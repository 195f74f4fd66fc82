"""Every C entry point of `av_separation_torch/csrc/` restores the caller's
CUDA device.

The kernels bind through ctypes without PyTorch's headers, so each entry
point that takes a `device` sets it through the shared RAII guard of
`csrc/device_guard.cuh`.  The source test holds that for every entry
point; the guard itself is compiled with g++ against a stand-in for the
CUDA runtime (a current-device variable), which shows that the caller's
device comes back on every return path, the error returns included.
"""

import re
import subprocess
from pathlib import Path

import pytest

CSRC = Path(__file__).resolve().parents[1] / "av_separation_torch" / "csrc"
GUARD = "const DeviceGuard guard(device);"


def entry_points():
    """(file, name, parameters, body) of every extern "C" definition."""
    for path in sorted(CSRC.glob("*.cu")):
        text = path.read_text()
        for m in re.finditer(r'extern "C" [\w\s\*]+?\b(avsep_\w+)\(([^)]*)\)'
                             r'\s*\{', text):
            depth, i = 1, m.end()
            while depth:
                depth += {"{": 1, "}": -1}.get(text[i], 0)
                i += 1
            yield path.name, m.group(1), m.group(2), text[m.end():i - 1]


def test_every_entry_point_that_takes_a_device_uses_the_guard():
    guarded = []
    for name, fn, params, body in entry_points():
        if not re.search(r"\bint device\b", params):
            assert "cudaSetDevice" not in body, fn
            continue
        assert body.count(GUARD) == 1, f"{name}: {fn}"
        before = body[:body.index(GUARD)]
        # Only argument checks run before it: no launch, no device call.
        assert not re.search(r"<<<|dispatch|launch|convs|cuda\w+\(",
                             before), f"{name}: {fn}"
        guarded.append(f"{name}:{fn}")
    assert sorted(guarded) == sorted([
        "audio_proj.cu:avsep_audio_proj_split",
        "audio_proj.cu:avsep_audio_proj_fwd",
        "dropout_fused.cu:avsep_dropout_bwd",
        "dropout_fused.cu:avsep_dropout_fwd",
        "flash_attn_bwd.cu:avsep_flash_attn_bwd",
        "flash_attn_fwd.cu:avsep_flash_attn_fwd",
        "flash_attn_fwd.cu:avsep_mma_3xtf32_probe",
        "flash_bwd_wgmma.cu:avsep_flash_bwd_wgmma",
        "flash_fwd_wgmma.cu:avsep_flash_fwd_wgmma",
        "mask_decoder.cu:avsep_mask_decoder_fwd",
        "stft_fft.cu:avsep_stft_4step_fwd",
        "stft_fft.cu:avsep_stft_fft_fwd"])


@pytest.mark.parametrize("path", sorted(p.name for p in CSRC.glob("*.cu")))
def test_no_source_sets_the_device_but_the_guard(path):
    text = (CSRC / path).read_text()
    assert "cudaSetDevice" not in text
    if "int device" in text:
        assert '#include "device_guard.cuh"' in text


FAKE_RUNTIME = r"""
#pragma once
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidDevice = 101 };
extern int g_current, g_sets;
inline cudaError_t cudaGetDevice(int* d) { *d = g_current; return 0; }
inline cudaError_t cudaSetDevice(int d) {
  ++g_sets;
  if (d < 0 || d >= 4) return cudaErrorInvalidDevice;
  g_current = d;
  return cudaSuccess;
}
"""

HARNESS = r"""
#include <cstdio>
#include "device_guard.cuh"
int g_current = 0, g_sets = 0;

// An entry point as the kernels write one: the guard, its error, then
// work on the target device that may fail.
int entry(int device, int fail_with) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (g_current != device) return 99;
  if (fail_with) return fail_with;
  return 0;
}

int main() {
  const int cases[][3] = {{2, 1, 0}, {2, 1, 7}, {2, 9, 0}, {2, 2, 0},
                          {0, 3, 0}};
  for (const auto& c : cases) {
    g_current = c[0];
    g_sets = 0;
    const int rc = entry(c[1], c[2]);
    std::printf("%d %d %d %d %d\n", c[0], c[1], rc, g_current, g_sets);
  }
  return 0;
}
"""


def test_the_guard_restores_the_callers_device(tmp_path):
    (tmp_path / "cuda_runtime.h").write_text(FAKE_RUNTIME)
    (tmp_path / "harness.cpp").write_text(HARNESS)
    exe = tmp_path / "harness"
    subprocess.run(["g++", "-std=c++17", "-Wall", "-Werror", "-I",
                    str(tmp_path), "-I", str(CSRC), "-x", "c++",
                    str(tmp_path / "harness.cpp"), "-o", str(exe)],
                   check=True, capture_output=True, text=True)
    rows = [tuple(map(int, ln.split())) for ln in subprocess.run(
        [str(exe)], check=True, capture_output=True,
        text=True).stdout.splitlines()]
    # (caller's device, target, return code, device after, set calls)
    assert rows == [
        (2, 1, 0, 2, 2),     # set 1, restored to 2
        (2, 1, 7, 2, 2),     # an error return after the guard: restored
        (2, 9, 101, 2, 1),   # the set fails: nothing to restore
        (2, 2, 0, 2, 1),     # already current: set, no restore needed
        (0, 3, 0, 0, 2)]
