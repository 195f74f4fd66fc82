"""Build and load the hand-written CUDA kernels of `av_separation_torch/csrc/`.

Each source is compiled by `nvcc` for `sm_90a` into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds) and loaded
with `ctypes`.  Libraries go to `build/torch_kernels/` at the root of the
checkout, named by a hash of the source, the shared headers and the flags,
so an edited source is never served by a stale library.  `build()` starts
one `nvcc` per missing source, all at once.  Nothing is built or loaded at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("flash_attn_fwd", "flash_attn_bwd", "flash_fwd_wgmma",
           "flash_bwd_wgmma", "audio_proj", "mask_decoder",
           "stft_fft", "dropout_fused", "glu_dwconv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME or PATH): the CUDA "
                           "kernels can only be built where the CUDA "
                           "toolkit is installed")
    return found


def library_path(name: str) -> Path:
    """Where the library of one source lives: named by a hash of the
    source, the shared headers (`*.cuh`) and the flags."""
    src = CSRC_DIR / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES,
          ptxas_verbose: bool = False) -> Dict[str, str]:
    """Compile every named source whose library is missing, in parallel.

    Returns the compiler output of each source built (empty for a library
    already present); raises with that output when nvcc fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ("-Xptxas", "-v") if ptxas_verbose else ()
    running = []
    logs: Dict[str, str] = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            logs[name] = ""
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *extra, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, target, tmp, proc))
    failures = []
    for name, target, tmp, proc in running:
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {name}.cu:\n{out}")
            continue
        os.replace(tmp, target)
    if failures:
        raise RuntimeError("\n".join(failures))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if it is missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            lib.avsep_error_string.argtypes = [ctypes.c_int]
            lib.avsep_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.avsep_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
