"""The repo's native C++ batch generator through ctypes (port of
`av_separation_tpu/data/native_loader.py`).

`native/avsep_native.cpp` draws the synthetic distribution (sine mixtures,
their STFT magnitudes and lip frames) on a pool of C++ threads, per index
deterministically, with its own random numbers: the same distribution as
`data/synthetic.py`, not its samples.  It is compiled here at first use
with the JAX loader's command (`g++ -O3 -march=native -shared -fPIC
-std=c++17 -pthread`) into `build/torch_native/`, under a name hashed from
the source, the flags, the compiler's version and the target that
`-march=native` resolves to, so that a library built on one machine is
never loaded on another.  A failed build raises: there is no fallback to
the NumPy generator.

The spectrograms are computed on the host, so a batch from this tier
launches no STFT kernel.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np

from av_separation_torch.config import DataConfig

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "avsep_native.cpp"
BUILD_DIR = ROOT / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-pthread")
KEYS = ("mixed_spec", "lip_frames", "clean_specs")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeBuildError(RuntimeError):
    """g++ is missing or failed on the native source."""


def _compiler_key() -> bytes:
    """g++'s version and the target `-march=native` expands to here."""
    try:
        version = subprocess.run(["g++", "--version"], capture_output=True,
                                 text=True, check=True).stdout
        target = subprocess.run(
            ["g++", "-march=native", "-###", "-E", "-x", "c++", os.devnull],
            capture_output=True, text=True, check=True).stderr
    except (OSError, subprocess.CalledProcessError) as e:
        raise NativeBuildError(f"g++ is not usable: {e}") from e
    return (version + "".join(ln for ln in target.splitlines()
                              if "cc1" in ln)).encode()


def library_path() -> Path:
    """Where the library lives: named by a hash of the source, the flags,
    the compiler and the resolved target."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS)
                            .encode() + _compiler_key()).hexdigest()[:12]
    return BUILD_DIR / f"libavsep_native-{digest}.so"


def _build(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    res = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise NativeBuildError(f"g++ failed on {SOURCE}:\n{res.stderr}")
    os.replace(tmp, target)


def load_library() -> ctypes.CDLL:
    """The loaded library, built first if it is missing."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        target = library_path()
        if not target.exists():
            _build(target)
        lib = ctypes.CDLL(str(target))
        f32 = ctypes.POINTER(ctypes.c_float)
        i32 = ctypes.c_int32
        lib.avsep_generate.restype = ctypes.c_int
        lib.avsep_generate.argtypes = [
            ctypes.c_int64, i32, i32, i32, ctypes.c_double,
            ctypes.POINTER(ctypes.c_double), i32, i32, i32, i32, i32, i32,
            i32, f32, f32, f32]
        _lib = lib
        return lib


def _shapes(cfg: DataConfig, count: int) -> Dict[str, tuple]:
    f, t, s = cfg.freq_bins, cfg.num_stft_frames, cfg.num_speakers
    return {"mixed_spec": (count, f, t),
            "lip_frames": (count, s * cfg.num_frames, cfg.frame_h,
                           cfg.frame_w),
            "clean_specs": (count, s, f, t)}


def generate_range(cfg: DataConfig, start_idx: int, count: int,
                   num_threads: int = 0,
                   out: Optional[Dict[str, np.ndarray]] = None
                   ) -> Dict[str, np.ndarray]:
    """Samples [start_idx, start_idx + count) as stacked float32 arrays.

    Pass `out` (an earlier result of the same shapes) to write into its
    buffers: a fresh large allocation pays its first-touch page faults on
    every call.  `num_threads` 0 takes min(cpu count, count)."""
    if cfg.n_fft < 1 or cfg.n_fft & (cfg.n_fft - 1):
        raise ValueError(f"the native generator needs a power-of-two n_fft, "
                         f"not {cfg.n_fft}")
    lib = load_library()
    if num_threads <= 0:
        num_threads = min(os.cpu_count() or 1, count)
    shapes = _shapes(cfg, count)
    if out is None:
        out = {k: np.empty(shapes[k], np.float32) for k in KEYS}
    else:
        for k in KEYS:
            a = out[k]
            if a.shape != shapes[k] or a.dtype != np.float32 \
                    or not a.flags.c_contiguous or not a.flags.writeable:
                raise ValueError(f"out[{k!r}]: {a.shape} {a.dtype} is not a "
                                 f"writable C-contiguous float32 "
                                 f"{shapes[k]}")
    freqs = np.asarray(cfg.speaker_freqs, np.float64)
    ptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    ret = lib.avsep_generate(
        start_idx, count, cfg.num_speakers, cfg.num_samples_audio,
        float(cfg.sample_rate),
        freqs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), cfg.n_fft,
        cfg.hop_length, cfg.num_stft_frames, cfg.num_frames, cfg.frame_h,
        cfg.frame_w, num_threads, ptr(out["mixed_spec"]),
        ptr(out["lip_frames"]), ptr(out["clean_specs"]))
    if ret != 0:
        raise RuntimeError(f"avsep_generate returned {ret}")
    return {k: out[k] for k in KEYS}


class NativeBatchIterator:
    """Batches of the native generator, the next one generated by the C++
    pool (ctypes releases the GIL) while the current one trains.

    Sample j of step k is index seed * 1,000,003 + k * batch_size + j, so
    a run resumed at `start_step` replays the uninterrupted stream.

    Buffer contract: the arrays rotate through 3 slots, so the batch that
    `__next__` returns stays valid until the second following `__next__`
    (the slot being refilled is never the current batch or the one before
    it).  A consumer that keeps a batch longer copies it.  On the CPU
    `train.make_train_step` reads the arrays in place (`torch.as_tensor`
    shares their memory) and is done with them before the next call; a
    staging of batches that outlives a step (pinned buffers and
    `non_blocking` copies) must copy a batch before its slot is reused.
    `close()` waits for the pending batch and stops the thread.
    """

    def __init__(self, cfg: DataConfig, batch_size: int, seed: int = 0,
                 num_threads: int = 0, start_step: int = 0):
        self.cfg = cfg
        self.batch_size = batch_size
        self.num_threads = num_threads
        self._idx = seed * 1_000_003 + start_step * batch_size
        self._executor = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._buffers: list = [None, None, None]
        self._slot = 0
        self._pending = self._submit()

    def _submit(self) -> concurrent.futures.Future:
        start, slot = self._idx, self._slot
        self._idx += self.batch_size
        self._slot = (slot + 1) % len(self._buffers)

        def run():
            self._buffers[slot] = generate_range(
                self.cfg, start, self.batch_size, self.num_threads,
                out=self._buffers[slot])
            return self._buffers[slot]

        return self._executor.submit(run)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = self._pending.result()
        self._pending = self._submit()
        return batch

    def close(self) -> None:
        self._executor.shutdown(wait=True, cancel_futures=True)

    def __enter__(self) -> "NativeBatchIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
