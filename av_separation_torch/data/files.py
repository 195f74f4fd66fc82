"""A corpus of files on disk as training batches (port of
`av_separation_tpu/data/files.py`, NumPy only).

Real corpora (LRS2, LRS3, VoxCeleb2) are files: each utterance's audio and
its lip-crop frames.  This tier reads such a corpus and hands out the batch
contract of the synthetic generator, so the train step cannot tell where
its data came from:

    {"mixed_spec":  (F, T) float32,
     "lip_frames":  (S * num_frames, H, W) float32,
     "clean_specs": (S, F, T) float32}

Layout: a directory of `sample_*.npz`, each holding `audios` (S, N) float32
waveforms and `lip_frames` (S * num_frames, H, W) float32, and a
`manifest.json` of the geometry.  16-bit PCM WAV is read and written with
the standard library's `wave`.

Two mixing modes:
  - static: each npz is a whole S-speaker sample;
  - dynamic (`dynamic_mix=True`): sample i mixes the first waveform of S
    distinct utterances drawn from `default_rng((seed, i))`, so every
    epoch of a reseeded loader sees new speaker pairings.

`write_synthetic_corpus` writes the synthetic generator in this format
(the test corpora; sample i is bit-identical to the JAX writer's), and
`PrefetchIterator` reads and transforms the next batches on a pool of
threads while the card trains on the current one.  The spectrograms are
computed on the host, as in the JAX package, so a batch from this tier
launches no STFT kernel.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import wave
from typing import Dict, Iterator, List, Optional

import numpy as np

from av_separation_torch.config import DataConfig
from av_separation_torch.data.synthetic import (SyntheticAVDataset,
                                                stft_magnitude_np)


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """A 16-bit PCM WAV -> ((C, N) float32 in [-1, 1], sample rate)."""
    with wave.open(path, "rb") as f:
        if f.getsampwidth() != 2:
            raise ValueError(f"{path}: only 16-bit PCM WAV is supported")
        n = f.getnframes()
        raw = f.readframes(n)
        channels = f.getnchannels()
        rate = f.getframerate()
    pcm = np.frombuffer(raw, dtype="<i2").reshape(n, channels)
    return pcm.T.astype(np.float32) / 32768.0, rate


def write_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """(N,) or (C, N) float32 in [-1, 1] -> a 16-bit PCM WAV."""
    audio = np.atleast_2d(np.asarray(audio, np.float32))
    pcm = np.clip(audio * 32768.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(pcm.shape[0])
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.T.tobytes())


def write_synthetic_corpus(root: str, cfg: DataConfig,
                           num_samples: Optional[int] = None) -> str:
    """Write the synthetic generator as a corpus: sample_%05d.npz (audios
    (S, N), lip_frames) and manifest.json.  Sample i holds the sources of
    `SyntheticAVDataset(cfg)[i]`, bit for bit."""
    os.makedirs(root, exist_ok=True)
    ds = SyntheticAVDataset(cfg)
    n = cfg.num_samples if num_samples is None else num_samples
    for i in range(n):
        audios, rng = ds.clean_audios(i)
        np.savez(os.path.join(root, f"sample_{i:05d}.npz"), audios=audios,
                 lip_frames=ds.lip_stream(audios, rng))
    manifest = {"num_samples": n, "sample_rate": cfg.sample_rate,
                "num_speakers": cfg.num_speakers,
                "num_samples_audio": cfg.num_samples_audio,
                "num_frames": cfg.num_frames, "frame_h": cfg.frame_h,
                "frame_w": cfg.frame_w}
    with open(os.path.join(root, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return root


class FileAVDataset:
    """The samples of a corpus directory, in the synthetic batch contract.

    root        : directory of sample_*.npz (and manifest.json).
    cfg         : the STFT geometry (n_fft, hop) and the expected shapes,
                  checked against the manifest.
    dynamic_mix : sample i mixes the first-speaker waveforms of S distinct
                  utterances drawn from `default_rng((seed, i))`.
    """

    def __init__(self, root: str, cfg: DataConfig,
                 dynamic_mix: bool = False, seed: int = 0):
        self.cfg = cfg
        self.root = root
        self.dynamic_mix = dynamic_mix
        self.seed = seed
        self.paths: List[str] = sorted(
            os.path.join(root, f) for f in os.listdir(root)
            if f.endswith(".npz"))
        if not self.paths:
            raise FileNotFoundError(f"no sample_*.npz under {root}")
        mpath = os.path.join(root, "manifest.json")
        if os.path.exists(mpath):
            with open(mpath) as f:
                man = json.load(f)
            for key, want in (("sample_rate", cfg.sample_rate),
                              ("num_samples_audio", cfg.num_samples_audio),
                              ("frame_h", cfg.frame_h),
                              ("frame_w", cfg.frame_w)):
                have = man.get(key)
                if have is not None and have != want:
                    raise ValueError(
                        f"corpus manifest {key}={have} != config {want}")

    def __len__(self) -> int:
        return len(self.paths)

    @staticmethod
    def _load(path: str) -> Dict[str, np.ndarray]:
        with np.load(path) as z:
            return {"audios": z["audios"].astype(np.float32),
                    "lip_frames": z["lip_frames"].astype(np.float32)}

    def sources(self, idx: int) -> Dict[str, np.ndarray]:
        """Clean waveforms (S, N) and lip frames of sample `idx` (mixed
        from S utterances in dynamic mode)."""
        cfg = self.cfg
        if not self.dynamic_mix:
            return self._load(self.paths[idx])
        rng = np.random.default_rng((self.seed, idx))
        picks = rng.choice(len(self.paths), size=cfg.num_speakers,
                           replace=False)
        audios, lips = [], []
        for p in picks:
            rec = self._load(self.paths[p])
            audios.append(rec["audios"][0])
            # The utterance's own lip stream: its first speaker's frames.
            lips.append(rec["lip_frames"][:cfg.num_frames])
        return {"audios": np.stack(audios),
                "lip_frames": np.concatenate(lips, axis=0)}

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rec = self.sources(idx)
        audios = rec["audios"]
        mixed = audios.sum(axis=0).astype(np.float32)
        spec = lambda a: stft_magnitude_np(a, cfg.n_fft, cfg.hop_length,
                                           cfg.num_stft_frames)
        return {"mixed_spec": spec(mixed),
                "lip_frames": rec["lip_frames"],
                "clean_specs": np.stack([spec(a) for a in audios])}


class PrefetchIterator:
    """Shuffled batches of a FileAVDataset, read on background threads.

    Full batches of a fresh `default_rng(seed).permutation` each epoch,
    forever, as `data/loader.batch_iterator` cuts them.  `num_threads`
    workers load and transform the next batches while the consumer trains;
    at most `queue_depth` finished batches wait.  Each index batch carries
    a ticket, and `__next__` hands batches out in ticket order, so the
    order does not depend on the thread count.  `start_step` fast-forwards
    the stream: one permutation is drawn and dropped per skipped epoch,
    then the skipped batches of the current epoch, so a run resumed at
    step K sees the batches an uninterrupted run sees from step K on.

    A worker's exception is raised by `__next__`.  `close()` stops and
    joins the workers (each checks for it between samples, so the join
    waits for one sample, not a batch); after it `__next__` raises
    StopIteration, even where a worker had finished a later batch.  The
    iterator is also a context manager.
    """

    def __init__(self, dataset: FileAVDataset, batch_size: int,
                 seed: int = 0, num_threads: int = 4, queue_depth: int = 4,
                 start_step: int = 0):
        n = len(dataset)
        if n < batch_size:
            raise ValueError(f"a corpus of {n} samples has no full batch "
                             f"of {batch_size}")
        self.ds = dataset
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        per_epoch = n // batch_size
        for _ in range(start_step // per_epoch):
            self.rng.permutation(n)
        self._skip = start_step % per_epoch
        self._ticket = 0        # next ticket to hand a worker
        self._next_ticket = 0   # next ticket to return
        self._todo: List[tuple] = []   # (ticket, indices), under _lock
        self._lock = threading.Lock()
        self._stash: Dict[int, object] = {}
        self._out_q: "queue.Queue[tuple]" = queue.Queue(maxsize=queue_depth)
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(num_threads)]
        for t in self._threads:
            t.start()

    def _take(self) -> tuple:
        """The next (ticket, indices), cutting a new epoch when the last
        one is handed out."""
        with self._lock:
            if not self._todo:
                n = len(self.ds)
                order = self.rng.permutation(n)
                for start in range(self._skip * self.batch_size,
                                   n - self.batch_size + 1,
                                   self.batch_size):
                    self._todo.append(
                        (self._ticket, order[start:start + self.batch_size]))
                    self._ticket += 1
                self._skip = 0
                self._todo.reverse()
            return self._todo.pop()

    def _worker(self) -> None:
        while not self._stop.is_set():
            ticket, idx = self._take()
            try:
                samples = []
                for i in idx:
                    if self._stop.is_set():
                        return
                    samples.append(self.ds[int(i)])
                item = {k: np.stack([s[k] for s in samples])
                        for k in samples[0]}
            except Exception as e:  # noqa: BLE001 — raised by __next__
                item = e
            while not self._stop.is_set():
                try:
                    self._out_q.put((ticket, item), timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        # The stash holds at most num_threads + queue_depth batches: the
        # consumer drains the queue while it waits for the next ticket, so
        # the worker that holds that ticket never waits on a full queue.
        if self._stop.is_set():
            raise StopIteration
        while self._next_ticket not in self._stash:
            if self._stop.is_set():
                raise StopIteration
            try:
                ticket, item = self._out_q.get(timeout=0.1)
            except queue.Empty:
                continue
            self._stash[ticket] = item
        item = self._stash.pop(self._next_ticket)
        self._next_ticket += 1
        if isinstance(item, Exception):
            raise item
        return item

    def close(self) -> None:
        self._stop.set()
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=10.0)

    def __enter__(self) -> "PrefetchIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
