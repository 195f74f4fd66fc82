"""The port's file-corpus tier (`av_separation_torch/data/files.py`) against
the JAX package's, on the CPU.

The same corpus geometry and seeds through both: the WAV round trip, the
corpus writer array for array, `FileAVDataset` static and dynamic bit for
bit, the `PrefetchIterator` batch order for 1 and 4 threads and on resume
(across an epoch boundary), the manifest checks, and one dropout-0 train
step of a demo-width model on the first files batch against the JAX step.
Every iterator is closed in a `finally`.
"""

import dataclasses
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from av_separation_tpu import config as jc
from av_separation_tpu.data import files as jf
from av_separation_tpu.train import create_train_state as jax_create
from av_separation_tpu.train import make_train_step as jax_make_step
from av_separation_torch import config as tc
from av_separation_torch.data import files as tf
from av_separation_torch.data.loader import batch_iterator
from av_separation_torch.data.synthetic import SyntheticAVDataset
from av_separation_torch.models.layers import Generators
from av_separation_torch.models.model import AVSeparationTransformer
from av_separation_torch.train import (TrainState, make_optimizer,
                                       make_train_step)
from av_separation_torch.utils.transplant import from_jax_variables

DATA = dict(num_samples=8, sample_rate=2048, duration=1.0, n_fft=128,
            hop_length=64, num_frames=5, frame_h=16, frame_w=16)
CFG, JCFG = tc.DataConfig(**DATA), jc.DataConfig(**DATA)
BATCH = 2  # 4 batches an epoch


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The same 8 samples written by each package's writer."""
    ours = str(tmp_path_factory.mktemp("ours"))
    theirs = str(tmp_path_factory.mktemp("theirs"))
    tf.write_synthetic_corpus(ours, CFG)
    jf.write_synthetic_corpus(theirs, JCFG)
    return ours, theirs


def take(it, n):
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def assert_batches_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("channels", [1, 2])
def test_wav_round_trip_and_jax_reader(tmp_path, channels):
    rng = np.random.default_rng(channels)
    audio = (0.7 * rng.normal(size=(channels, 4000))).clip(-1, 1) \
        .astype(np.float32)
    path = str(tmp_path / "x.wav")
    tf.write_wav(path, audio, 8000)
    back, rate = tf.read_wav(path)
    assert rate == 8000 and back.shape == (channels, 4000)
    np.testing.assert_allclose(back, audio, atol=1.0 / 32768)
    jback, jrate = jf.read_wav(path)
    assert jrate == rate
    np.testing.assert_array_equal(back, jback)
    jf.write_wav(str(tmp_path / "j.wav"), audio, 8000)
    with open(path, "rb") as a, open(tmp_path / "j.wav", "rb") as b:
        assert a.read() == b.read()


def test_corpus_equals_the_jax_writers(corpora):
    ours, theirs = corpora
    names = sorted(os.listdir(ours))
    assert names == sorted(os.listdir(theirs))
    assert names[-1] == "sample_00007.npz" and "manifest.json" in names
    for name in names:
        if name == "manifest.json":
            with open(os.path.join(ours, name)) as a, \
                    open(os.path.join(theirs, name)) as b:
                assert json.load(a) == json.load(b)
            continue
        with np.load(os.path.join(ours, name)) as a, \
                np.load(os.path.join(theirs, name)) as b:
            assert set(a.files) == set(b.files) == {"audios", "lip_frames"}
            for k in a.files:
                assert a[k].dtype == b[k].dtype == np.float32
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("dynamic", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_dataset_matches_jax_bit_for_bit(corpora, dynamic, seed):
    ours, _ = corpora
    ds = tf.FileAVDataset(ours, CFG, dynamic_mix=dynamic, seed=seed)
    ref = jf.FileAVDataset(ours, JCFG, dynamic_mix=dynamic, seed=seed)
    assert len(ds) == len(ref) == 8
    for i in range(8):
        # Index types as the iterators pass them: numpy ints.
        assert_batches_equal([ds[np.int64(i)]], [ref[np.int64(i)]])
        assert_batches_equal([ds[i]], [ref[i]])


def test_static_samples_are_the_synthetic_datasets(corpora):
    ds, syn = tf.FileAVDataset(corpora[0], CFG), SyntheticAVDataset(CFG)
    assert_batches_equal([ds[i] for i in range(8)],
                         [syn[i] for i in range(8)])


def test_dynamic_mix_pairs_distinct_utterances(corpora):
    ds = tf.FileAVDataset(corpora[0], CFG, dynamic_mix=True, seed=1)
    a, b = ds[0], ds[1]
    assert a["lip_frames"].shape == (CFG.total_lip_frames, 16, 16)
    assert not np.array_equal(a["mixed_spec"], b["mixed_spec"])
    rng = np.random.default_rng((1, 0))
    picks = rng.choice(8, size=2, replace=False)
    want = [np.load(os.path.join(corpora[0], f"sample_{p:05d}.npz"))[
        "audios"][0] for p in picks]
    np.testing.assert_array_equal(ds.sources(0)["audios"], np.stack(want))


@pytest.mark.parametrize("key,value", [("sample_rate", 16000),
                                       ("frame_h", 32), ("frame_w", 8),
                                       ("duration", 2.0)])
def test_manifest_mismatch_raises_in_both(corpora, key, value):
    field = "num_samples_audio" if key == "duration" else key
    with pytest.raises(ValueError, match=field):
        tf.FileAVDataset(corpora[0], dataclasses.replace(CFG,
                                                         **{key: value}))
    with pytest.raises(ValueError, match=field):
        jf.FileAVDataset(corpora[0], JCFG.replace(**{key: value}))


def test_an_empty_directory_raises_in_both(tmp_path):
    with pytest.raises(FileNotFoundError):
        tf.FileAVDataset(str(tmp_path), CFG)
    with pytest.raises(FileNotFoundError):
        jf.FileAVDataset(str(tmp_path), JCFG)


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("start_step", [0, 1, 5])
def test_prefetch_order_equals_jax(corpora, threads, start_step):
    """6 batches (across an epoch boundary; start 5 is one past the first
    epoch of 4) in the JAX iterator's order, and the uninterrupted
    stream's from `start_step` on."""
    ours, _ = corpora
    ds = tf.FileAVDataset(ours, CFG)
    got = take(tf.PrefetchIterator(ds, BATCH, seed=3, num_threads=threads,
                                   start_step=start_step), 6)
    ref = take(jf.PrefetchIterator(jf.FileAVDataset(ours, JCFG), BATCH,
                                   seed=3, num_threads=threads,
                                   start_step=start_step), 6)
    assert_batches_equal(got, ref)
    whole = take(tf.PrefetchIterator(ds, BATCH, seed=3, num_threads=1),
                 start_step + 6)
    assert_batches_equal(got, whole[start_step:])


def test_prefetch_matches_the_host_loader(corpora):
    """The same permutations as `data/loader.batch_iterator` over the
    synthetic dataset: the files tier replays the host tier's batches."""
    got = take(tf.PrefetchIterator(tf.FileAVDataset(corpora[0], CFG), BATCH,
                                   seed=0, num_threads=4), 9)
    host = batch_iterator(SyntheticAVDataset(CFG), BATCH, seed=0)
    assert_batches_equal(got, [next(host) for _ in range(9)])


def test_prefetch_raises_a_workers_error_and_stops(tmp_path, corpora):
    root = tmp_path / "bad"
    root.mkdir()
    for name in os.listdir(corpora[0]):
        if name.endswith(".npz"):
            (root / name).write_bytes(b"not an npz")
    before = set(threading.enumerate())
    it = tf.PrefetchIterator(tf.FileAVDataset(str(root), CFG), BATCH,
                             num_threads=2)
    try:
        with pytest.raises(Exception, match="pickle|npz|load|zip|file"):
            next(it)
    finally:
        it.close()
    assert not any(t.is_alive() for t in set(threading.enumerate())
                   - before)


def test_prefetch_needs_a_full_batch(corpora):
    with pytest.raises(ValueError, match="no full batch"):
        tf.PrefetchIterator(tf.FileAVDataset(corpora[0], CFG), 9)


def test_close_joins_the_workers(corpora):
    before = set(threading.enumerate())
    with tf.PrefetchIterator(tf.FileAVDataset(corpora[0], CFG), BATCH,
                             num_threads=4, queue_depth=1) as it:
        next(it)
    assert not any(t.is_alive() for t in set(threading.enumerate())
                   - before)
    with pytest.raises(StopIteration):
        next(it)


def test_train_step_on_a_files_batch_matches_jax(corpora):
    """Dropout 0, demo width (d 128, 4 heads: dh 32), the same weights: one
    step of each package on the first files batch, at
    tests/test_torch_train.py's tolerances."""
    model = dict(freq_bins=CFG.freq_bins, d_model=128, nhead=4,
                 num_encoder_layers=1, num_fusion_layers=1, num_speakers=2,
                 dropout=0.0)
    jcfg = jc.ExperimentConfig(
        name="files", model=jc.ModelConfig(**model, attn_impl="xla",
                                           decoder_impl="xla",
                                           proj_impl="xla", stem_impl="xla"),
        data=JCFG, train=jc.TrainConfig(batch_size=BATCH))
    cfg = tc.ExperimentConfig(name="files", model=tc.ModelConfig(**model),
                              data=CFG, train=tc.TrainConfig(
                                  batch_size=BATCH))
    ours, theirs = corpora
    batch = take(tf.PrefetchIterator(tf.FileAVDataset(ours, CFG), BATCH,
                                     seed=0, num_threads=2), 1)[0]
    jbatch = take(jf.PrefetchIterator(jf.FileAVDataset(theirs, JCFG), BATCH,
                                      seed=0, num_threads=2), 1)[0]
    assert_batches_equal([batch], [jbatch])
    jmodel, jstate = jax_create(jcfg)
    # NumPy copies first: the JAX step donates its state.
    variables = jax.tree_util.tree_map(np.array, {
        "params": jstate.params, "batch_stats": jstate.batch_stats})
    torch_model = AVSeparationTransformer(cfg.model)
    torch_model.load_state_dict(from_jax_variables(variables))
    torch_model.train()
    state = TrainState(0, torch_model,
                       make_optimizer(cfg, torch_model.parameters()),
                       Generators(torch.Generator(), torch.Generator()))
    _, jm = jax_make_step(jmodel, jcfg)(
        jstate, {k: jnp.asarray(v) for k, v in jbatch.items()})
    _, m = make_train_step(cfg)(state, batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               atol=1e-3)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
