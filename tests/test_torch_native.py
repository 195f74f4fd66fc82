"""The port's ctypes binding of the native C++ generator
(`av_separation_torch/data/native_loader.py`) against the JAX package's, on
the CPU.  Both compile the repo's one `native/avsep_native.cpp` with the
same flags, each into its own build directory, so their samples are equal
bit for bit.  Every iterator is closed."""

import dataclasses

import numpy as np
import pytest

from av_separation_tpu import config as jc
from av_separation_tpu.data import native_loader as jn
from av_separation_torch import config as tc
from av_separation_torch.data import native_loader as tn

DATA = dict(num_samples=100, sample_rate=2048, duration=1.0, n_fft=128,
            hop_length=64, num_frames=5, frame_h=16, frame_w=16)
CFG, JCFG = tc.DataConfig(**DATA), jc.DataConfig(**DATA)


@pytest.fixture(scope="module", autouse=True)
def jax_library_apart(tmp_path_factory):
    """The JAX loader builds into a directory of this module's own, so it
    never writes the library that the JAX package's own native tests may
    be building at the same time in another worker."""
    lib_dir = tmp_path_factory.mktemp("jax_native")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jn, "_LIB_DIR", str(lib_dir))
        mp.setattr(jn, "_LIB", str(lib_dir / "libavsep_native.so"))
        mp.setattr(jn, "_lib", None)
        yield


def assert_equal(a, b):
    assert set(a) == set(b) == set(tn.KEYS)
    for k in a:
        assert a[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("start,count,threads", [(0, 6, 0), (5, 4, 1),
                                                 (1_000_003, 3, 2)])
def test_generate_range_equals_jax(start, count, threads):
    ours = tn.generate_range(CFG, start, count, threads)
    assert_equal(ours, jn.generate_range(JCFG, start, count, threads))
    assert ours["mixed_spec"].shape == (count, 65, 33)
    assert ours["lip_frames"].shape == (count, 10, 16, 16)
    assert ours["clean_specs"].shape == (count, 2, 65, 33)
    assert 0.0 <= ours["lip_frames"].min() <= ours["lip_frames"].max() <= 1


def test_library_is_built_in_its_own_directory():
    lib = tn.library_path()
    assert lib.parent == tn.BUILD_DIR
    assert lib.parent.name == "torch_native" and lib.exists()
    assert tn.load_library() is tn.load_library()


def test_index_range_consistency():
    wide = tn.generate_range(CFG, 0, 10)
    single = tn.generate_range(CFG, 7, 1)
    for k in wide:
        np.testing.assert_array_equal(wide[k][7], single[k][0])


def test_out_buffers_are_reused_and_checked():
    first = tn.generate_range(CFG, 0, 4)
    ptrs = {k: v.ctypes.data for k, v in first.items()}
    again = tn.generate_range(CFG, 4, 4, out=first)
    assert {k: v.ctypes.data for k, v in again.items()} == ptrs
    assert_equal(again, tn.generate_range(CFG, 4, 4))
    with pytest.raises(ValueError, match="mixed_spec"):
        tn.generate_range(CFG, 0, 3, out=first)


def test_batch_iterator_recycles_three_slots():
    with tn.NativeBatchIterator(CFG, 4) as it:
        b1 = next(it)
        m1 = b1["mixed_spec"].copy()
        b2 = next(it)
        assert not np.array_equal(m1, b2["mixed_spec"])
        # b1 stays valid until the second following next(), which starts
        # the refill of its slot.
        np.testing.assert_array_equal(b1["mixed_spec"], m1)
        b3 = next(it)
        assert b3["mixed_spec"] is not b1["mixed_spec"]
        b4 = next(it)
        assert b4["mixed_spec"] is b1["mixed_spec"]
        assert not np.array_equal(b4["mixed_spec"], m1)


def test_iterator_equals_jax_and_resumes_at_its_offset():
    """seed * 1,000,003 + step * batch: the JAX stream, and a run resumed
    at step 3 replays the uninterrupted stream from step 3."""
    def take(it, n):
        try:
            return [{k: v.copy() for k, v in next(it).items()}
                    for _ in range(n)]
        finally:
            getattr(it, "close", lambda: None)()

    whole = take(tn.NativeBatchIterator(CFG, 2, seed=1), 5)
    ref = take(jn.NativeBatchIterator(JCFG, 2, seed=1), 5)
    for a, b in zip(whole, ref):
        assert_equal(a, b)
    resumed = take(tn.NativeBatchIterator(CFG, 2, seed=1, start_step=3), 2)
    for a, b in zip(resumed, whole[3:]):
        assert_equal(a, b)
    assert_equal(whole[0], tn.generate_range(CFG, 1_000_003, 2))


def test_non_power_of_two_nfft_raises():
    cfg = dataclasses.replace(CFG, n_fft=96)
    with pytest.raises(ValueError, match="power-of-two"):
        tn.generate_range(cfg, 0, 2)
    with pytest.raises(jn.NativeUnavailable):
        jn.generate_range(JCFG.replace(n_fft=96), 0, 2)


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """No fallback: a source that does not compile raises."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tn, "SOURCE", bad)
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tn, "_lib", None)
    with pytest.raises(tn.NativeBuildError, match="g\\+\\+ failed"):
        tn.load_library()
