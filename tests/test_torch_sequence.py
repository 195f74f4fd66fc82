"""The port's sequence parallelism (`parallel/sequence.py`) across 2 and 4
gloo ranks on the CPU (tests/torch_parallel_worker.py): all-gather-KV and
ring attention against dense attention, self-attention and
cross-attention with a shorter KV, forward and gradients (1e-5: float32
sums over at most 32 keys in another order); `make_sp_forward` of the
whole model over 'seq' (and 'seq' with 'data' or 'model') against the
unsharded forward within 1e-5."""

import os

import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from av_separation_torch.config import DataConfig, ModelConfig
from av_separation_torch.models.model import build_model
from av_separation_torch.ops.attention import merge_heads, split_heads

B, H, DH, T, TK = 2, 2, 8, 32, 16
MODEL = dict(freq_bins=65, d_model=32, nhead=2, num_encoder_layers=1,
             num_fusion_layers=1, dropout=0.1)
# T 16 (1,920 samples at hop 128) and 10 lip frames: 'seq' 2 divides both.
DATA = dict(num_samples=8, sample_rate=1920, duration=1.0, n_fft=128,
            hop_length=128, num_frames=5, frame_h=16, frame_w=16)


def _dense(q, k, v):
    qh, kh, vh = (split_heads(t, H) for t in (q, k, v))
    p = torch.softmax(qh @ kh.transpose(-1, -2) / DH ** 0.5, dim=-1)
    return merge_heads(p @ vh)


@pytest.fixture(scope="module", params=[2, 4], ids=["seq2", "seq4"])
def seq_run(request, tmp_path_factory):
    n = request.param
    rng = np.random.default_rng(n)
    arrays = {f"{case}_{x}": rng.normal(size=(B, t, H * DH)).astype(
        np.float32) for case, tk in (("self", T), ("cross", TK))
        for x, t in (("q", T), ("k", tk), ("v", tk), ("do", T))}
    d = tmp_path_factory.mktemp(f"seq{n}")
    np.savez(os.path.join(d, "qkv.npz"), **arrays)
    return n, arrays, worker.run("seq_ops", n, dict(seq=n, nhead=H), str(d))


@pytest.mark.parametrize("case", ["self", "cross"])
@pytest.mark.parametrize("route", ["gather", "ring"])
def test_against_dense_attention(seq_run, case, route):
    n, arrays, ranks = seq_run
    q, k, v = (torch.from_numpy(arrays[f"{case}_{x}"]).requires_grad_()
               for x in "qkv")
    o = _dense(q, k, v)
    o.backward(torch.from_numpy(arrays[f"{case}_do"]))
    want = [o.detach(), q.grad, k.grad, v.grad]
    for i, name in enumerate(("o", "dq", "dk", "dv")):
        got = torch.cat([r[f"{case}_{route}"][i] for r in ranks], dim=1)
        np.testing.assert_allclose(got.numpy(), want[i].numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=f"{route} {name}")


@pytest.mark.parametrize("mesh", [dict(seq=2), dict(data=2, seq=2),
                                  dict(seq=2, model=2)],
                         ids=["seq2", "data2xseq2", "seq2xmodel2"])
def test_sp_forward_matches_the_unsharded_forward(mesh, tmp_path):
    rng = np.random.default_rng(7)
    d = DataConfig(**DATA)
    batch = {"mixed_spec": np.abs(rng.normal(
        size=(2, d.freq_bins, d.num_stft_frames))).astype(np.float32),
        "lip_frames": rng.uniform(size=(2, d.total_lip_frames, 16, 16))
        .astype(np.float32)}
    np.savez(tmp_path / "batch.npz", **batch)
    ranks = worker.run("sp", int(np.prod(list(mesh.values()))),
                       dict(model=MODEL, data=DATA, mesh=mesh),
                       str(tmp_path))
    model = build_model(ModelConfig(**MODEL), device="cpu", seed=3)
    with torch.no_grad():
        want = model(*(torch.from_numpy(batch[k])
                       for k in ("mixed_spec", "lip_frames")))
    rows = mesh.get("data", 1)
    for i, key in enumerate(("separated", "masks")):
        got = torch.cat([ranks[r * len(ranks) // rows][key]
                         for r in range(rows)])
        assert got.shape == want[i].shape
        np.testing.assert_allclose(got.numpy(), want[i].numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=key)
