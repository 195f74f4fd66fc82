"""The port's sharded attention routes against the JAX package's: JAX
`_flash_sharded`, `_flash_sharded_packed` and `_attn_seq_sharded` on the
8-device CPU mesh (Pallas kernels in interpret mode) against

  - every rank's block through the plain flash version in one process, its
    seed folded by the rank's position (`shard_seed`);
  - the runtime route itself, `multi_head_attention(mesh=)`, on 4 gloo
    ranks (tests/torch_parallel_worker.py), each rank given the block that
    the JAX mesh gives the device of its number: its coordinates, its
    folded seed, the K/V gather over 'seq' and its reduce-scatter.

Dropout 0.1 throughout.  The outputs and the gradients must agree within
1e-6; the dropout masks bit for bit, read back from both sides' outputs
and dV on rows where q = k = 0 and v = dO = the identity (there o[i, j]
and dv[j, i] are keep[i, j] / (Tk (1 - rate))).  A mask bit that differs
moves such a value by 1 / (Tk (1 - rate)), far above 1e-6.  Shapes a mesh
axis does not divide raise in the runtime's own checks."""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_parallel_worker as worker
from av_separation_tpu.config import MeshConfig as JaxMeshConfig
from av_separation_tpu.ops import attention as jattn
from av_separation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from av_separation_torch.config import MeshConfig
from av_separation_torch.ops.attention import (draw_seed, fold_seed,
                                               merge_heads, shard_seed,
                                               split_heads)
from av_separation_torch.ops.kernels.attention import (flash_attention,
                                                       keep_mask)

RATE = 0.1
GENERATOR_SEED = 13
# The seed multi_head_attention draws from a generator seeded so.
SEED = draw_seed(torch.Generator().manual_seed(GENERATOR_SEED))
B, H, T = 4, 2, 32

# (mesh axes, head dim, JAX route)
CASES = [
    (dict(data=2, model=2), 32, "sharded"),
    (dict(data=2, model=2), 128, "packed"),
    (dict(data=2, seq=2), 32, "seq"),
    (dict(data=2, seq=2), 128, "seq"),
    (dict(seq=4), 32, "seq"),
]
IDS = [f"{'x'.join(f'{k}{v}' for k, v in m.items())}-dh{dh}-{r}"
       for m, dh, r in CASES]


def _jax_route(route, mesh, nhead):
    seed = jnp.asarray([SEED], jnp.int32)

    def fn(q, k, v):  # (B, H, T, dh) in, (B, H, T, dh) out
        if route == "packed":
            out = jattn._flash_sharded_packed(
                jattn.merge_heads(q), jattn.merge_heads(k),
                jattn.merge_heads(v), nhead, mesh, RATE, seed)
            return jattn.split_heads(out, nhead)
        if route == "sharded":
            return jattn._flash_sharded(q, k, v, mesh, RATE, seed)
        return jattn._attn_seq_sharded(q, k, v, mesh, "pallas", RATE,
                                       jax.random.key(0), seed)

    return fn


@functools.lru_cache(maxsize=None)
def _jax(axes, dh, route):
    """JAX's (o, dq, dk, dv) on `_inputs(dh)` as numpy (axes: items)."""
    q, k, v, do = _inputs(dh)
    mesh = jax_make_mesh(JaxMeshConfig(**dict(axes)))
    with pltpu.force_tpu_interpret_mode():
        o, vjp = jax.vjp(_jax_route(route, mesh, H), *(jnp.asarray(t)
                                                       for t in (q, k, v)))
        grads = vjp(jnp.asarray(do))
    return [np.asarray(t) for t in (o, *grads)]


def _inputs(dh):
    """q, k, v, dO (B, H, T, dh): the even rows random, the odd rows the
    mask probe (every rank holds rows of both kinds)."""
    rng = np.random.default_rng(dh)
    q, k, v, do = (rng.normal(size=(B, H, T, dh)).astype(np.float32)
                   for _ in range(4))
    probe = slice(1, None, 2)
    q[probe] = k[probe] = 0.0
    v[probe] = do[probe] = np.eye(T, dh, dtype=np.float32)
    return q, k, v, do


def _by_shards(q, k, v, cfg):
    """(B, H, T, dh) cut into every rank's block (its rows, heads and
    query block against the whole K and V), each through the plain flash
    version with its folded seed, the outputs put back in place."""
    rb, hb = q.shape[0] // (cfg.data * cfg.fsdp), q.shape[1] // cfg.model
    tb = q.shape[2] // cfg.seq
    rows = []
    for r in range(cfg.data * cfg.fsdp):
        heads = []
        for m in range(cfg.model):
            blocks = []
            for s in range(cfg.seq):
                at = dict(data=r // cfg.fsdp, fsdp=r % cfg.fsdp, seq=s,
                          model=m)
                rs, hs = slice(r * rb, (r + 1) * rb), slice(m * hb,
                                                            (m + 1) * hb)
                blocks.append(flash_attention(
                    q[rs, hs, s * tb:(s + 1) * tb], k[rs, hs], v[rs, hs],
                    RATE, shard_seed(SEED, cfg, at)))
            heads.append(torch.cat(blocks, dim=2))
        rows.append(torch.cat(heads, dim=1))
    return torch.cat(rows, dim=0)


@pytest.mark.parametrize("axes,dh,route", CASES, ids=IDS)
def test_outputs_gradients_and_masks_match_jax(axes, dh, route):
    """One call each side on `_inputs(dh)`: outputs and gradients within
    1e-6 on the random rows, the masks bit for bit on the probe rows."""
    cfg = MeshConfig(**axes)
    q, k, v, do = _inputs(dh)
    probe = slice(1, None, 2)
    theirs = _jax(tuple(axes.items()), dh, route)
    qt, kt, vt = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    ot = _by_shards(qt, kt, vt, cfg)
    ot.backward(torch.from_numpy(do))
    ours = [t.detach().numpy() for t in (ot, qt.grad, kt.grad, vt.grad)]
    for name, a, b in zip(("o", "dq", "dk", "dv"), ours, theirs):
        np.testing.assert_allclose(a[::2], b[::2], atol=1e-6, rtol=1e-6,
                                   err_msg=name)
    # Each rank's mask from the port's hash with its folded seed.
    tq = T // cfg.seq
    want = np.zeros((B, H, T, T), bool)
    rb, hb = B // (cfg.data * cfg.fsdp), H // cfg.model
    for d in range(cfg.data):
        for m in range(cfg.model):
            for s in range(cfg.seq):
                at = dict(data=d, fsdp=0, seq=s, model=m)
                want[d * rb:(d + 1) * rb, m * hb:(m + 1) * hb,
                     s * tq:(s + 1) * tq] = keep_mask(
                    shard_seed(SEED, cfg, at), rb, hb, tq, T, RATE).numpy()
    want = want[probe]
    for side in (theirs, ours):
        o, dv = side[0][probe], side[3][probe]
        assert np.array_equal(o[..., :T] > 0, want)
        assert np.array_equal(np.swapaxes(dv[..., :T], -1, -2) > 0, want)
    # Folding moves the masks: two ranks' blocks differ.
    assert not np.array_equal(want[0], want[-1]) or cfg.data == 1


def test_seed_folding_is_the_jax_int32_arithmetic():
    golden = np.int32(0x9E3779B1 - (1 << 32))
    for pos in (0, 1, 7, 31):
        with np.errstate(over="ignore"):
            want = int(np.int32(SEED) + np.int32(pos) * golden)
        assert fold_seed(SEED, pos) == want
    at = dict(data=1, fsdp=0, seq=1, model=1)
    assert shard_seed(SEED, MeshConfig(data=2, model=2), at) \
        == fold_seed(SEED, 3)
    assert shard_seed(SEED, MeshConfig(data=2, seq=2, model=2), at) \
        == fold_seed(SEED, 3 * 2 + 1 + 1)


# The meshes the runtime route runs on, 4 gloo ranks each.
RUNTIME_MESHES = {"data2xmodel2": dict(data=2, model=2),
                  "data2xseq2": dict(data=2, seq=2)}


@pytest.fixture(scope="module")
def runtime(tmp_path_factory):
    """mesh id -> the 4 ranks' results of the worker's 'attn' role (one
    spawn: both meshes over the same ranks)."""
    d = tmp_path_factory.mktemp("attn")
    for dh in (32, 128):
        np.savez(os.path.join(d, f"qkv{dh}.npz"),
                 **dict(zip(("q", "k", "v", "do"), _inputs(dh))))
    ranks = worker.run("attn", 4, dict(
        meshes=RUNTIME_MESHES, head_dims=[32, 128], rate=RATE,
        generator_seed=GENERATOR_SEED), str(d))
    return {mesh_id: [r[mesh_id] for r in ranks]
            for mesh_id in RUNTIME_MESHES}


@pytest.mark.parametrize("mesh_id,dh,route", [
    ("data2xmodel2", 32, "sharded"), ("data2xmodel2", 128, "packed"),
    ("data2xseq2", 32, "seq"), ("data2xseq2", 128, "seq")])
def test_runtime_route_on_gloo_ranks_matches_jax(runtime, mesh_id, dh,
                                                 route):
    """Each rank's output and gradients (under 'seq' its own time block of
    dK and dV, reduce-scattered) against its block of the JAX route."""
    axes = RUNTIME_MESHES[mesh_id]
    cfg = MeshConfig(**axes)
    theirs = _jax(tuple(axes.items()), dh, route)
    rb, hb, tb = B // (cfg.data * cfg.fsdp), H // cfg.model, T // cfg.seq
    for rank, res in enumerate(runtime[mesh_id]):
        d, f, s, m = res["at"]
        r = d * cfg.fsdp + f
        blk = np.s_[r * rb:(r + 1) * rb, m * hb:(m + 1) * hb,
                    s * tb:(s + 1) * tb]
        for name, got, want in zip(("o", "dq", "dk", "dv"), res[dh],
                                   theirs):
            np.testing.assert_allclose(got.numpy(), want[blk], atol=1e-6,
                                       rtol=1e-6,
                                       err_msg=f"rank {rank} {name}")


@pytest.mark.parametrize("mesh_id,kind,axis", [
    ("data2xmodel2", "rows", "'data', 'fsdp'"),
    ("data2xmodel2", "heads", "'model'"),
    ("data2xseq2", "rows", "'data', 'fsdp'"),
    ("data2xseq2", "time", "'seq'")])
def test_indivisible_shapes_raise(runtime, mesh_id, kind, axis):
    """The runtime's checks (split_rows, shard_model, comm.seq_block)
    raise a ValueError naming the axis on every rank; an axis of size 1
    divides everything."""
    axes = RUNTIME_MESHES[mesh_id]
    for res in runtime[mesh_id]:
        assert res["raises"][kind] is not None, kind
        assert re.search(re.escape(axis), res["raises"][kind])
        for other, size in (("heads", axes.get("model", 1)),
                            ("time", axes.get("seq", 1))):
            if size == 1:
                assert res["raises"][other] is None, other


def test_packed_views_round_trip():
    x = torch.arange(2 * 5 * 8.).reshape(2, 5, 8)
    assert torch.equal(merge_heads(split_heads(x, 2)), x)
