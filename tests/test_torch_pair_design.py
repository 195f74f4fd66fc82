"""The float32 flash kernels at head dim 256 (dh 129-256, zero-padded) in
numpy, on the CPU.

`pair_fwd_emulated` / `pair_bwd_emulated` follow the schedule and order
of sums of csrc/flash_attn_fwd.cu `flash_fwd_kernel_pair` and
csrc/flash_attn_bwd.cu `flash_bwd_dkv_kernel_pair` /
`flash_bwd_dq_kernel_pair`: one 8-warp block owns 64 rows (keys in
dK/dV), warps w and w + 4 the same 16 and one 128-column half each.  Per
tile (32 keys forward, 16 query rows in dK/dV, 16 keys in dQ) each half
computes its partial q k^T (and dO v^T) over its own columns in 3xTF32,
each adds its partner's partial to its own (a sum of two floats does not
depend on their order: both hold S_0 + S_1), both run the same softmax
(or form the same P, Pd, dS), and each accumulates its own columns of o
(dv, dk; dq).  They are held against the plain float32 versions
(`flash_attn_fwd_torch`, `flash_attn_bwd_torch`) at the true dh, check
that both halves hold the same S and dP bit for bit, and count the chunk
products (one 128-column matrix product) each tile pair takes.  The
budget tests check the shared memory of the layouts, a copy of the .cu
arithmetic kept here.
"""

import numpy as np
import pytest
import torch

from av_separation_torch.ops.kernels.attention import (
    WIDE_CHUNK, flash_attn_bwd_torch, flash_attn_fwd_torch, keep_mask,
    padded_head_dim)

SEED = -1234567
ROWS = 64          # rows (keys in dK/dV) a block
FWD_KEYS = 32      # keys a forward tile
BWD_TILE = 16      # query rows (dK/dV) or keys (dQ) a backward tile
WIDTH = 256        # the padded head dim
HALVES = [slice(c * WIDE_CHUNK, (c + 1) * WIDE_CHUNK)
          for c in range(WIDTH // WIDE_CHUNK)]
SMEM_LIMIT = 232448    # bytes a block may take on an H100
SMEM_SM = 233472       # bytes of an SM's shared memory, 1 KB a block kept


def rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def split_tf32(x):
    """x -> (big, small) as the kernels' `split` gives them to the tensor
    cores: the top 10 mantissa bits, and those of x - big."""
    mask = np.uint32(0xFFFFE000)
    x = np.asarray(x, np.float32)
    big = (x.view(np.uint32) & mask).view(np.float32)
    small = ((x - big).view(np.uint32) & mask).view(np.float32)
    return big, small


class Products:
    """3xTF32 chunk products (big*small + small*big + big*big, each exact,
    summed in float64 and rounded to float32), counted by pass."""

    def __init__(self):
        self.n = {"fwd": 0, "dkv": 0, "dq": 0}

    def mm(self, kind, a, b):
        self.n[kind] += 1
        ab, as_ = split_tf32(a)
        bb, bs = split_tf32(b)
        f64 = np.float64
        acc = ab.astype(f64) @ bb.astype(f64) + as_.astype(f64) @ bb \
            + ab.astype(f64) @ bs
        return acc.astype(np.float32)


def pair_sum(product):
    """Each half's sum of the two halves' partials, product(half) over its
    own 128 columns: its own plus its partner's (`pair_sum`).  Returns
    half 0's (chunk 0 + chunk 1) and whether half 1's is the same bit for
    bit."""
    parts = [product(c) for c in HALVES]
    mine = [parts[0] + parts[1], parts[1] + parts[0]]
    return mine[0], np.array_equal(mine[0], mine[1])


def padded(arrays, dh):
    return [np.pad(a, ((0, 0), (0, WIDTH - dh))) for a in arrays]


def pair_fwd_emulated(q, k, v, rate, seed, scale, count):
    """(Tq, 256), (Tk, 256) for one head -> (o, lse, halves_equal): 64-row
    blocks over 32-key tiles, S = S_0 + S_1 in both halves, the online
    softmax on it, each half's O columns += P V_c."""
    f32 = np.float32
    tq, tk = q.shape[0], k.shape[0]
    scale = f32(scale)
    keep = keep_mask(seed, 1, 1, tq, tk, rate).numpy()[0, 0] if rate \
        else np.ones((tq, tk), bool)
    o = np.zeros_like(q)
    lse = np.zeros(tq, f32)
    same = True
    for r0 in range(0, tq, ROWS):
        rows = slice(r0, r0 + ROWS)
        n = q[rows].shape[0]
        m = np.full(n, -np.inf, f32)
        l = np.zeros(n, f32)
        acc = [np.zeros((n, WIDE_CHUNK), f32) for _ in HALVES]
        for k0 in range(0, tk, FWD_KEYS):
            keys = slice(k0, k0 + FWD_KEYS)
            s, eq = pair_sum(lambda c: count.mm("fwd", q[rows, c],
                                                k[keys, c].T))
            same &= eq
            s = s * scale
            mn = np.maximum(m, s.max(1))
            alpha = np.exp(m - mn).astype(f32)
            p = np.exp(s - mn[:, None]).astype(f32)
            l = l * alpha + p.sum(1, dtype=f32)
            p = np.where(keep[rows, keys], p, f32(0))
            for i, c in enumerate(HALVES):
                acc[i] = acc[i] * alpha[:, None] + count.mm("fwd", p,
                                                            v[keys, c])
            m = mn
        for i, c in enumerate(HALVES):
            o[rows, c] = acc[i] / (l * f32(1.0 - rate))[:, None]
        lse[rows] = m + np.log(l)
    return o, lse, same


def pair_bwd_emulated(q, k, v, o, do, lse, rate, seed, scale, count):
    """(dq, dk, dv, halves_equal) for one head at width 256: the dK/dV pass
    over 64-key blocks and 16-row query tiles, the dQ pass over 64-row
    blocks and 16-key tiles; S and dP summed over the halves in both,
    each half's own columns of the gradients."""
    f32 = np.float32
    tq, tk = q.shape[0], k.shape[0]
    scale = f32(scale)
    inv = f32(1.0) / f32(1.0 - rate)
    keep = keep_mask(seed, 1, 1, tq, tk, rate).numpy()[0, 0] if rate \
        else np.ones((tq, tk), bool)
    delta = (do * o).sum(1, dtype=f32)
    dq, dk, dv = np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)
    same = True
    for k0 in range(0, tk, ROWS):  # dK/dV
        keys = slice(k0, k0 + ROWS)
        for r0 in range(0, tq, BWD_TILE):
            rows = slice(r0, r0 + BWD_TILE)
            st, eq0 = pair_sum(lambda c: count.mm("dkv", k[keys, c],
                                                  q[rows, c].T))
            dpt, eq1 = pair_sum(lambda c: count.mm("dkv", v[keys, c],
                                                   do[rows, c].T))
            same &= eq0 and eq1
            p = np.exp(st * scale - lse[None, rows]).astype(f32)
            kt = keep[rows, keys].T
            pd = np.where(kt, p * inv, f32(0))
            ds = p * (np.where(kt, dpt * inv, f32(0)) - delta[None, rows]) \
                * scale
            for c in HALVES:
                dv[keys, c] += count.mm("dkv", pd, do[rows, c])
                dk[keys, c] += count.mm("dkv", ds, q[rows, c])
    for r0 in range(0, tq, ROWS):  # dQ
        rows = slice(r0, r0 + ROWS)
        for k0 in range(0, tk, BWD_TILE):
            keys = slice(k0, k0 + BWD_TILE)
            s, eq0 = pair_sum(lambda c: count.mm("dq", q[rows, c],
                                                 k[keys, c].T))
            dp, eq1 = pair_sum(lambda c: count.mm("dq", do[rows, c],
                                                  v[keys, c].T))
            same &= eq0 and eq1
            p = np.exp(s * scale - lse[rows, None]).astype(f32)
            ds = p * (np.where(keep[rows, keys], dp * inv, f32(0))
                      - delta[rows, None]) * scale
            for c in HALVES:
                dq[rows, c] += count.mm("dq", ds, k[keys, c])
    return dq, dk, dv, same


def _case(dh, rate):
    """Inputs at Tq = Tk = 101 (a partial row block, partial tiles at both
    edges), the plain float32 version's outputs at the true dh, and the
    emulation's at the padded width, sliced back."""
    t = 101
    q, k, v, do = (rand((t, dh), s) for s in (80, 81, 82, 83))
    ts = [torch.from_numpy(x)[None, None] for x in (q, k, v, do)]
    o_ref, lse_ref = flash_attn_fwd_torch(*ts[:3], rate, SEED)
    g_ref = flash_attn_bwd_torch(*ts[:3], o_ref, ts[3], lse_ref, rate, SEED)
    scale = 1.0 / np.sqrt(dh)
    qp, kp, vp, dop = padded((q, k, v, do), dh)
    count = Products()
    o, lse, same_fwd = pair_fwd_emulated(qp, kp, vp, rate, SEED, scale,
                                         count)
    grads = pair_bwd_emulated(qp, kp, vp, o, dop, lse, rate, SEED, scale,
                              count)
    ref = (o_ref[0, 0].numpy(), lse_ref[0, 0].numpy(),
           [g[0, 0].numpy() for g in g_ref])
    got = (o[:, :dh], lse, [g[:, :dh] for g in grads[:3]])
    return got, ref, same_fwd and grads[3]


class TestPairSchedule:
    # dh 256 and dh 200 (zero-padded to 256, the softmax scale of 200), at
    # the card's tolerances above dh 128 (3e-5 on o and the gradients: S
    # sums 256 products; 1e-4 on lse).
    @pytest.mark.parametrize("rate", [0.0, 0.1])
    @pytest.mark.parametrize("dh", [200, 256])
    def test_forward_matches_plain(self, dh, rate):
        assert padded_head_dim(dh) == WIDTH
        (o, lse, _), (o_ref, lse_ref, _), same = _case(dh, rate)
        assert same
        assert np.abs(o - o_ref).max() <= 3e-5
        assert np.abs(lse - lse_ref).max() <= 1e-4

    @pytest.mark.parametrize("rate", [0.0, 0.1])
    @pytest.mark.parametrize("dh", [200, 256])
    def test_backward_matches_plain(self, dh, rate):
        (_, _, grads), (_, _, ref), same = _case(dh, rate)
        assert same
        for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
            assert np.abs(g - r).max() <= 3e-5, name


class TestPairProducts:
    @pytest.mark.parametrize("dh", [200, 256])
    def test_each_chunk_product_once_a_tile_pair(self, dh):
        # One 64-row block against 128 keys: 4 chunk products a tile pair
        # forward, 8 in dK/dV and 6 in dQ backward (14), where the column
        # split it replaced took 6 and 22 (each 128-column group's block
        # recomputing the 256-column S, and dP).
        tq, tk = ROWS, 2 * ROWS
        q, k, v, do = padded([rand((t, dh), i) for i, t in
                              enumerate((tq, tk, tk, tq))], dh)
        count = Products()
        o, lse, _ = pair_fwd_emulated(q, k, v, 0.0, SEED, 1 / np.sqrt(dh),
                                      count)
        pair_bwd_emulated(q, k, v, o, do, lse, 0.0, SEED, 1 / np.sqrt(dh),
                          count)
        pairs_fwd = tk // FWD_KEYS
        pairs_dkv = (tk // ROWS) * (tq // BWD_TILE)
        pairs_dq = (tq // ROWS) * (tk // BWD_TILE)
        assert pairs_dkv == pairs_dq
        assert count.n["fwd"] == 4 * pairs_fwd
        assert count.n["dkv"] == 8 * pairs_dkv
        assert count.n["dkv"] + count.n["dq"] == 14 * pairs_dq


def pair_smem(kernel):
    """Shared memory (bytes) of one block of a pair kernel, as
    flash_attn_fwd.cu `PairLayout` and flash_attn_bwd.cu `PairDkvLayout` /
    `PairDqLayout` state it: the operands at full width in rows of 260
    floats and every warp's float4 partials (S, and dP in the backward)."""
    row = WIDTH + 4
    partials = 8 * 32 * 4 * (FWD_KEYS // 8 if kernel == "fwd"
                              else 2 * BWD_TILE // 8)
    if kernel == "fwd":
        floats = ROWS * row + 2 * 2 * FWD_KEYS * row
    elif kernel == "dkv":
        floats = 2 * ROWS * row + 2 * (2 * BWD_TILE * row + 4 * BWD_TILE)
    else:
        floats = 2 * ROWS * row + 2 * 2 * BWD_TILE * row
    return 4 * (floats + partials)


class TestPairBudget:
    @pytest.mark.parametrize("kernel", ["fwd", "dkv", "dq"])
    def test_shared_memory_fits_a_block(self, kernel):
        # One 8-warp block an SM: it fits a block, and two would not fit.
        assert pair_smem(kernel) <= SMEM_LIMIT
        assert 2 * (pair_smem(kernel) + 1024) > SMEM_SM

    def test_shared_memory_as_the_layouts_state(self):
        # The numbers the .cu layouts give (static_asserts there keep them
        # under the limit; chip_smoke.py's build phase reports what the
        # built libraries export).
        assert {k: pair_smem(k) for k in ("fwd", "dkv", "dq")} == {
            "fwd": 216064, "dkv": 216576, "dq": 216064}
