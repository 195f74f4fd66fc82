"""The bfloat16 flash kernels' Hopper design (csrc/flash_fwd_wgmma.cu,
csrc/flash_bwd_wgmma.cu, csrc/wgmma_tma.cuh), checked on the CPU.

No card runs here, so each part of the design that fixes a result is
mirrored in numpy and held against the reference:

(a) the tile schedules: 64-key (forward, dQ) and 64-query (dK/dV) tiles,
    the softmax in the exp2 domain, p rounded to bf16 after each tile's
    running max, pd and ds rounded before their products, against the
    Pallas kernels in interpret mode;
(b) the fragment maps of `wgmma.m64nNk16` (accumulator, register A
    operand): the keep bits the kernels gather through them are
    `keep_mask`'s, and two accumulator chunks are the A fragment the
    kernels feed;
(c) the layouts: the 128- and 64-byte swizzles TMA writes, and the
    `wgmma` descriptors (start address, LBO, SBO, layout type) of every
    K-major and MN-major tile, at each head dim;
(d) the budgets: shared memory per instance, and the grids at the scaled
    shapes.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from av_separation_torch.ops.kernels.attention import (hash_tiles,
                                                       keep_mask,
                                                       keep_threshold)

SEED = -1234567
LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)
HEAD_DIMS = (32, 64, 128, 256)
SMEM_LIMIT = 232448  # bytes a block may use on the H100


def rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def bf16(x: np.ndarray) -> np.ndarray:
    """float32 rounded to bf16 (nearest even) and back."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)) \
        .bfloat16().float().numpy()


def bf16_tol(ref: np.ndarray, ulps: int = 2) -> float:
    peak = max(float(np.abs(ref).max()), 2.0 ** -126)
    return ulps * 2.0 ** (math.floor(math.log2(peak)) - 7)


# ---------------------------------------------------------------------------
# (a) tile schedules
# ---------------------------------------------------------------------------

def wgmma_fwd_emulated(q, k, v, rate, seed, bk=64):
    """The forward's schedule in float32: 64-key tiles, s2 = s scale log2 e,
    running max m2, p = exp2(s2 - m2) rounded to bf16 before P V (l sums
    the unrounded p), o = acc / (l (1 - rate)) in bf16, lse = (m2 + log2 l)
    ln 2."""
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    sl2 = np.float32(1.0 / math.sqrt(dh)) * LOG2E
    keep = keep_mask(seed, b, h, tq, tk, rate).numpy() if rate > 0 \
        else np.ones((b, h, tq, tk), bool)
    m = np.full((b, h, tq), -np.inf, np.float32)
    l = np.zeros((b, h, tq), np.float32)
    acc = np.zeros((b, h, tq, dh), np.float32)
    for k0 in range(0, tk, bk):
        s2 = np.einsum("bhqd,bhkd->bhqk", q, k[:, :, k0:k0 + bk]) * sl2
        mn = np.maximum(m, s2.max(-1))
        alpha = np.exp2(m - mn)
        p = np.exp2(s2 - mn[..., None])
        l = l * alpha + p.sum(-1)
        pk = np.where(keep[..., k0:k0 + bk], p, 0)
        acc = acc * alpha[..., None] + np.einsum(
            "bhqk,bhkd->bhqd", bf16(pk), v[:, :, k0:k0 + bk])
        m = mn
    o = bf16(acc / (l * np.float32(1 - rate))[..., None])
    return o, (m + np.log2(l)) * LN2


def wgmma_bwd_emulated(q, k, v, o, do, lse, rate, seed, bt=64):
    """The backward's schedules in float32: dK/dV over 64-query tiles,
    dQ over 64-key tiles, p = exp2(s scale log2 e - lse log2 e), pd and ds
    rounded to bf16 before their products, dq, dk, dv stored in bf16."""
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    scale = np.float32(1.0 / math.sqrt(dh))
    sl2 = scale * LOG2E
    keep = keep_mask(seed, b, h, tq, tk, rate).numpy() if rate > 0 \
        else np.ones((b, h, tq, tk), bool)
    inv = np.float32(1.0 / (1.0 - rate))
    delta = (do * o).sum(-1)
    l2 = lse * LOG2E

    def ds_pd(qs, ks):
        s = np.einsum("bhqd,bhkd->bhqk", q[:, :, qs], k[:, :, ks])
        p = np.exp2(s * sl2 - l2[:, :, qs, None])
        dp = np.einsum("bhqd,bhkd->bhqk", do[:, :, qs], v[:, :, ks])
        kp = keep[:, :, qs, ks]
        pd = np.where(kp, p * inv, 0)
        ds = p * (np.where(kp, dp * inv, 0) - delta[:, :, qs, None]) * scale
        return bf16(pd), bf16(ds)

    dq = np.zeros_like(q)
    dk = np.zeros_like(k)
    dv = np.zeros_like(v)
    for r0 in range(0, tq, bt):
        qs = slice(r0, r0 + bt)
        pd, ds = ds_pd(qs, slice(0, tk))
        dv += np.einsum("bhqk,bhqd->bhkd", pd, do[:, :, qs])
        dk += np.einsum("bhqk,bhqd->bhkd", ds, q[:, :, qs])
    for k0 in range(0, tk, bt):
        ks = slice(k0, k0 + bt)
        _, ds = ds_pd(slice(0, tq), ks)
        dq += np.einsum("bhqk,bhkd->bhqd", ds, k[:, :, ks])
    return bf16(dq), bf16(dk), bf16(dv)


# (label, q shape, k shape): the scaled audio self-attention at a small
# batch, the default model's dh 64, the demo's cross-attention (split,
# 63 x 50), the tiled route (T 1024) and the wide head.
SCHEDULE_SHAPES = {
    "audio self dh128": ((1, 1, 501, 128), (1, 1, 501, 128)),
    "dh64": ((1, 2, 130, 64), (1, 2, 130, 64)),
    "split dh32 63x50": ((2, 2, 63, 32), (2, 2, 50, 32)),
    "tiled T1024": ((1, 1, 1024, 64), (1, 1, 1024, 64)),
    "dh256": ((1, 1, 200, 256), (1, 1, 200, 256)),
}


class TestTileSchedules:
    # The emulation and the Pallas kernels round at the same points (p,
    # pd, ds and the outputs in bf16) but sum in another order and take p
    # as exp2 of a scaled s against exp of s - m: a rounding of p or of an
    # output may flip, so 2 bf16 ulps at each output's peak; lse is float32
    # from float32 sums, 1e-4.
    @pytest.mark.parametrize("rate", [0.0, 0.1])
    @pytest.mark.parametrize("label", list(SCHEDULE_SHAPES))
    def test_matches_pallas_interpret(self, label, rate):
        import jax
        from av_separation_tpu.ops.pallas.attention import flash_attention
        qs, ks = SCHEDULE_SHAPES[label]
        q, k, v, do = (bf16(rand(s, i)) for i, s in
                       enumerate((qs, ks, ks, qs), 21))
        o, lse = wgmma_fwd_emulated(q, k, v, rate, SEED)
        grads = wgmma_bwd_emulated(q, k, v, o, do, lse, rate, SEED)
        seed = jnp.asarray([SEED], jnp.int32)
        with pltpu.force_tpu_interpret_mode():
            o_j, vjp = jax.vjp(lambda *a: flash_attention(
                *a, dropout_rate=rate, dropout_seed=seed),
                *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)))
            want = vjp(jnp.asarray(do).astype(jnp.bfloat16))
        f32 = lambda x: np.asarray(jnp.asarray(x).astype(jnp.float32))
        o_j = f32(o_j)
        np.testing.assert_allclose(o, o_j, atol=bf16_tol(o_j), rtol=0)
        s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k) \
            / math.sqrt(qs[-1])
        mx = s.max(-1)
        lse_ref = mx + np.log(np.exp(s - mx[..., None]).sum(-1))
        np.testing.assert_allclose(lse, lse_ref, atol=1e-4)
        for name, g, w in zip("qkv", grads, want):
            w = f32(w)
            np.testing.assert_allclose(g, w, atol=bf16_tol(w), rtol=0,
                                       err_msg=name)


# ---------------------------------------------------------------------------
# (b) fragment maps, as wgmma_tma.cuh states them
# ---------------------------------------------------------------------------

def acc_map(w: int, lane: int, reg: int):
    """(row, column) of accumulator register `reg` of lane `lane`, warp `w`
    of the warpgroup, in an m64nNk16 product: 4n + 2hh + e holds row
    16w + g + 8hh, column 8n + 2t + e (lane = 4g + t)."""
    g, t = lane >> 2, lane & 3
    n, hh, e = reg // 4, (reg // 2) % 2, reg % 2
    return 16 * w + g + 8 * hh, 8 * n + 2 * t + e


def a_map(w: int, lane: int, reg: int, half: int):
    """(row, k) of half `half` of A register `reg` (0-3) of a register A
    operand of a k16 product: register 2j + hh holds row 16w + g + 8hh,
    k 8j + 2t + half."""
    g, t = lane >> 2, lane & 3
    j, hh = reg // 2, reg % 2
    return 16 * w + g + 8 * hh, 8 * j + 2 * t + half


def acc_as_a(acc_regs, j):
    """`acc_as_a` of wgmma_tma.cuh: registers 8j..8j+7 of a lane as the four
    A registers (each two values, low half first)."""
    return [(acc_regs[8 * j + 2 * r], acc_regs[8 * j + 2 * r + 1])
            for r in range(4)]


M32 = 0xFFFFFFFF


def murmur(x):
    x = x.astype(np.uint64) & M32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & M32
    x ^= x >> 16
    return x


def kernel_keep(seed, bh, row, key, hq, hk, rate, per_tile="keys", t0=0):
    """The keep test as the wgmma kernels compute it: the row part per row
    (hash_row), the key part per tile (key-tile term of the tile's first
    key `t0`, in-tile offset from it) in the forward and dQ kernels, or
    the query part per tile in the dK/dV kernel."""
    seed32 = np.uint64(seed & M32)
    row, key = np.asarray(row, np.uint64), np.asarray(key, np.uint64)
    base = (seed32 * 0x9E3779B9 & M32) ^ (np.uint64(bh) * 0x85EBCA6B & M32)
    if per_tile == "keys":
        rtile = base ^ ((row // hq) * 0xC2B2AE35 & M32)
        rterm = (row % hq) * 0x01000193 & M32
        ktile = np.uint64(t0 // hk) * 0x27D4EB2F & M32
        kterm = (np.uint64(t0 % hk) + key - np.uint64(t0)) * 0x61C88647 & M32
    else:
        rtile = base ^ (np.uint64(t0 // hq) * 0xC2B2AE35 & M32)
        rterm = (np.uint64(t0 % hq) + row - np.uint64(t0)) * 0x01000193 & M32
        ktile = (key // hk) * 0x27D4EB2F & M32
        kterm = (key % hk) * 0x61C88647 & M32
    x = (rterm + kterm + (rtile ^ ktile)) & M32
    return murmur(x) >= keep_threshold(rate)


class TestFragmentMaps:
    def test_accumulator_map_is_a_bijection(self):
        seen = {acc_map(w, lane, r) for w in range(4) for lane in range(32)
                for r in range(32)}
        assert seen == {(i, j) for i in range(64) for j in range(64)}

    @pytest.mark.parametrize("tq,tk", [(501, 501), (63, 50), (1024, 1024),
                                       (200, 700)])
    def test_keep_bits_through_the_maps_are_keep_mask(self, tq, tk):
        """Forward and dQ (rows are queries, 64-key tiles) and dK/dV (rows
        are keys, 64-query tiles): every tile's bits, gathered lane by lane
        and register by register, are keep_mask's."""
        rate, bh = 0.1, 3
        hq, hk = hash_tiles(tq, tk)
        want = keep_mask(SEED, 1, 4, tq, tk, rate).numpy()[0, bh]
        regs = [(w, lane, r) for w in range(4) for lane in range(32)
                for r in range(32)]
        rows = np.array([acc_map(*x)[0] for x in regs], np.int64)
        cols = np.array([acc_map(*x)[1] for x in regs], np.int64)
        for r0 in range(0, tq, 64):
            for c0 in range(0, tk, 64):
                q, kk = r0 + rows, c0 + cols
                ok = (q < tq) & (kk < tk)
                got = kernel_keep(SEED, bh, q[ok], kk[ok], hq, hk, rate,
                                  "keys", c0)
                np.testing.assert_array_equal(got, want[q[ok], kk[ok]])
                # dK/dV: accumulator rows are keys, columns queries.
                kk2, q2 = c0 + rows, r0 + cols
                ok2 = (q2 < tq) & (kk2 < tk)
                got2 = kernel_keep(SEED, bh, q2[ok2], kk2[ok2], hq, hk,
                                   rate, "queries", r0)
                np.testing.assert_array_equal(got2, want[q2[ok2], kk2[ok2]])

    def test_two_accumulator_chunks_are_the_a_fragment(self):
        x = np.arange(64 * 64, dtype=np.int64).reshape(64, 64)
        for w in range(4):
            for lane in range(32):
                regs = [x[acc_map(w, lane, r)] for r in range(32)]
                for j in range(4):  # k16 step j: columns 16j..16j+15
                    a = acc_as_a(regs, j)
                    for r in range(4):
                        for half in range(2):
                            row, kcol = a_map(w, lane, r, half)
                            assert a[r][half] == x[row, 16 * j + kcol]


# ---------------------------------------------------------------------------
# (c) layouts and descriptors, as wgmma_tma.cuh computes them
# ---------------------------------------------------------------------------

def panel(dh):
    cw = min(dh, 64)
    rb = 2 * cw
    return dict(cw=cw, rb=rb, chunks=dh // cw, chunk_bytes=64 * rb,
                layout=1 if rb == 128 else 2, bits=3 if rb == 128 else 2)


def swizzle(addr, bits):
    """Swizzle<bits, 4, 3>: the 16-byte unit (address bits 4..) XOR bits
    7.. of the address."""
    return addr ^ (((addr >> 7) & ((1 << bits) - 1)) << 4)


def tma_offset(dh, r, c):
    """Byte of element (row r, column c) of a panel as TMA lands it: chunk
    c // CW at chunk_bytes apart, row r at RB bytes, swizzled."""
    p = panel(dh)
    chunk, cc = divmod(c, p["cw"])
    return chunk * p["chunk_bytes"] + swizzle(r * p["rb"] + 2 * cc,
                                              p["bits"])


def make_desc(addr, lbo, sbo, layout):
    return ((addr & 0x3FFFF) >> 4) | (((lbo >> 4) & 0x3FFF) << 16) \
        | (((sbo >> 4) & 0x3FFF) << 32) | (layout << 62)


def fields(desc):
    return dict(start=(desc & 0x3FFF) << 4, lbo=((desc >> 16) & 0x3FFF) << 4,
                sbo=((desc >> 32) & 0x3FFF) << 4, layout=desc >> 62)


def desc_k(dh, base, kk):
    p = panel(dh)
    col = 16 * kk
    addr = base + (col // p["cw"]) * p["chunk_bytes"] + (col % p["cw"]) * 2
    return make_desc(addr, 16, 8 * p["rb"], p["layout"])


def desc_mn(dh, base, kk, chunk):
    p = panel(dh)
    addr = base + chunk * p["chunk_bytes"] + 16 * kk * p["rb"]
    return make_desc(addr, p["chunk_bytes"], 8 * p["rb"], p["layout"])


def wgmma_k_major(f, atom_rb, bits, m, k):
    """Byte the tensor core reads for operand element (row m, k) of a
    K-major swizzled descriptor: 8-row atoms at SBO, rows atom_rb apart,
    k along the row, the swizzle on the absolute address."""
    return swizzle(f["start"] + (m // 8) * f["sbo"] + (m % 8) * atom_rb
                   + 2 * k, bits)


def wgmma_mn_major(f, atom_rb, bits, k, n):
    """The same for an MN-major descriptor: k rows atom_rb apart in 8-row
    groups at SBO, n along the row in groups of atom_rb / 2 at LBO."""
    per = atom_rb // 2
    return swizzle(f["start"] + (k // 8) * f["sbo"] + (k % 8) * atom_rb
                   + (n // per) * f["lbo"] + 2 * (n % per), bits)


class TestLayouts:
    @pytest.mark.parametrize("dh", HEAD_DIMS)
    def test_tma_layout_is_a_bijection(self, dh):
        offs = [tma_offset(dh, r, c) for r in range(64) for c in range(dh)]
        assert sorted(offs) == list(range(0, 64 * dh * 2, 2))

    @pytest.mark.parametrize("dh", HEAD_DIMS)
    def test_k_major_descriptors_read_what_tma_wrote(self, dh):
        p = panel(dh)
        base = 3 * 1024 * 16  # a panel at a 1024-byte aligned offset
        for kk in range(dh // 16):
            f = fields(desc_k(dh, base, kk))
            assert f["layout"] == p["layout"] and f["sbo"] == 8 * p["rb"]
            assert f["lbo"] == 16
            for m in range(64):
                for k in range(16):
                    got = wgmma_k_major(f, p["rb"], p["bits"], m, k) - base
                    assert got == tma_offset(dh, m, 16 * kk + k)

    @pytest.mark.parametrize("dh", HEAD_DIMS)
    def test_mn_major_descriptors_read_what_tma_wrote(self, dh):
        """V (P V), dO (dV), Q (dK), K (dQ): k is the panel's row, n its
        column; one n64 (n32 at dh 32) product per chunk."""
        p = panel(dh)
        base = 5 * 1024 * 16
        for chunk in range(p["chunks"]):
            for kk in range(4):
                f = fields(desc_mn(dh, base, kk, chunk))
                assert f["layout"] == p["layout"]
                assert (f["sbo"], f["lbo"]) == (8 * p["rb"],
                                                p["chunk_bytes"])
                for k in range(16):
                    for n in range(p["cw"]):
                        got = wgmma_mn_major(f, p["rb"], p["bits"], k, n)
                        assert got - base == tma_offset(
                            dh, 16 * kk + k, chunk * p["cw"] + n)

    def test_descriptor_fields_fit(self):
        # 14-bit fields in 16-byte units: addresses below 256 KB, offsets
        # below 256 KB; the largest panel offset of any instance is 192 KB.
        for dh in HEAD_DIMS:
            d = desc_mn(dh, 200 * 1024, 3, panel(dh)["chunks"] - 1)
            f = fields(d)
            assert f["start"] == 200 * 1024 + (panel(dh)["chunks"] - 1) \
                * panel(dh)["chunk_bytes"] + 48 * panel(dh)["rb"]


# ---------------------------------------------------------------------------
# (d) budgets
# ---------------------------------------------------------------------------

def ring(fixed, stage, rows=0):
    """(stages, block bytes) as the layouts compute them: the fixed panels,
    as many stages (and per-stage rows) as fit in 227 KB, up to 4, 1024
    bytes of alignment slack and the barriers."""
    stages = min(4, (SMEM_LIMIT - 1024 - 8 * 9 - fixed) // (stage + rows))
    return stages, 1024 + fixed + stages * (stage + rows) \
        + 8 * (1 + 2 * stages)


def fwd_smem(dh, nc):
    pb = 128 * dh  # a 64-row panel in bf16
    return ring(nc * pb, 2 * pb)


def dkv_smem(dh):
    """K and V panels; per stage Q and dO, the rows' lse and delta, and
    the 64 x 64 float32 P^T handed between the two consumers."""
    pb = 128 * dh
    return ring(2 * pb, 2 * pb, rows=2 * 64 * 4 + 64 * 64 * 4)


def dq_smem(dh, nc):
    pb = 128 * dh
    return ring(2 * nc * pb, 2 * pb)


def plan(kind, b, h, tq, tk, dh, sms=132):
    """(consumer warpgroups, grid) as the launchers choose them: the
    forward takes one 64-row warpgroup a block where that grid gives each
    block an SM of its own (and at dh 256), else two; dK/dV one warpgroup
    for dV and one for dK over 64 keys (dh 256 in two column groups); dQ
    as the forward."""
    cdiv = lambda a, n: -(-a // n)
    if kind == "fwd":
        nc = 1 if dh == 256 or cdiv(tq, 64) * b * h <= sms else 2
        return nc, (cdiv(tq, 64 * nc), b * h, 1)
    if kind == "dkv":
        return 2, (cdiv(tk, 64), b * h, 2 if dh == 256 else 1)
    nc = 1 if dh == 256 or cdiv(tq, 64) * b * h <= sms else 2
    return nc, (cdiv(tq, 64 * nc), b * h, 1)


class TestBudgets:
    @pytest.mark.parametrize("dh", HEAD_DIMS)
    def test_shared_memory_fits(self, dh):
        # Every instance the launchers use: at least two stages within a
        # block's 227 KB.
        used = [fwd_smem(dh, 1), dkv_smem(dh)]
        if dh < 256:
            used += [fwd_smem(dh, 2), dq_smem(dh, 2)]
        else:
            used += [dq_smem(dh, 1)]
            # why dh 256 takes one dQ warpgroup: two leave no ring
            assert dq_smem(256, 2)[0] < 2
        for stages, nbytes in used:
            assert 2 <= stages <= 4 and nbytes <= SMEM_LIMIT

    @pytest.mark.parametrize("dh,fwd,dkv,dq", [
        (32, 4, 4, 4), (64, 4, 4, 4), (128, 4, 3, 4), (256, 3, 2, 2)])
    def test_ring_depth(self, dh, fwd, dkv, dq):
        nc = 1 if dh == 256 else 2
        assert (fwd_smem(dh, nc)[0], dkv_smem(dh)[0],
                dq_smem(dh, nc)[0]) == (fwd, dkv, dq)

    @pytest.mark.parametrize("kind,shape,want", [
        # scaled audio self-attention B8 H4 T501 dh128: 128-row blocks
        ("fwd", (8, 4, 501, 501, 128), (2, (4, 32, 1))),
        ("dkv", (8, 4, 501, 501, 128), (2, (8, 32, 1))),
        ("dq", (8, 4, 501, 501, 128), (2, (4, 32, 1))),
        # the bench's demo batch B128 H4 T63 dh32
        ("fwd", (128, 4, 63, 63, 32), (2, (1, 512, 1))),
        ("dkv", (128, 4, 63, 50, 32), (2, (1, 512, 1))),
        # the wide head B8 H2 T501 dh256: dK/dV in two column groups
        ("fwd", (8, 2, 501, 501, 256), (1, (8, 16, 1))),
        ("dkv", (8, 2, 501, 501, 256), (2, (8, 16, 2))),
        ("dq", (8, 2, 501, 501, 256), (1, (8, 16, 1))),
        # T 1024 B2 H4 and the visual self-attention B8 H4 T200: 64-row
        # blocks, one an SM
        ("fwd", (2, 4, 1024, 1024, 128), (1, (16, 8, 1))),
        ("dq", (2, 4, 1024, 1024, 128), (1, (16, 8, 1))),
        ("fwd", (8, 4, 200, 200, 128), (1, (4, 32, 1))),
    ])
    def test_grids_at_the_scaled_shapes(self, kind, shape, want):
        assert plan(kind, *shape) == want
