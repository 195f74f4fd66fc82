"""The flash kernels above head dim 256 (a thread-block cluster whose
blocks own 128-column chunks of the head dim) in numpy, on the CPU.

`cluster_fwd_emulated` / `cluster_bwd_emulated` follow the kernels'
schedule and order of sums (csrc/flash_attn_fwd.cu and flash_fwd_wgmma.cu
`*_cluster`, csrc/flash_attn_bwd.cu `flash_bwd_*_kernel_cluster`,
csrc/cluster.cuh): nc = dh / 128 chunks on C blocks, block r owning
chunks r, r + C, ... (one each up to 16 chunks, ceil(nc / 16) above);
per tile, each block's partial over its own chunks, summed in chunk
order; the sum of the C partials in block order (in the bf16 forward
each float4 slot of a thread's S by one block, the sums gathered by
all: the same sum); the online softmax (forward) or P, Pd, dS
(backward) on the whole sum; then each block's own columns of P V,
Pd^T dO, dS^T Q and dS K.  They are held against the plain versions
(`flash_attn_fwd_torch`, `flash_attn_bwd_torch`) at float32 and at the
bf16 rounding points, and count the chunk products each tile pair takes.
The budget tests check the launch plan, a copy of the .cu layouts'
arithmetic kept here (the kernels take theirs from the .cu files alone):
chunk ownership, shared memory, cluster sizes, grids, the scratch
buffer of the chunks a block owns after its first.
"""

import math

import numpy as np
import pytest
import torch

from av_separation_torch.ops.kernels.attention import (
    WIDE_CHUNK, _check, flash_attn_bwd_torch, flash_attn_fwd_torch,
    keep_mask, padded_head_dim)

# The plan of the cluster kernels, as csrc/cluster.cuh and the layouts
# (flash_attn_fwd.cu `ClusterLayout`, flash_fwd_wgmma.cu `ClusterLayout`,
# flash_attn_bwd.cu `ClusterDkvLayout` / `ClusterDqLayout`) state it: a
# cluster owns 64 rows (keys in dK/dV) and walks tiles of keys (forward:
# 32 at float32, 64 at bf16) or of 32 query rows / keys (backward); 4
# warps a block, 16 rows each (one warpgroup in the bf16 forward).
CLUSTER_PORTABLE = 8   # blocks a cluster may hold on any Hopper card
CLUSTER_MAX = 16       # ... with the non-portable attribute (H100)
CLUSTER_ROWS = 64
CLUSTER_FWD_KEYS = {torch.float32: 32, torch.bfloat16: 64}
CLUSTER_BWD_TILE = 32
THREADS = 128
SMEM_LIMIT = 232448    # bytes a block may take on an H100


def chunks_per_block(nc):
    return -(-nc // CLUSTER_MAX)


def cluster_blocks(nc):
    return -(-nc // chunks_per_block(nc))


def owned(rank, nc):
    """The chunks block `rank` owns, in the order it sums them."""
    size = cluster_blocks(nc)
    return [c for c in range(rank, nc, size)][:chunks_per_block(nc)]


def cluster_smem(kernel, dtype):
    """Shared memory (bytes) of one block of a cluster kernel: the
    operands of its first chunk and, in the backward, two exchange buffers
    of the partials (the forwards exchange through the K tiles they have
    consumed); the same at every head dim."""
    es = 2 if dtype == torch.bfloat16 else 4
    row = WIDE_CHUNK + 16 // es              # padded row, in elements
    if kernel == "fwd" and dtype == torch.bfloat16:
        # Two blocks' share of an SM (233,472 bytes less 1 KB a block).
        return (233472 - 2 * 1024) // 2
    if kernel == "fwd":
        keys = CLUSTER_FWD_KEYS[torch.float32]
        return 4 * (CLUSTER_ROWS * row + 2 * 2 * keys * row)
    xbuf = 2 * THREADS * (CLUSTER_BWD_TILE // 8) * 4   # S and dP, floats
    tile = CLUSTER_BWD_TILE * row
    stage = 2 * tile + (4 * CLUSTER_BWD_TILE * (4 // es)
                        if kernel == "dkv" else 0)
    return es * (2 * CLUSTER_ROWS * row + 2 * stage) + 4 * 2 * xbuf

SEED = -1234567
LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)


def rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def bf16_round(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)) \
        .bfloat16().float().numpy()


class Products:
    """Chunk products (one 128-column block's matrix product) by pass."""

    def __init__(self):
        self.n = {"fwd": 0, "dkv": 0, "dq": 0}

    def mm(self, kind, a, b):
        self.n[kind] += 1
        return (a @ b).astype(np.float32)


def in_order(parts):
    total = parts[0]
    for x in parts[1:]:
        total = total + x
    return total


def cluster_sum(product, dh):
    """sum over the cluster's blocks, in block order, of each block's
    partial: product(c) over its own chunks c, in chunk order, as every
    block (or a slot's block, in the bf16 forward) sums them."""
    nc = dh // WIDE_CHUNK
    return in_order([in_order([product(chunk(c)) for c in owned(r, nc)])
                     for r in range(cluster_blocks(nc))])


def chunk(c):
    return slice(c * WIDE_CHUNK, (c + 1) * WIDE_CHUNK)


def chunks(dh):
    return [chunk(c) for c in range(dh // WIDE_CHUNK)]


def cluster_fwd_emulated(q, k, v, rate, seed, bf16=False, count=None):
    """o, lse of the cluster forward, one (batch, head) and row tile at a
    time: float32 over 32-key tiles in the natural-exp domain
    (flash_attn_fwd.cu), bf16 over 64-key tiles in the exp2 domain with p
    rounded to bf16 before P V (flash_fwd_wgmma.cu)."""
    count = count or Products()
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    scale = np.float32(1.0 / math.sqrt(dh))
    keep = keep_mask(seed, b, h, tq, tk, rate).numpy() if rate > 0 \
        else np.ones((b, h, tq, tk), bool)
    o = np.zeros_like(q)
    lse = np.zeros((b, h, tq), np.float32)
    for bi in range(b):
        for hi in range(h):
            for r0 in range(0, tq, CLUSTER_ROWS):
                rows = slice(r0, r0 + CLUSTER_ROWS)
                qq = q[bi, hi, rows]
                n = qq.shape[0]
                m = np.full(n, -np.inf, np.float32)
                l = np.zeros(n, np.float32)
                acc = [np.zeros((n, WIDE_CHUNK), np.float32)
                       for _ in chunks(dh)]
                step = CLUSTER_FWD_KEYS[torch.bfloat16 if bf16
                                        else torch.float32]
                for k0 in range(0, tk, step):
                    keys = slice(k0, k0 + step)
                    s = cluster_sum(lambda c: count.mm(
                        "fwd", qq[:, c], k[bi, hi, keys, c].T), dh)
                    s = s * (scale * LOG2E if bf16 else scale)
                    mn = np.maximum(m, s.max(1))
                    ex = np.exp2 if bf16 else np.exp
                    alpha = ex(m - mn)
                    p = ex(s - mn[:, None])
                    l = l * alpha + p.sum(1)
                    pk = np.where(keep[bi, hi, rows, keys], p, 0)
                    if bf16:
                        pk = bf16_round(pk)
                    for i, c in enumerate(chunks(dh)):
                        acc[i] = acc[i] * alpha[:, None] + count.mm(
                            "fwd", pk, v[bi, hi, keys, c])
                    m = mn
                for i, c in enumerate(chunks(dh)):
                    o[bi, hi, rows, c] = acc[i] / (l * (1 - rate))[:, None]
                lse[bi, hi, rows] = (m + np.log2(l)) * LN2 if bf16 \
                    else m + np.log(l)
    return (bf16_round(o) if bf16 else o), lse


def cluster_bwd_emulated(q, k, v, o, do, lse, rate, seed, bf16=False,
                         count=None):
    """dq, dk, dv of the cluster backward: the dK/dV pass over 64-key
    blocks and 32-row query tiles, the dQ pass over 64-row blocks and
    32-key tiles, each summing its blocks' partials of S and dP in block
    order; pd and ds rounded to bf16 before their products in bf16."""
    count = count or Products()
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    scale = np.float32(1.0 / math.sqrt(dh))
    keep = keep_mask(seed, b, h, tq, tk, rate).numpy() if rate > 0 \
        else np.ones((b, h, tq, tk), bool)
    inv = np.float32(1.0 / (1.0 - rate))
    rnd = bf16_round if bf16 else (lambda x: x)
    dq, dk, dv = np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)
    tile = CLUSTER_BWD_TILE
    for bi in range(b):
        for hi in range(h):
            qq, kk_, vv, dd = q[bi, hi], k[bi, hi], v[bi, hi], do[bi, hi]
            delta = (dd * o[bi, hi]).sum(1, dtype=np.float32)
            ls = lse[bi, hi]
            kp = keep[bi, hi]
            for k0 in range(0, tk, CLUSTER_ROWS):  # dK/dV
                keys = slice(k0, k0 + CLUSTER_ROWS)
                for r0 in range(0, tq, tile):
                    rows = slice(r0, r0 + tile)
                    st = cluster_sum(lambda c: count.mm(
                        "dkv", kk_[keys, c], qq[rows, c].T), dh)
                    dpt = cluster_sum(lambda c: count.mm(
                        "dkv", vv[keys, c], dd[rows, c].T), dh)
                    p = np.exp(st * scale - ls[rows])
                    kt = kp[rows, keys].T
                    pd = rnd(np.where(kt, p * inv, 0))
                    ds = rnd(p * (np.where(kt, dpt * inv, 0) - delta[rows])
                             * scale)
                    for c in chunks(dh):
                        dv[bi, hi, keys, c] += count.mm("dkv", pd,
                                                        dd[rows, c])
                        dk[bi, hi, keys, c] += count.mm("dkv", ds,
                                                        qq[rows, c])
            for r0 in range(0, tq, CLUSTER_ROWS):  # dQ
                rows = slice(r0, r0 + CLUSTER_ROWS)
                for k0 in range(0, tk, tile):
                    keys = slice(k0, k0 + tile)
                    s = cluster_sum(lambda c: count.mm(
                        "dq", qq[rows, c], kk_[keys, c].T), dh)
                    dp = cluster_sum(lambda c: count.mm(
                        "dq", dd[rows, c], vv[keys, c].T), dh)
                    p = np.exp(s * scale - ls[rows, None])
                    ds = rnd(p * (np.where(kp[rows, keys], dp * inv, 0)
                                  - delta[rows, None]) * scale)
                    for c in chunks(dh):
                        dq[bi, hi, rows, c] += count.mm("dq", ds,
                                                        kk_[keys, c])
    if bf16:
        return tuple(bf16_round(g) for g in (dq, dk, dv))
    return dq, dk, dv


def bf16_tol(ref, ulps=2):
    """`ulps` bf16 ulps at the binade of ref's peak (chip_smoke.bf16_tol)."""
    peak = max(float(np.abs(ref).max()), 2.0 ** -126)
    return ulps * 2.0 ** (math.floor(math.log2(peak)) - 7)


# dh 384 and 512 (portable clusters of 3 and 4), 1152 (9 blocks: the
# non-portable size) and 2176 (17 chunks on 9 blocks, two each but the
# last).  Tq 70 / Tk 90: two row tiles, ragged key tiles.
SHAPES = {384: ((1, 2, 70, 384), (1, 2, 90, 384)),
          512: ((1, 2, 70, 512), (1, 2, 90, 512)),
          1152: ((1, 1, 40, 1152), (1, 1, 70, 1152)),
          2176: ((1, 1, 40, 2176), (1, 1, 70, 2176))}


def inputs(dh, bf16):
    qs, ks = SHAPES[dh]
    arrays = [rand(qs, 21), rand(ks, 22), rand(ks, 23), rand(qs, 24)]
    return [bf16_round(a) for a in arrays] if bf16 else arrays


class TestClusterSchedule:
    # Float32: sums of up to 2176 products in another order (per chunk,
    # then chunk by chunk across the cluster; tile by tile): 2e-5 on o
    # (O(1) values), 5e-5 on the gradients, 1e-4 on lse, as
    # tests/test_torch_kernels.py.  bf16 (operands exact in bf16, p, pd
    # and ds rounded at the same points on both sides): 2 bf16 ulps at
    # the peak of o and of each gradient, lse 1e-4.
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("rate", [0.0, 0.1])
    @pytest.mark.parametrize("dh", sorted(SHAPES))
    def test_forward_matches_plain(self, dh, rate, dtype):
        bf16 = dtype == "bfloat16"
        q, k, v, _ = inputs(dh, bf16)
        o, lse = cluster_fwd_emulated(q, k, v, rate, SEED, bf16)
        tdt = torch.bfloat16 if bf16 else torch.float32
        o_p, lse_p = flash_attn_fwd_torch(
            *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), rate, SEED)
        o_p = o_p.float().numpy()
        np.testing.assert_allclose(o, o_p, rtol=0,
                                   atol=bf16_tol(o_p) if bf16 else 2e-5)
        np.testing.assert_allclose(lse, lse_p.numpy(), rtol=0, atol=1e-4)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("rate", [0.0, 0.1])
    @pytest.mark.parametrize("dh", sorted(SHAPES))
    def test_backward_matches_plain(self, dh, rate, dtype):
        bf16 = dtype == "bfloat16"
        q, k, v, do = inputs(dh, bf16)
        tdt = torch.bfloat16 if bf16 else torch.float32
        tq_, tk_, tv_, tdo = (torch.from_numpy(x).to(tdt)
                              for x in (q, k, v, do))
        o, lse = flash_attn_fwd_torch(tq_, tk_, tv_, rate, SEED)
        want = flash_attn_bwd_torch(tq_, tk_, tv_, o, tdo, lse, rate, SEED)
        got = cluster_bwd_emulated(q, k, v, o.float().numpy(), do,
                                   lse.numpy(), rate, SEED, bf16)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            w = w.float().numpy()
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=bf16_tol(w) if bf16 else 5e-5,
                                       err_msg=name)


class TestClusterProducts:
    @pytest.mark.parametrize("dh", [384, 512, 1152, 2048, 2176, 4224])
    def test_each_chunk_product_once_a_tile_pair(self, dh):
        # One row tile against two key tiles (and the backward's tiles):
        # 2 nc chunk products a pair forward, 4 nc in dK/dV and 3 nc in dQ
        # backward, also where a block owns several chunks (2176: 17 on 9
        # blocks; 4224: 33 on 11); the chunked kernels it replaced took
        # nc (nc + 1) and nc (4 nc + 3).
        nc = dh // WIDE_CHUNK
        tq, tk = CLUSTER_ROWS, 2 * CLUSTER_ROWS
        q, k, v, do = (rand((1, 1, t, dh), i) for i, t in
                       enumerate((tq, tk, tk, tq)))
        count = Products()
        o, lse = cluster_fwd_emulated(q, k, v, 0.0, SEED, count=count)
        cluster_bwd_emulated(q, k, v, o, do, lse, 0.0, SEED, count=count)
        # one 64-row tile against the 32-key tiles of float32
        pairs_fwd = tk // CLUSTER_FWD_KEYS[torch.float32]
        pairs_dkv = (tk // CLUSTER_ROWS) * (tq // CLUSTER_BWD_TILE)
        pairs_dq = (tq // CLUSTER_ROWS) * (tk // CLUSTER_BWD_TILE)
        assert count.n["fwd"] == 2 * nc * pairs_fwd
        assert pairs_dkv == pairs_dq
        assert count.n["dkv"] + count.n["dq"] == 7 * nc * pairs_dq
        assert count.n["dkv"] == 4 * nc * pairs_dkv
        assert 2 * nc < nc * (nc + 1) and 7 * nc < nc * (4 * nc + 3)


class TestChunkOwnership:
    @pytest.mark.parametrize("nc", [3, 8, 9, 16, 17, 18, 31, 32, 33, 64,
                                    100])
    def test_every_chunk_has_one_block(self, nc):
        # Every chunk once, on a cluster the card takes (8 blocks
        # portable, 16 with the non-portable attribute); one chunk a
        # block up to 16 chunks, and no block two chunks more than
        # another's count above (chunk i of block r is r + i C).
        size = cluster_blocks(nc)
        mine = [owned(r, nc) for r in range(size)]
        assert sorted(c for cs in mine for c in cs) == list(range(nc))
        assert size <= CLUSTER_MAX
        assert (size > CLUSTER_PORTABLE) == (nc > CLUSTER_PORTABLE)
        counts = [len(cs) for cs in mine]
        assert max(counts) == chunks_per_block(nc)
        assert max(counts) - min(counts) <= 1
        assert (max(counts) == 1) == (nc <= CLUSTER_MAX)
        assert all(cs[0] == r for r, cs in enumerate(mine))

    @pytest.mark.parametrize("nc", [17, 18, 33, 40])
    def test_scratch_places_are_disjoint(self, nc):
        # `acc_place`: float4 q of place i of block (x, z), thread t at
        # ((block places + i) N + q) threads + t, block = x C + z; every
        # index once, inside the `acc_places_bytes` of the launch.  The
        # forwards and dQ keep the chunks after the first there (places
        # chunks - 1, N = 16), dK/dV every chunk (places chunks, N = 32).
        size, per = cluster_blocks(nc), chunks_per_block(nc)
        for places, n in ((per - 1, 16), (per, 32)):
            rows_x = 3
            idx = [((x * size + z) * places + i) * n * THREADS
                   + q * THREADS + t
                   for x in range(rows_x) for z in range(size)
                   for i in range(places) for q in range(n)
                   for t in range(THREADS)]
            nbytes = rows_x * size * places * n * THREADS * 16
            assert len(set(idx)) == len(idx)
            assert min(idx) == 0 and (max(idx) + 1) * 16 == nbytes


# chip_smoke.py's wide rows: (B, H, Tq, Tk, dh); dh 320 runs at 384.
SMOKE_WIDE = [(8, 2, 501, 501, 512), (8, 2, 501, 501, 320),
              (2, 1, 501, 501, 1152), (1, 1, 501, 501, 2048),
              (1, 1, 501, 501, 2176)]
DTYPES = [torch.float32, torch.bfloat16]


class TestClusterBudget:
    @pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
    @pytest.mark.parametrize("kernel", ["fwd", "dkv", "dq"])
    def test_shared_memory_fits_a_block(self, kernel, dtype):
        # The layouts hold a block's first chunk only, at every dh.
        assert cluster_smem(kernel, dtype) <= SMEM_LIMIT

    def test_shared_memory_as_the_layouts_state(self):
        # The numbers the .cu layouts give (static_asserts there keep
        # them under the limit; chip_smoke.py's build phase reports what
        # the built libraries export).  Both forwards fit two blocks an
        # SM (115,712 bytes each at most).
        f32 = {k: cluster_smem(k, torch.float32) for k in ("fwd", "dkv",
                                                            "dq")}
        bf = {k: cluster_smem(k, torch.bfloat16) for k in ("fwd", "dkv",
                                                           "dq")}
        assert f32 == {"fwd": 101376, "dkv": 168960, "dq": 167936}
        assert 2 * max(f32["fwd"], bf["fwd"]) <= 233472 - 2 * 1024
        assert bf == {"fwd": 115712, "dkv": 103424, "dq": 102400}

    @pytest.mark.parametrize("shape", SMOKE_WIDE,
                             ids=lambda s: f"B{s[0]}H{s[1]}dh{s[4]}")
    def test_grids_divide_by_the_cluster(self, shape):
        # Every launch: grid (row tiles * B*H, 1, C) against cluster dims
        # (1, 1, C); grid x folds B*H (grid_fold.cuh), which the cluster
        # does not span.
        b, h, tq, tk, dh = shape
        width = padded_head_dim(dh)
        cluster = (1, 1, cluster_blocks(width // WIDE_CHUNK))
        assert math.prod(cluster) <= CLUSTER_MAX
        for rows in (tq, tk, tq):   # forward, dK/dV, dQ
            grid = (-(-rows // CLUSTER_ROWS) * b * h, 1, cluster[2])
            assert all(g % c == 0 for g, c in zip(grid, cluster))

    def test_every_multiple_of_128_above_256_runs(self):
        # No head dim cap: a block owns ceil(nc / 16) chunks above 2048.
        for dh in (384, 2048, 2176, 4224, 8192):
            q = torch.zeros(1, 1, 9, dh)
            _check(q, q, q)
        q = torch.zeros(1, 1, 9, 2200)
        with pytest.raises(ValueError, match="not in"):
            _check(q, q, q)
