"""The flash kernels' folded grids (csrc/grid_fold.cuh), checked on the CPU.

Every flash launch puts B*H in grid x beside the row tile (block
`tile + tiles * pair`), not in grid y, whose 65,535 the Pallas grids
(bh, nq, nk) never had.  Mirrored here: the launch plan (the grids the
.cu launches build) decodes every
(tile, pair) exactly once, at B*H 65,536 and at the largest B*H whose
folded grid still fits 2^31 - 1 blocks; the keep bits of a block at a
folded index are the JAX hash's for its pair; and the wrapper's check
takes B*H 65,536 and refuses a grid past 2^31 - 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from av_separation_torch.ops.kernels import GRID_X_MAX
from av_separation_torch.ops.kernels.attention import (HEAD_DIMS, WIDE_CHUNK,
                                                       _check, hash_tiles,
                                                       keep_threshold,
                                                       wgmma_route)

SEED = -1234567
M32 = 0xFFFFFFFF
SMS = 132  # SMs of an H100 SXM


def cdiv(a, b):
    return -(-a // b)


def launch_plan(backward, dtype, b, h, tq, tk, dh, sms=SMS):
    """The launches of one forward (or backward) call at a built head dim,
    as the .cu files build their grids (`folded_grid`): (kernel, tiles,
    pairs, groups), grid x holding `tiles * pairs` blocks (pairs = B*H;
    block x owns tile x % tiles of pair x // tiles), grid z the `groups`
    of output columns (above dh 256 the cluster's blocks, one 128-column
    chunk each; the bf16 dK/dV kernel's two column groups at dh 256).  A
    block tiles 64 rows (keys for dK/dV), 128 where a `wgmma` kernel runs
    two consumer warpgroups, 4 query rows in the delta kernel; the
    `wgmma` kernels take one warpgroup where 64-row blocks give each
    block an SM of its own, and at dh 256.  Float32 at dh 256 runs on the
    8-warp `_pair` kernels: one block of 64 rows, no column groups."""
    bh = b * h
    wide = dh > HEAD_DIMS[-1]
    groups = dh // WIDE_CHUNK if wide or dh == 256 else 1

    def wg_rows(t):
        return 64 if dh == 256 or cdiv(t, 64) * bh <= sms else 128

    if wgmma_route(dtype, dh):
        if not backward:
            return [("flash_fwd_kernel_wgmma", cdiv(tq, wg_rows(tq)), bh, 1)]
        return [("flash_bwd_delta_kernel", cdiv(tq, 4), bh, 1),
                ("flash_bwd_dkv_kernel_wgmma", cdiv(tk, 64), bh, groups),
                ("flash_bwd_dq_kernel_wgmma", cdiv(tq, wg_rows(tq)), bh, 1)]
    # Above dh 256 a cluster of `groups` blocks along z shares a tile; at
    # 256 one 8-warp block, its warps two 128-column halves.
    suffix = "_cluster" if wide else ""
    if dh == 256:
        suffix, groups = "_pair", 1
    if not backward:
        wg = "_wgmma" if wide and dtype == torch.bfloat16 else ""
        return [("flash_fwd_kernel" + wg + suffix, cdiv(tq, 64), bh, groups)]
    return [("flash_bwd_delta_kernel" + ("_wide" if wide else ""),
             cdiv(tq, 4), bh, 1),
            ("flash_bwd_dkv_kernel" + suffix, cdiv(tk, 64), bh, groups),
            ("flash_bwd_dq_kernel" + suffix, cdiv(tq, 64), bh, groups)]


def unfold(x, tiles):
    """grid_fold.cuh `unfold`: block x -> (tile, pair)."""
    return x % tiles, x // tiles


def views(b, h, t, dh, dtype):
    """(B, H, T, dh) q, k, v views of one small buffer (stride 0 over B
    and H), enough for the wrapper's checks."""
    q = torch.zeros(1, 1, t, dh, dtype=dtype).expand(b, h, t, dh)
    return q, q, q


# (backward, dtype, dh): the forward and backward of each route.
ROUTES = [(bw, dt, dh) for bw in (False, True)
          for dt, dh in ((torch.float32, 32), (torch.float32, 256),
                         (torch.float32, 512), (torch.bfloat16, 32),
                         (torch.bfloat16, 128), (torch.bfloat16, 256),
                         (torch.bfloat16, 512))]


def route_id(r):
    return f"{'bwd' if r[0] else 'fwd'}-{str(r[1])[6:]}-dh{r[2]}"


class TestPlan:
    @pytest.mark.parametrize("route", ROUTES, ids=route_id)
    def test_every_tile_of_every_pair_once_at_65536(self, route):
        backward, dtype, dh = route
        b, h, t = 16384, 4, 16
        for name, tiles, pairs, groups in launch_plan(backward, dtype, b, h,
                                                      t, t, dh):
            assert pairs == b * h == 65536 and groups <= 8, name
            tile, pair = unfold(np.arange(tiles * pairs), tiles)
            seen = np.zeros((tiles, pairs), np.int64)
            np.add.at(seen, (tile, pair), 1)
            assert np.all(seen == 1), name
            # The tiles of one pair are neighbours in launch order.
            assert np.all(np.diff(pair[::tiles]) == 1)

    @pytest.mark.parametrize("route", ROUTES, ids=route_id)
    def test_largest_folded_grid(self, route):
        # The largest B*H (H 1, T 16) whose every launch fits grid x: its
        # decode covers the corners and a sample exactly, and one pair
        # more overflows; the wrapper takes the one and refuses the other.
        backward, dtype, dh = route
        t = 16
        plan = launch_plan(backward, dtype, 1, 1, t, t, dh)
        most = max(tiles for _, tiles, _, _ in plan)
        bh = GRID_X_MAX // most
        for name, tiles, pairs, _ in launch_plan(backward, dtype, bh, 1, t,
                                                 t, dh):
            n = tiles * pairs
            assert n <= GRID_X_MAX, name
            x = np.concatenate([np.arange(2 * tiles),
                                n - 1 - np.arange(2 * tiles),
                                np.random.default_rng(0).integers(
                                    0, n, 100_000)]).astype(np.int64)
            tile, pair = unfold(x, tiles)
            assert tile.min() >= 0 and tile.max() == tiles - 1
            assert pair.min() == 0 and pair.max() == pairs - 1
            np.testing.assert_array_equal(tile + tiles * pair, x)
        assert max(tl * p for _, tl, p, _ in launch_plan(
            backward, dtype, bh + 1, 1, t, t, dh)) > GRID_X_MAX
        _check(*views(bh, 1, t, dh, dtype), backward=backward)
        with pytest.raises(ValueError, match="grid x"):
            _check(*views(bh + 1, 1, t, dh, dtype), backward=backward)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_check_bounds_a_backward_by_its_keys(self, dtype):
        # Cross attention with 64 times the queries' keys (T 16 x 1,024):
        # the dK/dV kernel's 16 tiles a pair, not the delta kernel's 4,
        # set the backward's largest grid.
        tq, tk, dh = 16, 1024, 32
        plan = launch_plan(True, dtype, 1, 1, tq, tk, dh)
        most = max(tiles for _, tiles, _, _ in plan)
        assert most == 16
        bh = GRID_X_MAX // most
        q = torch.zeros(1, 1, tq, dh, dtype=dtype)
        kv = torch.zeros(1, 1, tk, dh, dtype=dtype)

        def qkv(n):
            return (q.expand(n, 1, tq, dh), kv.expand(n, 1, tk, dh),
                    kv.expand(n, 1, tk, dh))

        _check(*qkv(bh), backward=True)
        _check(*qkv(bh + 1))  # the forward's 1 tile a pair fits
        with pytest.raises(ValueError, match="grid x"):
            _check(*qkv(bh + 1), backward=True)

    def test_check_takes_bh_65536(self):
        # The 65,535 refusal is gone: B 16,384 x H 4 at T 16, both dtypes,
        # forward and backward.
        for dtype in (torch.float32, torch.bfloat16):
            for dh in (32, 128):
                for backward in (False, True):
                    _check(*views(16384, 4, 16, dh, dtype),
                           backward=backward)


def murmur_keep(seed, bh, rows, cols, tq, tk, rate):
    """dropout_hash.cuh for pair bh, keyed as the kernels key it."""
    hq, hk = hash_tiles(tq, tk)
    r = rows.astype(np.uint64)[:, None]
    c = cols.astype(np.uint64)[None, :]
    tile = ((((seed & M32) * 0x9E3779B9) & M32)
            ^ ((bh * 0x85EBCA6B) & M32)
            ^ (((r // hq) * 0xC2B2AE35) & M32)
            ^ (((c // hk) * 0x27D4EB2F) & M32))
    x = ((r % hq) * 0x01000193 + (c % hk) * 0x61C88647 + tile) & M32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & M32
    x ^= x >> 16
    return x >= keep_threshold(rate)


class TestKeepMaskAtFoldedIndex:
    # Blocks of the forward at B*H 65,536 and T 200 (four 64-row tiles a
    # pair): the pair and tile each block decodes key the hash, and its
    # rows' bits are the JAX `_keep_mask`'s for that pair (the murmur path
    # the Pallas kernels take under the interpreter).
    @pytest.mark.parametrize("x", [0, 5, 4097, 262142, 262143])
    def test_bits_are_the_jax_hash(self, x):
        from av_separation_tpu.ops.pallas.attention import _keep_mask
        t, rate = 200, 0.1
        ((_, tiles, pairs, _),) = launch_plan(False, torch.float32, 16384,
                                              4, t, t, 32)
        assert (tiles, pairs) == (4, 65536)
        tile, bh = unfold(x, tiles)
        rows = np.arange(64 * tile, min(64 * tile + 64, t))
        hq, hk = hash_tiles(t, t)
        seed = jnp.asarray([SEED], jnp.int32)
        want = np.asarray(_keep_mask(seed, jnp.int32(bh), jnp.int32(0),
                                     jnp.int32(0), (hq, hk), rate))
        got = murmur_keep(SEED, bh, rows, np.arange(t), t, t, rate)
        np.testing.assert_array_equal(got, want[rows][:, :t])
        assert bh == x // 4 and tile == x % 4
