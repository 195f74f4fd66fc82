"""The audio projection's Hopper design (csrc/audio_proj.cu), checked on
the CPU, at a bf16 and a float32 x.

No card runs here, so each part of the design that fixes a result is
mirrored in numpy and held against the reference:

(a) the weight split: three bf16 parts whose sum is the float32 weight,
    and x W1 through the three bf16 products at float32 accuracy;
(b) the product scheme: a bf16 conv1 as 3 bf16 products, every other conv
    (a float32 A: the float32 x, or the float32 h conv2 reads) as 6,
    summed in float32, k16 step by k16 step in the kernel's order, against
    the plain version and the Pallas kernel in interpret mode (1e-4 on y
    and h before bf16 rounding); one product each misses that;
(c) the layouts: the TMA boxes of the 3-D (c_in, T, B) map (halo frames
    zero, no frame of the next utterance, no pad column read), and the
    fragment addresses the kernel computes into the 128-byte swizzle
    (`ldmatrix` for a bf16 x, 8-byte loads for a float32 A);
(d) the model's padded-row x through `audio_projection`'s forward and
    backward against the JAX VJP, and the split read afresh each call;
(e) the launch plan (one grid dimension, B 65,536 included) and the
    shared memory of each instance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from av_separation_torch.ops.kernels import audio_proj as P

f32, f64 = np.float32, np.float64
SMEM_LIMIT = 232448  # bytes a block may use on the H100
BM, BK = 128, 64     # frames a block, input channels a chunk
CONV1_PAIRS = ((0, 2), (0, 1), (0, 0))  # (A part, W part), issue order
CONV2_PAIRS = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))


def bf16(x: np.ndarray) -> np.ndarray:
    """float32 rounded to bf16 (nearest even) and back."""
    return torch.from_numpy(np.ascontiguousarray(x, f32)).bfloat16() \
        .float().numpy()


def parts3(v: np.ndarray) -> list:
    """The kernel's split (audio_proj_split_kernel, split3): three bf16
    values (as float32) summing to v."""
    p1 = bf16(v)
    r = (v - p1).astype(f32)
    p2 = bf16(r)
    return [p1, p2, bf16((r - p2).astype(f32))]


def proj_case(b, t, f, d, seed, dtype="bf16"):
    """The card's projection rows: x = |N(0, 1)| (rounded to bf16 at
    `dtype` bf16), torch Conv1d initialisation."""
    rng = np.random.default_rng(seed)
    lim1, lim2 = (3 * f) ** -0.5, (3 * d) ** -0.5
    x = np.abs(rng.normal(size=(b, t, f))).astype(f32)
    x = bf16(x) if dtype == "bf16" else x
    w1 = rng.uniform(-lim1, lim1, (3, f, d)).astype(f32)
    b1 = rng.uniform(-lim1, lim1, d).astype(f32)
    w2 = rng.uniform(-lim2, lim2, (3, d, d)).astype(f32)
    b2 = rng.uniform(-lim2, lim2, d).astype(f32)
    return x, w1, b1, w2, b2


def tma_box(src: np.ndarray, c0: int, t0: int, b: int, cols: int,
            rows: int) -> np.ndarray:
    """One box of the kernel's 3-D map over src (B, T, C): columns
    [c0, c0 + cols) of frames [t0, t0 + rows) of utterance b, zero where
    a coordinate falls outside its dimension (negative ones too)."""
    out = np.zeros((rows, cols), src.dtype)
    t = np.arange(t0, t0 + rows)
    c = np.arange(c0, c0 + cols)
    tv, cv = (t >= 0) & (t < src.shape[1]), c < src.shape[2]
    out[np.ix_(tv, cv)] = src[b][np.ix_(t[tv], c[cv])]
    return out


def conv_wgmma(src, w, bias, a_parts, pairs, rows=BM):
    """relu(conv3(src, w) + bias) as one conv launch computes it: per block
    of `rows` frames (the kernel's 128), per 64-channel chunk (the A box of
    rows + 2 frames from t0 - 1, zero outside [0, T) and past c_in), per
    tap (staged rows shifted by the tap), per k16 step, the bf16 products
    of `pairs` (A part, W part) each summed exactly and added to the
    float32 accumulator, in the kernel's order."""
    b, t, cin = src.shape
    d = w.shape[-1]
    chunks = -(-cin // BK)
    wp = np.zeros((3, 3, chunks * BK, d), f32)  # part, tap, c_in, D
    wp[:, :, :cin] = np.stack(parts3(w))
    out = np.zeros((b, t, d), f32)
    for t0 in range(0, t, rows):
        acc = np.zeros((b, rows, d), f32)
        for c in range(chunks):
            box = np.stack([tma_box(src, c * BK, t0 - 1, i, BK, rows + 2)
                            for i in range(b)])
            a = a_parts(box)
            for tap in range(3):
                for kk in range(4):
                    ks = slice(16 * kk, 16 * kk + 16)
                    wk = slice(c * BK + 16 * kk, c * BK + 16 * kk + 16)
                    for i, j in pairs:
                        acc = (acc + a[i][:, tap:tap + rows, ks].astype(f64)
                               @ wp[j, tap, wk].astype(f64)).astype(f32)
        out[:, t0:t0 + rows] = acc[:, :t - t0]
    return np.maximum(out + bias, 0).astype(f32)


def proj_wgmma_emulated(x, w1, b1, w2, b2, one_product=False,
                        dtype="bf16", rows=BM):
    """(y, h) in float32, before the bf16 rounding of the stores: conv1
    from x (exact in bf16 at `dtype` bf16; else split in three, as conv2
    splits the float32 h), in blocks of `rows` frames."""
    pairs1 = CONV1_PAIRS if dtype == "bf16" else CONV2_PAIRS
    pairs1, pairs2 = ((pairs1[-1:], CONV2_PAIRS[-1:]) if one_product
                      else (pairs1, CONV2_PAIRS))
    h = conv_wgmma(x, w1, b1, (lambda a: [a]) if dtype == "bf16" else parts3,
                   pairs1, rows)
    return conv_wgmma(h, w2, b2, parts3, pairs2, rows), h


# ---------------------------------------------------------------------------
# (a) the weight split
# ---------------------------------------------------------------------------

class TestWeightSplit:
    @pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3, "init"])
    def test_parts_sum_to_the_weight_exactly(self, scale):
        rng = np.random.default_rng(1)
        w = proj_case(1, 2, 257, 64, 2)[1] if scale == "init" else (
            rng.normal(size=(3, 257, 64)) * scale).astype(f32)
        p = parts3(w)
        assert all(np.array_equal(q, bf16(q)) for q in p)  # bf16 values
        np.testing.assert_array_equal(
            p[0].astype(f64) + p[1].astype(f64) + p[2].astype(f64),
            w.astype(f64))
        got = P.weight_parts_torch(torch.from_numpy(w))
        assert got.dtype == torch.bfloat16 and got.shape == (3, *w.shape)
        np.testing.assert_array_equal(got.float().numpy(), np.stack(p))

    def test_three_products_give_x_w1_to_float32(self):
        x, w1 = proj_case(2, 20, 257, 64, 3)[:2]
        a = x.reshape(-1, 257)
        exact = a.astype(f64) @ w1[1].astype(f64)
        # Each bf16 x bf16 product is exact; summed in float64 the three
        # parts give x W1 to float64 rounding.
        sums = sum(a.astype(f64) @ p[1].astype(f64) for p in parts3(w1))
        np.testing.assert_allclose(sums, exact, rtol=0,
                                   atol=1e-12 * np.abs(exact).max())
        # Summed in float32, k16 step by k16 step, as the tensor cores do:
        # float32 accuracy (a few ulps of the sum of |terms|).
        acc = np.zeros(exact.shape, f32)
        ps = parts3(w1[1])
        for k0 in range(0, 257, 16):
            for j in (2, 1, 0):
                acc = (acc + a[:, k0:k0 + 16].astype(f64)
                       @ ps[j][k0:k0 + 16].astype(f64)).astype(f32)
        mag = np.abs(a).astype(f64) @ np.abs(w1[1]).astype(f64)
        assert np.all(np.abs(acc - exact) <= 64 * 2.0 ** -24 * mag)
        # One product (W1 rounded to bf16) is not float32 accuracy.
        one = a.astype(f64) @ ps[0].astype(f64)
        assert np.abs(one - exact).max() > 1e3 * 2.0 ** -24 * mag.max()


# ---------------------------------------------------------------------------
# (b) the product scheme
# ---------------------------------------------------------------------------

class TestProductScheme:
    # T 37 (one partial block), T 150 (a block boundary at 128 with the
    # halo across it), D 72 (a ragged 64-channel slab): the emulation
    # against the plain version and the Pallas kernel in interpret mode,
    # 1e-4 on y and h before the bf16 rounding of the stores; at a bf16
    # and a float32 x.
    @pytest.mark.parametrize("dtype", ["bf16", "f32"])
    @pytest.mark.parametrize("b,t,d", [(2, 37, 64), (2, 150, 72)])
    def test_matches_plain_and_pallas(self, b, t, d, dtype):
        from av_separation_tpu.ops.pallas.audio_proj import _fwd_impl
        args = proj_case(b, t, 257, d, 4, dtype)
        y, h = proj_wgmma_emulated(*args, dtype=dtype)
        y_p, h_p = P.audio_proj_fwd_torch(*(torch.from_numpy(a)
                                            for a in args))
        np.testing.assert_allclose(y, y_p.numpy(), atol=1e-4, rtol=0)
        np.testing.assert_allclose(h, h_p.numpy(), atol=1e-4, rtol=0)
        with pltpu.force_tpu_interpret_mode():
            y_j, h_j = _fwd_impl(*(jnp.asarray(a) for a in args))
        np.testing.assert_allclose(y, np.asarray(y_j), atol=1e-4, rtol=0)
        np.testing.assert_allclose(h, np.asarray(h_j), atol=1e-4, rtol=0)

    # The scaled serving shape (T 501, F 257, D 512) with B cut to 1: the
    # 3 + 6 (float32 x: 6 + 6) products keep y and h within 1e-4 of the
    # plain version; one bf16 product a conv (the weights, h and a float32
    # x rounded to bf16) does not.
    @pytest.mark.parametrize("dtype", ["bf16", "f32"])
    def test_holds_1e4_at_scaled_width_and_one_product_does_not(self, dtype):
        args = proj_case(1, 501, 257, 512, 5, dtype)
        y_p, h_p = (a.numpy() for a in P.audio_proj_fwd_torch(
            *(torch.from_numpy(a) for a in args)))
        y, h = proj_wgmma_emulated(*args, dtype=dtype)
        assert np.abs(y - y_p).max() <= 1e-4
        assert np.abs(h - h_p).max() <= 1e-4
        y1, h1 = proj_wgmma_emulated(*args, one_product=True, dtype=dtype)
        assert max(np.abs(y1 - y_p).max(), np.abs(h1 - h_p).max()) > 1e-4

    def test_hidden_halo_is_zero_not_relu_bias(self):
        # x = 0, b1 = 1: h = 1 inside [0, T); conv2 at the first and last
        # frames sees the map's zeros beyond them: 2 taps of ones, not 3.
        t, d = 70, 64
        x = np.zeros((1, t, 257), f32)
        w2 = np.full((3, d, d), 1.0 / d, f32)
        y, h = proj_wgmma_emulated(x, np.zeros((3, 257, d), f32),
                                   np.ones(d, f32), w2, np.zeros(d, f32))
        assert np.all(h == 1.0)
        np.testing.assert_allclose(y[0, [0, t - 1]], 2.0, rtol=1e-6)
        np.testing.assert_allclose(y[0, 1:t - 1], 3.0, rtol=1e-6)


# ---------------------------------------------------------------------------
# (c) the layouts
# ---------------------------------------------------------------------------

def proj_block(i: int, plan: dict) -> tuple:
    """(utterance, frame tile, channel slab) of block i, as the kernel
    decodes blockIdx.x (slab fastest)."""
    rest, slab = divmod(i, plan["slabs"])
    b, tile = divmod(rest, plan["tiles"])
    return b, tile, slab


def swz(r: int, u: int) -> int:
    """audio_proj.cu `swz`: byte offset of 16-byte unit u of row r in
    a 128-byte-swizzled box."""
    return r * 128 + ((u ^ (r & 7)) << 4)


def tma_swizzled(box: np.ndarray) -> np.ndarray:
    """The bytes TMA writes for a box of 128-byte rows in the 128-byte
    swizzle: unit u of row r lands at unit u ^ (r % 8)."""
    raw = np.ascontiguousarray(box).view(np.uint8).reshape(box.shape[0], 8,
                                                           16)
    out = np.zeros_like(raw)
    for r in range(raw.shape[0]):
        out[r, np.arange(8) ^ (r % 8)] = raw[r]
    return out.reshape(-1)


class TestLayouts:
    # A chunk of 64 channels is one box of 64 bf16 columns, or two of 32
    # float32 columns (128 bytes a row either way).
    @pytest.mark.parametrize("dtype", ["bf16", "f32"])
    def test_boxes_zero_the_halo_and_never_read_the_next_utterance(self,
                                                                   dtype):
        # Utterance b holds the value b + 1 in every valid element; its
        # rows are padded to 264 (260) with NaN, which must never be read.
        b, t, f = 3, 150, 257
        width = 64 if dtype == "bf16" else 32
        buf = np.full((b, t, 264 if dtype == "bf16" else 260), np.nan, f32)
        buf[..., :f] = (np.arange(b) + 1)[:, None, None]
        x = buf[..., :f]
        plan = P.proj_plan(b, t, 64, 132)
        for i in range(plan["blocks"]):
            ub, tile, _ = proj_block(i, plan)
            t0 = tile * BM
            for c in range(-(-f // BK)):
                box = np.concatenate(
                    [tma_box(x, c * BK + c0, t0 - 1, ub, width, BM + 2)
                     for c0 in range(0, BK, width)], axis=1)
                assert np.isfinite(box).all()
                frames = np.arange(t0 - 1, t0 + BM + 1)
                inside = (frames >= 0) & (frames < t)
                cols = c * BK + np.arange(BK) < f
                assert np.all(box[np.ix_(inside, cols)] == ub + 1)
                assert np.all(box[~inside] == 0) and np.all(box[:, ~cols] == 0)
        # A 2-D (B T, F) view at the same place would read utterance 1's
        # first frame into utterance 0's halo at t = T.
        flat = x.reshape(1, b * t, f)
        assert tma_box(flat, 0, BM - 1, 0, BK, BM + 2)[t - BM + 1, 0] == 2

    def test_ldmatrix_addresses_give_the_a_fragment(self):
        # A bf16 box of 130 rows x 64 columns, swizzled as TMA lands it;
        # each lane's ldmatrix.x4 row addresses (rows r0 + l % 8 +
        # 8 ((l / 8) % 2), unit 2 kk + l / 16) hand thread 4g + t, in
        # register 2j + h, the elements (g + 8h, 16 kk + 8j + 2t + e).
        box = np.arange(130 * 64, dtype=np.uint16).reshape(130, 64)
        mem = tma_swizzled(box)
        for r0 in (0, 1, 2, 17, 66):
            for kk in range(4):
                addr = [swz(r0 + (l & 7) + 8 * ((l >> 3) & 1),
                            2 * kk + (l >> 4)) for l in range(32)]
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    for i in range(4):
                        at = addr[8 * i + g] + 4 * t
                        got = mem[at:at + 4].view(np.uint16)
                        j, h = i >> 1, i & 1
                        col = 16 * kk + 8 * j + 2 * t
                        np.testing.assert_array_equal(
                            got, box[r0 + g + 8 * h, col:col + 2])

    def test_float32_loads_give_the_a_fragment(self):
        # The float32 h in two boxes of 32 columns a chunk: the 8-byte load
        # at box kk / 2, unit 4 (kk % 2) + 2j + t / 2, byte 8 (t % 2) of
        # row r0 + g + 8h holds (g + 8h, 16 kk + 8j + 2t + e).
        box = np.arange(130 * 64, dtype=np.float32).reshape(130, 64)
        mems = [tma_swizzled(box[:, 32 * i:32 * i + 32]) for i in range(2)]
        for r0 in (0, 2, 65):
            for kk in range(4):
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    for j in range(2):
                        for h in range(2):
                            r = r0 + g + 8 * h
                            at = swz(r, 4 * (kk & 1) + 2 * j + (t >> 1)) \
                                + 8 * (t & 1)
                            got = mems[kk >> 1][at:at + 8].view(np.float32)
                            col = 16 * kk + 8 * j + 2 * t
                            np.testing.assert_array_equal(
                                got, box[r, col:col + 2])


# ---------------------------------------------------------------------------
# (d) the padded-row input through the autograd function; no split cache
# ---------------------------------------------------------------------------

class TestPaddedInput:
    def test_proj_input_layout(self):
        # Rows padded to 16 bytes: 264 bf16, 260 float32 channels.
        x = torch.randn(2, 257, 9)
        for dtype, row in ((torch.float32, 260), (torch.bfloat16, 264)):
            xi = P.proj_input(x.to(dtype))
            assert xi.shape == (2, 9, 257) and xi.dtype == dtype
            torch.testing.assert_close(xi, x.to(dtype).transpose(1, 2),
                                       rtol=0, atol=0)
            assert xi.stride() == (9 * row, row, 1) and P.tma_rows_ok(xi)

    # Rows of 257 channels (514 or 1,028 bytes) are no TMA stride: the
    # check refuses them (the wrapper copies such an x into padded rows
    # before it checks).
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_check_refuses_rows_off_16_bytes(self, dtype):
        d = 64
        ws = (torch.zeros(3, 257, d), torch.zeros(d),
              torch.zeros(3, d, d), torch.zeros(d))
        x = torch.zeros(2, 9, 257, dtype=dtype)
        assert not P.tma_rows_ok(x)
        with pytest.raises(ValueError, match="16 bytes"):
            P._check(x, *ws)
        P._check(P.proj_input(x.transpose(1, 2)), *ws)

    # The padded view through the forward and backward against the JAX
    # VJP of the Pallas kernel:
    # float32 at 2e-5 + 1e-4 relative; bf16 one ulp on y, the cotangents
    # as tests/test_torch_bf16.py's (rtol 1e-2 of their scale).
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_forward_and_vjp_match_jax(self, dtype):
        from av_separation_tpu.ops.pallas.audio_proj import (
            fused_audio_projection)
        x, w1, b1, w2, b2 = proj_case(2, 37, 257, 64, 6)
        ws = (w1, b1, w2, b2)
        x_bft = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))
        xt = P.proj_input(x_bft.to(dtype)).requires_grad_()
        wt = [torch.from_numpy(w).requires_grad_() for w in ws]
        y = P.audio_projection(xt, *wt)
        g = np.random.default_rng(7).normal(size=y.shape).astype(f32)
        gt = torch.from_numpy(g).to(dtype)
        y.backward(gt)
        jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
        with pltpu.force_tpu_interpret_mode():
            y_j, vjp = jax.vjp(fused_audio_projection,
                               jnp.asarray(x).astype(jdt),
                               *(jnp.asarray(w) for w in ws))
            want = vjp(jnp.asarray(g).astype(jdt))
        bf = dtype == torch.bfloat16
        np.testing.assert_allclose(y.detach().float().numpy(),
                                   np.asarray(y_j, f32), atol=1e-5,
                                   rtol=2.0 ** -7 if bf else 1e-4)
        for name, t_, w in zip(("x", "w1", "b1", "w2", "b2"), [xt, *wt],
                               want):
            scale = float(np.abs(np.asarray(w, f32)).max())
            np.testing.assert_allclose(
                t_.grad.float().numpy(), np.asarray(w, f32),
                atol=(1e-2 if bf else 2e-5) * scale,
                rtol=1e-2 if bf else 1e-4, err_msg=name)

    def test_split_reads_the_weight_at_each_call(self):
        # No cache: the split of a weight updated in place (an optimiser
        # step) is the split of its new values.
        w1 = torch.from_numpy(proj_case(1, 2, 257, 64, 8)[1])
        w2 = torch.randn(3, 64, 64) * 0.1
        before = P.audio_proj_split(w1, w2)
        w1.mul_(3.0)
        after = P.audio_proj_split(w1, w2)
        torch.testing.assert_close(after[0].float().sum(0), w1, rtol=0,
                                   atol=0)
        assert not torch.equal(before[0], after[0])
        assert torch.equal(before[1], after[1])


# ---------------------------------------------------------------------------
# (e) the launch plan and the shared memory
# ---------------------------------------------------------------------------

def smem_bytes(a32: bool, bn: int) -> tuple:
    """audio_proj.cu `Layout`: (bytes, weight stages)."""
    box = -(-(BM + 2) * 128 // 1024) * 1024
    a_stage = (2 if a32 else 1) * box
    w_stage = 3 * (bn // 64) * 64 * 128
    stages = min(4, (SMEM_LIMIT - 1024 - 128 - 2 * a_stage) // w_stage)
    return 1024 + 2 * a_stage + stages * w_stage + 16 * (2 + stages), stages


class TestLaunchPlan:
    # A32: a float32 A (conv2, or a float32 conv1), else a bf16 x.
    @pytest.mark.parametrize("a32", [False, True])
    @pytest.mark.parametrize("bn", [64, 128])
    def test_shared_memory_fits(self, a32, bn):
        nbytes, stages = smem_bytes(a32, bn)
        assert nbytes <= SMEM_LIMIT and stages >= 2

    # (B, T, D) -> (channels a block, blocks) on 132 SMs.
    @pytest.mark.parametrize("shape,bn,blocks", [
        ((8, 501, 512), 128, 128),      # scaled
        ((128, 63, 128), 128, 128),     # bench (demo, batch 128)
        ((8, 63, 512), 64, 64),         # three_speaker
        ((16, 501, 1024), 128, 512),    # multihost
        ((2, 501, 200), 64, 32),        # odd width (D 196 -> 200)
        ((65536, 8, 64), 64, 65536)])   # more utterances than grid y holds
    def test_every_block_once(self, shape, bn, blocks):
        plan = P.proj_plan(*shape, 132)
        assert (plan["bn"], plan["blocks"]) == (bn, blocks)
        b, t, d = shape
        assert plan["tiles"] == -(-t // BM) and plan["slabs"] == -(-d // bn)
        seen = np.zeros((b, plan["tiles"], plan["slabs"]), np.int64)
        for i in range(blocks):
            seen[proj_block(i, plan)] += 1
        assert np.all(seen == 1)

    # One grid dimension of 65,536 blocks at B 65,536, x in the model's
    # padded rows, at either dtype; 2^31 utterances are refused.
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_b65536_passes_the_checks(self, dtype):
        b, t, d = 65536, 8, 64
        row = 264 if dtype == torch.bfloat16 else 260

        def x_of(n):
            return torch.empty(1, t, row, dtype=dtype)[..., :257] \
                .expand(n, t, 257)

        ws = (torch.zeros(3, 257, d), torch.zeros(d),
              torch.zeros(3, d, d), torch.zeros(d))
        P._check(x_of(b), *ws)
        assert P.proj_plan(b, t, d, 132)["blocks"] == b
        with pytest.raises(ValueError, match="grid x"):
            P._check(x_of(2 ** 31), *ws)
