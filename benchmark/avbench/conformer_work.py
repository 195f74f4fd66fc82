"""The yardstick's arithmetic for the conformer configurations
(`encoder_block` "conformer"): the model's analytic FLOPs (MFU
convention), and the work of each call of the GLU + depthwise-convolution
kernels, with the readers of their roofline shares and of the MFU.

`model_forward_flops` is a frozen copy of the port's
`utils/roofline.py:model_forward_flops` for a conformer configuration:
matrix-product and convolution FLOPs, two a multiply-add, one sample; the
STFT, GLU, BatchNorm and the elementwise work are not counted.  A training
step is priced at three forwards.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

from avbench import roofline


def _frames(cfg: dict):
    data = cfg["data"]
    t = 1 + int(data["sample_rate"] * data["duration"]) // data["hop_length"]
    return t, len(data["speaker_freqs"]) * data["num_frames"]


def conformer_block_flops(seq: int, d: int, k: int) -> float:
    """One conformer block over `seq` rows: two 4d FFNs (16 seq d^2
    multiply-adds), q / k / v / out (4 seq d^2), QK^T and PV (2 seq^2 d),
    the pointwise convolutions (3 seq d^2), the depthwise one (seq d k)."""
    return 2.0 * (23 * seq * d * d + 2 * seq * seq * d + seq * d * k)


def model_forward_flops(cfg: dict) -> float:
    """Forward-pass FLOPs of one sample (batch 1)."""
    m, data = cfg["model"], cfg["data"]
    t, n = _frames(cfg)
    f, d, s, k = m["freq_bins"], m["d_model"], m["num_speakers"], \
        m["conv_kernel"]

    def cross_block(seq_q, seq_kv):
        proj = 2 * seq_q * d * d
        kv = 2 * seq_kv * d * d
        scores = 2 * seq_q * seq_kv * d
        ffn = 2 * seq_q * d * 4 * d
        return 2 * (proj + kv + scores + ffn)

    total = 2 * 3 * t * (f * d + d * d)
    total += m["num_encoder_layers"] * conformer_block_flops(t, d, k)
    h, w = data["frame_h"], data["frame_w"]
    stem = (h // 2) * (w // 2) * 9 * 1 * 32 \
        + (h // 4) * (w // 4) * 9 * 32 * 64 \
        + (h // 8) * (w // 8) * 9 * 64 * 128
    total += 2 * n * stem
    total += 2 * n * 128 * d
    total += m["num_encoder_layers"] * conformer_block_flops(n, d, k)
    total += m["num_fusion_layers"] * cross_block(t, t)
    total += 2 * t * (d * 2 * d + 2 * d * f * s)
    return float(total)


class DwConvCall(NamedTuple):
    b: int
    t: int
    d: int
    k: int


def dwconv_calls(cfg: dict, batch: int) -> List[DwConvCall]:
    """The GLU + depthwise calls of one forward: each audio encoder layer
    at T, each visual one at the lip frames N."""
    m = cfg["model"]
    t, n = _frames(cfg)
    layers = m["num_encoder_layers"]
    d, k = m["d_model"], m["conv_kernel"]
    return ([DwConvCall(batch, t, d, k)] * layers
            + [DwConvCall(batch, n, d, k)] * layers)


def dwconv_fwd_work(c: DwConvCall, elem: int = 2) -> tuple:
    """(FLOPs, bytes) the forward needs: the convolution's multiply-adds;
    u (B, T, 2d) read and y (B, T, d) written once in the compute dtype
    (the taps and the bias are noise)."""
    return 2.0 * c.b * c.t * c.d * c.k, float(elem * c.b * c.t * 3 * c.d)


def dwconv_bwd_work(c: DwConvCall, elem: int = 2) -> tuple:
    """(FLOPs, bytes) the backward needs: the input's and the filters'
    gradients (2 x 2 B T d K); u and dy read, du written once."""
    return 4.0 * c.b * c.t * c.d * c.k, float(elem * c.b * c.t * 5 * c.d)


# The kernels of each pass, by name (csrc/glu_dwconv.cu), and the one a
# call launches once.
PASSES = {"fwd": ("glu_dwconv_fwd", "glu_dwconv_fwd_kernel"),
          "bwd": ("glu_dwconv_bwd", "glu_dwconv_bwd_kernel")}


def dwconv_roofline(ctx, which: str) -> Optional[float]:
    """The GLU + depthwise calls' share of their roofline in the traced
    steps: the least time their work needs over the device time of their
    kernels.  Read only when the calls counted (one `glu_dwconv_<pass>_kernel`
    a call) are as many as the layers make, each forward once more under
    remat; otherwise None."""
    prefix, counted = PASSES[which]
    steps = ctx.traced["steps"]
    kernels = [o for o in ctx.timeline.ops_of("step", ("kernel",))
               if prefix in o.name]
    if not kernels or ctx.config["model"].get("encoder_block") != "conformer":
        return None
    calls = dwconv_calls(ctx.config, int(ctx.traffic["batch_size"]))
    repeat = 2 if which == "fwd" and ctx.config["model"].get("remat") else 1
    launched = sum(counted in o.name for o in kernels)
    if launched != len(calls) * repeat * steps:
        return None
    work = dwconv_fwd_work if which == "fwd" else dwconv_bwd_work
    least = sum(roofline.least_seconds(*work(c), ctx.device_kind)
                for c in calls) * repeat * steps
    return 100.0 * least / sum(o.seconds for o in kernels)


def mfu(ctx) -> Optional[float]:
    """Three conformer-model forwards a sample over the window's wall
    time, as a share of the bf16 peak (as `readers.mfu` prices the
    others)."""
    if ctx.config["model"].get("encoder_block") != "conformer":
        return None
    samples = ctx.window["steps"] * int(ctx.traffic["batch_size"])
    wall = ctx.window["wall_s"]
    if not samples or not wall:
        return None
    flops = 3.0 * model_forward_flops(ctx.config) * samples
    return 100.0 * flops / wall / roofline.peaks(ctx.device_kind)["bf16_flops"]
