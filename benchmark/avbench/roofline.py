"""The yardstick's arithmetic: the chip's peaks, the model's analytic FLOPs
(MFU convention) and the work of each flash-attention call.

`model_forward_flops` is a frozen copy of the port's
`utils/roofline.py:model_forward_flops` (matrix-product and convolution
FLOPs, two a multiply-add, one sample); the STFT and the elementwise work
are not counted.  A training step is priced at three forwards, whatever
remat recomputes.
"""

from __future__ import annotations

from typing import List, NamedTuple

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core FLOP/s, HBM3 bytes/s.
PEAKS = {"NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12}}
DEFAULT_PEAK = PEAKS["NVIDIA H100 80GB HBM3"]


def peaks(device_kind: str) -> dict:
    """The peaks of a card by its name; the H100 SXM's for a name not in
    the table (the benchmark runs on that card)."""
    return PEAKS.get(device_kind, DEFAULT_PEAK)


def model_forward_flops(cfg: dict) -> float:
    """Forward-pass FLOPs of one sample (batch 1)."""
    m, data = cfg["model"], cfg["data"]
    t = 1 + int(data["sample_rate"] * data["duration"]) // data["hop_length"]
    n = len(data["speaker_freqs"]) * data["num_frames"]
    f, d, s = m["freq_bins"], m["d_model"], m["num_speakers"]

    def attn_block(seq_q, seq_kv):
        proj = 2 * seq_q * d * d
        kv = 2 * seq_kv * d * d
        scores = 2 * seq_q * seq_kv * d
        ffn = 2 * seq_q * d * 4 * d
        return 2 * (proj + kv + scores + ffn)

    total = 2 * 3 * t * (f * d + d * d)
    total += m["num_encoder_layers"] * attn_block(t, t)
    h, w = data["frame_h"], data["frame_w"]
    stem = (h // 2) * (w // 2) * 9 * 1 * 32 \
        + (h // 4) * (w // 4) * 9 * 32 * 64 \
        + (h // 8) * (w // 8) * 9 * 64 * 128
    total += 2 * n * stem
    total += 2 * n * 128 * d
    total += m["num_encoder_layers"] * attn_block(n, n)
    total += m["num_fusion_layers"] * attn_block(t, t)
    total += 2 * t * (d * 2 * d + 2 * d * f * s)
    return float(total)


class AttentionCall(NamedTuple):
    b: int
    h: int
    tq: int
    tk: int
    dh: int


def attention_calls(cfg: dict, batch: int) -> List[AttentionCall]:
    """The flash-attention calls of one forward: the audio and visual
    self-attention of each encoder layer and the cross-attention of each
    fusion layer (its keys resampled to the audio frames)."""
    m, data = cfg["model"], cfg["data"]
    t = 1 + int(data["sample_rate"] * data["duration"]) // data["hop_length"]
    n = len(data["speaker_freqs"]) * data["num_frames"]
    h, dh = m["nhead"], m["d_model"] // m["nhead"]
    enc = m["num_encoder_layers"]
    return ([AttentionCall(batch, h, t, t, dh)] * enc
            + [AttentionCall(batch, h, n, n, dh)] * enc
            + [AttentionCall(batch, h, t, t, dh)] * m["num_fusion_layers"])


def flash_fwd_work(c: AttentionCall, elem: int = 2) -> tuple:
    """(FLOPs, bytes) the forward needs: q k^T and p v; q, k, v read and
    o written once in the compute dtype, the float32 log-sum-exp written."""
    flops = 4.0 * c.b * c.h * c.tq * c.tk * c.dh
    nbytes = elem * c.b * c.h * c.dh * (2 * c.tq + 2 * c.tk) \
        + 4 * c.b * c.h * c.tq
    return flops, float(nbytes)


def flash_bwd_work(c: AttentionCall, elem: int = 2) -> tuple:
    """(FLOPs, bytes) the backward needs: the four gradient products
    dP = dO v^T, dV = P^T dO, dQ = dS k, dK = dS^T q (the recomputed
    q k^T is not counted); q, k, v, o, dO read and dQ, dK, dV written in
    the compute dtype, the float32 log-sum-exp read."""
    flops = 8.0 * c.b * c.h * c.tq * c.tk * c.dh
    nbytes = elem * c.b * c.h * c.dh * (4 * c.tq + 4 * c.tk) \
        + 4 * c.b * c.h * c.tq
    return flops, float(nbytes)


def least_seconds(flops: float, nbytes: float, device_kind: str) -> float:
    """The least time the work needs: operations at the bf16 peak or bytes
    at the HBM peak, the larger."""
    p = peaks(device_kind)
    return max(flops / p["bf16_flops"], nbytes / p["hbm_bytes"])
