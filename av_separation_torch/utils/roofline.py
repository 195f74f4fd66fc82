"""Analytic FLOP and byte accounting and the roofline report of the bench
(port of `av_separation_tpu/utils/roofline.py`).

  - FLOPs: analytic matmul and conv FLOPs from the config, in the MFU
    convention (remat does not inflate the numerator); the encoders'
    layers as `encoder_block` sets them (`conformer_block_flops`, port-only).
  - Bytes: `train_step_bytes`, an analytic estimate of parameter and
    optimizer traffic plus the activations the backward keeps.  There is
    no compiler cost analysis in PyTorch, so this is the only byte source.
  - Peaks: keyed by the card's name (`torch.cuda.get_device_name()`); a
    card not in the table gives {} and the caller omits the roofline
    fields rather than mislabel them.  `pct_of_peak` prices a rate
    against a chip's peak by the chip's own name (`h100_sxm`).
"""

from __future__ import annotations

from typing import Optional, Tuple

from av_separation_torch.config import ExperimentConfig

# (name, dense bf16 FLOP/s, float32 FLOP/s, HBM bytes/s), from NVIDIA's
# H100 SXM data sheet.  The port's float32 matrix products run without TF32
# (torch.backends.cuda.matmul.allow_tf32 is False), so float32 is priced at
# the 67 TFLOP/s outside the tensor cores.  Matched by substring against
# the lowered card name; "NVIDIA H100 80GB HBM3" is the SXM part, and an
# H100 PCIe or NVL (other peaks) is not in the table.
DEVICE_PEAKS = {
    "h100 80gb hbm3": ("h100_sxm", 989e12, 67e12, 3.35e12),
    "h100 sxm": ("h100_sxm", 989e12, 67e12, 3.35e12),
}


def detect_chip(device_name: str) -> Optional[Tuple]:
    """(name, bf16 peak, float32 peak, HBM B/s) for a card name, or None
    for a card not in the table."""
    name = device_name.lower()
    for marker, entry in DEVICE_PEAKS.items():
        if marker in name:
            return entry
    return None


def conformer_block_flops(seq: int, d: int, k: int) -> float:
    """FLOPs of one conformer block over `seq` rows (two a multiply-add):
    two 4d FFNs (16 seq d^2 MACs), q / k / v / out (4 seq d^2), QK^T and
    PV (2 seq^2 d), the pointwise convolutions d -> 2d and d -> d
    (3 seq d^2) and the depthwise one (seq d K).  GLU, BatchNorm, SiLU and
    the norms are not counted."""
    return 2.0 * (23 * seq * d * d + 2 * seq * seq * d + seq * d * k)


def model_forward_flops(cfg: ExperimentConfig) -> float:
    """Forward-pass FLOPs for ONE sample (batch=1)."""
    m, d_cfg = cfg.model, cfg.data
    t = d_cfg.num_stft_frames
    n = d_cfg.total_lip_frames
    f = m.freq_bins
    d = m.d_model
    s = m.num_speakers

    def attn_block(seq_q, seq_kv):
        """MACs of one pre-norm attention block: q/out projections over
        seq_q rows, k/v over seq_kv rows, QK^T + PV, and the 4*d FFN;
        doubled at the end for MAC -> FLOP."""
        proj = 2 * seq_q * d * d
        kv = 2 * seq_kv * d * d
        scores = 2 * seq_q * seq_kv * d
        ffn = 2 * seq_q * d * 4 * d
        return 2 * (proj + kv + scores + ffn)

    def enc_block(seq):
        if m.encoder_block == "conformer":
            return conformer_block_flops(seq, d, m.conv_kernel)
        return attn_block(seq, seq)

    total = 0.0
    total += 2 * 3 * t * (f * d + d * d)           # audio projection
    total += m.num_encoder_layers * enc_block(t)
    h, w = d_cfg.frame_h, d_cfg.frame_w            # visual conv stem
    stem = (h // 2) * (w // 2) * 9 * 1 * 32 \
        + (h // 4) * (w // 4) * 9 * 32 * 64 \
        + (h // 8) * (w // 8) * 9 * 64 * 128
    total += 2 * n * stem
    total += 2 * n * 128 * d                       # frame projection
    total += m.num_encoder_layers * enc_block(n)
    total += m.num_fusion_layers * attn_block(t, t)
    total += 2 * t * (d * 2 * d + 2 * d * f * s)   # decoder MLP
    return total


def data_gen_flops(cfg: ExperimentConfig) -> float:
    """On-device synthetic generation: (S+1) STFTs priced as matrix DFTs,
    the JAX package's accounting (the port's FFT does fewer)."""
    d_cfg = cfg.data
    t = d_cfg.num_stft_frames
    return 2 * (d_cfg.num_speakers + 1) * t * d_cfg.n_fft \
        * d_cfg.freq_bins * 2


def train_step_flops(cfg: ExperimentConfig, batch_size: int,
                     include_data_gen: bool = True) -> float:
    """Total FLOPs for one fwd+bwd+update step at `batch_size`."""
    per_sample = 3.0 * model_forward_flops(cfg)  # fwd + bwd
    if include_data_gen:
        per_sample += data_gen_flops(cfg)
    return per_sample * batch_size


def param_count(cfg: ExperimentConfig) -> float:
    """Approximate parameter count from the config (matmul and conv
    weights; biases and norms are noise)."""
    m = cfg.model
    d, f, s = m.d_model, m.freq_bins, m.num_speakers
    attn_block = 4 * d * d + 8 * d * d  # qkv + out, ffn up + down
    # The conformer's: two FFNs, qkv + out, the pointwise and depthwise
    # convolutions.
    enc_block = (23 * d * d + d * m.conv_kernel
                 if m.encoder_block == "conformer" else attn_block)
    total = 3 * f * d + 3 * d * d      # audio convs (k=3)
    total += 2 * m.num_encoder_layers * enc_block  # audio + visual stacks
    total += 9 * (32 + 32 * 64 + 64 * 128) + 128 * d  # stem + projection
    total += m.num_fusion_layers * attn_block
    total += d * 2 * d + 2 * d * f * s  # decoder
    return float(total)


def train_step_bytes(cfg: ExperimentConfig, batch_size: int) -> float:
    """Analytic estimate of the device-memory bytes one fwd+bwd+update
    step moves (approximate, as the JAX model):
      - params: forward and backward reads (compute dtype) and a float32
        gradient write, then Adam: read {grad, mu, nu, param}, write
        {mu, nu, param};
      - activations: per attention block ~15 L*d backward-saved values
        (norm outputs, q/k/v, attention output, both FFN intermediates),
        each written in the forward and read in the backward, and the
        flash kernels' float32 lse (L values) in place of the
        probabilities; per conformer block ~34 (two FFNs' 9 each, the
        attention's 5, the convolution module's 6, the residual
        stream's 4)."""
    m, d_cfg = cfg.model, cfg.data
    t = d_cfg.num_stft_frames
    n = d_cfg.total_lip_frames
    d = m.d_model
    c = 2 if m.compute_dtype == "bfloat16" else 4  # activation bytes
    p = param_count(cfg)
    param_bytes = p * (2 * c + 4) + p * 4 * 7

    def block_bytes(lq, saved=15):
        return saved * lq * d * c * 2 + lq * 4 * 2

    enc_saved = 34 if m.encoder_block == "conformer" else 15
    act = m.num_encoder_layers * (block_bytes(t, enc_saved)
                                  + block_bytes(n, enc_saved))
    act += m.num_fusion_layers * block_bytes(t)
    h, w = d_cfg.frame_h, d_cfg.frame_w
    act += n * (h * w // 4 * 32 + h * w // 16 * 64 + h * w // 64 * 128) \
        * c * 2
    act += t * (2 * d + m.freq_bins * m.num_speakers * 2) * c * 2
    return param_bytes + act * batch_size


def roofline(flops: float, bytes_accessed: Optional[float], dt: float,
             dtype: str, device_name: str) -> dict:
    """Roofline report of a measured run of `dt` seconds.

    time_lb = max(flops / peak FLOP/s, bytes / HBM B/s); `bound` names the
    larger term, and when even that floor explains less than half of the
    measured time the label is "op-overhead (floor: <term>)".
    pct_roofline = 100 * time_lb / dt.  Returns {} for a card not in the
    table (never mislabel)."""
    chip = detect_chip(device_name)
    if chip is None:
        return {}
    name, bf16_peak, f32_peak, bw = chip
    peak = bf16_peak if dtype == "bfloat16" else f32_peak
    out = {"device": name,
           "pct_peak_flops": round(100.0 * flops / dt / peak, 2)}
    if bytes_accessed:
        terms = {"compute": flops / peak, "bandwidth": bytes_accessed / bw}
        bound = max(terms, key=terms.get)
        pct = 100.0 * terms[bound] / dt
        if pct < 50.0:
            bound = f"op-overhead (floor: {bound})"
        out.update({"bound": bound, "pct_roofline": round(pct, 2),
                    "hbm_gb_per_s": round(bytes_accessed / dt / 1e9, 1)})
    return out


def pct_of_peak(flops_per_s: float, dtype: str = "float32",
                chip: str = "h100_sxm") -> float:
    """`flops_per_s` as a percentage of `chip`'s peak at `dtype`
    ('bfloat16' or 'float32'); 0.0 for a chip or dtype not in
    DEVICE_PEAKS."""
    column = {"bfloat16": 1, "float32": 2}.get(dtype)
    for entry in DEVICE_PEAKS.values():
        if entry[0] == chip and column is not None:
            return 100.0 * flops_per_s / entry[column]
    return 0.0
