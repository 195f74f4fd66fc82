"""Configuration dataclasses for the PyTorch port.

A copy of the model, data, loss and training parts of
`av_separation_tpu/config.py`, without the TPU kernel selectors
(`attn_impl`, `decoder_impl`, `proj_impl`, `stem_impl`): in this package a
tensor on the card goes through the hand-written kernel and a tensor on the
CPU through the kernel's plain PyTorch version, so there is nothing to
select.  The five named configs keep the reference's widths, depths, data
geometry and training constants field for field (`multihost` with remat, as
in JAX), `ModelConfig` carries the compute dtype and remat, and
`TrainConfig` carries the four data pipelines (host, device, native,
files) and the checkpoint fields, and `MeshConfig` the device mesh of the
parallel tier (`parallel/`); `rng_impl` is not carried over.  Port-only:
`ModelConfig.encoder_block` / `conv_kernel` (the Conformer block; the five
shared names keep the defaults, the reference's transformer layer) and the
named config `conformer_l`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


ENCODER_BLOCKS = ("transformer", "conformer")
# The conformer's depthwise kernel sizes: those `csrc/glu_dwconv.cu` is
# built for (odd, so that the zero padding is centred).
CONV_KERNELS = (7, 31)


@dataclass(frozen=True)
class ModelConfig:
    """Hyperparameters of AVSeparationTransformer (reference model.py:240-248
    defaults)."""

    freq_bins: int = 257
    d_model: int = 256
    nhead: int = 4
    num_encoder_layers: int = 2
    num_fusion_layers: int = 2
    num_speakers: int = 2
    dropout: float = 0.1
    # 'float32' | 'bfloat16': the dtype activations are computed in;
    # parameters, gradients and Adam stay float32 (models/model.py).
    compute_dtype: str = "float32"
    # Recompute each encoder and fusion layer in the backward instead of
    # keeping its activations (models/layers.py `remat_layer`).
    remat: bool = False
    # Port-only: the encoders' block, 'transformer' (the reference's
    # pre-norm layer) or 'conformer' (Gulati et al. 2020, models/layers.py
    # `ConformerLayer`), and the conformer's depthwise kernel, one of
    # `CONV_KERNELS`.
    encoder_block: str = "transformer"
    conv_kernel: int = 31

    def __post_init__(self):
        if self.encoder_block not in ENCODER_BLOCKS:
            raise ValueError(f"encoder_block {self.encoder_block!r}: one of "
                             f"{ENCODER_BLOCKS}")
        if self.conv_kernel not in CONV_KERNELS:
            raise ValueError(f"conv_kernel {self.conv_kernel}: one of "
                             f"{CONV_KERNELS}, the odd kernels that "
                             f"csrc/glu_dwconv.cu is built for")


@dataclass(frozen=True)
class DataConfig:
    """Synthetic AV dataset parameters (reference dataset.py:33-45 defaults)."""

    num_samples: int = 1000
    sample_rate: int = 8000
    duration: float = 1.0
    n_fft: int = 512
    hop_length: int = 128
    num_frames: int = 25
    frame_h: int = 32
    frame_w: int = 32
    speaker_freqs: Tuple[float, ...] = (220.0, 440.0)
    seed: int = 42

    @property
    def num_speakers(self) -> int:
        return len(self.speaker_freqs)

    @property
    def num_samples_audio(self) -> int:
        return int(self.sample_rate * self.duration)

    @property
    def freq_bins(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def num_stft_frames(self) -> int:
        # T = 1 + floor(N / hop)  (reference dataset.py:65)
        return 1 + self.num_samples_audio // self.hop_length

    @property
    def total_lip_frames(self) -> int:
        # All speakers' lip streams concatenated along the frame axis.
        return self.num_speakers * self.num_frames


@dataclass(frozen=True)
class LossConfig:
    """PIT SI-SNR + L1 loss (reference losses.py:45-73)."""

    l1_weight: float = 0.5
    # 'global': one best permutation per batch (the reference quirk,
    # losses.py:64-71).  'per_sample': standard per-utterance PIT.
    pit_mode: str = "global"
    eps: float = 1e-8


@dataclass(frozen=True)
class MeshConfig:
    """The device mesh of the parallel tier (`parallel/mesh.py`), one rank
    a device.  Axes, as in the JAX package:
    - 'data'  : utterance batches (DP); gradients are averaged over it.
    - 'fsdp'  : ZeRO-style sharding of parameters and Adam moments, gathered
      at use; the batch is also split over it, so it is a second data axis.
    - 'seq'   : sequence parallelism: the audio time axis is split over it,
      attention gathers K/V along time (`ops/attention.py`).
    - 'model' : tensor parallelism over the attention heads and the FFN's
      hidden width (Megatron-style column / row splits).
    """

    data: int = 1
    fsdp: int = 1
    seq: int = 1
    model: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.fsdp * self.seq * self.model


@dataclass(frozen=True)
class TrainConfig:
    """Training loop parameters (reference demo.py:83-113 constants)."""

    batch_size: int = 8
    steps: int = 100
    learning_rate: float = 3e-4
    grad_clip_norm: float = 1.0
    seed: int = 0
    log_every: int = 20
    # Checkpointing (utils/checkpoint.py): the directory to save into and
    # restore from, and the save interval in steps (0: only the final save).
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    # Batch pipeline: 'host' cuts batches from the NumPy dataset that
    # bit-matches the reference (data/loader.py); 'device' generates the
    # same distribution on the model's device (data/device_synthetic.py);
    # 'native' runs the threaded C++ generator (data/native_loader.py);
    # 'files' reads the corpus under `data_root` with background prefetch
    # (data/files.py), remixing speakers on the fly when `dynamic_mix`.
    data_pipeline: str = "host"
    data_root: Optional[str] = None
    dynamic_mix: bool = False


@dataclass(frozen=True)
class ExperimentConfig:
    name: str = "demo"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


def demo_config() -> ExperimentConfig:
    """Synthetic 2-speaker demo (reference demo.py:126-156, d_model=128)."""
    return ExperimentConfig(
        name="demo",
        model=ModelConfig(freq_bins=257, d_model=128, nhead=4,
                          num_encoder_layers=2, num_fusion_layers=2,
                          num_speakers=2, dropout=0.1),
        data=DataConfig(num_samples=500, sample_rate=8000, duration=1.0,
                        n_fft=512, hop_length=128, num_frames=25,
                        frame_h=32, frame_w=32, speaker_freqs=(220.0, 440.0)),
        train=TrainConfig(batch_size=8, steps=100, learning_rate=3e-4),
    )


def scaled_config() -> ExperimentConfig:
    """2-speaker scaled-up: d_model=512, 4 heads (dh=128), 6 enc + 4 fusion,
    4 s at 16 kHz (T=501), 2 x 100 lip frames."""
    return ExperimentConfig(
        name="scaled",
        model=ModelConfig(freq_bins=257, d_model=512, nhead=4,
                          num_encoder_layers=6, num_fusion_layers=4,
                          num_speakers=2, dropout=0.1),
        data=DataConfig(num_samples=1000, sample_rate=16000, duration=4.0,
                        n_fft=512, hop_length=128, num_frames=100,
                        frame_h=32, frame_w=32, speaker_freqs=(220.0, 440.0)),
        train=TrainConfig(batch_size=8, steps=100, learning_rate=3e-4),
    )


def three_speaker_config() -> ExperimentConfig:
    """3-speaker separation."""
    return ExperimentConfig(
        name="three_speaker",
        model=ModelConfig(freq_bins=257, d_model=512, nhead=4,
                          num_encoder_layers=6, num_fusion_layers=4,
                          num_speakers=3, dropout=0.1),
        data=DataConfig(num_samples=1000, sample_rate=8000, duration=1.0,
                        n_fft=512, hop_length=128, num_frames=25,
                        frame_h=32, frame_w=32,
                        speaker_freqs=(220.0, 330.0, 440.0)),
        train=TrainConfig(batch_size=8, steps=100, learning_rate=3e-4),
    )


def lrs2_config() -> ExperimentConfig:
    """LRS2-style: 25 fps 96x96 lip crops, 16 kHz audio, 3 s."""
    return ExperimentConfig(
        name="lrs2",
        model=ModelConfig(freq_bins=257, d_model=512, nhead=4,
                          num_encoder_layers=6, num_fusion_layers=4,
                          num_speakers=2, dropout=0.1),
        data=DataConfig(num_samples=1000, sample_rate=16000, duration=3.0,
                        n_fft=512, hop_length=128, num_frames=75,
                        frame_h=96, frame_w=96, speaker_freqs=(220.0, 440.0)),
        train=TrainConfig(batch_size=8, steps=100, learning_rate=3e-4),
    )


def multihost_config() -> ExperimentConfig:
    """Large: d_model=1024, 12 enc + 8 fusion, 4 speakers; heads and the
    FFN split over 4 devices of a host, DP over hosts."""
    return ExperimentConfig(
        name="multihost",
        model=ModelConfig(freq_bins=257, d_model=1024, nhead=8,
                          num_encoder_layers=12, num_fusion_layers=8,
                          num_speakers=4, dropout=0.1, remat=True),
        data=DataConfig(num_samples=10000, sample_rate=16000, duration=4.0,
                        n_fft=512, hop_length=128, num_frames=100,
                        frame_h=32, frame_w=32,
                        speaker_freqs=(220.0, 330.0, 440.0, 550.0)),
        mesh=MeshConfig(data=2, model=4),
        train=TrainConfig(batch_size=16, steps=100, learning_rate=3e-4),
    )


def conformer_l_config() -> ExperimentConfig:
    """Port-only: Conformer(L) blocks (Gulati et al. 2020, Table 1: d 512,
    8 heads, 17 layers) in both encoders, depthwise kernel 31, with the
    scaled config's fusion, decoder and data (4 s at 16 kHz, T 501,
    2 x 100 lip frames)."""
    scaled = scaled_config()
    return ExperimentConfig(
        name="conformer_l",
        model=ModelConfig(freq_bins=257, d_model=512, nhead=8,
                          num_encoder_layers=17, num_fusion_layers=4,
                          num_speakers=2, dropout=0.1,
                          encoder_block="conformer", conv_kernel=31),
        data=scaled.data, train=scaled.train)


NAMED_CONFIGS = {
    "demo": demo_config,
    "scaled": scaled_config,
    "three_speaker": three_speaker_config,
    "lrs2": lrs2_config,
    "multihost": multihost_config,
    "conformer_l": conformer_l_config,
}


def get_config(name: str) -> ExperimentConfig:
    try:
        return NAMED_CONFIGS[name]()
    except KeyError:
        raise KeyError(
            f"unknown config {name!r}; available: {sorted(NAMED_CONFIGS)}")
