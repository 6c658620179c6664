"""Typed configuration tree for the PyTorch port of helmnet-tpu.

The port's own copy of `helmnet_tpu/core/config.py` (the JAX package's
`__init__` imports JAX, so the port cannot import it). Field names,
defaults and the JSON layout are the same, so one experiment file drives
both packages (sections environment/geometry/medium/neural_network/source/
training, as in `experiments/base.json`).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class GeometryConfig:
    domain_size: int = 96
    pml_size: int = 8
    sigma_max: float = 2.0

    @staticmethod
    def from_json(d: dict) -> "GeometryConfig":
        return GeometryConfig(
            domain_size=int(d.get("grid size", 96)),
            pml_size=int(d.get("PML Size", 8)),
            sigma_max=float(d.get("sigma max", 2.0)),
        )


@dataclass(frozen=True)
class MediumConfig:
    c0: float = 1.0
    train_set: str = "datasets/splitted_96/trainset.npz"
    validation_set: str = "datasets/splitted_96/validation.npz"
    test_set: str = "datasets/splitted_96/testset.npz"

    @staticmethod
    def from_json(d: dict) -> "MediumConfig":
        return MediumConfig(
            c0=float(d.get("c0", 1.0)),
            train_set=d.get("train_set", MediumConfig.train_set),
            validation_set=d.get("validation_set", MediumConfig.validation_set),
            test_set=d.get("test_set", MediumConfig.test_set),
        )


@dataclass(frozen=True)
class ModelConfig:
    architecture: str = "custom_unet"
    activation_function: str = "prelu"
    features: int = 8
    depth: int = 4
    state_depth: int = 4
    state_channels: int = 2
    in_channels: int = 6
    # Network conv precision: 'highest', 'high' or 'default'. The port's
    # cuDNN convs run in f32 (TF32 off) under every name; 'default' is
    # what lets double_conv_mode='pallas' take the bf16-tap kernel.
    precision: str = "default"
    # Transposed-conv form: 'dilated' (torch ConvTranspose2d semantics) or
    # 'subpixel' (4 phase sub-convs at input resolution, identical math;
    # models/blocks.py)
    up_mode: str = "dilated"
    # DoubleConv path: 'xla' (cuDNN convs in f32, the yardstick) or
    # 'pallas' (the fused conv->PReLU->conv CUDA kernel of
    # ops/double_conv.py; bf16 taps, f32 accumulation; taken when
    # precision == 'default' and the activation is PReLU or ReLU)
    double_conv_mode: str = "xla"

    @staticmethod
    def from_json(d: dict) -> "ModelConfig":
        return ModelConfig(
            architecture=d.get("architecture", "custom_unet"),
            activation_function=d.get("activation function", "prelu"),
            features=int(d.get("channels per layer", 8)),
            depth=int(d.get("depth", 4)),
            state_depth=int(d.get("states depth", 4)),
            state_channels=int(d.get("state channels", 2)),
        )


@dataclass(frozen=True)
class SourceConfig:
    amplitude: float = 10.0
    location: Tuple[int, int] = (82, 48)
    omega: float = 1.0
    phase: float = 0.0
    smoothing: bool = False

    @staticmethod
    def from_json(d: dict) -> "SourceConfig":
        return SourceConfig(
            amplitude=float(d.get("amplitude", 10.0)),
            location=tuple(d.get("location", (82, 48))),
            omega=float(d.get("omega", 1.0)),
            phase=float(d.get("phase", 0.0)),
            smoothing=bool(d.get("smoothing", False)),
        )


@dataclass(frozen=True)
class TrainingConfig:
    buffer_size: int = 600
    gradient_clip: float = 1.0
    learning_rate: float = 1e-4
    minimum_learning_rate: float = 1e-5
    loss: str = "mse"
    loss_amplify: float = 1e4
    optimizer: str = "adam"
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    train_batch_size: int = 32
    test_batch_size: int = 128
    weight_decay: float = 1e-6
    unrolling_steps: int = 10
    max_epochs: int = 1000
    plateau_factor: float = 0.5
    plateau_patience: int = 10
    # curriculum: allowed solve length = min(curriculum_slope*epoch + 1, max_iterations)
    curriculum_slope: int = 20
    # probability that a restarted replay slot draws a random-circle source
    # instead of the fixed training source. The reference trains fixed-source
    # only (hybridnet.py:145-156) and validates on random circle sources
    # (hybridnet.py:178-190); a nonzero value trains the generalization the
    # validation measures (our extension — 0.0 reproduces the reference).
    p_random_source: float = 0.0
    # probability that a restarted replay slot draws a random extended
    # line-segment source (our far-OOD curriculum; the reference has no
    # extended sources at all, and its checkpoint diverges on them —
    # PERF_NOTES.md 1024^2 limitation). 0.0 reproduces the reference.
    p_extended_source: float = 0.0
    # rematerialize each unrolled BPTT step (jax.checkpoint): tape holds
    # per-step carries only, ~1/3 extra FLOPs. Required for 3D training on
    # one chip (70 GB un-rematerialized at 48^3 x batch 8 x unroll 10).
    remat: bool = False
    # device-path training source pool representation. None = auto: store
    # [K, 2] integer locations + separable 1D kernels and stamp point
    # sources on device (ops/source.point_source_kernels) when the grid is
    # >= 256^2 and no extended (line) sources are in the curriculum; the
    # dense [K, H, W, 2] pool is 5.6 GB of HBM at 1024^2 with the
    # 720-circle curriculum. True/False force the representation.
    sparse_source_pool: bool | None = None

    @staticmethod
    def from_json(d: dict) -> "TrainingConfig":
        return TrainingConfig(
            buffer_size=int(d.get("buffer size", 600)),
            gradient_clip=float(d.get("gradient clipping", 1.0)),
            learning_rate=float(d.get("learning rate", 1e-4)),
            minimum_learning_rate=float(d.get("minimum learning rate", 1e-5)),
            loss=d.get("loss", "mse"),
            optimizer=d.get("optimizer", "adam"),
            train_batch_size=int(d.get("train batch size", 32)),
            test_batch_size=int(d.get("test batch size", 128)),
            weight_decay=float(d.get("weight_decay", 1e-6)),
            p_random_source=float(d.get("p random source", 0.0)),
            p_extended_source=float(d.get("p extended source", 0.0)),
        )


@dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh layout. Axes: data (DP over replay batch), y/x (spatial
    domain decomposition of the H/W grid axes)."""

    data: int = 1
    y: int = 1
    x: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.y * self.x


@dataclass(frozen=True)
class Config:
    max_iterations: int = 1000
    geometry: GeometryConfig = field(default_factory=GeometryConfig)
    medium: MediumConfig = field(default_factory=MediumConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    source: SourceConfig = field(default_factory=SourceConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    # Operator backend: 'matmul' (DFT-derivative dense matmuls) or 'fft'
    # (1D FFT based). 'auto' picks matmul below 1024^2 and fft at/above it
    # (ops/spectral.resolve_mode), the JAX package's crossover.
    operator_mode: str = "auto"

    @property
    def k0(self) -> float:
        # reference wavenumber used by the PML gamma functions (=omega/c0)
        return self.source.omega / self.medium.c0

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def from_json_file(path: str) -> "Config":
        with open(path) as f:
            d = json.load(f)
        return Config.from_json(d)

    @staticmethod
    def from_json(d: dict) -> "Config":
        env = d.get("environment", {})
        return Config(
            max_iterations=int(env.get("max iterations", 1000)),
            geometry=GeometryConfig.from_json(d.get("geometry", {})),
            medium=MediumConfig.from_json(d.get("medium", {})),
            model=ModelConfig.from_json(d.get("neural_network", {})),
            source=SourceConfig.from_json(d.get("source", {})),
            training=TrainingConfig.from_json(d.get("training", {})),
        )

    def to_json(self) -> dict:
        return {
            "environment": {"max iterations": self.max_iterations, "signal": "residual"},
            "geometry": {
                "grid size": self.geometry.domain_size,
                "PML Size": self.geometry.pml_size,
                "sigma max": self.geometry.sigma_max,
            },
            "medium": {
                "c0": self.medium.c0,
                "train_set": self.medium.train_set,
                "validation_set": self.medium.validation_set,
                "test_set": self.medium.test_set,
            },
            "neural_network": {
                "architecture": self.model.architecture,
                "activation function": self.model.activation_function,
                "channels per layer": self.model.features,
                "depth": self.model.depth,
                "states depth": self.model.state_depth,
                "state channels": self.model.state_channels,
            },
            "source": {
                "amplitude": self.source.amplitude,
                "location": list(self.source.location),
                "omega": self.source.omega,
                "phase": self.source.phase,
                "smoothing": self.source.smoothing,
            },
            "training": {
                "buffer size": self.training.buffer_size,
                "gradient clipping": self.training.gradient_clip,
                "learning rate": self.training.learning_rate,
                "minimum learning rate": self.training.minimum_learning_rate,
                "loss": self.training.loss,
                "optimizer": self.training.optimizer,
                "train batch size": self.training.train_batch_size,
                "test batch size": self.training.test_batch_size,
                "weight_decay": self.training.weight_decay,
            },
        }


def load_settings(path: str) -> Config:
    """Reference-compatible settings loader (helmnet/utils.py:7-22)."""
    return Config.from_json_file(path)
