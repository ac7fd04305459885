"""Typed configuration, field for field the JAX package's ``config.py``.

Every knob is a frozen dataclass with the same names and defaults, so a
``ModelConfig`` written as JSON by either package loads in the other. The
five presets are the same five configurations. ``ModelConfig.dtype`` returns
a torch dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture of the generator / discriminator pair."""

    image_size: int = 64
    image_channels: int = 3
    action_dim: int = 4
    # End-effector state for joint state+action conditioning; 0 disables it.
    state_dim: int = 0

    # Generator.
    g_base_channels: int = 64
    g_max_channels: int = 512
    # Number of stride-2 stages; bottleneck spatial = image_size / 2**levels.
    g_levels: int = 3
    skip_connections: bool = False

    # Discriminator.
    d_base_channels: int = 64
    d_max_channels: int = 512
    d_levels: int = 4
    d_extra_layers: int = 0
    d_condition_frame: bool = True
    d_condition_action: bool = True
    d_spectral_norm: bool = False
    sn_iters: int = 9

    # "group", "batch" (per-batch statistics, no running averages) or "none".
    norm: str = "group"
    group_norm_groups: int = 32
    leak: float = 0.2

    # Activation dtype; parameters stay float32.
    compute_dtype: str = "bfloat16"

    # "xla" or "pallas" in the JAX package. The port accepts both and runs
    # the "pallas" dispatch for either: each layer is routed as the JAX
    # Pallas backend routes it (ops/envelope.py), then the tensor's device
    # decides: Hopper kernels on CUDA, plain ops on CPU.
    backend: str = "xla"

    # Gradient and rewrite engines of the JAX package (see its config.py).
    # gn_backward ("ad", "fused", "pallas") picks how the JAX package
    # differentiates a GroupNorm; all three compute the same gradient. The
    # port runs one path for all three: the fused conv blocks' autograd
    # Functions, whose GroupNorm backward is the closed form of ops/gn.py
    # (the gn_act_bwd kernel on CUDA, reference.gn_act_grads on the CPU).
    # wgrad="patches" (every conv's weight gradient as one im2col product,
    # ops/wgrad.py), deconv="subpixel" and conv0="s2d" (the split route's
    # plain conv-transposes and level-0 convs rewritten; a fused layer's
    # kernel already computes them so) run as ops/api.py describes.
    gn_backward: str = "ad"
    wgrad: str = "xla"
    deconv: str = "xla"
    conv0: str = "xla"

    def __post_init__(self):
        if self.backend not in ("xla", "pallas"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.gn_backward not in ("ad", "fused", "pallas"):
            raise ValueError(f"unknown gn_backward engine {self.gn_backward!r}")
        if self.wgrad not in ("xla", "patches"):
            raise ValueError(f"unknown wgrad engine {self.wgrad!r}")
        if self.sn_iters < 1:
            raise ValueError(f"sn_iters must be >= 1, got {self.sn_iters}")
        if self.wgrad == "patches" and self.backend == "pallas":
            raise ValueError("wgrad='patches' is incompatible with backend='pallas'")
        if self.deconv not in ("xla", "subpixel"):
            raise ValueError(f"unknown deconv engine {self.deconv!r}")
        if self.deconv == "subpixel" and self.backend == "pallas":
            raise ValueError("deconv='subpixel' is incompatible with backend='pallas'")
        if self.deconv == "subpixel" and self.wgrad == "patches":
            raise ValueError("deconv='subpixel' is incompatible with wgrad='patches'")
        if self.conv0 not in ("xla", "s2d"):
            raise ValueError(f"unknown conv0 engine {self.conv0!r}")
        if self.conv0 == "s2d" and self.backend == "pallas":
            raise ValueError("conv0='s2d' is incompatible with backend='pallas'")
        if self.conv0 == "s2d" and self.wgrad == "patches":
            raise ValueError("conv0='s2d' is incompatible with wgrad='patches'")

    @property
    def dtype(self) -> torch.dtype:
        if self.compute_dtype not in _DTYPES:
            raise ValueError(f"unsupported compute_dtype {self.compute_dtype!r}")
        return _DTYPES[self.compute_dtype]

    @property
    def bottleneck_size(self) -> int:
        return self.image_size // (2**self.g_levels)

    @property
    def cond_dim(self) -> int:
        return self.action_dim + self.state_dim


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DataConfig:
    source: str = "synthetic"
    data_dir: Optional[str] = None
    eval_data_dir: Optional[str] = None
    seq_len: int = 2
    shuffle_buffer: int = 256
    tfrecord_image_key: str = "image_aux1"
    tfrecord_encoding: str = "auto"
    raw_image_size: int = 64
    crop: int = 0
    crop_random: bool = False
    clip_len: int = 30
    decode_threads: int = 0
    device_dtype: str = "float32"


# ---------------------------------------------------------------------------
# Mesh / parallelism
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    # -1 means "all available devices" on the data axis.
    data: int = -1
    model: int = 1
    axis_names: Tuple[str, str] = ("data", "model")


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """``device`` as given, or ``cuda`` when None; never a silent CPU. The
    rule of every entry point (``Predictor``, ``make_train_step``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 8
    total_steps: int = 100_000
    g_lr: float = 2e-4
    d_lr: float = 2e-4
    adam_b1: float = 0.5
    adam_b2: float = 0.999
    recon_weight: float = 100.0
    recon_type: str = "l2"  # "l2" | "l1"
    gan_loss: str = "ce"  # "ce" | "hinge"
    disc_steps: int = 1
    r1_weight: float = 0.0
    d_label_smooth: float = 0.0
    d_augment: str = ""
    # One float32 parameter buffer and one Adam-moment vector per optimizer,
    # updated by one fused Adam launch (train/state.py's flat layout: the
    # JAX package's optax.flatten); per-tensor when mesh.model > 1. Changes
    # the checkpointed optimizer layout.
    flatten_optimizer: bool = False
    adam_moment_dtype: str = "float32"
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    lr_decay_steps: int = 0
    lr_end_factor: float = 0.0
    grad_clip_norm: float = 0.0
    rollout_length: int = 1
    scheduled_sampling: bool = False
    ss_start_prob: float = 0.0
    ss_end_prob: float = 1.0
    ss_decay_steps: int = 50_000
    remat_rollout: bool = False
    rollout_time_chunk: int = 0
    ema_decay: float = 0.0
    disc_microbatch: int = 0
    steps_per_call: int = 1
    scan_unroll: int = 1
    debug_nans: bool = False
    log_grad_norms: bool = False

    seed: int = 0
    log_every: int = 100
    checkpoint_every: int = 1000
    checkpoint_keep: int = 3
    sample_every: int = 1000


# ---------------------------------------------------------------------------
# Top level
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Config:
    name: str = "config1"
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    workdir: str = "/tmp/acgan"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


PRESETS = {
    # 64x64 single-step next-frame GAN, 4-dim action.
    "config1": Config(
        name="config1",
        model=ModelConfig(image_size=64, action_dim=4, g_levels=3, d_levels=4),
        data=DataConfig(source="synthetic", seq_len=2),
        train=TrainConfig(batch_size=8, rollout_length=1, steps_per_call=64),
    ),
    # 64x64 multi-step rollout (T=10), batch 16.
    "config2": Config(
        name="config2",
        model=ModelConfig(image_size=64, action_dim=4, g_levels=3, d_levels=4),
        data=DataConfig(source="synthetic", seq_len=11),
        train=TrainConfig(batch_size=16, rollout_length=10, steps_per_call=32),
    ),
    # 128x128 frames, deeper discriminator, batch 32 data-parallel.
    "config3": Config(
        name="config3",
        model=ModelConfig(
            image_size=128, action_dim=4, g_levels=4, d_levels=5, d_extra_layers=1
        ),
        data=DataConfig(source="synthetic", seq_len=2),
        train=TrainConfig(batch_size=32, rollout_length=1, steps_per_call=32),
        mesh=MeshConfig(data=-1, model=1),
    ),
    # State+action conditioning with scheduled-sampling rollouts, batch 64.
    "config4": Config(
        name="config4",
        model=ModelConfig(image_size=64, action_dim=4, state_dim=3, g_levels=3, d_levels=4),
        data=DataConfig(source="synthetic", seq_len=11),
        train=TrainConfig(
            batch_size=64,
            rollout_length=10,
            steps_per_call=16,
            scheduled_sampling=True,
            ss_start_prob=0.0,
            ss_end_prob=1.0,
            ss_decay_steps=50_000,
        ),
        mesh=MeshConfig(data=-1, model=1),
    ),
    # 256x256 long-horizon (T=30) rollouts, data-parallel.
    "config5": Config(
        name="config5",
        model=ModelConfig(
            image_size=256, action_dim=4, g_levels=5, d_levels=6, d_extra_layers=1
        ),
        data=DataConfig(source="synthetic", seq_len=31),
        train=TrainConfig(
            batch_size=32,
            rollout_length=30,
            remat_rollout=True,
            steps_per_call=4,
            rollout_time_chunk=2,
        ),
        mesh=MeshConfig(data=-1, model=1),
    ),
}


def config_from_dict(d: dict) -> Config:
    """A Config from ``dataclasses.asdict`` of a Config of either package
    (the JSON both write)."""
    d = dict(d)
    mesh = dict(d.pop("mesh", {}))
    if "axis_names" in mesh:
        mesh["axis_names"] = tuple(mesh["axis_names"])
    return Config(
        model=ModelConfig(**d.pop("model", {})),
        data=DataConfig(**d.pop("data", {})),
        train=TrainConfig(**d.pop("train", {})),
        mesh=MeshConfig(**mesh),
        **d,
    )


def get_preset(name: str, **overrides) -> Config:
    """Return a named preset, optionally with field overrides."""
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    cfg = PRESETS[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
