"""Config dataclasses of the port, field for field those of the JAX
package's ``configs/base.py``, so one dict drives both packages.

The one difference is the vocabulary of ``HeadConfig.backend`` and
``DGCConfig.backend``: ``"ref"`` (plain torch ops) or ``"kernel"`` (the
hand-written CUDA kernels), where the JAX package says ``"pallas"``.
``repro_torch.interop.head_config_from_dict`` maps the one onto the other.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field, replace
from typing import Optional

BACKENDS = ("ref", "kernel")


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int
    router_aux_coef: float = 0.01
    n_shared_experts: int = 0
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 64
    n_groups: int = 1


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm | cnn | feats
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    activation: str = "swiglu"
    norm: str = "rmsnorm"
    norm_eps: float = 1e-6
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None
    tie_embeddings: bool = True
    n_enc_layers: int = 0
    enc_seq: int = 0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # vocab padding: when the vocab does not divide the ring, W rows are
    # padded and the padded logits masked
    real_vocab_size: Optional[int] = None
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def with_sliding_window(self, window: int = 4096) -> "ModelConfig":
        return replace(self, sliding_window=window)


@dataclass(frozen=True)
class HeadConfig:
    """The hybrid-parallel extreme-classification head.

    ``softmax_impl`` names a registered ``repro_torch.api.heads`` strategy;
    ``backend`` is ``"ref"`` (dense torch ops) or ``"kernel"`` (the
    hand-written CUDA kernels in ``repro_torch.kernels``). The
    ``pallas_block_*`` names are kept so one config dict drives both
    packages."""
    softmax_impl: str = "full"     # full|knn|selective|mach|sampled|csoft
    backend: str = "kernel"        # ref (torch ops) | kernel (CUDA kernels)
    pallas_block_v: int = 512
    pallas_block_a: int = 128
    cosine_scale: float = 16.0     # normalized-logit scale (§3.2.1); 0 = raw
    knn_k: int = 16
    knn_kprime: int = 32
    active_frac: float = 0.10
    rebuild_every: int = 0
    knn_pad_random: bool = True
    selective_n_hash: int = 4
    selective_n_bits: int = 8
    selective_cap: int = 32
    mach_b: int = 64
    mach_r: int = 4
    sampled_n: int = 2048
    sampled_dist: str = "uniform"
    sampled_seed: int = 17
    csoft_b: int = 64
    csoft_r: int = 4
    csoft_agg: str = "min"
    label_smoothing: float = 0.0
    z_loss: float = 0.0

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend must be 'ref' or 'kernel', got {self.backend!r}")
        if self.sampled_dist not in ("uniform", "log_uniform"):
            raise ValueError(
                f"sampled_dist must be 'uniform' or 'log_uniform', got "
                f"{self.sampled_dist!r}")
        if self.csoft_agg not in ("min", "mean"):
            raise ValueError(
                f"csoft_agg must be 'min' or 'mean', got {self.csoft_agg!r}")
        from repro_torch.api.heads import KNOWN_HEADS
        if self.softmax_impl not in KNOWN_HEADS:
            raise ValueError(
                f"unknown softmax_impl {self.softmax_impl!r}; known heads: "
                f"{sorted(KNOWN_HEADS)}")


@dataclass(frozen=True)
class ParallelConfig:
    """The JAX package's mesh and sharding policy, field for field.

    On a grid (``repro_torch.dist.grid``) ``rules`` and ``param_rules``
    place every param as the JAX package's do (``train.gspmd.
    param_pspecs``): the dense, vlm and moe trunks tensor- and
    expert-parallel over ``model``, FSDP over ``data`` where
    ``param_rules`` say so, the batch over ``batch_axes``. The port's
    plain ring keeps the trunk replicated with the vocab over the ring.
    ``remat`` is applied (``"full"``: each layer's activations recomputed
    in the backward, ``torch.utils.checkpoint``)."""
    mesh_shape: tuple = (16, 16)
    axis_names: tuple = ("data", "model")
    # logical axis -> mesh axis rules (MaxText-style)
    rules: tuple = (
        ("batch", ("pod", "data")),
        ("vocab", "model"),
        ("heads", "model"),
        ("kv_heads", "model"),
        ("mlp", "model"),
        ("experts", "model"),
        ("expert_mlp", None),
        ("head_dim", None),
        ("inner", "model"),        # ssm d_inner
        ("embed", None),
        ("seq", None),
        ("layers", None),
    )
    remat: str = "none"            # none | full
    # FSDP / ZeRO: rules for the params (and moments); None: ``rules``
    param_rules: Optional[tuple] = None

    @property
    def batch_axes(self) -> tuple:
        return tuple(a for a in ("pod", "data") if a in self.axis_names)

    @property
    def model_axis(self) -> str:
        return "model"

    def _lookup(self, rules, logical: str):
        for k, v in rules:
            if k == logical:
                if isinstance(v, tuple):
                    return tuple(a for a in v if a in self.axis_names) or None
                if v is not None and v not in self.axis_names:
                    return None
                return v
        return None

    def mesh_axis_for(self, logical: str):
        return self._lookup(self.rules, logical)

    def mesh_axis_for_param(self, logical: str):
        return self._lookup(self.param_rules or self.rules, logical)


def ring_parallel_config(n: int = 1, remat: str = "none") -> ParallelConfig:
    """The port's ring of ``n`` members as a (data, model) mesh of (1, n):
    the trainers' default."""
    return ParallelConfig(mesh_shape=(1, n), axis_names=("data", "model"),
                          remat=remat)


@dataclass(frozen=True)
class FCCSConfig:
    """Fast continuous convergence strategy (paper §3.4)."""
    eta0: float = 0.4
    t_warm: int = 100
    b0: int = 4096
    b_min: int = 4096
    b_max: int = 262144
    t_ini: int = 100
    t_final: int = 2000


@dataclass(frozen=True)
class DGCConfig:
    """Layer-wise top-k gradient sparsification (paper §3.3.2 / DGC)."""
    enabled: bool = False
    sparsity: float = 0.999
    momentum: float = 0.9
    factor_masking: bool = True
    chunk: int = 2048
    group_bytes: int = 1 << 22
    backend: str = "ref"           # ref | kernel (kernels.ops.topk_dc)

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"DGC backend must be 'ref' or 'kernel', got "
                f"{self.backend!r}")


@dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "lars"
    weight_decay: float = 1e-4
    momentum: float = 0.9
    micro_batch: int = 0
    grad_accum: int = 1
    loss_scale: float = 0.0
    fccs: FCCSConfig = field(default_factory=FCCSConfig)
    dgc: DGCConfig = field(default_factory=DGCConfig)
    seed: int = 0
    steps: int = 200


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                      # train | prefill | decode


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,   32, "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",  524_288,    1, "decode"),
}

# long_500k: ssm / hybrid natively, dense / moe / vlm in the sliding-window
# variant, whisper (448-token decoder) skipped, as in the JAX package
LONG_CONTEXT_SKIP = {"whisper_tiny"}

ARCH_IDS = [
    "mamba2_370m", "kimi_k2_1t_a32b", "qwen3_moe_30b_a3b", "phi3_mini_3_8b",
    "qwen3_1_7b", "gemma_2b", "whisper_tiny", "chameleon_34b", "smollm_135m",
    "hymba_1_5b",
]


def normalize_arch_id(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_model_config(arch: str, reduced: bool = False) -> ModelConfig:
    arch = normalize_arch_id(arch)
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.reduced() if reduced else mod.config()


def pad_vocab(cfg: ModelConfig, multiple: int = 128) -> ModelConfig:
    """Pad vocab to a multiple (ring divisibility). Labels stay below
    real_vocab_size; padded logits are masked."""
    if cfg.vocab_size % multiple == 0:
        return cfg
    padded = -(-cfg.vocab_size // multiple) * multiple
    return replace(cfg, vocab_size=padded,
                   real_vocab_size=cfg.real_vocab_size or cfg.vocab_size)


def effective_vocab(cfg: ModelConfig) -> int:
    return cfg.real_vocab_size or cfg.vocab_size


def for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """A model config adapted to an input shape (the sliding window for
    the long context)."""
    if shape.name == "long_500k" and cfg.family in ("dense", "moe", "vlm"):
        return cfg.with_sliding_window(4096)
    return cfg
