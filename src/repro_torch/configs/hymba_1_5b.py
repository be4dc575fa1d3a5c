"""hymba-1.5b — hybrid parallel attn+mamba heads [arXiv:2411.13676].

32L d_model=1600 25H (GQA kv=5) d_ff=5504, ssm_state=16, vocab=32001.
Each block runs attention heads and Mamba (SSM) heads in PARALLEL on the same
input and fuses the normalized outputs (learned per-channel scaling). Hymba's
meta-tokens and partial-layer global attention are omitted, as in the
JAX package; sliding-window attention is used as in the paper's local layers.
Values copied from the JAX package's config of the same name.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab_size=32001,
        activation="swiglu",
        rope_theta=10000.0,
        sliding_window=1024,        # hymba local attention layers
        tie_embeddings=True,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=1, head_dim=64, chunk=256),
        source="arXiv:2411.13676 (Hymba-1.5B)",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b-reduced",
        family="hybrid",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        sliding_window=32,
        ssm=SSMConfig(d_state=8, d_conv=4, expand=1, head_dim=32, chunk=16),
        source="reduced smoke variant",
    )
