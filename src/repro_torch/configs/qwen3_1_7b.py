"""qwen3-1.7b — qk_norm, GQA [hf:Qwen/Qwen3-8B family].

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936.
Values copied from the JAX package's config of the same name.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b",
        family="dense",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=6144,
        vocab_size=151936,
        activation="swiglu",
        qk_norm=True,
        rope_theta=1000000.0,
        tie_embeddings=True,
        source="hf:Qwen/Qwen3-1.7B",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b-reduced",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        qk_norm=True,
        source="reduced smoke variant",
    )
