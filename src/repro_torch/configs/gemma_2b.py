"""gemma-2b — GeGLU, head_dim=256, MQA [arXiv:2403.08295].

18L d_model=2048 8H (kv=1, MQA) d_ff=16384 vocab=256000.
Values copied from the JAX package's config of the same name.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b",
        family="dense",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=256000,
        activation="geglu",
        rope_theta=10000.0,
        tie_embeddings=True,
        source="arXiv:2403.08295 (Gemma 2B)",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b-reduced",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=1,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        activation="geglu",
        source="reduced smoke variant",
    )
