"""phi3-mini-3.8b — RoPE SwiGLU GQA [arXiv:2404.14219].

32L d_model=3072 32H (kv=32, i.e. MHA) d_ff=8192 vocab=32064.
Values copied from the JAX package's config of the same name.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=32064,
        activation="swiglu",
        rope_theta=10000.0,
        tie_embeddings=False,
        source="arXiv:2404.14219 (Phi-3-mini)",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-reduced",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        source="reduced smoke variant",
    )
