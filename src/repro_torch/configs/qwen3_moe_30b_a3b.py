"""qwen3-moe-30b-a3b — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B].

48L d_model=2048 32H (GQA kv=4) per-expert d_ff=768, vocab=151936.
Values copied from the JAX package's config of the same name.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=768,
        vocab_size=151936,
        activation="swiglu",
        qk_norm=True,
        rope_theta=1000000.0,
        tie_embeddings=False,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff=768),
        source="hf:Qwen/Qwen3-30B-A3B",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-reduced",
        family="moe",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=64,
        vocab_size=512,
        qk_norm=True,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=64, capacity_factor=8.0),
        source="reduced smoke variant",
    )
