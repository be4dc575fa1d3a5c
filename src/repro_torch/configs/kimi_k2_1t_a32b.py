"""kimi-k2-1t-a32b — trillion-param MoE [arXiv:2501.kimi2 paper-table].

61L d_model=7168 64H (GQA kv=8) per-expert d_ff=2048, vocab=163840,
MoE 384 experts top-8.
Values copied from the JAX package's config of the same name.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        head_dim=112,
        d_ff=2048,
        vocab_size=163840,
        activation="swiglu",
        qk_norm=False,
        rope_theta=50000.0,
        tie_embeddings=False,
        moe=MoEConfig(n_experts=384, top_k=8, d_ff=2048, n_shared_experts=1),
        source="arXiv:2501.kimi2 (Kimi K2 paper table)",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-reduced",
        family="moe",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=64,
        vocab_size=512,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=64, n_shared_experts=1, capacity_factor=8.0),
        source="reduced smoke variant",
    )
