"""smollm-135m — llama-arch small [hf:HuggingFaceTB/SmolLM-135M].

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
Values copied from the JAX package's config of the same name.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m",
        family="dense",
        n_layers=30,
        d_model=576,
        n_heads=9,
        n_kv_heads=3,
        d_ff=1536,
        vocab_size=49152,
        activation="swiglu",
        rope_theta=10000.0,
        tie_embeddings=True,
        source="hf:HuggingFaceTB/SmolLM-135M",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m-reduced",
        family="dense",
        n_layers=2,
        n_heads=3,
        n_kv_heads=3,
        d_model=96,
        d_ff=256,
        vocab_size=512,
        source="reduced smoke variant",
    )
