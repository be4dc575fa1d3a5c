"""chameleon-34b — early-fusion VLM, VQ image tokens [arXiv:2405.09818].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536 (text+image tokens in
one early-fused vocabulary). qk-norm per the paper. The VQ-VAE image tokenizer
is STUBBED: input_specs() provides interleaved token ids + modality mask.
Values copied from the JAX package's config of the same name.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b",
        family="vlm",
        n_layers=48,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=22016,
        vocab_size=65536,
        activation="swiglu",
        qk_norm=True,              # chameleon's training-stability fix
        rope_theta=10000.0,
        tie_embeddings=False,
        source="arXiv:2405.09818 (Chameleon 34B)",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b-reduced",
        family="vlm",
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
