"""mamba2-370m — SSD (state-space duality) [arXiv:2405.21060].

48L d_model=1024, attention-free, ssm_state=128, vocab=50280.
Values copied from the JAX package's config of the same name.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        family="ssm",
        n_layers=48,
        d_model=1024,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        norm="rmsnorm",
        tie_embeddings=True,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
        source="arXiv:2405.21060 (Mamba-2 370m)",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m-reduced",
        family="ssm",
        n_layers=2,
        d_model=128,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=512,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, chunk=16),
        source="reduced smoke variant",
    )
