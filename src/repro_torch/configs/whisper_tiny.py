"""whisper-tiny — enc-dec, conv frontend stubbed [arXiv:2212.04356].

4L enc + 4L dec, d_model=384 6H d_ff=1536 vocab=51865. The mel-spectrogram +
conv feature extractor is STUBBED per the assignment carve-out: input_specs()
provides precomputed frame embeddings [B, 1500, 384].
Values copied from the JAX package's config of the same name.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        family="encdec",
        n_layers=4,
        n_enc_layers=4,
        enc_seq=1500,
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        d_ff=1536,
        vocab_size=51865,
        activation="gelu",
        norm="layernorm",
        rope_theta=0.0,            # whisper uses learned/sinusoidal positions
        tie_embeddings=True,
        source="arXiv:2212.04356 (Whisper tiny)",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny-reduced",
        family="encdec",
        n_layers=2,
        n_enc_layers=2,
        enc_seq=64,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        activation="gelu",
        norm="layernorm",
        rope_theta=0.0,
        source="reduced smoke variant",
    )
