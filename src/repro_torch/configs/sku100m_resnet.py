"""The paper's own setting: a ResNet-50-class feature extractor (D=512
embedding) and an extreme-classification head over N = 1M / 10M / 100M
SKU classes. Values copied from the JAX package's config of the same name.
"""
from repro_torch.configs.base import ModelConfig


def config(n_classes: int = 100_001_020) -> ModelConfig:
    return ModelConfig(
        name="sku100m-resnet50",
        family="cnn",
        n_layers=50,
        d_model=512,               # paper: feature dim 512
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=n_classes,      # classes == "vocab" for the shared head
        tie_embeddings=False,
        source="KDD'20 paper §4 (ResNet-50, D=512, SKU-100M)",
    )


def config_1m() -> ModelConfig:
    return config(1_020_250)


def config_10m() -> ModelConfig:
    return config(9_890_866)


def reduced(n_classes: int = 1024) -> ModelConfig:
    return ModelConfig(
        name="sku-resnet-reduced",
        family="cnn",
        n_layers=8,
        d_model=128,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=n_classes,
        tie_embeddings=False,
        source="reduced smoke variant",
    )
