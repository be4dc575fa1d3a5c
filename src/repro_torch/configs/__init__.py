from repro_torch.configs.base import (DGCConfig, FCCSConfig, HeadConfig,
                                      ModelConfig, TrainConfig,
                                      effective_vocab, pad_vocab)

__all__ = ["DGCConfig", "FCCSConfig", "HeadConfig", "ModelConfig",
           "TrainConfig", "effective_vocab", "pad_vocab"]
