from repro_torch.configs.base import (ARCH_IDS, DGCConfig, FCCSConfig,
                                      HeadConfig, InputShape, ModelConfig,
                                      TrainConfig, effective_vocab,
                                      get_model_config, normalize_arch_id,
                                      pad_vocab)

__all__ = ["ARCH_IDS", "DGCConfig", "FCCSConfig", "HeadConfig", "InputShape",
           "ModelConfig", "TrainConfig", "effective_vocab",
           "get_model_config", "normalize_arch_id", "pad_vocab"]
