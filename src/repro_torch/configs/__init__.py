from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES,
                                      LONG_CONTEXT_SKIP, DGCConfig,
                                      FCCSConfig, HeadConfig, InputShape,
                                      ModelConfig, ParallelConfig,
                                      TrainConfig, effective_vocab,
                                      for_shape, get_model_config,
                                      normalize_arch_id, pad_vocab,
                                      ring_parallel_config)

__all__ = ["ARCH_IDS", "INPUT_SHAPES", "LONG_CONTEXT_SKIP", "DGCConfig",
           "FCCSConfig", "HeadConfig", "InputShape", "ModelConfig",
           "ParallelConfig", "TrainConfig", "effective_vocab", "for_shape",
           "get_model_config", "normalize_arch_id", "pad_vocab",
           "ring_parallel_config"]
