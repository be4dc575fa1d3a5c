from repro_torch.optim.optimizers import (Optimizer, OptState, adam,
                                          apply_updates, assign, lars,
                                          make_optimizer, sgd, tree_leaves,
                                          tree_map)
from repro_torch.optim.scale import (LossScaleState, dynamic_loss_scale,
                                     init_loss_scale, scaled_grads)

__all__ = ["LossScaleState", "Optimizer", "OptState", "adam",
           "apply_updates", "assign", "dynamic_loss_scale",
           "init_loss_scale", "lars", "make_optimizer", "scaled_grads",
           "sgd", "tree_leaves", "tree_map"]
