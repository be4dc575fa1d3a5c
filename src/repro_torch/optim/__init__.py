from repro_torch.optim.optimizers import (Optimizer, OptState, adam,
                                          apply_updates, assign, lars,
                                          make_optimizer, sgd, tree_leaves,
                                          tree_map)

__all__ = ["Optimizer", "OptState", "adam", "apply_updates", "assign",
           "lars", "make_optimizer", "sgd", "tree_leaves", "tree_map"]
