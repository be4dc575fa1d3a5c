"""``repro_torch.checkpoint``: full-state checkpoints in the JAX package's
on-disk format (``checkpoint.py``), with the port's own msgpack codec
(``codec.py``)."""
from repro_torch.checkpoint.checkpoint import (all_steps, codec_name,
                                               latest_step, prune, read_meta,
                                               restore, save,
                                               validate_restore)

__all__ = ["save", "restore", "latest_step", "all_steps", "prune",
           "read_meta", "validate_restore", "codec_name"]
