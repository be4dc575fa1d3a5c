"""Serve steps of the architecture zoo: the port of ``make_prefill_step``
and ``make_serve_step`` of the JAX package's ``train/gspmd.py``.

The JAX package runs the zoo's trunk tensor-parallel over a (data, model)
mesh and the head as a shard_map over the vocab. Here every member of the
ring (``repro_torch.dist``) holds the whole trunk (replicated: tensor
parallelism of the trunk waits for the zoo trainer, ROADMAP.md A.9, and
does not change the numbers), and the class matrix, the tied embedding
table or the untied head, is row-sharded for the greedy token: each member
scores its row block with ``core.sharded_softmax.serve_logits_local`` and
one pmax / pmin / psum picks the token, with padded vocab rows masked
(``n_valid``). Every member calls a step with the same arguments.

``backend`` selects the attention's kernels (``"kernel"``: the
hand-written flash attention in the prefill); the greedy head is the dense
``serve_logits_local`` on both backends, as in the JAX package.
"""
from __future__ import annotations

from repro_torch import dist
from repro_torch.configs.base import InputShape, ModelConfig, effective_vocab
from repro_torch.core.sharded_softmax import serve_logits_local
from repro_torch.models import lm


def vocab_rows(w):
    """This ring member's row block of the class matrix W [V, D] (a
    view)."""
    n = dist.world_size()
    if w.shape[0] % n:
        raise ValueError(f"the vocab of {w.shape[0]} rows does not divide "
                         f"the ring of {n}: pad it (configs.pad_vocab)")
    v_loc = w.shape[0] // n
    r = dist.rank()
    return w[r * v_loc:(r + 1) * v_loc]


def _greedy(params, model_cfg: ModelConfig, f):
    n_valid = (effective_vocab(model_cfg)
               if model_cfg.real_vocab_size else 0)
    w = vocab_rows(lm.head_weight(params, model_cfg))
    token, _ = serve_logits_local(f, w, n_valid=n_valid)
    return token


def make_prefill_step(model_cfg: ModelConfig, shape: InputShape, *,
                      backend: str = "ref"):
    """Prefill: full forward + caches + last-position greedy token.
    ``step(params, inputs) -> (token [B] int32, caches)``."""
    window = lm.decode_window(model_cfg, shape.seq_len)

    def prefill_step(params, inputs):
        h, _, caches = lm.backbone(params, model_cfg, inputs, want_cache=True,
                                   cache_window=window, backend=backend)
        return _greedy(params, model_cfg, h[:, -1, :]), caches

    return prefill_step


def make_serve_step(model_cfg: ModelConfig, shape: InputShape, *,
                    backend: str = "ref"):
    """One decode token through the cache + sharded-vocab greedy sample.
    ``step(params, caches, slots, token [B,1]) -> (next [B,1], caches,
    slots)``; the caches are updated in place."""
    window = lm.decode_window(model_cfg, shape.seq_len)

    def serve_step(params, caches, slots, token):
        h, caches, slots = lm.decode(params, model_cfg, {"token": token},
                                     caches, slots, window=window,
                                     backend=backend)
        return _greedy(params, model_cfg, h[:, 0, :])[:, None], caches, slots

    return serve_step
