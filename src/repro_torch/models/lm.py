"""Model assembly: embedding + decoder stack + (tied) classification head.
The port of the JAX package's ``models/lm.py`` for the dense (and vlm)
family:

  init_model(generator, cfg)               -> params (a ``ParamDict``)
  backbone(params, cfg, inputs, ...)       -> (hidden [B,S,D], aux, caches)
  head_weight(params, cfg)                 -> W [V, D] (the class matrix)
  decode(params, cfg, inputs, caches, slots, window) -> (hidden, caches, slots)
  decode_window / init_decode_state

The head weight is what the greedy token's sharded argmax runs over
(``core.sharded_softmax.serve_logits_local``). The ``cnn`` family is the
paper's ResNet trunk (``models/resnet.py``): a plain dict ``{"trunk",
"head"}`` whose ``backbone`` takes ``{"images": [B, H, W, 3]}``. The
encdec and feats families (and the moe / ssm / hybrid stacks) raise,
naming ROADMAP.md: the paper system's ``feats`` trunk lives in
``train.hybrid``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decoder as dec_lib
from repro_torch.models import resnet as resnet_lib
from repro_torch.models.layers import (ParamDict, _dense_init,
                                       apply_embedding, apply_norm,
                                       init_embedding, init_norm)


def require_ported(cfg: ModelConfig) -> None:
    """Raise for a family this module cannot build: the cnn trunk, and the
    decoder stacks ``models.decoder`` has."""
    if cfg.family != "cnn":
        dec_lib.require_ported(cfg)


def init_model(gen: torch.Generator, cfg: ModelConfig) -> ParamDict:
    """Random params on ``gen``'s device: embedding, blocks, ``ln_f`` and,
    for untied embeddings, ``head`` [V, D]. The cnn family: a dict of the
    ``trunk`` and the ``head`` [V, D]."""
    require_ported(cfg)
    if cfg.family == "cnn":
        return {"head": _dense_init(gen, (cfg.vocab_size, cfg.d_model),
                                    in_axis=1),
                "trunk": resnet_lib.init_resnet(gen, cfg)}
    p = {"embed": init_embedding(gen, cfg),
         "blocks": dec_lib.init_blocks(gen, cfg),
         "ln_f": init_norm(cfg, device=gen.device)}
    if not cfg.tie_embeddings:
        p["head"] = _dense_init(gen, (cfg.vocab_size, cfg.d_model), in_axis=1)
    return ParamDict(**p)


def head_weight(params, cfg: ModelConfig):
    """The classification head W [V, D]."""
    if cfg.family == "cnn":
        return params["head"]
    if not cfg.tie_embeddings:
        return params.head
    return params.embed.table


def backbone(params, cfg: ModelConfig, inputs, *, want_cache: bool = False,
             cache_window: Optional[int] = None, backend: str = "ref"):
    """-> (hidden [B,S,D], aux scalar, caches or None). ``backend`` selects
    the attention's kernels (``layers.multihead_attention``)."""
    require_ported(cfg)
    if cfg.family == "cnn":
        feat = resnet_lib.apply_resnet(params["trunk"], cfg,
                                       inputs["images"].to(
                                           getattr(torch, cfg.dtype)))
        return feat, torch.zeros((), device=feat.device), None
    tokens = inputs["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = apply_embedding(params.embed, cfg, tokens)
    win = cache_window or (cfg.sliding_window or tokens.shape[1])
    x, aux, caches = dec_lib.apply_stack(
        params.blocks, cfg, x, positions, want_cache=want_cache,
        cache_window=win if want_cache else None, backend=backend,
        self_rows=True)
    return apply_norm(params.ln_f, x, cfg), aux, caches


def decode(params, cfg: ModelConfig, inputs, caches, slots_state, *,
           window: int, backend: str = "ref"):
    """One-token decode. inputs: {"token": [B,1]}. The caches are updated
    in place. -> (hidden [B,1,D], caches, new slots_state)."""
    x = apply_embedding(params.embed, cfg, inputs["token"])
    x, caches, slots_state = dec_lib.decode_stack(
        params.blocks, cfg, x, caches, slots_state, window=window,
        backend=backend)
    return apply_norm(params.ln_f, x, cfg), caches, slots_state


def decode_window(cfg: ModelConfig, seq_len: int) -> int:
    """KV-cache slot count for a decode shape: full seq unless windowed."""
    if cfg.sliding_window:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def init_decode_state(cfg: ModelConfig, batch: int, seq_len: int, *,
                      device):
    """Fresh caches + slot bookkeeping for decoding at seq_len."""
    window = decode_window(cfg, seq_len)
    caches = dec_lib.init_decode_cache(cfg, batch, window,
                                       getattr(torch, cfg.dtype),
                                       device=device)
    slots = dec_lib.init_cache_slots(cfg, window, device=device)
    return caches, slots, window
