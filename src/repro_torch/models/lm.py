"""Model assembly: embedding + decoder stack + (tied) classification head.
The port of the JAX package's ``models/lm.py`` for the dense, vlm, ssm and
hybrid families:

  init_model(generator, cfg)               -> params (a ``ParamDict``)
  backbone(params, cfg, inputs, ...)       -> (hidden [B,S,D], aux, caches)
  head_weight(params, cfg)                 -> W [V, D] (the class matrix)
  decode(params, cfg, inputs, caches, slots, window) -> (hidden, caches, slots)
  decode_window / init_decode_state
  params_tree(params) / params_from_tree(tree, cfg, device)

The head weight is what the greedy token's sharded argmax runs over
(``core.sharded_softmax.serve_logits_local``). The ``cnn`` family is the
paper's ResNet trunk (``models/resnet.py``): a plain dict ``{"trunk",
"head"}`` whose ``backbone`` takes ``{"images": [B, H, W, 3]}``. The
encdec and feats families (and the moe stack) raise, naming ROADMAP.md:
the paper system's ``feats`` trunk lives in ``train.hybrid``.

``params_tree`` lays the decoder params out as the JAX package does, each
block leaf stacked on a leading [L] axis (the checkpoint's and
``interop``'s layout), and ``params_from_tree`` takes that layout back to
one ``ParamDict`` a layer.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
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
    """KV-cache slot count for a decode shape: full seq unless windowed;
    1 for the ssm family, which has no KV cache (its state is the
    cache)."""
    if cfg.family == "ssm":
        return 1
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


def params_tree(params, *, stacked: bool = True) -> dict:
    """The decoder params in the JAX package's layout: a plain dict tree
    whose ``blocks`` has each leaf stacked on a leading [L] axis (new
    tensors on the params' device; the rest are the params' own).
    ``stacked=False`` puts layer 0's leaf where the stack would be: the
    same tree paths, no copy (a restore's template)."""
    def plain(node):
        if isinstance(node, dict):
            return {k: plain(v) for k, v in node.items()}
        return node

    def stack(layers):
        if isinstance(layers[0], dict):
            return {k: stack([x[k] for x in layers]) for k in layers[0]}
        return (torch.stack([x.detach() for x in layers]) if stacked
                else layers[0])

    tree = {k: plain(v) for k, v in params.items() if k != "blocks"}
    tree["blocks"] = stack(list(params["blocks"]))
    return tree


def params_from_tree(tree: dict, cfg: ModelConfig, *, device) -> ParamDict:
    """The inverse of ``params_tree`` from host arrays or tensors: fp32
    copies on ``device``, one ``ParamDict`` a layer."""
    def convert(node, layer=None):
        if isinstance(node, dict):
            return {k: convert(v, layer) for k, v in node.items()}
        a = node if torch.is_tensor(node) else np.asarray(node)
        a = a if layer is None else a[layer]
        # a copy: a restored leaf or a JAX host array stays as it is
        return (a.to(device=device, dtype=torch.float32, copy=True)
                if torch.is_tensor(a)
                else torch.tensor(a, dtype=torch.float32, device=device))

    blocks = tree["blocks"]
    n_layers = len(blocks["ln1"]["scale"])
    if n_layers != cfg.n_layers:
        raise ValueError(f"{n_layers} stacked layers, config has "
                         f"{cfg.n_layers}")
    params = {k: convert(v) for k, v in tree.items() if k != "blocks"}
    params["blocks"] = [convert(blocks, layer) for layer in range(n_layers)]
    return ParamDict(**params)
