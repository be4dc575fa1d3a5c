"""Model assembly: embedding + family backbone + (tied) classification
head. The port of the JAX package's ``models/lm.py`` for the dense, vlm,
moe, ssm, hybrid, encdec and cnn families:

  init_model(generator, cfg)               -> params (a ``ParamDict``)
  abstract_model(cfg)                      -> the same on the meta device
  backbone(params, cfg, inputs, ...)       -> (hidden [B,S,D], aux, caches)
  head_weight(params, cfg)                 -> W [V, D] (the class matrix)
  decode(params, cfg, inputs, caches, slots, window) -> (hidden, caches, slots)
  decode_window / init_decode_state
  params_tree(params) / params_from_tree(tree, cfg, device)

The head weight is what the greedy token's sharded argmax runs over
(``core.sharded_softmax.serve_logits_local``). The ``cnn`` family is the
paper's ResNet trunk (``models/resnet.py``): a plain dict ``{"trunk",
"head"}`` whose ``backbone`` takes ``{"images": [B, H, W, 3]}``. The
encdec family (``models/encdec.py``) is ``{"embed", "encdec"[, "head"]}``
and its ``backbone`` takes ``{"frames": [B, enc_seq, D], "tokens"}``. The
feats family raises: the paper system's ``feats`` trunk lives in
``train.hybrid``.

``params_tree`` lays the params out as the JAX package does, each leaf of
a layer list (``blocks``; the encdec family's ``enc_blocks`` and
``dec_blocks``) stacked on a leading [L] axis (the checkpoint's and
``interop``'s layout), and ``params_from_tree`` takes that layout back to
one ``ParamDict`` a layer.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decoder as dec_lib
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import resnet as resnet_lib
from repro_torch.models.layers import (MetaGenerator, ParamDict, _dense_init,
                                       apply_embedding, apply_norm,
                                       init_embedding, init_norm)


# the layer lists, stacked on [L] in the JAX package's layout
STACKED = ("blocks", "enc_blocks", "dec_blocks")


def require_ported(cfg: ModelConfig) -> None:
    """Raise for a family this module cannot build: it builds the cnn
    trunk, the encoder-decoder and the decoder stacks ``models.decoder``
    has."""
    if cfg.family not in ("cnn", "encdec"):
        dec_lib.require_ported(cfg)


def init_model(gen: torch.Generator, cfg: ModelConfig) -> ParamDict:
    """Random params on ``gen``'s device: embedding, blocks, ``ln_f`` (the
    encdec family: embedding and ``encdec``) and, for untied embeddings,
    ``head`` [V, D]. The cnn family: a dict of the ``trunk`` and the
    ``head`` [V, D]."""
    require_ported(cfg)
    if cfg.family == "cnn":
        return {"head": _dense_init(gen, (cfg.vocab_size, cfg.d_model),
                                    in_axis=1),
                "trunk": resnet_lib.init_resnet(gen, cfg)}
    p = {"embed": init_embedding(gen, cfg)}
    if cfg.family == "encdec":
        p["encdec"] = encdec_lib.init_encdec(gen, cfg)
    else:
        p["blocks"] = dec_lib.init_blocks(gen, cfg)
        p["ln_f"] = init_norm(cfg, device=gen.device)
    if not cfg.tie_embeddings:
        p["head"] = _dense_init(gen, (cfg.vocab_size, cfg.d_model), in_axis=1)
    return ParamDict(**p)


def abstract_model(cfg: ModelConfig) -> ParamDict:
    """``init_model``'s params as meta tensors: every shape and dtype, no
    storage (the dry run and ``roofline.analysis.active_params``)."""
    return init_model(MetaGenerator(), cfg)


def head_weight(params, cfg: ModelConfig):
    """The classification head W [V, D]."""
    if cfg.family == "cnn":
        return params["head"]
    if not cfg.tie_embeddings:
        return params.head
    return params.embed.table


def backbone(params, cfg: ModelConfig, inputs, *, want_cache: bool = False,
             cache_window: Optional[int] = None, backend: str = "ref",
             remat: str = "none"):
    """-> (hidden [B,S,D], aux scalar (the MoE router losses), caches or
    None). ``backend`` selects the attention's kernels
    (``layers.multihead_attention``). The encdec family's caches are its
    decoder's self-attention K/V over the S tokens and the cross K/V over
    the encoder's frames (``cache_window`` does not apply). ``remat``
    (``ParallelConfig.remat``): ``"full"`` checkpoints each layer of the
    decoder stacks and the encoder-decoder under grad (the cnn trunk
    takes none, as in the JAX package)."""
    require_ported(cfg)
    if cfg.family == "cnn":
        feat = resnet_lib.apply_resnet(params["trunk"], cfg,
                                       inputs["images"].to(
                                           getattr(torch, cfg.dtype)))
        return feat, torch.zeros((), device=feat.device), None
    tokens = inputs["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = apply_embedding(params.embed, cfg, tokens)
    if cfg.family == "encdec":
        enc_out = encdec_lib.encode(
            params.encdec, cfg,
            inputs["frames"].to(getattr(torch, cfg.dtype)), backend=backend,
            remat=remat)
        x, caches = encdec_lib.decode_train(params.encdec, cfg, x, enc_out,
                                            positions, want_cache,
                                            backend=backend, remat=remat)
        return x, torch.zeros((), device=x.device), caches
    win = cache_window or (cfg.sliding_window or tokens.shape[1])
    x, aux, caches = dec_lib.apply_stack(
        params.blocks, cfg, x, positions, want_cache=want_cache,
        cache_window=win if want_cache else None, backend=backend,
        self_rows=True, remat=remat)
    return apply_norm(params.ln_f, x, cfg), aux, caches


def decode(params, cfg: ModelConfig, inputs, caches, slots_state, *,
           window: int, backend: str = "ref"):
    """One-token decode. inputs: {"token": [B,1]}. The caches are updated
    in place. -> (hidden [B,1,D], caches, new slots_state)."""
    x = apply_embedding(params.embed, cfg, inputs["token"])
    if cfg.family == "encdec":
        return encdec_lib.decode_step(params.encdec, cfg, x, caches,
                                      slots_state, window=window,
                                      backend=backend)
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
    init = (encdec_lib.init_encdec_decode_cache if cfg.family == "encdec"
            else dec_lib.init_decode_cache)
    caches = init(cfg, batch, window, getattr(torch, cfg.dtype),
                  device=device)
    slots = dec_lib.init_cache_slots(cfg, window, device=device)
    return caches, slots, window


def params_tree(params, *, stacked: bool = True) -> dict:
    """The params in the JAX package's layout: a plain dict tree whose
    layer lists (``STACKED``) have each leaf stacked on a leading [L] axis
    (new tensors on the params' device; the rest are the params' own).
    ``stacked=False`` puts layer 0's leaf where the stack would be: the
    same tree paths, no copy (a restore's template)."""
    def stack(layers):
        if isinstance(layers[0], dict):
            return {k: stack([x[k] for x in layers]) for k in layers[0]}
        return (torch.stack([x.detach() for x in layers]) if stacked
                else layers[0])

    def plain(node):
        if isinstance(node, dict):
            return {k: stack(list(v)) if k in STACKED else plain(v)
                    for k, v in node.items()}
        return node

    return plain(params)


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

    want = {"blocks": cfg.n_layers, "enc_blocks": cfg.n_enc_layers,
            "dec_blocks": cfg.n_layers}

    def unstack(node):
        out = {}
        for k, v in node.items():
            if k in STACKED:
                n_layers = len(v["ln1"]["scale"])
                if n_layers != want[k]:
                    raise ValueError(f"{n_layers} stacked layers in {k!r}, "
                                     f"config has {want[k]}")
                out[k] = [convert(v, layer) for layer in range(n_layers)]
            elif isinstance(v, dict):
                out[k] = unstack(v)
            else:
                out[k] = convert(v)
        return out

    return ParamDict(**unstack(tree))
