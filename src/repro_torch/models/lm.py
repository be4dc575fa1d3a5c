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

On a grid (``repro_torch.dist``) ``init_model(gen, cfg, specs)`` draws the
whole tree from the generator, as on the ring, and keeps the member's
slice of each leaf (``specs``: ``train.gspmd.member_specs``), a layer at a
time, so a grid's model is the ring's model, cut; ``backbone``,
``decode`` and ``head_weight`` take the same specs and gather what FSDP
split over the batch axes (the head's W: the member's [V / n_model, D]
block). Every zoo family splits: the dense, vlm and moe trunks, the ssm
mixer (``models.ssm``) and the hybrid block, and the encoder-decoder
(``models.encdec``).

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

from repro_torch import dist
from repro_torch.configs.base import ModelConfig
from repro_torch.models import decoder as dec_lib
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import resnet as resnet_lib
from repro_torch.models.layers import (MetaGenerator, ParamDict, _dense_init,
                                       apply_embedding, apply_norm,
                                       embedding_axes, init_embedding,
                                       init_norm, norm_axes)


# the layer lists, stacked on [L] in the JAX package's layout
STACKED = ("blocks", "enc_blocks", "dec_blocks")


def require_ported(cfg: ModelConfig, grid: bool = False) -> None:
    """Raise for a family this module cannot build: it builds the cnn
    trunk, the encoder-decoder and the decoder stacks ``models.decoder``
    has; a grid (``grid=True``) splits every zoo family, and refuses the
    paper's cnn trunk, which the paper trainer runs data-parallel."""
    if cfg.family not in ("cnn", "encdec"):
        dec_lib.require_ported(cfg)
    if grid and cfg.family == "cnn":
        raise NotImplementedError(
            "the cnn trunk is not split over a (data, model) grid: the "
            "paper trainer runs it data-parallel")


def cut(tree, specs):
    """This member's slice of every leaf of ``tree`` by ``specs`` (a tree
    of the same layout, ``dist.member_block``), each a copy of its own;
    ``specs=None``: the tree as it is."""
    if specs is None:
        return tree
    if isinstance(tree, list):
        return [cut(t, s) for t, s in zip(tree, specs)]
    if isinstance(tree, dict):
        out = {k: cut(v, specs[k]) for k, v in tree.items()}
        return out if type(tree) is dict else type(tree)(**out)
    return dist.member_block(tree, specs).clone()


def gather_params(params, specs):
    """The whole params from every member's slices by ``specs`` (a
    collective over the grid; ``cut``'s inverse)."""
    if isinstance(params, list):
        return [gather_params(t, s) for t, s in zip(params, specs)]
    if isinstance(params, dict):
        out = {k: gather_params(v, specs[k]) for k, v in params.items()}
        return out if type(params) is dict else type(params)(**out)
    return dist.gather_block(params.detach(), specs)


def init_model(gen: torch.Generator, cfg: ModelConfig,
               specs=None) -> ParamDict:
    """Random params on ``gen``'s device: embedding, blocks, ``ln_f`` (the
    encdec family: embedding and ``encdec``) and, for untied embeddings,
    ``head`` [V, D]. The cnn family: a dict of the ``trunk`` and the
    ``head`` [V, D]. ``specs`` (``train.gspmd.member_specs``): the
    member's slices of the same draws, cut a layer at a time."""
    require_ported(cfg, grid=specs is not None)
    sp = specs or {}
    if cfg.family == "cnn":
        return {"head": _dense_init(gen, (cfg.vocab_size, cfg.d_model),
                                    in_axis=1),
                "trunk": resnet_lib.init_resnet(gen, cfg)}
    p = {"embed": cut(init_embedding(gen, cfg), sp.get("embed"))}
    if cfg.family == "encdec":
        p["encdec"] = cut(encdec_lib.init_encdec(gen, cfg), sp.get("encdec"))
    else:
        p["blocks"] = [cut(dec_lib.init_block(gen, cfg),
                           None if specs is None else specs["blocks"][i])
                       for i in range(cfg.n_layers)]
        p["ln_f"] = cut(init_norm(cfg, device=gen.device), sp.get("ln_f"))
    if not cfg.tie_embeddings:
        p["head"] = cut(_dense_init(gen, (cfg.vocab_size, cfg.d_model),
                                    in_axis=1), sp.get("head"))
    return ParamDict(**p)


def model_axes(cfg: ModelConfig):
    """Logical axes of every param, in ``params_tree``'s layout (the layer
    lists stacked, a leading ``"layers"``): the JAX package's
    ``model_axes``, leaf for leaf."""
    if cfg.family == "cnn":
        return {"trunk": None, "head": ("vocab", "embed")}
    a = {"embed": embedding_axes(cfg)}
    if cfg.family == "encdec":
        a["encdec"] = encdec_lib.encdec_axes(cfg)
    else:
        a["blocks"] = encdec_lib._stack_axes(dec_lib.block_axes(cfg))
        a["ln_f"] = norm_axes(cfg)
    if not cfg.tie_embeddings:
        a["head"] = ("vocab", "embed")
    return a


def cache_logical_axes(cfg: ModelConfig):
    if cfg.family == "encdec":
        return encdec_lib.encdec_cache_axes(cfg)
    return dec_lib.cache_axes(cfg)


def abstract_model(cfg: ModelConfig) -> ParamDict:
    """``init_model``'s params as meta tensors: every shape and dtype, no
    storage (the dry run and ``roofline.analysis.active_params``)."""
    return init_model(MetaGenerator(), cfg)


def head_weight(params, cfg: ModelConfig, specs=None):
    """The classification head W [V, D]; on a grid (``specs``) the
    member's [V / n_model, D] block, gathered over the batch axes where
    FSDP split it."""
    if cfg.family == "cnn":
        return params["head"]
    if not cfg.tie_embeddings:
        w, spec = params.head, specs and specs["head"]
    else:
        w, spec = params.embed.table, specs and specs["embed"]["table"]
    return w if spec is None else dist.gather_block(w, spec, dist.BATCH)


def _gathered(p, spec):
    return p if spec is None else dec_lib.gather_layer(p, spec)


def backbone(params, cfg: ModelConfig, inputs, *, want_cache: bool = False,
             cache_window: Optional[int] = None, backend: str = "ref",
             remat: str = "none", specs=None):
    """-> (hidden [B,S,D], aux scalar (the MoE router losses), caches or
    None). ``backend`` selects the attention's kernels
    (``layers.multihead_attention``). The encdec family's caches are its
    decoder's self-attention K/V over the S tokens and the cross K/V over
    the encoder's frames (``cache_window`` does not apply). ``remat``
    (``ParallelConfig.remat``): ``"full"`` checkpoints each layer of the
    decoder stacks and the encoder-decoder under grad (the cnn trunk
    takes none, as in the JAX package). ``specs``: the member's param
    specs on a grid (module docstring)."""
    require_ported(cfg, grid=specs is not None)
    if cfg.family == "cnn":
        feat = resnet_lib.apply_resnet(params["trunk"], cfg,
                                       inputs["images"].to(
                                           getattr(torch, cfg.dtype)))
        return feat, torch.zeros((), device=feat.device), None
    sp = specs or {}
    tokens = inputs["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = apply_embedding(_gathered(params.embed, sp.get("embed")), cfg,
                        tokens, sp.get("embed"))
    if cfg.family == "encdec":
        enc_out = encdec_lib.encode(
            params.encdec, cfg,
            inputs["frames"].to(getattr(torch, cfg.dtype)), backend=backend,
            remat=remat, specs=sp.get("encdec"))
        x, caches = encdec_lib.decode_train(params.encdec, cfg, x, enc_out,
                                            positions, want_cache,
                                            backend=backend, remat=remat,
                                            specs=sp.get("encdec"))
        return x, torch.zeros((), device=x.device), caches
    win = cache_window or (cfg.sliding_window or tokens.shape[1])
    x, aux, caches = dec_lib.apply_stack(
        params.blocks, cfg, x, positions, want_cache=want_cache,
        cache_window=win if want_cache else None, backend=backend,
        self_rows=True, remat=remat, specs=sp.get("blocks"))
    return (apply_norm(_gathered(params.ln_f, sp.get("ln_f")), x, cfg), aux,
            caches)


def decode(params, cfg: ModelConfig, inputs, caches, slots_state, *,
           window: int, backend: str = "ref", specs=None):
    """One-token decode. inputs: {"token": [B,1]}. The caches are updated
    in place. -> (hidden [B,1,D], caches, new slots_state)."""
    sp = specs or {}
    x = apply_embedding(_gathered(params.embed, sp.get("embed")), cfg,
                        inputs["token"], sp.get("embed"))
    if cfg.family == "encdec":
        return encdec_lib.decode_step(params.encdec, cfg, x, caches,
                                      slots_state, window=window,
                                      backend=backend,
                                      specs=sp.get("encdec"))
    x, caches, slots_state = dec_lib.decode_stack(
        params.blocks, cfg, x, caches, slots_state, window=window,
        backend=backend, specs=sp.get("blocks"))
    return (apply_norm(_gathered(params.ln_f, sp.get("ln_f")), x, cfg),
            caches, slots_state)


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
                      device, specs=None):
    """Fresh caches + slot bookkeeping for decoding at seq_len (``specs``:
    a grid member's, whose caches hold its KV heads and SSM blocks)."""
    window = decode_window(cfg, seq_len)
    sp = specs or {}
    if cfg.family == "encdec":
        caches = encdec_lib.init_encdec_decode_cache(
            cfg, batch, window, getattr(torch, cfg.dtype), device=device,
            specs=sp.get("encdec"))
    else:
        caches = dec_lib.init_decode_cache(cfg, batch, window,
                                           getattr(torch, cfg.dtype),
                                           device=device,
                                           specs=sp.get("blocks"))
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
