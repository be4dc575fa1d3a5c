"""Decoder-layer stack of the dense, vlm, moe, ssm and hybrid families: the
port of the JAX package's ``models/decoder.py``.

The JAX package stacks the layers' params on a leading ``layers`` axis and
scans over them; here the layers are a list of ``ParamDict``s and the
stack a Python loop. The caches keep the JAX layout, stacked over layers:

  attn: {"k": [L,B,W,Hk,Dh], "v": [L,B,W,Hk,Dh]}   (W = rotating window slots)
  ssm:  {"ssm_state": [L,B,H,N,P] fp32, "conv_state": [L,B,K-1,Dxbc]}

(the ssm family has no K/V; the hybrid family has both) plus the slot
bookkeeping shared by all layers: {"pos": int32 scalar, "pos_slots": [W]
int32}. Decode writes the new token's K/V, and the new ssm and conv
states, into the cache IN PLACE (the JAX package returns a new cache): a
step then moves one token's worth, not the whole cache. The hybrid block
runs attention and the SSM in parallel on the same normed input and fuses
``0.5 * (rms_norm(attn) * fuse_attn + rms_norm(ssm) * fuse_ssm)``; the ssm
block has no MLP sublayer; the moe block's feed-forward is the
token-choice MoE (``models/moe.py``), whose router losses the stack sums.
The encoder-decoder family is ``models/encdec.py``.

On a grid the layers' params are the member's slices
(``train.gspmd.member_specs``): the tensor-parallel layers read them as
they are (``models.layers``, ``models.moe``, ``models.ssm``; the hybrid
block's attention and SSM mixer each in its own layout, side by side on
the same input), and a leaf FSDP split over
``data`` is all-gathered over it inside the layer's body (``gather_layer``,
the JAX ``make_layer_param_sharder``'s per-layer gather), so under remat
inside its checkpoint too; the gather's backward is the reduce-scatter.
The caches then hold the member's KV heads and its blocks of the SSM
state and conv tail.

``remat="full"`` (``ParallelConfig.remat``) runs each layer under
``torch.utils.checkpoint`` where the JAX package wraps the scan body in
``jax.checkpoint``: the layer keeps only its input for the backward and
runs again there, with the same ops, so values and gradients are
bit-equal to ``remat="none"``. A checkpointed layer returns its output
and, for the moe family, its router loss, and writes no cache: remat
applies where a gradient is taken and no cache is wanted.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import dist
from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (ParamDict, apply_attention, apply_mlp,
                                       apply_norm, attention_axes,
                                       init_attention, init_mlp, init_norm,
                                       mlp_axes, model_split, norm_axes,
                                       project_kv, rms_norm)

PORTED_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid")
SSM_CACHE = ("ssm_state", "conv_state")


def require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family has no decoder stack (decoder "
            f"stacks: {list(PORTED_FAMILIES)}; the encoder-decoder family is "
            f"models/encdec.py)")


# ---------------------------------------------------------------------------
# per-layer init
# ---------------------------------------------------------------------------


def init_block(gen: torch.Generator, cfg: ModelConfig) -> ParamDict:
    require_ported(cfg)
    dev = gen.device
    if cfg.family == "ssm":
        return ParamDict(ln1=init_norm(cfg, device=dev),
                         ssm=ssm_lib.init_ssm(gen, cfg))
    p = {"ln1": init_norm(cfg, device=dev), "attn": init_attention(gen, cfg),
         "ln2": init_norm(cfg, device=dev)}
    if cfg.family == "hybrid":
        p["ssm"] = ssm_lib.init_ssm(gen, cfg)
        p["fuse_attn"] = torch.ones(cfg.d_model, device=dev)
        p["fuse_ssm"] = torch.ones(cfg.d_model, device=dev)
    if cfg.family == "moe":
        p["moe"] = moe_lib.init_moe(gen, cfg)
    else:
        p["mlp"] = init_mlp(gen, cfg)
    return ParamDict(**p)


def block_axes(cfg: ModelConfig):
    """Logical axes of one layer's params (``init_block``'s tree)."""
    fam = cfg.family
    if fam == "ssm":
        return {"ln1": norm_axes(cfg), "ssm": ssm_lib.ssm_axes(cfg)}
    a = {"ln1": norm_axes(cfg), "attn": attention_axes(cfg),
         "ln2": norm_axes(cfg)}
    if fam == "hybrid":
        a["ssm"] = ssm_lib.ssm_axes(cfg)
        a["fuse_attn"] = ("embed",)
        a["fuse_ssm"] = ("embed",)
        a["mlp"] = mlp_axes(cfg)
    elif fam == "moe":
        a["moe"] = moe_lib.moe_axes(cfg)
    else:
        a["mlp"] = mlp_axes(cfg)
    return a


def cache_axes(cfg: ModelConfig):
    """Logical axes of the stacked cache leaves (leading ``"layers"``)."""
    c = {}
    if cfg.family != "ssm":
        c["k"] = ("layers", "batch", "seq", "kv_heads", "head_dim")
        c["v"] = ("layers", "batch", "seq", "kv_heads", "head_dim")
    if cfg.family in ("ssm", "hybrid"):
        sa = ssm_lib.ssm_cache_axes(cfg)
        c["ssm_state"] = ("layers",) + sa["ssm_state"]
        c["conv_state"] = ("layers",) + sa["conv_state"]
    return c


def init_blocks(gen: torch.Generator, cfg: ModelConfig) -> list:
    return [init_block(gen, cfg) for _ in range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# prefill forward
# ---------------------------------------------------------------------------


def _fuse(p, attn_out, ssm_out, dtype):
    """The hybrid block's fusion of its two normed mixers."""
    return 0.5 * (rms_norm(attn_out) * p.fuse_attn.to(dtype)
                  + rms_norm(ssm_out) * p.fuse_ssm.to(dtype))


def _sub(spec, key):
    return None if spec is None else spec[key]


def _mixer_forward(p, cfg: ModelConfig, x, positions, backend: str = "ref",
                   self_rows: bool = False, spec=None):
    """Sequence-mixing sublayer (attn / ssm / parallel attn + ssm).
    Returns (mix_out, cache_out_dict)."""
    h = apply_norm(p.ln1, x, cfg)
    if cfg.family == "ssm":
        return ssm_lib.apply_ssm(p.ssm, cfg, h, spec=_sub(spec, "ssm"))
    attn_out, (k, v) = apply_attention(
        p.attn, cfg, h, positions=positions, causal=True,
        window=cfg.sliding_window, backend=backend, self_rows=self_rows,
        spec=_sub(spec, "attn"))
    cache = {"k": k, "v": v}
    if cfg.family == "hybrid":
        ssm_out, ssm_cache = ssm_lib.apply_ssm(p.ssm, cfg, h,
                                               spec=_sub(spec, "ssm"))
        cache.update(ssm_cache)
        return _fuse(p, attn_out, ssm_out, x.dtype), cache
    return attn_out, cache


def _feed_forward(p, cfg: ModelConfig, h, spec=None):
    """The MLP, or the moe family's MoE: (out, router aux loss or None)."""
    if cfg.family == "moe":
        return moe_lib.apply_moe(p.moe, cfg, h, spec=_sub(spec, "moe"))
    return apply_mlp(p.mlp, cfg, h, _sub(spec, "mlp")), None


def gather_layer(p, spec):
    """The layer's params with every leaf FSDP split over the batch axes
    all-gathered over them (``spec``: the layer's specs; None: the params
    as they are)."""
    if spec is None:
        return p

    def walk(node, sp):
        if isinstance(node, dict):
            return ParamDict(**{k: walk(v, sp[k]) for k, v in node.items()})
        return dist.gather_block(node, sp, dist.BATCH)
    return walk(p, spec)


def _block_forward(p, cfg: ModelConfig, x, positions, backend: str = "ref",
                   self_rows: bool = False, spec=None):
    """Full block. Returns (x, aux, cache): aux the MoE router's
    auxiliary loss, None for the other families. ``spec``: the layer's
    specs on a grid (``gather_layer``), by which its layers read what they
    hold."""
    p = gather_layer(p, spec)
    mix, cache = _mixer_forward(p, cfg, x, positions, backend, self_rows,
                                spec)
    x = x + mix
    if cfg.family == "ssm":
        return x, None, cache
    ff, aux = _feed_forward(p, cfg, apply_norm(p.ln2, x, cfg), spec)
    return x + ff, aux, cache


def remat_wanted(remat: str, want_cache: bool) -> bool:
    """Whether layers run checkpointed: ``remat="full"``, under grad, and
    no cache wanted."""
    if remat not in ("none", "full"):
        raise ValueError(f"remat must be 'none' or 'full', got {remat!r}")
    return remat == "full" and not want_cache and torch.is_grad_enabled()


def checkpointed(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant; the
    bodies draw no random numbers, so no RNG state is kept)."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _block_remat(p, cfg: ModelConfig, x, positions, backend, self_rows,
                 spec=None):
    """``_block_forward`` checkpointed: (x, aux, None)."""
    if cfg.family == "moe":
        def body(xc):
            xo, a, _ = _block_forward(p, cfg, xc, positions, backend,
                                      self_rows, spec)
            return xo, a
        x, a = checkpointed(body, x)
        return x, a, None
    return checkpointed(
        lambda xc: _block_forward(p, cfg, xc, positions, backend,
                                  self_rows, spec)[0], x), None, None


def apply_stack(blocks, cfg: ModelConfig, x, positions, *,
                want_cache: bool = False, cache_window: Optional[int] = None,
                backend: str = "ref", self_rows: bool = False,
                remat: str = "none", specs=None):
    """Run the layer stack. Returns (x, aux (the MoE router losses summed
    over the layers; 0 for the other families), caches or None).

    ``caches`` leaves are stacked [L, ...]; attention K/V are
    slot-compressed to ``cache_window`` rotating slots when given.
    ``self_rows``: ``positions`` is arange(S), which the ``kernel``
    backend's attention needs (``layers.multihead_attention``).
    ``remat``: ``"full"`` checkpoints each layer (``remat_wanted``).
    ``specs``: the layers' specs on a grid (``gather_layer``)."""
    require_ported(cfg)
    layers = []
    aux = torch.zeros((), device=x.device)
    block = (_block_remat if remat_wanted(remat, want_cache)
             else _block_forward)
    for i, p in enumerate(blocks):
        x, a, cache = block(p, cfg, x, positions, backend, self_rows,
                            None if specs is None else specs[i])
        if a is not None:
            aux = aux + a
        if want_cache:
            if cache_window is not None and "k" in cache:
                cache["k"], cache["v"] = _compress_kv(
                    cache["k"], cache["v"], positions, cache_window)
            layers.append(cache)
    caches = ({k: torch.stack([c[k] for c in layers]) for k in layers[0]}
              if want_cache else None)
    return x, aux, caches


def _compress_kv(k, v, positions, window: int):
    """Keep the last min(S, window) entries, placed at slot pos % window."""
    b, s, hk, dh = k.shape
    w = min(s, window)
    k_tail, v_tail = k[:, s - w:], v[:, s - w:]
    if w == window and s >= window:
        slots = (positions[s - w:] % window).long()
        kc = torch.zeros((b, window, hk, dh), dtype=k.dtype, device=k.device)
        vc = torch.zeros((b, window, hk, dh), dtype=v.dtype, device=v.device)
        kc[:, slots] = k_tail
        vc[:, slots] = v_tail
        return kc, vc
    pad = window - w
    return (torch.nn.functional.pad(k_tail, (0, 0, 0, 0, 0, pad)),
            torch.nn.functional.pad(v_tail, (0, 0, 0, 0, 0, pad)))


def init_cache_slots(cfg: ModelConfig, window: int, prefill_positions=None,
                     *, device=None):
    """pos / pos_slots bookkeeping shared by all layers."""
    if prefill_positions is None:
        return {"pos": torch.zeros((), dtype=torch.int32, device=device),
                "pos_slots": torch.full((window,), -1, dtype=torch.int32,
                                        device=device)}
    s = prefill_positions.shape[0]
    w = min(s, window)
    tail = prefill_positions[s - w:]
    slots = torch.full((window,), -1, dtype=torch.int32,
                       device=prefill_positions.device)
    slots[(tail % window).long()] = tail.to(torch.int32)
    return {"pos": prefill_positions[-1].to(torch.int32) + 1,
            "pos_slots": slots}


# ---------------------------------------------------------------------------
# decode (one token)
# ---------------------------------------------------------------------------


def _ssm_decode(p, cfg: ModelConfig, h, layer_cache, spec=None):
    """The SSM's decode step; its new states are written into
    ``layer_cache``'s leaves in place."""
    out, sc = ssm_lib.apply_ssm_step(p.ssm, cfg, h, layer_cache,
                                     spec=_sub(spec, "ssm"))
    for name in SSM_CACHE:
        layer_cache[name].copy_(sc[name])
    return out


def _block_decode(p, cfg: ModelConfig, x, layer_cache, pos, pos_slots, slot,
                  backend: str = "ref", spec=None):
    """x: [B,1,D]. Writes the token's K/V into ``layer_cache`` at ``slot``,
    and the new ssm and conv states, in place. Returns (x, layer_cache)."""
    p = gather_layer(p, spec)
    h = apply_norm(p.ln1, x, cfg)
    if cfg.family == "ssm":
        return x + _ssm_decode(p, cfg, h, layer_cache, spec), layer_cache
    positions = pos[None]
    k_new, v_new = project_kv(p.attn, cfg, h, positions, _sub(spec, "attn"))
    idx = slot.reshape(1).long()
    kc = layer_cache["k"].index_copy_(1, idx, k_new)
    vc = layer_cache["v"].index_copy_(1, idx, v_new)
    new_slots = pos_slots.index_copy(0, idx, pos.reshape(1))
    attn_out, _ = apply_attention(
        p.attn, cfg, h, positions=positions, kv=(kc, vc),
        kv_positions=new_slots, causal=True, window=cfg.sliding_window,
        backend=backend, spec=_sub(spec, "attn"))
    if cfg.family == "hybrid":
        attn_out = _fuse(p, attn_out,
                         _ssm_decode(p, cfg, h, layer_cache, spec), x.dtype)
    x = x + attn_out
    return (x + _feed_forward(p, cfg, apply_norm(p.ln2, x, cfg), spec)[0],
            layer_cache)


def decode_stack(blocks, cfg: ModelConfig, x, caches, slots_state, *,
                 window: int, backend: str = "ref", specs=None):
    """One decode step through all layers.

    caches: the stacked cache leaves (updated in place); slots_state:
    {"pos", "pos_slots"}. Returns (x, caches, new_slots_state)."""
    require_ported(cfg)
    pos = slots_state["pos"]
    pos_slots = slots_state["pos_slots"]
    slot = pos % window
    for i, p in enumerate(blocks):
        x, _ = _block_decode(p, cfg, x, {k: c[i] for k, c in caches.items()},
                             pos, pos_slots, slot, backend,
                             None if specs is None else specs[i])
    new_state = {"pos": pos + 1,
                 "pos_slots": pos_slots.index_copy(
                     0, slot.reshape(1).long(), pos.reshape(1))}
    return x, caches, new_state


def member_kv_heads(cfg: ModelConfig, attn_spec) -> int:
    """The KV heads a member's cache holds: its block where ``attn_spec``
    (a layer's attention specs on a grid; None off one) splits ``wk``
    over the model axis, else all of them."""
    n = cfg.n_kv_heads
    return n // dist.world_size() if model_split(attn_spec, "wk") else n


def init_decode_cache(cfg: ModelConfig, batch: int, window: int, dtype, *,
                      device, specs=None):
    """Fresh (empty) stacked cache; on a grid (``specs``: the layers'
    member specs) the member's KV heads and its blocks of the SSM caches
    (``ssm.init_ssm_cache``)."""
    require_ported(cfg)
    c = {}
    spec = None if specs is None else specs[0]
    if cfg.family != "ssm":
        shape = (cfg.n_layers, batch, window,
                 member_kv_heads(cfg, _sub(spec, "attn")),
                 cfg.resolved_head_dim)
        c["k"] = torch.zeros(shape, dtype=dtype, device=device)
        c["v"] = torch.zeros(shape, dtype=dtype, device=device)
    if cfg.family in ("ssm", "hybrid"):
        layer = ssm_lib.init_ssm_cache(cfg, batch, dtype, device=device,
                                       spec=_sub(spec, "ssm"))
        c.update({k: a[None].repeat((cfg.n_layers,) + (1,) * a.dim())
                  for k, a in layer.items()})
    return c
