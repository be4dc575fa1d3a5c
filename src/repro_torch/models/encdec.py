"""Whisper-style encoder-decoder transformer backbone: the port of the JAX
package's ``models/encdec.py``.

The mel-spectrogram and conv frontend are stubbed, as in the JAX package:
the encoder takes precomputed frame embeddings [B, enc_seq, d_model]
(what the two conv layers would emit). Downstream of them: sinusoidal
encoder positions, the encoder's non-causal self-attention, the decoder's
causal self-attention and cross-attention over the encoder's output, and
learned decoder positions (4,096, tiled).

The layers are lists of ``ParamDict``s (``enc_blocks``, ``dec_blocks``)
where the JAX package stacks them on [L] and scans. Self-attention over a
sequence's rows (the encoder's, non-causal; the decoder's, causal) goes
through the ``kernel`` backend's flash attention; cross-attention and the
decode step over the caches take the ``ref`` branches. Decode writes the
token's self-attention K/V into the cache in place; the cross caches
[L, B, enc_seq, Hk, Dh] are built once from the encoder's output.
``remat="full"`` checkpoints each encoder layer, and each decoder layer
when no cache is wanted (``decoder.remat_wanted``), as the JAX package
wraps its scan bodies in ``jax.checkpoint``.

On a grid (``specs``: the member specs of ``init_encdec``'s tree,
``train.gspmd.member_specs``) the self- and cross-attentions are column-
then row-parallel over the heads the model axis divides (whisper-tiny's 6
heads, 3 a member on 2), the MLP over its hidden columns, the encoder's
self-attention through the flash kernel on the member's heads, and a
leaf FSDP split over ``data`` is gathered inside its layer
(``decoder.gather_layer``; the JAX package leaves the encdec out of its
per-layer sharder, which moves the gathers, not the numbers). The cross
caches hold the member's KV heads, as K and V do.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.decoder import (checkpointed, gather_layer,
                                        member_kv_heads, remat_wanted)
from repro_torch.models.layers import (ParamDict, _embed_init,
                                       apply_attention, apply_mlp,
                                       apply_norm, attention_axes,
                                       init_attention, init_mlp, init_norm,
                                       mlp_axes, norm_axes, project_kv,
                                       sinusoid_positions)

DEC_POS = 4096    # learned decoder positions, tiled beyond


def init_enc_block(gen: torch.Generator, cfg: ModelConfig) -> ParamDict:
    dev = gen.device
    return ParamDict(ln1=init_norm(cfg, device=dev),
                     attn=init_attention(gen, cfg),
                     ln2=init_norm(cfg, device=dev), mlp=init_mlp(gen, cfg))


def init_dec_block(gen: torch.Generator, cfg: ModelConfig) -> ParamDict:
    dev = gen.device
    return ParamDict(ln1=init_norm(cfg, device=dev),
                     self_attn=init_attention(gen, cfg),
                     ln2=init_norm(cfg, device=dev),
                     cross_attn=init_attention(gen, cfg),
                     ln3=init_norm(cfg, device=dev), mlp=init_mlp(gen, cfg))


def enc_block_axes(cfg: ModelConfig):
    return {"ln1": norm_axes(cfg), "attn": attention_axes(cfg),
            "ln2": norm_axes(cfg), "mlp": mlp_axes(cfg)}


def dec_block_axes(cfg: ModelConfig):
    return {"ln1": norm_axes(cfg), "self_attn": attention_axes(cfg),
            "ln2": norm_axes(cfg), "cross_attn": attention_axes(cfg),
            "ln3": norm_axes(cfg), "mlp": mlp_axes(cfg)}


def _stack_axes(ax):
    """Logical axes of a layer list stacked on [L] (``lm.params_tree``)."""
    if isinstance(ax, dict):
        return {k: _stack_axes(v) for k, v in ax.items()}
    return ("layers",) + ax


def encdec_axes(cfg: ModelConfig):
    """Logical axes of ``init_encdec``'s params, layer lists stacked."""
    return {
        "enc_blocks": _stack_axes(enc_block_axes(cfg)),
        "enc_ln": norm_axes(cfg),
        "dec_blocks": _stack_axes(dec_block_axes(cfg)),
        "dec_ln": norm_axes(cfg),
        "dec_pos": (None, "embed"),
    }


def encdec_cache_axes(cfg: ModelConfig):
    ax = ("layers", "batch", "seq", "kv_heads", "head_dim")
    return {"k": ax, "v": ax, "cross_k": ax, "cross_v": ax}


def init_encdec(gen: torch.Generator, cfg: ModelConfig) -> ParamDict:
    dev = gen.device
    return ParamDict(
        enc_blocks=[init_enc_block(gen, cfg)
                    for _ in range(cfg.n_enc_layers)],
        enc_ln=init_norm(cfg, device=dev),
        dec_blocks=[init_dec_block(gen, cfg) for _ in range(cfg.n_layers)],
        dec_ln=init_norm(cfg, device=dev),
        dec_pos=_embed_init(gen, (DEC_POS, cfg.d_model)))


def _sp(specs, key, i=None):
    """The specs of ``key`` (layer ``i`` of a layer list) or None."""
    if specs is None:
        return None
    return specs[key] if i is None else specs[key][i]


def _enc_block(lp, cfg: ModelConfig, x, positions, backend: str,
               spec=None):
    lp = gather_layer(lp, spec)
    h = apply_norm(lp.ln1, x, cfg)
    a, _ = apply_attention(lp.attn, cfg, h, positions=positions,
                           causal=False, backend=backend, self_rows=True,
                           spec=_sp(spec, "attn"))
    x = x + a
    return x + apply_mlp(lp.mlp, cfg, apply_norm(lp.ln2, x, cfg),
                         _sp(spec, "mlp"))


def encode(p, cfg: ModelConfig, frames, *, backend: str = "ref",
           remat: str = "none", specs=None):
    """frames: [B, enc_seq, D] stubbed conv features -> encoder output."""
    dt = frames.dtype
    s = frames.shape[1]
    x = frames + sinusoid_positions(s, cfg.d_model,
                                    device=frames.device).to(dt)
    positions = torch.arange(s, device=frames.device)
    remat = remat_wanted(remat, False)
    for i, lp in enumerate(p.enc_blocks):
        spec = _sp(specs, "enc_blocks", i)
        if remat:
            x = checkpointed(
                lambda xc, lp=lp, spec=spec: _enc_block(
                    lp, cfg, xc, positions, backend, spec), x)
        else:
            x = _enc_block(lp, cfg, x, positions, backend, spec)
    return apply_norm(gather_layer(p.enc_ln, _sp(specs, "enc_ln")), x, cfg)


def _dec_positions_embed(p, positions, dt, specs=None):
    table = gather_layer(p.dec_pos, _sp(specs, "dec_pos"))
    idx = (positions % table.shape[0]).long()
    return table[idx].to(dt)


def _dec_block(lp, cfg: ModelConfig, x, enc_out, positions, enc_pos,
               backend: str, spec=None):
    """One decoder layer: (x, (k, v)) of its self-attention."""
    lp = gather_layer(lp, spec)
    h = apply_norm(lp.ln1, x, cfg)
    a, (k, v) = apply_attention(lp.self_attn, cfg, h, positions=positions,
                                causal=True, backend=backend, self_rows=True,
                                spec=_sp(spec, "self_attn"))
    x = x + a
    h = apply_norm(lp.ln2, x, cfg)
    c, _ = apply_attention(lp.cross_attn, cfg, h, positions=positions,
                           kv={"x": enc_out}, kv_positions=enc_pos,
                           causal=False, backend=backend,
                           spec=_sp(spec, "cross_attn"))
    x = x + c
    return x + apply_mlp(lp.mlp, cfg, apply_norm(lp.ln3, x, cfg),
                         _sp(spec, "mlp")), (k, v)


def decode_train(p, cfg: ModelConfig, tokens_emb, enc_out, positions,
                 want_cache: bool = False, *, backend: str = "ref",
                 remat: str = "none", specs=None):
    """Teacher-forced decoder forward. tokens_emb: [B,S,D] (embedded),
    ``positions`` arange(S). Returns (hidden [B,S,D], caches or None):
    caches {"k", "v", "cross_k", "cross_v"} stacked [L, ...]."""
    dt = tokens_emb.dtype
    x = tokens_emb + _dec_positions_embed(p, positions, dt, specs)[None]
    enc_pos = torch.arange(enc_out.shape[1], device=enc_out.device)
    layers = []
    remat = remat_wanted(remat, want_cache)
    for i, lp in enumerate(p.dec_blocks):
        spec = _sp(specs, "dec_blocks", i)
        if remat:
            x = checkpointed(
                lambda xc, eo, lp=lp, spec=spec: _dec_block(
                    lp, cfg, xc, eo, positions, enc_pos, backend, spec)[0],
                x, enc_out)
            continue
        x, (k, v) = _dec_block(lp, cfg, x, enc_out, positions, enc_pos,
                               backend, spec)
        if want_cache:
            ck, cv = project_kv(gather_layer(lp.cross_attn,
                                             _sp(spec, "cross_attn")),
                                cfg, enc_out, enc_pos,
                                _sp(spec, "cross_attn"))
            layers.append({"k": k, "v": v, "cross_k": ck, "cross_v": cv})
    caches = ({n: torch.stack([c[n] for c in layers]) for n in layers[0]}
              if want_cache else None)
    return (apply_norm(gather_layer(p.dec_ln, _sp(specs, "dec_ln")), x, cfg),
            caches)


def build_cross_cache(p, cfg: ModelConfig, enc_out, specs=None):
    """Per-layer cross-attention K/V of the encoder's output: (ck, cv)
    [L, B, T_enc, Hk, Dh] (the member's KV heads on a grid)."""
    enc_pos = torch.arange(enc_out.shape[1], device=enc_out.device)
    kv = []
    for i, lp in enumerate(p.dec_blocks):
        spec = _sp(_sp(specs, "dec_blocks", i), "cross_attn")
        kv.append(project_kv(gather_layer(lp.cross_attn, spec), cfg,
                             enc_out, enc_pos, spec))
    return (torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv]))


def decode_step(p, cfg: ModelConfig, x, caches, slots_state, *, window: int,
                backend: str = "ref", specs=None):
    """One decoder token x [B,1,D] (embedded). caches: stacked {"k", "v",
    "cross_k", "cross_v"}, the self-attention K/V written at the token's
    slot in place. Returns (hidden [B,1,D], caches, new slots_state)."""
    pos = slots_state["pos"]
    pos_slots = slots_state["pos_slots"]
    slot = pos % window
    idx = slot.reshape(1).long()
    positions = pos[None]
    x = x + _dec_positions_embed(p, positions, x.dtype, specs)[None]
    enc_pos = torch.arange(caches["cross_k"].shape[2], device=x.device)
    new_slots = pos_slots.index_copy(0, idx, pos.reshape(1))
    for i, lp in enumerate(p.dec_blocks):
        spec = _sp(specs, "dec_blocks", i)
        lp = gather_layer(lp, spec)
        h = apply_norm(lp.ln1, x, cfg)
        k_new, v_new = project_kv(lp.self_attn, cfg, h, positions,
                                  _sp(spec, "self_attn"))
        kc = caches["k"][i].index_copy_(1, idx, k_new)
        vc = caches["v"][i].index_copy_(1, idx, v_new)
        a, _ = apply_attention(lp.self_attn, cfg, h, positions=positions,
                               kv=(kc, vc), kv_positions=new_slots,
                               causal=True, backend=backend,
                               spec=_sp(spec, "self_attn"))
        x = x + a
        h = apply_norm(lp.ln2, x, cfg)
        c, _ = apply_attention(lp.cross_attn, cfg, h, positions=positions,
                               kv=(caches["cross_k"][i], caches["cross_v"][i]),
                               kv_positions=enc_pos, causal=False,
                               backend=backend, spec=_sp(spec, "cross_attn"))
        x = x + c
        x = x + apply_mlp(lp.mlp, cfg, apply_norm(lp.ln3, x, cfg),
                          _sp(spec, "mlp"))
    x = apply_norm(gather_layer(p.dec_ln, _sp(specs, "dec_ln")), x, cfg)
    return x, caches, {"pos": pos + 1, "pos_slots": new_slots}


def init_encdec_decode_cache(cfg: ModelConfig, batch: int, window: int,
                             dtype, *, device, specs=None) -> dict:
    """Fresh (empty) stacked caches: self-attention K/V over ``window``
    slots, cross K/V over the encoder's ``enc_seq`` frames; on a grid
    (``specs``) the member's KV heads of each."""
    spec = _sp(specs, "dec_blocks", 0)
    dh, n = cfg.resolved_head_dim, cfg.n_layers

    def zeros(t, attn):
        hk = member_kv_heads(cfg, _sp(spec, attn))
        return torch.zeros((n, batch, t, hk, dh), dtype=dtype, device=device)

    return {"k": zeros(window, "self_attn"), "v": zeros(window, "self_attn"),
            "cross_k": zeros(cfg.enc_seq, "cross_attn"),
            "cross_v": zeros(cfg.enc_seq, "cross_attn")}
