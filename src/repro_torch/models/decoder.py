"""Decoder-layer stack of the dense (and vlm) family: the port of the JAX
package's ``models/decoder.py``.

The JAX package stacks the layers' params on a leading ``layers`` axis and
scans over them; here the layers are a list of ``ParamDict``s and the
stack a Python loop. The caches keep the JAX layout, stacked over layers:

  {"k": [L,B,W,Hk,Dh], "v": [L,B,W,Hk,Dh]}   (W = rotating window slots)

plus the slot bookkeeping shared by all layers: {"pos": int32 scalar,
"pos_slots": [W] int32}. Decode writes the new token's K/V into the cache
IN PLACE (the JAX package returns a new cache): a step then moves one
token's K/V, not the whole cache. The moe, ssm and hybrid families wait
for their slice (ROADMAP.md A.9).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (ParamDict, apply_attention, apply_mlp,
                                       apply_norm, init_attention, init_mlp,
                                       init_norm, project_kv)

PORTED_FAMILIES = ("dense", "vlm")


def require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported to torch yet (ported: "
            f"{list(PORTED_FAMILIES)}; see ROADMAP.md A.9)")


# ---------------------------------------------------------------------------
# per-layer init
# ---------------------------------------------------------------------------


def init_block(gen: torch.Generator, cfg: ModelConfig) -> ParamDict:
    require_ported(cfg)
    return ParamDict(ln1=init_norm(cfg, device=gen.device),
                     attn=init_attention(gen, cfg),
                     ln2=init_norm(cfg, device=gen.device),
                     mlp=init_mlp(gen, cfg))


def init_blocks(gen: torch.Generator, cfg: ModelConfig) -> list:
    return [init_block(gen, cfg) for _ in range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# prefill forward
# ---------------------------------------------------------------------------


def _mixer_forward(p, cfg: ModelConfig, x, positions, backend: str = "ref",
                   self_rows: bool = False):
    """Sequence-mixing sublayer. Returns (mix_out, cache_out_dict)."""
    h = apply_norm(p.ln1, x, cfg)
    attn_out, (k, v) = apply_attention(
        p.attn, cfg, h, positions=positions, causal=True,
        window=cfg.sliding_window, backend=backend, self_rows=self_rows)
    return attn_out, {"k": k, "v": v}


def _block_forward(p, cfg: ModelConfig, x, positions, backend: str = "ref",
                   self_rows: bool = False):
    """Full block. Returns (x, cache). (The JAX package's third output,
    the MoE router's auxiliary loss, is 0 for the dense family.)"""
    mix, cache = _mixer_forward(p, cfg, x, positions, backend, self_rows)
    x = x + mix
    x = x + apply_mlp(p.mlp, cfg, apply_norm(p.ln2, x, cfg))
    return x, cache


def apply_stack(blocks, cfg: ModelConfig, x, positions, *,
                want_cache: bool = False, cache_window: Optional[int] = None,
                backend: str = "ref", self_rows: bool = False):
    """Run the layer stack. Returns (x, aux (0: no MoE), caches or None).

    ``caches`` leaves are stacked [L, ...]; attention K/V are
    slot-compressed to ``cache_window`` rotating slots when given.
    ``self_rows``: ``positions`` is arange(S), which the ``kernel``
    backend's attention needs (``layers.multihead_attention``)."""
    require_ported(cfg)
    ks, vs = [], []
    for p in blocks:
        x, cache = _block_forward(p, cfg, x, positions, backend, self_rows)
        if want_cache:
            k, v = cache["k"], cache["v"]
            if cache_window is not None:
                k, v = _compress_kv(k, v, positions, cache_window)
            ks.append(k)
            vs.append(v)
    caches = ({"k": torch.stack(ks), "v": torch.stack(vs)} if want_cache
              else None)
    return x, torch.zeros((), device=x.device), caches


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


def _block_decode(p, cfg: ModelConfig, x, layer_cache, pos, pos_slots, slot,
                  backend: str = "ref"):
    """x: [B,1,D]. Writes the token's K/V into ``layer_cache`` at ``slot``
    in place. Returns (x, layer_cache)."""
    h = apply_norm(p.ln1, x, cfg)
    positions = pos[None]
    k_new, v_new = project_kv(p.attn, cfg, h, positions)
    idx = slot.reshape(1).long()
    kc = layer_cache["k"].index_copy_(1, idx, k_new)
    vc = layer_cache["v"].index_copy_(1, idx, v_new)
    new_slots = pos_slots.index_copy(0, idx, pos.reshape(1))
    attn_out, _ = apply_attention(
        p.attn, cfg, h, positions=positions, kv=(kc, vc),
        kv_positions=new_slots, causal=True, window=cfg.sliding_window,
        backend=backend)
    x = x + attn_out
    x = x + apply_mlp(p.mlp, cfg, apply_norm(p.ln2, x, cfg))
    return x, layer_cache


def decode_stack(blocks, cfg: ModelConfig, x, caches, slots_state, *,
                 window: int, backend: str = "ref"):
    """One decode step through all layers.

    caches: the stacked {"k", "v"} (updated in place); slots_state:
    {"pos", "pos_slots"}. Returns (x, caches, new_slots_state)."""
    require_ported(cfg)
    pos = slots_state["pos"]
    pos_slots = slots_state["pos_slots"]
    slot = pos % window
    for i, p in enumerate(blocks):
        x, _ = _block_decode(p, cfg, x, {"k": caches["k"][i],
                                         "v": caches["v"][i]},
                             pos, pos_slots, slot, backend)
    new_state = {"pos": pos + 1,
                 "pos_slots": pos_slots.index_copy(
                     0, slot.reshape(1).long(), pos.reshape(1))}
    return x, caches, new_state


def init_decode_cache(cfg: ModelConfig, batch: int, window: int, dtype, *,
                      device):
    """Fresh (empty) stacked cache."""
    require_ported(cfg)
    shape = (cfg.n_layers, batch, window, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
