"""Token-choice top-k MoE with capacity-based sort dispatch: the port of the
JAX package's ``models/moe.py``.

Each batch row is its own dispatch group (a decode step's tokens form one
global group): the group's (token, expert) pairs are sorted by expert,
stably, so that an expert keeps its first ``cap`` tokens in token order
and drops the rest, exactly as ``jnp.argsort(stable=True)`` does. The
experts' buffer [B, E, cap, D] is then one batched product per expert
matrix. Includes the Switch load-balance auxiliary loss and the optional
shared (always-active) experts of Kimi-K2 / DeepSeek.

Where the JAX package scatters (``buf.at[dest].set(mode="drop")``, the
combine's ``.at[src_token].add``), the port gathers through the sort's
permutation and its inverse, so that every index a gather's backward adds
into is unique and every sum runs in a fixed order: two runs on a card
are bit-equal (``index_add_`` on CUDA sums in no fixed order).

- dispatch: the buffer's slot (e, c) reads the c-th of expert e's sorted
  entries when the expert has more than c of them, else zero;
- combine: each sorted entry reads its slot (a dropped one a zero row
  appended to the experts' output), weighted by its router probability in
  fp32; the inverse permutation takes the entries back to token order and
  each token sums its k in expert-rank order.

On a grid the experts are split over the model axis (``moe_axes``,
``train.gspmd.param_pspecs``): a member holds E / n_model of them, as
its ``spec`` says. The router runs on the replicated tokens, as the dispatch's
sort and capacity do, so the dropped pairs are the JAX dispatch's (each
batch row's); a member fills and runs only its experts' slots, combines
their contributions in fp32 and the sum goes over the model axis (only
the combine's order of summation differs from one member's). The Switch
loss's ``fe`` and ``me`` are means over the GLOBAL batch, as in JAX: over
the batch axes on a grid.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import dist
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import topk_stable
from repro_torch.models.layers import ParamDict, _dense_init, model_split


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> ParamDict:
    m = cfg.moe
    p = {
        "router": _dense_init(gen, (cfg.d_model, m.n_experts), in_axis=0),
        "wi_gate": _dense_init(gen, (m.n_experts, cfg.d_model, m.d_ff),
                               in_axis=1),
        "wi_up": _dense_init(gen, (m.n_experts, cfg.d_model, m.d_ff),
                             in_axis=1),
        "wo": _dense_init(gen, (m.n_experts, m.d_ff, cfg.d_model), in_axis=1),
    }
    if m.n_shared_experts > 0:
        d_sh = m.d_ff * m.n_shared_experts
        p["shared"] = {
            "wi_gate": _dense_init(gen, (cfg.d_model, d_sh), in_axis=0),
            "wi_up": _dense_init(gen, (cfg.d_model, d_sh), in_axis=0),
            "wo": _dense_init(gen, (d_sh, cfg.d_model), in_axis=0),
        }
    return ParamDict(**p)


def moe_axes(cfg: ModelConfig):
    """Logical axes of ``init_moe``'s params: the experts over
    ``"experts"``, the shared experts' hidden dim over ``"mlp"``."""
    a = {
        "router": ("embed", None),
        "wi_gate": ("experts", "embed", "expert_mlp"),
        "wi_up": ("experts", "embed", "expert_mlp"),
        "wo": ("experts", "expert_mlp", "embed"),
    }
    if cfg.moe.n_shared_experts > 0:
        a["shared"] = {"wi_gate": ("embed", "mlp"), "wi_up": ("embed", "mlp"),
                       "wo": ("mlp", "embed")}
    return a


def capacity_for(n_tokens: int, cfg: ModelConfig,
                 capacity_factor: Optional[float] = None) -> int:
    m = cfg.moe
    cf = capacity_factor if capacity_factor is not None else m.capacity_factor
    c = int(n_tokens * m.top_k * cf / m.n_experts) + 1
    return max(8, -(-c // 8) * 8)  # round up to 8


def _dispatch_group(xg, top_i, cap: int, n_experts: int, k: int,
                    e0: int = 0, e_loc: Optional[int] = None):
    """Sort-based dispatch of groups. xg [G, t, d], top_i [G, t, k] ->
    (buf [G, e_loc, cap, d] for experts [e0, e0 + e_loc) (all E by
    default), meta) with meta = (dest [G, t*k]: each sorted entry's slot
    (e - e0) * cap + rank, e_loc * cap where it is dropped or another
    member's; keep; order [G, t*k]: the stable sort's permutation)."""
    g, t, d = xg.shape
    e_loc = n_experts if e_loc is None else e_loc
    flat_e = top_i.reshape(g, t * k).long()
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = flat_e.gather(1, order)
    experts = torch.arange(n_experts, device=xg.device).expand(g, -1)
    starts = torch.searchsorted(sorted_e, experts.contiguous(), side="left")
    ends = torch.searchsorted(sorted_e, experts.contiguous(), side="right")
    rank = (torch.arange(t * k, device=xg.device)[None]
            - starts.gather(1, sorted_e))
    keep = rank < cap
    mine = keep & (sorted_e >= e0) & (sorted_e < e0 + e_loc)
    dest = torch.where(mine, (sorted_e - e0) * cap + rank, e_loc * cap)
    starts, ends = starts[:, e0:e0 + e_loc], ends[:, e0:e0 + e_loc]
    # each token's row k times (an expand: its backward sums the k), then
    # in the sorted order (a permutation: its backward adds each row into
    # one place), and a zero row last, which the empty slots read
    xs = xg[:, :, None, :].expand(g, t, k, d).reshape(g, t * k, d).gather(
        1, order[..., None].expand(-1, -1, d))
    xs = torch.cat([xs, xs.new_zeros((g, 1, d))], dim=1)
    slot = starts[..., None] + torch.arange(cap, device=xg.device)  # [G,E,cap]
    pos = torch.where(slot < ends[..., None], slot, t * k)
    buf = xs.gather(1, pos.reshape(g, -1, 1).expand(-1, -1, d))
    return buf.reshape(g, e_loc, cap, d), (dest, keep, order)


def _combine_group(eo, meta, top_p, t: int, k: int):
    """eo [G, E, cap, d] -> out [G, t, d] fp32: each token's k expert rows
    weighted by their router probabilities."""
    dest, keep, order = meta
    g, d = eo.shape[0], eo.shape[-1]
    eo_flat = torch.cat([eo.reshape(g, -1, d),
                         eo.new_zeros((g, 1, d))], dim=1)    # the drop row
    back = eo_flat.gather(1, dest[..., None].expand(-1, -1, d))
    w = top_p.reshape(g, t * k).gather(1, order)
    back = back.float() * w[..., None]
    inv = torch.argsort(order, dim=1)
    back = back.gather(1, inv[..., None].expand(-1, -1, d))   # token order
    return back.reshape(g, t, k, d).sum(dim=2)


def _gated(x, wi_gate, wi_up, wo, cfg: ModelConfig, eq_in: str, eq_out: str):
    g = torch.einsum(eq_in, x, wi_gate)
    u = torch.einsum(eq_in, x, wi_up)
    act = (F.silu(g) if cfg.activation == "swiglu"
           else F.gelu(g, approximate="tanh"))
    return torch.einsum(eq_out, act * u, wo)


def _shared(p, cfg: ModelConfig, x, spec=None):
    """The shared experts: a gated MLP of hidden dim d_ff * n_shared, its
    columns split over the model axis where ``spec`` (the MoE's) splits
    them."""
    dt = x.dtype
    sp = p.shared
    split = spec is not None and model_split(spec["shared"], "wo")
    if split:
        x = dist.pvary(x)
    g = x @ sp.wi_gate.to(dt)
    u = x @ sp.wi_up.to(dt)
    act = (F.silu(g) if cfg.activation == "swiglu"
           else F.gelu(g, approximate="tanh"))
    out = (act * u) @ sp.wo.to(dt)
    return dist.psum_invariant(out) if split else out


def routing(p, cfg: ModelConfig, x):
    """The router of x [B, S, D]: (probs [B, S, E] fp32, top_p [B, S, k]
    renormalised, top_i [B, S, k] int32; ties to the lowest expert, as
    ``lax.top_k``), and the Switch auxiliary loss, whose gradient goes
    through the mean probabilities only (the counts are integers)."""
    m = cfg.moe
    b, s, _ = x.shape
    logits = (x @ p.router.to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = topk_stable(probs, m.top_k)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    # the means over the global batch: over the batch axes on a grid
    me = dist.pmean(probs.mean(dim=(0, 1)), dist.BATCH)
    # integer counts by scatter-add (exact in any order; unlike bincount
    # it has a meta kernel, so the dry run can route shapes)
    idx = top_i.reshape(-1).long()
    counts = torch.zeros(m.n_experts, dtype=torch.long,
                         device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx)).float()
    counts = dist.psum(counts, dist.BATCH).detach()
    fe = counts / (b * s * m.top_k * dist.world_size(dist.BATCH))
    aux = m.n_experts * (fe * me).sum() * m.router_aux_coef
    return probs, top_p, top_i, aux


def apply_moe(p, cfg: ModelConfig, x, *,
              capacity_factor: Optional[float] = None, spec=None):
    """x: [B, S, D] -> (out [B, S, D], aux loss scalar fp32).

    Each batch row is a dispatch group; a decode step (S == 1, B > 1) is
    ONE group of B tokens, or every token would pay E x cap slots.
    ``spec``: the member's specs of ``p`` on a grid (None off one)."""
    m = cfg.moe
    b, s, d = x.shape
    if s == 1 and b > 1:
        out, aux = apply_moe(p, cfg, x.reshape(1, b, d),
                             capacity_factor=capacity_factor, spec=spec)
        return out.reshape(b, s, d), aux
    k, dt = m.top_k, x.dtype
    _, top_p, top_i, aux = routing(p, cfg, x)
    cap = capacity_for(s, cfg, capacity_factor)
    e_loc = p.wi_gate.shape[0]
    split = model_split(spec, "wi_gate")
    e0 = dist.rank() * e_loc if split else 0
    # on a grid the experts' branch is the member's: the tokens' and the
    # router weights' cotangents sum over the model axis
    xe, pe = (dist.pvary(x), dist.pvary(top_p)) if split else (x, top_p)
    buf, meta = _dispatch_group(xe, top_i, cap, m.n_experts, k, e0, e_loc)
    eo = _gated(buf, p.wi_gate.to(dt), p.wi_up.to(dt), p.wo.to(dt), cfg,
                "becd,edf->becf", "becf,efd->becd")
    out = _combine_group(eo, meta, pe, s, k)
    out = (dist.psum_invariant(out) if split else out).to(dt)
    if m.n_shared_experts > 0:
        out = out + _shared(p, cfg, x, spec)
    return out, aux


def moe_ref_dense(p, cfg: ModelConfig, x):
    """Oracle: every token through its top-k experts via dense masking, in
    fp32, with no capacity. O(T * E): test scale only."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d).float()
    probs = torch.softmax(xf @ p.router.float(), dim=-1)
    top_p, top_i = topk_stable(probs, m.top_k)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    gate = torch.zeros((t, m.n_experts), device=x.device)
    gate = gate.scatter(1, top_i.long(), top_p)
    eo = _gated(xf, p.wi_gate.float(), p.wi_up.float(), p.wo.float(), cfg,
                "td,edf->tef", "tef,efd->ted")
    out = torch.einsum("ted,te->td", eo, gate)
    if m.n_shared_experts > 0:
        out = out + _shared(p, cfg, xf)
    return out.reshape(b, s, d).to(x.dtype)
