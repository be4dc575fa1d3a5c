"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) mixer: the port of
the JAX package's ``models/ssm.py``.

Training and prefill run the chunked SSD algorithm: intra-chunk
attention-like products and an inter-chunk state recurrence, a Python loop
over chunks where the JAX package scans, with the state in fp32. Decode is
the O(1) recurrent step over a carried (conv, ssm) cache.

The dtype discipline is the JAX package's, line for line: dt's softplus,
the SSD sums and the state run in fp32, ``y`` is cast to the compute dtype
before the gate, and the gated norm runs in fp32 at ``cfg.norm_eps``.
softplus is ``logaddexp(x, 0)``, as ``jax.nn.softplus`` is (torch's
``softplus`` turns into the identity above 20).

One deliberate difference: ``ssd_chunked`` masks the decay exponent
``cums_i - cums_j`` to -inf above the diagonal BEFORE the exp, where the
JAX package takes the exp of every pair and zeroes the upper triangle
after. The forward values are the same (the masked entries are exactly 0
both ways), and so is the gradient wherever the JAX package's is finite;
above the diagonal the exponent is positive, passes fp32's exp limit after
~40 steps at the init's dt range, and the JAX package's gradient there is
0 * inf = NaN (chunk 64 and up), while this one stays finite.

On a grid (``repro_torch.dist.grid``) each leaf is the member's block by
``train.gspmd.param_pspecs`` (``spec``: the mixer's member specs), where
the model axis divides it: ``in_proj`` over its fused z | x | B | C | dt
columns, ``conv_w`` / ``conv_b`` over the xBC channels, ``dt_bias`` /
``A_log`` / ``D`` over the heads, ``norm_scale`` and ``out_proj``'s rows
over the inner channels. Those blocks do not line up with each other
(mamba2-370M's member 0 holds all of z and x[0:144] of ``in_proj``;
hymba-1.5B's ``norm_scale`` cuts head 12 in half), so the mixer runs in
the layouts its leaves give (``GridLayout``). Where the heads split (and
with them the inner channels), training and prefill run by heads
(``_by_heads``): ``in_proj`` and the conv are gathered (weights, not the
activations, whose rows outnumber a weight's), each member takes the
columns of its heads and of their groups, scans its heads, sums the
gated RMSNorm's mean of squares over the model axis (local on a shard,
global in GSPMD) and closes ``out_proj`` row-parallel with
``dist.psum_invariant``. Where the heads are whole, every member runs the
whole mixer on its leaves gathered. The decode step, one token a row,
moves the activations instead: ``in_proj`` column-parallel, its columns
gathered (``dist.all_gather_invariant``), the conv on the member's
channels, the recurrence on its heads, ``y`` brought to the member's
inner channels. The caches hold the member's heads of the SSM state and
its channels (``conv_w``'s block) of the conv tail.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import dist
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamDict, _dense_init, model_split


def ssm_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    d_xbc = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, n_heads, d_xbc


def init_ssm(gen: torch.Generator, cfg: ModelConfig) -> ParamDict:
    s = cfg.ssm
    d_inner, n_heads, d_xbc = ssm_dims(cfg)
    d_in_proj = 2 * d_inner + 2 * s.n_groups * s.d_state + n_heads
    dev = gen.device
    return ParamDict(
        in_proj=_dense_init(gen, (cfg.d_model, d_in_proj), in_axis=0),
        conv_w=_dense_init(gen, (s.d_conv, d_xbc), in_axis=0) * 0.1,
        conv_b=torch.zeros(d_xbc, device=dev),
        dt_bias=torch.log(torch.expm1(torch.linspace(1e-3, 1e-1, n_heads,
                                                     device=dev))),
        A_log=torch.log(torch.linspace(1.0, 16.0, n_heads, device=dev)),
        D=torch.ones(n_heads, device=dev),
        norm_scale=torch.ones(d_inner, device=dev),
        out_proj=_dense_init(gen, (d_inner, cfg.d_model), in_axis=0))


@dataclasses.dataclass(frozen=True)
class GridLayout:
    """Which of the mixer's leaves a grid member holds a block of, over a
    model axis of ``n`` (> 1) where it is member ``r``: ``in_proj``'s
    columns, the conv's channels, the heads (``dt_bias`` / ``A_log`` /
    ``D`` and the SSM state), the inner channels (``norm_scale`` and
    ``out_proj``'s rows)."""
    n: int
    r: int
    in_proj: bool
    conv: bool
    heads: bool
    inner: bool

    def block(self, size: int) -> tuple:
        """[lo, hi) of this member's block of a dim of ``size``."""
        step = size // self.n
        return self.r * step, (self.r + 1) * step


def grid_layout(spec) -> Optional[GridLayout]:
    """The member's ``GridLayout`` from the mixer's specs (None off a grid
    or on a model axis of one, where every leaf is whole)."""
    n = dist.world_size()
    if spec is None or n == 1:
        return None
    inner = model_split(spec, "norm_scale")
    if inner != model_split(spec, "out_proj"):
        raise ValueError("norm_scale and out_proj's rows split apart")
    return GridLayout(n=n, r=dist.rank(),
                      in_proj=model_split(spec, "in_proj"),
                      conv=model_split(spec, "conv_w"),
                      heads=model_split(spec, "dt_bias"), inner=inner)


def _heads(lay: Optional[GridLayout], n_heads: int) -> tuple:
    """[h0, h1) of the heads the member scans."""
    return lay.block(n_heads) if lay and lay.heads else (0, n_heads)


def _zxbcdt(p, x, lay: Optional[GridLayout]):
    """x @ in_proj, every fused column on every member: where ``in_proj``
    is split, the member's columns, gathered over the model axis."""
    w = p.in_proj.to(x.dtype)
    if lay is None or not lay.in_proj:
        return x @ w
    return dist.all_gather_invariant(dist.pvary(x) @ w, dim=-1)


def _own(x, lay: Optional[GridLayout], split: bool, lo: int, hi: int,
         dim: int = -1):
    """The member's block [lo, hi) of ``dim`` of a value every member holds
    alike, for work on its own block (``dist.pvary``: the cotangents of
    the members' blocks sum into the whole one)."""
    if lay is None or not split:
        return x
    return dist.pvary(x).narrow(dim, lo, hi - lo)


def _split_in_proj(cfg: ModelConfig, zxbcdt):
    d_inner, _, d_xbc = ssm_dims(cfg)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + d_xbc]
    dt = zxbcdt[..., d_inner + d_xbc:]
    return z, xbc, dt


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _causal_conv(xbc, w, b):
    """Depthwise causal conv1d. xbc: [B,S,C]; w: [K,C]. The K taps are
    summed one by one in the JAX package's order."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = pad[:, 0:s, :] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + s, :] * w[i]
    return out + b


def ssd_chunked(x, dt, A, B, C, chunk: int, init_state=None):
    """Chunked SSD scan.

    x: [b,s,h,p]; dt: [b,s,h] (post-softplus, fp32); A: [h] (negative
    fp32); B, C: [b,s,g,n] (g groups broadcast over heads). Returns (y
    [b,s,h,p] fp32, final_state [b,h,n,p] fp32)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError(f"seq {s} % chunk {chunk} != 0")
    nc, l = s // chunk, chunk
    rep = h // g

    xc = x.reshape(b, nc, l, h, p).float()
    dtc = dt.reshape(b, nc, l, h).float()
    Bc = B.reshape(b, nc, l, g, n).float()
    Cc = C.reshape(b, nc, l, g, n).float()
    dtA = dtc * A                                   # [b,nc,l,h] negative
    cums = torch.cumsum(dtA, dim=2)                 # inclusive

    # intra-chunk ("diagonal") term: L[i,j] = exp(cums_i - cums_j) for
    # i >= j, else 0, masked before the exp (the module's docstring)
    tri = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    seg = cums[:, :, :, None, :] - cums[:, :, None, :, :]    # [b,nc,i,j,h]
    Ldec = torch.exp(torch.where(tri[None, None, :, :, None], seg,
                                 float("-inf")))
    CB = torch.einsum("bclgn,bcmgn->bclmg", Cc, Bc)          # [b,nc,i,j,g]
    # CB repeated over each group's heads (jnp.repeat's order), as a view
    M = (CB[..., None] * Ldec.view(b, nc, l, l, g, rep)).view(b, nc, l, l, h)
    xdt = xc * dtc[..., None]                                 # [b,nc,l,h,p]
    y_diag = torch.einsum("bclmh,bcmhp->bclhp", M, xdt)

    # chunk-final states
    decay_states = torch.exp(cums[:, :, -1:, :] - cums)       # [b,nc,l,h]
    Bh = Bc.repeat_interleave(rep, dim=3)                     # [b,nc,l,h,n]
    states = torch.einsum("bclhn,bclh,bclhp->bchnp", Bh, decay_states * dtc,
                          xc)                                 # [b,nc,h,n,p]

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(cums[:, :, -1, :])                # [b,nc,h]
    prev = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
            if init_state is None else init_state)
    entering = []
    for c in range(nc):
        entering.append(prev)
        prev = states[:, c] + chunk_decay[:, c, :, None, None] * prev
    prev_states = torch.stack(entering, dim=1)                # [b,nc,h,n,p]

    # inter-chunk ("off-diagonal") contribution
    Ch = Cc.repeat_interleave(rep, dim=3)                     # [b,nc,l,h,n]
    y_off = torch.einsum("bclhn,bclh,bchnp->bclhp", Ch, torch.exp(cums),
                         prev_states)
    return (y_diag + y_off).reshape(b, s, h, p), prev


def _gated_norm(p, cfg: ModelConfig, y, z, dt_, d_total=None):
    """mamba2's gated RMSNorm: y (in the compute dtype) times silu(z), then
    the norm in fp32 at ``cfg.norm_eps``. ``d_total``: the whole inner
    width where y holds the member's channels of it, whose mean of
    squares is then summed over the model axis."""
    y = y * F.silu(z)
    yf = y.float()
    if d_total is None:
        ms = yf.square().mean(dim=-1, keepdim=True)
    else:
        ms = dist.psum(yf.square().sum(dim=-1, keepdim=True)) / d_total
    return (yf * torch.rsqrt(ms + cfg.norm_eps) * p.norm_scale).to(dt_)


def _norm_out(p, cfg: ModelConfig, y, z, dt_, lay: Optional[GridLayout],
              heads: tuple):
    """The decode step's gated norm and ``out_proj`` of ``y`` [..., (h1 -
    h0) * P] (the heads ``heads`` = (h0, h1)) gated by ``z`` [...,
    d_inner] (whole on every member): off a grid ``_gated_norm``, then
    the product; on one, ``y`` is brought to the member's inner channels,
    the mean of squares is summed over the model axis, and ``out_proj`` is
    row-parallel."""
    d_inner = z.shape[-1]
    if lay is None or not (lay.heads or lay.inner):
        return _gated_norm(p, cfg, y, z, dt_) @ p.out_proj.to(dt_)
    head_dim = cfg.ssm.head_dim
    c0, c1 = heads[0] * head_dim, heads[1] * head_dim
    i0, i1 = lay.block(d_inner) if lay.inner else (0, d_inner)
    if (c0, c1) != (i0, i1):
        # the heads' channels are not the inner block: y whole, then cut
        if lay.heads:
            y = dist.all_gather_invariant(y, dim=-1)
        y = _own(y, lay, lay.inner, i0, i1)
    out = _gated_norm(p, cfg, y, _own(z, lay, lay.inner, i0, i1), dt_,
                      d_total=d_inner if lay.inner else None) \
        @ p.out_proj.to(dt_)
    return dist.psum_invariant(out) if lay.inner else out


def _scan(p, cfg: ModelConfig, zxbcdt, conv_w, conv_b, n_heads: int,
          n_groups: int, init_state=None):
    """The mixer between ``in_proj`` and the gated norm over ``n_heads``
    heads and ``n_groups`` groups (all of them off a grid, or a member's):
    ``zxbcdt`` [B, S, 2 d + 2 G N + H] (d = n_heads * P), the depthwise
    conv by ``conv_w`` / ``conv_b`` over its xBC channels, the chunked SSD
    with ``p``'s dt_bias / A_log / D. -> (z [B, S, d], y [B, S, d] in the
    compute dtype, the final state [B, H, N, P] fp32)."""
    s_cfg = cfg.ssm
    dt_ = zxbcdt.dtype
    b, s, _ = zxbcdt.shape
    d = n_heads * s_cfg.head_dim
    gn = n_groups * s_cfg.d_state
    z = zxbcdt[..., :d]
    xbc = F.silu(_causal_conv(zxbcdt[..., d:2 * d + 2 * gn], conv_w.to(dt_),
                              conv_b.to(dt_)))
    dt = zxbcdt[..., 2 * d + 2 * gn:]
    B = xbc[..., d:d + gn].reshape(b, s, n_groups, s_cfg.d_state)
    C = xbc[..., d + gn:].reshape(b, s, n_groups, s_cfg.d_state)
    xh = xbc[..., :d].reshape(b, s, n_heads, s_cfg.head_dim)
    dt = _softplus(dt.float() + p.dt_bias)
    A = -torch.exp(p.A_log)
    # pad seq to a chunk multiple; padded steps get dt=0 (decay 1, no
    # input), so they are exact no-ops on the state
    s_pad = -s % s_cfg.chunk
    xh_in, dt_in, B_in, C_in = xh, dt, B, C
    if s_pad:
        xh_in = F.pad(xh, (0, 0, 0, 0, 0, s_pad))
        dt_in = F.pad(dt, (0, 0, 0, s_pad))
        B_in = F.pad(B, (0, 0, 0, 0, 0, s_pad))
        C_in = F.pad(C, (0, 0, 0, 0, 0, s_pad))
    y, state = ssd_chunked(xh_in, dt_in, A, B_in, C_in, s_cfg.chunk,
                           init_state)
    if s_pad:
        y = y[:, :s]
    y = y + p.D[None, None, :, None] * xh.float()
    return z, y.reshape(b, s, d).to(dt_), state


# the dim of each leaf the model axis may split (its "inner" or "heads")
_SPLIT_DIM = {"in_proj": 1, "conv_w": 1, "conv_b": 0, "dt_bias": 0,
              "A_log": 0, "D": 0, "norm_scale": 0, "out_proj": 0}


def apply_ssm(p, cfg: ModelConfig, x, init_state=None, spec=None):
    """Train / prefill forward. x: [B,S,D] -> (y [B,S,D], cache_out
    {"ssm_state" [B,H,N,P] fp32, "conv_state" [B,K-1,Dxbc]}). ``spec``:
    the mixer's member specs on a grid, where it runs by the member's
    heads (``_by_heads``) or, where the heads are whole, on every member
    with the split leaves gathered; the cache then holds the member's
    heads and conv channels, and ``init_state`` is its heads' state."""
    lay = grid_layout(spec)
    if lay is not None and lay.heads:
        return _by_heads(p, cfg, x, lay, init_state)
    if lay is not None:
        # every head on every member: the split leaves gathered whole
        p = ParamDict(**{k: dist.all_gather_invariant(v, dim=_SPLIT_DIM[k])
                         if k in _SPLIT_DIM and model_split(spec, k) else v
                         for k, v in p.items()})
    _, n_heads, _ = ssm_dims(cfg)
    z, y, state = _scan(p, cfg, x @ p.in_proj.to(x.dtype), p.conv_w,
                        p.conv_b, n_heads, cfg.ssm.n_groups, init_state)
    out = _gated_norm(p, cfg, y, z, x.dtype) @ p.out_proj.to(x.dtype)
    # the conv tail, for a decode that continues the prefill
    tail = _conv_tail_from_prefill(p, cfg, x)
    if lay is not None and lay.conv:
        tail = tail[..., slice(*lay.block(tail.shape[-1]))]
    return out, {"ssm_state": state, "conv_state": tail}


def _by_heads(p, cfg: ModelConfig, x, lay: GridLayout, init_state):
    """``apply_ssm`` on a member that holds a block of the heads (and so
    the inner channels of those heads: ``norm_scale``, ``out_proj``'s
    rows): ``in_proj`` and the conv gathered whole (their blocks split
    the fused columns and the xBC channels elsewhere than at the heads),
    their columns of the member's heads (z, x, dt) and of its heads'
    groups (B, C) taken; the scan on those heads; the norm's mean of
    squares summed over the model axis; ``out_proj`` row-parallel. The
    weights move, not the activations, whose rows outnumber a weight's."""
    s_cfg = cfg.ssm
    d_inner, n_heads, d_xbc = ssm_dims(cfg)
    dt_ = x.dtype
    head_dim, n, gn = s_cfg.head_dim, s_cfg.d_state, s_cfg.n_groups
    h0, h1 = lay.block(n_heads)
    rep = n_heads // gn
    if h0 // rep != (h1 - 1) // rep and (h0 % rep or h1 % rep):
        raise NotImplementedError(
            f"heads {h0}..{h1 - 1} of {n_heads} split a group of {rep}")
    g0, g1 = h0 // rep, (h1 - 1) // rep + 1
    dev = x.device

    def span(lo, hi):
        return torch.arange(lo, hi, device=dev)

    xs = span(h0 * head_dim, h1 * head_dim)                # the heads' x
    bc = torch.cat([span(g0 * n, g1 * n), gn * n + span(g0 * n, g1 * n)])
    cols = torch.cat([xs, d_inner + xs, 2 * d_inner + bc,
                      2 * d_inner + 2 * gn * n + span(h0, h1)])
    chans = torch.cat([xs, d_inner + bc])
    # each member's columns of the gathered weights: the gathers' backward
    # sums the members' parts of the gradient and keeps the member's block
    w_in = (dist.all_gather(p.in_proj, dim=1) if lay.in_proj
            else dist.pvary(p.in_proj))
    conv_w, conv_b = ((dist.all_gather(p.conv_w, dim=1),
                       dist.all_gather(p.conv_b, dim=0)) if lay.conv
                      else (dist.pvary(p.conv_w), dist.pvary(p.conv_b)))
    z, y, state = _scan(p, cfg, dist.pvary(x) @ w_in[:, cols].to(dt_),
                        conv_w[:, chans], conv_b[chans], h1 - h0, g1 - g0,
                        init_state)
    out = dist.psum_invariant(
        _gated_norm(p, cfg, y, z, dt_, d_total=d_inner)
        @ p.out_proj.to(dt_))
    # the conv tail in the cache's layout (``conv_w``'s block of the xBC
    # channels), from the tail rows' own product with the whole in_proj
    with torch.no_grad():
        tail = _conv_tail(cfg, _split_in_proj(
            cfg, x[:, -(s_cfg.d_conv - 1):, :].detach()
            @ w_in.detach().to(dt_))[1])
    if lay.conv:
        tail = tail[..., slice(*lay.block(d_xbc))]
    return out, {"ssm_state": state, "conv_state": tail}


def _conv_tail(cfg: ModelConfig, xbc):
    """The last (d_conv - 1) rows of the pre-conv xBC [B, S, C], a prompt
    shorter than that left-padded with zeros."""
    k = cfg.ssm.d_conv
    xbc = xbc[:, -(k - 1):, :]
    if xbc.shape[1] < k - 1:
        xbc = F.pad(xbc, (0, 0, k - 1 - xbc.shape[1], 0))
    return xbc


def _conv_tail_from_prefill(p, cfg: ModelConfig, x):
    """The last (d_conv - 1) pre-conv xBC rows, for decode continuation,
    from their own product with ``in_proj`` (as the JAX package takes
    them); a prompt shorter than that is left-padded with zeros."""
    k = cfg.ssm.d_conv
    zxbcdt = x[:, -(k - 1):, :] @ p.in_proj.to(x.dtype)
    _, xbc, _ = _split_in_proj(cfg, zxbcdt)
    return _conv_tail(cfg, xbc)


def ssm_axes(cfg: ModelConfig):
    """Logical axes of ``init_ssm``'s params."""
    return {
        "in_proj": ("embed", "inner"),
        "conv_w": (None, "inner"),
        "conv_b": ("inner",),
        "dt_bias": ("heads",),
        "A_log": ("heads",),
        "D": ("heads",),
        "norm_scale": ("inner",),
        "out_proj": ("inner", "embed"),
    }


def ssm_cache_axes(cfg: ModelConfig):
    return {"ssm_state": ("batch", "heads", None, None),
            "conv_state": ("batch", None, "inner")}


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, *, device,
                   spec=None) -> dict:
    """Zeros of one layer's decode cache; on a grid (``spec``) the
    member's heads of the state and its channels of the conv tail."""
    s = cfg.ssm
    _, n_heads, d_xbc = ssm_dims(cfg)
    lay = grid_layout(spec)
    if lay is not None:
        n_heads //= lay.n if lay.heads else 1
        d_xbc //= lay.n if lay.conv else 1
    return {"ssm_state": torch.zeros((batch, n_heads, s.d_state, s.head_dim),
                                     dtype=torch.float32, device=device),
            "conv_state": torch.zeros((batch, s.d_conv - 1, d_xbc),
                                      dtype=dtype, device=device)}


def apply_ssm_step(p, cfg: ModelConfig, x, cache, spec=None):
    """Single-token decode. x: [B,1,D] -> (y [B,1,D], new cache). The new
    cache's leaves are fresh tensors; ``models.decoder`` writes them into
    the stacked cache in place. ``spec``: as ``apply_ssm``'s, the cache
    the member's heads and conv channels."""
    s_cfg = cfg.ssm
    d_inner, n_heads, _ = ssm_dims(cfg)
    lay = grid_layout(spec)
    dt_ = x.dtype
    b = x.shape[0]
    gn = s_cfg.n_groups * s_cfg.d_state
    zxbcdt = _zxbcdt(p, x[:, 0, :], lay)                      # [B, ...]
    z, xbc, dt = _split_in_proj(cfg, zxbcdt)
    if lay is not None and lay.conv:
        xbc = xbc[..., slice(*lay.block(xbc.shape[-1]))]
    window = torch.cat([cache["conv_state"], xbc[:, None, :]], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", window,
                            p.conv_w.to(dt_)) + p.conv_b.to(dt_)
    xbc_t = F.silu(conv_out)
    if lay is not None and lay.conv:
        xbc_t = dist.all_gather_invariant(xbc_t, dim=-1)
    h0, h1 = heads = _heads(lay, n_heads)
    x_ssm = xbc_t[..., :d_inner]
    B = xbc_t[..., d_inner:d_inner + gn].reshape(b, s_cfg.n_groups,
                                                 s_cfg.d_state)
    C = xbc_t[..., d_inner + gn:].reshape(b, s_cfg.n_groups, s_cfg.d_state)
    rep = n_heads // s_cfg.n_groups
    Bh = B.repeat_interleave(rep, dim=1).float()[:, h0:h1]    # [B,H,N]
    Ch = C.repeat_interleave(rep, dim=1).float()[:, h0:h1]
    xh = x_ssm.reshape(b, n_heads, s_cfg.head_dim).float()[:, h0:h1]
    dt = _softplus(dt[:, h0:h1].float() + p.dt_bias)          # [B,H]
    A = -torch.exp(p.A_log)
    decay = torch.exp(dt * A)
    state = decay[:, :, None, None] * cache["ssm_state"] + torch.einsum(
        "bhn,bh,bhp->bhnp", Bh, dt, xh)
    y = torch.einsum("bhn,bhnp->bhp", Ch, state) + p.D[None, :, None] * xh
    out = _norm_out(p, cfg, y.reshape(b, -1).to(dt_), z, dt_, lay, heads)
    return out[:, None, :], {"ssm_state": state,
                             "conv_state": window[:, 1:, :]}
