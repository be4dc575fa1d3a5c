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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamDict, _dense_init


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


def _gated_norm(p, cfg: ModelConfig, y, z, dt_):
    """mamba2's gated RMSNorm: y (in the compute dtype) times silu(z), then
    the norm in fp32 at ``cfg.norm_eps``."""
    y = y * F.silu(z)
    yf = y.float()
    ms = yf.square().mean(dim=-1, keepdim=True)
    return (yf * torch.rsqrt(ms + cfg.norm_eps) * p.norm_scale).to(dt_)


def apply_ssm(p, cfg: ModelConfig, x, init_state=None):
    """Train / prefill forward. x: [B,S,D] -> (y [B,S,D], cache_out
    {"ssm_state" [B,H,N,P] fp32, "conv_state" [B,K-1,Dxbc]})."""
    s_cfg = cfg.ssm
    d_inner, n_heads, _ = ssm_dims(cfg)
    dt_ = x.dtype
    gn = s_cfg.n_groups * s_cfg.d_state
    zxbcdt = x @ p.in_proj.to(dt_)
    z, xbc, dt = _split_in_proj(cfg, zxbcdt)
    xbc = F.silu(_causal_conv(xbc, p.conv_w.to(dt_), p.conv_b.to(dt_)))
    b, s, _ = x.shape
    x_ssm = xbc[..., :d_inner]
    B = xbc[..., d_inner:d_inner + gn].reshape(b, s, s_cfg.n_groups,
                                               s_cfg.d_state)
    C = xbc[..., d_inner + gn:].reshape(b, s, s_cfg.n_groups, s_cfg.d_state)
    xh = x_ssm.reshape(b, s, n_heads, s_cfg.head_dim)
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
    y = _gated_norm(p, cfg, y.reshape(b, s, d_inner).to(dt_), z, dt_)
    out = y @ p.out_proj.to(dt_)
    # the conv tail, for a decode that continues the prefill
    return out, {"ssm_state": state,
                 "conv_state": _conv_tail_from_prefill(p, cfg, x)}


def _conv_tail_from_prefill(p, cfg: ModelConfig, x):
    """The last (d_conv - 1) pre-conv xBC rows, for decode continuation;
    a prompt shorter than that is left-padded with zeros."""
    _, _, d_xbc = ssm_dims(cfg)
    k = cfg.ssm.d_conv
    zxbcdt = x[:, -(k - 1):, :] @ p.in_proj.to(x.dtype)
    _, xbc, _ = _split_in_proj(cfg, zxbcdt)
    if xbc.shape[1] < k - 1:
        xbc = F.pad(xbc, (0, 0, k - 1 - xbc.shape[1], 0))
    return xbc


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


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, *, device) -> dict:
    s = cfg.ssm
    _, n_heads, d_xbc = ssm_dims(cfg)
    return {"ssm_state": torch.zeros((batch, n_heads, s.d_state, s.head_dim),
                                     dtype=torch.float32, device=device),
            "conv_state": torch.zeros((batch, s.d_conv - 1, d_xbc),
                                      dtype=dtype, device=device)}


def apply_ssm_step(p, cfg: ModelConfig, x, cache):
    """Single-token decode. x: [B,1,D] -> (y [B,1,D], new cache). The new
    cache's leaves are fresh tensors; ``models.decoder`` writes them into
    the stacked cache in place."""
    s_cfg = cfg.ssm
    d_inner, n_heads, _ = ssm_dims(cfg)
    dt_ = x.dtype
    b = x.shape[0]
    gn = s_cfg.n_groups * s_cfg.d_state
    zxbcdt = x[:, 0, :] @ p.in_proj.to(dt_)                   # [B, ...]
    z, xbc, dt = _split_in_proj(cfg, zxbcdt)
    window = torch.cat([cache["conv_state"], xbc[:, None, :]], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", window,
                            p.conv_w.to(dt_)) + p.conv_b.to(dt_)
    xbc_t = F.silu(conv_out)
    x_ssm = xbc_t[..., :d_inner]
    B = xbc_t[..., d_inner:d_inner + gn].reshape(b, s_cfg.n_groups,
                                                 s_cfg.d_state)
    C = xbc_t[..., d_inner + gn:].reshape(b, s_cfg.n_groups, s_cfg.d_state)
    rep = n_heads // s_cfg.n_groups
    Bh = B.repeat_interleave(rep, dim=1).float()              # [B,H,N]
    Ch = C.repeat_interleave(rep, dim=1).float()
    xh = x_ssm.reshape(b, n_heads, s_cfg.head_dim).float()    # [B,H,P]
    dt = _softplus(dt.float() + p.dt_bias)                    # [B,H]
    A = -torch.exp(p.A_log)
    decay = torch.exp(dt * A)
    state = decay[:, :, None, None] * cache["ssm_state"] + torch.einsum(
        "bhn,bh,bhp->bhnp", Bh, dt, xh)
    y = torch.einsum("bhn,bhnp->bhp", Ch, state) + p.D[None, :, None] * xh
    y = _gated_norm(p, cfg, y.reshape(b, d_inner).to(dt_), z, dt_)
    out = (y @ p.out_proj.to(dt_))[:, None, :]
    return out, {"ssm_state": state, "conv_state": window[:, 1:, :]}
