"""Shared model primitives: norms, RoPE, GQA attention (qk-norm, sliding
window, the q-block / kv-block online-softmax scan), gated MLPs,
embeddings. The port of the JAX package's ``models/layers.py``.

Conventions, as in the JAX package:

* Parameters keep the JAX package's names and layouts (``wq`` [D, H, Dh],
  ``wk`` / ``wv`` [D, Hk, Dh], ``wo`` [H, Dh, D], MLP matrices [in, out]).
  They live in ``ParamDict``s, the JAX package's nested param dicts with
  attribute access, in fp32 (``cfg.param_dtype``), and are cast to the
  compute dtype ``cfg.dtype`` where they are used.
* Norm statistics, softmax and attention logits run in fp32. Where the JAX
  package multiplies bf16 operands with ``preferred_element_type=float32``
  (attention scores, the flash scan's two products), the port multiplies
  the operands upcast to fp32: each product of two bf16 values is exact in
  fp32, so only the order of the fp32 sums differs.
* Sequence ops take absolute positions, so the same code serves prefill
  and rotating-cache decode.

On a grid (``repro_torch.dist``) a member holds its slices of the
tensor-parallel params (``train.gspmd.param_pspecs``): the attention's
``heads`` / ``kv_heads`` of ``wq`` / ``wk`` / ``wv`` (column-parallel) and
of ``wo`` (row-parallel, its output summed over ``model``), the MLP's
hidden columns (``wo``'s output summed, then ``bo`` added once) and the
embedding table's vocab rows (a masked local lookup, then summed). A
layer reads what it holds from its ``spec`` (the member's specs of its
params, ``train.gspmd.member_specs``; None off a grid), so a dim the
model axis does not divide stays whole (SmolLM's 9 heads on 2 members)
and the same code runs the replicated ring. Values the model
axis holds alike carry their whole cotangent on every member:
``dist.pvary`` opens each column-parallel product and
``dist.psum_invariant`` closes each row-parallel one.

``multihead_attention`` takes the path's ``backend``: ``"ref"`` runs the
JAX package's two branches as it chooses them; ``"kernel"`` sends
self-attention over a sequence's rows (the caller says so with
``self_rows=True``: positions arange(S)) to the hand-written
``ops.flash_attention``, the one case that kernel expresses, and
everything else (decode over the rotating cache) down the ``ref``
branches, as the JAX package leaves it to XLA.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import dist
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops


class ParamDict(dict):
    """Named parameters and sub-trees: one node of the JAX package's nested
    param dict, a dict whose entries also read as attributes (``p.wq`` is
    ``p["wq"]``). Nested dicts become ``ParamDict``s and lists of dicts
    lists of them; the keys are kept in sorted order, so iteration (and
    ``optim.tree_map`` / ``tree_leaves``) walks the tree in
    ``jax.tree.flatten``'s order over the JAX package's dicts, a layer list
    in index order. The leaves are plain fp32 tensors: fresh ones do not
    require grad, so serving records no graph, and the trainer
    differentiates a tree of the same tensors made to require grad
    (``core.pipeline``), the one representation for serving and
    training."""

    def __init__(self, **entries):
        super().__init__()
        for name in sorted(entries):
            val = entries[name]
            if isinstance(val, dict) and not isinstance(val, ParamDict):
                val = ParamDict(**val)
            elif isinstance(val, (list, tuple)):
                val = [v if isinstance(v, ParamDict) else ParamDict(**v)
                       for v in val]
            self[name] = val

    def __getattr__(self, name: str):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


class MetaGenerator:
    """Stands in for the ``torch.Generator`` an init takes, where the init
    should build shapes only: every tensor of the params lands on the meta
    device (no storage, nothing drawn), so a model of any size is built in
    milliseconds (``lm.abstract_model``)."""
    device = torch.device("meta")


def randn(gen, shape):
    """N(0, 1) fp32 on ``gen``'s device, drawn from ``gen`` (or, from a
    ``MetaGenerator``, an empty meta tensor)."""
    if isinstance(gen, MetaGenerator):
        return torch.empty(shape, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device)


def _dense_init(gen: torch.Generator, shape, in_axis: int = -2):
    """LeCun-normal-ish fan-in init, fp32."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    return randn(gen, shape) / math.sqrt(fan_in)


def _embed_init(gen: torch.Generator, shape):
    return randn(gen, shape) * 0.02


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_norm(cfg: ModelConfig, dim: Optional[int] = None, *, device):
    dim = dim or cfg.d_model
    p = {"scale": torch.ones(dim, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(dim, device=device)
    return ParamDict(**p)


def norm_axes(cfg: ModelConfig):
    """Logical axes of ``init_norm``'s params (the JAX package's, leaf for
    leaf; ``train.gspmd.param_pspecs`` maps them onto the grid)."""
    a = {"scale": ("embed",)}
    if cfg.norm == "layernorm":
        a["bias"] = ("embed",)
    return a


def apply_norm(p, x, cfg: ModelConfig):
    dt = x.dtype
    x = x.float()
    if cfg.norm == "layernorm":
        mu = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, keepdim=True, unbiased=False)
        y = (x - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p.scale + p.bias
    else:  # rmsnorm
        ms = x.square().mean(dim=-1, keepdim=True)
        y = x * torch.rsqrt(ms + cfg.norm_eps) * p.scale
    return y.to(dt)


def rms_norm(x, eps: float = 1e-6):
    """Scale-free RMS norm (the hybrid family's fusion), at its own eps,
    not ``cfg.norm_eps``."""
    dt = x.dtype
    x = x.float()
    ms = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(ms + eps)).to(dt)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope(x, positions, theta: float):
    """x: [..., S, H, Dh]; positions: [..., S] absolute token positions.
    The rotation runs in fp32 (bf16 x times fp32 cos promotes, as in the
    JAX package) and is cast back to x's dtype."""
    if theta <= 0:
        return x
    dh = x.shape[-1]
    half = dh // 2
    # the JAX package's fp32 arithmetic: log(theta) / half, then exp
    step = float(np.float32(np.log(np.float32(theta))) / np.float32(half))
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) * step)
    ang = positions[..., :, None].float() * freqs           # [..., S, half]
    cos = torch.cos(ang)[..., :, None, :]                   # [..., S, 1, half]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoid_positions(length: int, dim: int, *, device=None):
    """Whisper-style fixed sinusoidal embeddings [length, dim] fp32, with
    the JAX package's fp32 step log(10000) / (dim // 2 - 1)."""
    half = dim // 2
    step = float(np.float32(np.log(np.float32(10000.0)))
                 / np.float32(max(half - 1, 1)))
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=device) * step)
    ang = torch.arange(length, dtype=torch.float32,
                       device=device)[:, None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnDims:
    n_heads: int
    n_kv: int
    head_dim: int


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   dims: Optional[AttnDims] = None):
    d = dims or AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)
    p = {
        "wq": _dense_init(gen, (cfg.d_model, d.n_heads, d.head_dim), in_axis=0),
        "wk": _dense_init(gen, (cfg.d_model, d.n_kv, d.head_dim), in_axis=0),
        "wv": _dense_init(gen, (cfg.d_model, d.n_kv, d.head_dim), in_axis=0),
        "wo": _dense_init(gen, (d.n_heads, d.head_dim, cfg.d_model), in_axis=1),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(d.head_dim, device=gen.device)
        p["k_norm"] = torch.ones(d.head_dim, device=gen.device)
    return ParamDict(**p)


def attention_axes(cfg: ModelConfig):
    a = {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
    }
    if cfg.qk_norm:
        a["q_norm"] = ("head_dim",)
        a["k_norm"] = ("head_dim",)
    return a


def _qk_norm(x, scale, eps):
    dt = x.dtype
    x = x.float()
    ms = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(ms + eps) * scale).to(dt)


def _attn_scores_block(q, k, q_pos, k_pos, scale, causal, window):
    """q: [B,Hq,Sq,Dh] k: [B,Hk,T,Dh] (Hq multiple of Hk) -> probs fp32
    [B,Hk,G,Sq,T]."""
    b, hq, sq, dh = q.shape
    hk = k.shape[1]
    qg = q.reshape(b, hk, hq // hk, sq, dh)
    scores = torch.einsum("bkgsd,bktd->bkgst", qg.float(), k.float()) * scale
    qp = q_pos[:, None]
    kp = k_pos[None, :]
    valid = kp >= 0
    if causal:
        valid = valid & (kp <= qp)
    if window is not None and window > 0:
        valid = valid & (kp > qp - window)
    scores = torch.where(valid, scores, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    # rows with no valid key (padding) -> zeros, not NaN
    return torch.where(valid.any(dim=-1)[:, None], probs, 0.0)


def _flash_qblock(qg, kT, vT, qpos, k_positions, scale, causal, window,
                  kv_block: int):
    """Online softmax over kv blocks for one q block.
    qg: [B,Hk,G,qb,Dh]; kT/vT: [B,Hk,T,Dh]. Returns [B,Hk,G,qb,Dh] fp32."""
    b, hk, g, qb, dh = qg.shape
    t = kT.shape[2]
    if t % kv_block:
        raise ValueError(f"T {t} % kv_block {kv_block} != 0")
    qp = qpos[:, None]
    qf = qg.float()
    m = torch.full((b, hk, g, qb), float("-inf"), device=qg.device)
    l = torch.zeros((b, hk, g, qb), device=qg.device)
    acc = torch.zeros((b, hk, g, qb, dh), device=qg.device)
    for j0 in range(0, t, kv_block):
        kb, vb = kT[:, :, j0:j0 + kv_block], vT[:, :, j0:j0 + kv_block]
        kp = k_positions[j0:j0 + kv_block][None, :]
        s = torch.einsum("bkgsd,bktd->bkgst", qf, kb.float()) * scale
        valid = kp >= 0
        if causal:
            valid = valid & (kp <= qp)
        if window is not None and window > 0:
            valid = valid & (kp > qp - window)
        s = torch.where(valid, s, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # rows still all-masked keep m = -inf; guard exp of (-inf) - (-inf)
        safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(torch.where(valid, s - safe_m[..., None],
                                  float("-inf")))
        corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgst,bktd->bkgsd", p.to(vb.dtype).float(), vb.float())
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None]


def _kernel_self_attention(q, k, v, causal, window):
    """Self-attention over a sequence's rows through the flash kernel, in
    the [B*H, S, Dh] layout it takes: the KV heads are not expanded, since
    the kernel has query head b*Hq + h read KV head b*Hk + h // g, as the
    JAX package's reshape does."""
    b, s, hq, dh = q.shape

    def heads(x):
        return x.transpose(1, 2).reshape(-1, s, dh).contiguous()

    out = ops.flash_attention(heads(q), heads(k), heads(v), causal=causal,
                              window=window or 0)
    return out.reshape(b, hq, s, dh).transpose(1, 2)


def multihead_attention(q, k, v, *, q_positions, k_positions, causal=True,
                        window=None, q_block: int = 512, kv_block: int = 1024,
                        backend: str = "ref", self_rows: bool = False):
    """GQA attention over absolute positions.

    q: [B,Sq,Hq,Dh]; k,v: [B,T,Hk,Dh]; q_positions [Sq]; k_positions [T]
    (entries < 0 mark invalid cache slots). Returns [B,Sq,Hq,Dh] in q's
    dtype.

    ``ref``: long sequences run the two-level flash scan (q blocks outer,
    kv blocks inner, online softmax in fp32), short and decode shapes score
    directly, chosen by the JAX package's test. ``kernel``: with
    ``self_rows`` (the caller's statement that q_positions and k_positions
    are both arange(S): self-attention over a sequence's rows, the one case
    the flash kernel expresses, since its positions are implicit) the call
    goes to ``ops.flash_attention``; any other call (decode over the cache's
    slots) takes the ``ref`` branches.
    """
    b, sq, hq, dh = q.shape
    t = k.shape[1]
    hk = k.shape[2]
    if self_rows and sq != t:
        raise ValueError(f"self_rows: {sq} query rows over {t} keys")
    if backend == "kernel" and self_rows:
        return _kernel_self_attention(q, k, v, causal, window)
    # the JAX package's fp32 1 / sqrt(dh)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(dh)))
    qT = q.transpose(1, 2)               # [B,Hq,Sq,Dh]
    kT = k.transpose(1, 2)               # [B,Hk,T,Dh]
    vT = v.transpose(1, 2)

    if sq * t <= q_block * kv_block * 2 or t % kv_block:
        probs = _attn_scores_block(qT, kT, q_positions, k_positions, scale,
                                   causal, window)
        out = torch.einsum("bkgst,bktd->bkgsd", probs.to(v.dtype).float(),
                           vT.float())
        out = out.reshape(b, hq, sq, dh)
        return out.to(q.dtype).transpose(1, 2)

    g = hq // hk
    qg4 = qT.reshape(b, hk, g, sq, dh)
    if sq <= q_block:
        out = _flash_qblock(qg4, kT, vT, q_positions, k_positions, scale,
                            causal, window, kv_block)
    else:
        if sq % q_block:
            raise ValueError(f"seq {sq} not divisible by q_block {q_block}")
        out = torch.cat([
            _flash_qblock(qg4[:, :, :, i:i + q_block], kT, vT,
                          q_positions[i:i + q_block], k_positions, scale,
                          causal, window, kv_block)
            for i in range(0, sq, q_block)], dim=3)
    return out.reshape(b, hq, sq, dh).to(q.dtype).transpose(1, 2)


def model_split(spec, leaf: str) -> bool:
    """Whether the param ``leaf`` of a layer's ``spec`` (None: off a grid)
    is split over the model axis."""
    return spec is not None and "model" in dist.spec_axes(spec[leaf])


def project_kv(p, cfg: ModelConfig, x, positions, spec=None):
    """Project (and qk-norm + rope) K/V of x for self-attention/caching:
    the member's KV heads where ``spec`` splits ``wk`` / ``wv`` over the
    model axis, all of them where they are whole."""
    dt = x.dtype
    split = model_split(spec, "wk")
    if split:
        x = dist.pvary(x)
    k = torch.einsum("bsd,dhk->bshk", x, p.wk.to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p.wv.to(dt))
    if cfg.qk_norm:
        k = _qk_norm(k, dist.pvary(p.k_norm) if split else p.k_norm,
                     cfg.norm_eps)
    if cfg.rope_theta > 0:
        k = rope(k, positions, cfg.rope_theta)
    return k, v


def _kv_for_heads(k, v, cfg: ModelConfig, hq_loc: int):
    """The KV heads this member's ``hq_loc`` query heads read, where the
    query heads are split over the model axis and the KV heads whole (MQA
    and GQA with fewer KV heads than members): a contiguous run of them,
    each still read by a whole group of the member's query heads. Their
    cotangents sum over the model axis (``pvary``), since every member's
    copy holds the whole K and V."""
    g = cfg.n_heads // cfg.n_kv_heads
    lo = dist.rank() * hq_loc // g
    hi = ((dist.rank() + 1) * hq_loc - 1) // g + 1
    if hq_loc % (hi - lo):
        raise NotImplementedError(
            f"{hq_loc} query heads a member over groups of {g} read KV "
            f"heads {lo}..{hi - 1} unevenly")
    return dist.pvary(k)[:, :, lo:hi], dist.pvary(v)[:, :, lo:hi]


def apply_attention(p, cfg: ModelConfig, x, *, positions, kv=None,
                    kv_positions=None, causal=True, window=None,
                    backend: str = "ref", self_rows: bool = False,
                    spec=None):
    """Full attention sublayer. ``kv`` overrides the K/V source:
    - None: self-attention over x;
    - (k_cache, v_cache): a pre-projected (and pre-roped) cache [B,T,Hk,Dh]
      at ``kv_positions``;
    - {"x": enc_out}: cross-attention: K and V projected from ``enc_out``
      [B,T,D] at ``kv_positions``, k qk-normed when the config asks for it,
      and no rope on q or k.
    Returns (out [B,S,D], (k_new, v_new) projected K/V of x for the cache,
    or None when ``kv`` was given). ``self_rows``: ``positions`` is
    arange(S), which the ``kernel`` backend needs for self-attention (see
    ``multihead_attention``); it raises on causal self-attention without
    it rather than run the ``ref`` branches. Cross-attention and decode
    over a cache take the ``ref`` branches on either backend."""
    dt = x.dtype
    cross = isinstance(kv, dict)
    split = model_split(spec, "wq")
    q = torch.einsum("bsd,dhk->bshk", dist.pvary(x) if split else x,
                     p.wq.to(dt))
    if cross:
        # column-parallel over the KV heads where wk is split
        src = dist.pvary(kv["x"]) if model_split(spec, "wk") else kv["x"]
        k = torch.einsum("bsd,dhk->bshk", src, p.wk.to(dt))
        v = torch.einsum("bsd,dhk->bshk", src, p.wv.to(dt))
        k_pos = kv_positions
    elif kv is None:
        if backend == "kernel" and causal and not self_rows:
            raise ValueError("the kernel backend runs causal self-attention "
                             "over a sequence's rows only: pass self_rows="
                             "True with positions arange(S)")
        k, v = project_kv(p, cfg, x, positions, spec)
        k_pos = positions
    else:
        k, v = kv
        k_pos = kv_positions
    if cfg.qk_norm:
        q = _qk_norm(q, dist.pvary(p.q_norm) if split else p.q_norm,
                     cfg.norm_eps)
        if cross:
            k = _qk_norm(k, dist.pvary(p.k_norm)
                         if model_split(spec, "wk") else p.k_norm,
                         cfg.norm_eps)
    if cfg.rope_theta > 0 and not cross:
        q = rope(q, positions, cfg.rope_theta)
    ks, vs = k, v
    if split and not model_split(spec, "wk"):
        ks, vs = _kv_for_heads(k, v, cfg, q.shape[2])
    out = multihead_attention(q, ks, vs, q_positions=positions,
                              k_positions=k_pos, causal=causal, window=window,
                              backend=backend,
                              self_rows=self_rows and kv is None)
    out = torch.einsum("bshk,hkd->bsd", out, p.wo.to(dt))
    if split:
        out = dist.psum_invariant(out)
    if kv is None:
        return out, (k, v)
    return out, None


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None):
    d_ff = d_ff or cfg.d_ff
    if cfg.activation in ("swiglu", "geglu"):
        return ParamDict(
            wi_gate=_dense_init(gen, (cfg.d_model, d_ff), in_axis=0),
            wi_up=_dense_init(gen, (cfg.d_model, d_ff), in_axis=0),
            wo=_dense_init(gen, (d_ff, cfg.d_model), in_axis=0))
    return ParamDict(  # plain gelu MLP
        wi=_dense_init(gen, (cfg.d_model, d_ff), in_axis=0),
        bi=torch.zeros(d_ff, device=gen.device),
        wo=_dense_init(gen, (d_ff, cfg.d_model), in_axis=0),
        bo=torch.zeros(cfg.d_model, device=gen.device))


def mlp_axes(cfg: ModelConfig):
    if cfg.activation in ("swiglu", "geglu"):
        return {"wi_gate": ("embed", "mlp"), "wi_up": ("embed", "mlp"),
                "wo": ("mlp", "embed")}
    return {"wi": ("embed", "mlp"), "bi": ("mlp",),
            "wo": ("mlp", "embed"), "bo": ("embed",)}


def apply_mlp(p, cfg: ModelConfig, x, spec=None):
    """jax.nn.gelu defaults to the tanh approximation; so does this. Where
    ``spec`` splits the hidden dim over the model axis, the member's
    columns, its product summed over the axis."""
    dt = x.dtype
    split = model_split(spec, "wo")
    if split:
        x = dist.pvary(x)
    if cfg.activation in ("swiglu", "geglu"):
        g = x @ p.wi_gate.to(dt)
        u = x @ p.wi_up.to(dt)
        act = (F.silu(g) if cfg.activation == "swiglu"
               else F.gelu(g, approximate="tanh"))
        out = (act * u) @ p.wo.to(dt)
        return dist.psum_invariant(out) if split else out
    h = F.gelu(x @ p.wi.to(dt) + p.bi.to(dt), approximate="tanh")
    out = h @ p.wo.to(dt)
    return (dist.psum_invariant(out) if split else out) + p.bo.to(dt)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------


def init_embedding(gen: torch.Generator, cfg: ModelConfig):
    return ParamDict(table=_embed_init(gen, (cfg.vocab_size, cfg.d_model)))


def embedding_axes(cfg: ModelConfig):
    return {"table": ("vocab", "embed")}


def apply_embedding(p, cfg: ModelConfig, tokens, spec=None):
    """The table's rows in the compute dtype (gathered, then cast: the same
    values as the JAX package's cast of the whole table, then gather).
    Where ``spec`` splits the table's rows over the model axis, each
    member looks up the tokens it holds (zeros for the rest) and the rows
    are summed over the axis."""
    dt = getattr(torch, cfg.dtype)
    table = p.table
    if not model_split(spec, "table"):
        return table[tokens.long()].to(dt)
    v_loc = table.shape[0]
    rel = tokens.long() - dist.rank() * v_loc
    own = (rel >= 0) & (rel < v_loc)
    rows = table[rel.clamp(0, v_loc - 1)].to(dt)
    return dist.psum_invariant(torch.where(own[..., None], rows,
                                           torch.zeros((), dtype=dt,
                                                       device=rows.device)))
