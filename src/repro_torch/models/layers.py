"""Model-layer primitives of the decoder LMs (PyTorch counterpart of
``repro.models.layers``).

Plain functions over dicts of tensors, batch-first, with the reference's
names, params keys and (d_in, d_out) weight layout.  Random init draws
from an explicit ``torch.Generator`` on that generator's device.  This
module carries norms, RoPE, GQA attention (full-sequence, cache fill and
one-token decode), the four dense MLPs, the MoE layer (capacity dispatch
by one-hot einsums or by gathers, and every expert at decode), the
depthwise causal conv1d, the Mamba-2 SSD block and the Griffin RG-LRU
block.  The MoE's products stay plain PyTorch matmuls, as the reference's
stay XLA einsums outside any Pallas kernel.

Where ``cfg.use_kernels`` is set, the full-sequence forward goes through
the CUDA kernels under exactly the reference's conditions: self-attention
through flash attention (:mod:`repro_torch.kernels.attention`), the SSD
scan of ``ssd_apply`` through :mod:`repro_torch.kernels.ssd_scan` and the
RG-LRU recurrence of ``rglru_core`` through
:mod:`repro_torch.kernels.rglru_scan`.  Everywhere else the plain PyTorch
paths below follow the reference's arithmetic: attention's products in
the activation dtype, logits and softmax in float32, the probabilities
cast back to v's dtype before the product with v; the SSD scan in its
chunked dual form; the RG-LRU recurrence as a parallel prefix scan; and
the reference's float32 casts, one for one.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import (DTENSOR_FLATTENS_SHARDED, dtensor_of,
                                is_dtensor, uneven_split)
from repro_torch.kernels import attention as kattn
from repro_torch.kernels import rglru_scan as krg
from repro_torch.kernels import ssd_scan as kssd
from repro_torch.models.remat import checkpoint

Params = Dict[str, Any]


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name ("bfloat16", "float32")."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def normal(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    """float32 N(0, std^2) draws from ``gen``, on the generator's device."""
    return torch.randn(shape, generator=gen, device=gen.device) * std


# --------------------------------------------------------------------------
# initializers / norms
# --------------------------------------------------------------------------
def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype) -> torch.Tensor:
    return normal(gen, (d_in, d_out), 1.0 / math.sqrt(d_in)).to(
        torch_dtype(dtype))


def norm_init(d: int, cfg: ModelConfig, device=None) -> Params:
    dt = torch_dtype(cfg.param_dtype)
    p = {"scale": torch.ones((d,), dtype=dt, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dt, device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xf = x.to(torch.float32)
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    else:  # rmsnorm
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * p["scale"].to(torch.float32)
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: (..., S) integer.  The rotation runs
    in float32 (bf16 x times f32 cos/sin promotes, as in the reference)
    and the result is cast back to x's dtype."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)              # (half,)
    angles = positions[..., :, None].to(torch.float32) * freqs    # (..., S, half)
    cos = torch.cos(angles)[..., :, None, :]                      # (..., S, 1, half)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention (GQA, causal, optional sliding window)
# --------------------------------------------------------------------------
def attention_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, hq, hk = cfg.d_model, cfg.num_heads * cfg.d_head, cfg.num_kv_heads * cfg.d_head
    p = {
        "wq": dense_init(gen, d, hq, cfg.param_dtype),
        "wk": dense_init(gen, d, hk, cfg.param_dtype),
        "wv": dense_init(gen, d, hk, cfg.param_dtype),
        "wo": dense_init(gen, hq, d, cfg.param_dtype),
    }
    if cfg.qkv_bias:
        dt = torch_dtype(cfg.param_dtype)
        for name, n in (("bq", hq), ("bk", hk), ("bv", hk)):
            p[name] = torch.zeros((n,), dtype=dt, device=gen.device)
    return p


def _split_heads(x: torch.Tensor, n: int, dh: int) -> torch.Tensor:
    if uneven_split(x, -1, n):
        # DTensor's view rule refuses to split a shard unevenly (qwen2-0.5b's
        # 14 and 2 heads over 16 ranks); its split rule gathers the dim
        # first, as the reference's GSPMD inserts its own collectives here.
        # (A ``redistribute`` call cannot reach a DTensor inside vmap/grad.)
        return torch.stack(torch.split(x, dh, dim=-1), dim=-2)
    return x.reshape(x.shape[:-1] + (n, dh))


def _gqa_repeat(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(..., S, Hk, Dh) -> (..., S, Hk*n_rep, Dh), each head n_rep times in
    a row (``jnp.repeat``'s order)."""
    if n_rep == 1:
        return k
    if dtensor_of(k) is not None:
        return _RepeatHeads.apply(k, n_rep)
    return torch.repeat_interleave(k, n_rep, dim=-2)


class _RepeatHeads(torch.autograd.Function):
    """``repeat_interleave`` over the heads of a DTensor, whose backward
    sums each head's ``n_rep`` copies.  Autograd's own backward views the
    gradient's heads as ``(Hk, n_rep)``, which DTensor refuses when they
    are sharded over a mesh dim whose size does not divide ``Hk``
    (mixtral-8x22b's 48 heads over 16 ranks into 8 x 6); there this one
    takes split form, and DTensor's split rule gathers the heads first.
    Plain tensors never come here.  Under ``vmap`` the heads stay dim -2
    wherever the batch dim sits, so the generated rule serves."""
    generate_vmap_rule = True

    @staticmethod
    def forward(k, n_rep):
        return torch.repeat_interleave(k, n_rep, dim=-2)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.n_rep = inputs[1]

    @staticmethod
    def backward(ctx, g):
        n_rep = ctx.n_rep
        hk = g.shape[-2] // n_rep
        if uneven_split(g, -2, hk):
            return torch.stack([c.sum(-2) for c in
                                torch.split(g, n_rep, dim=-2)], dim=-2), None
        return g.unflatten(-2, (hk, n_rep)).sum(-2), None


_ATTN_CHUNK_Q = 512  # default q-block size for the memory-bounded path


def _attn_core(q, k, v, mask, softcap: Optional[float],
               chunk_q: int = _ATTN_CHUNK_Q) -> torch.Tensor:
    """q: (..., Sq, Hq, Dh); k,v: (..., Sk, Hq, Dh); mask: (..., Sq, Sk) bool.

    Long sequences take a q-chunked path so the materialized logits stay
    O(chunk * Sk) instead of O(Sq * Sk), under the reference's condition.
    """
    sq = q.shape[-3]
    if (sq > chunk_q and sq % chunk_q == 0
            and (mask is None or mask.ndim == 2)):
        return _attn_core_chunked(q, k, v, mask, softcap, chunk_q)
    return _attn_core_dense(q, k, v, mask, softcap)


def _attn_core_dense(q, k, v, mask, softcap: Optional[float]) -> torch.Tensor:
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("...qhd,...khd->...hqk", q, k).to(torch.float32) * scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    if mask is not None:
        logits = torch.where(mask[..., None, :, :], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("...hqk,...khd->...qhd", probs.to(v.dtype), v)


def _attn_core_chunked(q, k, v, mask, softcap, chunk: int) -> torch.Tensor:
    """The reference's ``lax.scan`` over query blocks, as a loop, each
    block's body rematerialized as the reference's ``@jax.checkpoint``
    on it: the backward runs a block again, so no block's (chunk x Sk)
    probabilities are kept for it."""
    sq = q.shape[-3]
    outs = []
    for i in range(0, sq, chunk):
        mi = None if mask is None else mask[i:i + chunk]
        outs.append(checkpoint(_attn_core_dense, q[..., i:i + chunk, :, :],
                               k, v, mi, softcap))
    return torch.cat(outs, dim=-3)


def _gqa_core(q, k, v, mask, *, n_rep: int, softcap: Optional[float],
              chunk_q: int) -> torch.Tensor:
    """The plain attention of q (..., Sq, Hq, Dh) over GQA k, v
    (..., Sk, Hq / n_rep, Dh)."""
    return _attn_core(q, _gqa_repeat(k, n_rep), _gqa_repeat(v, n_rep), mask,
                      softcap, chunk_q=chunk_q)


def _per_rank(fn, q, k, v, *rest) -> torch.Tensor:
    """``fn(q, k, v, *rest)``, an attention over (B, S, H, D) tensors.  On
    DTensors it runs on each rank's shards through ``local_map`` (the
    kernel's wrapper takes plain tensors, and DTensor's search for an
    einsum's strategy grows past minutes on a 3-D mesh): the shards are
    whole attention problems where q, k and v are sharded alike on the
    batch or the head dim (every rank's q heads then read its own kv
    heads); any other placement is replicated first.  ``rest`` (a mask)
    is plain."""
    if not is_dtensor(q):
        return fn(q, k, v, *rest)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    want = tuple(p if p == k.placements[i] == v.placements[i]
                 and any(p.is_shard(d) for d in (0, 2)) else Replicate()
                 for i, p in enumerate(q.placements))
    q, k, v = (t if t.placements == want else t.redistribute(mesh, want)
               for t in (q, k, v))
    return local_map(fn, out_placements=(want,), device_mesh=mesh,
                     in_placements=(want,) * 3 + (None,) * len(rest))(
        q, k, v, *rest)


def causal_mask(sq: int, sk: int, window: Optional[int] = None,
                q_offset: int = 0, device=None) -> torch.Tensor:
    """bool (sq, sk): True where attend. q position i attends k position j iff
    j <= i+q_offset and (window is None or i+q_offset - j < window)."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(sk, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m &= (qpos - kpos) < window
    return m


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``, ``w`` cast to ``x``'s dtype; inside :func:`token_first`,
    a DTensor ``x`` of 3 or more dims multiplied with its token dim
    first."""
    w = w.to(x.dtype)
    if _token_first and x.ndim >= 3 and dtensor_of(x) is not None:
        return (x.transpose(0, -2) @ w).transpose(0, -2)
    return x @ w


_token_first = False


@contextlib.contextmanager
def token_first():
    """For a program whose batch is sharded by sequence, on a torch whose
    DTensor cannot flatten a sharded inner dim: :func:`dense` puts the
    token dim first, so that neither its product nor the product's
    backward flattens (batch, token) with the token dim sharded (the
    gradient of a product's output comes back sharded like the residual
    stream, whatever its input was)."""
    global _token_first
    was, _token_first = _token_first, not DTENSOR_FLATTENS_SHARDED
    try:
        yield
    finally:
        _token_first = was


def _project(x: torch.Tensor, w: torch.Tensor,
             b: Optional[torch.Tensor]) -> torch.Tensor:
    y = dense(x, w)
    return y if b is None else y + _bias_beside(y, b.to(x.dtype))


def _bias_beside(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``b`` ready to add to ``y``: where ``y`` is a partial sum (a
    product over a sharded contraction dim) a DTensor bias sharded on the
    same mesh dim is replicated there first.  DTensor may otherwise plan
    to turn the shard into a partial sum, which torch 2.11 cannot run; a
    replicated bias becomes one without moving data.  Plain tensors (and
    DTensors under functorch's wrappers) come back as they are."""
    if not (is_dtensor(y) and is_dtensor(b)):
        return b
    from torch.distributed.tensor import Replicate
    want = [Replicate() if py.is_partial() and pb.is_shard() else pb
            for py, pb in zip(y.placements, b.placements)]
    return b if want == list(b.placements) else b.redistribute(
        b.device_mesh, want)


def attention_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor,
                    window: Optional[int] = None,
                    kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    mask: Optional[torch.Tensor] = None,
                    use_rope: bool = True) -> torch.Tensor:
    """Full-sequence attention (training / prefill).

    x: (B, S, D).  kv: optional precomputed (k, v) for cross-attention
    (already head-split, rope-free).  mask overrides the causal default.
    """
    nh, nkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.d_head
    explicit_mask = mask is not None
    bias = cfg.qkv_bias
    q = _split_heads(_project(x, p["wq"], p["bq"] if bias else None), nh, dh)
    if kv is None:
        k = _split_heads(_project(x, p["wk"], p["bk"] if bias else None),
                         nkv, dh)
        v = _split_heads(_project(x, p["wv"], p["bv"] if bias else None),
                         nkv, dh)
        if use_rope:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
    else:
        k, v = kv
        if use_rope:
            q = apply_rope(q, positions, cfg.rope_theta)
    if (cfg.use_kernels and kv is None and not explicit_mask
            and cfg.attn_logit_softcap is None and x.ndim == 3):
        out = _per_rank(functools.partial(
            kattn.flash_attention, causal=True, window=window), q, k, v)
    else:
        if mask is None and kv is None:
            mask = causal_mask(x.shape[-2], x.shape[-2], window,
                               device=x.device)
        out = _per_rank(functools.partial(
            _gqa_core, n_rep=nh // nkv, softcap=cfg.attn_logit_softcap,
            chunk_q=cfg.attn_chunk_q), q, k, v, mask)
    out = _merge_heads(out)
    return dense(out, p["wo"])


def _merge_heads(out: torch.Tensor) -> torch.Tensor:
    """(..., H, D) -> (..., H * D).  A DTensor sharded on D (a decode
    cache's head dim on 'model') is replicated there first: DTensor
    refuses to flatten across an inner sharded dim (torch 2.11); under
    functorch's wrappers, where nothing can be redistributed, the heads
    are concatenated instead, whose rule gathers the dim."""
    d = dtensor_of(out)
    if d is not None and any(p.is_shard(d.ndim - 1) for p in d.placements):
        if d is not out:
            return torch.cat(torch.unbind(out, dim=-2), dim=-1)
        from torch.distributed.tensor import Replicate
        out = out.redistribute(out.device_mesh, [
            Replicate() if p.is_shard(out.ndim - 1) else p
            for p in out.placements])
    return out.reshape(out.shape[:-2] + (out.shape[-2] * out.shape[-1],))


def attention_kv(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                 positions: Optional[torch.Tensor] = None,
                 use_rope: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project k,v (head-split, rope applied if requested) for cache fill."""
    nkv, dh = cfg.num_kv_heads, cfg.d_head
    bias = cfg.qkv_bias
    k = _split_heads(_project(x, p["wk"], p["bk"] if bias else None), nkv, dh)
    v = _split_heads(_project(x, p["wv"], p["bv"] if bias else None), nkv, dh)
    if use_rope:
        if positions is None:
            raise ValueError("attention_kv: positions are needed for RoPE")
        k = apply_rope(k, positions, cfg.rope_theta)
    return k, v


def attention_decode(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_positions: torch.Tensor, position: torch.Tensor,
                     use_rope: bool = True) -> torch.Tensor:
    """One-token decode. x: (B, 1, D); caches: (B, Sc, Hk, Dh);
    cache_positions: (B, Sc) integer with -1 for empty slots (masked out);
    position: (B,) current absolute position of the new token."""
    nh, nkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.d_head
    q = _split_heads(_project(x, p["wq"], p["bq"] if cfg.qkv_bias else None),
                     nh, dh)                                  # (B,1,Hq,Dh)
    if use_rope:
        q = apply_rope(q, position[..., None], cfg.rope_theta)
    k = _gqa_repeat(k_cache.to(x.dtype), nh // nkv)
    v = _gqa_repeat(v_cache.to(x.dtype), nh // nkv)
    mask = (cache_positions <= position[..., None]) & (cache_positions >= 0)
    out = _attn_core(q, k, v, mask[..., None, :], cfg.attn_logit_softcap)
    out = _merge_heads(out)
    return out @ p["wo"].to(x.dtype)


# --------------------------------------------------------------------------
# MLPs (swiglu / geglu / relu2 / gelu)
# --------------------------------------------------------------------------
def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation (torch's default
    is the erf form)."""
    return F.gelu(x, approximate="tanh")


def mlp_init(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None) -> Params:
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    if cfg.mlp_variant in ("swiglu", "geglu"):
        return {"wi": dense_init(gen, d, f, cfg.param_dtype),
                "wg": dense_init(gen, d, f, cfg.param_dtype),
                "wo": dense_init(gen, f, d, cfg.param_dtype)}
    return {"wi": dense_init(gen, d, f, cfg.param_dtype),
            "wo": dense_init(gen, f, d, cfg.param_dtype)}


def mlp_apply(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.mlp_variant == "swiglu":
        h = F.silu(dense(x, p["wg"])) * dense(x, p["wi"])
    elif cfg.mlp_variant == "geglu":
        h = _gelu(dense(x, p["wg"])) * dense(x, p["wi"])
    elif cfg.mlp_variant == "relu2":
        h = torch.square(torch.relu(dense(x, p["wi"])))
    else:  # gelu
        h = _gelu(dense(x, p["wi"]))
    return dense(h, p["wo"])


def _einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum``'s type rule: the operands are promoted to one dtype
    first (``torch.einsum`` refuses mixed dtypes)."""
    dt = functools.reduce(torch.promote_types, (o.dtype for o in ops))
    return torch.einsum(eq, *(o.to(dt) for o in ops))


# --------------------------------------------------------------------------
# MoE (GShard-style capacity dispatch; every expert at decode)
# --------------------------------------------------------------------------
def moe_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    dt = torch_dtype(cfg.param_dtype)
    p = {"router": dense_init(gen, d, e, "float32"),
         "wi": normal(gen, (e, d, f), 1.0 / math.sqrt(d)).to(dt),
         "wo": normal(gen, (e, f, d), 1.0 / math.sqrt(f)).to(dt)}
    if cfg.mlp_variant in ("swiglu", "geglu"):
        p["wg"] = normal(gen, (e, d, f), 1.0 / math.sqrt(d)).to(dt)
    return p


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a row of zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _route(p: Params, xt: torch.Tensor,
           k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router probabilities (T, E) in float32, and the top-k gates (T, k),
    renormalised, with their experts (T, k).  ``jax.lax.top_k`` orders by
    probability descending and, among equal ones, the lower expert first;
    ``torch.topk`` promises no order among ties, so the experts are chosen
    by a stable descending sort (the capacity order depends on it)."""
    probs = torch.softmax(xt.to(torch.float32) @ p["router"], dim=-1)
    gate_idx = torch.sort(probs, dim=-1, descending=True,
                          stable=True).indices[..., :k]
    gate_vals = torch.gather(probs, -1, gate_idx)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    return probs, gate_vals, gate_idx


def _expert_mlp(p: Params, xe: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """The experts' outputs: a gated MLP where the params hold ``wg``
    (swiglu, geglu), squared ReLU otherwise, as in the reference.  xe is
    (E, C, D), each expert's own tokens, or (T, D), the same tokens for
    every expert; either way (E, ., D) comes back, from batched matmuls
    over the experts that read the weights where they lie."""
    def proj(w):
        return torch.matmul(xe, w.to(xe.dtype))

    if "wg" in p:
        act = F.silu if cfg.mlp_variant == "swiglu" else _gelu
        h = act(proj(p["wg"])) * proj(p["wi"])
    else:
        h = torch.square(torch.relu(proj(p["wi"])))
    return torch.matmul(h, p["wo"].to(h.dtype))


def moe_apply(p: Params, x: torch.Tensor,
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-factor top-k MoE (GShard-style einsum dispatch).

    x: (B, S, D) -> (y, aux_loss).  Long inputs are cut into token groups
    of ``cfg.moe_group`` (capacity applies per group), where the reference
    runs ``lax.scan`` over them; aux is then the mean over groups."""
    b, s, d = x.shape
    t = b * s
    group = cfg.moe_group
    if t > group and t % group == 0:
        ys, auxes = zip(*(_moe_group(p, xg[0], cfg) for xg in torch.split(
            x.reshape(t // group, group, d), 1)))
        return torch.stack(ys).reshape(b, s, d), torch.stack(auxes).mean()
    y, aux = _moe_group(p, x.reshape(t, d), cfg)
    return y.reshape(b, s, d), aux


def _moe_group(p: Params, xt: torch.Tensor,
               cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    t = xt.shape[0]
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    cap = max(1, int(cfg.capacity_factor * t * k / e))
    probs, gate_vals, gate_idx = _route(p, xt, k)

    # load-balance aux loss (Switch): E * sum_e f_e * p_e
    me = probs.mean(0)                                             # (E,)
    ce = _one_hot(gate_idx.reshape(-1), e, torch.float32).sum(0) / (t * k)
    aux = e * torch.sum(me * ce) * cfg.router_aux_loss_coef

    # position of each (token, slot) within its expert's capacity buffer,
    # counted token-major, slot-minor; a slot at or past cap is dropped
    onehot = _one_hot(gate_idx, e, torch.int32)                    # (T, k, E)
    flat = onehot.reshape(t * k, e)
    pos_in_expert = (torch.cumsum(flat, dim=0) - flat).reshape(t, k, e)
    pos = (pos_in_expert * onehot).sum(-1)                         # (T, k)
    in_cap = (pos < cap) & (onehot.sum(-1) > 0)

    if cfg.moe_dispatch == "gather":
        return _moe_gather_path(p, xt, cfg, cap, gate_idx, gate_vals, pos,
                                in_cap), aux

    # dispatch tensor (T, E, C) one-hot; combine weights folded in
    dt = xt.dtype
    pos_oh = _one_hot(pos, cap, dt)                                # (T, k, C)
    disp = _einsum("tke,tkc->tec", (onehot * in_cap[..., None]).to(dt),
                   pos_oh)
    expert_in = _einsum("tec,td->ecd", disp, xt)                   # (E, C, D)
    expert_out = _expert_mlp(p, expert_in, cfg)                    # (E, C, D)
    # the reference's einsum "tec,tk,tke->tec": a token's k experts are
    # distinct, so each (t, e) meets one nonzero term and the product is
    # exact in any order
    gate_e = _einsum("tk,tke->te", gate_vals.to(dt), onehot.to(dt))
    y = _einsum("tec,ecd->td", disp * gate_e[..., None], expert_out)
    return y, aux


def _moe_gather_path(p: Params, xt: torch.Tensor, cfg: ModelConfig,
                     cap: int, gate_idx: torch.Tensor,
                     gate_vals: torch.Tensor, pos: torch.Tensor,
                     in_cap: torch.Tensor) -> torch.Tensor:
    """Index-based dispatch and combine (``cfg.moe_dispatch == "gather"``):
    an (E, C) slot -> token table and gathers in place of the two one-hot
    einsums; the same selection as the einsum path."""
    t, d = xt.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    flat_pos = torch.where(in_cap.reshape(-1), pos.reshape(-1), cap)
    flat_tok = torch.arange(t, device=xt.device).repeat_interleave(k)
    # slot -> token id (t is the padding token); the extra capacity column
    # takes the dropped assignments, the rest are unique
    slot_tok = torch.full((e * (cap + 1),), t, dtype=torch.long,
                          device=xt.device).scatter(
        0, gate_idx.reshape(-1) * (cap + 1) + flat_pos, flat_tok)
    slot_tok = slot_tok.reshape(e, cap + 1)[:, :cap]               # (E, C)
    xt_pad = torch.cat([xt, xt.new_zeros((1, d))])
    expert_in = xt_pad[slot_tok]                                   # (E, C, D)
    expert_out = _expert_mlp(p, expert_in, cfg)                    # (E, C, D)

    # combine: y[t] = sum_k gate[t,k] * expert_out[e(t,k), pos(t,k)]
    picked = expert_out[gate_idx, torch.clamp(pos, max=cap - 1)]   # (T, k, D)
    w = (gate_vals * in_cap).to(xt.dtype)                          # (T, k)
    return _einsum("tk,tkd->td", w, picked)


def moe_apply_dense(p: Params, x: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """All-expert weighted MoE for decode steps (few tokens, where capacity
    dispatch would drop some).  The expert products run as one batched
    matmul over experts, which reads the weights where they lie."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    xt = x.reshape(b * s, d)
    _, gate_vals, gate_idx = _route(p, xt, k)
    full_gates = torch.zeros((b * s, e), dtype=x.dtype,
                             device=x.device).scatter(
        1, gate_idx, gate_vals.to(x.dtype))
    yall = _expert_mlp(p, xt, cfg)                                 # (E, T, D)
    y = _einsum("te,etd->td", full_gates, yall)
    return y.reshape(b, s, d)


# --------------------------------------------------------------------------
# depthwise causal conv1d (shared by ssd / rglru)
# --------------------------------------------------------------------------
def conv1d_init(gen: torch.Generator, channels: int, width: int,
                dtype) -> Params:
    dt = torch_dtype(dtype)
    return {"w": normal(gen, (width, channels), 1.0 / math.sqrt(width)).to(dt),
            "b": torch.zeros((channels,), dtype=dt, device=gen.device)}


def conv1d_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C). Causal depthwise conv, width from params; the taps are
    added in the reference's order."""
    w = p["w"].to(x.dtype)
    width, s = w.shape[0], x.shape[-2]
    xpad = F.pad(x, (0, 0, width - 1, 0))
    out = xpad[..., 0:s, :] * w[0]
    for i in range(1, width):
        out = out + xpad[..., i:i + s, :] * w[i]
    return out + p["b"].to(x.dtype)


def conv1d_step(p: Params, buf: torch.Tensor,
                x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode step. buf: (B, width-1, C) past inputs; x: (B, C).  Returns
    (the new buffer, the output (B, C))."""
    w = p["w"].to(x.dtype)
    width = w.shape[0]
    window = torch.cat([buf, x[..., None, :]], dim=-2)         # (B, width, C)
    out = _einsum("...wc,wc->...c", window, w) + p["b"].to(x.dtype)
    return (window[..., -(width - 1):, :] if width > 1 else buf), out


def last_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """The last ``n`` positions of x (B, S, C), zero-padded in front when
    S < n: the conv buffer a prefill leaves for decode (a copy)."""
    s = x.shape[1]
    if s >= n:
        return x[:, s - n:].clone()
    return F.pad(x, (0, 0, n - s, 0))


# --------------------------------------------------------------------------
# Mamba-2 SSD block
# --------------------------------------------------------------------------
def ssd_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    nh = di // cfg.ssm_head_dim
    ns = cfg.ssm_state
    dev = gen.device
    f32 = torch.float32
    return {
        "in_proj": dense_init(gen, d, 2 * di + 2 * ns + nh, cfg.param_dtype),
        "conv": conv1d_init(gen, di + 2 * ns, cfg.ssm_conv_width,
                            cfg.param_dtype),
        "A_log": torch.zeros((nh,), dtype=f32, device=dev),
        "D": torch.ones((nh,), dtype=f32, device=dev),
        "dt_bias": torch.zeros((nh,), dtype=f32, device=dev),
        "out_norm": {"scale": torch.ones(
            (di,), dtype=torch_dtype(cfg.param_dtype), device=dev)},
        "out_proj": dense_init(gen, di, d, cfg.param_dtype),
    }


def _ssd_split(p: Params, x: torch.Tensor, cfg: ModelConfig):
    d = cfg.d_model
    di = cfg.ssm_expand * d
    ns = cfg.ssm_state
    nh = di // cfg.ssm_head_dim
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * ns, nh], dim=-1)
    return z, xbc, dt, di, ns, nh


def ssd_scan_ref(x, dt, A, B, C, chunk: int):
    """Chunked SSD, the model's default path (the reference's jnp
    ``ssd_scan_ref``, its ``lax.scan`` over chunks a loop).

    x: (Bt, S, H, P); dt: (Bt, S, H) (already softplus'ed, >=0);
    A: (H,) negative; B, C: (Bt, S, N); S a multiple of ``chunk``.
    Returns y: (Bt, S, H, P) in x's dtype and the final state
    (Bt, H, P, N) in float32.
    """
    bt, s, h, p = x.shape
    n = B.shape[-1]
    q = chunk
    assert s % q == 0, (s, q)
    nc = s // q
    xc = x.reshape(bt, nc, q, h, p)
    dtc = dt.reshape(bt, nc, q, h)
    Bc = B.reshape(bt, nc, q, n)
    Cc = C.reshape(bt, nc, q, n)

    dA = dtc * A                                       # (bt, nc, q, h) negative
    cum = torch.cumsum(dA, dim=2)                      # within-chunk cumsum
    # intra-chunk (dual quadratic form)
    lt = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (bt,nc,q_i,q_j,h)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    decay = torch.exp(torch.where(causal[None, None, :, :, None], lt,
                                  -math.inf))
    G = _einsum("bcin,bcjn->bcij", Cc, Bc)                # (bt,nc,q,q)
    M = G[..., None] * decay * dtc[:, :, None, :, :]      # (bt,nc,i,j,h)
    y_intra = _einsum("bcijh,bcjhp->bcihp", M, xc)

    # inter-chunk recurrence over states (dt and A are float32, so cum and
    # everything built on it are float32)
    chunk_decay = torch.exp(cum[:, :, -1])                # (bt,nc,h)
    # each chunk's state contribution: sum_j exp(sum_{k>j} dA) dt_j B_j x_j
    rev = torch.exp(cum[:, :, -1:, :] - cum)              # (bt,nc,q,h)
    state_chunk = _einsum("bcjhp,bcjn->bchpn",
                          (dtc * rev)[..., None] * xc, Bc)
    state = torch.zeros((bt, h, p, n), dtype=torch.float32, device=x.device)
    s_prevs = []                          # the state entering each chunk
    for c in range(nc):
        s_prevs.append(state)
        state = state * chunk_decay[:, c, :, None, None] + state_chunk[:, c]
    s_prev = torch.stack(s_prevs, 1)                      # (bt,nc,h,p,n)
    y_inter = _einsum("bcin,bchpn->bcihp", Cc, s_prev) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(bt, s, h, p)
    return y.to(x.dtype), state


def ssd_scan_padded(x, dt, A, B, C, chunk: int):
    """:func:`ssd_scan_ref` on inputs zero-padded along S to a multiple of
    ``chunk``, with y cut back to S (padded steps have dt = 0, so the
    final state is that of the real ones)."""
    s = x.shape[1]
    pad = (-s) % chunk
    if not pad:
        return ssd_scan_ref(x, dt, A, B, C, chunk)
    y, state = ssd_scan_ref(F.pad(x, (0, 0, 0, 0, 0, pad)),
                            F.pad(dt, (0, 0, 0, pad)), A,
                            F.pad(B, (0, 0, 0, pad)),
                            F.pad(C, (0, 0, 0, pad)), chunk)
    return y[:, :s], state


def gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """The SSD block's output norm: rmsnorm(y * silu(z)) in float32, cast
    to ``dtype``, times ``scale``."""
    yf = (y * F.silu(z)).to(torch.float32)
    ms = (yf ** 2).mean(-1, keepdim=True)
    return (yf * torch.rsqrt(ms + 1e-6)).to(dtype) * scale.to(dtype)


def ssd_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                use_kernels: bool):
    """The SSD block over a sequence x (B, S, D): (out (B, S, D), final
    SSM state or None, the pre-conv ``xbc`` a prefill keeps for its conv
    buffer).  With ``use_kernels`` and a 4-D head split the scan is the
    kernel's (no state comes back), else the chunked path, padded to the
    chunk."""
    z, xbc, dt, di, ns, nh = _ssd_split(p, x, cfg)
    xbc_conv = F.silu(conv1d_apply(p["conv"], xbc))
    xs, B, C = torch.split(xbc_conv, [di, ns, ns], dim=-1)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(xs.shape[:-1] + (nh, cfg.ssm_head_dim))
    if use_kernels and xh.ndim == 4:
        y, state = kssd.ssd_scan(xh, dt, A, B, C, chunk=cfg.ssm_chunk), None
    else:
        y, state = ssd_scan_padded(xh, dt, A, B, C, cfg.ssm_chunk)
    y = y + xh * p["D"][:, None].to(x.dtype)
    y = gated_rmsnorm(y.reshape(xs.shape), z, p["out_norm"]["scale"], x.dtype)
    return y @ p["out_proj"].to(x.dtype), state, xbc


def ssd_apply(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Training/prefill forward. x: (B, S, D) -> (B, S, D)."""
    return ssd_forward(p, x, cfg, cfg.use_kernels)[0]


def ssd_decode(p: Params, x: torch.Tensor, cfg: ModelConfig,
               state: Params) -> Tuple[torch.Tensor, Params]:
    """One-step decode. x: (B, 1, D); state: {'ssm': (B,H,P,N), 'conv':
    (B,w-1,C)}.  Returns (y (B, 1, D), the new state)."""
    z, xbc, dt, di, ns, nh = _ssd_split(p, x, cfg)
    conv_buf, xbc1 = conv1d_step(p["conv"], state["conv"], xbc[:, 0])
    xs, B, C = torch.split(F.silu(xbc1), [di, ns, ns], dim=-1)  # (B, di/ns)
    dt1 = F.softplus(dt[:, 0].to(torch.float32) + p["dt_bias"])  # (B,H)
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(xs.shape[:-1] + (nh, cfg.ssm_head_dim))       # (B,H,P)
    dA = torch.exp(dt1 * A)                                        # (B,H)
    s = state["ssm"] * dA[..., None, None] + _einsum(
        "bh,bn,bhp->bhpn", dt1.to(x.dtype), B, xh)
    y = _einsum("bn,bhpn->bhp", C, s) + xh * p["D"][:, None].to(x.dtype)
    y = gated_rmsnorm(y.reshape(x.shape[0], di), z[:, 0],
                      p["out_norm"]["scale"], x.dtype)
    y = (y @ p["out_proj"].to(x.dtype))[:, None, :]
    return y, {"ssm": s, "conv": conv_buf}


def ssd_init_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                   device=None) -> Params:
    di = cfg.ssm_expand * cfg.d_model
    nh = di // cfg.ssm_head_dim
    conv_dim = di + 2 * cfg.ssm_state
    return {"ssm": torch.zeros((batch, nh, cfg.ssm_head_dim, cfg.ssm_state),
                               dtype=dtype, device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim),
                                dtype=dtype, device=device)}


# --------------------------------------------------------------------------
# RG-LRU block (RecurrentGemma / Griffin)
# --------------------------------------------------------------------------
_RGLRU_C = 8.0


def rglru_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, w = cfg.d_model, cfg.rglru_width
    # Lambda init so that a = sigmoid(L)^c is in (0.9, 0.999)
    u = torch.rand((w,), generator=gen, device=gen.device) * 0.099 + 0.9
    root = u ** (1.0 / _RGLRU_C)
    lam = torch.log(root / (1 - root))
    return {
        "in_x": dense_init(gen, d, w, cfg.param_dtype),
        "in_gate": dense_init(gen, d, w, cfg.param_dtype),
        "conv": conv1d_init(gen, w, cfg.conv1d_width, cfg.param_dtype),
        "w_a": dense_init(gen, w, w, cfg.param_dtype),
        "w_i": dense_init(gen, w, w, cfg.param_dtype),
        "Lambda": lam.to(torch.float32),
        "out": dense_init(gen, w, d, cfg.param_dtype),
    }


def rglru_gates(p: Params,
                xs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """RG-LRU gate computation -> (a, b) of h_t = a_t h_{t-1} + b_t, both
    float32."""
    r = torch.sigmoid(xs @ p["w_a"].to(xs.dtype))          # recurrence gate
    i = torch.sigmoid(xs @ p["w_i"].to(xs.dtype))          # input gate
    # a_t = sigmoid(Lambda)^(c * r_t), computed in log space for stability
    log_a = _RGLRU_C * r.to(torch.float32) * F.logsigmoid(p["Lambda"])
    a = torch.exp(log_a)                                   # (B,S,W) in (0,1)
    gated = (i * xs).to(torch.float32)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * gated
    return a, b


def linear_scan(a: torch.Tensor,
                b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along axis -2 under (a1, b1) o (a2, b2) =
    (a1 a2, b1 a2 + b2), the reference's ``lax.associative_scan``: a
    Hillis-Steele doubling scan, log2(S) passes that each combine every
    position with the one ``d`` before it (d = 1, 2, 4, ...).  Returns the
    prefix products of a and the recurrence h_t = a_t h_{t-1} + b_t from
    h = 0."""
    s = a.shape[-2]
    d = 1
    while d < s:
        a_hi = a[..., d:, :]
        b = torch.cat([b[..., :d, :], b[..., :-d, :] * a_hi + b[..., d:, :]],
                      dim=-2)
        a = torch.cat([a[..., :d, :], a[..., :-d, :] * a_hi], dim=-2)
        d *= 2
    return a, b


def rglru_core(p: Params, xs: torch.Tensor,
               h0: Optional[torch.Tensor] = None,
               use_kernels: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU recurrence. xs: (B, S, W) -> (ys in xs's dtype, h_final
    in float32)."""
    a, b = rglru_gates(p, xs)
    if use_kernels and h0 is None and xs.ndim == 3:
        bb = krg.rglru_scan(a, b)
        return bb.to(xs.dtype), bb[..., -1, :]
    aa, bb = linear_scan(a, b)
    if h0 is not None:
        bb = bb + aa * h0[..., None, :].to(torch.float32)
    return bb.to(xs.dtype), bb[..., -1, :]


def rglru_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  use_kernels: bool):
    """The RG-LRU block over a sequence x (B, S, D): (out (B, S, D), the
    final h, the pre-conv inputs a prefill keeps for its conv buffer)."""
    xs_pre = x @ p["in_x"].to(x.dtype)
    gate = _gelu(x @ p["in_gate"].to(x.dtype))
    xs = conv1d_apply(p["conv"], xs_pre)
    ys, h_final = rglru_core(p, xs, use_kernels=use_kernels)
    return (ys * gate) @ p["out"].to(x.dtype), h_final, xs_pre


def rglru_apply(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Training/prefill. x: (B, S, D)."""
    return rglru_forward(p, x, cfg, cfg.use_kernels)[0]


def rglru_decode(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 state: Params) -> Tuple[torch.Tensor, Params]:
    """x: (B, 1, D); state: {'h': (B, W), 'conv': (B, w-1, W)}."""
    xs = x[:, 0] @ p["in_x"].to(x.dtype)
    gate = _gelu(x[:, 0] @ p["in_gate"].to(x.dtype))
    conv_buf, xs = conv1d_step(p["conv"], state["conv"], xs)
    a, b = rglru_gates(p, xs)
    h = a * state["h"].to(torch.float32) + b
    y = (h.to(x.dtype) * gate) @ p["out"].to(x.dtype)
    return y[:, None, :], {"h": h, "conv": conv_buf}


def rglru_init_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device=None) -> Params:
    w = cfg.rglru_width
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv1d_width - 1, w),
                                dtype=dtype, device=device)}
