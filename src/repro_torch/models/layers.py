"""Model-layer primitives of the dense and local-attention decoder LMs
(PyTorch counterpart of ``repro.models.layers``).

Plain functions over dicts of tensors, batch-first, with the reference's
names, params keys and (d_in, d_out) weight layout.  Random init draws
from an explicit ``torch.Generator`` on that generator's device.  This
slice carries norms, RoPE, GQA attention (full-sequence, cache fill and
one-token decode) and the four dense MLPs; MoE, conv1d, SSD and RG-LRU
come with ROADMAP A9's later part.

Where ``cfg.use_kernels`` is set, full-sequence self-attention goes
through the flash attention kernel (:mod:`repro_torch.kernels.attention`)
under exactly the reference's condition; everywhere else attention is the
plain PyTorch path below, which follows the reference's arithmetic:
products in the activation dtype, logits and softmax in float32, the
probabilities cast back to v's dtype before the product with v.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import attention as kattn

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
    return x.reshape(x.shape[:-1] + (n, dh))


def _gqa_repeat(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(..., S, Hk, Dh) -> (..., S, Hk*n_rep, Dh), each head n_rep times in
    a row (``jnp.repeat``'s order)."""
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=-2)


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
    """The reference's ``lax.scan`` over query blocks, as a loop."""
    sq = q.shape[-3]
    outs = []
    for i in range(0, sq, chunk):
        mi = None if mask is None else mask[i:i + chunk]
        outs.append(_attn_core_dense(q[..., i:i + chunk, :, :], k, v, mi,
                                     softcap))
    return torch.cat(outs, dim=-3)


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


def _project(x: torch.Tensor, w: torch.Tensor,
             b: Optional[torch.Tensor]) -> torch.Tensor:
    y = x @ w.to(x.dtype)
    return y if b is None else y + b.to(x.dtype)


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
        out = kattn.flash_attention(q, k, v, causal=True, window=window)
    else:
        if mask is None and kv is None:
            mask = causal_mask(x.shape[-2], x.shape[-2], window,
                               device=x.device)
        k = _gqa_repeat(k, nh // nkv)
        v = _gqa_repeat(v, nh // nkv)
        out = _attn_core(q, k, v, mask, cfg.attn_logit_softcap,
                         chunk_q=cfg.attn_chunk_q)
    out = out.reshape(out.shape[:-2] + (nh * dh,))
    return out @ p["wo"].to(x.dtype)


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
    out = out.reshape(out.shape[:-2] + (nh * dh,))
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
        h = F.silu(x @ p["wg"].to(x.dtype)) * (x @ p["wi"].to(x.dtype))
    elif cfg.mlp_variant == "geglu":
        h = _gelu(x @ p["wg"].to(x.dtype)) * (x @ p["wi"].to(x.dtype))
    elif cfg.mlp_variant == "relu2":
        h = torch.square(torch.relu(x @ p["wi"].to(x.dtype)))
    else:  # gelu
        h = _gelu(x @ p["wi"].to(x.dtype))
    return h @ p["wo"].to(x.dtype)
