"""Plain PyTorch versions of the port's kernels (PyTorch counterpart of
``repro.kernels.ref``).

They run on any device.  The kernel wrappers in
:mod:`repro_torch.kernels.comms`, :mod:`repro_torch.kernels.attention`,
:mod:`repro_torch.kernels.ssd_scan` and :mod:`repro_torch.kernels.rglru_scan`
use them for CPU tensors, the CPU tests hold them against the JAX
package, and ``chip_smoke.py`` holds each CUDA kernel against them on the
card: the codecs and the top-k decode-reduce bitwise (the latter with
distinct indices in each member, see :func:`topk_reduce_ref`), attention
and the two scans to a tolerance (see
:func:`attention_ref`, :func:`ssd_ref`, :func:`rglru_ref`).  Every
operation of the codecs' versions is chosen so that CPU, card and the
jitted reference round identically:

* Rounding rule: ``torch.round`` rounds half to even, like ``jnp.round``.
* Division rule: the int8 scale is ``amax * f32(1/127)`` (XLA's folded
  form of ``amax / 127``, see :func:`repro_torch.device.recip_f32`), and
  ``inv`` is a true division ``1 / scale``, then ``x * inv`` — never
  ``x / scale``.  The sign scale divides the block's sum by its real
  count held in a TENSOR on the input's device: PyTorch's CUDA ``x / c``
  with a Python-float ``c`` multiplies by the reciprocal, while a division
  by a device tensor is an IEEE division on CPU and card alike, as the
  Pallas kernel's division by a loaded value is.
* Summation rule: the sign scale is ``mean|x|``, a float sum, so its bits
  depend on the order of the adds.  The port fixes one order on every
  device: zero-pad each block to the next power of two ``P``, then sum
  ``|x|`` by the halving tree ``w = P; while w > 1: w //= 2;
  s = s[..., :w] + s[..., w:2*w]`` (element i with element i + w at every
  level).  ``csrc/sign_codec.cu`` adds the same pairs.  XLA sums in
  another order, so the scales agree with the JAX package only to a few
  ulp.
* Bit rule: bit k of byte j is ``x[8j+k] >= 0``, least significant bit
  first; -0.0 counts as +, NaN as -, and the zero padding of a ragged
  last block as + (the reference ships those bytes too).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import recip_f32

INV127 = recip_f32(127.0)
_SHIFT8 = tuple(range(8))


def _blocked(x: torch.Tensor, block: int) -> Tuple[torch.Tensor, int]:
    """(R, C) -> (R, nb, block) zero-padded float32 view, plus nb."""
    r, c = x.shape
    nb = -(-c // block)
    xp = F.pad(x.to(torch.float32), (0, nb * block - c))
    return xp.reshape(r, nb, block), nb


def _inv(scale: torch.Tensor) -> torch.Tensor:
    """1/scale by true division, 0 where the scale is 0 (q = 0 there)."""
    inv = torch.ones_like(scale) / scale
    return torch.where(scale > 0, inv, torch.zeros_like(scale))


def int8_ref(x: torch.Tensor, block: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-block max-scale int8: (q int8 (R, C), scale f32 (R, nb),
    roundtrip f32 (R, C))."""
    r, c = x.shape
    xb, nb = _blocked(x, block)
    scale = xb.abs().amax(dim=-1) * INV127                     # (R, nb)
    q = torch.clamp(torch.round(xb * _inv(scale)[..., None]), -127, 127)
    rt = (q * scale[..., None]).reshape(r, nb * block)[:, :c]
    q = q.to(torch.int8).reshape(r, nb * block)[:, :c]
    return q.contiguous(), scale, rt.contiguous()


def int8_dequant_ref(q: torch.Tensor, scale: torch.Tensor,
                     block: int) -> torch.Tensor:
    """``q * scale`` per block: (R, C) int8 and (R, nb) f32 -> (R, C) f32."""
    r, c = q.shape
    qb, nb = _blocked(q, block)
    y = (qb * scale[..., None]).reshape(r, nb * block)[:, :c]
    return y.contiguous()


def int8_scale_quant_ref(x: torch.Tensor, scale: torch.Tensor,
                         block: int) -> torch.Tensor:
    """Shared-scale int8: q = clip(round(x * (1/scale))) per block, with a
    zero scale mapping to q = 0."""
    r, c = x.shape
    xb, nb = _blocked(x, block)
    q = torch.clamp(torch.round(xb * _inv(scale)[..., None]), -127, 127)
    return q.to(torch.int8).reshape(r, nb * block)[:, :c].contiguous()


def _pow2(n: int) -> int:
    """The least power of two >= n."""
    return 1 << (int(n) - 1).bit_length()


def _sign_counts(cols: int, block: int, device) -> torch.Tensor:
    """(nb,) f32 tensor: the real entries of each block (the last may be
    ragged) — the divisor of the block mean, on ``device``."""
    nb = -(-cols // block)
    counts = torch.full((nb,), float(block), dtype=torch.float32,
                        device=device)
    if nb:
        counts[-1] = float(cols - (nb - 1) * block)
    return counts


def sign_pack_ref(x: torch.Tensor, block: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-bit signs and block mean magnitudes: (bits uint8
    (R, nb*block/8), scale f32 (R, nb)), by the bit, summation and
    division rules above."""
    r, c = x.shape
    xb, nb = _blocked(x, block)                                # (R, nb, B)
    p = _pow2(block)
    s = F.pad(xb.abs(), (0, p - block))
    w = p
    while w > 1:
        w //= 2
        s = s[..., :w] + s[..., w:2 * w]
    scale = s[..., 0] / _sign_counts(c, block, x.device)
    shift = torch.tensor(_SHIFT8, dtype=torch.int32, device=x.device)
    bits = (xb >= 0).to(torch.int32).reshape(r, nb * block // 8, 8)
    packed = (bits << shift).sum(dim=-1, dtype=torch.int32)
    return packed.to(torch.uint8), scale


def sign_unpack_ref(bits: torch.Tensor, scale: torch.Tensor, size: int,
                    block: int) -> torch.Tensor:
    """``(2*bit - 1) * scale`` per element: (R, nb*block/8) uint8 and
    (R, nb) f32 -> (R, size) f32."""
    r = bits.shape[0]
    nb = -(-size // block)
    shift = torch.tensor(_SHIFT8, dtype=torch.int32, device=bits.device)
    b = (bits.to(torch.int32)[..., None] >> shift) & 1
    sgn = b.reshape(r, nb, block).to(torch.float32) * 2.0 - 1.0
    y = (sgn * scale[..., None]).reshape(r, nb * block)[:, :size]
    return y.contiguous()


def topk_reduce_ref(vals: torch.Tensor, idx: torch.Tensor,
                    size: int) -> torch.Tensor:
    """Scatter-sum of M top-k payloads, (M, K) f32 values at (M, K) int32
    indices, into one dense (size,) f32 buffer, by the order rule: starting
    from zeros, one ``index_add_`` per member, in member order, which is the
    order of the reference's ``zeros().at[idx.ravel()].add(...)`` on the
    CPU.  Indices outside [0, size) are dropped, as the Pallas kernel drops
    them (here: an add of +0.0 at index 0, which changes no value; the
    reference's jnp oracle would wrap a negative index, numpy style)."""
    out = torch.zeros((int(size),), dtype=torch.float32, device=vals.device)
    for m in range(vals.shape[0] if size else 0):
        i = idx[m].long()
        ok = (i >= 0) & (i < size)
        out.index_add_(0, torch.where(ok, i, 0),
                       torch.where(ok, vals[m].to(torch.float32), 0.0))
    return out


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """Softmax attention, the plain version of the flash attention kernel.

    q (B, Sq, Hq, D); k, v (B, Sk, Hk, D) with Hq % Hk == 0: query head h
    reads key/value head h // (Hq/Hk) (``repeat_interleave``, which is
    ``jnp.repeat``'s order).  Key j is visible to query i iff j <= i when
    ``causal`` and i - j < ``window`` when windowed, positions counting from
    0 on both sides; other logits are -1e30.  All arithmetic is float32
    (logits scaled by f32(1/sqrt(D)), softmax, the product with v); the
    result comes back in q's dtype.  The kernel sums in another order, so
    the two agree to a tolerance, not bitwise."""
    n_rep = q.shape[2] // k.shape[2]
    qf = q.to(torch.float32)
    kf = k.to(torch.float32).repeat_interleave(n_rep, dim=2)
    vf = v.to(torch.float32).repeat_interleave(n_rep, dim=2)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    sq, sk = q.shape[1], k.shape[1]
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD recurrence step by step, the plain version of the SSD scan
    kernel.

    x (Bt, S, H, P); dt (Bt, S, H) >= 0; A (H,) negative; B, C (Bt, S, N).
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t and y_t = C_t . h_t, in
    float32 from a zero state.  Returns y (Bt, S, H, P) in x's dtype and
    the final state (Bt, H, P, N) in float32.  Inputs may be strided views.
    The kernel takes the chunked (dual) form, which sums in another order,
    so the two agree to a tolerance, not bitwise."""
    bt, s, h, p = x.shape
    n = B.shape[-1]
    xf, dtf = x.to(torch.float32), dt.to(torch.float32)
    Af = A.to(torch.float32)
    Bf, Cf = B.to(torch.float32), C.to(torch.float32)
    state = torch.zeros((bt, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        dA = torch.exp(dtf[:, t] * Af)                              # (Bt, H)
        state = state * dA[..., None, None] + torch.einsum(
            "bh,bn,bhp->bhpn", dtf[:, t], Bf[:, t], xf[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", Cf[:, t], state))
    y = torch.stack(ys, 1) if ys else xf.new_zeros((bt, 0, h, p))
    return y.to(x.dtype), state


def rglru_ref(a: torch.Tensor, b: torch.Tensor,
              h0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The linear recurrence h_t = a_t h_{t-1} + b_t step by step, the plain
    version of the RG-LRU scan kernel.  a, b (Bt, S, W); h0 (Bt, W) or a
    zero start.  Returns (h_1..h_S (Bt, S, W), h_S), both float32."""
    af, bf = a.to(torch.float32), b.to(torch.float32)
    h = torch.zeros((a.shape[0], a.shape[-1]), dtype=torch.float32,
                    device=a.device) if h0 is None else h0.to(torch.float32)
    hs = []
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        hs.append(h)
    out = torch.stack(hs, 1) if hs else af.new_zeros(af.shape)
    return out, h
