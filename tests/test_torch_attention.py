"""The port's attention kernel wrapper on the CPU (its plain version)
against the JAX package's Pallas kernel in interpret mode, and the
wrapper's refusals.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances are the reference's own (``tests/test_kernels.py``): 2e-5 in
float32, 2e-2 in bfloat16, absolute and relative.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402

from repro_torch.kernels import attention as kattn  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:       # chip_smoke.py, at the repo's root
    sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

# the reference's sweep (b, s, hq, hk, d, block, causal, window), with its
# head dims raised to the kernel's smallest (32), plus D = 256
SWEEP = [
    (2, 64, 4, 2, 32, 16, True, None),
    (1, 48, 2, 1, 32, 16, True, 8),       # padded seq + sliding window
    (2, 32, 4, 4, 32, 32, False, None),   # bidirectional (encoder)
    (1, 128, 8, 2, 64, 32, True, None),
    (1, 40, 3, 1, 32, 16, True, 4),       # odd heads, non-divisible seq
    (1, 40, 2, 1, 256, 16, True, 8),      # gemma3's head dim
]
DTYPES = {"float32": (np.float32, torch.float32, 2e-5),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, 2e-2)}


def _qkv(seed, b, sq, sk, hq, hk, d, np_dtype):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32).astype(np_dtype)
            for shape in ((b, sq, hq, d), (b, sk, hk, d), (b, sk, hk, d))]


def _to_torch(a: np.ndarray, dtype) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy()).to(dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", SWEEP, ids=str)
def test_flash_attention_matches_pallas_interpret(case, dtype):
    b, s, hq, hk, d, blk, causal, window = case
    np_dt, dt, tol = DTYPES[dtype]
    q, k, v = _qkv(s + d, b, s, s, hq, hk, d, np_dt)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, window=window, block_q=blk, block_k=blk,
                  interpret=True)
    kattn.reset_launch_counts()
    got = kattn.flash_attention(_to_torch(q, dt), _to_torch(k, dt),
                                _to_torch(v, dt), causal=causal,
                                window=window)
    assert got.dtype == dt and tuple(got.shape) == q.shape
    assert kattn.launch_counts == {"flash_attention": 0}   # CPU: no launch
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _split3(x):
    """x (float32) cut by truncation into bf16 hi (x's top 8 significand
    bits), mid (the next 8, of x - hi) and lo (the rest), as float32
    tensors; asserts that each is a bf16 value and that they sum to x
    exactly where |x| >= 2^-110, where the terms stay normal (below it a
    subnormal term keeps fewer bits, and under 2^-133 is lost)."""
    rest, terms = x, []
    for _ in range(3):
        term = (rest.view(torch.int32) & -65536).view(torch.float32)
        assert torch.equal(term.to(torch.bfloat16).float(), term)
        rest = rest - term              # exact in float32
        terms.append(term)
    normal = x.abs() >= 2.0**-110
    assert not rest[normal].any() and bool((rest.abs() < 2.0**-133).all())
    assert torch.equal((terms[0] + terms[1] + terms[2])[normal], x[normal])
    return terms


def _mask(sq, sk, causal, window):
    qpos = torch.arange(sq)[:, None]
    kpos = torch.arange(sk)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    return mask


def _bf16_design(q, k, v, causal, window):
    """The bf16 kernel's arithmetic (csrc/flash_attention.cu) in plain
    torch: bf16 inputs upcast, each dot scaled by f32(log2(e)/sqrt(D)),
    softmax by exp2 with f32 statistics, then P split by truncation into
    bf16 hi (p's top 8 significand bits), mid (the next 8) and lo (the
    rest), which sum to p exactly, and three f32 products with V, as the
    tensor cores take them.  Returns that output (before the bf16 store)
    and the same with P in f32, both (B, Sq, Hq, D) float32."""
    n_rep = q.shape[2] // k.shape[2]
    qf = q.float()
    kf = k.float().repeat_interleave(n_rep, dim=2)
    vf = v.float().repeat_interleave(n_rep, dim=2)
    d = q.shape[-1]
    scale_log2 = torch.tensor(np.log2(np.e) / np.sqrt(d), dtype=torch.float32)
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale_log2
    mask = _mask(q.shape[1], k.shape[1], causal, window)
    logits = torch.where(mask, logits, -1e30)
    p = torch.exp2(logits - logits.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    split = 0
    for term in _split3(p):             # hi, mid, lo
        split = split + torch.einsum("bhqk,bkhd->bhqd", term, vf)
    split = split / l
    full = torch.einsum("bhqk,bkhd->bhqd", p, vf) / l
    return split.transpose(1, 2), full.transpose(1, 2)


@pytest.mark.parametrize("case", SWEEP, ids=str)
def test_bf16_design_matches_pallas_interpret(case):
    """The bf16 kernel's arithmetic, emulated, within the bf16 tolerance
    (2e-2) of the Pallas kernel in interpret mode; the three-term split of
    P is exact, and its three products cost at most 2^-15 of max |o|
    against one product with P in float32."""
    b, s, hq, hk, d, blk, causal, window = case
    np_dt, dt, tol = DTYPES["bfloat16"]
    q, k, v = _qkv(s + d, b, s, s, hq, hk, d, np_dt)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, window=window, block_q=blk, block_k=blk,
                  interpret=True)
    split, full = _bf16_design(_to_torch(q, dt), _to_torch(k, dt),
                               _to_torch(v, dt), causal, window)
    np.testing.assert_allclose(split.to(dt).float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)
    err = float((split - full).abs().max())
    assert err <= 2.0**-15 * float(full.abs().max()), err


# the plane pairs (i, j) the float32 kernel keeps, 0 hi, 1 mid, 2 lo: all
# with i + j <= 2, smallest first, as the kernel streams them
KEPT_PAIRS = ((0, 2), (1, 1), (0, 1), (2, 0), (1, 0), (0, 0))


def _f32_design(q, k, v, causal, window):
    """The float32 kernel's arithmetic (csrc/flash_attention.cu) in plain
    torch: q, k and v split by truncation into bf16 planes hi + mid + lo
    (exactly), S from the six kept plane products summed in float32
    (mid.lo, lo.mid and lo.lo dropped), scaled by f32(log2(e)/sqrt(D)),
    softmax by exp2 with f32 statistics, then P split into three bf16
    terms and the six kept products of P's terms with V's planes, over l.
    Returns (B, Sq, Hq, D) float32."""
    n_rep = q.shape[2] // k.shape[2]
    qs = _split3(q)
    ks = [t.repeat_interleave(n_rep, dim=2) for t in _split3(k)]
    vs = [t.repeat_interleave(n_rep, dim=2) for t in _split3(v)]
    d = q.shape[-1]
    scale_log2 = torch.tensor(np.log2(np.e) / np.sqrt(d), dtype=torch.float32)
    s = 0
    for i, j in KEPT_PAIRS:             # each product exact in float32
        s = s + torch.einsum("bqhd,bkhd->bhqk", qs[i], ks[j])
    logits = s * scale_log2
    mask = _mask(q.shape[1], k.shape[1], causal, window)
    logits = torch.where(mask, logits, -1e30)
    p = torch.exp2(logits - logits.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    ps = _split3(p)
    o = 0
    for i, j in KEPT_PAIRS:
        o = o + torch.einsum("bhqk,bkhd->bhqd", ps[i], vs[j])
    return (o / l).transpose(1, 2)


def _attention_f64(q, k, v, causal, window):
    """Softmax attention of the same inputs in float64."""
    n_rep = q.shape[2] // k.shape[2]
    qd = q.double()
    kd = k.double().repeat_interleave(n_rep, dim=2)
    vd = v.double().repeat_interleave(n_rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", qd, kd) / np.sqrt(q.shape[-1])
    mask = _mask(q.shape[1], k.shape[1], causal, window)
    p = torch.softmax(torch.where(mask, logits, -1e30), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vd)


# the float32 design against float64: max |o - o64| within this many
# 2^-24 of max |o64|.  Measured at most 2.9 over SWEEP, where
# attention_ref itself is 2.7-5.4 from float64: float32's rounding of the
# logits and the sums, beside which the dropped plane pairs (under 2^-21
# of a product, about 2^-26 on average) do not show.
F32_DESIGN_ULPS = 8


@pytest.mark.parametrize("case", SWEEP, ids=str)
def test_f32_design_matches_pallas_interpret(case):
    """The float32 kernel's arithmetic, emulated, within the float32
    tolerance (2e-5) of the Pallas kernel in interpret mode, and within
    F32_DESIGN_ULPS * 2^-24 of max |o| of the same attention in float64;
    the splits of q, k, v and P are exact."""
    b, s, hq, hk, d, blk, causal, window = case
    np_dt, dt, tol = DTYPES["float32"]
    q, k, v = _qkv(s + d, b, s, s, hq, hk, d, np_dt)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, window=window, block_q=blk, block_k=blk,
                  interpret=True)
    qt, kt, vt = (_to_torch(x, dt) for x in (q, k, v))
    got = _f32_design(qt, kt, vt, causal, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)
    exact = _attention_f64(qt, kt, vt, causal, window)
    err = float((got.double() - exact).abs().max())
    assert err <= F32_DESIGN_ULPS * 2.0**-24 * float(exact.abs().max()), err


# chip_smoke.py's float32 "rows" cases, as (B, S, S, Hq, Hk, D, causal,
# window)
SPREAD_ROWS = [c[:6] + c[7:9] for c in chip_smoke.ATTN_CASES
               if c[-1] == "rows"]


@pytest.mark.parametrize("case", SPREAD_ROWS, ids=str)
def test_f32_design_on_spread_rows(case):
    """chip_smoke.py's float32 "rows" cases: q, k and v scaled by
    logspace(*ATTN_ROWS) along the sequence.  There float32 attention_ref
    is itself within the float32 tolerance of the attention in float64,
    so the tolerance can hold a kernel; the emulated design is within it
    of both."""
    b, s, _, hq, hk, d, causal, window = case
    scale = np.logspace(*chip_smoke.ATTN_ROWS, s)[:, None, None]
    q, k, v = (torch.from_numpy((x * scale).astype(np.float32))
               for x in _qkv(s + d, b, s, s, hq, hk, d, np.float32))
    exact = _attention_f64(q, k, v, causal, window)
    plain = ref.attention_ref(q, k, v, causal=causal, window=window)
    got = _f32_design(q, k, v, causal, window)
    tol = DTYPES["float32"][2]
    np.testing.assert_allclose(plain.double().numpy(), exact.numpy(),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(got.double().numpy(), exact.numpy(),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=tol, rtol=tol)


@pytest.mark.parametrize("case", [
    (2, 24, 24, 4, 2, 32, True, None),
    (2, 24, 24, 4, 1, 32, True, 5),
    (1, 10, 33, 2, 2, 64, False, None),   # Sq != Sk, bidirectional
    (1, 33, 10, 4, 2, 32, False, 30),     # every query still sees a key
], ids=str)
def test_attention_ref_matches_reference_oracle(case):
    """The plain version (GQA repeat inside) against the JAX package's
    oracle (GQA repeat done by the caller), float32."""
    b, sq, sk, hq, hk, d, causal, window = case
    q, k, v = _qkv(sq * sk, b, sq, sk, hq, hk, d, np.float32)
    rep = hq // hk
    want = jref.attention_ref(jnp.asarray(q), jnp.repeat(k, rep, axis=2),
                              jnp.repeat(v, rep, axis=2), causal=causal,
                              window=window)
    got = ref.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=causal,
                            window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)


def _zeros(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("args,kw,err,match", [
    ((_zeros(1, 8, 2, 64, dtype=torch.float16),) * 3, {}, TypeError,
     "float32 or bfloat16"),
    ((_zeros(1, 8, 2, 64), _zeros(1, 8, 2, 64, dtype=torch.bfloat16),
      _zeros(1, 8, 2, 64, dtype=torch.bfloat16)), {}, TypeError, "one dtype"),
    ((_zeros(8, 2, 64),) * 3, {}, ValueError, "4-D"),
    ((_zeros(1, 8, 2, 48),) * 3, {}, ValueError, "head dim 48"),
    ((_zeros(1, 8, 3, 64), _zeros(1, 8, 2, 64), _zeros(1, 8, 2, 64)), {},
     ValueError, "multiple of"),
    ((_zeros(1, 8, 2, 64), _zeros(1, 9, 2, 64), _zeros(1, 9, 2, 64)), {},
     ValueError, "Sq == Sk"),
    ((_zeros(1, 20, 2, 64), _zeros(1, 9, 2, 64), _zeros(1, 9, 2, 64)),
     {"causal": False, "window": 11}, ValueError, "see no key"),
    ((_zeros(1, 8, 2, 64),) * 3, {"window": 0}, ValueError, "window"),
    ((_zeros(1, 8, 2, 64), _zeros(1, 8, 2, 64), _zeros(1, 7, 2, 64)), {},
     ValueError, r"\(B, Sk, Hk, D\)"),
    ((_zeros(1, 2, 8, 64).transpose(1, 2), _zeros(1, 8, 2, 64),
      _zeros(1, 8, 2, 64)), {}, ValueError, "contiguous"),
], ids=lambda x: x if isinstance(x, str) else "")
def test_flash_attention_refuses_what_it_does_not_take(args, kw, err, match):
    with pytest.raises(err, match=match):
        kattn.flash_attention(*args, **kw)
