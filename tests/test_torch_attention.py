"""The port's attention kernel wrapper on the CPU (its plain version)
against the JAX package's Pallas kernel in interpret mode, and the
wrapper's refusals.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances are the reference's own (``tests/test_kernels.py``): 2e-5 in
float32, 2e-2 in bfloat16, absolute and relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402

from repro_torch.kernels import attention as kattn  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

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
