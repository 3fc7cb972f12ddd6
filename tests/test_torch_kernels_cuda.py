"""The port's CUDA kernels against their plain PyTorch versions: the
codecs and the top-k decode-reduce bitwise (distinct indices in each
member; 1e-6 where they repeat), attention and the SSD and RG-LRU scans to
the reference's tolerances.

Marked ``gpu``: a CUDA kernel has no CPU mode, so these tests skip without
a card.  The file imports no JAX, so it also runs where only PyTorch is
installed; ``tests/conftest.py`` imports JAX, so run it there with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_kernels_cuda.py
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:       # chip_smoke.py, at the repo's root
    sys.path.insert(0, str(ROOT))

from chip_smoke import ATTN_ROWS  # noqa: E402
from repro_torch.kernels import comms as kern  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

COLS = (1, 255, 256, 257, 2120, 2123)   # 2123: rows misaligned for float4
BLOCKS = (64, 256, 100)
# sign: 1000 is no power of two, 24/8 = 3 bytes is no multiple of 4
SIGN_COLS = (1, 7, 1023, 1024, 1025, 2120, 2123)
SIGN_BLOCKS = (24, 64, 1000, 1024)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _payload(seed: int, rows: int, cols: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, cols))
         * np.logspace(-3, 1, rows)[:, None]).astype(np.float32)
    x[-1] = 0.0
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("cols", COLS)
def test_kernels_match_plain_versions(cuda, cols, block):
    x = torch.from_numpy(_payload(cols + block, 6, cols)).to(cuda)
    kern.reset_launch_counts()
    q, s = kern.int8_quantize(x, block=block)
    y = kern.int8_dequantize(q, s, block=block)
    group = s.amax(0, keepdim=True).expand_as(s).contiguous()
    group[-2] *= 0.5                                  # saturates at +-127
    g = kern.int8_scale_quantize(x, group, block=block)
    torch.cuda.synchronize()
    q_p, s_p, _ = ref.int8_ref(x, block)
    assert torch.equal(q, q_p) and torch.equal(s, s_p)
    assert torch.equal(y, ref.int8_dequant_ref(q, s, block))
    assert torch.equal(g, ref.int8_scale_quant_ref(x, group, block))
    assert kern.launch_counts == {"int8_quantize": 1, "int8_dequantize": 1,
                                  "int8_scale_quantize": 1, "sign_pack": 0,
                                  "sign_unpack": 0, "topk_decode_reduce": 0}


@pytest.mark.gpu
def test_kernels_refuse_mixed_devices(cuda):
    x = torch.zeros((2, 300), device=cuda)
    with pytest.raises(ValueError, match="different devices"):
        kern.int8_scale_quantize(x, torch.zeros((2, 2)))


def _sign_payload(seed: int, rows: int, cols: int) -> torch.Tensor:
    """Rows at magnitudes from 1e-3 to 10, the last one all zero, and a
    -0.0 in every other row."""
    x = _payload(seed, rows, cols)
    x[:-1, ::5] = -0.0
    return torch.from_numpy(x)


@pytest.mark.gpu
@pytest.mark.parametrize("block", SIGN_BLOCKS)
@pytest.mark.parametrize("cols", SIGN_COLS)
def test_sign_kernels_match_plain_versions(cuda, cols, block):
    x = _sign_payload(cols + block, 6, cols).to(cuda)
    kern.reset_launch_counts()
    bits, scale = kern.sign_pack(x, block=block)
    y = kern.sign_unpack(bits, scale, size=cols, block=block)
    torch.cuda.synchronize()
    b_p, s_p = ref.sign_pack_ref(x, block)
    assert torch.equal(bits, b_p) and torch.equal(scale, s_p)
    assert torch.equal(y, ref.sign_unpack_ref(bits, scale, cols, block))
    signs = np.unpackbits(bits.cpu().numpy(), axis=1, bitorder="little")
    assert signs[:, cols:].all()          # the padded tail packs as +
    assert signs[:-1, :cols:5].all()      # -0.0 packs as +
    assert signs[-1].all() and not scale[-1].any()    # all-zero row
    assert kern.launch_counts == {"int8_quantize": 0, "int8_dequantize": 0,
                                  "int8_scale_quantize": 0, "sign_pack": 1,
                                  "sign_unpack": 1, "topk_decode_reduce": 0}


@pytest.mark.gpu
def test_sign_kernels_at_a_large_shape(cuda):
    """The kernel phase's large shape, ragged and misaligned for float4."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((8, 2**24 + 77), generator=gen, device=cuda)
    x[-1] = 0.0
    bits, scale = kern.sign_pack(x, block=1024)
    y = kern.sign_unpack(bits, scale, size=x.shape[1], block=1024)
    torch.cuda.synchronize()
    b_p, s_p = ref.sign_pack_ref(x, 1024)
    assert torch.equal(bits, b_p) and torch.equal(scale, s_p)
    assert torch.equal(y, ref.sign_unpack_ref(bits, scale, x.shape[1], 1024))


# top-k decode-reduce: (M, K, size), the kernel phase's cases of
# chip_smoke.py short of its timing shape, plus an empty payload
TOPK_CASES = [(8, 530, 2120), (4, 530, 2120), (8, 132, 2120), (1, 1, 7),
              (16, 15, 244), (8, 4, 100), (3, 0, 10)]
# the kernel's tiling edges (tiles of 2**14 floats): just above one tile,
# no multiple of it, K = 0 above one tile, past the payloads that one CTA
# takes whole (more than 2**18 entries into one tile), and past the 2**14
# tiles whose counts fit shared memory
TOPK_EDGES = [(4, 3000, 2**14 + 1), (8, 5000, 100003), (3, 0, 100000),
              (17, 2**14, 2**14), (2, 1000, 2**28 + 5)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", TOPK_CASES, ids=str)
def test_topk_decode_reduce_matches_plain_version(cuda, case):
    m, k, size = case
    gen = torch.Generator(device=cuda).manual_seed(m * k + size)
    vals = torch.randn((m, k), generator=gen, device=cuda)
    vals[0] = 0.0                                    # a masked member
    idx = torch.stack([torch.randperm(size, generator=gen, device=cuda)[:k]
                       for _ in range(m)]).to(torch.int32)
    kern.reset_launch_counts()
    out = kern.topk_decode_reduce(vals, idx, size=size)
    torch.cuda.synchronize()
    assert kern.launch_counts["topk_decode_reduce"] == 1
    assert torch.equal(out, ref.topk_reduce_ref(vals, idx, size))
    assert torch.equal(kern.topk_decode_reduce(vals, idx, size=size), out)
    rep = torch.randint(0, size, (m, k), generator=gen, device=cuda,
                        dtype=torch.int32)
    torch.testing.assert_close(kern.topk_decode_reduce(vals, rep, size=size),
                               ref.topk_reduce_ref(vals, rep, size),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("case", TOPK_EDGES, ids=str)
def test_topk_decode_reduce_tiling_edges(cuda, case):
    """Bit for bit with distinct indices in each member, and the same on a
    second call.  With indices repeated within members each output is a
    sum of about M*K/size terms taken in another order than the plain
    version's, so both are held to the float32 summation bound against the
    exact (float64) sum: |error| <= n * 2**-24 * sum |v| per element, n
    its number of terms."""
    m, k, size = case
    gen = torch.Generator(device=cuda).manual_seed(m * k + size)
    vals = torch.randn((m, k), generator=gen, device=cuda)
    idx = torch.stack([torch.randperm(size, generator=gen, device=cuda)[:k]
                       for _ in range(m)]).to(torch.int32)
    kern.reset_launch_counts()
    out = kern.topk_decode_reduce(vals, idx, size=size)
    torch.cuda.synchronize()
    assert kern.launch_counts["topk_decode_reduce"] == 1
    assert torch.equal(out, ref.topk_reduce_ref(vals, idx, size))
    assert torch.equal(kern.topk_decode_reduce(vals, idx, size=size), out)
    rep = torch.randint(0, size, (m, k), generator=gen, device=cuda,
                        dtype=torch.int32).reshape(-1).long()
    flat = vals.reshape(-1)
    exact = torch.zeros(size, dtype=torch.float64, device=cuda).index_add_(
        0, rep, flat.double())
    terms = torch.zeros(size, dtype=torch.float64, device=cuda).index_add_(
        0, rep, torch.ones_like(flat, dtype=torch.float64))
    mass = torch.zeros(size, dtype=torch.float64, device=cuda).index_add_(
        0, rep, flat.double().abs())
    bound = terms * 2.0**-24 * mass
    rep32 = rep.to(torch.int32).reshape(m, k)
    for got in (kern.topk_decode_reduce(vals, rep32, size=size),
                ref.topk_reduce_ref(vals, rep32, size)):
        assert bool(((got.double() - exact).abs() <= bound).all())


@pytest.mark.gpu
def test_topk_decode_reduce_drops_indices_out_of_range(cuda):
    """Indices below 0 and at or past size (every third entry each) are
    dropped, as by the plain version, over 21 tiles."""
    m, k, size = 2, 40000, 20 * 2**14 + 3
    gen = torch.Generator(device=cuda).manual_seed(11)
    vals = torch.randn((m, k), generator=gen, device=cuda)
    idx = torch.stack([torch.randperm(size, generator=gen, device=cuda)[:k]
                       for _ in range(m)]).to(torch.int32)
    idx[:, 0::3] = -1 - idx[:, 0::3]
    idx[:, 1::3] += size
    out = kern.topk_decode_reduce(vals, idx, size=size)
    assert torch.equal(out, ref.topk_reduce_ref(vals, idx, size))
    assert int((out != 0).sum()) <= m * (k // 3 + 1)


# flash attention: (B, Sq, Sk, Hq, Hk, D, dtype, causal, window), the
# kernel phase's cases of chip_smoke.py
ATTN_CASES = [
    (8, 1024, 1024, 14, 2, 64, "bfloat16", True, None),    # qwen2 prefill
    (1, 2048, 2048, 16, 8, 256, "bfloat16", True, 1024),   # gemma3 local
    (8, 1024, 1024, 10, 1, 256, "bfloat16", True, 2048),   # recurrentgemma
    # olmoe-1b-7b's heads (16 over 16 of 128), seamless-m4t-large-v2's
    # decoder (16 over 16 of 64), mixtral-8x22b's (48 over 8 of 128) with
    # a window shorter than S
    (2, 1024, 1024, 16, 16, 128, "bfloat16", True, None),
    (2, 1024, 1024, 16, 16, 128, "float32", True, None),
    (2, 300, 300, 16, 16, 64, "float32", True, None),
    (1, 1100, 1100, 48, 8, 128, "bfloat16", True, 700),
    (1, 1100, 1100, 48, 8, 128, "float32", True, 700),
    *[(2, 300, 300, 4, 2, d, "float32", True, None)
      for d in (32, 64, 96, 128, 192, 256)],
    *[(2, 300, 300, 4, 2, d, "bfloat16", True, None) for d in (32, 192)],
    (1, 40, 40, 3, 1, 32, "bfloat16", True, 4),            # ragged S
    (2, 100, 260, 4, 2, 64, "bfloat16", False, None),      # Sq != Sk
    (1, 40, 40, 3, 1, 32, "float32", True, 4),             # ragged S
    (2, 1000, 1000, 4, 2, 64, "float32", True, None),      # ragged S
    (2, 100, 260, 4, 2, 64, "float32", False, None),       # Sq != Sk
    (2, 100, 260, 4, 2, 128, "bfloat16", False, None),
    (1, 200, 200, 4, 2, 128, "float32", True, 512),        # window > S
    (2, 130, 130, 4, 4, 96, "float32", True, None),        # Hq == Hk
    (2, 130, 130, 4, 4, 96, "bfloat16", True, 16),
    # rows of widely spread magnitude: q, k and v scaled by
    # logspace(*ATTN_ROWS) along the sequence
    (2, 300, 300, 4, 2, 64, "float32", True, None, "rows"),
    (1, 256, 256, 4, 2, 256, "float32", True, 100, "rows"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_flash_attention_matches_plain_version(cuda, case):
    from repro_torch.kernels import attention as kattn
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b, sq, sk, hq, hk, d, dtype, causal, window, *rows = case
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(sq + d)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device=cuda)
               for s, h in ((sq, hq), (sk, hk), (sk, hk)))
    if rows:
        q, k, v = (x * torch.logspace(*ATTN_ROWS, x.shape[1],
                                      device=cuda)[:, None, None]
                   for x in (q, k, v))
    q, k, v = (x.to(dt) for x in (q, k, v))
    kattn.reset_launch_counts()
    out = kattn.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert kattn.launch_counts == {"flash_attention": 1}
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    tol = 2e-5 if dt == torch.float32 else 2e-2
    assert out.dtype == dt and out.shape == q.shape
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
def test_flash_attention_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels import attention as kattn
    q = torch.zeros((1, 8, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="different devices"):
        kattn.flash_attention(q, q.cpu(), q.cpu())
    with pytest.raises(ValueError, match="16-byte"):
        flat = torch.zeros(1 + q.numel(), device=cuda)
        qm = flat[1:].view(q.shape)
        kattn.flash_attention(qm, q, q)


# SSD scan: (Bt, S, H, P, N, chunk), the reference's sweep
# (tests/test_kernels.py), the kernel phase's full-width shape of
# chip_smoke.py (mamba2-130m's forward, 8 x 1024) and the edges of the
# kernel's chunk-parallel passes at full width
SSD_CASES = [
    (2, 32, 4, 8, 16, 8),
    (1, 40, 2, 16, 8, 16),    # padded
    (2, 64, 3, 8, 4, 64),     # single chunk
    (1, 16, 1, 4, 4, 4),
    (2, 100, 3, 64, 256, 64),  # the largest state the kernel takes
    (8, 1024, 24, 64, 128, 64),
    (8, 1025, 24, 64, 128, 64),  # 17 chunks, one row in the last
    (2, 40, 24, 64, 128, 64),    # S < chunk
    (8, 1024, 24, 64, 128, 32),  # chunk 32
    (2, 50, 3, 3, 5, 16),        # odd P and N: P N no multiple of 4
]
SSD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}   # tests/test_kernels.py:56


def _ssd_inputs(gen, bt, s, h, p, n, dt):
    x = torch.randn((bt, s, h, p), generator=gen, device=gen.device).to(dt)
    dts = torch.nn.functional.softplus(
        torch.randn((bt, s, h), generator=gen, device=gen.device))
    A = -torch.exp(torch.randn((h,), generator=gen, device=gen.device) * 0.5)
    B = torch.randn((bt, s, n), generator=gen, device=gen.device).to(dt)
    C = torch.randn((bt, s, n), generator=gen, device=gen.device).to(dt)
    return x, dts, A, B, C


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(SSD_TOL))
@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_ssd_scan_matches_plain_version(cuda, case, dtype):
    from repro_torch.kernels import ssd_scan as kssd
    bt, s, h, p, n, chunk = case
    gen = torch.Generator(device=cuda).manual_seed(s + n)
    ins = _ssd_inputs(gen, bt, s, h, p, n, getattr(torch, dtype))
    kssd.reset_launch_counts()
    y = kssd.ssd_scan(*ins, chunk=chunk)
    torch.cuda.synchronize()
    assert kssd.launch_counts == {"ssd_scan": 1}
    want, _ = ref.ssd_ref(*ins)
    assert y.dtype == ins[0].dtype and y.shape == ins[0].shape
    err = float((y.float() - want.float()).abs().max())
    assert err / float(want.float().abs().max()) < SSD_TOL[dtype]


@pytest.mark.gpu
def test_ssd_scan_reads_strided_inputs(cuda):
    """Column slices of one projection, as ssd_apply passes them."""
    from repro_torch.kernels import ssd_scan as kssd
    bt, s, h, p, n = 2, 130, 4, 64, 128
    gen = torch.Generator(device=cuda).manual_seed(5)
    xbc = torch.randn((bt, s, h * p + 2 * n), generator=gen, device=cuda)
    xs, B, C = torch.split(xbc, [h * p, n, n], dim=-1)
    _, dts, A, _, _ = _ssd_inputs(gen, bt, s, h, p, n, torch.float32)
    x = xs.reshape(bt, s, h, p)
    y = kssd.ssd_scan(x, dts, A, B, C)
    want = kssd.ssd_scan(x.contiguous(), dts, A, B.contiguous(),
                         C.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(y, want)


RGLRU_CASES = [(2, 32, 8), (1, 50, 16), (2, 64, 4), (1, 8, 2), (3, 37, 300),
               (8, 1024, 2560)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", RGLRU_CASES, ids=str)
def test_rglru_scan_matches_plain_version(cuda, case):
    from repro_torch.kernels import rglru_scan as krg
    gen = torch.Generator(device=cuda).manual_seed(sum(case))
    a = torch.rand(case, generator=gen, device=cuda) * 0.099 + 0.9
    b = torch.randn(case, generator=gen, device=cuda)
    krg.reset_launch_counts()
    h = krg.rglru_scan(a, b)
    torch.cuda.synchronize()
    assert krg.launch_counts == {"rglru_scan": 1}
    want, _ = ref.rglru_ref(a, b)
    torch.testing.assert_close(h, want, atol=5e-5, rtol=1e-4)
