"""The port's 1-bit sign codec against the JAX package.

Bits and unpacked values are held bit for bit.  The block scale is
``mean|x|``, a float sum, and the port sums in its own fixed order (the
halving tree of ``repro_torch.kernels.ref``), so scales agree with the
Pallas kernel in interpret mode and with the jitted oracle to
``rtol=1e-6`` (3.2e-7 measured, 2-3 ulp).  The vote of the wire reduce is
bitwise the reference's when both see the same packed payload; on its own
payload the port differs by those scales' few ulp.  Blocks go to
``repro.kernels.comms`` directly: ``repro.kernels.ops`` would shrink them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.comms import codecs as jcodecs  # noqa: E402
from repro.comms import reduce as jreduce  # noqa: E402
from repro.comms import sync as jsync  # noqa: E402
from repro.comms.wire import WireStats as JWS  # noqa: E402
from repro.core import topology as jtopology  # noqa: E402
from repro.kernels import comms as jkern  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

from repro_torch.comms import codecs as tcodecs  # noqa: E402
from repro_torch.comms import reduce as treduce  # noqa: E402
from repro_torch.comms import sync as tsync  # noqa: E402
from repro_torch.comms.wire import WireStats as TWS  # noqa: E402
from repro_torch.core import topology as ttopology  # noqa: E402
from repro_torch.kernels import comms as tkern  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

COLS = (1, 7, 1023, 1024, 1025, 2120)
BLOCKS = (24, 64, 1000, 1024)
SCALE_RTOL = 1e-6

_j_sign_ref = jax.jit(jref.sign_ref, static_argnums=1)


def _payload(seed: int, rows: int, cols: int) -> np.ndarray:
    """Rows at magnitudes from 1e-3 to 10, a -0.0 in every row but the
    last, and the last row all zero."""
    rng = np.random.default_rng(seed)
    mag = np.logspace(-3, 1, rows)[:, None]
    x = (rng.normal(size=(rows, cols)) * mag).astype(np.float32)
    x[:, 0] = -0.0
    x[-1] = 0.0
    return x


def _eq(a, b) -> bool:
    return np.array_equal(np.asarray(a), np.asarray(b))


def _close(got, want, rtol) -> bool:
    got, want = np.asarray(got), np.asarray(want)
    return got.shape == want.shape and \
        bool((np.abs(got - want) <= rtol * np.abs(want)).all())


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("cols", COLS)
def test_sign_pack_matches_reference(cols, block):
    x = _payload(cols * 7 + block, 5, cols)
    b_k, s_k = jkern.sign_pack(jnp.asarray(x), block=block, interpret=True)
    s_r, rt_r = _j_sign_ref(jnp.asarray(x), block)
    b_p, s_p = tref.sign_pack_ref(torch.from_numpy(x), block)
    b_w, s_w = tkern.sign_pack(torch.from_numpy(x), block=block)
    assert b_w.dtype == torch.uint8 and s_w.dtype == torch.float32
    assert torch.equal(b_p, b_w) and torch.equal(s_p, s_w)
    assert _eq(b_w, b_k)                          # the padded tail too
    assert _close(s_w, s_k, SCALE_RTOL) and _close(s_w, s_r, SCALE_RTOL)
    signs = np.unpackbits(b_w.numpy(), axis=1, bitorder="little")
    assert signs[:, cols:].all() and signs[:, 0].all()   # pad and -0.0: +
    assert not s_w[-1].any()                      # all-zero row
    # the port's own roundtrip equals the reference oracle's on its scales
    rt = tkern.sign_unpack(b_w, s_w, size=cols, block=block)
    assert _close(rt, rt_r, SCALE_RTOL)


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("cols", COLS)
def test_sign_unpack_matches_reference(cols, block):
    """On the reference's own packed payload, bit for bit."""
    x = _payload(cols * 11 + block, 5, cols)
    b, s = jkern.sign_pack(jnp.asarray(x), block=block, interpret=True)
    y_k = jkern.sign_unpack(b, s, size=cols, block=block, interpret=True)
    bt, stt = torch.tensor(np.asarray(b)), torch.tensor(np.asarray(s))
    y_p = tref.sign_unpack_ref(bt, stt, cols, block)
    y_w = tkern.sign_unpack(bt, stt, size=cols, block=block)
    assert y_w.dtype == torch.float32 and y_w.shape == (5, cols)
    assert _eq(y_p, y_k) and _eq(y_w, y_k)


def test_sign_bit_rule():
    """-0.0 and +0.0 count as +, NaN as -; the scale is the block mean."""
    x = np.zeros((1, 16), np.float32)
    x[0, :6] = [-0.0, 0.0, np.nan, -1.0, 2.0, -3.0]
    b, s = tkern.sign_pack(torch.from_numpy(x), block=8)
    b_k, _ = jkern.sign_pack(jnp.asarray(x), block=8, interpret=True)
    assert _eq(b, b_k)
    assert b[0].tolist() == [0b11010011, 0xff]
    assert np.isnan(s[0, 0].item()) and s[0, 1].item() == 0.0
    _, s = tkern.sign_pack(torch.tensor([[1.0, -2.0, 3.0, -6.0] + [0] * 4]),
                           block=8)
    assert s.tolist() == [[1.5]]


def test_sign_summation_rule_is_the_halving_tree():
    """The scale is bitwise the halving tree over the zero-padded block,
    which is not the sequential sum for these values."""
    x = np.array([[1e8, 1.0, -1e8, 1.0, 3.0, 5.0, 7.0, 0.5]], np.float32)
    _, s = tkern.sign_pack(torch.from_numpy(x), block=8)
    a = np.abs(x[0])
    tree = ((a[0] + a[4]) + (a[2] + a[6])) + ((a[1] + a[5]) + (a[3] + a[7]))
    assert s.item() == np.float32(tree) / np.float32(8)


def test_sign_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros((2, 300))
    with pytest.raises(ValueError, match="multiple of 8"):
        tkern.sign_pack(x, block=12)
    with pytest.raises(ValueError, match="at most"):
        tkern.sign_pack(x, block=tkern.SIGN_MAX_BLOCK + 8)
    with pytest.raises(TypeError):
        tkern.sign_pack(x.double())
    bits, scale = tkern.sign_pack(x, block=64)
    with pytest.raises(ValueError):
        tkern.sign_unpack(bits, scale, size=400, block=64)   # wrong nb
    with pytest.raises(TypeError):
        tkern.sign_unpack(bits.to(torch.int8), scale, size=300, block=64)
    with pytest.raises(ValueError):
        tcodecs.SignCompressor(block=12)
    tkern.reset_launch_counts()
    tkern.sign_unpack(bits, scale, size=300, block=64)
    assert tkern.launch_counts["sign_pack"] == 0
    assert tkern.launch_counts["sign_unpack"] == 0


def _shared_pack(monkeypatch):
    """Route the port's SignCompressor to the reference's packed payload,
    so that only the vote arithmetic is compared."""
    class Shim:
        @staticmethod
        def sign_pack(x, block):
            b, s = jkern.sign_pack(jnp.asarray(x.numpy()), block=block,
                                   interpret=True)
            return torch.tensor(np.asarray(b)), torch.tensor(np.asarray(s))
    monkeypatch.setattr(tcodecs, "_kernels", Shim)


def _masks(n: int):
    rng = np.random.default_rng(n)
    return [None, tuple(int(v) for v in rng.integers(0, 2, n)), (0,) * n]


# every level of two_level (2, 4) and three_level (2, 2, 2), a
# non-power-of-two group (2, 3) and one global group of 8
LEVELS = [((2, 4), 1), ((2, 4), 2), ((2, 2, 2), 1), ((2, 2, 2), 2),
          ((2, 2, 2), 3), ((2, 3), 1), ((2, 3), 2), ((8,), 1)]


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("block", [1024, 24])
@pytest.mark.parametrize("gs,level", LEVELS)
def test_sign_wire_reduce_matches_reference(gs, level, block, shared,
                                            monkeypatch):
    """SignCompressor.reduce through SimWireOps.gathered against the
    reference's jitted reduce, unmasked, masked and all masked.  With the
    reference's packed payload (``shared``) the vote is bitwise; that
    covers the division rule (a static count of 3 or 6 multiplies by
    f32(1/count), a masked count divides) and the member order of the
    scale sum.  With the port's own payload, to the scales' tolerance."""
    if shared:
        _shared_pack(monkeypatch)
    n = int(np.prod(gs))
    x = _payload(n * 31 + level + block, n, 2120)
    x[-1] = np.random.default_rng(3).normal(size=2120)
    codec = jcodecs.SignCompressor(block)
    jfn = jax.jit(lambda v, m: codec.reduce(
        v, jreduce.SimWireOps(gs, level, m))[0])
    for mask in _masks(n):
        jm = None if mask is None else jnp.asarray(mask, bool)
        tm = None if mask is None else torch.tensor(mask, dtype=torch.bool)
        want = np.asarray(jfn(jnp.asarray(x), jm))
        got = tcodecs.SignCompressor(block).reduce(
            torch.from_numpy(x), treduce.SimWireOps(gs, level, tm))
        if shared:
            assert _eq(got, want), mask
        else:
            assert _close(got, want, 2 * SCALE_RTOL), mask


def test_sim_wire_ops_gathered_matches_reference():
    rng = np.random.default_rng(7)
    a = rng.normal(size=(8, 5)).astype(np.float32)
    mask = (1, 0, 1, 1, 0, 1, 1, 1)

    def fn(ag, wm):
        s = ag.sum(-2) if wm is None else (ag * wm[..., None]).sum(-2)
        return s * 2.0

    for m in (None, mask):
        jops = jreduce.SimWireOps((2, 4), 2,
                                  None if m is None else jnp.asarray(m))
        tops = treduce.SimWireOps((2, 4), 2,
                                  None if m is None else torch.tensor(m))
        want = jops.gathered(fn, jnp.asarray(a))
        got = tops.gathered(fn, torch.from_numpy(a))
        assert got.shape == (8, 5)
        assert _close(got, want, 1e-6)


@pytest.mark.parametrize("bucket", [True, False])
def test_sign_wire_stats_match_reference(bucket):
    rng = np.random.default_rng(0)
    shapes = {"out": {"w": (8, 32, 8), "b": (8, 8)},
              "h1": {"w": (8, 24, 32), "b": (8, 32)}}
    tree = {k: {m: rng.normal(size=s).astype(np.float32)
                for m, s in v.items()} for k, v in shapes.items()}
    ttree = {k: {m: torch.from_numpy(a) for m, a in v.items()}
             for k, v in tree.items()}
    jarr, jn = jsync.Comms("sign", bucket=bucket).payload_spec(
        jax.tree.map(jnp.asarray, tree))
    tarr, tn = tsync.Comms("1bit", bucket=bucket).payload_spec(ttree)
    assert tn == jn
    assert [(a.name, tuple(a.shape), a.dtype, a.nbytes) for a in tarr] == \
        [(a.name, tuple(a.shape), a.dtype, a.nbytes) for a in jarr]
    jt = jtopology.make_topology("two_level", n=8, N=2, G=16, I=4)
    tt = ttopology.make_topology("two_level", n=8, N=2, G=16, I=4)
    assert TWS(tt, tarr, tn).step_bytes(96) == JWS(jt, jarr, jn).step_bytes(96)


def test_make_compressor_and_comms_take_the_reference_kwargs():
    c = tcodecs.make_compressor("sign", block=256)
    assert repr(c) == repr(jcodecs.make_compressor("sign", block=256))
    assert repr(tsync.Comms("sign", block=64, bucket=False)) == \
        repr(jsync.Comms("sign", block=64, bucket=False))
    assert repr(tsync.make_comms("int8", block=128)) == \
        repr(jsync.make_comms("int8", block=128))
    assert tsync.make_comms() is None
    with pytest.raises(ValueError):
        tcodecs.make_compressor(c, block=8)
    with pytest.raises(ValueError):
        tsync.make_comms(tsync.Comms("sign"), bucket=False)


@pytest.mark.parametrize("bucket", [True, False])
@pytest.mark.parametrize("wire", [True, False])
def test_comms_sync_with_sign_matches_reference(bucket, wire):
    """A whole sync of an MLP tree through ``Comms("sign")``, fused into
    one buffer or leaf by leaf, on the wire path and on the legacy
    roundtrip; the layout changes the blocks, so both are checked."""
    rng = np.random.default_rng(1)
    shapes = {"out": {"w": (8, 32, 8), "b": (8, 8)},
              "h1": {"w": (8, 24, 32), "b": (8, 32)}}
    tree = {k: {m: rng.normal(size=s).astype(np.float32)
                for m, s in v.items()} for k, v in shapes.items()}
    ttree = {k: {m: torch.from_numpy(a) for m, a in v.items()}
             for k, v in tree.items()}
    jt = jtopology.make_topology("two_level", n=8, N=2, G=16, I=4)
    tt = ttopology.make_topology("two_level", n=8, N=2, G=16, I=4)
    ev_j, ev_t = jt.event_at(3), tt.event_at(3)
    jc = jsync.Comms("sign", bucket=bucket)
    tc = tsync.Comms("sign", bucket=bucket)
    jops = jreduce.SimWireOps((2, 4), 2) if wire else None
    tops = treduce.SimWireOps((2, 4), 2) if wire else None
    want, _ = jax.jit(lambda t: jc.sync(
        t, lambda u: jt.aggregate(u, ev_j), reduce_mode=jops))(
            jax.tree.map(jnp.asarray, tree))
    got = tc.sync(ttree, lambda u: tt.aggregate(u, ev_t), reduce_mode=tops)
    # the legacy path means +-s values, so an entry can cancel to near 0:
    # hold each leaf to its largest entry
    for k in tree:
        for m in tree[k]:
            g, w = got[k][m].numpy(), np.asarray(want[k][m])
            assert np.abs(g - w).max() <= 2 * SCALE_RTOL * np.abs(w).max()


@settings(max_examples=20, deadline=None)
@given(rows=st.integers(1, 4),
       cols=st.sampled_from([1, 7, 31, 32, 33, 64, 100, 171, 256]),
       block=st.sampled_from([8, 24, 32, 64]),
       seed=st.integers(0, 10**6), scale=st.floats(1e-3, 1e3))
def test_sign_roundtrip_idempotent(rows, cols, block, seed, scale):
    """Re-encoding a decoded payload is a fixed point up to f32 rounding,
    with the tolerance of the reference's own property test
    (``tests/test_comms_properties.py``), and the first roundtrip agrees
    with the reference's to the scales' tolerance."""
    x = (np.random.default_rng(seed).normal(size=(rows, cols))
         * scale).astype(np.float32)
    codec = tcodecs.SignCompressor(block)
    once = codec.roundtrip(torch.from_numpy(x))
    twice = codec.roundtrip(once)
    np.testing.assert_allclose(twice.numpy(), once.numpy(),
                               atol=1e-5 * scale + 1e-6, rtol=1e-5)
    want = jcodecs.SignCompressor(block).roundtrip(jnp.asarray(x))[0]
    assert _close(once, want, SCALE_RTOL)
