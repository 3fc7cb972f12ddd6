"""The port's int8 codec against the JAX package, bitwise.

The plain PyTorch versions (``repro_torch.kernels.ref``, and the kernel
wrappers, which take them for CPU tensors) are held bit for bit against
the Pallas kernels in interpret mode and against the JAX package's
oracles.  The oracles run under ``jax.jit`` because that is how the engine
runs them: jitted, XLA turns ``amax / 127`` into ``amax * f32(1/127)``,
while eager op-by-op dispatch divides, and the two differ in the last bit
of some scales.  Blocks are passed to ``repro.kernels.comms`` directly:
``repro.kernels.ops`` would shrink them in interpret mode.

The CUDA kernels themselves run only on a card:
``tests/test_torch_kernels_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.comms import codecs as jcodecs  # noqa: E402
from repro.comms import flat as jflat  # noqa: E402
from repro.comms import reduce as jreduce  # noqa: E402
from repro.comms import sync as jsync  # noqa: E402
from repro.core import grouping as jgrouping  # noqa: E402
from repro.core import topology as jtopology  # noqa: E402
from repro.kernels import comms as jkern  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

from repro_torch.comms import codecs as tcodecs  # noqa: E402
from repro_torch.comms import flat as tflat  # noqa: E402
from repro_torch.comms import reduce as treduce  # noqa: E402
from repro_torch.comms import sync as tsync  # noqa: E402
from repro_torch.core import grouping as tgrouping  # noqa: E402
from repro_torch.core import topology as ttopology  # noqa: E402
from repro_torch.kernels import comms as tkern  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

COLS = (1, 255, 256, 257, 2120)
BLOCKS = (64, 256)

_j_int8_ref = jax.jit(jref.int8_ref, static_argnums=1)
_j_scale_ref = jax.jit(jref.int8_scale_quant_ref, static_argnums=2)


def _payload(seed: int, rows: int, cols: int) -> np.ndarray:
    """Rows at magnitudes from 1e-3 to 10 (so scales span decades), the
    last row all zero."""
    rng = np.random.default_rng(seed)
    mag = np.logspace(-3, 1, rows)[:, None]
    x = (rng.normal(size=(rows, cols)) * mag).astype(np.float32)
    x[-1] = 0.0
    return x


def _eq(a, b) -> bool:
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("cols", COLS)
def test_int8_quantize_bitwise(cols, block):
    x = _payload(cols * 7 + block, 5, cols)
    q_k, s_k = jkern.int8_quantize(jnp.asarray(x), block=block,
                                   interpret=True)
    q_r, s_r, rt_r = _j_int8_ref(jnp.asarray(x), block)
    q_p, s_p, rt_p = tref.int8_ref(torch.from_numpy(x), block)
    q_w, s_w = tkern.int8_quantize(torch.from_numpy(x), block=block)
    for q, s in ((q_p, s_p), (q_w, s_w)):
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert _eq(q, q_k) and _eq(s, s_k)
        assert _eq(q, q_r) and _eq(s, s_r)
    assert _eq(rt_p, rt_r)
    assert not q_w[-1].any() and not s_w[-1].any()       # all-zero row


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("cols", COLS)
def test_int8_dequantize_bitwise(cols, block):
    x = _payload(cols * 11 + block, 5, cols)
    q, s = jkern.int8_quantize(jnp.asarray(x), block=block, interpret=True)
    y_k = jkern.int8_dequantize(q, s, block=block, interpret=True)
    qt, st = torch.tensor(np.asarray(q)), torch.tensor(np.asarray(s))
    y_p = tref.int8_dequant_ref(qt, st, block)
    y_w = tkern.int8_dequantize(qt, st, block=block)
    assert y_w.dtype == torch.float32
    assert _eq(y_p, y_k) and _eq(y_w, y_k)


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("cols", COLS)
def test_int8_scale_quantize_bitwise(cols, block):
    """Against the group-max scale the wire path uses, with the scale of
    the largest row (the last non-zero one) halved so it saturates."""
    x = _payload(cols * 13 + block, 5, cols)
    _, own, _ = _j_int8_ref(jnp.asarray(x), block)
    own = np.asarray(own)
    group = np.broadcast_to(own.max(0, keepdims=True), own.shape).copy()
    group[-2] *= 0.5
    q_k = jkern.int8_scale_quantize(jnp.asarray(x), jnp.asarray(group),
                                    block=block, interpret=True)
    q_r = _j_scale_ref(jnp.asarray(x), jnp.asarray(group), block)
    xt, gt = torch.from_numpy(x), torch.from_numpy(group)
    q_p = tref.int8_scale_quant_ref(xt, gt, block)
    q_w = tkern.int8_scale_quantize(xt, gt, block=block)
    assert _eq(q_p, q_k) and _eq(q_w, q_k) and _eq(q_p, q_r)
    if cols > 1:
        assert int(q_w[-2].abs().max()) == 127


def test_int8_saturation_and_ties():
    """The block max maps to exactly +-127; an x*inv at a half integer
    rounds to even, as jnp.round does."""
    x = np.zeros((2, 256), np.float32)
    x[0, :4] = [127.0, -127.0, 2.5, -0.5]     # scale 1: ties at 2.5, -0.5
    x[1, :3] = [-3.0, 1.5, 0.5]
    q, s = tkern.int8_quantize(torch.from_numpy(x), block=256)
    q_k, s_k = jkern.int8_quantize(jnp.asarray(x), block=256, interpret=True)
    assert _eq(q, q_k) and _eq(s, s_k)
    assert q[0, :4].tolist() == [127, -127, 2, 0]
    assert int(q[1, 0]) == -127


@pytest.mark.parametrize("mask", [None, (1, 0, 1, 1, 0, 1, 1, 1)])
@pytest.mark.parametrize("gs,level", [((2, 4), 1), ((2, 4), 2),
                                      ((2, 2, 2), 2), ((8,), 1)])
def test_int8_wire_reduce_bitwise(gs, level, mask):
    """Int8Compressor.reduce under SimWireOps (the int8 wire path) equals
    the reference's jitted reduce bit for bit."""
    x = _payload(sum(gs) * 31 + level, 8, 2120)
    x[-1] = np.random.default_rng(3).normal(size=2120)
    codec = jcodecs.Int8Compressor()

    def jfn(v, m):
        return codec.reduce(v, jreduce.SimWireOps(gs, level, m))[0]

    jm = None if mask is None else jnp.asarray(mask, bool)
    want = np.asarray(jax.jit(jfn)(jnp.asarray(x), jm))
    tm = None if mask is None else torch.tensor(mask, dtype=torch.bool)
    got = tcodecs.Int8Compressor().reduce(
        torch.from_numpy(x), treduce.SimWireOps(gs, level, tm))
    assert _eq(got, want)


def test_int8_wire_reduce_non_power_of_two_group():
    """A group of 3 divides by an unmasked count of 3.0: XLA multiplies by
    f32(1/3), and the port does the same (division rule)."""
    x = _payload(99, 6, 700)
    x[-1] = np.random.default_rng(4).normal(size=700)
    codec = jcodecs.Int8Compressor()
    want = np.asarray(jax.jit(
        lambda v: codec.reduce(v, jreduce.SimWireOps((2, 3), 2))[0])(
            jnp.asarray(x)))
    got = tcodecs.Int8Compressor().reduce(
        torch.from_numpy(x), treduce.SimWireOps((2, 3), 2))
    assert _eq(got, want)


@pytest.mark.parametrize("mask", [None, (0, 1, 1, 1, 1, 0, 0, 1)])
def test_sim_wire_ops_sum_max_count(mask):
    """The int32 group sum stays int32 (torch.sum would widen to int64),
    and count() is a Python float when unmasked."""
    rng = np.random.default_rng(5)
    q = rng.integers(-127, 128, size=(8, 40)).astype(np.int32)
    a = np.abs(rng.normal(size=(8, 3))).astype(np.float32)
    jm = None if mask is None else jnp.asarray(mask, bool)
    tm = None if mask is None else torch.tensor(mask, dtype=torch.bool)
    jops = jreduce.SimWireOps((2, 4), 2, jm)
    tops = treduce.SimWireOps((2, 4), 2, tm)
    s = tops.sum(torch.from_numpy(q))
    assert s.dtype == torch.int32
    assert _eq(s, jops.sum(jnp.asarray(q)))
    assert _eq(tops.max(torch.from_numpy(a)), jops.max(jnp.asarray(a)))
    if mask is None:
        assert isinstance(tops.count(), float)
        assert tops.count() == jops.count() == 4.0
    else:
        assert _eq(tops.count(), jops.count())


def _mlp_tree(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    shapes = {"out": {"w": (n, 32, 8), "b": (n, 8)},
              "h1": {"w": (n, 24, 32), "b": (n, 32)},
              "h2": {"w": (n, 32, 32), "b": (n, 32)}}
    return {k: {m: rng.normal(size=s).astype(np.float32)
                for m, s in v.items()} for k, v in shapes.items()}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def test_flat_bucket_layout_matches_reference():
    """Leaves concatenate in jax.tree.flatten's sorted-key order — the
    int8 block scales depend on it."""
    tree = _mlp_tree(4)
    jfb = jflat.FlatBucket.plan(jax.tree.map(jnp.asarray, tree))
    tfb = tflat.FlatBucket.plan(_to_torch(tree))
    assert [(s.bucket, s.offset, s.size, s.shape) for s in tfb.slots] == \
        [(s.bucket, s.offset, s.size, s.shape) for s in jfb.slots]
    assert tfb.lengths == jfb.lengths == {"float32": 2120}
    jbuf = jfb.flatten(jax.tree.map(jnp.asarray, tree))
    tbuf = tfb.flatten(_to_torch(tree))
    assert _eq(tbuf["float32"], jbuf["float32"])
    back = tfb.unflatten(tbuf)
    for k in tree:
        for m in tree[k]:
            assert _eq(back[k][m], tree[k][m])


@pytest.mark.parametrize("codec", ["identity", "int8"])
def test_wire_stats_bytes_match_reference(codec):
    tree = _mlp_tree(8)
    jarr, jn = jsync.Comms(codec).payload_spec(
        jax.tree.map(jnp.asarray, tree))
    tarr, tn = tsync.Comms(codec).payload_spec(_to_torch(tree))
    assert tn == jn
    assert [(a.name, tuple(a.shape), a.dtype, a.nbytes) for a in tarr] == \
        [(a.name, tuple(a.shape), a.dtype, a.nbytes) for a in jarr]
    g_j = jgrouping.random_grouping(8, 2, seed=1)
    g_t = tgrouping.random_grouping(8, 2, seed=1)
    pairs = [
        (jtopology.make_topology("two_level", n=8, N=2, G=8, I=2),
         ttopology.make_topology("two_level", n=8, N=2, G=8, I=2)),
        (jtopology.make_topology("grouped", grouping=g_j, G=8, I=(2, 4)),
         ttopology.make_topology("grouped", grouping=g_t, G=8, I=(2, 4))),
    ]
    from repro.comms.wire import WireStats as JWS
    from repro_torch.comms.wire import WireStats as TWS
    for jt, tt in pairs:
        jws, tws = JWS(jt, jarr, jn), TWS(tt, tarr, tn)
        assert tws.payload_bytes == jws.payload_bytes
        assert tws.step_bytes(16) == jws.step_bytes(16)


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros((2, 300))
    with pytest.raises(TypeError):
        tkern.int8_quantize(x.double())
    with pytest.raises(ValueError):
        tkern.int8_quantize(torch.zeros(300))
    with pytest.raises(ValueError):
        tkern.int8_quantize(torch.zeros((300, 2)).t())      # not contiguous
    with pytest.raises(ValueError):
        tkern.int8_quantize(x, block=0)
    with pytest.raises(ValueError):
        tkern.int8_scale_quantize(x, torch.zeros((2, 1)), block=256)
    with pytest.raises(TypeError):
        tkern.int8_dequantize(x, torch.zeros((2, 2)), block=256)
    with pytest.raises(ValueError):
        tkern.int8_dequantize(torch.zeros((2, 300), dtype=torch.int8),
                              torch.zeros((2, 3)), block=256)


def test_cpu_tensors_take_the_plain_version_without_counting():
    tkern.reset_launch_counts()
    x = torch.from_numpy(_payload(0, 3, 500))
    q, s = tkern.int8_quantize(x)
    tkern.int8_dequantize(q, s)
    tkern.int8_scale_quantize(x, s)
    assert all(v == 0 for v in tkern.launch_counts.values())
