"""The port's top-k codec with error feedback against the JAX package.

* ``topk_reduce_ref`` (and the kernel wrapper, which takes it for CPU
  tensors) against the jitted ``repro.kernels.ref.topk_reduce_ref`` and the
  Pallas ``topk_decode_reduce`` in interpret mode, at the reference's own
  cases (``tests/test_comms.py``) and the quickstart's sync shapes.  With
  distinct indices in each member it is the jitted oracle bit for bit (both
  add member after member); the Pallas kernel sums an output element's
  entries in XLA's reduce order, so it agrees bit for bit only where all
  M*K indices are distinct, and to 1e-6 where members share an index.
  Indices repeated within a member: 1e-6 against both.
* ``TopKCompressor``: encode, decode and the error-feedback roundtrip bit
  for bit, including ties in |x|, where the chosen indices must be those of
  ``jax.lax.top_k`` (lower index first); ``k`` rounds half to even.
* Wire bytes equal the reference's (static accounting).
* Quickstart-scale trajectories (two- and three-level, wire path and
  legacy roundtrip, an Algorithm-1 masked step) against the JAX sim:
  params, losses and residuals within 1e-5 relative (max |diff| over max
  |reference| per leaf), as ``tests/test_torch_hsgd.py`` holds the other
  codecs; the frameworks sum matrix products in different orders, and a
  selection near a tie could follow a last-bit difference, which these
  seeds do not meet.  Inside the port, ``run_rounds`` is bitwise the
  trajectory of per-step ``step()`` calls, residuals included.

The CUDA kernel itself runs only on a card:
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.comms as JC  # noqa: E402
import repro.core as J  # noqa: E402
from repro.comms import codecs as jcodecs  # noqa: E402
from repro.comms import reduce as jreduce  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import SimpleConfig as JConfig  # noqa: E402
from repro.models import SimpleModel as JModel  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402

import repro_torch.comms as PC  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.comms import codecs as tcodecs  # noqa: E402
from repro_torch.comms import reduce as treduce  # noqa: E402
from repro_torch.data import (FederatedDataset, label_shard_partition,  # noqa: E402
                              make_classification)
from repro_torch.kernels import comms as tkern  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import (SimpleConfig, SimpleModel,  # noqa: E402
                                params_from_numpy)
from repro_torch.optim import sgd  # noqa: E402

RTOL = 1e-5
MODEL = dict(kind="mlp", input_dim=24, hidden=32, num_classes=8)
_j_topk_ref = jax.jit(jref.topk_reduce_ref, static_argnums=2)


def _eq(a, b) -> bool:
    return np.array_equal(np.asarray(a), np.asarray(b))


# the reference's cases (tests/test_comms.py); the last two are the
# quickstart's local and global syncs at rate 0.25 (k = 530 of 2120)
@pytest.mark.parametrize("m,k,size,blk", [
    (8, 4, 100, 32), (1, 1, 7, 8), (16, 15, 244, 64), (3, 10, 64, 64),
    (4, 530, 2120, 256), (8, 530, 2120, 256)])
def test_topk_reduce_matches_reference(m, k, size, blk):
    rng = np.random.default_rng(5)
    vals = rng.normal(size=(m, k)).astype(np.float32)
    # distinct indices within each member; members overlap
    uniq = np.stack([rng.permutation(size)[:k] for _ in range(m)]) \
        .astype(np.int32)
    want_k = np.asarray(jops.topk_decode_reduce(
        jnp.asarray(vals), jnp.asarray(uniq), size=size, block=blk,
        interpret=True))
    want_r = np.asarray(_j_topk_ref(jnp.asarray(vals), jnp.asarray(uniq),
                                    size))
    got = tkern.topk_decode_reduce(torch.from_numpy(vals),
                                   torch.from_numpy(uniq), size=size,
                                   block=blk)
    assert got.dtype == torch.float32 and got.shape == (size,)
    assert _eq(got, want_r)
    if len(np.unique(uniq)) == m * k:
        assert _eq(got, want_k)
    else:
        np.testing.assert_allclose(got.numpy(), want_k, rtol=1e-6,
                                   atol=1e-6)
    assert _eq(tref.topk_reduce_ref(torch.from_numpy(vals),
                                    torch.from_numpy(uniq), size), want_r)
    # repeated indices, also within one member: 1e-6
    rep = rng.integers(0, size, size=(m, k)).astype(np.int32)
    got = tkern.topk_decode_reduce(torch.from_numpy(vals),
                                   torch.from_numpy(rep), size=size)
    for want in (jops.topk_decode_reduce(
            jnp.asarray(vals), jnp.asarray(rep), size=size, block=blk,
            interpret=True),
            _j_topk_ref(jnp.asarray(vals), jnp.asarray(rep), size)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


def test_topk_reduce_drops_indices_out_of_range():
    """As the Pallas kernel drops them (the reference's jnp oracle drops
    9 too, but wraps -1 to the last element, numpy style)."""
    vals = np.array([[1.0, 2.0, 4.0], [8.0, 16.0, 32.0]], np.float32)
    idx = np.array([[0, -1, 5], [9, 3, 0]], np.int32)
    want = np.asarray(jops.topk_decode_reduce(
        jnp.asarray(vals), jnp.asarray(idx), size=6, block=8,
        interpret=True))
    got = tref.topk_reduce_ref(torch.from_numpy(vals), torch.from_numpy(idx),
                               6)
    assert _eq(got, want) and got.tolist() == [33.0, 0, 0, 16.0, 0, 4.0]


def test_topk_wrapper_refuses_what_the_kernel_does_not_take():
    v = torch.zeros((2, 3))
    i = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        tkern.topk_decode_reduce(v, i.long(), size=4)
    with pytest.raises(TypeError, match="float32"):
        tkern.topk_decode_reduce(v.double(), i, size=4)
    with pytest.raises(ValueError, match="shape"):
        tkern.topk_decode_reduce(v, i[:, :2].contiguous(), size=4)
    with pytest.raises(ValueError, match="size"):
        tkern.topk_decode_reduce(v, i, size=-1)
    assert tkern.topk_decode_reduce(v, i, size=0).shape == (0,)


def _ties(seed: int, rows: int, cols: int) -> np.ndarray:
    """Values from a handful of magnitudes with random signs, so |x| ties
    everywhere, plus one row of zeros (all tied)."""
    rng = np.random.default_rng(seed)
    x = (rng.choice([0.25, 0.5, 1.0, 2.0], size=(rows, cols))
         * rng.choice([-1.0, 1.0], size=(rows, cols))).astype(np.float32)
    x[-1] = 0.0
    return x


@pytest.mark.parametrize("rate", [0.25, 1 / 16, 1.0, 1e-9])
@pytest.mark.parametrize("ties", [False, True])
def test_topk_codec_matches_reference_bitwise(rate, ties):
    rows, cols = 5, 2120
    rng = np.random.default_rng(int(ties) * 100 + int(rate * 1000))
    x = _ties(7, rows, cols) if ties else \
        rng.normal(size=(rows, cols)).astype(np.float32)
    res = (rng.normal(size=(rows, cols)) * 0.1).astype(np.float32)
    jc, tc = jcodecs.TopKCompressor(rate), tcodecs.TopKCompressor(rate)
    assert tc._k(cols) == jc._k(cols) and repr(tc) == repr(jc)
    assert tc.stateful and tc.wire_reduce and not tc.layout_free
    jw = jax.jit(jc.encode)(jnp.asarray(x))
    tw = tc.encode(torch.from_numpy(x))
    assert _eq(tw["indices"], jw["indices"]) and _eq(tw["values"],
                                                     jw["values"])
    assert tw["indices"].dtype == torch.int32
    assert _eq(tc.decode(tw, torch.from_numpy(x)),
               jc.decode(jw, jnp.asarray(x)))
    # error feedback: (decoded, u - decoded) with u = x + residual
    jsent, jres = jax.jit(jc.roundtrip)(jnp.asarray(x), jnp.asarray(res))
    tsent, tres = tc.roundtrip(torch.from_numpy(x), torch.from_numpy(res))
    assert _eq(tsent, jsent) and _eq(tres, jres)
    # no residual: the decoded payload alone (the residual rule)
    assert _eq(tc.roundtrip(torch.from_numpy(x)),
               jax.jit(jc.roundtrip)(jnp.asarray(x))[0])


def test_topk_k_rounds_half_to_even():
    """k = round(rate * L) with Python's rounding: 2120 / 16 = 132.5 -> 132,
    and 2152 / 16 = 134.5 -> 134, as in the reference."""
    for length, k in ((2120, 132), (2152, 134), (8, 1), (1, 1)):
        assert tcodecs.TopKCompressor()._k(length) == k == \
            jcodecs.TopKCompressor()._k(length)


@pytest.mark.parametrize("mask", [None, (1, 0, 1, 1, 0, 1, 1, 1)])
@pytest.mark.parametrize("level", [1, 2])
def test_topk_wire_reduce_matches_reference(level, mask):
    """TopKCompressor.reduce under SimWireOps: the dense group mean of the
    decoded payloads and the new residual, against the jitted reference."""
    rng = np.random.default_rng(level)
    x = rng.normal(size=(8, 2120)).astype(np.float32)
    res = (rng.normal(size=(8, 2120)) * 0.1).astype(np.float32)
    jc = jcodecs.TopKCompressor(0.25)
    jm = None if mask is None else jnp.asarray(mask, bool)
    want, want_res = jax.jit(lambda v, r, m: jc.reduce(
        v, jreduce.SimWireOps((2, 4), level, m), r))(
            jnp.asarray(x), jnp.asarray(res), jm)
    tm = None if mask is None else torch.tensor(mask, dtype=torch.bool)
    got, got_res = tcodecs.TopKCompressor(0.25).reduce(
        torch.from_numpy(x), treduce.SimWireOps((2, 4), level, tm),
        torch.from_numpy(res))
    assert _eq(got_res, want_res)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-7)


def _data():
    x, y = make_classification(seed=0, num_classes=8, dim=24, per_class=80)
    return FederatedDataset(x, y, label_shard_partition(
        y, [[j] for j in range(8)], n_workers=8))


DS = _data()


def _topos(name):
    if name == "two_level":
        return (J.make_topology("two_level", n=8, N=2, G=16, I=4),
                P.make_topology("two_level", n=8, N=2, G=16, I=4))
    spec = ((2, 2, 2), (8, 4, 2))
    return (J.make_topology(J.HierarchySpec(*spec)),
            P.make_topology(P.HierarchySpec(*spec)))


def _engines(topo, wire=True, rate=0.25):
    jt, pt = _topos(topo)
    jm, pm = JModel(JConfig(**MODEL)), SimpleModel(SimpleConfig(**MODEL))
    je = J.HSGD(jm.loss, jsgd(0.08), jt, J.EngineConfig(
        comms=JC.Comms("topk", rate=rate, wire_reduce=wire)))
    pe = P.HSGD(pm.loss, sgd(0.08), pt, P.EngineConfig(
        comms=PC.Comms("topk", rate=rate, wire_reduce=wire)))
    p0 = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    js = je.init(jax.random.PRNGKey(0), jm.init)
    ps = pe.init_from_params(params_from_numpy(p0, device="cpu"),
                             device="cpu")
    return je, js, pe, ps


def _batch_j(t):
    return jax.tree.map(jnp.asarray, DS.batch(t, 10))


def _batch_p(t):
    return DS.batch(t, 10)


def _close(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    return np.abs(got - want).max() <= RTOL * np.abs(want).max()


def _assert_state_close(ps, js):
    jp = jax.device_get(js.params)
    for k in jp:
        for n in jp[k]:
            assert _close(ps.params[k][n], jp[k][n]), (k, n)
    jc = jax.device_get(js.comms)
    assert sorted(ps.comms) == sorted(jc)
    for k in jc:
        assert _close(ps.comms[k], jc[k]), k


@pytest.mark.parametrize("wire", [True, False])
@pytest.mark.parametrize("topo", ["two_level", "three_level"])
def test_topk_trajectory_matches_reference(topo, wire):
    je, js, pe, ps = _engines(topo, wire)
    assert ps.comms["float32"].shape == (8, 2120) and not ps.comms[
        "float32"].any()
    js, jh = je.run_rounds(js, _batch_j, T=32)
    ps, ph = pe.run_rounds(ps, _batch_p, T=32)
    _assert_state_close(ps, js)
    assert ps.comms["float32"].abs().max() > 0      # residuals carried
    ce_j = np.array([r["ce"] for r in jh])
    ce_p = np.array([r["ce"] for r in ph])
    assert np.abs(ce_p - ce_j).max() <= RTOL * np.abs(ce_j).max()
    assert [r["wire_bytes"] for r in ph] == [r["wire_bytes"] for r in jh]


def test_topk_masked_step_matches_reference():
    """Algorithm 1 with error feedback: a masked-out worker receives the
    aggregate and keeps its unconsumed residual."""
    je, js, pe, ps = _engines("two_level")
    mask = np.array([1, 0, 1, 1, 0, 1, 1, 1], bool)
    for t in range(8):
        js, _ = je.step(js, _batch_j(t), mask=mask)
        ps, _ = pe.step(ps, _batch_p(t), mask=mask)
    _assert_state_close(ps, js)
    assert ps.comms["float32"][1].abs().max() == 0  # worker 1 never sent


@pytest.mark.parametrize("rate", [0.25, 1 / 16])
def test_topk_wire_bytes_match_reference(rate):
    je, js, pe, ps = _engines("two_level", rate=rate)
    jw, pw = je.wire_stats(js), pe.wire_stats(ps)
    assert pw.payload_bytes == jw.payload_bytes
    assert [(a.name, a.shape, a.dtype) for a in pw.payload] == \
        [(a.name, tuple(a.shape), a.dtype) for a in jw.payload]
    assert pw.step_bytes(96) == jw.step_bytes(96)
    assert sum(pw.step_bytes(96)) == (864960 if rate == 0.25 else 215424)


@pytest.mark.parametrize("wire", [True, False])
@pytest.mark.parametrize("topo", ["two_level", "three_level"])
def test_topk_run_rounds_equals_step_bitwise(topo, wire):
    _, _, pe, s0 = _engines(topo, wire)
    sr, hist = pe.run_rounds(s0, _batch_p, T=16)
    ss = s0
    losses = []
    for t in range(16):
        ss, m = pe.step(ss, _batch_p(t))
        losses.append(float(m["ce"]))
    for k in ss.params:
        for n in ss.params[k]:
            assert torch.equal(sr.params[k][n], ss.params[k][n]), (k, n)
    assert torch.equal(sr.comms["float32"], ss.comms["float32"])
    assert [r["ce"] for r in hist] == losses
