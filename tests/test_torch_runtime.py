"""The simulated runtime of the port (``repro_torch.runtime``, the
participation protocol, the topology's ``level_groupings``) and its engine
integration, against the JAX package.

The runtime modules are numpy copies of ``repro.runtime``, so they are held
bit for bit: sampler draws, policy parsing and admissions, and every clock
reading after the same sequence of ``advance``/``sync`` calls.  Engine runs
start both packages from the params the reference's ``model.init`` draws
and see the same numpy batches; their simulated fields (``sim_time_s``,
``sim_sync_s``, ``dropped``, ``runtime_report()``) are host numbers and
agree exactly, their losses within RTOL = 1e-5 relative, as the barrier
trajectories of ``tests/test_torch_hsgd.py``.  Inside the port: the
elastic-drop contract (a dropped worker keeps its post-update params,
opt state and unconsumed residuals bit for bit), a FullBarrier runtime bit
for bit the engine without one, and the planner's fit on a port history.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro.population as JPop  # noqa: E402
import repro.runtime as JR  # noqa: E402
from repro.models import SimpleConfig as JConfig  # noqa: E402
from repro.models import SimpleModel as JModel  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402

import repro_torch.comms as PC  # noqa: E402
import repro_torch.core as P  # noqa: E402
import repro_torch.population as PPop  # noqa: E402
import repro_torch.runtime as PR  # noqa: E402
from repro_torch.data import (FederatedDataset, label_shard_partition,  # noqa: E402
                              make_classification)
from repro_torch.models import (SimpleConfig, SimpleModel,  # noqa: E402
                                params_from_numpy)
from repro_torch.optim import momentum, sgd  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

RTOL = 1e-5
MODEL = dict(kind="mlp", input_dim=24, hidden=32, num_classes=8)
SPECS = {"two_level": ((2, 4), (8, 2)), "three_level": ((2, 2, 2), (8, 4, 2))}
LINKS = ((4.0, 1e8), (0.1, 1e9), (0.05, 1e10))
STRAGGLERS = ("none", "fixed:0.25:4", "fixed:0.125:8", "lognormal:0.7",
              "lognormal:0.8", "bursty:0.1:0.3:5", "bursty:0.25:0.5:2.5")


def _data():
    x, y = make_classification(seed=0, num_classes=8, dim=24, per_class=80)
    return FederatedDataset(x, y, label_shard_partition(
        y, [[j] for j in range(8)], n_workers=8))


DS = _data()


def _batch_j(t):
    return jax.tree.map(jnp.asarray, DS.batch(t, 10))


def _batch_p(t):
    return DS.batch(t, 10)


def _topos(kind):
    if kind == "grouped":
        return (J.GroupedTopology(J.contiguous(8, 2), G=8, I=(2, 4)),
                P.GroupedTopology(P.contiguous(8, 2), G=8, I=(2, 4)))
    spec = SPECS[kind]
    return (J.make_topology(J.HierarchySpec(*spec)),
            P.make_topology(P.HierarchySpec(*spec)))


def _runtimes(n_levels, straggler, policy, seed=1):
    links = LINKS[:n_levels]
    return (JR.RuntimeModel(compute_s=1.0,
                            links=tuple(JR.LinkModel(*l) for l in links),
                            straggler=straggler, policy=policy, seed=seed),
            PR.RuntimeModel(compute_s=1.0,
                            links=tuple(PR.LinkModel(*l) for l in links),
                            straggler=straggler, policy=policy, seed=seed))


# ---------------------------------------------------------------------------
# the numpy modules, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec", STRAGGLERS)
def test_sampler_draws_equal_reference(spec):
    for n, seed in ((8, 0), (8, 3), (16, 1)):
        a = JR.make_straggler(spec, n=n, seed=seed)
        b = PR.make_straggler(spec, n=n, seed=seed)
        assert repr(a) == repr(b) and a.params() == b.params()
        for t in (7, 0, 3, 31, 1):      # out of order: pure in (seed, t)
            assert np.array_equal(a.multipliers(t), b.multipliers(t))
        if hasattr(a, "slow_set"):
            assert np.array_equal(a.slow_set, b.slow_set)


def test_sampler_parsing_equals_reference():
    s = PR.make_straggler("fixed:0.5:3", n=8, seed=0)
    r = PR.make_straggler(s, n=6, seed=9)       # rebind keeps the regime
    assert (r.n, r.seed, r.params()) == (6, 9, s.params())
    assert sorted(PR.STRAGGLERS) == sorted(JR.STRAGGLERS)
    for bad, err in (("nope", KeyError), ("lognormal:1:2:3:4", ValueError)):
        with pytest.raises(err):
            JR.make_straggler(bad, n=4)
        with pytest.raises(err):
            PR.make_straggler(bad, n=4)


def test_policy_parsing_and_admission_equal_reference():
    rng = np.random.default_rng(0)
    arrivals = [np.array([1.0, 1.4, 9.0]), rng.exponential(2.0, 7),
                np.array([3.0, 3.0, 3.0, 3.0])]
    for spec in (None, "full", "barrier", 2.0, 0.5, "2.0", "L1:2.0,L2:0.5",
                 {1: 2.0, 3: 0.25}, JR.DeadlineElastic(1.0, anchor="min")):
        pspec = PR.DeadlineElastic(1.0, anchor="min") \
            if isinstance(spec, JR.DeadlineElastic) else spec
        a, b = JR.make_policy(spec), PR.make_policy(pspec)
        assert repr(a) == repr(b) and a.elastic == b.elastic
        for lvl in (1, 2, 3):
            if isinstance(a, JR.DeadlineElastic):
                assert a.deadline(lvl) == b.deadline(lvl)
            for arr in arrivals:
                assert np.array_equal(a.admit(lvl, arr), b.admit(lvl, arr))
    for bad in ("L1:", "Lx:1"):
        with pytest.raises(ValueError):
            JR.make_policy(bad)
        with pytest.raises(ValueError):
            PR.make_policy(bad)


def test_make_runtime_resolution():
    assert PR.make_runtime(None) is None
    rt = PR.RuntimeModel(compute_s=2.0)
    assert PR.make_runtime(rt) is rt
    assert PR.make_runtime(compute_s=3.0).compute_s == 3.0
    assert not PR.RuntimeModel(compute_s=1.0).elastic
    assert PR.RuntimeModel(compute_s=1.0, policy=1.0).elastic
    assert [(l.latency_s, l.bandwidth_Bps) for l in PR.default_links(3)] == \
        [(l.latency_s, l.bandwidth_Bps) for l in JR.default_links(3)]


def _clock_reading(ck):
    return (ck.time_s, ck.level_seconds(), ck.breakdown(),
            {k: v.tolist() for k, v in ck.last_admitted.items()},
            dict(ck.last_sync_time), ck.clocks.tolist())


# async levels need full-level events, which the grouped topology's
# per-group periods do not emit at level 2
CLOCK_CASES = [(kind, policy, al) for kind in ("two_level", "three_level")
               for policy in (None, 1.0)
               for al in (None, {1: 1}, {2: 2})] + \
    [("grouped", policy, al) for policy in (None, 1.0) for al in (None,)]


@pytest.mark.parametrize("kind,policy,async_levels", CLOCK_CASES)
def test_clock_readings_equal_reference(kind, policy, async_levels):
    jt, pt = _topos(kind)
    n_levels = len(jt.periods)
    for straggler in ("fixed:0.25:6", "lognormal:0.9", "bursty:0.25:0.5:2.5"):
        jr, pr = _runtimes(n_levels, straggler, policy, seed=7)
        jc = jr.clock(jt, 4096, async_levels=async_levels)
        pc = pr.clock(pt, 4096, async_levels=async_levels)
        assert [jc.event_cost_s(l) for l in range(1, n_levels + 1)] == \
            [pc.event_cost_s(l) for l in range(1, n_levels + 1)]
        for t in range(48):
            jc.advance(t)
            pc.advance(t)
            ev, pev = jt.event_at(t), pt.event_at(t)
            assert (ev is None and pev is None) or \
                (ev.level, ev.groups) == (pev.level, pev.groups)
            if ev is not None:
                jm, pm = jc.sync(ev), pc.sync(pev)
                assert (jm is None) == (pm is None)
                if jm is not None:
                    assert np.array_equal(jm, pm)
            assert _clock_reading(jc) == _clock_reading(pc), (straggler, t)


@pytest.mark.parametrize("kind", ["two_level", "three_level", "grouped"])
def test_level_groupings_and_participation_equal_reference(kind):
    jt, pt = _topos(kind)
    jg, pg = jt.level_groupings(), pt.level_groupings()
    assert sorted(jg) == sorted(pg)
    for lvl in jg:
        assert jg[lvl].N == pg[lvl].N
        for i in range(jg[lvl].N):
            assert np.array_equal(jg[lvl].members(i), pg[lvl].members(i))
    jp, pp = jt.participation(), pt.participation()
    assert isinstance(pp, PPop.StaticParticipation)
    for t in range(16):
        ev = pt.event_at(t)
        if ev is None:
            continue
        want = jp.event_mask(jt.event_at(t))
        got = pp.event_mask(ev)
        assert (want is None and got is None) or np.array_equal(want, got)
        assert pp.round_mask(ev) is None and pp.draw(t) is None


def test_participation_composition_equals_reference():
    """``compose`` ANDs the members' round masks (calling each once) and
    drops Nones, in both packages."""
    m1 = np.array([1, 1, 0, 1], bool)
    m2 = np.array([1, 0, 1, 1], bool)

    def fixed(base, m):
        return type("Fixed", (base,), {"round_mask": lambda self, ev: m})()

    jcomp = JPop.compose(fixed(JPop.Participation, m1), None,
                         fixed(JPop.Participation, m2))
    pcomp = PPop.compose(fixed(PPop.Participation, m1), None,
                         fixed(PPop.Participation, m2))
    assert np.array_equal(jcomp.round_mask(J.SyncEvent(level=1)),
                          pcomp.round_mask(P.SyncEvent(level=1)))
    assert pcomp.describe()["kind"] == jcomp.describe()["kind"]
    assert isinstance(PPop.compose(), PPop.FullParticipation)
    one = PPop.StaticParticipation(P.make_topology("two_level", n=4, N=2,
                                                   G=4, I=2))
    assert PPop.compose(None, one) is one


# ---------------------------------------------------------------------------
# engine integration, against the reference
# ---------------------------------------------------------------------------
def _engines(kind, runtimes, opt=(jsgd(0.08), sgd(0.08)), comms=(None, None),
             **cfg):
    jt, pt = _topos(kind)
    jm, pm = JModel(JConfig(**MODEL)), SimpleModel(SimpleConfig(**MODEL))
    je = J.HSGD(jm.loss, opt[0], jt, J.EngineConfig(
        runtime=runtimes[0], comms=comms[0], **cfg))
    pe = P.HSGD(pm.loss, opt[1], pt, P.EngineConfig(
        runtime=runtimes[1], comms=comms[1], **cfg))
    p0 = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    js = je.init(jax.random.PRNGKey(0), jm.init)
    ps = pe.init_from_params(params_from_numpy(p0, device="cpu"),
                             device="cpu")
    return je, js, pe, ps


def _assert_sim_history(ph, jh):
    assert [r["t"] for r in ph] == [r["t"] for r in jh]
    for key in ("sim_time_s", "sim_sync_s", "dropped", "wire_bytes"):
        assert [r.get(key) for r in ph] == [r.get(key) for r in jh], key
    ce_j = np.array([r["ce"] for r in jh])
    ce_p = np.array([r["ce"] for r in ph])
    assert np.abs(ce_p - ce_j).max() <= RTOL * np.abs(ce_j).max()


def _assert_params_close(pparams, jparams):
    jp = jax.device_get(jparams)
    for k in jp:
        for n in jp[k]:
            want = np.asarray(jp[k][n])
            err = np.abs(pparams[k][n].numpy() - want).max()
            assert err <= RTOL * np.abs(want).max(), (k, n, err)


@pytest.mark.parametrize("policy", [None, 2.0])
@pytest.mark.parametrize("straggler", ["fixed:0.125:8", "bursty:0.25:0.5:2.5"])
@pytest.mark.parametrize("kind", ["two_level", "three_level"])
def test_run_rounds_with_runtime_matches_reference(kind, straggler, policy):
    je, js, pe, ps = _engines(kind, _runtimes(len(SPECS[kind][0]),
                                              straggler, policy))
    js, jh = je.run_rounds(js, _batch_j, T=48)
    ps, ph = pe.run_rounds(ps, _batch_p, T=48)
    _assert_sim_history(ph, jh)
    _assert_params_close(ps.params, js.params)
    assert pe.runtime_report() == je.runtime_report()
    assert pe.runtime_report(ps) == pe.runtime_report()
    assert pe._payload_nbytes(ps) == je._payload_nbytes(js)
    if policy is not None:
        assert sum(r.get("dropped", 0) for r in ph) > 0


@pytest.mark.parametrize("comms", ["int8", "sign"])
def test_elastic_runtime_with_codec_matches_reference(comms):
    """A masked round's wire sync (``SimWireOps(..., mask)``) under the
    int8 and sign codecs; the clock prices the encoded payload."""
    je, js, pe, ps = _engines(
        "two_level", _runtimes(2, "bursty:0.25:0.5:2.5", 2.0),
        comms=(comms, comms))
    js, jh = je.run_rounds(js, _batch_j, T=48)
    ps, ph = pe.run_rounds(ps, _batch_p, T=48)
    assert pe._payload_nbytes(ps) == je._payload_nbytes(js) == \
        pe.wire_stats(ps).payload_bytes
    _assert_sim_history(ph, jh)
    _assert_params_close(ps.params, js.params)
    assert sum(pe.runtime_report()["dropped"].values()) > 0


def test_grouped_topology_elastic_runtime_matches_reference():
    """Partial-group events and deadline drops compose."""
    je, js, pe, ps = _engines("grouped", _runtimes(2, "lognormal:0.9", 0.25,
                                                   seed=4))
    js, jh = je.run_rounds(js, _batch_j, T=16)
    ps, ph = pe.run_rounds(ps, _batch_p, T=16)
    _assert_sim_history(ph, jh)
    assert sum(pe.runtime_report()["dropped"].values()) > 0


# ---------------------------------------------------------------------------
# inside the port
# ---------------------------------------------------------------------------
def _port_engine(spec=((2, 4), (8, 2)), opt=None, **cfg):
    pm = SimpleModel(SimpleConfig(**MODEL))
    eng = P.HSGD(pm.loss, opt or sgd(0.05),
                 P.make_topology(P.HierarchySpec(*spec)),
                 P.EngineConfig(**cfg))
    st = eng.init(torch.Generator().manual_seed(0), pm.init, device="cpu")
    return eng, st


def _batches(t0, n):
    return tuple({k: torch.as_tensor(v) for k, v in DS.batch(t, 10).items()}
                 for t in range(t0, t0 + n))


def _rows(tree, mask):
    return [x[torch.as_tensor(mask)] for x in tree_leaves(tree)]


def test_full_barrier_runtime_is_bitwise_no_runtime():
    e0, s0 = _port_engine()
    e1, s1 = _port_engine(runtime=PR.RuntimeModel(compute_s=1.0))
    s0, h0 = e0.run_rounds(s0, _batch_p, T=16)
    s1, h1 = e1.run_rounds(s1, _batch_p, T=16)
    for a, b in zip(tree_leaves(s0.params),
                    tree_leaves(s1.params)):
        assert torch.equal(a, b)
    assert [r["ce"] for r in h0] == [r["ce"] for r in h1]
    assert "sim_time_s" not in h0[0]
    assert h1[0]["sim_time_s"] > 0.0 and "sim_sync_s" in h1[0]
    assert e0.runtime_report() is None


@pytest.mark.parametrize("comms", [None, "int8"])
def test_elastic_drop_contract_params_and_opt(comms):
    """A worker dropped from a sync has exactly the params and opt state
    of a round that ended with no sync; admitted workers got the masked
    aggregate (neither the unsynced nor the unmasked state)."""
    eng, st = _port_engine(((2, 4), (4, 4)), opt=momentum(0.05),
                           comms=comms)
    batches = _batches(0, 4)
    mask = np.array([1, 1, 0, 1, 1, 0, 1, 1], bool)
    ev = P.SyncEvent(level=1)
    dropped, _ = eng.round_fn(P.Round(4, ev), masked=True)(
        st, batches, torch.as_tensor(mask))
    nosync, _ = eng.round_fn(P.Round(4, None))(st, batches)
    full, _ = eng.round_fn(P.Round(4, ev))(st, batches)
    for tree in ("params", "opt_state"):
        for d, n in zip(_rows(getattr(dropped, tree), ~mask),
                        _rows(getattr(nosync, tree), ~mask)):
            assert torch.equal(d, n)
    for other in (nosync, full):
        assert any(not torch.equal(a, b) for a, b in zip(
            _rows(dropped.params, mask), _rows(other.params, mask)))


def test_elastic_drop_contract_comms_residuals():
    """Across a missed sync a dropped worker keeps its unconsumed
    error-feedback residual bit for bit (top-k, the stateful codec; int8
    and sign carry none), while admitted workers' residuals move."""
    eng, st = _port_engine(((2, 4), (4, 4)),
                           comms=PC.Comms("topk", rate=0.25))
    st, _ = eng.run_rounds(st, _batch_p, T=8)
    assert max(float(r.abs().max()) for r in
               tree_leaves(st.comms)) > 0
    mask = np.array([1, 0, 1, 1, 1, 1, 0, 1], bool)
    nxt, _ = eng.round_fn(P.Round(4, P.SyncEvent(level=1)), masked=True)(
        st, _batches(8, 4), torch.as_tensor(mask))
    for new, old in zip(tree_leaves(nxt.comms),
                        tree_leaves(st.comms)):
        assert torch.equal(new[torch.as_tensor(~mask)],
                           old[torch.as_tensor(~mask)])
        m = torch.as_tensor(mask)
        assert float((new[m] - old[m]).abs().max()) > 0.0


def test_comm_model_fit_from_port_trace():
    """On a homogeneous full-barrier run the clock IS the CommModel closed
    form: the fit on a port history recovers the constants, also on a
    resumed trace."""
    # the reference test's world: its smaller payload keeps the fit's
    # error, which the 6-place rounding of sim_time_s sets, under 1e-6
    x, y = make_classification(0, num_classes=8, dim=16, per_class=40)
    ds = FederatedDataset(x, y, label_shard_partition(
        y, [[j] for j in range(8)]))
    pm = SimpleModel(SimpleConfig(kind="mlp", input_dim=16, hidden=24,
                                  num_classes=8))
    links = (PR.LinkModel(2.0, 1e8), PR.LinkModel(0.1, 1e9))
    rt = PR.RuntimeModel(compute_s=0.5, links=links)
    topo = P.make_topology(P.HierarchySpec((2, 4), (8, 2)))
    eng = P.HSGD(pm.loss, sgd(0.05), topo, P.EngineConfig(runtime=rt))
    st = eng.init(torch.Generator().manual_seed(0), pm.init, device="cpu")
    batch = lambda t: ds.batch(t, 8)
    st, hist = eng.run_rounds(st, batch, T=32)
    fit = P.CommModel.fit_from_trace(hist, topo)
    clock = rt.clock(topo, eng._payload_nbytes(st))
    assert fit.compute_s == pytest.approx(0.5, rel=1e-6)
    assert fit.global_round_s == pytest.approx(clock.event_cost_s(1),
                                               rel=1e-6)
    assert fit.local_round_s == pytest.approx(clock.event_cost_s(2), rel=1e-6)
    assert fit.wall_clock(32, G=8, I=2) == pytest.approx(
        hist[-1]["sim_time_s"], rel=1e-6)
    st, hist2 = eng.run_rounds(st, batch, T=32)
    assert hist2[0]["t"] == 33
    fit2 = P.CommModel.fit_from_trace(hist2, topo)
    assert fit2.local_round_s == pytest.approx(fit.local_round_s, rel=1e-6)
    assert fit2.global_round_s == pytest.approx(fit.global_round_s, rel=1e-6)
