"""The population regime of the port (``repro_torch.population``: the
sampler, ``SampledParticipation``, hydrate and fold-back; and
``repro_torch.data.PopulationShards``) against the JAX package.

The sampler and the shards are numpy copies, so they are held bit for bit:
draws, availability, sizes, labels and batches.  ``run_sampled`` starts
both packages from the params the reference's ``model.init`` draws and
sees the same numpy batches (the reference's world of
``tests/test_population.py``): server params agree within RTOL = 1e-5
relative (max |diff| over max |reference| per leaf), ``ce`` within RTOL,
and the ``participation`` channel and ``wire_bytes`` exactly.  Inside the
port: with k == population the sampled loop is bit for bit row 0 of the
materialized engine (sgd and adam), the weighted and nonzero folds match
a float64 host oracle, and a 10^6-client population keeps the state
bounded by k.  Both audits (the engine's and the population engine's)
return clean reports.  In a one-process
``gloo`` group the sampled loop runs on the mesh bit for bit as on the sim
(the eight-rank exact population is ``tests/test_torch_mesh_runtime.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro.data as JD  # noqa: E402
import repro.population as JP  # noqa: E402
from repro.models import SimpleConfig as JConfig  # noqa: E402
from repro.models import SimpleModel as JModel  # noqa: E402
from repro.optim import adam as jadam, sgd as jsgd  # noqa: E402

import repro_torch.core as P  # noqa: E402
import repro_torch.population as PP  # noqa: E402
from repro_torch.data import PopulationShards  # noqa: E402
from repro_torch.models import (SimpleConfig, SimpleModel,  # noqa: E402
                                params_from_numpy)
from repro_torch.obs import Metrics  # noqa: E402
from repro_torch.optim import adam, sgd  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

RTOL = 1e-5
GS, PERIODS = (2, 4), (4, 2)   # k = 8 slots, G = 4 steps per sampling round
DIM, CLASSES = 12, 6
MODEL = dict(kind="mlp", input_dim=DIM, hidden=16, num_classes=CLASSES)
SHARDS = dict(num_classes=CLASSES, dim=DIM, seed=5)
P_SHARDS = PopulationShards(population=8, **SHARDS)
J_SHARDS = JD.PopulationShards(population=8, **SHARDS)
P0 = jax.device_get(JModel(JConfig(**MODEL)).init(jax.random.PRNGKey(0)))


def _pb(ids, t):
    return P_SHARDS.batch(np.asarray(ids) % 8, t, 6)


def _jb(ids, t):
    return jax.tree.map(jnp.asarray,
                        J_SHARDS.batch(np.asarray(ids) % 8, t, 6))


def _port_engine(opt=None, **cfg):
    pm = SimpleModel(SimpleConfig(**MODEL))
    return P.HSGD(pm.loss, opt or sgd(0.1),
                  P.make_topology(P.HierarchySpec(GS, PERIODS)),
                  P.EngineConfig(**cfg))


def _server(eng):
    return eng.init_server_from_params(params_from_numpy(P0, device="cpu"),
                                       device="cpu")


def _assert_params_close(pparams, jparams):
    jp = jax.device_get(jparams)
    for k in jp:
        for n in jp[k]:
            want = np.asarray(jp[k][n])
            err = np.abs(pparams[k][n].numpy() - want).max()
            assert err <= RTOL * max(np.abs(want).max(), 1e-30), (k, n, err)


# ---------------------------------------------------------------------------
# the numpy modules, bit for bit
# ---------------------------------------------------------------------------
def test_sampler_draws_equal_reference():
    for kw in ({"cells": (50, 40), "seed": 9}, {"cells": GS},
               {"cells": (100, 100), "seed": 3, "p_available": 0.5},
               {"cells": (1000, 1000), "seed": 7},
               {"cells": (3, 5, 7), "seed": 1}):
        gs = (2, 2, 2) if len(kw["cells"]) == 3 else GS
        a = PP.HierarchicalSampler(PP.Population(**kw), gs)
        b = JP.HierarchicalSampler(JP.Population(**kw), gs)
        assert a.k == b.k
        for r in (3, 0, 11, 3):          # out of order: pure in (seed, r)
            da, db = a.draw(r), b.draw(r)
            assert np.array_equal(da.client_ids, db.client_ids)
            assert np.array_equal(da.paths, db.paths)
            assert np.array_equal(da.active, db.active)
            assert da.num_cells() == db.num_cells()
            assert da.grouping().assignment == db.grouping().assignment
        assert PP.Population(**kw).describe() == JP.Population(**kw).describe()
    for spec in (None, 16, (10, 20), [4, 2]):
        a, b = PP.make_population(spec), JP.make_population(spec)
        assert (a is None and b is None) or a.describe() == b.describe()
    for mod in (PP, JP):
        with pytest.raises(TypeError):
            mod.make_population("millions")
        with pytest.raises(ValueError, match="one fanout per"):
            mod.HierarchicalSampler(mod.Population(cells=(100,)), GS)
        with pytest.raises(ValueError, match="must be >="):
            mod.HierarchicalSampler(mod.Population(cells=(100, 2)), GS)
    for seed in (0, 5):
        a, b = PP.default_client_sizes(seed), JP.default_client_sizes(seed)
        assert [a(c) for c in (-1, 0, 7, 999_999)] == \
            [b(c) for c in (-1, 0, 7, 999_999)]


def test_population_shards_equal_reference():
    for pop in (8, 10**6):
        a = PopulationShards(population=pop, **SHARDS)
        b = JD.PopulationShards(population=pop, **SHARDS)
        assert a.describe() == b.describe()
        assert np.array_equal(a.mus, b.mus)
        ids = np.array([0, 3, 7, -1, 5, 2, 6, 1]) if pop == 8 else \
            np.array([999_999, 12, 500_000, -1, 3, 77, 4242, 8])
        for t in (0, 5):
            ba, bb = a.batch(ids, t, 6), b.batch(ids, t, 6)
            assert all(np.array_equal(ba[k], bb[k]) and
                       ba[k].dtype == bb[k].dtype for k in bb)
        for c in ids[ids >= 0]:
            assert np.array_equal(a.client_labels(c), b.client_labels(c))
            assert a.client_size(c) == b.client_size(c)
        assert a.size_fn()(int(ids[0])) == b.size_fn()(int(ids[0]))
        with pytest.raises(ValueError, match="outside the declared"):
            a.client_size(pop)


def test_sampled_participation_equals_reference():
    pop = dict(cells=(100, 100), seed=3, p_available=0.5)
    a = PP.SampledParticipation(PP.Population(**pop), GS, round_index=0)
    b = JP.SampledParticipation(JP.Population(**pop), GS, round_index=0)
    ev = P.SyncEvent(level=2)
    assert np.array_equal(a.round_mask(ev), b.round_mask(ev))
    assert not a.round_mask(ev).all()
    assert a.draw(0) is a.draw(0) and a.draw(4).round_index == 4
    assert a.describe() == b.describe()
    composed = PP.compose(PP.StaticParticipation(
        P.make_topology(P.HierarchySpec(GS, PERIODS))), None, a)
    assert isinstance(composed, PP.ComposedParticipation)
    assert np.array_equal(composed.round_mask(ev), a.round_mask(ev))
    assert composed.draw(0).round_index == 0
    assert PP.SampledParticipation(PP.Population(cells=GS), GS,
                                   round_index=1).round_mask(ev) is None


# ---------------------------------------------------------------------------
# run_sampled against the reference
# ---------------------------------------------------------------------------
CASES = {
    "sgd": (dict(cells=GS, seed=0), "sgd", None, 3),
    "adam": (dict(cells=GS, seed=0), "adam", None, 3),
    "weighted": (dict(cells=(100, 100), seed=1, p_available=0.6,
                      weighting="size"), "sgd", None, 4),
    "nonzero": (dict(cells=(10, 100), seed=3, fold="nonzero"), "sgd", None,
                3),
    "topk": (dict(cells=(10, 100), seed=2), "sgd", "topk", 3),
    "all_empty": (dict(cells=(100, 100), seed=0, p_available=0.0), "sgd",
                  None, 2),
    "elastic": (dict(cells=(10, 100), seed=4, staleness_decay=0.5), "sgd",
                None, 3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_run_sampled_matches_reference(case):
    """``elastic`` runs a bursty runtime whose deadline drops slots, so
    the fold-back discounts them by ``staleness_decay``."""
    pop, opt, comms, rounds = CASES[case]
    runtimes = (None, None)
    if case == "elastic":
        import repro.runtime as JR
        import repro_torch.runtime as PR
        runtimes = tuple(m.RuntimeModel(compute_s=1.0,
                                        straggler="bursty:0.25:0.5:2.5",
                                        policy=m.DeadlineElastic(1.0), seed=1)
                         for m in (JR, PR))
    jm, pm = JModel(JConfig(**MODEL)), SimpleModel(SimpleConfig(**MODEL))
    jo, po = (jsgd(0.1), sgd(0.1)) if opt == "sgd" else \
        (jadam(3e-3), adam(3e-3))
    je = J.HSGD(jm.loss, jo, J.make_topology(J.HierarchySpec(GS, PERIODS)),
                J.EngineConfig(comms=comms, runtime=runtimes[0],
                               population=JP.Population(**pop)))
    pe = P.HSGD(pm.loss, po, P.make_topology(P.HierarchySpec(GS, PERIODS)),
                P.EngineConfig(comms=comms, runtime=runtimes[1],
                               population=PP.Population(**pop)))
    assert pe.population_engine().fold_mode == \
        je.population_engine().fold_mode
    sizes = (P_SHARDS.size_fn(), J_SHARDS.size_fn()) \
        if pop.get("weighting") == "size" else (None, None)
    jsrv = je.init_server(jax.random.PRNGKey(0), jm.init)
    psrv = _server(pe)
    jsrv, jh = je.run_sampled(jsrv, _jb, rounds, sizes=sizes[1])
    psrv, ph = pe.run_sampled(psrv, _pb, rounds, sizes=sizes[0])
    _assert_params_close(psrv.params, jsrv.params)
    assert psrv.round == jsrv.round == rounds
    assert [h["participation"] for h in ph] == \
        [h["participation"] for h in jh]
    for p, j in zip(ph, jh):
        assert set(p) == set(j) and p["round"] == j["round"]
        assert p.get("wire_bytes") == j.get("wire_bytes")
        assert abs(p["ce"] - j["ce"]) <= RTOL * abs(j["ce"])
    if case == "elastic":
        assert sum(h["participation"]["stale_slots"] for h in ph) > 0
        assert [h["sim_time_s"] for h in ph] == [h["sim_time_s"] for h in jh]
    if case == "all_empty":
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(psrv.params), tree_leaves(_server(pe).params)))
        assert ph[0]["participation"]["active"] == 0


# ---------------------------------------------------------------------------
# inside the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_k_equals_population_is_bitwise_the_materialized_engine(opt):
    """cells == group_sizes, uniform weights: the sampled loop's server
    params and opt state are bit for bit row 0 of the materialized
    engine's; probes on in both change nothing of that."""
    make = (lambda: sgd(0.1)) if opt == "sgd" else (lambda: adam(3e-3))
    batch = lambda t: P_SHARDS.batch(np.arange(8), t, 6)
    base = _port_engine(make())
    st = base.init_from_params(params_from_numpy(P0, device="cpu"),
                               device="cpu")
    st, _ = base.run_rounds(st, batch, 3 * PERIODS[0])
    for metrics in (None, "on"):
        eng = _port_engine(make(), population=PP.Population(cells=GS),
                           metrics=metrics)
        server, hist = eng.run_sampled(_server(eng),
                                       lambda ids, t: batch(t), 3)
        for a, b in zip(tree_leaves(st.params), tree_leaves(server.params)):
            assert torch.equal(a[0], b)
        for name, v in st.opt_state.items():
            for a, b in zip(tree_leaves(v),
                            tree_leaves(server.opt_state[name])):
                assert torch.equal(a[0], b), name
        assert hist[-1]["participation"]["unique"] == 8
        assert [h["round"] for h in hist] == [1, 2, 3]


def test_weighted_and_nonzero_folds_match_host_oracle():
    eng = _port_engine(population=PP.Population(cells=GS, weighting="size"))
    popeng = eng.population_engine()
    server = _server(eng)
    sizes = P_SHARDS.size_fn()
    draw = popeng.sampler.draw(0)
    state = popeng.hydrate(server)
    # hydrate gives every slot its own storage, not k views of one
    assert all(x.stride(0) != 0 for x in tree_leaves(state.params))
    state, _ = popeng.inner.run_rounds(
        state, lambda t: _pb(draw.client_ids, t), PERIODS[0])
    w, meta = popeng.round_weights(draw, sizes)
    assert meta == {"active": 8, "stale_slots": 0}
    np.testing.assert_allclose(w, [sizes(int(c)) for c in draw.client_ids])
    folded = popeng.fold_back(server, state, w)
    for got, x in zip(tree_leaves(folded.params), tree_leaves(state.params)):
        want = np.average(x.numpy().astype(np.float64), axis=0, weights=w)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=1e-7)

    eng = _port_engine(population=PP.Population(cells=GS, fold="nonzero"))
    popeng = eng.population_engine()
    assert popeng.fold_mode == "nonzero"
    server = _server(eng)
    state = popeng.hydrate(server)
    # slot j moves only entries with (flat index % 8) == j; entries of
    # slots 6 and 7 have weight 0 and keep the server value
    w = np.array([1.0, 2.0, 3.0, 4.0, 1.0, 1.0, 0.0, 0.0])

    def perturb(x):
        idx = torch.arange(x[0].numel()).reshape(x.shape[1:]) % 8
        return torch.stack([x[j] + (idx == j) * (0.5 + j) for j in range(8)])

    state = dataclasses.replace(state, params={
        k: {n: perturb(x) for n, x in v.items()}
        for k, v in state.params.items()})
    folded = popeng.fold_back(server, state, w)
    for s, got in zip(tree_leaves(server.params),
                      tree_leaves(folded.params)):
        idx = np.arange(s.numel()).reshape(tuple(s.shape)) % 8
        delta = got.numpy().astype(np.float64) - s.numpy()
        assert np.isfinite(got.numpy()).all()
        for j in range(8):
            sel = idx == j
            want = 0.5 + j if w[j] > 0 else 0.0
            np.testing.assert_allclose(delta[sel], want, rtol=1e-5,
                                       atol=1e-12)
    # an all-zero weight vector keeps the server as it is
    assert popeng.fold_back(server, state, np.zeros(8)) is server


def test_million_client_state_bounded_by_k_with_probes():
    shards = PopulationShards(population=10**6, **SHARDS)
    eng = _port_engine(population=PP.Population(cells=(1000, 1000), seed=7),
                       metrics="on")
    assert eng.population.size == 10**6
    popeng = eng.population_engine()
    server = _server(eng)
    state = popeng.hydrate(server)
    for leaf in tree_leaves(state.params) + tree_leaves(state.opt_state):
        assert leaf.shape[0] == 8 and leaf.numel() <= 8 * 10_000
    assert state.metrics is not None and state.metrics.count == 0
    server, hist = eng.run_sampled(
        server, lambda ids, t: shards.batch(ids, t, 6), 2,
        sizes=shards.size_fn())
    assert all(torch.isfinite(x).all() for x in tree_leaves(server.params))
    p = hist[-1]["participation"]
    assert p["population"] == 10**6 and p["k"] == 8
    assert len(server.ledger.counts) <= 16
    # a round's record carries its last step's channels: grad_norm, and no
    # probe row, since that step is the global boundary the fold-back takes
    assert all(h["grad_norm"] > 0 and "div_global" not in h for h in hist)


def test_population_refusals():
    eng = _port_engine()
    with pytest.raises(ValueError, match="no population bound"):
        eng.init_server(torch.Generator().manual_seed(0), None, device="cpu")
    state = eng.init_from_params(params_from_numpy(P0, device="cpu"),
                                 device="cpu")
    rep = eng.audit(state)
    assert rep.events and rep.unwaived == ()
    eng = _port_engine(population=(100, 100))
    rep = eng.population_engine().audit(_server(eng))
    assert rep.events and rep.unwaived == ()
    pm = SimpleModel(SimpleConfig(**MODEL))
    with pytest.raises(TypeError, match="UniformTopology"):
        P.HSGD(pm.loss, sgd(0.1), P.GroupedTopology(
            P.contiguous(8, 2), G=8, I=2), P.EngineConfig(
                population=(4, 4))).population_engine()


def test_mesh_refuses_population_naming_a7d(tmp_path):
    """In a one-process ``gloo`` group, where the mesh refused a
    population at bind until it had the fold-back's gather: the sampled
    loop now runs on the mesh bit for bit as the sim's (k = 1)."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        pm = SimpleModel(SimpleConfig(**MODEL))
        runs = []
        for executor in ("mesh", None):
            eng = P.HSGD(pm.loss, sgd(0.1),
                         P.make_topology("local_sgd", n=1, P=4),
                         P.EngineConfig(executor=executor, population=(4,)))
            server, hist = eng.run_sampled(_server(eng), _pb, 2)
            runs.append((server, hist))
        (ms, mh), (ss, sh) = runs
        assert mh == sh and ms.round == 2
        for a, b in zip(tree_leaves(ms.params), tree_leaves(ss.params)):
            assert torch.equal(a, b)
        assert not all(torch.equal(a, b) for a, b in zip(
            tree_leaves(ms.params), tree_leaves(_server(eng).params)))
    finally:
        dist.destroy_process_group()


def test_bench_population_mesh_leg_is_the_sim():
    """The twin's mesh leg on the CPU (eight gloo ranks, quick): the
    10^6-client point's server bit for bit the sim loop's on every rank,
    with the draws the same on every rank."""
    from repro_torch.experiments import bench_population as bp
    report = bp.run(quick=True, device="cpu", backend="mesh")
    mesh = report["mesh"]
    assert mesh["params_bitwise_vs_sim"] and mesh["ranks_agree"]
    assert mesh["population"] == 10**6 and mesh["unique_clients"] == \
        report["sweep"][str(10**6)]["unique_clients"]
    # one rank holds one slot's row of the k = 8 hydrated state
    assert mesh["state_bytes"] * 8 == bp.BASELINE_STATE_BYTES
    with pytest.raises(ValueError, match="backend"):
        bp.run(quick=True, device="cpu", backend="tpu")


def test_metrics_plan_reaches_the_inner_engine():
    plan = Metrics(capacity=5)
    eng = _port_engine(population=PP.Population(cells=GS), metrics=plan)
    inner = eng.population_engine().inner
    assert inner.metrics is plan and inner.topology.event_at(3) is None
    assert inner.topology.event_at(1).level == 2
