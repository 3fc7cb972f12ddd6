"""The mesh lowering of the runtime, async, probes and population in the
port: ``MeshExecutor`` on ``torch.distributed``, eight ``gloo`` ranks on
the CPU, one process per worker.

One module-scoped launch runs every configuration in the same eight ranks;
the cases assert on its results:

* an elastic drop round: ``exact=True`` bit for bit the port's sim with
  top-k error-feedback residuals (a dropped row keeps its unconsumed
  residual); the production lowering within 5e-6 of the port's sim (the
  reference's bound for its mesh against its sim);
* an elastic runtime end to end on two_level, grouped (``contiguous(8,
  2)``, G=8, I=(2, 4)) and two_level with async ``{1: 1}`` (drops at
  stale boundaries): exact bit for bit the port's sim (pending slots
  included), ``sim_time_s`` and drops equal to the JAX package's, ``ce``
  within 1e-5 of it;
* async: staleness 0 bit for bit the barrier on the mesh; the exact stale
  path bit for bit the port's sim, pending slots included, for
  none/int8/sign/top-k/identity x ``{2: 1}``, ``{1: 1, 2: 1}``;
* probes: the mesh's rows within 1e-4 relative of the JAX sim's and within
  PROBE_ATOL of the row's largest of the port's sim; the staleness channel
  of an async run and the per-step path's rows drained by
  ``HSGD.drain_metrics`` likewise; ``grad_norm`` alone on the exact mesh
  bit for bit the sim's; metrics off bit for bit metrics on;
* the population: ``run_sampled`` on the exact mesh bit for bit the sim,
  full and partial participation;
* every rank's gathered state, clock history and draws the same.

The ranks import this module, so it imports no JAX at its top: the JAX
package enters only in the parent's test bodies.
"""
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

import repro_torch.comms as PC  # noqa: E402
import repro_torch.core as P  # noqa: E402
import repro_torch.population as PP  # noqa: E402
import repro_torch.runtime as PR  # noqa: E402
from repro_torch.data import (FederatedDataset, PopulationShards,  # noqa: E402
                              label_shard_partition, make_classification)
from repro_torch.launch.mesh import launch  # noqa: E402
from repro_torch.models import (SimpleConfig, SimpleModel,  # noqa: E402
                                params_from_numpy)
from repro_torch.obs import Metrics  # noqa: E402
from repro_torch.optim import momentum, sgd  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

MODEL = dict(kind="mlp", input_dim=24, hidden=32, num_classes=8)
WORLD = 8
SPAWN_TIMEOUT = 300.0
MASK = np.array([1, 0, 1, 1, 0, 1, 1, 1], bool)
DROP_ATOL = 5e-6        # tests/test_executors.py: mesh masked round vs sim
CE_ATOL = 1e-5          # tests/test_executors.py: grouped elastic ce
PROBE_RTOL = 1e-4       # tests/test_obs.py::test_sim_mesh_probe_parity
PROBE_ATOL = 1e-6       # of the row's largest, against the port's sim

TOPOS = {
    "two_level": lambda M: M.make_topology("two_level", n=8, N=2, G=16,
                                           I=4),
    "three_level": lambda M: M.make_topology(
        M.HierarchySpec((2, 2, 2), (8, 4, 2))),
    "grouped": lambda M: M.GroupedTopology(M.contiguous(8, 2), G=8,
                                           I=(2, 4)),
}
CODECS = {"none": None, "int8": ("int8", {}), "sign": ("sign", {}),
          "topk": ("topk", {"rate": 0.25}), "identity": ("identity", {})}
ASYNC = {"L2": {2: 1}, "L1L2": {1: 1, 2: 1}}
# the population world of tests/test_torch_population.py
POP_GS, POP_PERIODS = (2, 4), (4, 2)
POP_MODEL = dict(kind="mlp", input_dim=12, hidden=16, num_classes=6)
POP_SHARDS = dict(num_classes=6, dim=12, seed=5)
POPS = {"full": dict(cells=POP_GS, seed=0),
        "partial_int8": dict(cells=(10, 100), seed=3, p_available=0.6)}
POP_ROUNDS = 2


def _runtime(M, topo):
    """The reference's elastic runtimes of tests/test_executors.py."""
    if topo == "grouped":
        return M.RuntimeModel(compute_s=1.0, straggler="lognormal:0.9",
                              policy=0.25, seed=4)
    return M.RuntimeModel(compute_s=1.0, straggler="fixed:0.25:6",
                          policy=1.0, seed=11)


def _runs():
    """label -> run description (a dict of keyword arguments of
    ``_port_run``)."""
    runs = {
        "drop/exact/topk": dict(kind="drop", comms="topk", exact=True),
        "drop/prod/none": dict(kind="drop", comms="none", exact=False),
        "elastic/exact/two_level": dict(kind="elastic", topo="two_level",
                                        comms="topk_half", exact=True, T=16),
        "elastic/exact/grouped": dict(kind="elastic", topo="grouped",
                                      comms="none", exact=True, T=16),
        # a drop at a stale boundary: dropped rows keep their pending slots
        "elastic/exact/async": dict(kind="elastic", topo="two_level",
                                    comms="int8", exact=True,
                                    async_levels={1: 1}, T=32),
        "barrier/exact": dict(kind="rounds", exact=True),
        "stale0/exact": dict(kind="rounds", exact=True,
                             async_levels={1: 0}),
        "probes/prod/three_level": dict(kind="rounds", topo="three_level",
                                        metrics=True, T=16),
        "probes_off/prod/three_level": dict(kind="rounds",
                                            topo="three_level", T=16),
        "probes/exact/async": dict(kind="rounds", exact=True, metrics=True,
                                   async_levels={1: 1}, comms="int8",
                                   opt="momentum"),
        "probes_off/exact/async": dict(kind="rounds", exact=True,
                                       async_levels={1: 1}, comms="int8",
                                       opt="momentum"),
        # the per-step path with its rows drained by HSGD.drain_metrics
        "steps/prod/three_level": dict(kind="steps", topo="three_level",
                                       metrics=True, T=8),
        # grad_norm alone, no probe row
        "grad_norm/exact": dict(kind="rounds", metrics="grad_norm", T=16,
                                exact=True),
    }
    for codec in CODECS:
        for name, al in ASYNC.items():
            runs[f"stale/exact/{codec}/{name}"] = dict(
                kind="rounds", exact=True, comms=codec, async_levels=al)
    for name in POPS:
        runs[f"population/exact/{name}"] = dict(kind="population",
                                                pop=name, exact=True)
    return runs


RUNS = _runs()


def _data():
    x, y = make_classification(seed=0, num_classes=8, dim=24, per_class=80)
    return FederatedDataset(x, y, label_shard_partition(
        y, [[j] for j in range(8)], n_workers=8))


def _comms(C, name):
    if name == "topk_half":
        return C.Comms("topk", rate=0.5)
    spec = CODECS[name]
    return None if spec is None else C.Comms(spec[0], **spec[1])


def _np_tree(tree):
    return [x.detach().cpu().numpy() for x in tree_leaves(tree)]


def _pending_leaves(pending):
    out = []
    for lvl in sorted(pending or {}):
        slot = pending[lvl]
        for snap in slot.snaps:
            for field in ("params", "opt", "agg", "agg_opt"):
                out += _np_tree(getattr(snap, field))
        if slot.residual is not None:
            out += _np_tree(slot.residual)
    return out


def _port_run(kind, p0, executor=None, *, topo="two_level", comms="none",
              exact=False, async_levels=None, metrics=False, opt="sgd",
              T=32, pop=None):
    """One run of the port on the sim (``executor`` None) or on the mesh
    of this rank: the gathered state as numpy, the history's ce, clock and
    drops, and the probe rows."""
    ds = _data()
    model = SimpleModel(SimpleConfig(**MODEL))
    if kind == "population":
        return _population_run(pop, executor)
    if metrics == "grad_norm":
        metrics = Metrics(divergences=False)
    cfg = dict(executor=executor, comms=_comms(PC, comms),
               async_levels=async_levels,
               metrics=("on" if metrics is True else metrics) or None)
    if kind == "elastic":
        cfg["runtime"] = _runtime(PR, topo)
    engine = P.HSGD(model.loss, momentum(0.05) if opt == "momentum"
                    else sgd(0.05), TOPOS[topo](P), P.EngineConfig(**cfg))
    state = engine.init_from_params(params_from_numpy(p0, device="cpu"),
                                    device="cpu")
    batch = lambda t: ds.batch(t, 8)
    if kind == "drop":
        state, hist = engine.run_rounds(state, batch, 8)
        dev_batches = tuple({k: torch.as_tensor(v) for k, v in
                             engine.executor.local_rows(batch(t)).items()}
                            for t in range(8, 12))
        state, _ = engine.round_fn(P.Round(4, P.SyncEvent(level=1)),
                                   masked=True)(
            state, dev_batches, torch.as_tensor(MASK))
    elif kind == "steps":
        hist = []
        for t in range(T):
            state, m = engine.step(state, batch(t))
            hist.append({k: float(v) for k, v in m.items()})
        state, drained = engine.drain_metrics(state)
        hist[-1].update(drained[-1])
        for rec, row in zip(hist[1::2], drained):
            rec.update(row)
    else:
        state, hist = engine.run_rounds(state, batch, T)
    gather = engine.executor.gather
    return {
        "params": _np_tree(gather(state.params)),
        "opt": _np_tree(gather(state.opt_state)),
        "comms": None if state.comms is None
        else _np_tree(gather(state.comms)),
        "pending": None if state.pending is None
        else _pending_leaves(gather(state.pending)),
        "ce": [r["ce"] for r in hist],
        "clock": [(r.get("sim_time_s"), r.get("dropped")) for r in hist],
        "dropped": None if engine.runtime is None
        else engine.runtime_report()["dropped"],
        "rows": [{k: v for k, v in r.items() if k.startswith("div_")}
                 for r in hist if "div_global" in r],
        "metrics_count": None if state.metrics is None
        else state.metrics.count,
        "grad_norm": [r.get("grad_norm") for r in hist],
    }


def _population_run(name, executor):
    shards = PopulationShards(population=8, **POP_SHARDS)
    model = SimpleModel(SimpleConfig(**POP_MODEL))
    comms = "int8" if name.endswith("int8") else None
    eng = P.HSGD(model.loss, sgd(0.1), P.make_topology(
        P.HierarchySpec(POP_GS, POP_PERIODS)), P.EngineConfig(
            executor=executor, comms=comms,
            population=PP.Population(**POPS[name])))
    server = eng.init_server(torch.Generator().manual_seed(0), model.init,
                             device="cpu")
    popeng = eng.population_engine()
    draws = [popeng.sampler.draw(r).client_ids.tolist()
             for r in range(POP_ROUNDS)]
    server, hist = eng.run_sampled(
        server, lambda ids, t: shards.batch(np.asarray(ids) % 8, t, 6),
        POP_ROUNDS)
    return {"params": _np_tree(server.params),
            "opt": _np_tree(server.opt_state), "comms": None,
            "pending": None, "ce": [h["ce"] for h in hist],
            "clock": [h["participation"] for h in hist], "dropped": None,
            "rows": [], "metrics_count": None, "draws": draws,
            "grad_norm": []}


def _digest(run) -> str:
    h = hashlib.sha256()
    for key in ("params", "opt", "comms", "pending"):
        for a in run[key] or []:
            h.update(a.tobytes())
    return h.hexdigest()


def _rank_program(rank, p0):
    """Every run of RUNS on this rank.  Rank 0 returns its runs and every
    rank's digests, clock histories and draws."""
    out, summary = {}, {}
    for label, spec in RUNS.items():
        spec = dict(spec)
        exact = spec.pop("exact", False)
        run = _port_run(spec.pop("kind"), p0,
                        P.MeshExecutor(exact=exact), exact=exact, **spec)
        out[label] = run
        summary[label] = (_digest(run), run["clock"], run.get("draws"),
                          run["rows"])
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, summary)
    return {"runs": out, "ranks": everyone}


@pytest.fixture(scope="module")
def p0():
    jax = pytest.importorskip("jax")
    from repro.models import SimpleConfig as JConfig
    from repro.models import SimpleModel as JModel
    jm = JModel(JConfig(**MODEL))
    return {k: {n: np.asarray(v) for n, v in d.items()}
            for k, d in jax.device_get(
                jm.init(jax.random.PRNGKey(0))).items()}


@pytest.fixture(scope="module")
def mesh(p0):
    return launch(_rank_program, WORLD, backend="gloo", device="cpu",
                  args=(p0,), timeout=SPAWN_TIMEOUT)


_SIM = {}


def _sim(label, p0):
    """The port's sim run of ``label`` (cached: several cases read it)."""
    if label not in _SIM:
        spec = dict(RUNS[label])
        spec.pop("exact", None)
        _SIM[label] = _port_run(spec.pop("kind"), p0, **spec)
    return _SIM[label]


def _assert_state_equal(got, want, keys=("params", "opt", "comms",
                                         "pending")):
    for key in keys:
        assert (got[key] is None) == (want[key] is None), key
        for a, b in zip(got[key] or [], want[key] or []):
            assert np.array_equal(a, b), key
        assert len(got[key] or []) == len(want[key] or []), key


def _max_diff(a, b):
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


def _jax_elastic(label, p0):
    """The JAX package's sim run of an elastic configuration."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    import repro.comms as JC
    import repro.core as J
    import repro.runtime as JR
    from repro.models import SimpleConfig as JConfig
    from repro.models import SimpleModel as JModel
    from repro.optim import sgd as jsgd
    ds = _data()
    jm = JModel(JConfig(**MODEL))
    spec = RUNS[label]
    topo = spec["topo"]
    engine = J.HSGD(jm.loss, jsgd(0.05), TOPOS[topo](J), J.EngineConfig(
        comms=_comms(JC, spec["comms"]), runtime=_runtime(JR, topo),
        async_levels=spec.get("async_levels")))
    state = engine.init(jax.random.PRNGKey(0), jm.init)
    _, hist = engine.run_rounds(
        state, lambda t: jax.tree.map(jnp.asarray, ds.batch(t, 8)),
        spec["T"])
    return hist


# ---------------------------------------------------------------------------
# elastic drop rounds
# ---------------------------------------------------------------------------
def test_mesh_masked_round_exact_bitwise_with_residuals(mesh, p0):
    """A dropped worker keeps its post-update params, opt state and its
    unconsumed top-k residual; admitted rows replay the sim reduce."""
    got = mesh["runs"]["drop/exact/topk"]
    want = _sim("drop/exact/topk", p0)
    _assert_state_equal(got, want)
    assert any(np.abs(r).max() > 0 for r in got["comms"])


def test_mesh_masked_round_production_matches_sim(mesh, p0):
    got = mesh["runs"]["drop/prod/none"]
    want = _sim("drop/prod/none", p0)
    assert _max_diff(got["params"], want["params"]) < DROP_ATOL


@pytest.mark.parametrize("case", ["two_level", "grouped", "async"])
def test_mesh_elastic_runtime_end_to_end(mesh, p0, case):
    """Exact mesh bit for bit the port's sim (params, residuals, pending
    slots), the clock and drops equal to the JAX package's, ce within
    CE_ATOL of it.  ``async`` drops workers at stale boundaries."""
    label = f"elastic/exact/{case}"
    got, want = mesh["runs"][label], _sim(label, p0)
    assert sum(got["dropped"].values()) > 0
    assert got["dropped"] == want["dropped"]
    _assert_state_equal(got, want)
    assert got["ce"] == want["ce"] and got["clock"] == want["clock"]
    if case == "async":
        assert got["pending"] and got["dropped"][1] > 0
    jh = _jax_elastic(label, p0)
    assert [c[0] for c in got["clock"]] == [r["sim_time_s"] for r in jh]
    assert [c[1] for c in got["clock"]] == [r.get("dropped") for r in jh]
    assert all(abs(a - r["ce"]) < CE_ATOL for a, r in zip(got["ce"], jh))


# ---------------------------------------------------------------------------
# async stale folds
# ---------------------------------------------------------------------------
def test_staleness_zero_is_bitwise_barrier_mesh(mesh):
    a, b = mesh["runs"]["barrier/exact"], mesh["runs"]["stale0/exact"]
    _assert_state_equal(a, b)
    assert a["ce"] == b["ce"] and b["pending"] is None


@pytest.mark.parametrize("codec", list(CODECS))
@pytest.mark.parametrize("al", list(ASYNC))
def test_mesh_exact_stale_bitwise_vs_sim(mesh, p0, codec, al):
    label = f"stale/exact/{codec}/{al}"
    got, want = mesh["runs"][label], _sim(label, p0)
    _assert_state_equal(got, want)
    assert got["ce"] == want["ce"]
    assert got["pending"] and len(got["pending"]) == len(want["pending"])


# ---------------------------------------------------------------------------
# probes
# ---------------------------------------------------------------------------
def _assert_rows_close(got, want, rtol, atol_of_largest=None):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        big = max(abs(v) for v in w.values())
        for k in w:
            assert abs(g[k] - w[k]) <= rtol * max(abs(w[k]), 1e-8), (k, g, w)
            if atol_of_largest is not None:
                assert abs(g[k] - w[k]) <= atol_of_largest * big, (k, g, w)


def test_sim_mesh_probe_parity(mesh, p0):
    """The production mesh's rows (L+2 collectives) against the JAX sim's
    within the reference's 1e-4 and against the port's sim within
    PROBE_ATOL of the row's largest."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    import repro.core as J
    from repro.models import SimpleConfig as JConfig
    from repro.models import SimpleModel as JModel
    from repro.optim import sgd as jsgd
    label = "probes/prod/three_level"
    got = mesh["runs"][label]
    _assert_rows_close(got["rows"], _sim(label, p0)["rows"], PROBE_RTOL,
                       PROBE_ATOL)
    ds = _data()
    jm = JModel(JConfig(**MODEL))
    engine = J.HSGD(jm.loss, jsgd(0.05), TOPOS["three_level"](J),
                    J.EngineConfig(metrics="on"))
    state = engine.init(jax.random.PRNGKey(0), jm.init)
    _, jh = engine.run_rounds(
        state, lambda t: jax.tree.map(jnp.asarray, ds.batch(t, 8)), 16)
    jrows = [{k: v for k, v in r.items() if k.startswith("div_")}
             for r in jh if "div_global" in r]
    _assert_rows_close(got["rows"], jrows, PROBE_RTOL)
    assert len(got["rows"]) == 8 and got["metrics_count"] == 0


def test_mesh_staleness_channel_matches_sim(mesh, p0):
    """The exact async run with probes: the trajectory bit for bit the
    sim's, the rows (staleness channel included) to rounding, nonzero
    staleness exactly at the level-1 folds."""
    label = "probes/exact/async"
    got, want = mesh["runs"][label], _sim(label, p0)
    _assert_state_equal(got, want)
    _assert_rows_close(got["rows"], want["rows"], PROBE_RTOL, PROBE_ATOL)
    stale = [r["div_staleness"] for r in got["rows"]]
    assert sum(v > 0 for v in stale) == 1      # the fold at t = 32
    assert stale[-1] > 0


def test_mesh_step_path_drains_the_sim_rows(mesh, p0):
    """Per-step pushes on the mesh, drained by ``HSGD.drain_metrics`` on
    every rank: the sim's rows to rounding, the trajectory within
    DROP_ATOL."""
    label = "steps/prod/three_level"
    got, want = mesh["runs"][label], _sim(label, p0)
    _assert_rows_close(got["rows"], want["rows"], PROBE_RTOL, PROBE_ATOL)
    assert len(got["rows"]) == 4 and got["metrics_count"] == 0
    assert _max_diff(got["params"], want["params"]) < DROP_ATOL


def test_mesh_grad_norm_channel_is_the_sims(mesh, p0):
    """``grad_norm`` alone (no probe row) rides the round's one gather of
    the metrics: on the exact mesh bit for bit the sim's, as is the
    trajectory."""
    label = "grad_norm/exact"
    got, want = mesh["runs"][label], _sim(label, p0)
    assert got["grad_norm"] == want["grad_norm"]
    assert all(g > 0 for g in got["grad_norm"]) and got["rows"] == []
    _assert_state_equal(got, want, keys=("params",))


@pytest.mark.parametrize("pair", [("probes/prod/three_level",
                                   "probes_off/prod/three_level"),
                                  ("probes/exact/async",
                                   "probes_off/exact/async")])
def test_mesh_metrics_off_is_bitwise_identical(mesh, pair):
    on, off = (mesh["runs"][label] for label in pair)
    _assert_state_equal(on, off)
    assert on["ce"] == off["ce"] and off["rows"] == []


# ---------------------------------------------------------------------------
# the population regime
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(POPS))
def test_exact_mesh_population_bitwise(mesh, p0, name):
    label = f"population/exact/{name}"
    got, want = mesh["runs"][label], _sim(label, p0)
    _assert_state_equal(got, want, keys=("params", "opt"))
    assert got["ce"] == want["ce"] and got["clock"] == want["clock"]
    assert got["draws"] == want["draws"]
    if name == "partial_int8":
        assert any(p["active"] < 8 for p in got["clock"])


# ---------------------------------------------------------------------------
# every rank the same
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("label", sorted(RUNS))
def test_every_rank_has_the_same_state_clock_and_draws(mesh, label):
    first = mesh["ranks"][0][label]
    assert all(ranks[label] == first for ranks in mesh["ranks"])
