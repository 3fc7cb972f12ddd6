"""The observability layer of the port (``repro_torch.obs``: the metrics
bus, the trace exporter, the probes and their engine integration) against
the JAX package's ``repro.obs``.

The bus and the trace exporter are copies, so they are held bit for bit:
the registry, ``validate_record``'s complaints, the trace JSON of the same
calls and ``validate_trace``'s verdicts.  ``Metrics``' layout (channels,
history keys, op budget) is equal.  Engine runs start both packages from
the params the reference's ``model.init`` draws and see the same numpy
batches (the reference's tiny world of ``tests/test_obs.py``): every
``div_*`` value agrees within DIV_RTOL = 1e-5 of the largest channel of its
row, ``grad_norm`` and ``ce`` within RTOL = 1e-5 relative, and every record
carries the same keys.  Inside the port: probes change no param bit, the
staleness channel reads 0 except at stale folds, and the mesh executor
refuses a metrics plan naming A7d.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro.obs as JO  # noqa: E402
import repro.runtime as JR  # noqa: E402
from repro.models import SimpleConfig as JConfig  # noqa: E402
from repro.models import SimpleModel as JModel  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402

import repro_torch.core as P  # noqa: E402
import repro_torch.obs as PO  # noqa: E402
import repro_torch.runtime as PR  # noqa: E402
from repro_torch.models import (SimpleConfig, SimpleModel,  # noqa: E402
                                params_from_numpy)
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

N = 8
RTOL = 1e-5
DIV_RTOL = 1e-5
MODEL = dict(kind="mlp", input_dim=16, hidden=8, num_classes=4)
SPECS = {"two_level": ((2, 4), (8, 2)), "three_level": ((2, 2, 2), (8, 4, 2))}


def _batches(T):
    rng = np.random.default_rng(0)
    return [{"x": rng.standard_normal((N, 4, 16)).astype(np.float32),
             "y": rng.integers(0, 4, (N, 4)).astype(np.int32)}
            for _ in range(T)]


BATCHES = _batches(32)


def _jb(t):
    return jax.tree.map(jnp.asarray, BATCHES[t])


def _pb(t):
    return BATCHES[t]


def _engines(spec="three_level", metrics="on", **cfg):
    jm, pm = JModel(JConfig(**MODEL)), SimpleModel(SimpleConfig(**MODEL))
    jcfg, pcfg = dict(cfg), dict(cfg)
    if "runtime" in cfg:
        jcfg["runtime"], pcfg["runtime"] = cfg["runtime"]
    if isinstance(metrics, tuple):
        jmet, pmet = metrics
    else:
        jmet = pmet = metrics
    je = J.HSGD(jm.loss, jsgd(0.1), J.make_topology(
        J.HierarchySpec(*SPECS[spec])), J.EngineConfig(metrics=jmet, **jcfg))
    pe = P.HSGD(pm.loss, sgd(0.1), P.make_topology(
        P.HierarchySpec(*SPECS[spec])), P.EngineConfig(metrics=pmet, **pcfg))
    p0 = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    js = je.init(jax.random.PRNGKey(0), jm.init)
    ps = pe.init_from_params(params_from_numpy(p0, device="cpu"),
                             device="cpu")
    return je, js, pe, ps


def _assert_rows_close(prow, jrow, keys=None):
    keys = [k for k in jrow if k.startswith("div_")] if keys is None \
        else keys
    big = max(abs(jrow[k]) for k in keys)
    for k in keys:
        assert abs(prow[k] - jrow[k]) <= DIV_RTOL * big, (k, prow, jrow)


def _assert_history_close(ph, jh):
    assert len(ph) == len(jh)
    for p, j in zip(ph, jh):
        assert set(p) == set(j), set(p) ^ set(j)
        assert p["t"] == j["t"]
        for k in ("ce", "grad_norm"):
            if k in j:
                assert abs(p[k] - j[k]) <= RTOL * abs(j[k]), (k, p, j)
        if "div_global" in j:
            _assert_rows_close(p, j)
        for k in ("wire_bytes", "sim_time_s", "sim_sync_s", "dropped"):
            assert p.get(k) == j.get(k), k


# ---------------------------------------------------------------------------
# the bus and the trace exporter: copies, bit for bit
# ---------------------------------------------------------------------------
def test_bus_registry_and_validation_equal_reference():
    fields = lambda s: (s.name, s.kind, s.source, s.units, s.doc)
    assert [fields(s) for s in PO.registered_metrics()] == \
        [fields(s) for s in JO.registered_metrics()]
    assert PO.SCHEMA_VERSION == JO.SCHEMA_VERSION
    for key in ("div_up_L3", "div_down_L1", "sim_sync_s", "t", "round",
                "participation", "no_such_channel", "div_staleness"):
        a, b = PO.spec_for(key), JO.spec_for(key)
        assert (a is None) == (b is None) and \
            (a is None or fields(a) == fields(b)), key
    records = [
        {"t": 3, "ce": 1.25, "div_global": 0.1, "grad_norm": 2.0,
         "wire_bytes": 128, "sim_sync_s": {"L1": 0.2}},
        {"t": 1.5, "sim_sync_s": 3.0, "dropped": True},
        {"my_custom": 1.0}, {"participation": [1], "round": 2.0},
        {"ce": np.float32(1.0), "t": np.int64(4), "acc": "x"},
    ]
    for rec in records:
        for strict in (False, True):
            assert PO.validate_record(rec, strict=strict) == \
                JO.validate_record(rec, strict=strict), (rec, strict)
    for mod in (PO, JO):
        with pytest.raises(ValueError, match="already registered"):
            mod.register_metric(mod.MetricSpec("t"))


def _trace_calls(rec):
    rec.compute_span(0, 0.0, 1.0)
    rec.compute_span(3, 0.5, 1.25)
    rec.wait_span(0, 2, 1.0, 0.5)
    rec.sync_span(2, 1.5, 0.25, payload_bytes=1024, dropped=1)
    rec.sync_span(1, 2.0, 0.125, extra={"stale": True})
    rec.divergences(4, 2, 1.75, {"global": 0.5, "up_L1": 0.2})
    rec.instant("mark", 3.0, pid=1, tid=0)
    return rec


def test_trace_json_and_validation_equal_reference(tmp_path):
    prec, jrec = _trace_calls(PO.TraceRecorder()), \
        _trace_calls(JO.TraceRecorder())
    assert prec.to_json() == jrec.to_json()
    assert PO.validate_trace(prec) == JO.validate_trace(jrec) == []
    prec.save(tmp_path / "p.json")
    jrec.save(tmp_path / "j.json")
    assert (tmp_path / "p.json").read_text() == \
        (tmp_path / "j.json").read_text()
    bad = [[1, 2, 3], {"events": []},
           {"traceEvents": [{"name": "x", "ph": "Q", "pid": 0, "tid": 0,
                             "ts": 0}]},
           {"traceEvents": [{"name": "x", "ph": "X", "pid": 0, "tid": 0,
                             "ts": -1, "dur": 1}]},
           {"traceEvents": [{"name": "x", "ph": "X", "pid": 0, "tid": 0,
                             "ts": 0}]},
           {"traceEvents": [{"ph": "C", "pid": 0, "tid": 0, "ts": 0}]},
           {"traceEvents": [7, {"name": "m", "ph": "M", "pid": 0}]}]
    for obj in bad:
        errs = PO.validate_trace(obj)
        assert errs and errs == JO.validate_trace(obj), obj


# ---------------------------------------------------------------------------
# the plan and the ring
# ---------------------------------------------------------------------------
def test_buffer_push_wrap_reset_equal_reference():
    pbuf, jbuf = PO.MetricBuffer.zeros(3, 2), JO.MetricBuffer.zeros(3, 2)
    for i in range(4):  # one past capacity: the ring wraps
        old = pbuf
        pbuf = pbuf.push(torch.full((2,), float(i)))
        jbuf = jbuf.push(jnp.full((2,), float(i)))
        assert pbuf.count == int(jbuf.count) == i + 1
        assert old.count == i        # a push leaves the old buffer as it was
    assert torch.equal(pbuf.rows, torch.as_tensor(np.asarray(jbuf.rows)))
    assert pbuf.rows[0].tolist() == [3.0, 3.0]
    rows = pbuf.rows
    pbuf, jbuf = pbuf.reset(), jbuf.reset()
    assert pbuf.count == int(jbuf.count) == 0 and pbuf.capacity == 3
    assert pbuf.rows is rows         # the storage is kept


def test_make_metrics_and_layout_equal_reference():
    assert PO.make_metrics(None) is None and PO.make_metrics(False) is None
    for spec in (True, "on", "ON"):
        assert PO.make_metrics(spec) == PO.Metrics()
    plan = PO.Metrics(grad_norm=False, capacity=7)
    assert PO.make_metrics(plan) is plan
    with pytest.raises(AssertionError):
        PO.make_metrics("sideways")
    topos = [(J.make_topology(J.HierarchySpec(*SPECS[s])),
              P.make_topology(P.HierarchySpec(*SPECS[s]))) for s in SPECS]
    topos.append((J.make_topology("local_sgd", n=4, P=4),
                  P.make_topology("local_sgd", n=4, P=4)))
    topos.append((J.GroupedTopology(J.contiguous(8, 2), G=8, I=(2, 4)),
                  P.GroupedTopology(P.contiguous(8, 2), G=8, I=(2, 4))))
    for kw in ({}, {"staleness": True}, {"grad_norm": False},
               {"divergences": False, "grad_norm": False}):
        jm, pm = JO.Metrics(**kw), PO.Metrics(**kw)
        for jt, pt in topos:
            assert pm.levels(pt) == jm.levels(jt)
            assert pm.channels(pt) == jm.channels(jt)
            assert pm.history_keys(pt) == jm.history_keys(jt)
            for backend in ("sim", "mesh"):
                for leaves in (2, 4, 6):
                    assert pm.op_budget(backend, pt, leaves) == \
                        jm.op_budget(backend, jt, leaves)
    with pytest.raises(NotImplementedError, match="A7d"):
        PO.Metrics().mesh_row_fn(topos[0][1])


@pytest.mark.parametrize("spec", ["two_level", "three_level", "grouped"])
def test_probe_row_equals_reference(spec):
    """The sim probe row on shared spread params, nested groupings and
    not, against the reference's ``sim_row_fn``."""
    if spec == "grouped":
        jt = J.GroupedTopology(J.random_grouping(8, 2, seed=1), G=8, I=2)
        pt = P.GroupedTopology(P.random_grouping(8, 2, seed=1), G=8, I=2)
    else:
        jt = J.make_topology(J.HierarchySpec(*SPECS[spec]))
        pt = P.make_topology(P.HierarchySpec(*SPECS[spec]))
    jm = JModel(JConfig(**MODEL))
    p0 = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    spread = jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(
            (N,) + x.shape)).astype(np.float32), p0)
    want = np.asarray(jax.jit(JO.Metrics().sim_row_fn(jt))(
        jax.tree.map(jnp.asarray, spread)))
    got = PO.Metrics().sim_row_fn(pt)(
        params_from_numpy(spread, device="cpu")).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= DIV_RTOL * np.abs(want).max()
    # eq. (10): up + down == global per level
    for i in range(1, len(got), 2):
        assert abs(got[i] + got[i + 1] - got[0]) <= 1e-5 * got[0]


# ---------------------------------------------------------------------------
# the engine with probes on, against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world", ["two_level", "three_level", "async"])
def test_run_rounds_with_probes_matches_reference(world):
    """Probe rows, grad_norm and ce against the reference.  The three-level
    world runs a ring of 3 rows over 8 syncs with evals every 5 steps, so
    drains happen before the ring would wrap and at evals, in the
    reference's order; the async world ({1: 1}) adds the staleness
    channel."""
    spec = "two_level" if world == "two_level" else "three_level"
    cfg, jkw, pkw, T = {}, {}, {}, 16
    metrics = "on"
    if world == "three_level":
        metrics = (JO.Metrics(capacity=3), PO.Metrics(capacity=3))
        jkw = {"eval_every": 5, "eval_fn": lambda st, t: {"acc": float(t)}}
        pkw = {"eval_every": 5, "eval_fn": lambda st, t: {"acc": float(t)}}
    if world == "async":
        cfg, T = {"async_levels": {1: 1}}, 32
    je, js, pe, ps = _engines(spec, metrics, **cfg)
    js, jh = je.run_rounds(js, _jb, T, **jkw)
    ps, ph = pe.run_rounds(ps, _pb, T, **pkw)
    _assert_history_close(ph, jh)
    syncs = [r["t"] for r in ph if "div_global" in r]
    assert syncs == list(range(2, T + 1, 2))
    assert ps.metrics.count == 0
    if world == "async":
        assert pe.metrics.staleness and je.metrics.staleness
        stale = {r["t"]: r["div_staleness"] for r in ph if "div_global" in r}
        # folds at the level-1 boundaries after the first (t = 16, 24, 32)
        assert all((v > 0) == (t in (16, 24, 32)) for t, v in stale.items())


def test_step_path_and_drain_metrics_match_reference():
    """Per-step pushes and ``drain_metrics`` past a ring of 3 rows: 4
    pushes, the last 3 survive, in push order."""
    je, js, pe, ps = _engines(
        "three_level", (JO.Metrics(capacity=3), PO.Metrics(capacity=3)))
    for t in range(8):
        js, _ = je.step(js, _jb(t))
        ps, _ = pe.step(ps, _pb(t))
    assert ps.metrics.count == int(js.metrics.count) == 4
    js, jrows = je.drain_metrics(js)
    ps, prows = pe.drain_metrics(ps)
    assert ps.metrics.count == 0
    assert len(prows) == len(jrows) == 3
    for p, j in zip(prows, jrows):
        assert set(p) == set(j)
        _assert_rows_close(p, j)


def test_probes_off_is_bitwise_and_probes_change_no_param():
    je, js, pe, ps = _engines("three_level", metrics=None)
    _, _, pe_on, ps_on = _engines("three_level", metrics="on")
    plain = P.HSGD(pe.loss_fn, sgd(0.1), P.make_topology(
        P.HierarchySpec(*SPECS["three_level"])))
    ps_plain = plain.init_from_params(
        {k: {n: x[0] for n, x in v.items()} for k, v in ps.params.items()},
        device="cpu")
    ps, h_off = pe.run_rounds(ps, _pb, 16)
    ps_on, h_on = pe_on.run_rounds(ps_on, _pb, 16)
    ps_plain, h_plain = plain.run_rounds(ps_plain, _pb, 16)
    assert ps.metrics is None and ps_on.metrics is not None
    for a, b, c in zip(tree_leaves(ps.params), tree_leaves(ps_on.params),
                       tree_leaves(ps_plain.params)):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert h_off == h_plain
    assert not any(k.startswith("div_") or k == "grad_norm"
                   for rec in h_off for k in rec)
    assert [r["ce"] for r in h_on] == [r["ce"] for r in h_off]


def _event_key(ev):
    return {k: v for k, v in ev.items() if k != "args"}


@pytest.mark.parametrize("runtime", [False, True])
def test_run_rounds_trace_matches_reference(runtime):
    """A traced run: with a runtime the clock's spans in simulated time,
    without one the fallback spans in step-index time; every event equal
    in name, phase, track and time, args equal but for the probe values
    (within DIV_RTOL of the row's largest)."""
    cfg = {"comms": "identity"}
    if runtime:
        cfg["runtime"] = (JR.RuntimeModel(compute_s=0.004,
                                          straggler="lognormal:0.5"),
                          PR.RuntimeModel(compute_s=0.004,
                                          straggler="lognormal:0.5"))
    je, js, pe, ps = _engines("three_level", **cfg)
    jrec, prec = JO.TraceRecorder(), PO.TraceRecorder()
    js, jh = je.run_rounds(js, _jb, 16, trace=jrec)
    ps, ph = pe.run_rounds(ps, _pb, 16, trace=prec)
    _assert_history_close(ph, jh)
    assert PO.validate_trace(prec) == JO.validate_trace(jrec) == []
    assert len(prec.events) == len(jrec.events)
    assert [_event_key(e) for e in prec.events] == \
        [_event_key(e) for e in jrec.events]
    names = {e["name"] for e in prec.events}
    assert ("compute" in names) == runtime
    assert any(n.startswith("round x") for n in names) != runtime
    for p, j in zip(prec.events, jrec.events):
        if p["ph"] == "C" or p["name"].startswith("probe t="):
            keys = [k for k in j["args"] if k != "step"]
            assert p["args"].get("step") == j["args"].get("step")
            _assert_rows_close(p["args"], j["args"], keys)
        else:
            assert p.get("args") == j.get("args"), (p, j)


def test_obs_cli_writes_a_valid_trace(tmp_path):
    import json
    from repro_torch.obs.__main__ import main
    out = tmp_path / "trace.json"
    assert main(["--out", str(out), "--device", "cpu", "--levels", "2",
                 "--steps", "8"]) == 0
    obj = json.loads(out.read_text())
    assert PO.validate_trace(obj) == []
    assert any(e["ph"] == "C" for e in obj["traceEvents"])
    assert any(e["name"] == "compute" for e in obj["traceEvents"])


def test_twins_refuse_the_reference_file_names():
    from repro_torch.experiments import bench_obs, bench_population
    with pytest.raises(ValueError, match="BENCH_obs.json"):
        bench_obs.main(out="elsewhere/BENCH_obs.json", device="cpu")
    with pytest.raises(ValueError, match="BENCH_population.json"):
        bench_population.main(out="BENCH_population.json", device="cpu")
    assert bench_obs.TOPOLOGIES["three_level"].periods == (32, 16, 8)
    assert (bench_obs.BATCH, bench_obs.REPEATS, bench_obs.MIN_RATIO) == \
        (512, 3, 0.95)


def test_mesh_refuses_metrics_naming_a7d(tmp_path):
    """In a one-process ``gloo`` group: any metrics plan is refused at
    bind, naming A7d; metrics None binds."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        pm = SimpleModel(SimpleConfig(**MODEL))
        topo = lambda: P.make_topology("local_sgd", n=1, P=4)
        for metrics in ("on", PO.Metrics(divergences=False)):
            with pytest.raises(NotImplementedError, match="A7d"):
                P.HSGD(pm.loss, sgd(0.1), topo(), P.EngineConfig(
                    executor="mesh", metrics=metrics))
        P.HSGD(pm.loss, sgd(0.1), topo(), P.EngineConfig(executor="mesh"))
    finally:
        dist.destroy_process_group()
