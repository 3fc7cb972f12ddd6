"""repro_torch.analysis: the recorder, the rule catalog (R1–R6) on
hand-built report fixtures AND live engines, the budget diff, and the CLI
gate — the reference's ``tests/test_analysis.py``, function for function.

Every rule gets a good/bad fixture pair built from plain report data (no
recording), plus a live demonstration on the CPU: an injected extra
reduction is caught by R1, the legacy int8 encode→reduce(f32)→decode
roundtrip (``wire_reduce=False``) fires R2 while the default compressed
collective is clean, a print of a tensor smuggled into the loss is caught
by R3, and synthetic budget regressions (extra sync op, dtype upcast, byte
growth) fail the check.  The reference's two walker tests that fail under
jax 0.9.0 (``jax.debug.print`` lowers to ``debug_print``, which its
``CALLBACK_PRIMS`` lacks) are ported to what they mean: the recorder must
catch the torch counterparts, ``.item()`` and a printed tensor.  No
tolerances: every check here is an exact count.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import (EventAudit, RoundAudit,  # noqa: E402
                                  SyncPlanReport, audit_engine,
                                  check_reports, entry_from_report,
                                  fingerprint, run_rules, trace,
                                  update_budget, waivers_for)
from repro_torch.analysis.__main__ import CONFIGS, build_engine, main  # noqa
from repro_torch.comms import Comms  # noqa: E402
from repro_torch.core import EngineConfig, HSGD  # noqa: E402
from repro_torch.core.topology import HierarchySpec, make_topology  # noqa
from repro_torch.models.simple import SimpleConfig, SimpleModel  # noqa
from repro_torch.optim.optimizers import sgd  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

MODEL = dict(kind="mlp", input_dim=16, hidden=8, num_classes=4)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(loss=None, **cfg):
    model = SimpleModel(SimpleConfig(**MODEL))
    topo = make_topology("uniform", spec=HierarchySpec((2, 4), (8, 4)))
    eng = HSGD(loss or model.loss, sgd(0.1), topo, EngineConfig(**cfg))
    state = eng.init(torch.Generator().manual_seed(0), model.init,
                     device="cpu")
    return eng, state


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------
def test_walker_records_collectives_with_axes_and_payload(tmp_path):
    """A ``MeshAxes`` psum in a one-process ``gloo`` group: one record with
    its axis names, dtype, elements and bytes; its host staging is the
    collective's, not a transfer."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_hsgd_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        mesh = make_hsgd_mesh((1,))
        summary = trace(lambda v: mesh.world.psum(v) * 2,
                        torch.ones((1, 4)))
    finally:
        dist.destroy_process_group()
    assert summary.collective_count == 1
    op = summary.collectives[0]
    assert op.primitive == "psum"
    assert op.axes == ("data",)
    assert op.dtypes == ("float32",)
    assert op.elements == 4 and op.nbytes == 16
    assert summary.transfers == () and summary.callbacks == ()


def test_walker_records_host_callbacks(capsys):
    def g(x):
        print(x.sum())
        s = float(x.sum())
        return x * s

    summary = trace(g, torch.ones(3))
    assert [o.primitive for o in summary.callbacks] == \
        ["repr", "_local_scalar_dense"]
    assert all("test_torch_analysis.py" in o.path for o in summary.callbacks)


def test_walker_descends_into_scan_bodies():
    """The port's nesting is the functorch transforms of the local update:
    ops under ``vmap(grad(...))`` are recorded, the gradient's products
    included."""
    def f(p, x):
        return torch.func.vmap(torch.func.grad(
            lambda q, y: (y @ q).square().sum()))(p, x)

    summary = trace(f, torch.ones(4, 3), torch.ones(4, 5, 3))
    prims = [o.primitive for o in summary.reduces]
    assert "sum" in prims and "bmm" in prims


def test_fingerprint_stable_across_traces_and_sensitive_to_program():
    f = lambda x: torch.func.grad(lambda y: torch.relu(y).sum())(x)
    j1 = trace(f, torch.ones(3))
    j2 = trace(f, torch.ones(3) * 2)
    assert fingerprint(j1) == fingerprint(j2)   # values never enter
    j3 = trace(lambda x: x * 3, torch.ones(3))
    assert fingerprint(j1) != fingerprint(j3)
    assert fingerprint(trace(f, torch.ones(4))) != fingerprint(j1)


# ---------------------------------------------------------------------------
# rule fixtures (plain report data, no recording)
# ---------------------------------------------------------------------------
def mk_event(key="L1", sync_ops=6, expected=6, dtypes=("float32",),
             nbytes=976, elements=244, expected_elements=None, axes=()):
    return EventAudit(key=key, level=int(key[1]), groups=None,
                      sync_ops=sync_ops, expected_sync_ops=expected,
                      ops=(), axes=tuple(axes), wire_dtypes=tuple(dtypes),
                      payload_elements=elements, payload_bytes=nbytes,
                      expected_payload_elements=expected_elements)


def mk_round(key="r4+L1", collectives=0, callbacks=(), transfers=(),
             cache_stable=True, cache_size=1):
    return RoundAudit(key=key, n_local=4, event=key.split("+")[1],
                      collective_count=collectives,
                      callbacks=tuple(callbacks), transfers=tuple(transfers),
                      cache_stable=cache_stable, jit_cache_size=cache_size)


def mk_report(events=(), rounds=(), codec=None, wire=None, config="fixture",
              waivers=()):
    report = SyncPlanReport(
        config=config, executor="sim", topology="UniformTopology",
        aggregator="MeanAggregator", codec=codec,
        events={e.key: e for e in events},
        rounds={r.key: r for r in rounds}, wire=wire)
    return dataclasses.replace(
        report, findings=tuple(run_rules(report, waivers)))


def rules_fired(report):
    return sorted({f.rule for f in report.findings})


def test_r1_sync_op_count():
    assert rules_fired(mk_report(events=[mk_event()])) == []
    assert rules_fired(mk_report(events=[mk_event(sync_ops=7)])) == ["R1"]
    # no exact expectation -> R1 defers to the budget
    assert rules_fired(
        mk_report(events=[mk_event(sync_ops=7, expected=None)])) == []


def test_r2_fires_on_f32_reduction_under_compressing_codec():
    bad = mk_report(events=[mk_event()], codec="int8")
    assert rules_fired(bad) == ["R2"] and not bad.findings[0].waived
    assert rules_fired(mk_report(events=[mk_event()], codec="identity")) == []
    assert rules_fired(mk_report(events=[mk_event()], codec=None)) == []
    assert rules_fired(
        mk_report(events=[mk_event(dtypes=("int8",))], codec="int8")) == []


def test_r2_waiver_suppresses_but_keeps_the_finding_visible():
    waived = mk_report(events=[mk_event()], codec="int8",
                       waivers={"R2": "baseline until compressed allreduce"})
    assert waived.unwaived == ()
    (f,) = waived.findings
    assert f.rule == "R2" and f.waived and "baseline" in f.waive_reason


def test_r3_host_callbacks_and_transfers():
    assert rules_fired(mk_report(rounds=[mk_round()])) == []
    bad = mk_report(rounds=[mk_round(
        callbacks=("_local_scalar_dense@core/hsgd.py:1",))])
    assert rules_fired(bad) == ["R3"]
    assert "_local_scalar_dense" in bad.findings[0].message
    assert rules_fired(mk_report(rounds=[mk_round(
        transfers=("lift_fresh@core/aggregators.py:1",))])) == ["R3"]


def test_r4_retrace_detection():
    assert rules_fired(mk_report(rounds=[mk_round(cache_size=1)])) == []
    assert rules_fired(mk_report(rounds=[mk_round(cache_size=3)])) == ["R4"]
    assert rules_fired(
        mk_report(rounds=[mk_round(cache_stable=False)])) == ["R4"]
    # unmeasured (no run_rounds pass) is not a finding
    assert rules_fired(mk_report(rounds=[mk_round(cache_size=None)])) == []


def test_r5_wire_accounting_cross_check():
    assert rules_fired(
        mk_report(events=[mk_event(expected_elements=244)])) == []
    assert rules_fired(
        mk_report(events=[mk_event(expected_elements=250)])) == ["R5"]


def test_report_json_roundtrip():
    rep = mk_report(events=[mk_event(axes=("pod", "data"))],
                    rounds=[mk_round(callbacks=("tolist@obs/bus.py:3",))],
                    codec="int8",
                    wire={"payload_bytes": 248, "n_elements": 244,
                          "f32_bytes": 976, "wire_dtypes": ["float32", "int8"]})
    back = SyncPlanReport.from_dict(json.loads(json.dumps(rep.to_dict())))
    assert back == rep


# ---------------------------------------------------------------------------
# live audits (sim executor, CPU)
# ---------------------------------------------------------------------------
def test_live_audit_sim_off_matches_schedule():
    eng, state, batch_fn = build_engine("sim/two_level/off", "cpu")
    rep = eng.audit(state, batch_fn, config="sim/two_level/off")
    assert set(rep.events) == {"L1", "L2"}
    for ev in rep.events.values():
        assert ev.sync_ops == ev.expected_sync_ops == 6  # mlp leaves
    assert rep.unwaived == ()
    # one build per round signature across run_rounds (R4 clean)
    assert {r.jit_cache_size for r in rep.rounds.values()} == {1}
    assert {r.cache_stable for r in rep.rounds.values()} == {True}


def test_live_audit_int8_r2_burned_down_by_wire_reduce():
    """The compressed-collective form keeps int8 on the wire (one int32
    sum a bucket), so R2 passes with NO waiver; forcing the legacy
    roundtrip (``wire_reduce=False``) still fires it — the rule watches
    what the program moves, not the codec's declaration."""
    eng, state, _ = build_engine("sim/two_level/int8", "cpu")
    rep = eng.audit(state)  # sync-only audit: no batch_fn needed for R2
    assert rep.unwaived == ()
    for ev in rep.events.values():
        assert "float32" not in ev.wire_dtypes
        assert ev.f32_elements == 0

    legacy, lstate = _engine(comms=Comms("int8", wire_reduce=False))
    lrep = legacy.audit(lstate)
    assert sorted({f.rule for f in lrep.unwaived}) == ["R2"]
    waived = legacy.audit(lstate, waivers={"R2": "known baseline"})
    assert waived.unwaived == ()
    assert any(f.rule == "R2" and f.waived for f in waived.findings)


def test_live_injected_extra_reduction_caught_by_r1():
    """An executor that sneaks one extra per-leaf reduction into every
    sync is caught by R1 (the sync-op count doubles against the schedule
    prediction)."""
    from repro_torch.core.executors import SimExecutor

    class ExtraReduceExecutor(SimExecutor):
        def sync_fn(self, event):
            base = super().sync_fn(event)

            def sync(params, opt_state, cstate, mask=None):
                p, o, c = base(params, opt_state, cstate, mask=mask)
                p = tree_map(lambda x: x + 0 * x.sum(0, keepdim=True), p)
                return p, o, c

            return sync

    eng, state = _engine(executor=ExtraReduceExecutor())
    rep = eng.audit(state)
    assert sorted({f.rule for f in rep.unwaived}) == ["R1"]
    assert all(ev.sync_ops == 2 * ev.expected_sync_ops
               for ev in rep.events.values())


def test_live_debug_print_in_loss_caught_by_r3(capsys):
    model = SimpleModel(SimpleConfig(**MODEL))

    def noisy_loss(params, batch):
        loss, metrics = model.loss(params, batch)
        print("loss", loss)
        return loss, metrics

    eng, state = _engine(loss=noisy_loss)
    bf = lambda t: {"x": torch.zeros((8, 4, 16)),
                    "y": torch.zeros((8, 4), dtype=torch.int32)}
    rep = audit_engine(eng, state, bf, run=False)
    assert sorted({f.rule for f in rep.unwaived}) == ["R3"]
    assert all(c.startswith("repr@") for r in rep.rounds.values()
               for c in r.callbacks)
    assert all(len(r.callbacks) == 4 for r in rep.rounds.values())


# ---------------------------------------------------------------------------
# budget gating
# ---------------------------------------------------------------------------
def budget_for(report):
    return {"version": 1, "waivers": {},
            "configs": {report.config: entry_from_report(report)}}


def test_budget_unchanged_report_passes():
    rep = mk_report(events=[mk_event()], rounds=[mk_round()])
    regs, imps = check_reports([rep], budget_for(rep))
    assert regs == [] and imps == []


@pytest.mark.parametrize("mutate, expect", [
    (lambda e: mk_event(sync_ops=7, expected=None), "sync ops grew"),
    (lambda e: mk_event(dtypes=("float32", "float64")), "new wire dtype"),
    (lambda e: mk_event(nbytes=1952), "payload bytes grew"),
    (lambda e: mk_event(axes=("pod",)), "named axes changed"),
])
def test_budget_catches_synthetic_regressions(mutate, expect):
    base = mk_report(events=[mk_event(axes=())])
    budget = budget_for(base)
    bad = mk_report(events=[mutate(None)])
    regs, _ = check_reports([bad], budget)
    assert any(expect in r for r in regs), (expect, regs)


def test_budget_catches_new_signatures_and_findings():
    base = mk_report(events=[mk_event()], rounds=[mk_round()])
    budget = budget_for(base)
    extra_event = mk_report(events=[mk_event(), mk_event(key="L2")],
                            rounds=[mk_round()])
    regs, _ = check_reports([extra_event], budget)
    assert any("new event signature 'L2'" in r for r in regs)
    waived = mk_report(events=[mk_event()], rounds=[mk_round()],
                       codec="int8", waivers={"R2": "ok"})
    regs, _ = check_reports([waived], budget)
    assert any("new finding" in r for r in regs)


def test_budget_unwaived_finding_always_fails():
    bad = mk_report(events=[mk_event(sync_ops=7)])
    regs, _ = check_reports([bad], budget_for(bad))
    assert any("unwaived finding R1" in r for r in regs)


def test_budget_improvements_pass_with_note():
    base = mk_report(events=[mk_event()])
    better = mk_report(events=[mk_event(sync_ops=1, expected=1, nbytes=248)])
    regs, imps = check_reports([better], budget_for(base))
    assert regs == []
    assert any("shrank" in i for i in imps)


def test_budget_update_merges_and_preserves_waivers():
    old = {"version": 1,
           "waivers": {"*int8*": {"R2": "baseline"}},
           "configs": {"mesh/only": {"events": {}, "rounds": {},
                                     "wire": None, "findings": []}}}
    rep = mk_report(events=[mk_event()], config="sim/new")
    new = update_budget(old, [rep])
    assert new["waivers"] == old["waivers"]
    assert "mesh/only" in new["configs"]  # not re-audited -> kept verbatim
    assert new["configs"]["sim/new"] == entry_from_report(rep)
    assert waivers_for(new, "sim/two_level/int8") == {"R2": "baseline"}
    assert waivers_for(new, "sim/two_level/off") == {}
    # the compressed-collective configs may not be re-waived
    regs, _ = check_reports([], new)
    assert any("may not be re-waived" in r for r in regs)


def test_budget_missing_config_is_a_regression():
    rep = mk_report(events=[mk_event()], config="unknown/config")
    regs, _ = check_reports([rep], {"version": 1, "waivers": {},
                                    "configs": {}})
    assert any("not in budget" in r for r in regs)


# ---------------------------------------------------------------------------
# CLI gate against the committed budget
# ---------------------------------------------------------------------------
def test_cli_check_passes_against_committed_budget(tmp_path):
    """The check in miniature: audit two sim configs on the CPU, diff
    against the committed ANALYSIS_budget_torch.json, write the report."""
    out = tmp_path / "report.json"
    rc = main(["--check", "--device", "cpu", "--configs",
               "sim/two_level/off,sim/two_level/int8", "--out", str(out)])
    assert rc == 0
    payload = json.loads(out.read_text())
    assert "sim/two_level/off" in payload["configs"]
    int8 = payload["configs"]["sim/two_level/int8"]
    assert int8["findings"] == []
    assert {e["kernels"] == ["int8_scale_quantize"]
            for e in int8["events"].values()} == {True}
    with pytest.raises(ValueError, match="JAX package's record"):
        main(["--update", "--device", "cpu", "--configs",
              "sim/two_level/off", "--budget",
              str(tmp_path / "ANALYSIS_budget.json")])


def test_config_matrix_spans_the_lowering_paths():
    assert len(CONFIGS) == 15
    assert any(c.startswith("sim/") for c in CONFIGS)
    assert any(c.startswith("mesh/") for c in CONFIGS)
    assert any("three_level" in c for c in CONFIGS)
    assert any("int8" in c for c in CONFIGS)
    assert any("identity" in c for c in CONFIGS)
