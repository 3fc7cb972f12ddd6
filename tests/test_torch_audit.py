"""The port's audit against the reference's own budget, its negative
controls, its entry points and the reference's walker claims.

* Parity: the live CPU audit of the 9 sim configs, and of the 6 mesh
  configs in one launch of eight ``gloo`` ranks (``repro_torch.analysis.
  matrix.run_audits``), equals the reference's ``ANALYSIS_budget.json`` —
  read as JSON, no JAX here — in each event's ``sync_ops``,
  ``payload_bytes``, ``wire_dtypes`` and ``axes``, each round's
  ``collective_count``, ``callbacks`` and ``transfers``, and the findings
  (none, with no waiver).  One known difference, asserted as such:
  ``mesh/two_level/probes`` moves 10 collectives a round where the
  reference moves 11, because the port gathers every per-step metric
  channel in one ``all_gather`` (``MeshExecutor._metric_means``) and the
  reference pmeans each channel (``grad_norm`` is its second).  Each
  report's budget projection also equals the committed
  ``ANALYSIS_budget_torch.json``.
* Negative controls, each tripping exactly its own rule: an extra reduce
  in ``sync_fn`` (R1, the count doubles), the legacy int8 roundtrip (R2;
  a waiver keeps the finding visible), a loss that calls ``.item()`` (R3)
  and an executor whose round cache rebuilds (R4).
* ``PopulationEngine.audit`` and ``launch.train --audit`` on a reduced
  config, on the plain and the population path.
* The reference's walker claims on the port: the fused sync is one
  reduce against one per leaf (``tests/test_comms.py:315``); the mesh round
  is one bucket + one metrics gather against leaves + 1
  (``tests/test_executors.py:300``); a runtime model leaves the round's
  fingerprint unchanged (``tests/test_runtime.py:236``).
* ``gpu``: on the card, with the kernels, each sim config's report equals
  the CPU's field for field (skips without a card).

Every check is an exact count or an exact equality: no tolerance.
"""
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import (entry_from_report, fingerprint,  # noqa
                                  load_budget, trace)
from repro_torch.analysis.matrix import (CONFIGS, build_engine,  # noqa
                                         run_audits)
from repro_torch.comms import Comms  # noqa: E402
from repro_torch.core import (EngineConfig, HSGD, Round,  # noqa: E402
                              SyncEvent)
from repro_torch.core.executors import SimExecutor  # noqa: E402
from repro_torch.core.topology import HierarchySpec, make_topology  # noqa
from repro_torch.models.simple import SimpleConfig, SimpleModel  # noqa
from repro_torch.optim.optimizers import sgd  # noqa: E402
from repro_torch.runtime import RuntimeModel  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
REFERENCE = json.loads((ROOT / "ANALYSIS_budget.json").read_text())
BUDGET = load_budget(ROOT / "ANALYSIS_budget_torch.json")
SIM = [c for c in CONFIGS if c.startswith("sim/")]
MESH = [c for c in CONFIGS if c.startswith("mesh/")]
# configs whose rounds gather the per-step metric channels in one
# collective where the reference pmeans each (see the module docstring)
FUSED_METRIC_CHANNELS = {"mesh/two_level/probes": 1}
MODEL = dict(kind="mlp", input_dim=16, hidden=8, num_classes=4)
N_LEAVES = 6


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh_reports():
    """The six mesh configs' reports: one launch of eight gloo ranks."""
    return {r.config: r for r in run_audits(BUDGET, MESH, "cpu")}


def _compared(entry, fused: int = 0):
    """The fields the port must share with the reference's budget entry;
    ``fused`` is added back to each round's collective count."""
    return {
        "events": {k: {f: (sorted(e[f]) if f in ("axes", "wire_dtypes")
                           else e[f])
                       for f in ("sync_ops", "payload_bytes", "wire_dtypes",
                                 "axes")}
                   for k, e in entry["events"].items()},
        "rounds": {k: {"collective_count": r["collective_count"] + fused,
                       "callbacks": r["callbacks"],
                       "transfers": r["transfers"]}
                   for k, r in entry["rounds"].items()},
        "findings": entry["findings"],
    }


def _hold(report):
    entry = entry_from_report(report)
    fused = FUSED_METRIC_CHANNELS.get(report.config, 0)
    assert _compared(entry, fused) == \
        _compared(REFERENCE["configs"][report.config])
    assert entry["findings"] == [] and report.findings == ()
    assert entry == BUDGET["configs"][report.config]
    if fused:
        probes = entry["probes"]
        ref = REFERENCE["configs"][report.config]["probes"]
        assert probes["budget"] == ref["budget"]
        assert {k: v["extra_ops"] for k, v in probes["rounds"].items()} == \
            {k: v["extra_ops"] - fused for k, v in ref["rounds"].items()}


@pytest.mark.parametrize("config", SIM)
def test_sim_audit_equals_the_reference_budget(config):
    eng, state, batch_fn = build_engine(config, "cpu")
    _hold(eng.audit(state, batch_fn, config=config))


@pytest.mark.parametrize("config", MESH)
def test_mesh_audit_equals_the_reference_budget(config, mesh_reports):
    _hold(mesh_reports[config])


def test_the_budget_holds_the_fifteen_configs_and_no_waiver():
    assert sorted(BUDGET["configs"]) == sorted(REFERENCE["configs"]) == \
        sorted(CONFIGS)
    assert BUDGET["waivers"] == {}


@pytest.mark.parametrize("config, kernels", [
    ("sim/two_level/int8", ("int8_scale_quantize",)),
    ("sim/two_level/momentum-int8", ("int8_scale_quantize",) * 2),
    ("sim/two_level/sign", ("sign_pack",)),
    ("sim/two_level/identity", ()),
    ("mesh/two_level/int8", ("int8_scale_quantize",)),
    ("mesh/two_level/sign", ("sign_pack",)),
])
def test_events_list_their_kernel_regions(config, kernels, mesh_reports):
    if config.startswith("mesh/"):
        rep = mesh_reports[config]
    else:
        eng, state, _ = build_engine(config, "cpu")
        rep = eng.audit(state, config=config)
    assert {k: ev.kernels for k, ev in rep.events.items()} == \
        {k: kernels for k in rep.events}


# ---------------------------------------------------------------------------
# negative controls: each trips exactly its own rule
# ---------------------------------------------------------------------------
class ExtraReduceExecutor(SimExecutor):
    def sync_fn(self, event):
        base = super().sync_fn(event)

        def sync(params, opt_state, cstate, mask=None):
            p, o, c = base(params, opt_state, cstate, mask=mask)
            p = tree_map(lambda x: x + 0 * x.sum(0, keepdim=True), p)
            return p, o, c

        return sync


class RebuildingExecutor(SimExecutor):
    """A round cache that forgets: every lookup builds the body anew."""

    def round_fn(self, rnd, masked=False):
        self._round_fns.pop((rnd, masked), None)
        return super().round_fn(rnd, masked)


def _control(rule):
    model = SimpleModel(SimpleConfig(**MODEL))
    loss, cfg = model.loss, {}
    if rule == "R1":
        cfg = dict(executor=ExtraReduceExecutor())
    elif rule == "R2":
        cfg = dict(comms=Comms("int8", wire_reduce=False))
    elif rule == "R3":
        scale = torch.ones(())

        def loss(params, batch):
            ce, metrics = model.loss(params, batch)
            return ce * scale.item(), metrics
    else:
        cfg = dict(executor=RebuildingExecutor())
    topo = make_topology("uniform", spec=HierarchySpec((2, 4), (8, 4)))
    eng = HSGD(loss, sgd(0.1), topo, EngineConfig(**cfg))
    state = eng.init(torch.Generator().manual_seed(0), model.init,
                     device="cpu")
    bf = lambda t: {"x": torch.randn((8, 4, 16), generator=torch.Generator()
                                     .manual_seed(t)),
                    "y": torch.zeros((8, 4), dtype=torch.int32)}
    return eng, state, bf


@pytest.mark.parametrize("rule", ["R1", "R2", "R3", "R4"])
def test_negative_control_trips_its_own_rule(rule):
    eng, state, bf = _control(rule)
    rep = eng.audit(state, bf, config=f"control/{rule}")
    assert sorted({f.rule for f in rep.unwaived}) == [rule]
    if rule == "R1":
        assert all(ev.sync_ops == 2 * ev.expected_sync_ops == 12
                   for ev in rep.events.values())
    elif rule == "R2":
        waived = eng.audit(state, bf, waivers={"R2": "known baseline"})
        assert waived.unwaived == ()
        assert {f.rule for f in waived.findings} == {"R2"}
        assert all(f.waived and f.waive_reason == "known baseline"
                   for f in waived.findings)
    elif rule == "R3":
        # one read a local step: 4 a round
        assert all(len(r.callbacks) == 4 and all(
            c.startswith("_local_scalar_dense@") for c in r.callbacks)
            for r in rep.rounds.values())
    else:
        assert all(not r.cache_stable and r.jit_cache_size > 1
                   for r in rep.rounds.values())


# ---------------------------------------------------------------------------
# the other entry points
# ---------------------------------------------------------------------------
def test_population_engine_audit_records_the_sampled_round():
    model = SimpleModel(SimpleConfig(**MODEL))
    topo = make_topology("uniform", spec=HierarchySpec((2, 4), (8, 4)))
    eng = HSGD(model.loss, sgd(0.1), topo,
               EngineConfig(population=(10, 10), comms="int8"))
    pop = eng.population_engine()
    server = eng.init_server(torch.Generator().manual_seed(0), model.init,
                             device="cpu")
    bf = lambda ids, t: {"x": torch.randn((len(ids), 4, 16)),
                         "y": torch.zeros((len(ids), 4), dtype=torch.int32)}
    rep = pop.audit(server, bf, config="sim/pop")
    assert rep.unwaived == () and rep.codec == "int8"
    # one sampling round is one global period; its global event is the
    # fold-back, so the inner engine syncs at level 2 only and its last
    # round ends on the dropped level-1 slot
    assert set(rep.events) == {"L2"}
    assert set(rep.rounds) == {"r4+L2", "r4+none"}
    assert rep.events["L2"].sync_ops == 1
    assert all(r.callbacks == r.transfers == () and r.cache_stable
               for r in rep.rounds.values())


@pytest.mark.parametrize("extra", [(), ("--population", "10x10",
                                        "--sample-k", "4")])
def test_train_audit_prints_a_clean_report(extra, capsys):
    from repro_torch.launch import train
    argv = ["--arch", "qwen2-0.5b", "--reduced", "--workers", "4",
            "--groups", "2", "--G", "4", "--I", "2", "--steps", "4",
            "--batch", "2", "--seq", "32", "--comms", "int8", "--audit",
            *extra]
    train.main(argv, device="cpu")
    out = capsys.readouterr().out
    tag = "/pop" if extra else ""
    assert f"[sim/qwen2-0.5b{tag}] executor=sim" in out
    assert "sync L2: 1 op(s) (expected 1) dtypes=int32" in out
    assert "findings: none" in out and "FINDING" not in out


# ---------------------------------------------------------------------------
# the reference's walker claims, on the port
# ---------------------------------------------------------------------------
def test_sync_operand_count_is_o_dtypes():
    """The fused aggregation runs O(dtypes) reduces instead of O(leaves):
    one f32 bucket against one mean per leaf."""
    model = SimpleModel(SimpleConfig(**MODEL))
    topo = make_topology("uniform", spec=HierarchySpec((2, 4), (8, 4)))
    params = tree_map(lambda x: x[None].expand((8,) + tuple(x.shape)),
                      model.init(torch.Generator().manual_seed(0),
                                 device="cpu"))
    assert len(tree_leaves(params)) == N_LEAVES
    ev = SyncEvent(level=1)
    comms = Comms()
    plain = trace(lambda t: topo.aggregate(t, ev), params)
    fused = trace(lambda t: comms.sync(t, lambda b: topo.aggregate(b, ev)),
                  params)
    assert len(plain.reduces) == plain.count("mean") == N_LEAVES
    assert len(fused.reduces) == fused.count("mean") == 1


def test_mesh_comms_fuses_collectives(mesh_reports):
    """The mesh round syncs O(dtypes) fused buffers, not O(leaves) arrays:
    one bucket + one metrics gather, against leaves + 1 with comms off."""
    off = mesh_reports["mesh/two_level/off"].rounds
    fused = mesh_reports["mesh/two_level/identity"].rounds
    assert {r.collective_count for r in off.values()} == {N_LEAVES + 1}
    assert {r.collective_count for r in fused.values()} == {1 + 1}


def test_runtime_model_leaves_the_round_program_unchanged():
    model = SimpleModel(SimpleConfig(**MODEL))
    mk = lambda: make_topology("uniform", spec=HierarchySpec((2, 4), (8, 2)))
    e0 = HSGD(model.loss, sgd(0.05), mk())
    e1 = HSGD(model.loss, sgd(0.05), mk(),
              EngineConfig(runtime=RuntimeModel(compute_s=1.0)))
    s0 = e0.init(torch.Generator().manual_seed(0), model.init, device="cpu")
    s1 = e1.init(torch.Generator().manual_seed(0), model.init, device="cpu")
    rnd = Round(2, SyncEvent(level=1))
    batches = tuple({"x": torch.randn((8, 4, 16)),
                     "y": torch.zeros((8, 4), dtype=torch.int32)}
                    for _ in range(2))
    f0 = fingerprint(e0.executor.round_program(rnd, s0, batches))
    assert f0 == fingerprint(e1.executor.round_program(rnd, s1, batches))
    e2 = HSGD(model.loss, sgd(0.05), mk(), EngineConfig(metrics="on"))
    s2 = e2.init(torch.Generator().manual_seed(0), model.init, device="cpu")
    assert f0 != fingerprint(e2.executor.round_program(rnd, s2, batches))


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
@pytest.mark.parametrize("config", SIM)
def test_card_audit_equals_the_cpu_audit(config):
    from repro_torch.kernels import comms as kern
    reports = {}
    for dev in ("cpu", "cuda"):
        eng, state, batch_fn = build_engine(config, dev)
        reports[dev] = eng.audit(state, batch_fn, config=config).to_dict()
    assert reports["cuda"] == reports["cpu"]
    assert entry_from_report(eng.audit(state, batch_fn, config=config)) == \
        BUDGET["configs"][config]
    kern.reset_launch_counts()
    for ev in {e for e in eng.topology.schedule(eng.topology.periods[0])
               if e is not None}:
        summary = eng.executor.sync_program(ev, state)
        counts = {k: n for k, n in kern.launch_counts.items() if n}
        assert counts == {k: summary.kernels.count(k)
                          for k in set(summary.kernels)}
        kern.reset_launch_counts()
