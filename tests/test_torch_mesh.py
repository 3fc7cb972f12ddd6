"""The port's mesh executor on ``torch.distributed``, eight ``gloo`` ranks on
the CPU, one process per worker.

One module-scoped launch runs every configuration in the same eight ranks;
the parametrised cases assert on its results:

* ``exact=True`` is bit for bit the port's sim (params, error-feedback
  residuals and per-step losses) for comms off, identity, int8, sign and
  top-k on the two-level, three-level and grouped topologies, for the
  top-k legacy roundtrip, and for Algorithm-1 masked steps;
* the production lowering is within 1e-3 (max |diff| of params) of the JAX
  package's sim, the reference's own contract for its mesh
  (``tests/test_differential.py``), with every sync of the top-k wire path
  going through exactly one ``topk_decode_reduce`` call on every rank (on
  the CPU the wrapper runs the plain version; on the card each call is one
  kernel launch, ``chip_smoke.py``);
* every rank's gathered state is the same;
* the refusals: a world that is not one process per worker, a mesh that
  does not mirror the hierarchy, no process group at all, ``nccl`` without
  a card per rank, and a rank that raises fails the launch.

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
from repro_torch.data import (FederatedDataset, label_shard_partition,  # noqa: E402
                              make_classification)
from repro_torch.kernels import comms as tkern  # noqa: E402
from repro_torch.launch.mesh import launch, make_hsgd_mesh  # noqa: E402
from repro_torch.models import (SimpleConfig, SimpleModel,  # noqa: E402
                                params_from_numpy)
from repro_torch.optim import sgd  # noqa: E402

MODEL = dict(kind="mlp", input_dim=24, hidden=32, num_classes=8)
WORLD = 8
SPAWN_TIMEOUT = 300.0          # join timeout of the module's launch
MASK = np.array([1, 0, 1, 1, 0, 1, 1, 1], bool)
PROD_ATOL = 1e-3

# topology builders, over either package (``M`` is repro.core or
# repro_torch.core: the same API)
TOPOS = {
    "two_level": lambda M: M.make_topology("two_level", n=8, N=2, G=16,
                                           I=4),
    "three_level": lambda M: M.make_topology(
        M.HierarchySpec((2, 2, 2), (16, 4, 2))),
    "three_level_842": lambda M: M.make_topology(
        M.HierarchySpec((2, 2, 2), (8, 4, 2))),
    "grouped": lambda M: M.make_topology(M.random_grouping(8, 2, seed=1),
                                         G=8, I=(2, 4)),
}
# codec and Comms keyword arguments; None: comms off
COMMS = {"none": None, "identity": ("identity", {}), "int8": ("int8", {}),
         "sign": ("sign", {}), "topk": ("topk", {"rate": 0.25}),
         "topk_legacy": ("topk", {"rate": 0.25, "wire_reduce": False})}


def _runs():
    """(label, topology, comms, steps, exact, masked)."""
    runs = [(f"exact/{t}/{c}", t, c, 16, True, False)
            for t in ("two_level", "three_level", "grouped")
            for c in ("none", "identity", "int8", "sign", "topk")]
    runs.append(("exact/two_level/topk_legacy", "two_level", "topk_legacy",
                 16, True, False))
    runs += [(f"exact/masked/{c}", "two_level", c, 8, True, True)
             for c in ("int8", "topk")]
    runs += [(f"prod/two_level/{c}", "two_level", c, 32, False, False)
             for c in ("none", "int8", "sign", "topk", "topk_legacy")]
    runs += [("prod/three_level_842/topk", "three_level_842", "topk", 32,
              False, False),
             ("prod/grouped/none", "grouped", "none", 16, False, False),
             ("prod/grouped/topk", "grouped", "topk", 16, False, False),
             ("prod/masked/topk", "two_level", "topk", 8, False, True)]
    return runs


RUNS = {r[0]: r for r in _runs()}


def _data():
    x, y = make_classification(seed=0, num_classes=8, dim=24, per_class=80)
    return FederatedDataset(x, y, label_shard_partition(
        y, [[j] for j in range(8)], n_workers=8))


def _comms(C, name):
    spec = COMMS[name]
    return None if spec is None else C.Comms(spec[0], **spec[1])


def _port_run(label, p0, executor=None):
    """One run of the port (sim, or the mesh on a rank): the gathered
    (n, ...) params and residuals as numpy, and the per-step losses."""
    _, topo, comms, steps, _, masked = RUNS[label]
    ds = _data()
    model = SimpleModel(SimpleConfig(**MODEL))
    engine = P.HSGD(model.loss, sgd(0.08), TOPOS[topo](P), P.EngineConfig(
        executor=executor, comms=_comms(PC, comms)))
    state = engine.init_from_params(params_from_numpy(p0, device="cpu"),
                                    device="cpu")
    if masked:
        ce = []
        for t in range(steps):
            state, m = engine.step(state, ds.batch(t, 10), mask=MASK)
            ce.append(float(m["ce"]))
    else:
        state, hist = engine.run_rounds(state, lambda t: ds.batch(t, 10),
                                        T=steps)
        ce = [r["ce"] for r in hist]
    gather = engine.executor.gather
    params = {k: {n: v.numpy() for n, v in d.items()}
              for k, d in gather(state.params).items()}
    res = None if state.comms is None else \
        {k: v.numpy() for k, v in gather(state.comms).items()}
    return {"params": params, "comms": res, "ce": ce}


def _digest(run) -> str:
    h = hashlib.sha256()
    for k in sorted(run["params"]):
        for n in sorted(run["params"][k]):
            h.update(run["params"][k][n].tobytes())
    for k in sorted(run["comms"] or {}):
        h.update(run["comms"][k].tobytes())
    return h.hexdigest()


def _rank_program(rank, p0):
    """Every run of RUNS on this rank, with the wrapper's calls counted;
    then the refusals.  Rank 0 returns its runs and every rank's digests
    and call counts."""
    real = tkern.topk_decode_reduce
    calls = []

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    out, summary = {}, {}
    tkern.topk_decode_reduce = counting
    try:
        for label, *_, exact, _ in RUNS.values():
            calls.clear()
            run = _port_run(label, p0, P.MeshExecutor(exact=exact))
            summary[label] = (_digest(run), len(calls))
            out[label] = run
    finally:
        tkern.topk_decode_reduce = real
    refusals = {}
    model = SimpleModel(SimpleConfig(**MODEL))
    for what, make in (
            ("world", lambda: P.HSGD(
                model.loss, sgd(0.1),
                P.make_topology("two_level", n=4, N=2, G=4, I=2),
                P.EngineConfig(executor="mesh"))),
            ("mirror", lambda: P.HSGD(
                model.loss, sgd(0.1), TOPOS["two_level"](P),
                P.EngineConfig(executor=P.MeshExecutor(
                    mesh=make_hsgd_mesh((4, 2))))))):
        try:
            make()
            refusals[what] = None
        except ValueError as e:
            refusals[what] = str(e)
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, summary)
    return {"runs": out, "ranks": everyone, "refusals": refusals}


def _failing_rank(rank):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()


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


def _syncs(topo: str, steps: int) -> int:
    t = TOPOS[topo](P)
    return sum(ev is not None for ev in t.schedule(steps))


@pytest.mark.parametrize("label", [k for k in RUNS if k.startswith("exact")])
def test_exact_mesh_is_the_sim_bitwise(mesh, p0, label):
    got = mesh["runs"][label]
    want = _port_run(label, p0)
    for k in want["params"]:
        for n in want["params"][k]:
            assert np.array_equal(got["params"][k][n],
                                  want["params"][k][n]), (k, n)
    assert (got["comms"] is None) == (want["comms"] is None)
    for k in want["comms"] or {}:
        assert np.array_equal(got["comms"][k], want["comms"][k]), k
    assert got["ce"] == want["ce"]
    if COMMS[RUNS[label][2]] is not None and RUNS[label][2].startswith(
            "topk"):
        assert np.abs(got["comms"]["float32"]).max() > 0


@pytest.mark.parametrize("label", [k for k in RUNS if k.startswith("prod")])
def test_production_mesh_matches_the_jax_sim(mesh, p0, label):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    import repro.comms as JC
    import repro.core as J
    from repro.models import SimpleConfig as JConfig
    from repro.models import SimpleModel as JModel
    from repro.optim import sgd as jsgd
    _, topo, comms, steps, _, masked = RUNS[label]
    ds = _data()
    jm = JModel(JConfig(**MODEL))
    engine = J.HSGD(jm.loss, jsgd(0.08), TOPOS[topo](J), J.EngineConfig(
        comms=_comms(JC, comms)))
    state = engine.init(jax.random.PRNGKey(0), jm.init)

    def batch(t):
        return jax.tree.map(jnp.asarray, ds.batch(t, 10))

    if masked:
        for t in range(steps):
            state, _ = engine.step(state, batch(t), mask=MASK)
    else:
        state, _ = engine.run_rounds(state, batch, T=steps)
    want = jax.device_get(state.params)
    got = mesh["runs"][label]
    err = max(np.abs(got["params"][k][n] - np.asarray(want[k][n])).max()
              for k in want for n in want[k])
    assert err < PROD_ATOL, err


@pytest.mark.parametrize("label", sorted(RUNS))
def test_every_rank_gathers_the_same_state(mesh, label):
    digests = {ranks[label][0] for ranks in mesh["ranks"]}
    assert len(digests) == 1


@pytest.mark.parametrize("label", sorted(RUNS))
def test_topk_decode_reduce_runs_once_per_sync(mesh, label):
    """Only the production top-k wire path calls it: once a sync, on every
    rank (the params ride one bucket; sgd has no moments)."""
    _, topo, comms, steps, exact, masked = RUNS[label]
    want = 0
    if comms == "topk" and not exact and topo != "grouped":
        want = _syncs(topo, steps)
    assert [ranks[label][1] for ranks in mesh["ranks"]] == [want] * WORLD
    if label == "prod/two_level/topk":
        assert want == 8
    if label == "prod/three_level_842/topk":
        assert want == 16


def test_mesh_refusals_in_a_world(mesh):
    msg = mesh["refusals"]
    assert msg["world"] and "one process per worker" in msg["world"]
    assert msg["mirror"] and "do not mirror" in msg["mirror"]


def test_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    model = SimpleModel(SimpleConfig(**MODEL))
    assert isinstance(P.make_executor("mesh"), P.MeshExecutor)
    with pytest.raises(RuntimeError, match="launch"):
        P.HSGD(model.loss, sgd(0.1), TOPOS["two_level"](P),
               P.EngineConfig(executor="mesh"))


def test_launch_fails_when_a_rank_raises():
    with pytest.raises(RuntimeError, match="rank 1 failed") as err:
        launch(_failing_rank, 2, backend="gloo", device="cpu", timeout=60.0)
    assert "fails on purpose" in str(err.value)


def test_launch_refuses_nccl_without_a_card_per_rank():
    with pytest.raises(ValueError, match="one CUDA card per rank"):
        launch(_failing_rank, 2, backend="nccl", device="cpu")
