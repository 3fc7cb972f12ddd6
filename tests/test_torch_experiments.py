"""The port's experiment harness and mains (``repro_torch.experiments``)
against the JAX package's (``benchmarks/``), on the CPU at small sizes.

Both packages start from the params the reference's ``model.init`` draws
(exported to numpy and passed as ``init_params``) and see the same numpy
batches.  Tolerances: losses and accuracies of a trajectory within 1e-5
relative at every eval point, as the trajectories of
``tests/test_torch_hsgd.py``; per-step losses of ``run`` and the params
of ``worker_params`` within 1e-5 of the largest reference value; the
gradients behind Fig. 3c within 1e-6 of the largest and the divergences
within 1e-6 of the largest term (``tests/test_torch_divergence.py``);
the groupings, the communication model, ``time_to_target`` and Table 1's
rows exactly.  The live mains themselves run on the card
(``chip_smoke.py``), not here.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import common as BC  # noqa: E402
from benchmarks import fig_e4_participation as JE4  # noqa: E402
from benchmarks import table1_bounds as JT1  # noqa: E402
import repro.core as J  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402

import repro_torch.core as P  # noqa: E402
from repro_torch.experiments import common as PC  # noqa: E402
from repro_torch.experiments import fig3c_grouping as PF3C  # noqa: E402
from repro_torch.experiments import fig_e4_participation as PE4  # noqa: E402
from repro_torch.experiments import table1_bounds as PT1  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402

RTOL = 1e-5


def _p0(model, seed=0):
    return jax.device_get(model.init(jax.random.PRNGKey(seed)))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def test_make_world_matches_reference():
    for kw in ({}, {"num_classes": 4}, {"n_workers": 16}):
        (ds, model), (jds, jmodel) = PC.make_world(**kw), BC.make_world(**kw)
        assert np.array_equal(ds.x, jds.x) and np.array_equal(ds.y, jds.y)
        assert all(np.array_equal(a, b) for a, b in zip(ds.parts, jds.parts))
        assert model.cfg.__dict__ == jmodel.cfg.__dict__


def _topos(kind):
    if kind == "two_level":
        return (J.make_topology("two_level", n=8, N=2, G=16, I=4),
                P.make_topology("two_level", n=8, N=2, G=16, I=4))
    return (J.make_topology(J.random_grouping(8, 2, seed=1), G=8, I=(2, 4)),
            P.make_topology(P.random_grouping(8, 2, seed=1), G=8, I=(2, 4)))


@pytest.mark.parametrize("use_rounds", [False, True])
@pytest.mark.parametrize("kind", ["two_level", "grouped"])
def test_trajectory_matches_reference(kind, use_rounds):
    jds, jmodel = BC.make_world(8)
    ds, model = PC.make_world(8)
    jt, pt = _topos(kind)
    want = BC.trajectory(jds, jmodel, jt, 16, eval_every=4,
                         use_rounds=use_rounds)
    got = PC.trajectory(ds, model, pt, 16, eval_every=4,
                        use_rounds=use_rounds, device="cpu",
                        init_params=_p0(jmodel))
    assert [r["step"] for r in got] == [r["step"] for r in want] == \
        [4, 8, 12, 16]
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= RTOL * abs(w["loss"])
        assert abs(g["acc"] - w["acc"]) <= RTOL * abs(w["acc"])
    walls = [r["wall_s"] for r in got]
    assert walls == sorted(walls) and walls[0] > 0


def test_mean_trajectories_and_steps_per_sec_run_on_the_cpu():
    ds, model = PC.make_world(8)
    spec = P.two_level(8, 2, 8, 2)
    runs = [PC.trajectory(ds, model, P.make_topology(spec), 8, seed=s,
                          eval_every=4, device="cpu") for s in (0, 1)]
    mean = PC.mean_trajectories(ds, model, lambda: P.make_topology(spec), 8,
                                seeds=(0, 1), eval_every=4, device="cpu")
    for i, rec in enumerate(mean):
        assert rec["loss"] == float(np.mean([r[i]["loss"] for r in runs]))
    for use_rounds in (False, True):
        sps = PC.steps_per_sec(ds, model, spec, T=8, warmup=8,
                               use_rounds=use_rounds, device="cpu")
        assert np.isfinite(sps) and sps > 0


SPECS = [J.local_sgd(8, 4), J.local_sgd(8, 16), J.two_level(8, 2, 16, 4),
         J.two_level(8, 2, 64, 2), J.HierarchySpec((2, 2, 2), (16, 4, 2))]


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_comm_model_and_time_to_target_equal_reference(spec):
    pspec = P.HierarchySpec(spec.group_sizes, spec.periods)
    for steps in (1, 4, 17, 64, 120, 300):
        for kind in ("cnn", "vgg11"):
            for far in (True, False):
                assert PC.comm_time_ms(pspec, steps, kind, far) == \
                    BC.comm_time_ms(spec, steps, kind, far)
    hist = [{"step": 4 * (i + 1), "loss": 1.0, "acc": a}
            for i, a in enumerate((0.1, 0.5, 0.74, 0.75, 0.9, 0.2))]
    for target in (0.75, 0.5, 0.95):
        assert PC.time_to_target(hist, pspec, target) == \
            BC.time_to_target(hist, spec, target)


@pytest.mark.parametrize("quick", [True, False])
def test_table1_rows_equal_reference(quick):
    got, want = PT1.rows(quick), JT1.rows(quick)
    assert got == want
    assert all(v == 1.0 for k, v in got[1].items() if k != "grid_points")


def test_fig3c_groupings_and_divergences_on_shared_grads():
    """The grouping is a discontinuous function of the grads: on the
    reference's grads the twin picks the reference's groupings, and on
    its own grads from the reference's params, the same ones again."""
    jds, jmodel = BC.make_world(8, num_classes=4)
    ds, model = PC.make_world(8, num_classes=4)
    p0 = _p0(jmodel)
    jgrads = J.per_worker_grads(jmodel.loss, jax.tree.map(jnp.asarray, p0),
                                jax.tree.map(jnp.asarray,
                                             jds.full_per_worker(64)))
    labels = jds.dominant_labels()
    want = {"iid": J.group_iid(labels, 2), "non": J.group_noniid(labels, 2),
            "auto": J.diversity_grouping(np.asarray(jgrads), 2)}
    shared = torch.from_numpy(np.array(jgrads))
    got = PF3C.groupings(ds, shared)
    assert {k: g.assignment for k, g in got.items()} == \
        {k: g.assignment for k, g in want.items()}
    for k in want:
        pd = P.all_divergences(shared, got[k])
        jd = J.all_divergences(jgrads, want[k])
        assert _rel([pd[m] for m in jd], [jd[m] for m in jd]) <= 1e-6, k
    grads, gs, divs = PF3C.measured(ds, model, torch.device("cpu"),
                                    init_params=p0)
    assert _rel(grads.numpy(), np.asarray(jgrads)) <= 1e-6
    assert {k: g.assignment for k, g in gs.items()} == \
        {k: g.assignment for k, g in want.items()}
    # the claims' divergence ratios (fig3c_grouping.py's asserts)
    assert divs["iid"]["upward"] < 0.1 * divs["non"]["upward"]
    assert divs["auto"]["upward"] < 0.5 * divs["non"]["upward"]


def _engines():
    jds, jmodel = BC.make_world(8)
    ds, model = PC.make_world(8)
    je = J.HSGD(jmodel.loss, jsgd(0.08),
                J.make_topology("two_level", n=8, N=2, G=8, I=2))
    pe = P.HSGD(model.loss, sgd(0.08),
                P.make_topology("two_level", n=8, N=2, G=8, I=2))
    js = je.init(jax.random.PRNGKey(0), jmodel.init)
    ps = pe.init_from_params(params_from_numpy(_p0(jmodel), "cpu"),
                             device="cpu")
    return (je, js, jds), (pe, ps, ds)


def test_run_and_worker_params_match_reference():
    (je, js, jds), (pe, ps, ds) = _engines()

    def jeval(state, t):
        return {"w0": float((je.worker_params(state, 0)["h1"]["w"] ** 2)
                            .sum()),
                "t_eval": t}

    def peval(state, t):
        return {"w0": float((pe.worker_params(state, 0)["h1"]["w"] ** 2)
                            .sum()),
                "t_eval": t}

    js, jh = J.run(je, js, lambda t: jax.tree.map(jnp.asarray,
                                                  jds.batch(t, 10)),
                   12, eval_every=5, eval_fn=jeval)
    ps, ph = P.run(pe, ps, lambda t: ds.batch(t, 10), 12, eval_every=5,
                   eval_fn=peval)
    assert [sorted(r) for r in ph] == [sorted(r) for r in jh]
    assert [r["t"] for r in ph] == list(range(1, 13))
    assert [r.get("t_eval") for r in ph] == [r.get("t_eval") for r in jh]
    assert _rel([r["ce"] for r in ph], [r["ce"] for r in jh]) <= RTOL
    assert _rel([r["w0"] for r in ph if "w0" in r],
                [r["w0"] for r in jh if "w0" in r]) <= RTOL
    for j in (0, 3, 7):
        jw, pw = je.worker_params(js, j), pe.worker_params(ps, j)
        for k in jw:
            for n in jw[k]:
                assert pw[k][n].shape == jw[k][n].shape
                assert _rel(pw[k][n].numpy(), jw[k][n]) <= RTOL, (j, k, n)


def test_participation_run_matches_reference():
    """Fig. E.4's run: masks re-drawn every round, both packages."""
    jds, jmodel = BC.make_world(16)
    ds, model = PC.make_world(16)
    spec = J.two_level(16, 2, 8, 2)
    pspec = P.two_level(16, 2, 8, 2)
    want = JE4.run(jds, jmodel, spec, 12, seed=1)
    got = PE4.run(ds, model, pspec, 12, seed=1, device="cpu",
                  init_params=_p0(jmodel, seed=1))
    assert abs(got[0] - want[0]) <= RTOL * abs(want[0])
    assert abs(got[1] - want[1]) <= RTOL * abs(want[1])
