"""The port's divergences, bounds, planner and the numpy parts of grouping
and data against the JAX package.

Inputs are (n, dim) float32 grads (and trees of them) made with numpy
from a seed, fed to both packages.  Tolerances:

* the divergence functions (``repro_torch.core.divergence``) run their
  sums in PyTorch's order, not XLA's: every output agrees with the
  reference's to within 1e-6 of the largest term of that output
  (max |port - reference| <= 1e-6 * max |reference|);
* ``per_worker_grads`` from the reference's params: 1e-6 of the largest
  gradient;
* the partition identity (eq. 10): |residual| <= 1e-5 of the global
  divergence, for uniform and non-uniform groupings alike (the
  reference's own limit in ``tests/test_theory_properties.py``);
* the numpy modules (``Grouping``'s matrices and ``from_labels``,
  ``FederatedDataset.dominant_labels`` / ``full_per_worker``,
  ``_lift_matrices``, ``theory``, ``planner``): bit for bit.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as J  # noqa: E402
import repro.core.divergence as JD  # noqa: E402
from repro.core import planner as JPL  # noqa: E402
from repro.core import theory as JT  # noqa: E402
from repro.data import FederatedDataset as JDataset  # noqa: E402
from repro.models import SimpleConfig as JConfig  # noqa: E402
from repro.models import SimpleModel as JModel  # noqa: E402

import repro_torch.core as P  # noqa: E402
import repro_torch.core.divergence as PD  # noqa: E402
from repro_torch.core import planner as PPL  # noqa: E402
from repro_torch.core import theory as PT  # noqa: E402
from repro_torch.data import (FederatedDataset, dirichlet_partition,  # noqa: E402
                              label_shard_partition, make_classification)
from repro_torch.models import (SimpleConfig, SimpleModel,  # noqa: E402
                                params_from_numpy)

RTOL = 1e-6
RESIDUAL_RTOL = 1e-5

ASSIGNMENTS = [
    (0, 0, 0, 0, 1, 1, 1, 1),                 # contiguous, uniform
    (0, 1, 2, 3, 0, 1, 2, 3),                 # interleaved, uniform
    (0, 0, 0, 0, 0, 1, 1, 2),                 # non-uniform 5 / 2 / 1
    (2, 0, 1, 1, 0, 2, 2, 2, 1, 0, 2),        # non-uniform, n = 11
    (0,) * 6,                                  # one group
    tuple(range(5)),                           # singletons
]


def _grads(n, dim=40, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, dim)) * rng.uniform(0.1, 3.0, size=(n, 1))
            + rng.normal(size=dim)).astype(np.float32)


def _close(got, want, rtol=RTOL):
    got = np.asarray(got.detach().cpu() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


def _pair(assignment):
    return J.Grouping(tuple(assignment)), P.Grouping(tuple(assignment))


# -- grouping and data (numpy, bit for bit) ----------------------------------
@pytest.mark.parametrize("assignment", ASSIGNMENTS)
def test_grouping_matrices_bit_for_bit(assignment):
    jg, pg = _pair(assignment)
    for name in ("local_matrix", "global_matrix", "onehot", "size_weights"):
        want, got = getattr(jg, name)(), getattr(pg, name)()
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    labels = [7 * a - 3 for a in assignment[::-1]]
    assert P.Grouping.from_labels(labels).assignment == \
        J.Grouping.from_labels(labels).assignment


def test_dataset_views_bit_for_bit():
    x, y = make_classification(seed=3, num_classes=4, dim=6, per_class=30)
    cases = [label_shard_partition(y, [[j % 4] for j in range(8)]),
             dirichlet_partition(y, 5, 0.3, seed=1)]
    for parts in cases:
        ds, jds = FederatedDataset(x, y, parts), JDataset(x, y, parts)
        assert ds.dominant_labels() == jds.dominant_labels()
        for cap in (512, 7):
            got, want = ds.full_per_worker(cap), jds.full_per_worker(cap)
            for k in ("x", "y"):
                assert got[k].dtype == want[k].dtype
                assert np.array_equal(got[k], want[k])


# -- divergences on shared grads ---------------------------------------------
@pytest.mark.parametrize("assignment", ASSIGNMENTS)
def test_divergences_match_reference(assignment):
    jg, pg = _pair(assignment)
    g = _grads(len(assignment))
    jgr, pgr = jax.numpy.asarray(g), torch.from_numpy(g)
    _close(PD.global_divergence(pgr), JD.global_divergence(jgr))
    _close(PD.group_means(pgr, pg), JD.group_means(jgr, jg))
    _close(PD.upward_divergence(pgr, pg), JD.upward_divergence(jgr, jg))
    _close(PD.downward_divergences(pgr, pg),
           JD.downward_divergences(jgr, jg))
    _close(PD.downward_divergence_avg(pgr, pg),
           JD.downward_divergence_avg(jgr, jg))
    _close(PD.divergence_stack(pgr, pg), JD.divergence_stack(jgr, jg))
    got, want = PD.all_divergences(pgr, pg), JD.all_divergences(jgr, jg)
    assert list(got) == list(want)
    _close([got[k] for k in got], [want[k] for k in want])
    groupings = [pg, P.Grouping((0,) * len(assignment))]
    _close(PD.partition_divergences(pgr, groupings),
           JD.partition_divergences(jgr, [jg, J.Grouping(
               (0,) * len(assignment))]))
    out = PD.divergence_stack(pgr, pg)
    assert out.dtype == torch.float32 and out.shape == (4,)


@pytest.mark.parametrize("seed", range(12))
def test_partition_residual_is_zero(seed):
    """eq. (10) for any grads and any grouping, uniform or not."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 13))
    N = int(rng.integers(1, n + 1))
    _, dense = np.unique(rng.integers(0, N, size=n), return_inverse=True)
    pg = P.Grouping(tuple(dense))
    g = torch.from_numpy(_grads(n, dim=int(rng.integers(1, 9)), seed=seed))
    res = float(PD.partition_residual(g, pg))
    assert abs(res) <= RESIDUAL_RTOL * float(PD.global_divergence(g))
    row = PD.partition_divergences(g, [pg])
    assert abs(float(row[0] - row[1] - row[2])) <= \
        RESIDUAL_RTOL * float(row[0])


def _tree(n, seed=1):
    rng = np.random.default_rng(seed)
    return {"b": {"w": rng.normal(size=(n, 3, 4)).astype(np.float32),
                  "a": rng.normal(size=(n, 5)).astype(np.float32)},
            "a": rng.normal(size=(n, 2, 2)).astype(np.float32) * 4}


def _level_groupings():
    """A nested three-level hierarchy's level groupings (outermost first),
    and a non-nested pair."""
    topo = J.make_topology(J.HierarchySpec((2, 2, 2), (16, 4, 2)))
    lg = topo.level_groupings()
    nested = [lg[k].assignment for k in sorted(lg)]
    return [nested, [(0, 0, 0, 0, 1, 1, 1, 1), (0, 1, 0, 1, 0, 1, 0, 1)]]


@pytest.mark.parametrize("kind", ["nested", "not_nested"])
def test_partition_divergences_tree_matches_reference(kind):
    assignments = _level_groupings()[kind == "not_nested"]
    jgs = [J.Grouping(a) for a in assignments]
    pgs = [P.Grouping(a) for a in assignments]
    jl, pl = JD._lift_matrices(jgs), PD._lift_matrices(pgs)
    if kind == "nested":
        assert len(pl) == len(jl) == len(assignments) - 1
        for a, b in zip(pl, jl):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert pl is None and jl is None
    tree = _tree(8)
    jt = jax.tree.map(jax.numpy.asarray, tree)
    pt = {k: ({n: torch.from_numpy(v) for n, v in t.items()}
              if isinstance(t, dict) else torch.from_numpy(t))
          for k, t in tree.items()}
    want = JD.partition_divergences_tree(jt, jgs)
    got = PD.partition_divergences_tree(pt, pgs)
    _close(got, want)
    flat_p = PD.flatten_pytree_batch(pt)
    flat_j = JD.flatten_pytree_batch(jt)
    assert np.array_equal(flat_p.numpy(), np.asarray(flat_j))
    # the fused per-leaf row equals the flat one (additivity over leaves)
    _close(got, PD.partition_divergences(flat_p, pgs), rtol=1e-5)


def test_per_worker_grads_from_reference_params():
    cfg = dict(kind="mlp", input_dim=6, hidden=5, num_classes=4)
    jm, pm = JModel(JConfig(**cfg)), SimpleModel(SimpleConfig(**cfg))
    p0 = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    x, y = make_classification(seed=1, num_classes=4, dim=6, per_class=20)
    ds = FederatedDataset(x, y, label_shard_partition(
        y, [[j % 4] for j in range(6)]))
    batches = ds.full_per_worker(8)
    want = JD.per_worker_grads(jm.loss, jax.tree.map(jax.numpy.asarray, p0),
                               jax.tree.map(jax.numpy.asarray, batches))
    got = PD.per_worker_grads(pm.loss, params_from_numpy(p0, "cpu"), batches)
    assert got.shape == want.shape == (6, 6 * 5 + 5 + 5 * 5 + 5 + 5 * 4 + 4)
    _close(got, want)


# -- theory and planner (numpy, bit for bit) ---------------------------------
GRID = list(itertools.product((8, 16, 64), (2, 4), (16, 64), (2, 4, 16),
                              (0.0, 0.5, 2.0)))


def test_theory_bit_for_bit():
    for n, N, G, I, s2 in GRID:
        e2 = 1.0 + s2
        kw = dict(gamma=0.9 * JT.lr_cap(G, 1.0), T=20_000, L=1.0,
                  sigma2=s2, f0_minus_fstar=2.0)
        assert PT.lr_cap(G, 1.0) == JT.lr_cap(G, 1.0)
        assert PT.theorem2_bound(n=n, N=N, G=G, I=I, eps_tilde2=e2, **kw) \
            == JT.theorem2_bound(n=n, N=N, G=G, I=I, eps_tilde2=e2, **kw)
        sizes = [n // N] * (N - 1) + [n - (n // N) * (N - 1)]
        t1 = dict(n=n, G=G, group_sizes=sizes, I_periods=[I] * N,
                  eps_up2=s2, eps_down2=[e2] * N, **kw)
        assert PT.theorem1_bound(**t1) == JT.theorem1_bound(**t1)
        c1 = dict(n=n, P=G, eps_tilde2=e2, **kw)
        assert PT.corollary1_local_sgd_bound(**c1) == \
            JT.corollary1_local_sgd_bound(**c1)
        for f in ("lemma1_rhs", "lemma2_rhs"):
            assert getattr(PT, f)(n, N, e2) == getattr(JT, f)(n, N, e2)
        for f in ("sandwich_noise_terms", "sandwich_div_terms"):
            assert getattr(PT, f)(n, N, G, I) == getattr(JT, f)(n, N, G, I)
        for l, q in ((1.05, 0.5), (1.5, 0.1), (0.9, 1.0)):
            assert PT.remark5_ok(n, N, G, I, l, q) == \
                JT.remark5_ok(n, N, G, I, l, q)
        args = (n, N, 2000, G, I, s2, e2)
        assert PT.table1_ours(*args) == JT.table1_ours(*args)
        assert PT.table1_yu2019(n, 2000, G, s2, e2) == \
            JT.table1_yu2019(n, 2000, G, s2, e2)
        assert PT.table1_liu2020(n, 2000, G, e2) == \
            JT.table1_liu2020(n, 2000, G, e2)
        assert PT.table1_castiglia2021(n, 2000, G, I, s2) == \
            JT.table1_castiglia2021(n, 2000, G, I, s2)
    for periods, sizes in (((16, 4, 2), (2, 2, 2)), ((32, 8, 4, 1),
                                                     (2, 4, 2, 3))):
        for lvl in range(1, len(sizes)):
            assert PT.theorem3_A1(lvl, periods, sizes) == \
                JT.theorem3_A1(lvl, periods, sizes)
            assert PT.theorem3_A2(lvl, periods, sizes) == \
                JT.theorem3_A2(lvl, periods, sizes)
        kw = dict(gamma=0.01, T=5000, L=2.0, sigma2=0.7, f0_minus_fstar=1.5,
                  periods=periods, group_sizes=sizes, eps_tilde2=1.3)
        assert PT.theorem3_bound(**kw) == JT.theorem3_bound(**kw)


def _plans(pl):
    comm = pl.CommModel(compute_s=0.004, local_round_s=0.00029,
                        global_round_s=0.00453)
    return pl.enumerate_plans(n=64, T=20_000, L=1.0, sigma2=1.0,
                              eps_tilde2=1.0, f0_minus_fstar=2.0, comm=comm)


def test_planner_bit_for_bit():
    def key(p):
        return None if p is None else (p.N, p.G, p.I, p.bound, p.wall_s,
                                       p.gamma)

    mine, ref = _plans(PPL), _plans(JPL)
    assert [key(p) for p in mine] == [key(p) for p in ref]
    assert [key(p) for p in PPL.pareto_front(mine)] == \
        [key(p) for p in JPL.pareto_front(ref)]
    budget = min(p.wall_s for p in ref) * 1.10
    assert key(PPL.best_under_budget(mine, budget)) == \
        key(JPL.best_under_budget(ref, budget))
    for target in (0.06, 0.3, 1e-9):
        assert key(PPL.fastest_under_bound(mine, target)) == \
            key(JPL.fastest_under_bound(ref, target))


@pytest.mark.parametrize("t0", [0, 20])
def test_fit_from_trace_bit_for_bit(t0):
    """A hand-made trace with ``sim_time_s``, from step 1 and resumed at
    t0 > 0 (the clock restarts at 0, record t stays absolute)."""
    spec = (2, 4), (16, 4)
    ptopo = P.make_topology(P.HierarchySpec(*spec))
    jtopo = J.make_topology(J.HierarchySpec(*spec))
    c, lo, gl = 0.004, 0.0003, 0.005
    lv = [ev.level if ev is not None else None for ev in jtopo.schedule(80)]
    hist, clock = [], 0.0
    for t in range(t0 + 1, 81):
        ev = lv[t - 1]
        clock += c + (gl if ev == 1 else lo if ev is not None else 0.0)
        hist.append({"t": t, "sim_time_s": clock * (1 + 1e-3 * (t % 3)),
                     "loss": 1.0})
    got = PPL.CommModel.fit_from_trace(hist, ptopo)
    want = JPL.CommModel.fit_from_trace(hist, jtopo)
    assert got == PPL.CommModel(want.compute_s, want.local_round_s,
                                want.global_round_s)
    assert abs(got.compute_s - c) < 1e-4
    assert PPL.CommModel.fit_from_trace(hist, P.HierarchySpec(*spec)) == got
