"""The port's optimizers, LR schedules and numpy-only helpers against the
JAX package.

Optimizers run a few steps on shared params and gradients against the
reference's jitted ``update``.  Tolerance 1e-6 relative to a leaf's
largest entry: XLA contracts ``beta * m + g`` into a fused multiply-add
where PyTorch rounds twice (1.4e-7 measured after 6 steps), and adam's
``b ** step`` and ``sqrt`` may differ in the last bit.  The schedules are
bitwise, except ``cosine`` whose ``cos`` differs by up to an ulp (7.5e-8
measured).  ``dirichlet_partition`` and the groupings are numpy-only and
held bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.grouping as JG  # noqa: E402
import repro.data.federated as JF  # noqa: E402
import repro.optim as JO  # noqa: E402

import repro_torch.core as P  # noqa: E402
import repro_torch.data as PD  # noqa: E402
import repro_torch.optim as PO  # noqa: E402

RTOL = 1e-6

OPTIMIZERS = {
    "momentum": (JO.momentum(0.05), PO.momentum(0.05)),
    "nesterov": (JO.momentum(0.05, 0.8, nesterov=True),
                 PO.momentum(0.05, 0.8, nesterov=True)),
    "adam": (JO.adam(1e-2), PO.adam(1e-2)),
    "adam_weight_decay": (JO.adam(1e-2, weight_decay=0.01),
                          PO.adam(1e-2, weight_decay=0.01)),
    "adam_cosine": (JO.adam(JO.cosine(0.1, 10, 3)),
                    PO.adam(PO.cosine(0.1, 10, 3))),
    "sgd_warmup": (JO.sgd(JO.linear_warmup(0.1, 4)),
                   PO.sgd(PO.linear_warmup(0.1, 4))),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizers_match_reference(name):
    jopt, popt = OPTIMIZERS[name]
    rng = np.random.default_rng(len(name))
    p = {"w": rng.normal(size=(5, 7)).astype(np.float32),
         "b": rng.normal(size=(3,)).astype(np.float32)}
    jp = jax.tree.map(jnp.asarray, p)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    js, ts = jopt.init(jp), popt.init(tp)
    assert sorted(ts) == sorted(js)          # "step", "m", "v" as used
    jupdate = jax.jit(jopt.update)
    for _ in range(6):
        g = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in p.items()}
        ju, js = jupdate(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = popt.update({k: torch.from_numpy(v) for k, v in g.items()},
                             ts, tp)
        jp = jax.tree.map(lambda a, b: a + b, jp, ju)
        tp = {k: tp[k] + tu[k] for k in tp}
    assert int(ts["step"]) == int(js["step"]) == 6
    for k in p:
        want = np.asarray(jp[k])
        assert tp[k].dtype == torch.float32
        assert np.abs(tp[k].numpy() - want).max() <= \
            RTOL * np.abs(want).max(), k
        for key in ("m", "v"):
            if key in js:
                w = np.asarray(js[key][k])
                assert np.abs(ts[key][k].numpy() - w).max() <= \
                    RTOL * np.abs(w).max(), (key, k)


SCHEDULES = {
    "constant": (JO.constant(0.3), PO.constant(0.3), True),
    "linear_warmup": (JO.linear_warmup(0.1, 7), PO.linear_warmup(0.1, 7),
                      True),
    "cosine": (JO.cosine(0.1, 50, 5), PO.cosine(0.1, 50, 5), False),
    "cosine_no_warmup": (JO.cosine(0.2, 33), PO.cosine(0.2, 33), False),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_reference(name):
    """Under jit, as the engine runs them: XLA multiplies by the f32
    reciprocal of the Python constants the schedules divide by."""
    jf, pf, bitwise = SCHEDULES[name]
    jfn = jax.jit(jf)
    want = np.array([float(jfn(jnp.int32(s))) for s in range(60)],
                    np.float32)
    got = np.array([float(pf(torch.tensor(s, dtype=torch.int32)))
                    for s in range(60)], np.float32)
    if bitwise:
        assert np.array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= RTOL * np.abs(want).max()
    out = pf(torch.tensor(3, dtype=torch.int32))
    assert out.dtype == torch.float32 and out.ndim == 0


@pytest.mark.parametrize("alpha", [0.1, 1.0, 100.0])
def test_dirichlet_partition_equal_to_reference(alpha):
    x, y = PD.make_classification(seed=3, num_classes=8, dim=4,
                                  per_class=40)
    for seed in range(3):
        want = JF.dirichlet_partition(y, 8, alpha, seed=seed)
        got = PD.dirichlet_partition(y, 8, alpha, seed=seed)
        assert len(got) == 8
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    for bad in ((0, 1.0), (8, 0.0), (8, float("nan"))):
        with pytest.raises(ValueError):
            PD.dirichlet_partition(y, *bad)


def test_groupings_equal_to_reference():
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 5, size=12)
    assert P.group_iid(labels, 3).assignment == \
        JG.group_iid(labels, 3).assignment
    assert P.group_noniid(labels, 4).assignment == \
        JG.group_noniid(labels, 4).assignment
    grads = rng.normal(size=(12, 6))
    assert P.diversity_grouping(grads, 3).assignment == \
        JG.diversity_grouping(grads, 3).assignment
    g_p = P.Grouping((0, 0, 0, 1, 1, 2, 2, 2))
    g_j = JG.Grouping((0, 0, 0, 1, 1, 2, 2, 2))
    for frac, seed in ((0.5, 0), (0.1, 1), (1.0, 2)):
        assert np.array_equal(P.sample_participation(g_p, frac, seed),
                              JG.sample_participation(g_j, frac, seed))
        assert np.array_equal(P.sample_participation((2, 4), frac, seed),
                              JG.sample_participation((2, 4), frac, seed))
