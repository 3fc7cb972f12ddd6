"""The port's schedules and aggregations against the JAX package.

Schedules, groupings and the compiled rounds are host-side and must be
equal.  ``aggregate`` on random worker-stacked tensors must match at every
level, mask and partial-group event to within 1e-6 relative (max |diff|
over max |reference|): the two frameworks sum the group members in
different orders.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as P  # noqa: E402

RTOL = 1e-6


def _ev(ev):
    return None if ev is None else (ev.level, ev.groups, ev.weights)


SPECS = [((2, 4), (16, 4)), ((2, 2, 2), (16, 4, 2)), ((8,), (4,)),
         ((3, 2), (6, 3))]


@pytest.mark.parametrize("gs,periods", SPECS)
def test_hierarchy_schedule_equal(gs, periods):
    js, ps = J.HierarchySpec(gs, periods), P.HierarchySpec(gs, periods)
    assert ps.schedule(50) == js.schedule(50)
    assert ps.sync_counts(50) == js.sync_counts(50)
    assert ps.n_workers == js.n_workers
    assert [ps.n_at_level(l) for l in range(1, len(gs) + 1)] == \
        [js.n_at_level(l) for l in range(1, len(gs) + 1)]
    assert P.two_level(8, 2, 16, 4) == P.HierarchySpec((2, 4), (16, 4))
    assert P.local_sgd(4, 3).schedule(9) == J.local_sgd(4, 3).schedule(9)


def _topologies(seed: int = 1):
    gj = J.random_grouping(8, 2, seed=seed)
    gp = P.random_grouping(8, 2, seed=seed)
    return [
        (J.make_topology("two_level", n=8, N=2, G=16, I=4),
         P.make_topology("two_level", n=8, N=2, G=16, I=4)),
        (J.make_topology("uniform", spec=J.HierarchySpec((2, 2, 2),
                                                         (16, 4, 2))),
         P.make_topology("uniform", spec=P.HierarchySpec((2, 2, 2),
                                                         (16, 4, 2)))),
        (J.make_topology("local_sgd", n=4, P=3),
         P.make_topology("local_sgd", n=4, P=3)),
        (J.make_topology("grouped", grouping=gj, G=8, I=(2, 4)),
         P.make_topology("grouped", grouping=gp, G=8, I=(2, 4))),
        (J.make_topology(J.Grouping((0, 0, 0, 1, 1, 2, 2, 2)), G=12,
                         I=(2, 3, 4)),
         P.make_topology(P.Grouping((0, 0, 0, 1, 1, 2, 2, 2)), G=12,
                         I=(2, 3, 4))),
    ]


@pytest.mark.parametrize("case", range(5))
def test_topology_schedules_and_rounds_equal(case):
    jt, pt = _topologies()[case]
    assert pt.n == jt.n and tuple(pt.periods) == tuple(jt.periods)
    js, ps = jt.schedule(40), pt.schedule(40)
    assert [_ev(e) for e in ps] == [_ev(e) for e in js]
    for ev_j, ev_p in zip(js, ps):
        if ev_j is not None:
            a, b = jt.participants(ev_j), pt.participants(ev_p)
            assert (a is None and b is None) or np.array_equal(a, b)
    for cut, t0 in ((0, 0), (5, 0), (16, 3)):
        jr = J.compile_schedule(js[t0:], cut_every=cut, t0=t0)
        pr = P.compile_schedule(ps[t0:], cut_every=cut, t0=t0)
        assert [(r.n_local, _ev(r.event)) for r in pr] == \
            [(r.n_local, _ev(r.event)) for r in jr]


def test_groupings_equal():
    for seed in range(3):
        assert P.random_grouping(12, 3, seed).assignment == \
            J.random_grouping(12, 3, seed).assignment
    g = P.Grouping((0, 1, 1, 2, 0))
    assert np.array_equal(g.onehot(), J.Grouping((0, 1, 1, 2, 0)).onehot())
    assert np.array_equal(g.sizes, [2, 2, 1]) and g.N == 3
    assert P.contiguous(6, 3).assignment == J.contiguous(6, 3).assignment


def _tree(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(n, 5, 3)).astype(np.float32),
            "b": rng.normal(size=(n, 7)).astype(np.float32)}


def _jax_tree(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _close(got, want):
    for k in want:
        g = got[k].numpy()
        w = np.asarray(want[k])
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= RTOL * np.abs(w).max(), k


MASKS = [None, (1, 0, 1, 1, 0, 1, 1, 1), (0, 0, 0, 0, 1, 1, 0, 1)]


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("case", [0, 1, 3, 4])
def test_aggregate_matches_reference(case, mask):
    """Every event the topology fires in one global period (levels, full
    and partial-group events) plus a runtime mask."""
    jt, pt = _topologies()[case]
    tree = _tree(jt.n, seed=case)
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    events = {_ev(e): (e, f) for e, f in zip(jt.schedule(jt.periods[0]),
                                             pt.schedule(pt.periods[0]))
              if e is not None}
    assert len(events) >= 2
    for ev_j, ev_p in events.values():
        jm = None if mask is None else jnp.asarray(mask, bool)
        tm = None if mask is None else torch.tensor(mask, dtype=torch.bool)
        want = jt.aggregate(_jax_tree(tree), ev_j, mask=jm)
        got = pt.aggregate(ttree, ev_p, mask=tm)
        _close(got, want)


AGGREGATORS = {
    "compressed": dict(aggregator="compressed"),
    "bf16_flag": dict(sync_dtype="bfloat16"),
    "weighted": dict(aggregator="weighted"),
    "signsgd": dict(aggregator="signsgd"),
}


def _with_aggregator(jt, pt, kw):
    """The same topology again, with the aggregator ``kw`` selects."""
    if kw.get("aggregator") == "weighted":
        w = np.linspace(0.5, 2.0, jt.n)
        kw = {"aggregator": None}
        jkw = {"aggregator": J.make_aggregator("weighted", weights=w)}
        pkw = {"aggregator": P.make_aggregator("weighted", weights=w)}
    else:
        jkw = pkw = kw
    if hasattr(jt, "spec"):
        return (J.make_topology(jt.spec, **jkw),
                P.make_topology(P.HierarchySpec(jt.spec.group_sizes,
                                                jt.spec.periods), **pkw))
    g = jt.grouping.assignment
    return (J.make_topology(J.Grouping(g), G=jt.G, I=jt.I, **jkw),
            P.make_topology(P.Grouping(g), G=pt.G, I=pt.I, **pkw))


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("case", [0, 1, 3, 4])
@pytest.mark.parametrize("agg", sorted(AGGREGATORS))
def test_aggregators_match_reference(agg, case, mask):
    """The compressed (bf16), weighted and SignSGD rules on every event
    of one global period, with and without a runtime mask.  Uniform
    hierarchies reduce bf16 sums with rounding after every add, as XLA
    does, and agree to 1e-6 like f32.  The grouped topologies' bf16 means
    are products with the membership matrix, which the two frameworks
    round differently, and a global event rounds again in the mean of
    group means: 2 bf16 ulps measured at the largest entry (2^-8 of it
    each), held to 2^-6 of it."""
    jt, pt = _with_aggregator(*_topologies()[case], AGGREGATORS[agg])
    assert repr(pt.aggregator) == repr(jt.aggregator)
    tree = _tree(jt.n, seed=case + 10)
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    events = {_ev(e): (e, f) for e, f in zip(jt.schedule(jt.periods[0]),
                                             pt.schedule(pt.periods[0]))
              if e is not None}
    half = pt.aggregator.accum_dtype == torch.bfloat16
    rtol = 2.0 ** -6 if half and not hasattr(jt, "spec") else RTOL
    for ev_j, ev_p in events.values():
        jm = None if mask is None else jnp.asarray(mask, bool)
        tm = None if mask is None else torch.tensor(mask, dtype=torch.bool)
        want = jt.aggregate(_jax_tree(tree), ev_j, mask=jm)
        got = pt.aggregate(ttree, ev_p, mask=tm)
        for k in want:
            g, w = got[k].numpy(), np.asarray(want[k])
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= rtol * np.abs(w).max(), k


def test_unported_aggregators_raise():
    """Every aggregator of the reference is ported: ``aggregator="sign"``
    and ``sync_dtype="bfloat16"`` resolve to the reference's rules.  What
    still raises is a name neither package registers."""
    for kw in ({"aggregator": "sign"}, {"sync_dtype": "bfloat16"},
               {"aggregator": "bf16", "sync_dtype": "float16"}):
        pt = P.make_topology("two_level", n=4, N=2, G=4, I=2, **kw)
        jt = J.make_topology("two_level", n=4, N=2, G=4, I=2, **kw)
        assert repr(pt.aggregator) == repr(jt.aggregator)
    assert repr(P.make_aggregator("mean")) == repr(J.make_aggregator("mean"))
    with pytest.raises(KeyError, match="unknown aggregator"):
        P.make_aggregator("median")
    with pytest.raises(ValueError, match="weights"):
        P.make_aggregator("weighted", weights=[-1.0, 2.0])
