"""The port's workload against the JAX package: models on shared params,
and the numpy-only data module copied from it.

Loss and gradients of the mlp, linear and cnn models must agree to within
1e-5 (max |diff| over max |reference| per leaf): the frameworks order the
sums of a matrix product or convolution differently.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.data as JD  # noqa: E402
from repro.models import SimpleConfig as JConfig  # noqa: E402
from repro.models import SimpleModel as JModel  # noqa: E402

import repro_torch.data as PD  # noqa: E402
from repro_torch.models import (SimpleConfig, SimpleModel,  # noqa: E402
                                params_from_numpy, params_to_numpy)

TOL = 1e-5

CONFIGS = [
    dict(kind="mlp", input_dim=24, hidden=32, num_classes=8),
    dict(kind="linear", input_dim=12, num_classes=5),
    dict(kind="cnn", input_dim=8, channels=2, num_classes=4),
]


def _batch(cfg, seed: int, b: int = 6):
    rng = np.random.default_rng(seed)
    feat = cfg["input_dim"] ** 2 * cfg.get("channels", 1) \
        if cfg["kind"] == "cnn" else cfg["input_dim"]
    return {"x": rng.normal(size=(b, feat)).astype(np.float32),
            "y": rng.integers(0, cfg["num_classes"], size=b).astype(np.int32)}


def _close(got, want):
    for k in want:
        if isinstance(want[k], dict):
            _close(got[k], want[k])
            continue
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        assert np.abs(got[k] - w).max() <= TOL * max(np.abs(w).max(), 1e-6), k


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c["kind"])
def test_loss_and_grads_match_reference(cfg):
    torch.backends.cudnn.allow_tf32 = False      # TF32 rule (card only)
    jm, pm = JModel(JConfig(**cfg)), SimpleModel(SimpleConfig(**cfg))
    p0 = jax.device_get(jm.init(jax.random.PRNGKey(3)))
    # non-zero biases, so their gradients and layouts are exercised too
    p0 = jax.tree.map(lambda a: a + 0.01 * np.arange(a.size, dtype=np.float32)
                      .reshape(a.shape) / a.size, p0)
    batch = _batch(cfg, seed=7)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        p0, jax.tree.map(jnp.asarray, batch))
    pp = params_from_numpy(p0, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    pg, (pl, paux) = torch.func.grad(
        lambda p, b: (lambda l, a: (l, (l, a)))(*pm.loss(p, b)),
        has_aux=True)(pp, tb)
    assert abs(float(pl) - float(jl)) <= TOL * abs(float(jl))
    assert abs(float(paux["ce"]) - float(jaux["ce"])) <= TOL * abs(float(jl))
    _close(params_to_numpy(pg), jax.device_get(jg))
    acc_j = float(jax.jit(jm.accuracy)(p0, jax.tree.map(jnp.asarray, batch)))
    assert float(pm.accuracy(pp, tb)) == acc_j


def test_params_layout_roundtrip():
    cfg = CONFIGS[2]
    p0 = jax.device_get(JModel(JConfig(**cfg)).init(jax.random.PRNGKey(0)))
    pp = params_from_numpy(p0, device="cpu")
    assert tuple(pp["c1"]["w"].shape) == (8, 2, 3, 3)       # OIHW
    back = params_to_numpy(pp)
    for k in p0:
        for n in p0[k]:
            assert np.array_equal(back[k][n], p0[k][n])
    init = SimpleModel(SimpleConfig(**cfg)).init(
        torch.Generator().manual_seed(0), device="cpu")
    assert {k: {n: tuple(v.shape) for n, v in d.items()}
            for k, d in params_to_numpy(init).items()} == \
        {k: {n: v.shape for n, v in d.items()} for k, d in p0.items()}


def test_init_is_seeded_and_device_independent():
    m = SimpleModel(SimpleConfig(kind="mlp", input_dim=6, hidden=4,
                                 num_classes=3))
    a = m.init(torch.Generator().manual_seed(5), device="cpu")
    b = m.init(torch.Generator().manual_seed(5), device="cpu")
    assert all(torch.equal(a[k][n], b[k][n]) for k in a for n in a[k])


def test_federated_data_equal_to_reference():
    xj, yj = JD.make_classification(seed=2, num_classes=5, dim=7,
                                    per_class=30)
    xp, yp = PD.make_classification(seed=2, num_classes=5, dim=7,
                                    per_class=30)
    assert np.array_equal(xp, xj) and np.array_equal(yp, yj)
    labels = [[0, 1], [1, 2], [3], [4, 0]]
    pj = JD.label_shard_partition(yj, labels, seed=1, n_workers=4)
    pp = PD.label_shard_partition(yp, labels, seed=1, n_workers=4)
    assert all(np.array_equal(a, b) for a, b in zip(pp, pj))
    dj, dp = JD.FederatedDataset(xj, yj, pj), PD.FederatedDataset(xp, yp, pp)
    for t in (0, 5):
        bj, bp = dj.batch(t, 9), dp.batch(t, 9)
        assert np.array_equal(bp["x"], bj["x"])
        assert np.array_equal(bp["y"], bj["y"])
    assert np.array_equal(dp.global_batch(50)["y"], dj.global_batch(50)["y"])
    with pytest.raises(ValueError):
        dp.require_workers(5)
    with pytest.raises(ValueError):
        PD.label_shard_partition(yp, [[9]])
