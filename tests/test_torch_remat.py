"""Rematerialization in the port (``repro_torch.models.remat``), the
counterpart of the reference's ``jax.checkpoint``, on the CPU.

Reduced qwen2-0.5b, olmoe-1b-7b and seamless-m4t-large-v2 in float32 at
32 tokens with ``attn_chunk_q`` = 8, so that the chunked attention (each
chunk's body rematerialized, always) runs in every attention layer:

* ``cfg.remat`` (every pattern unit, or every decoder layer, run again in
  the backward) leaves the loss bit for bit and the gradient within
  SAME_RTOL of its largest entry, under ``torch.func.grad``, under
  ``vmap(grad)`` and under plain autograd (bit for bit for the
  decoder-only LMs); the rematerialized gradients
  against the reference's ``jax.grad`` with ``remat=True`` from the same
  numpy params, within GRAD_RTOL of the largest entry (the LM tests');
* under plain autograd no saved tensor has a chunk's (B, H, chunk, Sk)
  probabilities' shape, and ``cfg.remat`` saves fewer bytes;
* the recorded H-SGD training step of reduced qwen2-0.5b prices, beyond
  the unchunked step, exactly one forward's chunk products (Q.K^T and
  P.V again), and with ``cfg.remat`` exactly one forward of the units
  more, each against a hand count.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import (HSGD, EngineConfig, HierarchySpec,  # noqa: E402
                              make_topology)
from repro_torch.models import build_model, params_from_numpy  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.roofline import analyze_program  # noqa: E402
from repro_torch.tree import (tree_flatten, tree_leaves,  # noqa: E402
                              tree_map)

ARCHS = ("qwen2-0.5b", "olmoe-1b-7b", "seamless-m4t-large-v2")
B, S, CHUNK, FRAMES = 2, 32, 8, 6
GRAD_RTOL = 1e-5     # against the reference, of the largest entry
SAME_RTOL = 1e-6     # remat on against off, of the largest entry


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these small runs only lose to the other test
    processes' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **over):
    over = dict(attn_chunk_q=CHUNK, **over)
    return reduced(get_config(arch), **over), jreduced(jget_config(arch),
                                                       **over)


def _batch(cfg, seed=1, lead=()):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, lead + (B, S)),
         "targets": rng.integers(0, cfg.vocab_size, lead + (B, S))}
    b = {k: v.astype(np.int32) for k, v in b.items()}
    if cfg.family == "encdec":
        b["enc_inputs"] = rng.standard_normal(
            lead + (B, FRAMES, cfg.d_model)).astype(np.float32)
    return b


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def world(request):
    cfg, jcfg = _cfgs(request.param)
    jm = jbuild_model(dataclasses.replace(jcfg, remat=True))
    jp = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0)))
    return cfg, jm, jp, params_from_numpy(jp, device="cpu")


def _loss_fn(cfg, remat):
    model = build_model(dataclasses.replace(cfg, remat=remat))
    return lambda p, b: model.loss(p, b)[0]


def _close(got, want, rtol):
    top = max(float(w.abs().max()) for w in want)
    return max(float((g - w).abs().max()) for g, w in zip(got, want)) \
        <= rtol * top


def _same(got, want, bitwise):
    if bitwise:
        return all(torch.equal(a, b) for a, b in zip(got, want))
    return _close(got, want, SAME_RTOL)


def test_remat_keeps_loss_and_gradient(world):
    """Loss bit for bit; gradients within SAME_RTOL of the largest entry
    under grad, vmap(grad) and plain autograd, and bit for bit there for
    the decoder-only LMs; the encoder-decoder's encoder leaves take the
    decoder layers' gradients of the memory summed in another order (4e-8
    of the largest entry)."""
    cfg, _, _, params = world
    bitwise = cfg.family != "encdec"
    batch = _torch(_batch(cfg))
    off, on = _loss_fn(cfg, False), _loss_fn(cfg, True)
    assert torch.equal(off(params, batch), on(params, batch))
    g_off = tree_leaves(torch.func.grad(off)(params, batch))
    g_on = tree_leaves(torch.func.grad(on)(params, batch))
    assert _same(g_on, g_off, bitwise)
    rows = _torch(_batch(cfg, lead=(2,)))
    stacked = tree_map(lambda t: torch.stack([t, t * 1.01]), params)
    v_off, v_on = (tree_leaves(torch.func.vmap(torch.func.grad(f))(
        stacked, rows)) for f in (off, on))
    assert _same(v_on, v_off, bitwise)
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(params)]
    _, tdef = tree_flatten(params)
    a_off, a_on = (torch.autograd.grad(f(tdef.unflatten(leaves), batch),
                                       leaves) for f in (off, on))
    assert _same(a_on, a_off, bitwise)


def test_remat_gradient_matches_reference(world):
    """``torch.func.grad`` with ``cfg.remat`` against ``jax.grad`` of the
    reference with ``remat=True``, leaf for leaf."""
    cfg, jm, jp, params = world
    batch = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jg = jax.jit(jax.grad(lambda p: jm.loss(p, jb)[0]))(jp)
    pg = torch.func.grad(_loss_fn(cfg, True))(params, _torch(batch))
    want = [torch.from_numpy(np.asarray(g)) for g in jax.tree.leaves(jg)]
    got = tree_leaves(pg)
    assert [g.shape for g in got] == [w.shape for w in want]
    assert _close(got, want, GRAD_RTOL)


def _saved(cfg, params, batch):
    """(shapes, bytes) of every tensor autograd saves in one ``loss``."""
    shapes, total = [], [0]

    def pack(t):
        shapes.append(tuple(t.shape))
        total[0] += t.numel() * t.element_size()
        return t

    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(params)]
    _, tdef = tree_flatten(params)
    model = build_model(cfg)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = model.loss(tdef.unflatten(leaves), batch)[0]
    torch.autograd.grad(loss, leaves)
    return shapes, total[0]


def test_no_chunk_probabilities_are_saved(world):
    cfg, _, _, params = world
    batch = _torch(_batch(cfg))
    probs = (B, cfg.num_heads, CHUNK, S)
    plain, plain_bytes = _saved(cfg, params, batch)
    assert probs not in plain
    unit, unit_bytes = _saved(dataclasses.replace(cfg, remat=True), params,
                              batch)
    assert probs not in unit
    assert unit_bytes < plain_bytes
    # the control: the unchunked attention saves its (B, H, S, S) ones
    dense, _ = _saved(dataclasses.replace(cfg, attn_chunk_q=S), params,
                      batch)
    assert (B, cfg.num_heads, S, S) in dense


def _step_products(cfg, n=2):
    """Product FLOPs (both classes) of one recorded local H-SGD step of
    ``n`` workers, each on its own (B, S) batch."""
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    topo = make_topology(HierarchySpec((n,), (4,)))
    eng = HSGD(model.loss, sgd(1e-3), topo, EngineConfig())
    state = eng.init_from_params(params, device="cpu")
    rep = analyze_program("step", eng.step_fn(None), state,
                          _torch(_batch(cfg, lead=(n,))))
    return sum(rep.flops_by_class.get(c, 0) for c in ("f32", "bf16"))


def test_recorded_step_prices_the_recompute():
    """qwen2-0.5b reduced, 2 workers: chunked minus unchunked is one
    forward's Q.K^T and P.V over all pairs; remat minus no remat is one
    forward of every unit's products."""
    cfg, _ = _cfgs("qwen2-0.5b")
    n, L, h, dh = 2, cfg.num_layers, cfg.num_heads, cfg.d_head
    d, f, hk = cfg.d_model, cfg.d_ff, cfg.num_kv_heads
    attention = 4 * B * h * S * S * dh
    assert cfg.block_pattern == ("global",) and cfg.mlp_variant == "swiglu"
    unit = (2 * B * S * d * (2 * h * dh + 2 * hk * dh)   # q, k, v, o
            + attention + 3 * 2 * B * S * d * f)         # the swiglu MLP
    dense = _step_products(dataclasses.replace(cfg, attn_chunk_q=S), n)
    chunked = _step_products(cfg, n)
    remat = _step_products(dataclasses.replace(cfg, remat=True), n)
    assert chunked - dense == n * L * attention
    assert remat - chunked == n * L * unit
