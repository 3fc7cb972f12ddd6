"""The port's MoE layer and MoE LMs against the JAX package's, on the CPU.

Reduced olmoe-1b-7b (64 experts top-8 cut to 4 top-2, full attention,
Hq == Hk) and mixtral-8x22b (8 experts top-2 cut to 4 top-2, GQA, window
16), float32, the reference's params carried over through
``params_from_numpy``.

* ``moe_apply`` (einsum and gather dispatch), ``_moe_group`` and
  ``moe_apply_dense`` on the same numpy inputs: y within TOL, the aux loss
  within AUX_TOL.  Cases: one group; groups (t > moe_group and t a
  multiple of it, with ``moe_group`` made small); a drop (capacity 1.0
  and a router skewed toward expert 0: ``reduced()`` itself never drops,
  its capacity factor is E / k), which holds the token-major, slot-minor
  drop order; and tied router probabilities (columns of the router made
  equal), where ``jax.lax.top_k`` takes the lower expert first.
* The whole ``DecoderLM``: ``loss`` (CE and aux), ``forward``, ``prefill``
  and every ``decode_step`` in float32 within TOL, ``forward`` in bfloat16
  within the dense LM tests' BF16_TOL, and ``loss``'s gradient, aux
  included, within GRAD_RTOL of its largest entry against ``jax.grad``.
* One short ``launch.train`` run of reduced olmoe-1b-7b (2 workers, 4
  steps, no codec) from the reference's params and batches: losses within
  1e-5 relative of the reference's driver.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_train import (  # noqa: E402,F401 (a fixture)
    RTOL, one_torch_thread, rel, run_port, run_ref)

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import attention as kattn  # noqa: E402
from repro_torch.models import (build_model, params_from_numpy,  # noqa: E402
                                params_to_numpy)
from repro_torch.models import layers as L  # noqa: E402

TOL = 1e-5           # y and logits, absolute
AUX_TOL = 1e-6       # the load-balance loss, absolute
GRAD_RTOL = 1e-5     # gradients, of the largest entry
BF16_TOL = 3e-2      # tests/test_torch_lm.py
ARCHS = ("olmoe-1b-7b", "mixtral-8x22b")
B, S = 2, 24
# layer cases: config overrides, the router's edit, and whether the
# reference drops a token
CASES = {
    "one_group": ({}, None),
    "groups": ({"moe_group": 8}, None),         # t = 48: six groups of 8
    "drop": ({"capacity_factor": 1.0}, "skew"),
    "tie": ({}, "tie"),
}


def _cfgs(arch, **over):
    return jreduced(jget_config(arch), **over), reduced(get_config(arch),
                                                        **over)


def _layer_inputs(jcfg, edit, seed=0):
    """The reference's ``moe_init`` params and x (B, S, D), as numpy.
    "skew": every token carries a constant feature that the router maps to
    expert 0, which every token then picks; "tie": experts 1 and 2, and 0
    and 3, get equal router columns, so their probabilities tie exactly."""
    p = {k: np.array(v) for k, v in jax.device_get(
        JL.moe_init(jax.random.PRNGKey(seed), jcfg)).items()}
    x = np.random.default_rng(seed).normal(
        size=(B, S, jcfg.d_model)).astype(np.float32)
    if edit == "skew":
        x[..., 0] = 3.0
        p["router"][0, 0] = 5.0
    elif edit == "tie":
        p["router"][:, 2] = p["router"][:, 1]
        p["router"][:, 3] = p["router"][:, 0]
    return p, x


def _jit(fn):
    """The reference's layer function compiled, its config static."""
    return jax.jit(fn, static_argnums=2)


def _port(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


def _maxdiff(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, case, dispatch):
    over, edit = CASES[case]
    jcfg, pcfg = _cfgs(arch, moe_dispatch=dispatch, **over)
    p, x = _layer_inputs(jcfg, edit)
    jy, jaux = _jit(JL.moe_apply)(p, jnp.asarray(x), jcfg)
    py, paux = L.moe_apply(_port(p), torch.from_numpy(x), pcfg)
    assert py.shape == x.shape and py.dtype == torch.float32
    assert _maxdiff(py, jy) < TOL
    assert abs(float(paux) - float(jaux)) < AUX_TOL
    if case == "drop":
        # the same layer without a drop gives other outputs
        _, free = _cfgs(arch, moe_dispatch=dispatch, capacity_factor=4.0)
        py_free, _ = L.moe_apply(_port(p), torch.from_numpy(x), free)
        assert _maxdiff(py, py_free) > 1e-2
    if case == "tie":
        probs, _, idx = L._route(_port(p), torch.from_numpy(
            x.reshape(-1, x.shape[-1])), pcfg.num_experts_per_tok)
        # every token's two picks are a tied pair, the lower expert first
        assert (probs[:, 1] == probs[:, 2]).all()
        assert {tuple(r) for r in idx.tolist()} <= {(0, 3), (1, 2)}


@pytest.mark.parametrize("case", ["one_group", "drop", "tie"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_group_and_dense_match_reference(arch, case):
    """``_moe_group`` on (T, D) and the decode path ``moe_apply_dense``."""
    over, edit = CASES[case]
    jcfg, pcfg = _cfgs(arch, **over)
    p, x = _layer_inputs(jcfg, edit, seed=1)
    xt = x.reshape(-1, x.shape[-1])
    jy, jaux = _jit(JL._moe_group)(p, jnp.asarray(xt), jcfg)
    py, paux = L._moe_group(_port(p), torch.from_numpy(xt), pcfg)
    assert _maxdiff(py, jy) < TOL
    assert abs(float(paux) - float(jaux)) < AUX_TOL
    jd = _jit(JL.moe_apply_dense)(p, jnp.asarray(x), jcfg)
    pd = L.moe_apply_dense(_port(p), torch.from_numpy(x), pcfg)
    assert pd.shape == x.shape
    assert _maxdiff(pd, jd) < TOL


def test_all_tied_routes_take_the_lowest_experts():
    """On all-equal router columns every expert ties: lax.top_k's choice,
    experts 0 and 1 in that order, is what the port's stable sort takes
    (``torch.topk`` promises no order among ties)."""
    jcfg, pcfg = _cfgs("olmoe-1b-7b")
    p, x = _layer_inputs(jcfg, None)
    p["router"][:] = p["router"][:, :1]
    xt = x.reshape(-1, x.shape[-1])
    _, jidx = jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(xt) @ p["router"], axis=-1), 2)
    _, _, idx = L._route(_port(p), torch.from_numpy(xt), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert (idx == torch.tensor([[0, 1]])).all()


def _lm_world(arch, **over):
    jcfg, pcfg = _cfgs(arch, **over)
    jm, pm = jbuild_model(jcfg), build_model(pcfg)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    return jm, pm, jp, params_from_numpy(jp, device="cpu")


def _tokens(vocab, seed, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_gradient_match_reference(arch):
    """``loss`` (total, CE, aux) and its gradient by autograd, aux
    included, against ``jax.value_and_grad``, leaf for leaf in
    ``jax.tree.leaves`` order: the gradient within GRAD_RTOL of its
    largest entry; and the aux term alone carries a gradient into the
    router."""
    jm, pm, jp, pp = _lm_world(arch)
    toks = _tokens(jm.cfg.vocab_size, 1)
    tgt = _tokens(jm.cfg.vocab_size, 2)
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgt)}
    (jloss, jinfo), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb), has_aux=True))(jp)
    leaves = [t.requires_grad_(True) for t in jax.tree.leaves(
        pp, is_leaf=lambda x: isinstance(x, torch.Tensor))]
    ploss, pinfo = pm.loss(pp, {"tokens": torch.from_numpy(toks),
                                "targets": torch.from_numpy(tgt)})
    assert abs(float(ploss) - float(jloss)) < TOL
    assert abs(float(pinfo["ce"]) - float(jinfo["ce"])) < TOL
    assert float(pinfo["moe_aux"]) > 0
    assert abs(float(pinfo["moe_aux"]) - float(jinfo["moe_aux"])) < AUX_TOL
    assert float(ploss) == pytest.approx(float(pinfo["ce"])
                                         + float(pinfo["moe_aux"]))
    grads = torch.autograd.grad(ploss, leaves, retain_graph=True)
    jl = [np.asarray(g) for g in jax.tree.leaves(jg)]
    assert len(jl) == len(grads)
    top = max(float(np.abs(g).max()) for g in jl)
    for a, b in zip(grads, jl):
        assert a.shape == b.shape
        assert _maxdiff(a.detach(), b) <= GRAD_RTOL * top
    router = pp["units"][0]["moe"]["router"]
    (g_aux,) = torch.autograd.grad(pinfo["moe_aux"], router)
    assert float(g_aux.abs().max()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_prefill_decode_match_reference(arch):
    """``prefill`` and every ``decode_step`` (the every-expert path)
    against the reference's, and against the port's own ``forward``."""
    jm, pm, jp, pp = _lm_world(arch)
    toks = _tokens(jm.cfg.vocab_size, 3)
    with torch.no_grad():
        pl, _ = pm.forward(pp, torch.from_numpy(toks))
    n = 18
    jlg, jcache = jax.jit(jm.prefill, static_argnames="max_len")(
        jp, jnp.asarray(toks[:, :n]), max_len=S)
    plg, pcache = pm.prefill(pp, torch.from_numpy(toks[:, :n]), max_len=S)
    assert _maxdiff(plg, jlg) < TOL
    assert _maxdiff(plg, pl[:, n - 1]) < TOL
    jstep = jax.jit(jm.decode_step)
    for t in range(n, S):
        jlg, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t]))
        plg, pcache = pm.decode_step(pp, pcache, torch.from_numpy(toks[:, t]))
        assert _maxdiff(plg, jlg) < TOL
        assert _maxdiff(plg, pl[:, t]) < TOL


def _routes(monkeypatch, jm, pm, jp, pp, toks):
    """Both forwards, with every MoE call's expert sets (sorted) recorded
    (the reference's from inside its compiled scan, by a callback)."""
    jr, pr = [], []
    real_group, real_route = JL._moe_group, L._route

    def jgroup(p, xt, cfg):
        probs = jax.nn.softmax(xt.astype(jnp.float32) @ p["router"], -1)
        jax.debug.callback(lambda i: jr.append(np.sort(np.asarray(i), -1)),
                           jax.lax.top_k(probs, cfg.num_experts_per_tok)[1],
                           ordered=True)
        return real_group(p, xt, cfg)

    def proute(p, xt, k):
        out = real_route(p, xt, k)
        pr.append(np.sort(out[2].numpy(), -1))
        return out

    monkeypatch.setattr(JL, "_moe_group", jgroup)
    monkeypatch.setattr(L, "_route", proute)
    jl, _ = jm.forward(jp, jnp.asarray(toks))
    jax.effects_barrier()
    pl, _ = pm.forward(pp, torch.from_numpy(toks))
    monkeypatch.undo()
    return jl, pl, jr, pr


# bfloat16 MoE.  A token whose k-th and (k+1)-th router probabilities lie
# within bfloat16 rounding of each other picks another expert under any
# change of rounding, and its logits then move by O(1): the reference's
# compiled forward and the same forward op by op (``jax.disable_jit``)
# differ so (1.41 at most over three seeds measured, reduced
# olmoe-1b-7b).  So the port is held to the reference on the sequences
# where no MoE layer picked another expert set (reduced() never drops a
# token, so a flip reaches only its own sequence).  There the logits, up
# to about 4.2, lie 0.036 to 0.055 apart (the reference from itself 0.043
# to 0.047): one to two bfloat16 ulps in [2, 8).  The limit is the dense
# LM tests' measure, 8 ulps, of the largest logit here.
BF16_ULPS = 8


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_bf16_forward_matches_reference(arch, monkeypatch):
    jm, pm, jp, pp = _lm_world(arch, dtype="bfloat16",
                               param_dtype="bfloat16")
    assert pp["units"][0]["moe"]["wi"].dtype == torch.bfloat16
    assert pp["units"][0]["moe"]["router"].dtype == torch.float32
    toks = _tokens(jm.cfg.vocab_size, 3)
    jl, pl, jr, pr = _routes(monkeypatch, jm, pm, jp, pp, toks)
    assert pl.dtype == torch.bfloat16
    assert len(jr) == len(pr) == jm.cfg.num_layers
    flipped = np.zeros(B, bool)
    for a, b in zip(jr, pr):
        flipped |= (a != b).any(-1).reshape(B, S).any(-1)
    held = ~flipped
    assert held.any(), "every sequence picked another expert set"
    ref = np.asarray(jl, np.float32)[held]
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    assert _maxdiff(pl.float().numpy()[held], ref) <= BF16_ULPS * ulp


def test_launch_train_matches_reference():
    """launch.train on reduced olmoe-1b-7b, 2 workers (one group, G=2,
    I=1), 4 steps, no codec: the objective is CE + aux in both drivers."""
    argv = ["--arch", "olmoe-1b-7b", "--reduced", "--workers", "2",
            "--groups", "1", "--G", "2", "--I", "1", "--steps", "4",
            "--batch", "2", "--seq", "16", "--log-every", "1"]
    jm = jbuild_model(jreduced(jget_config("olmoe-1b-7b")))
    p0 = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    ref = run_ref(argv)
    port = run_port(argv, p0)
    assert [r["step"] for r in port["records"]] == [1, 2, 3, 4]
    assert [r["step"] for r in ref["records"]] == [1, 2, 3, 4]
    for p, r in zip(port["records"], ref["records"]):
        assert p["lvl"] == r["lvl"]
        assert rel(p["loss"], r["loss"]) <= RTOL, (p, r)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_and_count_match_reference(arch):
    """The port's own init builds the reference's tree, leaf for leaf, and
    the config's analytic count; build_model takes the full configs."""
    jm, pm = jbuild_model(_cfgs(arch)[0]), build_model(_cfgs(arch)[1])
    jshapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                           jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    pp = pm.init(torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        params_to_numpy(pp)) == jshapes
    n = sum(t.numel() for t in jax.tree.leaves(
        pp, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert n == pm.cfg.param_count()
    full = build_model(get_config(arch))
    assert full.cfg.num_experts == get_config(arch).num_experts


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_route_is_every_attention_layer(arch, monkeypatch):
    """Under use_kernels the attention wrapper is called once per layer in
    ``forward`` and ``prefill`` (mixtral's with its window) and never in
    ``decode_step``; on the CPU it runs its plain version, so the outputs
    are the plain route's."""
    _, pm, _, pp = _lm_world(arch)
    km = build_model(reduced(get_config(arch), use_kernels=True))
    real, calls = kattn.flash_attention, []

    def spy(q, k, v, *, causal=True, window=None):
        calls.append(window)
        return real(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(kattn, "flash_attention", spy)
    toks = torch.from_numpy(_tokens(km.cfg.vocab_size, 6))
    n = km.cfg.num_layers
    lk, _ = km.forward(pp, toks)
    assert calls == [km.cfg.sliding_window] * n
    assert torch.equal(lk, pm.forward(pp, toks)[0])
    _, cache = km.prefill(pp, toks[:, :8], max_len=S)
    km.decode_step(pp, cache, toks[:, 8])
    assert len(calls) == 2 * n
