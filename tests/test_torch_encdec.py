"""The port's encoder-decoder backbone (``repro_torch.models.encdec``) and
its frontend stub against the JAX package's, on the CPU.

Reduced seamless-m4t-large-v2 (2 encoder and 2 decoder layers, d_model
128, 4 heads, layernorm, gelu), float32, with the reference's params
carried over through ``params_from_numpy`` (norm scales and biases nudged
off their init so they are exercised) and the same numpy frames given to
both packages (the reference's ``jax.random`` draw is not reproduced):

* ``encode``, ``forward``, ``loss``, ``prefill`` and every ``decode_step``
  within TOL; ``DecodeEngine.generate`` with ``enc_inputs``: the
  reference engine's tokens, and ``score_continuation`` within TOL;
* the param tree (``enc_units`` and ``dec_units`` one dict each, stacked
  over layers), its count against the config's, ``params_to_numpy`` of
  ``params_from_numpy`` bit for bit, and a checkpoint written by the port
  read back by both packages;
* ``launch.serve --arch seamless-m4t-large-v2 --reduced`` (and from a
  checkpoint), the frontend's specs, and ``launch.train``'s refusal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.checkpoint import restore as jrestore  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.configs.base import INPUT_SHAPES  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import frontends as jfrontends  # noqa: E402
from repro.serving import DecodeEngine as JEngine  # noqa: E402

from repro_torch.checkpoint import restore, save  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import attention as kattn  # noqa: E402
from repro_torch.models import (EncDecLM, build_model,  # noqa: E402
                                params_from_numpy, params_to_numpy)
from repro_torch.models import frontends  # noqa: E402
from repro_torch.serving import DecodeEngine  # noqa: E402

ARCH = "seamless-m4t-large-v2"
TOL = 1e-5
B, S, F = 2, 16, 6           # batch, tokens, encoder frames
NUDGED = ("scale", "bias")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these small runs only lose to the other test
    processes' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nudged(p, seed=0):
    rng = np.random.default_rng(seed)

    def nudge(path, a):
        if path[-1].key in NUDGED:
            noise = rng.normal(size=a.shape).astype(np.float32) * 0.05
            return (a.astype(np.float32) + noise).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(nudge, p)


@pytest.fixture(scope="module")
def world():
    jm = jbuild_model(jreduced(jget_config(ARCH)))
    pm = build_model(reduced(get_config(ARCH)))
    jp = _nudged(jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0))))
    return jm, pm, jp, params_from_numpy(jp, device="cpu")


def _tokens(vocab, seed, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _frames(d, seed=7, frames=F):
    return np.random.default_rng(seed).normal(
        size=(B, frames, d)).astype(np.float32)


def _maxdiff(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


def test_encode_forward_loss_match_reference(world):
    jm, pm, jp, pp = world
    assert isinstance(pm, EncDecLM)
    toks, tgt = _tokens(jm.cfg.vocab_size, 1), _tokens(jm.cfg.vocab_size, 2)
    frames = _frames(jm.cfg.d_model)
    jmem = jax.jit(jm.encode)(jp, jnp.asarray(frames))
    pmem = pm.encode(pp, torch.from_numpy(frames))
    assert pmem.shape == (B, F, jm.cfg.d_model)
    assert _maxdiff(pmem, jmem) < TOL
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgt),
          "enc_inputs": jnp.asarray(frames)}
    (jlogits, _), (jloss, jinfo) = jax.jit(
        lambda p: (jm.forward(p, jb["tokens"], jb["enc_inputs"]),
                   jm.loss(p, jb)))(jp)
    plogits, paux = pm.forward(pp, torch.from_numpy(toks),
                               torch.from_numpy(frames))
    assert plogits.shape == (B, S, jm.cfg.vocab_size) and float(paux) == 0
    assert _maxdiff(plogits, jlogits) < TOL
    ploss, pinfo = pm.loss(pp, {k: torch.from_numpy(np.asarray(v))
                                for k, v in jb.items()})
    assert abs(float(ploss) - float(jloss)) < TOL
    assert abs(float(pinfo["ce"]) - float(jinfo["ce"])) < TOL
    assert float(pinfo["moe_aux"]) == 0.0 and float(ploss) == float(
        pinfo["ce"])


def test_prefill_and_decode_match_reference(world):
    """The cache carries each layer's cross-attention k/v (n, B, F, Hk, Dh)
    from the prefill; every decode step against the reference's and the
    port's own forward."""
    jm, pm, jp, pp = world
    toks = _tokens(jm.cfg.vocab_size, 3)
    frames = _frames(jm.cfg.d_model, seed=8)
    n = 10
    full, _ = pm.forward(pp, torch.from_numpy(toks), torch.from_numpy(frames))
    jlg, jcache = jax.jit(jm.prefill, static_argnames="max_len")(
        jp, jnp.asarray(toks[:, :n]), max_len=S,
        enc_inputs=jnp.asarray(frames))
    plg, pcache = pm.prefill(pp, torch.from_numpy(toks[:, :n]), max_len=S,
                             enc_inputs=torch.from_numpy(frames))
    assert pcache["pos"] == n
    assert _maxdiff(plg, jlg) < TOL
    for key in ("k", "v", "xk", "xv"):
        assert tuple(pcache["units"][key].shape) == jcache["units"][key].shape
        assert _maxdiff(pcache["units"][key], jcache["units"][key]) < TOL
    jstep = jax.jit(jm.decode_step)
    for t in range(n, S):
        jlg, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t]))
        plg, pcache = pm.decode_step(pp, pcache, torch.from_numpy(toks[:, t]))
        assert _maxdiff(plg, jlg) < TOL
        assert _maxdiff(plg, full[:, t]) < TOL
    empty = pm.init_cache(B, S, device="cpu")
    jempty = jm.init_cache(B, S)
    assert jax.tree.map(lambda a: tuple(a.shape), params_to_numpy(
        {"embed": torch.zeros(()), **empty["units"]})) == {
        "embed": (), **jax.tree.map(lambda a: a.shape, jempty["units"])}


def test_engine_matches_reference(world):
    jm, pm, jp, pp = world
    prompt = _tokens(jm.cfg.vocab_size, 4, shape=(B, 9))
    frames = _frames(jm.cfg.d_model, seed=9, frames=3)
    jres = JEngine(jm, jp).generate(jnp.asarray(prompt), 7,
                                    enc_inputs=jnp.asarray(frames))
    eng = DecodeEngine(pm, pp, device="cpu")
    kattn.reset_launch_counts()
    pres = eng.generate(prompt, 7, enc_inputs=frames)
    np.testing.assert_array_equal(pres.tokens, jres.tokens)
    assert _maxdiff(pres.logprobs, jres.logprobs) < TOL
    assert kattn.launch_counts == {"flash_attention": 0}
    cont = _tokens(jm.cfg.vocab_size, 5, shape=(B, 5))
    jscore = JEngine(jm, jp).score_continuation(
        jnp.asarray(prompt), jnp.asarray(cont), enc_inputs=jnp.asarray(frames))
    pscore = eng.score_continuation(prompt, cont,
                                    enc_inputs=torch.from_numpy(frames))
    assert np.abs(pscore - jscore).max() < TOL


def test_param_tree_count_and_roundtrip(world, tmp_path):
    jm, pm, jp, pp = world
    jshapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                           jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    own = pm.init(torch.Generator().manual_seed(0), device="cpu")
    assert sorted(own) == ["dec_units", "embed", "enc_norm", "enc_units",
                           "final_norm", "lm_head"]
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        params_to_numpy(own)) == jshapes
    n = sum(t.numel() for t in jax.tree.leaves(
        own, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    # the reference's analytic count leaves out every layernorm's bias and
    # the encoder's final norm (configs/base.py); the port's config is a
    # copy and keeps that
    cfg = pm.cfg
    norms = 3 * cfg.num_layers + 2 * cfg.num_encoder_layers + 1
    assert n == cfg.param_count() + (norms + 2) * cfg.d_model
    # bit for bit both ways, float32 and bfloat16 leaves
    for tree in (jp, jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16),
                                  jp)):
        back = params_to_numpy(params_from_numpy(tree, device="cpu"))
        jl, jdef = jax.tree.flatten(tree)
        pl, pdef = jax.tree.flatten(back)
        assert pdef == jdef
        for a, b in zip(pl, jl):
            if b.dtype == ml_dtypes.bfloat16:
                np.testing.assert_array_equal(a, b.view(np.uint16))
            else:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    # a checkpoint of the tree: the port reads it back, so does the
    # reference, bit for bit
    save(str(tmp_path), 3, {"params": pp})
    step, tree = restore(str(tmp_path), {"params": own})
    assert step == 3
    for a, b in zip(jax.tree.leaves(params_to_numpy(tree["params"])),
                    jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, b)
    jstep, jtree = jrestore(str(tmp_path), {"params": jp})
    assert jstep == 3
    for a, b in zip(jax.tree.leaves(jtree["params"]), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_serve_launcher_on_cpu(capsys, tmp_path):
    from repro_torch.launch.serve import main
    argv = ["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len",
            "12", "--gen", "4"]
    res = main(argv, device="cpu")
    assert res.tokens.shape == (2, 4) and np.isfinite(res.logprobs).all()
    assert f"arch={ARCH}-smoke" in capsys.readouterr().out
    # from a checkpoint of other params: other tokens, the same as in memory
    pm = build_model(reduced(get_config(ARCH)))
    params = pm.init(torch.Generator().manual_seed(5), device="cpu")
    save(str(tmp_path), 1, {"params": params})
    res_ckpt = main(argv + ["--ckpt-dir", str(tmp_path)], device="cpu")
    gen = torch.Generator().manual_seed(0)
    pm.init(gen, device="cpu")                 # the launcher's draws
    prompt = torch.randint(0, pm.cfg.vocab_size, (2, 12), generator=gen)
    frames = frontends.synth_audio_frames(gen, pm.cfg, 2, 12 // 4)
    want = DecodeEngine(pm, params, device="cpu").generate(
        prompt, 4, generator=gen, enc_inputs=frames)
    np.testing.assert_array_equal(res_ckpt.tokens, want.tokens)


def test_frontend_stub():
    cfg = get_config(ARCH)
    for shape in INPUT_SHAPES.values():
        want = jfrontends.audio_frame_specs(jget_config(ARCH), shape)
        got_shape, got_dtype = frontends.audio_frame_specs(cfg, shape)
        assert got_shape == want.shape
        assert str(got_dtype).split(".")[-1] == str(want.dtype)
    small = reduced(cfg)
    a = frontends.synth_audio_frames(torch.Generator().manual_seed(1),
                                     small, 3, 5)
    b = frontends.synth_audio_frames(torch.Generator().manual_seed(1),
                                     small, 3, 5)
    assert a.shape == (3, 5, small.d_model) and a.dtype == torch.float32
    assert torch.equal(a, b)


def test_launch_train_refuses_encdec():
    """The token stream has no encoder frames: the reference's driver
    fails on the missing ``enc_inputs``, the port's says so up front."""
    from repro_torch.launch.train import main
    with pytest.raises(ValueError, match="encoder-decoder.*enc_inputs"):
        main(["--arch", ARCH, "--reduced", "--steps", "2"], device="cpu")


def test_kernel_route_is_the_decoder_self_attention(world, monkeypatch):
    """Under use_kernels the attention wrapper is called once per decoder
    layer in ``forward``, ``loss`` and ``prefill`` (causal self-attention,
    the reference's rule) and never by the encoder, the cross-attention or
    ``decode_step``; on the CPU it runs its plain version, so the outputs
    are the plain route's."""
    jm, pm, jp, pp = world
    km = build_model(reduced(get_config(ARCH), use_kernels=True))
    real, calls = kattn.flash_attention, []

    def spy(q, k, v, *, causal=True, window=None):
        calls.append((tuple(q.shape), causal, window))
        return real(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(kattn, "flash_attention", spy)
    toks = torch.from_numpy(_tokens(jm.cfg.vocab_size, 6))
    frames = torch.from_numpy(_frames(jm.cfg.d_model, seed=10))
    n = km.cfg.num_layers
    lk, _ = km.forward(pp, toks, frames)
    assert len(calls) == n and {c[1:] for c in calls} == {(True, None)}
    assert torch.equal(lk, pm.forward(pp, toks, frames)[0])
    km.loss(pp, {"tokens": toks, "targets": toks, "enc_inputs": frames})
    assert len(calls) == 2 * n
    _, cache = km.prefill(pp, toks[:, :8], max_len=S, enc_inputs=frames)
    assert len(calls) == 3 * n
    km.decode_step(pp, cache, toks[:, 8])
    assert len(calls) == 3 * n
