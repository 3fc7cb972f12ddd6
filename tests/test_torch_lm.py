"""The port's LM serving path against the JAX package's, on the CPU.

Reduced qwen2-0.5b, gemma3-12b (local + global layers, window 16),
phi3-mini-3.8b (Hq == Hk), mamba2-130m (SSD, chunk 8) and
recurrentgemma-2b (RG-LRU + local attention: one unit, and with 5 layers
one unit plus a 2-block remainder like the full model) in float32, with
the reference's params carried over through ``params_from_numpy`` (norm
scales, biases and the SSD's A_log, D and dt_bias nudged off their init
so they are exercised).  Logits must agree to 1e-4 absolute, the
reference's own limit between prefill/decode and forward
(``tests/test_models.py``); the frameworks order the sums of a matrix
product differently, so agreement is to a tolerance, not bitwise.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.serving import DecodeEngine as JEngine  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import attention as kattn  # noqa: E402
from repro_torch.kernels import rglru_scan as krg  # noqa: E402
from repro_torch.kernels import ssd_scan as kssd  # noqa: E402
from repro_torch.models import (build_model, params_from_numpy,  # noqa: E402
                                params_to_numpy)
from repro_torch.serving import DecodeEngine  # noqa: E402

TOL = 1e-4
# "arch:n" is the reduced arch with n layers
ARCHS = ("qwen2-0.5b", "gemma3-12b", "phi3-mini-3.8b", "mamba2-130m",
         "recurrentgemma-2b", "recurrentgemma-2b:5")
B, S = 2, 24
# params nudged off their init: norm scales and biases, the attention
# biases, the SSD's A_log (0), D (1) and dt_bias (0) and the conv bias (0)
NUDGED = ("scale", "bias", "bq", "bk", "bv", "A_log", "D", "dt_bias", "b")


def _models(arch, **over):
    arch, _, layers = arch.partition(":")
    if layers:
        over["num_layers"] = int(layers)
    jcfg = jreduced(jget_config(arch), **over)
    pover = dict(over)
    if "use_pallas" in pover:
        pover["use_kernels"] = pover.pop("use_pallas")
    pcfg = reduced(get_config(arch), **pover)
    return jbuild_model(jcfg), build_model(pcfg)


def _params(jm, seed=0):
    """The reference's params as numpy, with norm scales and biases
    nudged by seeded noise."""
    p = jax.device_get(jm.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def nudge(path, a):
        if path[-1].key in NUDGED:
            noise = rng.normal(size=a.shape).astype(np.float32) * 0.05
            return (a.astype(np.float32) + noise).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(nudge, p)


def _tokens(vocab, seed=1, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _maxdiff(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


@pytest.fixture(scope="module", params=ARCHS)
def world(request):
    jm, pm = _models(request.param)
    jp = _params(jm)
    return jm, pm, jp, params_from_numpy(jp, device="cpu")


def test_forward_and_loss_match_reference(world):
    jm, pm, jp, pp = world
    toks = _tokens(jm.cfg.vocab_size)
    tgt = _tokens(jm.cfg.vocab_size, seed=2)
    jl, _ = jm.forward(jp, jnp.asarray(toks))
    pl, paux = pm.forward(pp, torch.from_numpy(toks))
    assert pl.shape == (B, S, jm.cfg.vocab_size) and float(paux) == 0.0
    assert _maxdiff(pl, jl) < TOL
    batch = {"tokens": toks, "targets": tgt}
    jloss, jaux = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    ploss, paux = pm.loss(pp, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    assert abs(float(ploss) - float(jloss)) < TOL
    assert abs(float(paux["ce"]) - float(jaux["ce"])) < TOL


@pytest.mark.parametrize("prompt_len", [9, 16, 20])
def test_prefill_and_decode_match_reference(world, prompt_len):
    """Prompts shorter than, equal to and longer than gemma3's window (16):
    the port's prefill and every decode step against the reference's and
    against the port's own forward."""
    jm, pm, jp, pp = world
    toks = _tokens(jm.cfg.vocab_size, seed=prompt_len)
    full, _ = pm.forward(pp, torch.from_numpy(toks))
    jlg, jcache = jax.jit(jm.prefill, static_argnames="max_len")(
        jp, jnp.asarray(toks[:, :prompt_len]), max_len=S)
    plg, pcache = pm.prefill(pp, torch.from_numpy(toks[:, :prompt_len]),
                             max_len=S)
    assert pcache["pos"] == prompt_len
    errs = [_maxdiff(plg, jlg), _maxdiff(plg, full[:, prompt_len - 1])]
    step = jax.jit(jm.decode_step)
    for t in range(prompt_len, S):
        jlg, jcache = step(jp, jcache, jnp.asarray(toks[:, t]))
        plg, pcache = pm.decode_step(pp, pcache, torch.from_numpy(toks[:, t]))
        errs += [_maxdiff(plg, jlg), _maxdiff(plg, full[:, t])]
    assert max(errs) < TOL, errs
    # the caches hold what the reference's hold (local: the ring buffer)
    jleaves = jax.tree.leaves(jcache["units"])
    pleaves = [t.numpy() for t in jax.tree.leaves(pcache["units"])]
    assert [a.shape for a in pleaves] == [a.shape for a in jleaves]
    for a, b in zip(pleaves, jleaves):
        assert _maxdiff(a, b) < TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_route_matches_reference_pallas(arch):
    """use_kernels=True (the CPU runs the kernel's plain version) against
    the reference's use_pallas=True (Pallas in interpret mode), forward and
    prefill; then the port's kernel-route prefill and decode against its
    own forward."""
    jm, pm = _models(arch, use_pallas=True)
    assert pm.cfg.use_kernels and jm.cfg.use_pallas
    jp = _params(jm)
    pp = params_from_numpy(jp, device="cpu")
    toks = _tokens(jm.cfg.vocab_size, seed=3)
    jl, _ = jm.forward(jp, jnp.asarray(toks))
    for counter in (kattn, kssd, krg):
        counter.reset_launch_counts()
    pl, _ = pm.forward(pp, torch.from_numpy(toks))
    assert _maxdiff(pl, jl) < TOL
    jlg, _ = jm.prefill(jp, jnp.asarray(toks[:, :20]), max_len=S)
    plg, cache = pm.prefill(pp, torch.from_numpy(toks[:, :20]), max_len=S)
    assert _maxdiff(plg, jlg) < TOL
    for t in range(20, S):
        plg, cache = pm.decode_step(pp, cache, torch.from_numpy(toks[:, t]))
        assert _maxdiff(plg, pl[:, t]) < TOL
    # the CPU runs the plain versions: no launch
    assert kattn.launch_counts == {"flash_attention": 0}
    assert kssd.launch_counts == {"ssd_scan": 0}
    assert krg.launch_counts == {"rglru_scan": 0}


def test_engine_matches_reference(world):
    jm, pm, jp, pp = world
    prompt = _tokens(jm.cfg.vocab_size, seed=4, shape=(B, 11))
    jres = JEngine(jm, jp).generate(jnp.asarray(prompt), 9)
    pres = DecodeEngine(pm, pp, device="cpu").generate(prompt, 9)
    np.testing.assert_array_equal(pres.tokens, jres.tokens)
    assert pres.steps == jres.steps == 9
    assert _maxdiff(pres.logprobs, jres.logprobs) < TOL
    cont = _tokens(jm.cfg.vocab_size, seed=5, shape=(B, 7))
    jscore = JEngine(jm, jp).score_continuation(jnp.asarray(prompt),
                                                jnp.asarray(cont))
    pscore = DecodeEngine(pm, pp, device="cpu").score_continuation(
        torch.from_numpy(prompt), torch.from_numpy(cont))
    assert pscore.shape == (B,) and pscore.dtype == np.float64
    assert np.abs(pscore - jscore).max() < TOL


def test_engine_greedy_matches_forward_argmax():
    """The reference's own check (tests/test_serving.py) on the port."""
    _, pm = _models("qwen2-0.5b")
    params = pm.init(torch.Generator().manual_seed(0), device="cpu")
    prompt = _tokens(pm.cfg.vocab_size, seed=6, shape=(2, 6))
    res = DecodeEngine(pm, params, device="cpu").generate(prompt, 4)
    seq = prompt.astype(np.int64)
    for t in range(4):
        logits, _ = pm.forward(params, torch.from_numpy(seq))
        nxt = logits[:, -1].argmax(-1).numpy()
        np.testing.assert_array_equal(res.tokens[:, t], nxt)
        seq = np.concatenate([seq, nxt[:, None]], axis=1)


def test_engine_samples_with_temperature():
    _, pm = _models("gemma3-12b")
    params = pm.init(torch.Generator().manual_seed(0), device="cpu")
    eng = DecodeEngine(pm, params, temperature=1.0, device="cpu")
    prompt = _tokens(pm.cfg.vocab_size, seed=7, shape=(2, 5))
    a = eng.generate(prompt, 6, generator=torch.Generator().manual_seed(3))
    b = eng.generate(prompt, 6, generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert np.isfinite(a.logprobs).all() and (a.logprobs <= 0).all()


# bfloat16: both packages round activations to bfloat16 after every op,
# but at other places inside a fused op (XLA fuses on the CPU, PyTorch
# does not), and each rounding difference carries through both layers.
# Measured on the CPU, reduced qwen2-0.5b, three seeds: 1.0e-2 to 1.2e-2
# over logits up to 0.93, about 3 bfloat16 ulps (3.9e-3 in [0.5, 1)).
# The limit, 3e-2, is about 8 ulps.
BF16_TOL = 3e-2


def test_bf16_forward_matches_reference():
    over = dict(dtype="bfloat16", param_dtype="bfloat16")
    jm, pm = _models("qwen2-0.5b", **over)
    jp = _params(jm)
    pp = params_from_numpy(jp, device="cpu")
    assert pp["embed"].dtype == torch.bfloat16
    toks = _tokens(jm.cfg.vocab_size, seed=8)
    jl, _ = jm.forward(jp, jnp.asarray(toks))
    pl, _ = pm.forward(pp, torch.from_numpy(toks))
    assert pl.dtype == torch.bfloat16
    assert _maxdiff(pl.float(), np.asarray(jl, np.float32)) < BF16_TOL


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b"])
def test_bf16_ssm_forward_matches_reference(arch):
    """The SSD and RG-LRU families in bfloat16, forward and the kernel
    route (the plain versions on the CPU), against the reference at
    BF16_TOL."""
    over = dict(dtype="bfloat16", param_dtype="bfloat16")
    toks = None
    for kernels in (False, True):
        jm, pm = _models(arch, use_pallas=kernels, **over)
        jp = _params(jm)
        pp = params_from_numpy(jp, device="cpu")
        toks = _tokens(jm.cfg.vocab_size, seed=8) if toks is None else toks
        jl, _ = jm.forward(jp, jnp.asarray(toks))
        pl, _ = pm.forward(pp, torch.from_numpy(toks))
        assert pl.dtype == torch.bfloat16
        assert _maxdiff(pl.float(), np.asarray(jl, np.float32)) < BF16_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_roundtrip_bitwise(dtype):
    jm, _ = _models("gemma3-12b", dtype=dtype, param_dtype=dtype)
    jp = _params(jm)
    back = params_to_numpy(params_from_numpy(jp, device="cpu"))
    jl, jdef = jax.tree.flatten(jp)
    pl, pdef = jax.tree.flatten(back)
    assert pdef == jdef
    for a, b in zip(pl, jl):
        assert a.shape == b.shape
        if b.dtype == ml_dtypes.bfloat16:
            assert a.dtype == np.uint16
            np.testing.assert_array_equal(a, b.view(np.uint16))
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_param_tree_and_count_match_reference():
    """The port's own init builds the reference's tree, leaf for leaf, and
    the config's analytic count."""
    for arch in ARCHS:
        jm, pm = _models(arch)
        jshapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                               jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
        pp = pm.init(torch.Generator().manual_seed(0), device="cpu")
        pshapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                               params_to_numpy(pp))
        assert pshapes == jshapes, arch
        n = sum(t.numel() for t in jax.tree.leaves(
            pp, is_leaf=lambda x: isinstance(x, torch.Tensor)))
        # the reference's analytic count leaves out each SSD layer's conv
        # bias (configs/base.py counts the conv's weights only); the port's
        # config is a copy and keeps that
        cfg = pm.cfg
        conv_bias = sum(cfg.ssm_expand * cfg.d_model + 2 * cfg.ssm_state
                        for kind in cfg.layer_kinds if kind == "ssd")
        assert n == cfg.param_count() + conv_bias, arch


def test_serve_launcher_on_cpu(capsys):
    from repro_torch.launch.serve import main
    res = main(["--arch", "qwen2-0.5b", "--reduced", "--batch", "2",
                "--prompt-len", "10", "--gen", "5"], device="cpu")
    assert res.tokens.shape == (2, 5) and np.isfinite(res.logprobs).all()
    assert "tok/s" in capsys.readouterr().out
    # --ckpt-dir restores (tests/test_torch_checkpoint.py); a directory
    # without a checkpoint fails as the reference's restore does
    with pytest.raises(AssertionError, match="no checkpoints"):
        main(["--arch", "qwen2-0.5b", "--reduced", "--ckpt-dir", "x"],
             device="cpu")
    res = main(["--reduced", "--batch", "2", "--gen", "3"],
               device="cpu")                   # the default mamba2-130m
    assert res.tokens.shape == (2, 3) and np.isfinite(res.logprobs).all()
    assert "arch=mamba2-130m-smoke" in capsys.readouterr().out


def test_engine_refuses_params_elsewhere():
    _, pm = _models("qwen2-0.5b")
    params = pm.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="params are on"):
        DecodeEngine(pm, params, device="meta")
