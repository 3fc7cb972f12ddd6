"""The examples' twins (``repro_torch.examples``) against the JAX
package's ``examples/`` scripts, on the CPU.

The reference's scripts run as they are (``runpy``), and the twins get
the reference's draws as numpy: the params of its ``model.init(PRNGKey(0))``
and, for serving, its prompt.  Tolerance ``RTOL = 1e-5`` relative, as in
``tests/test_torch_experiments.py`` and ``tests/test_torch_population.py``:

* quickstart and multilevel: every printed loss and accuracy within RTOL
  (the full-precision values the scripts format), the steps and the sync
  levels equal;
* population: every round's step and clients-seen count equal (the draws
  are host numpy in both packages), the train loss within RTOL;
* serve_decode: mamba2-130m's greedy tokens equal to the reference's with
  its params and prompt carried in; the other three archs by their
  arguments only (arch list, prompt shape, ``gen_len``, frame count,
  AST-parsed from the script), since ``generate`` for those families is
  held in ``tests/test_torch_lm.py`` and ``tests/test_torch_encdec.py``;
* train_hsgd: its argv equals the script's, token for token.  The
  batches come from the port's own token stream (the reference draws its
  stream from JAX's PRNG), so there is no trajectory parity here.
"""
import ast
import builtins
import contextlib
import io
import runpy
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch.examples import (multilevel_hsgd, population_hsgd,  # noqa: E402
                                  quickstart, serve_decode, train_hsgd)

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these small runs only lose to the other test
    processes' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(name, **init_globals):
    """Run ``examples/<name>.py`` as it is, its printing captured; its
    module globals."""
    with contextlib.redirect_stdout(io.StringIO()):
        return runpy.run_path(str(EXAMPLES / f"{name}.py"),
                              init_globals=init_globals,
                              run_name="__main__")


def _p0(model):
    return jax.device_get(model.init(jax.random.PRNGKey(0)))


def _close(got, want):
    return abs(got - want) <= RTOL * abs(want)


def test_quickstart_matches_reference():
    ref = _reference("quickstart")
    want = [r for r in ref["history"] if "acc" in r]
    got = quickstart.main("cpu", init_params=_p0(ref["model"]))
    assert [g["step"] for g in got] == [w["t"] for w in want] \
        == [16, 32, 48, 64, 80, 96]
    assert [g["level"] for g in got] == [
        ref["engine"].topology.event_at(w["t"] - 1).level for w in want]
    for g, w in zip(got, want):
        assert _close(g["loss"], w["loss"]), (g, w)
        assert _close(g["acc"], w["acc"]), (g, w)


def test_multilevel_matches_reference():
    """The script prints ``float(model.loss(...))`` formatted; a stand-in
    for ``float`` in its globals records the full-precision values."""
    seen = []

    def recording_float(x):
        seen.append(builtins.float(x))
        return seen[-1]

    ref = _reference("multilevel_hsgd", float=recording_float)
    got = multilevel_hsgd.main("cpu", init_params=_p0(ref["model"]))
    assert len(seen) == len(got) == 4
    for g, w in zip(got, seen):
        assert _close(g["loss"], w), (g, w)
    # the four runs are the script's, in its order
    calls = [node.args[0].value for node in ast.walk(ast.parse(
        (EXAMPLES / "multilevel_hsgd.py").read_text()))
        if isinstance(node, ast.Call) and getattr(node.func, "id", "")
        == "run"]
    assert [g["run"] for g in got] == calls
    # and they keep the figure's ordering: best < 3-level, 2-level < worst
    best, three, two, worst = (g["loss"] for g in got)
    assert best < min(three, two) and max(three, two) < worst


def test_population_matches_reference():
    ref = _reference("population_hsgd")
    got = population_hsgd.main("cpu", init_params=_p0(ref["model"]))
    want = ref["history"]
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert (g["round"], g["t"]) == (w["round"], w["t"])
        assert g["unique"] == w["participation"]["unique"]
        assert g["population"] == w["participation"]["population"] \
            == 1_000_000
        assert _close(g["ce"], w["ce"]), (g, w)


def _serve_args():
    """The reference script's arch list, prompt shape, ``gen_len`` and
    frame count, from its source."""
    tree = ast.parse((EXAMPLES / "serve_decode.py").read_text())
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.For):
            out["archs"] = ast.literal_eval(node.iter)
        elif isinstance(node, ast.Call):
            name = getattr(node.func, "attr", getattr(node.func, "id", ""))
            if name == "randint":
                out["prompt"] = ast.literal_eval(node.args[1])
            elif name == "generate":
                out["gen_len"] = ast.literal_eval(node.args[1])
            elif name == "synth_audio_frames":
                out["frames"] = tuple(ast.literal_eval(a)
                                      for a in node.args[2:])
    return out


def test_serve_decode_arguments_equal_the_script():
    args = _serve_args()
    assert args == {"archs": serve_decode.ARCHS,
                    "prompt": serve_decode.PROMPT,
                    "gen_len": serve_decode.GEN_LEN,
                    "frames": (serve_decode.PROMPT[0], serve_decode.FRAMES)}


def test_serve_decode_mamba2_tokens_equal_the_reference():
    from repro.configs import get_config, reduced
    from repro.models import build_model
    from repro.serving import DecodeEngine

    arch = "mamba2-130m"
    cfg = reduced(get_config(arch))
    model = build_model(cfg)
    key = jax.random.PRNGKey(0)
    params = model.init(key)
    prompt = jax.random.randint(key, serve_decode.PROMPT, 0, cfg.vocab_size)
    want = DecodeEngine(model, params, temperature=0.0).generate(
        prompt, serve_decode.GEN_LEN).tokens
    got = serve_decode.main("cpu", params={arch: jax.device_get(params)},
                            prompts={arch: np.asarray(prompt)},
                            archs=(arch,))
    assert np.array_equal(np.asarray(got[arch]), np.asarray(want))


def test_serve_decode_runs_every_cache_type_from_its_own_draws():
    got = serve_decode.main("cpu")
    assert list(got) == list(serve_decode.ARCHS)
    for arch, tokens in got.items():
        tokens = np.asarray(tokens)
        assert tokens.shape == (serve_decode.PROMPT[0],
                                serve_decode.GEN_LEN), arch
        assert tokens.min() >= 0 and tokens.max() < 512, arch


def _train_argv():
    tree = ast.parse((EXAMPLES / "train_hsgd.py").read_text())
    call = next(node for node in ast.walk(tree)
                if isinstance(node, ast.Call)
                and getattr(node.func, "id", "") == "main")
    return ast.literal_eval(call.args[0])


def test_train_hsgd_argv_equals_the_script():
    assert list(train_hsgd.ARGV) == _train_argv()
    assert train_hsgd.argv() == _train_argv()
    moved = train_hsgd.argv({"--ckpt-dir": "a", "--out": "b"})
    want = _train_argv()
    want[want.index("--ckpt-dir") + 1] = "a"
    want[want.index("--out") + 1] = "b"
    assert moved == want
    with pytest.raises(ValueError, match="only"):
        train_hsgd.argv({"--steps": "4"})


def test_train_hsgd_writes_to_a_fresh_temp_dir(monkeypatch, tmp_path):
    """Unless the caller names them, ``--ckpt-dir`` and ``--out`` go to a
    fresh temporary directory per run (the reference's fixed ``/tmp``
    paths would let one run resume from another's checkpoints); named
    paths are kept and no directory is made.  The training itself is
    stubbed: only the argv it gets is read."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    seen = []
    monkeypatch.setattr(train_hsgd.train, "main",
                        lambda argv, device: seen.append(argv) or [])
    train_hsgd.main("cpu")
    train_hsgd.main("cpu", {"--out": "b"})
    train_hsgd.main("cpu", {"--ckpt-dir": "a", "--out": "b"})
    path = lambda argv, flag: argv[argv.index(flag) + 1]  # noqa: E731
    dirs = sorted(p for p in tmp_path.iterdir())
    assert len(dirs) == 2
    first, second, named = seen
    assert Path(path(first, "--ckpt-dir")).parent == Path(
        path(first, "--out")).parent
    assert {Path(path(first, "--ckpt-dir")).parent,
            Path(path(second, "--ckpt-dir")).parent} == set(dirs)
    assert path(second, "--out") == "b"
    assert named == train_hsgd.argv({"--ckpt-dir": "a", "--out": "b"})
    for argv in seen:
        rest = [t for i, t in enumerate(argv)
                if i == 0 or argv[i - 1] not in train_hsgd.PATH_FLAGS]
        assert rest == [t for i, t in enumerate(train_hsgd.ARGV)
                        if i == 0 or train_hsgd.ARGV[i - 1]
                        not in train_hsgd.PATH_FLAGS]
