"""The port's H-SGD training path against the JAX package's, on the CPU.

* ``repro_torch.tree`` takes an LM's params: tuples are nodes (children
  in index order), ``None`` a node with no leaves, leaves in
  ``jax.tree.leaves``'s order for every reduced LM family, so
  ``HSGD.init_from_params`` takes ``DecoderLM`` params.
* Engine and launch.train parity with codecs off on reduced qwen2-0.5b: the
  reference's launch.train (``repro.launch.train.main``) runs once for the module
  (uniform (2, 2), G=4, I=2, momentum, cosine(3e-3, 16, warmup 1), batch 4,
  seq 32, 16 steps, checkpoints and divergences every 8); the port's
  ``HSGD.run_rounds`` and its launch.train start from the reference's params and
  take the reference's ``TokenStream`` batches (the JAX PRNG is not
  re-implemented).  CE within RTOL relative, params within ATOL, the
  divergences within RTOL of the largest, ``lvl`` exact, the header's
  ``config`` equal but for ``jit``.
* Resume: the port resumes from the reference's own step-8 checkpoint and
  lands on its records and step-16 params; the port's own resume is bit
  for bit its uninterrupted run (the reference's launch.train smoke,
  ``tests/test_system.py:80``, mirrored).
* ``ap.error`` cases give the reference's messages; ``--audit`` prints
  a clean audit of the sync plan (the analysis layer is
  ``tests/test_torch_audit.py``'s).

``tests/test_torch_train_codecs.py`` holds int8 and sign,
``tests/test_torch_train_paths.py`` the runtime, probes, population and
mesh paths.
"""
import contextlib
import io
import json
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402

from repro_torch.checkpoint import restore  # noqa: E402
from repro_torch.comms import FlatBucket  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import (EngineConfig, HSGD, HierarchySpec,  # noqa: E402
                              make_topology)
from repro_torch.launch import train as ptrain  # noqa: E402
from repro_torch.models import build_model, params_from_numpy  # noqa: E402
from repro_torch.optim import cosine, momentum, sgd  # noqa: E402
from repro_torch.tree import TreeDef, tree_flatten, tree_leaves  # noqa: E402

RTOL = 1e-5          # CE and divergences, relative
ATOL = 1e-5          # params, absolute
ARCH = "qwen2-0.5b"
BASE = ["--arch", ARCH, "--reduced", "--workers", "4", "--groups", "2",
        "--G", "4", "--I", "2", "--batch", "4", "--seq", "32",
        "--optimizer", "momentum", "--log-every", "1"]
STEPS = 16


# ---------------------------------------------------------------------------
# helpers, also imported by tests/test_torch_train_codecs.py and
# tests/test_torch_train_paths.py
# ---------------------------------------------------------------------------
@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's runs here: these small runs only
    lose to the other test processes' threads, and the CPU's
    multithreaded index backward (the embedding's) accumulates in an
    order that can change from run to run, which the bit-for-bit resume
    check would see."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_params(seed=0):
    """The reference's launch.train initial params, as numpy."""
    jm = jbuild_model(jreduced(jget_config(ARCH)))
    return jax.device_get(jm.init(jax.random.PRNGKey(seed)))


# the reference's token draw under jit (bit for bit its eager draw,
# tests/test_torch_synthetic.py), memoized: eager, it takes 0.1 s a worker
# and step, which would dominate every run of the reference's launch.train here
_JSYNTH = jax.jit(jsynthetic.synth_lm_batch, static_argnums=(2, 3, 4))
_DRAWS = {}


def fast_synth(seed, step, batch, seq_len, vocab, worker=0):
    key = (seed, step, batch, seq_len, vocab, worker)
    if key not in _DRAWS:
        _DRAWS[key] = jax.device_get(
            _JSYNTH(seed, step, batch, seq_len, vocab, worker))
    return _DRAWS[key]


def _torch_batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def ref_stream(args, vocab, n, device):
    """The reference's TokenStream for launch.train's flags, as tensors."""
    return lambda t: _torch_batch(jax.tree.map(
        lambda *xs: np.stack(xs), *[fast_synth(
            args.seed, t, args.batch, args.seq, vocab, worker=w)
            for w in range(n)]))


def ref_client_batches(args, vocab, device):
    def batch_fn(client_ids, t):
        bs = [fast_synth(args.seed, t, args.batch, args.seq, vocab,
                         worker=int(c) + 1) for c in client_ids]
        return _torch_batch(jax.tree.map(lambda *xs: np.stack(xs), *bs))
    return batch_fn


def lines_of(text):
    out = {"records": [], "other": []}
    for line in text.splitlines():
        if not line.startswith("{"):
            out["other"].append(line)
            continue
        rec = json.loads(line)
        if "schema_version" in rec:
            out["header"] = rec
        elif "wire" in rec:
            out["wire"] = rec["wire"]
        elif "runtime" in rec:
            out["runtime"] = rec
        elif "step" in rec:
            out["records"].append(rec)
        else:
            out["other"].append(rec)
    return out


def run_ref(argv):
    """The reference's launch.train, its draws memoized (same bits)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jsynthetic, "synth_lm_batch", fast_synth)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            jtrain.main(argv)
    finally:
        mp.undo()
    return lines_of(buf.getvalue())


def run_port(argv, p0):
    """The port's launch.train on the CPU from the reference's params ``p0`` and
    the reference's batches."""
    mp = pytest.MonkeyPatch()
    mp.setattr(ptrain, "init_params",
               lambda model, seed, device: params_from_numpy(p0, device))
    mp.setattr(ptrain, "make_stream", ref_stream)
    mp.setattr(ptrain, "make_client_batches", ref_client_batches)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            ptrain.main(argv, device="cpu")
    finally:
        mp.undo()
    return lines_of(buf.getvalue())


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


N_PARAMS = 14        # leaves of reduced qwen2-0.5b


def ckpt_params(path, step):
    """The params leaves of a launch.train checkpoint (either package's file)
    as float32 numpy: the tree is {"opt", "params"}, so they come last."""
    import msgpack
    with open(f"{path}/ckpt_{step:08d}.msgpack", "rb") as f:
        blob = msgpack.unpackb(f.read(), raw=False)
    return [np.frombuffer(r["data"], r["wire"]).astype(np.float32)
            for r in blob["payload"][-N_PARAMS:]]


def assert_records_match(port, ref, rtol=RTOL):
    assert [r["step"] for r in port] == [r["step"] for r in ref]
    for p, r in zip(port, ref):
        assert rel(p["loss"], r["loss"]) <= rtol, (p, r)
        for key in ("lvl", "wire_cum_bytes", "sim_time_s", "sim_sync_s",
                    "dropped"):
            assert p.get(key) == r.get(key), (key, p, r)
        divs = {k: v for k, v in r.items() if k.startswith("div_")
                or k == "grad_norm"}
        assert set(divs) == {k for k in p if k.startswith("div_")
                             or k == "grad_norm"}
        for k, v in divs.items():
            assert rel(p[k], v) <= rtol, (k, p[k], v)


def assert_header_match(port, ref):
    want = dict(ref["header"])
    want["config"] = {k: v for k, v in want["config"].items() if k != "jit"}
    assert port["header"] == want


# ---------------------------------------------------------------------------
# the tree repair
# ---------------------------------------------------------------------------
FAMILIES = {"dense": ("qwen2-0.5b", {}), "local": ("gemma3-12b", {}),
            "ssm": ("mamba2-130m", {}),
            "hybrid": ("recurrentgemma-2b", {}),
            "hybrid_rem": ("recurrentgemma-2b", {"num_layers": 5})}


def test_tree_nodes_and_specs():
    tree = {"b": (1, [2, None, 3]), "a": None, "c": {"x": 4}}
    leaves, tdef = tree_flatten(tree)
    assert leaves == [1, 2, 3, 4]
    assert leaves == jax.tree.leaves(tree)
    assert tdef.unflatten(leaves) == tree
    back = tdef.unflatten([10, 20, 30, 40])
    assert back == {"a": None, "b": (10, [20, None, 30]), "c": {"x": 40}}
    assert isinstance(back["b"], tuple) and isinstance(back["b"][1], list)
    hash(tdef)
    # a dict-only tree's spec is what it was: sorted (key, child) pairs
    _, d = tree_flatten({"y": 1, "x": {"z": 2}})
    assert d == TreeDef((("x", (("z", None),)), ("y", None)))
    assert tree_flatten(())[0] == [] and tree_flatten(None)[0] == []
    with pytest.raises(ValueError):
        tdef.flatten_up_to({"a": None, "b": [1, [2, None, 3]],
                            "c": {"x": 4}})


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_lm_params_flatten_in_jax_order(family):
    arch, over = FAMILIES[family]
    jm = jbuild_model(jreduced(jget_config(arch), **over))
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    pp = params_from_numpy(jp, device="cpu")
    jl, pl = jax.tree.leaves(jp), tree_leaves(pp)
    assert len(jl) == len(pl) > 0
    for a, b in zip(jl, pl):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.to(torch.float32).numpy())
    pm = build_model(reduced(get_config(arch), **over))
    eng = HSGD(pm.loss, momentum(0.01), make_topology(
        "uniform", spec=HierarchySpec((2, 2), (4, 2))),
        EngineConfig(comms="int8"))
    st = eng.init_from_params(pp, device="cpu")
    assert len(tree_leaves(st.params)) == len(pl)
    assert all(x.shape[0] == 4 for x in tree_leaves(st.params))
    # the comms bucket concatenates leaves in that order
    fb = FlatBucket.plan(st.params)
    buf = fb.flatten(st.params)["float32"]
    want = np.concatenate([np.asarray(a, np.float32).reshape(-1)
                           for a in jl])
    np.testing.assert_array_equal(buf[0].numpy(), want)


# ---------------------------------------------------------------------------
# WireStats and EngineConfig.describe, field for field
# ---------------------------------------------------------------------------
def _topologies(core):
    return {
        "two_level": core.make_topology(
            "uniform", spec=core.HierarchySpec((2, 4), (8, 2))),
        "three_level": core.make_topology(
            "uniform", spec=core.HierarchySpec((2, 2, 2), (8, 4, 2))),
        # heterogeneous group periods: partial level-2 events
        "grouped": core.GroupedTopology(
            core.Grouping([0, 0, 1, 1, 1, 2]), G=12, I=(2, 3, 4)),
    }


@pytest.mark.parametrize("topo", ["two_level", "three_level", "grouped"])
def test_wire_stats_summary_equals_reference(topo):
    import repro.core as jcore
    import repro_torch.core as pcore
    from repro.comms import WireArray as JArray
    from repro.comms import WireStats as JStats
    from repro_torch.comms import WireArray as PArray
    from repro_torch.comms import WireStats as PStats
    spec = (("q", (361600,), "int8"), ("scale", (1413,), "float32"),
            ("bits", (45200,), "uint8"), ("half", (7,), "bfloat16"))
    ref = JStats(_topologies(jcore)[topo], tuple(JArray(*a) for a in spec),
                 361607)
    port = PStats(_topologies(pcore)[topo], tuple(PArray(*a) for a in spec),
                  361607)
    assert port.f32_bytes == ref.f32_bytes
    assert port.wire_dtypes == ref.wire_dtypes
    assert port.compression_ratio == ref.compression_ratio
    assert port.per_level() == ref.per_level()
    for T in (None, 5, 24):
        assert port.summary(T) == ref.summary(T)


def test_engine_config_describe_equals_reference():
    from repro.comms import Comms as JComms
    from repro.core import EngineConfig as JConfig
    from repro.population import Population as JPopulation
    from repro.runtime import RuntimeModel as JRuntime
    from repro_torch.comms import Comms as PComms
    from repro_torch.population import Population as PPopulation
    from repro_torch.runtime import RuntimeModel as PRuntime
    for kw in ({}, {"comms": "int8", "metrics": "on", "executor": "mesh"},
               {"async_levels": {1: 2}, "accum_steps": 2}):
        want = JConfig(**kw).describe()
        del want["jit"]
        assert EngineConfig(**kw).describe() == want
    want = JConfig(comms=JComms("topk", rate=0.1),
                   runtime=JRuntime(0.004, straggler="lognormal:0.8",
                                    policy="0.004", seed=3),
                   population=JPopulation((10, 10), seed=7)).describe()
    del want["jit"]
    assert EngineConfig(
        comms=PComms("topk", rate=0.1),
        runtime=PRuntime(0.004, straggler="lognormal:0.8", policy="0.004",
                         seed=3),
        population=PPopulation((10, 10), seed=7)).describe() == want


# ---------------------------------------------------------------------------
# parity with codecs off
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def p0():
    return ref_params(0)


@pytest.fixture(scope="module")
def ref_none(tmp_path_factory):
    ck = tmp_path_factory.mktemp("ref_none")
    out = run_ref(BASE + ["--steps", str(STEPS), "--ckpt-dir", str(ck),
                          "--ckpt-every", "8", "--divergence-every", "8"])
    out["ckpt"] = ck
    return out


def test_engine_parity_none(ref_none, p0):
    pm = build_model(reduced(get_config(ARCH)))
    topo = make_topology("uniform", spec=HierarchySpec((2, 2), (4, 2)))
    eng = HSGD(pm.loss, momentum(cosine(3e-3, STEPS, warmup_steps=1)), topo)
    st = eng.init_from_params(params_from_numpy(p0, device="cpu"),
                              device="cpu")
    args = ptrain.build_argparser().parse_args(BASE)
    st, hist = eng.run_rounds(st, ref_stream(args, 512, 4, "cpu"), STEPS)
    ref = ref_none["records"]
    assert [h["t"] for h in hist] == [r["step"] for r in ref]
    for h, r in zip(hist, ref):
        assert rel(h["ce"], r["loss"]) <= RTOL, (h, r)
    want = ckpt_params(ref_none["ckpt"], STEPS)
    got = [x.to(torch.float32).numpy().reshape(-1)
           for x in tree_leaves(st.params)]
    gap = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
    assert gap <= ATOL, gap


def test_trainer_parity_none(ref_none, p0, tmp_path):
    port = run_port(BASE + ["--steps", str(STEPS), "--ckpt-dir",
                            str(tmp_path), "--ckpt-every", "8",
                            "--divergence-every", "8"], p0)
    assert_header_match(port, ref_none)
    assert "wire" not in port and "wire" not in ref_none
    ref = ref_none["records"]
    assert_records_match(port["records"], ref)
    with_div = [r for r in ref if "divergence" in r]
    assert [r["step"] for r in with_div] == [8, 16]
    for p, r in zip(port["records"], ref):
        assert ("divergence" in p) == ("divergence" in r)
        for lvl, vals in r.get("divergence", {}).items():
            top = max(abs(v) for v in vals.values())
            for k, v in vals.items():
                assert abs(p["divergence"][lvl][k] - v) <= RTOL * top, \
                    (lvl, k, p["divergence"][lvl][k], v)
    for step in (8, STEPS):
        gap = max(float(np.abs(a - b).max()) for a, b in zip(
            ckpt_params(tmp_path, step), ckpt_params(ref_none["ckpt"], step)))
        assert gap <= ATOL, (step, gap)


def test_resume_from_reference_checkpoint(ref_none, p0, tmp_path):
    """The port picks up the reference's step-8 file and lands on the
    reference's uninterrupted run."""
    shutil.copy(ref_none["ckpt"] / "ckpt_00000008.msgpack", tmp_path)
    port = run_port(BASE + ["--steps", str(STEPS), "--ckpt-dir",
                            str(tmp_path), "--ckpt-every", "8"], p0)
    assert "resumed from step 8" in port["other"]
    ref = [r for r in ref_none["records"] if r["step"] > 8]
    got = port["records"]
    assert [r["step"] for r in got] == list(range(9, STEPS + 1))
    for p, r in zip(got, ref):
        assert rel(p["loss"], r["loss"]) <= RTOL and p["lvl"] == r["lvl"]
    gap = max(float(np.abs(a - b).max()) for a, b in zip(
        ckpt_params(tmp_path, STEPS), ckpt_params(ref_none["ckpt"], STEPS)))
    assert gap <= ATOL, gap


SMOKE = ["--arch", ARCH, "--reduced", "--workers", "4", "--groups", "2",
         "--G", "4", "--I", "2", "--batch", "2", "--seq", "32"]


def test_trainer_smoke_resume_bit_for_bit(tmp_path):
    """``tests/test_system.py:80`` on the port with its own init and
    stream: 12 steps with checkpoints every 6, then the same run resumed
    from its step-6 file writes the same step-12 file, byte for byte; a
    run to 14 steps resumes from step 12."""
    full, part = tmp_path / "full", tmp_path / "part"
    hist = ptrain.main(SMOKE + ["--steps", "12", "--log-every", "4",
                                "--ckpt-dir", str(full), "--ckpt-every", "6"],
                       device="cpu")
    assert hist[-1]["step"] == 12 and np.isfinite(hist[-1]["loss"])
    assert hist[-1]["loss"] < hist[0]["loss"] + 0.05
    part.mkdir()
    shutil.copy(full / "ckpt_00000006.msgpack", part)
    ptrain.main(SMOKE + ["--steps", "12", "--log-every", "4",
                         "--ckpt-dir", str(part), "--ckpt-every", "6"],
                device="cpu")
    assert (full / "ckpt_00000012.msgpack").read_bytes() == \
        (part / "ckpt_00000012.msgpack").read_bytes()
    hist2 = ptrain.main(SMOKE + ["--steps", "14", "--log-every", "2",
                                 "--ckpt-dir", str(full)], device="cpu")
    assert [r["step"] for r in hist2] == [14]
    # the restored state is the file's, on the template's device and dtypes
    pm = build_model(reduced(get_config(ARCH)))
    eng = HSGD(pm.loss, sgd(0.1), make_topology(
        "uniform", spec=HierarchySpec((2, 2), (4, 2))))
    st = eng.init(torch.Generator().manual_seed(0), pm.init, device="cpu")
    step, tree = restore(str(full), {"params": st.params,
                                     "opt": st.opt_state}, step=12)
    assert step == 12
    for a, b in zip(tree_leaves(tree), tree_leaves(
            {"params": st.params, "opt": st.opt_state})):
        assert a.dtype == b.dtype and a.shape == b.shape


def test_trainer_population_smoke():
    hist = ptrain.main(SMOKE + ["--steps", "8", "--log-every", "4",
                                "--population", "10x10", "--sample-k", "4"],
                       device="cpu")
    assert [r["round"] for r in hist] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in hist)
    assert hist[-1]["participation"]["k"] == 4


# ---------------------------------------------------------------------------
# flag errors
# ---------------------------------------------------------------------------
ERRORS = {
    "block_without_codec": ["--comms-block", "64", "--comms", "topk"],
    "rate_without_topk": ["--comms-rate", "0.1", "--comms", "int8"],
    "straggler_without_runtime": ["--straggler", "lognormal:0.8"],
    "deadline_without_runtime": ["--deadline", "2.0"],
    "population_not_cells": ["--population", "ten"],
    "population_levels": ["--population", "100"],
    "sample_k": ["--population", "10x10", "--sample-k", "3"],
    "population_steps": ["--population", "10x10", "--steps", "7"],
    "population_ckpt": ["--population", "10x10", "--steps", "8",
                        "--ckpt-dir", "x"],
    "population_trace": ["--population", "10x10", "--steps", "8",
                         "--trace", "t.json"],
    "population_divergence": ["--population", "10x10", "--steps", "8",
                              "--divergence-every", "2"],
    "sample_seed_alone": ["--sample-seed", "3"],
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_flag_errors_match_reference(case, capsys):
    argv = SMOKE + ERRORS[case]
    with pytest.raises(SystemExit) as ref:
        jtrain.main(argv)
    want = capsys.readouterr().err
    with pytest.raises(SystemExit) as got:
        ptrain.main(argv, device="cpu")
    assert got.value.code == ref.value.code == 2
    assert capsys.readouterr().err == want
    assert "error: " in want


def test_audit_raises_naming_a11(capsys):
    """Since the analysis layer is ported, ``--audit`` no longer raises: it
    prints the sync plan's audit, clean, before training starts."""
    ptrain.main(SMOKE + ["--steps", "2", "--audit"], device="cpu")
    out = capsys.readouterr().out
    assert f"[sim/{ARCH}] executor=sim" in out
    assert "findings: none" in out and "FINDING" not in out
