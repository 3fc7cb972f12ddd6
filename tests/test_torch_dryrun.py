"""The port's placement and dry run (``repro_torch.launch.partitioning``,
``repro_torch.launch.dryrun``, the spec helpers of
``repro_torch.models.model``) against the reference's, on the CPU.

* Placement parity, spec for spec, with no devices: on the reference's
  ``AbstractMesh`` of both production meshes, for every arch, the
  port's ``params_shardings`` (with and without a lead worker axis, an
  fsdp axis and model sharding), ``batch_shardings`` and
  ``cache_shardings`` against the reference's on the same shapes (the
  port's ``meta`` init and ``decode_state_specs`` must have the
  reference's shapes first), and ``train_plan``, ``applicable`` and
  ``model_flops_per_step``.
* Per-chip counts in a subprocess with a fake world of 8, (2, 2, 2), at
  the reduced qwen2-0.5b of ``tests/test_dryrun_small.py``: rank 0's
  product FLOPs against a count by hand from its local shapes, the
  reference test's assertions on collectives, the global sync's bytes
  against rank 0's local params, and no process group left behind.
* The reference test's second leg: the placed global-sync step run for
  real on 8 ``gloo`` ranks against the single-process sim step.
* The CLI's round trip, and its refusal of the reference's file name.
* ``gpu``: rank 0's reduced prefill on the card prices as on ``meta``.

The ranks of the ``gloo`` leg import this module, so JAX enters only inside
fixtures and test bodies (the ``gpu`` case then also runs with
``--noconftest`` where only PyTorch is installed).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, get_config,  # noqa: E402
                                 reduced)
from repro_torch.core import (HSGD, EngineConfig, HierarchySpec,  # noqa: E402
                              MeshExecutor, SyncEvent, make_topology)
from repro_torch.experiments import roofline_table  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import partitioning as PP  # noqa: E402
from repro_torch.launch.mesh import launch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.model import (decode_state_specs,  # noqa: E402
                                      input_specs, param_specs)
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.roofline.analysis import model_flops_per_step  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SRC = str(ROOT / "src")
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
# the reduced config of tests/test_dryrun_small.py
SMALL = dict(num_heads=4, num_kv_heads=2, head_dim=32)
SMALL_SPEC = HierarchySpec((2, 2), (4, 2))
SMALL_BATCH = (2, 32)          # a worker's (sequences, tokens)
EXEC_ATOL = 1e-5               # tests/test_dryrun_small.py:99-100


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


# ---------------------------------------------------------------------------
# placement parity
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref():
    """The reference's placement, plan and spec helpers, and JAX.  Its
    ``dryrun`` module sets ``XLA_FLAGS`` when imported; the variable is put
    back so that later subprocesses of this worker do not inherit it."""
    jax = pytest.importorskip("jax")
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as rdry
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    from repro.configs import get_config as rget
    from repro.launch import partitioning as rpart
    from repro.models import build_model as rbuild
    from repro.models.model import decode_state_specs as rdecode
    from repro.models.model import input_specs as rinputs
    return dict(jax=jax, dry=rdry, part=rpart, get=rget, build=rbuild,
                decode=rdecode, inputs=rinputs)


_PORT_SPECS = {}


def _port_params(arch):
    """The port's ``meta`` init of ``arch``'s params, flattened (once per
    arch: a full-width fake init takes up to seconds)."""
    if arch not in _PORT_SPECS:
        _PORT_SPECS[arch] = tree_flatten(param_specs(build_model(
            get_config(arch))))[0]
    return _PORT_SPECS[arch]


def _norm(spec):
    """A spec as a tuple, one-name tuples as the name (the same
    PartitionSpec entry)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in tuple(spec))


def _ref_specs(ref, tree):
    from jax.sharding import NamedSharding
    return [_norm(s.spec) for s in ref["jax"].tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding))]


def _shapes(leaves):
    return [tuple(np.shape(x)) if not isinstance(x, int) else ()
            for x in leaves]


def _lead(shapes, n):
    return [torch.empty((n,) + s, device="meta") for s in shapes]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_placement_and_plan_equal_the_reference(ref, arch, mesh_name):
    """Every spec of every placement function, the training plan,
    ``applicable`` and the model FLOPs of every shape equal the
    reference's for this arch on this production mesh."""
    from jax.sharding import AbstractMesh
    jax = ref["jax"]
    sizes, names = MESHES[mesh_name]
    mesh = AbstractMesh(sizes, names)
    rcfg, pcfg = ref["get"](arch), get_config(arch)

    # params: the port's meta init has the reference's shapes
    r_leaves = jax.tree.leaves(jax.eval_shape(
        lambda: ref["build"](rcfg).init(jax.random.PRNGKey(0))))
    p_leaves = _port_params(arch)
    shapes = _shapes(r_leaves)
    assert _shapes(p_leaves) == shapes
    assert [str(t.dtype).replace("torch.", "") for t in p_leaves] == \
        [str(x.dtype) for x in r_leaves]

    # the plan, and params with and without a lead worker axis
    rplan, pplan = ref["dry"].train_plan(rcfg, mesh), D.train_plan(pcfg,
                                                                   mesh)
    assert {k: pplan[k] for k in ("mapping", "lead", "fsdp_axis",
                                  "data_axis")} == \
        {k: rplan[k] for k in ("mapping", "lead", "fsdp_axis", "data_axis")}
    assert (pplan["spec"].group_sizes, pplan["spec"].periods) == \
        (rplan["spec"].group_sizes, rplan["spec"].periods)
    n = pplan["spec"].n_workers
    structs = [jax.ShapeDtypeStruct(s, np.float32) for s in shapes]
    lead_structs = [jax.ShapeDtypeStruct((n,) + s, np.float32)
                    for s in shapes]
    for lead, fsdp, shard in ((None, None, True), (None, "data", True),
                              (None, "data", False),
                              (pplan["lead"], pplan["fsdp_axis"], True),
                              (pplan["lead"], None, True)):
        kw = dict(lead_worker=lead, fsdp_axis=fsdp, model_shard=shard)
        theirs = _ref_specs(ref, ref["part"].params_shardings(
            mesh, structs if lead is None else lead_structs, **kw))
        ours = PP.params_shardings(mesh, p_leaves if lead is None
                                   else _lead(shapes, n), **kw)
        assert [_norm(s) for s in ours] == theirs, kw

    # batches and caches of every applicable shape; the model FLOPs
    for sname, shape in INPUT_SHAPES.items():
        assert D.applicable(arch, sname) == ref["dry"].applicable(arch,
                                                                  sname)
        if not D.applicable(arch, sname):
            continue
        assert model_flops_per_step(pcfg, shape) == \
            ref["dry"].model_flops_per_step(rcfg, shape)
        if shape.kind == "decode":
            r_in = ref["decode"](rcfg, shape)
            p_in = decode_state_specs(pcfg, shape)
            assert sorted(p_in) == sorted(ref["inputs"](rcfg, shape)) == \
                sorted(input_specs(pcfg, shape)) == ["cache", "token"]
            r_cache = jax.tree.leaves(r_in["cache"])
            p_cache = tree_flatten(p_in["cache"])[0]
            assert _shapes(p_cache) == _shapes(r_cache), sname
            theirs = _ref_specs(ref, ref["part"].cache_shardings(
                mesh, r_in["cache"], shape.global_batch))
            ours = PP.cache_shardings(mesh, p_cache, shape.global_batch)
            assert [_norm(s) for s in ours] == theirs, sname
            continue
        r_in = ref["inputs"](rcfg, shape)
        p_in = input_specs(pcfg, shape)
        assert sorted(p_in) == sorted(r_in), sname
        leaves = [p_in[k] for k in sorted(p_in)]
        r_batch = [r_in[k] for k in sorted(r_in)]
        assert _shapes(leaves) == _shapes(r_batch), sname
        if shape.kind == "train":
            lead = pplan["lead"]
            r_batch = [jax.ShapeDtypeStruct(
                (n, x.shape[0] // n) + x.shape[1:], x.dtype)
                for x in r_batch]
            leaves = [torch.empty((n, t.shape[0] // n) + tuple(t.shape[1:]),
                                  device="meta") for t in leaves]
            kw = dict(lead_worker=lead, data_axis=pplan["data_axis"])
        else:
            kw = {}
        theirs = _ref_specs(ref, ref["part"].batch_shardings(mesh, r_batch,
                                                             **kw))
        ours = PP.batch_shardings(mesh, leaves, **kw)
        assert [_norm(s) for s in ours] == theirs, sname


def test_placements_of_a_spec():
    """A spec's placements on a DeviceMesh: Shard(d) on each mesh dim a
    tensor dim names (a dim over two mesh dims on both), Replicate on the
    rest; a name the mesh lacks is refused."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:   # placements() reads only the dim names
        mesh_dim_names = ("pod", "data", "model")

    assert PP.placements((("pod", "data"), None, "model"), Mesh()) == \
        [Shard(0), Shard(0), Shard(2)]
    assert PP.placements((None, "data"), Mesh()) == \
        [Replicate(), Shard(1), Replicate()]
    assert PP.placements((), Mesh()) == [Replicate()] * 3
    with pytest.raises(ValueError, match="rack"):
        PP.placements(("rack",), Mesh())


# ---------------------------------------------------------------------------
# per-chip counts on a fake world of 8
# ---------------------------------------------------------------------------
_COUNTS = r"""
import dataclasses, json
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import name_mesh_groups

cfg = dataclasses.replace(reduced(get_config("qwen2-0.5b")), **SMALL)
shape = InputShape("small", S, B, "train")
out = {}
try:
    with D.fake_world(8):
        mesh = name_mesh_groups(init_device_mesh(
            "cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model")))
        programs, plan = D.train_programs(cfg, shape, mesh)
        state, batch = programs["local"].args
        out["params_bytes"] = D.local_bytes(state.params)
        out["local_shapes"] = {
            k: list(v.to_local().shape) for k, v in
            state.params["units"][0]["attn"].items()}
        rec = D.record_train(cfg, shape, mesh)
        for k in ("local", "local_sync", "global_sync"):
            r = rec[k]
            out[k] = {"flops": r.flops_by_class,
                      "coll_intra": r.coll_intra,
                      "coll_cross": r.coll_cross,
                      "all_reduce": r.coll_by_kind["all-reduce"]}
finally:
    out["initialized_after"] = dist.is_initialized()
print("RESULT" + json.dumps(out))
"""


def _hand_products(cfg, b, s, m):
    """Rank 0's product FLOPs of one local step by hand, from its local
    shapes: every weight's product over its 1/m shard (each >=2-D weight
    is sharded on 'model') and the tied LM head over its 1/m of the
    vocabulary, forward and twice backward (the input's and the weight's
    gradient); attention's six products a layer (QK^T and PV forward; dP,
    dS, dQ and dK, dV backward) over rank 0's heads, but for two that
    run over every head: there DTensor gathers the flattened (batch x
    heads) dim before the product (the recorded local shapes, the
    ``(b * heads, s, s)`` bmm)."""
    d, hq = cfg.d_model, cfg.num_heads * cfg.d_head
    hk = cfg.num_kv_heads * cfg.d_head
    t = b * s
    weights = 2 * t * (d * hq + 2 * d * hk + hq * d + 3 * d * cfg.d_ff) / m
    per_head = 2 * b * s * s * cfg.d_head
    attention = per_head * (4 * cfg.num_heads // m + 2 * cfg.num_heads)
    head = 2 * t * d * cfg.vocab_size / m
    return cfg.num_layers * (3 * weights + attention) + 3 * head


def test_rank0_counts_on_a_fake_world_of_8():
    """The reduced qwen2-0.5b on (pod=2, data=2, model=2): rank 0's product
    FLOPs equal the count by hand; the global sync crosses pods and the
    local one does not cross more; the global sync's all-reduces over the
    replica axes move rank 0's local params in float32 (the payload
    dtype), plus the per-step metrics' gather; no process group is left
    behind."""
    script = f"SMALL = {SMALL!r}\nS, B = {SMALL_BATCH[1]}, " \
        f"{SMALL_BATCH[0] * SMALL_SPEC.n_workers}\n" + _COUNTS
    r = subprocess.run([sys.executable, "-c", script], env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(next(line for line in r.stdout.splitlines()
                          if line.startswith("RESULT"))[len("RESULT"):])
    assert out["initialized_after"] is False
    cfg = dataclasses.replace(reduced(get_config("qwen2-0.5b")), **SMALL)
    # rank 0's shards: every attention weight halved on its largest dim
    assert out["local_shapes"] == {
        "wq": [1, 2, 128, 64], "wk": [1, 2, 64, 64], "wv": [1, 2, 64, 64],
        "wo": [1, 2, 128, 64], "bq": [1, 2, 64], "bk": [1, 2, 32],
        "bv": [1, 2, 32]}
    want = _hand_products(cfg, *SMALL_BATCH, 2)
    for k in ("local", "local_sync", "global_sync"):
        assert out[k]["flops"]["f32"] == want, k
        assert out[k]["flops"]["bf16"] == 0
    # the reference test's assertions (tests/test_dryrun_small.py:97-100)
    assert out["global_sync"]["coll_cross"] > 0
    assert out["local_sync"]["coll_cross"] <= out["global_sync"]["coll_cross"]
    assert sum(out["local"]["flops"].values()) > 0
    # the sync: one all-reduce of each local shard of the updated params,
    # in float32 (the payload dtype), over ('pod', 'data') for the global
    # sync and ('data',) for the local one.  Every updated leaf is sharded
    # over 'model' (the final norm's scale, replicated as placed, comes
    # back from the update sharded like its gradient), so the payload is
    # half the params.  The metrics' all-gather over the replica axes is
    # the only other cross-pod collective (n x 1 step x (ce, moe_aux)).
    sync = cfg.param_count() * 4 // 2
    metrics = SMALL_SPEC.n_workers * 1 * 2 * 4
    assert out["local"]["coll_cross"] == metrics
    assert out["global_sync"]["coll_cross"] == sync + metrics
    assert out["global_sync"]["all_reduce"] - out["local"]["all_reduce"] \
        == sync
    assert out["local_sync"]["coll_intra"] - out["local"]["coll_intra"] \
        == sync
    # as placed, rank 0 holds the params' halves but the final norm's
    assert out["params_bytes"] == sync + cfg.d_model * 4 // 2


# ---------------------------------------------------------------------------
# the placed step run for real on 8 gloo ranks
# ---------------------------------------------------------------------------
def _small_world():
    cfg = dataclasses.replace(reduced(get_config("qwen2-0.5b")), **SMALL)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    n = SMALL_SPEC.n_workers
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (n,) + SMALL_BATCH).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens),
             "targets": torch.from_numpy(np.roll(tokens, -1, axis=-1))}
    return cfg, model, params, batch


# the pins of the placed step: none, and the residual pinned at every unit
# edge to its sequence dim over 'model' (it arrives sharded on d_model)
PINS = (None, (None, "model", None))


def _placed_rank(rank, pins):
    """One rank of (pod=2, data=2, model=2): its worker's row placed on the
    'model' dim, one global-sync step from the same state for each
    ``act_pspec`` of ``pins``, its worker's full params back for each."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate
    from repro_torch.launch.mesh import make_hsgd_mesh, name_mesh_groups
    torch.set_num_threads(1)
    cfg, _, params, batch = _small_world()
    mesh = name_mesh_groups(init_device_mesh(
        "cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model")))
    hmesh = make_hsgd_mesh(SMALL_SPEC.group_sizes, device_mesh=mesh)
    wmesh = mesh["model"]

    def spec(t):
        return D._row(PP.param_spec(tuple(t.shape), 2,
                                    lead_worker=("pod", "data")))
    out = {}
    for pin in pins:
        model = build_model(dataclasses.replace(cfg, act_pspec=pin))
        eng = HSGD(model.loss, sgd(1e-2), make_topology("uniform",
                                                        spec=SMALL_SPEC),
                   EngineConfig(executor=MeshExecutor(hmesh)))
        state = eng.init_from_params(params, device="cpu")
        state = dataclasses.replace(
            state, params=D._place_tree(state.params, spec, wmesh),
            opt_state=D._place_tree(state.opt_state, spec, wmesh))
        rows = {k: D.place(v[eng.executor.widx][None], (None,) * 3, wmesh)
                for k, v in batch.items()}
        step = D._replicating(eng.step_fn(SyncEvent(level=1)))
        new, metrics = step(state, rows)
        out[pin] = {"params": [t.redistribute(wmesh, [Replicate()])
                               .to_local()[0].numpy()
                               for t in tree_flatten(new.params)[0]],
                    "ce": float(metrics["ce"].full_tensor())}
    return out


@pytest.fixture(scope="module")
def placed():
    """Rank 0's results of the placed step under each of PINS, from one
    launch of 8 ``gloo`` ranks."""
    return launch(_placed_rank, 8, backend="gloo", device="cpu",
                  args=(PINS,), timeout=240.0)


def test_placed_global_sync_runs_as_the_sim_step(placed):
    """The reference test's second leg: the placed global-sync step on 8
    ``gloo`` ranks (tensor parallelism over 'model' inside each worker,
    the sync over ('pod', 'data')) gives rank 0's worker the params and
    the mean CE of the single-process sim step, within 1e-5."""
    _against_the_sim(placed[None])


def test_placed_global_sync_with_act_pspec_runs_as_the_sim_step(placed):
    """The same with the residual pinned at every unit edge to its
    sequence dim over 'model' (it arrives there sharded on d_model), so
    that the pin's redistribution runs inside the step's ``vmap(grad)``
    and its backward moves the gradient back, on real ranks: still
    within 1e-5 of the sim step (where the pin, on plain tensors, does
    nothing)."""
    _against_the_sim(placed[PINS[1]])


def _against_the_sim(got):
    cfg, model, params, batch = _small_world()
    eng = HSGD(model.loss, sgd(1e-2), make_topology("uniform",
                                                    spec=SMALL_SPEC))
    new, metrics = eng.step_fn(SyncEvent(level=1))(
        eng.init_from_params(params, device="cpu"), batch)
    want = [t[0].numpy() for t in tree_flatten(new.params)[0]]
    assert len(got["params"]) == len(want)
    for a, b in zip(got["params"], want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=EXEC_ATOL)
    assert abs(got["ce"] - float(metrics["ce"])) < EXEC_ATOL


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_cli_round_trip(tmp_path):
    """``python -m repro_torch.launch.dryrun`` writes one record in the
    reference's format, which ``roofline_table`` renders, and leaves no
    process group; the reference's file name is refused."""
    out = tmp_path / "dryrun_torch.json"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-0.5b", "--shape", "decode_32k", "--mesh", "single", "--out",
         str(out)], env=_env(), capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    results = json.loads(out.read_text())
    assert list(results) == ["qwen2-0.5b|decode_32k|single"]
    rec = results["qwen2-0.5b|decode_32k|single"]
    assert set(rec) >= {"arch", "shape", "multi_pod", "lower_s", "mapping",
                        "n_workers", "steps", "dominant", "terms_s",
                        "model_flops_per_chip", "useful_ratio",
                        "rank0_resident_bytes"}
    step = rec["steps"]["decode"]
    assert step["peak_memory_bytes"] is None
    assert step["flops_per_chip"] > 0 and step["coll_cross_bytes"] == 0
    assert rec["model_flops_per_chip"] == model_flops_per_step(
        get_config("qwen2-0.5b"), INPUT_SHAPES["decode_32k"]) / 256
    rows = roofline_table.rows(results)
    assert len(rows) == 1 and rows[0]["fits_hbm"] is True
    assert rows[0]["dominant"] == rec["dominant"]
    assert not dist.is_initialized()
    with pytest.raises(SystemExit):
        D.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                "--out", str(tmp_path / "dryrun.json")])
    assert not (tmp_path / "dryrun.json").exists()


def test_constrain_acts_redistributes_a_dtensor_residual():
    """``act_pspec`` pins a DTensor residual's placements on its own mesh;
    a plain tensor, or no ``act_pspec``, comes back as it is (the
    reference's no-mesh case)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.models.transformer import constrain_acts
    cfg = reduced(get_config("qwen2-0.5b"))
    pinned = dataclasses.replace(cfg, act_pspec=("data", None, "model"))
    x = torch.zeros(4, 8, 16)
    assert constrain_acts(x, pinned) is x
    with D.fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        xd = distribute_tensor(x, mesh, [Replicate(), Replicate()])
        assert constrain_acts(xd, cfg) is xd
        out = constrain_acts(xd, pinned)
        assert list(out.placements) == [Shard(0), Shard(2)]
        assert out.to_local().shape == (2, 8, 8)
        assert constrain_acts(out, pinned) is out
    assert not dist.is_initialized()


def test_fake_world_is_torn_down_when_the_program_raises():
    with pytest.raises(RuntimeError, match="inside"):
        with D.fake_world(4):
            assert dist.get_world_size() == 4
            raise RuntimeError("inside")
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_card_prefill_prices_as_meta():
    """Rank 0's reduced prefill on (data=2, model=2) with the attention
    kernel: materialized on the card it prices as on ``meta`` (FLOPs by
    class, bytes, collective bytes, regions), and its kernel launches equal
    its regions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import attention as kattn
    from repro_torch.launch.mesh import name_mesh_groups
    cfg = dataclasses.replace(reduced(get_config("qwen2-0.5b")),
                              use_kernels=True, **SMALL)
    shape = InputShape("small", 64, 4, "prefill")
    with D.fake_world(4):
        mesh = name_mesh_groups(init_device_mesh(
            "cuda", (2, 2), mesh_dim_names=("data", "model")))
        reps = {}
        for seed in (None, 0):
            prog = D.prefill_program(cfg, shape, mesh, seed=seed)
            D.warm_up(prog)
            kattn.reset_launch_counts()
            reps[seed] = D.price("small", prog, mesh, 1.0, warm=False)
            torch.cuda.synchronize()
            launches = kattn.launch_counts["flash_attention"]
        meta, card = reps[None], reps[0]
    assert launches == card.regions["flash_attention"] == cfg.num_layers
    assert (card.flops_by_class, card.bytes_per_chip, card.coll_intra,
            card.coll_cross, card.regions) == \
        (meta.flops_by_class, meta.bytes_per_chip, meta.coll_intra,
         meta.coll_cross, meta.regions)
