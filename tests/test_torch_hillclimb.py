"""The hillclimb's twin (``repro_torch.experiments.hillclimb``) against
``benchmarks/hillclimb.py``, on the CPU.

* Its tables (``ITERATIONS``, ``SERVE_ITERATIONS``) equal the reference's,
  read from the reference's source with ``ast`` (importing that module
  sets ``XLA_FLAGS`` to 512 host devices).
* The reference's own figures cannot be had (its dry run raises under
  jax 0.9.0, ROADMAP §C), so the twin is held by the exact effects of its
  knobs, in one subprocess with a fake world of 8, (pod=2, data=2,
  model=2), on ``tests/test_torch_dryrun.py``'s reduced qwen2-0.5b:
  ``measure`` itself runs there, with ``get_config`` and the input shapes
  cut to that size.  Against hand counts: ``sync_dtype="bfloat16"``
  halves the global sync's param all-reduce; ``accum_steps=2`` leaves
  the product FLOPs as they are; ``model_shard=False`` makes rank 0's
  params the whole params and its products the unsharded count;
  ``remat`` adds one forward of the units on rank 0's shards; and
  ``act_pspec=("data", None, "model")``, under the fsdp mapping that the
  reference's act_shard iterations run (nemotron-4-340b, mixtral-8x22b),
  redistributes the one unit edge whose layout differs from the pin,
  and so changes the step's collectives, where
  ``act_pspec`` None adds none.
* ``main`` refuses the reference's output file.
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from test_torch_dryrun import SMALL, _hand_products  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.experiments import hillclimb as H  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
B, S = 2, 32                   # a worker's (sequences, tokens)
N_WORKERS = 4                  # (pod, data) = (2, 2): replica mapping


def _reference_tables():
    tree = ast.parse((ROOT / "benchmarks" / "hillclimb.py").read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id in ("ITERATIONS", "SERVE_ITERATIONS"):
            out[node.targets[0].id] = ast.literal_eval(node.value)
    return out


def test_tables_equal_the_reference():
    ref = _reference_tables()
    assert H.ITERATIONS == ref["ITERATIONS"]
    assert H.SERVE_ITERATIONS == ref["SERVE_ITERATIONS"]
    assert sum(len(v) for v in H.ITERATIONS.values()) == 16


_KNOBS = r"""
import dataclasses, json
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import InputShape
from repro_torch.experiments import hillclimb as H
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import name_mesh_groups
from repro_torch.device import dtensor_layout
from repro_torch.models import transformer as T

small = dataclasses.replace(reduced(get_config("qwen2-0.5b")), **SMALL)
H.get_config = lambda arch: small
H.INPUT_SHAPES = {f"b{b}": InputShape("small", S, b * N, "train")
                  for b in (B, 2 * B)}
# the pin's redistributions: constrain_acts's calls that move the residual
moved = []
redistribute = T.redistribute
def counted(x, placements):
    have = dtensor_layout(x)[1]
    if have != list(placements):
        moved.append([p.dim if p.is_shard() else str(p) for p in have])
    return redistribute(x, placements)
T.redistribute = counted

RUNS = {
    "base": ("b2", {}, {}),
    "bf16_sync": ("b2", {}, {"sync_dtype": "bfloat16"}),
    "no_model_shard": ("b2", {}, {"model_shard": False}),
    "remat": ("b2", {"remat": True}, {}),
    "accum2": ("b4", {}, {"accum_steps": 2}),
    "fsdp": ("b2", {}, {}),
    "fsdp_act": ("b2", {"act_pspec": ("data", None, "model")}, {}),
}
out = {}
try:
    with D.fake_world(8):
        mesh = name_mesh_groups(init_device_mesh(
            "cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model")))
        for name, (shape, over, knobs) in RUNS.items():
            if name.startswith("fsdp"):
                # the mapping of the archs whose replica does not fit
                D.REPLICA_HBM_BUDGET = 0
            del moved[:]
            # the steps the checks read (the amortized period takes the
            # local step for the local sync's)
            rec = H.measure("qwen2-0.5b", shape, mesh=mesh, cfg_over=over,
                            kinds=("local", "global_sync"), **knobs)
            rec["moved"] = list(moved)
            out[name] = rec
finally:
    out["initialized_after"] = dist.is_initialized()
print("RESULT" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def knobs():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep \
        + env.get("PYTHONPATH", "")
    script = (f"SMALL = {SMALL!r}\nS, B, N = {S}, {B}, {N_WORKERS}\n"
              + _KNOBS)
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(next(line for line in r.stdout.splitlines()
                          if line.startswith("RESULT"))[len("RESULT"):])
    assert out.pop("initialized_after") is False
    return out


def _cfg():
    return dataclasses.replace(reduced(get_config("qwen2-0.5b")), **SMALL)


def _head(rec):
    return rec["steps"]["global_sync"]


def _products(rec):
    f = _head(rec)["flops_by_class"]
    return f["f32"] + f["bf16"]


def test_records_have_the_reference_fields(knobs):
    for rec in knobs.values():
        assert set(rec) >= {"terms_s", "amortized", "peak_gb",
                            "coll_cross_gb", "coll_intra_gb",
                            "flops_per_chip", "rank0_resident_gb"}
        assert rec["peak_gb"] is None
        assert rec["amortized"]["dominant"] in ("compute_s", "memory_s",
                                                "collective_s")


def test_bf16_sync_halves_the_global_param_all_reduce(knobs):
    """The global sync all-reduces rank 0's model-sharded half of the
    params over ('pod', 'data'): 4 B a param in float32, 2 in bfloat16;
    the per-step metrics' gather (n x (ce, moe_aux) in float32) stays."""
    cfg = _cfg()
    sync = cfg.param_count() * 4 // 2
    metrics = N_WORKERS * 2 * 4
    base, bf16 = knobs["base"], knobs["bf16_sync"]
    assert _head(base)["coll_cross_bytes"] == sync + metrics
    assert _head(bf16)["coll_cross_bytes"] == sync // 2 + metrics

    def sync_all_reduce(rec):
        steps = rec["steps"]
        return steps["global_sync"]["coll_by_kind"]["all-reduce"] \
            - steps["local"]["coll_by_kind"]["all-reduce"]
    assert sync_all_reduce(base) == sync
    assert sync_all_reduce(bf16) == sync // 2
    assert _products(bf16) == _products(base)


def test_accum_steps_keeps_the_products(knobs):
    """Two microbatches of 2 sequences price the products of one batch of
    4, twice those of a batch of 2.  (At microbatches of one sequence
    DTensor picks another strategy for the flattened (batch x heads)
    attention products: 2**20 fewer FLOPs at B = 2.)"""
    assert _products(knobs["accum2"]) == 2 * _products(knobs["base"])


def test_model_shard_off_holds_the_whole_params(knobs):
    cfg = _cfg()
    whole = cfg.param_count() * 4
    base, off = knobs["base"], knobs["no_model_shard"]
    # as placed, rank 0 holds the params' halves but the final norm's
    assert base["rank0_param_bytes"] == whole // 2 + cfg.d_model * 4 // 2
    assert off["rank0_param_bytes"] == whole
    assert off["rank0_resident_bytes"] - base["rank0_resident_bytes"] \
        == whole - base["rank0_param_bytes"]
    assert _head(off)["flops_by_class"]["f32"] == \
        _hand_products(cfg, B, S, 1)
    assert _head(base)["flops_by_class"]["f32"] == \
        _hand_products(cfg, B, S, 2)


def test_remat_adds_one_forward_of_the_units(knobs):
    """Rank 0's shards: every weight's product over its half, QK^T and PV
    over its half of the heads (S = 32 < attn_chunk_q: no chunks)."""
    cfg = _cfg()
    d, hq = cfg.d_model, cfg.num_heads * cfg.d_head
    hk = cfg.num_kv_heads * cfg.d_head
    weights = 2 * B * S * (d * hq + 2 * d * hk + hq * d + 3 * d * cfg.d_ff)
    attention = 4 * B * S * S * cfg.d_head * cfg.num_heads
    unit = cfg.num_layers * (weights + attention) // 2
    assert _products(knobs["remat"]) - _products(knobs["base"]) == unit


def test_act_pspec_redistributes_the_unit_edges(knobs):
    """Under the fsdp mapping a worker is (data, model): the embedding's
    output arrives sharded on d_model over both dims, and the pin moves it
    to the batch over 'data' at the first unit's entry (its gradient goes
    back in the backward) once a step, in each of the three calls of rank
    0's program (the warm-up, local, global sync); every other edge
    already holds the pin.  Without act_pspec none runs."""
    base, act = knobs["fsdp"], knobs["fsdp_act"]
    assert base["moved"] == []
    assert act["moved"] == [[2, 2]] * 3
    assert _head(act)["coll_by_kind"] != _head(base)["coll_by_kind"]
    assert _products(act) == _products(base)


def test_main_refuses_the_reference_file(tmp_path):
    with pytest.raises(SystemExit):
        H.main(["--pair", "none", "--out", H.REFERENCE_OUT])
