"""The port's launch.train on the runtime, probe, trace, population and
mesh paths against the JAX package's, on the CPU (reduced qwen2-0.5b,
uniform (2, 2), G=4, I=2, momentum, batch 4, seq 32, 8 steps).

* ``--runtime`` with a lognormal straggler and a deadline (which drops
  workers) and ``--probes``: one reference run of launch.train, the port's launch.train
  from the reference's params and batches: CE, ``div_*`` and
  ``grad_norm`` within RTOL relative, ``sim_time_s``, ``sim_sync_s`` and
  ``dropped`` exact, the final ``runtime`` / ``fitted_comm_model`` line
  equal, the ``--trace`` file's events by name and phase equal.
* ``--population 10x10 --sample-k 4``: the same clients drawn each round,
  participation records equal, CE within RTOL.
* ``--backend mesh --comms topk`` on 4 spawned ``gloo`` ranks (the port's
  own init and stream; the ranks import launch.train afresh): records
  within MESH_RTOL of the port's sim and wire bytes equal, the step-8
  checkpoint (gathered, written by rank 0) within MESH_ATOL of the sim's;
  a mesh run resumed from its step-4 file (read on every rank, each
  keeping its row) against the sim resumed from the sim's, to the same
  limits.
"""
import collections
import json
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_train import (  # noqa: E402,F401 (a fixture)
    BASE, RTOL, assert_header_match, assert_records_match, ckpt_params,
    one_torch_thread, ref_params, rel, run_port, run_ref)

from repro_torch.launch import train as ptrain  # noqa: E402

STEPS = ["--steps", "8"]
RUNTIME = ["--runtime", "0.004,0.005:1e9,0.0003:1e10",
           "--straggler", "lognormal:0.8", "--deadline", "0.004", "--probes"]
POPULATION = ["--population", "10x10", "--sample-k", "4"]
MESH_RTOL = 1e-3     # tests/test_differential.py:247, the mesh's contract
MESH_ATOL = 1e-3


@pytest.fixture(scope="module")
def p0():
    return ref_params(0)


def _events(path):
    with open(path) as f:
        evs = json.load(f)
    evs = evs["traceEvents"] if isinstance(evs, dict) else evs
    return collections.Counter((e.get("name"), e.get("ph")) for e in evs)


def test_runtime_probes_trace(p0, tmp_path):
    argv = BASE + STEPS + RUNTIME
    ref = run_ref(argv + ["--trace", str(tmp_path / "ref.json")])
    port = run_port(argv + ["--trace", str(tmp_path / "port.json")], p0)
    assert_header_match(port, ref)
    assert_records_match(port["records"], ref["records"])
    assert any(r.get("dropped") for r in ref["records"])
    assert all("div_global" in r for r in ref["records"] if r["lvl"])
    assert port["runtime"] == ref["runtime"]
    assert _events(tmp_path / "port.json") == _events(tmp_path / "ref.json")


def test_population(p0):
    argv = BASE + STEPS + POPULATION + ["--log-every", "4"]
    ref, port = run_ref(argv), run_port(argv, p0)
    assert_header_match(port, ref)
    assert [r["step"] for r in port["records"]] == [4, 8]
    for p, r in zip(port["records"], ref["records"]):
        assert p["round"] == r["round"]
        assert p["participation"] == r["participation"]
        assert rel(p["loss"], r["loss"]) <= RTOL, (p, r)


def test_mesh_backend_matches_sim(tmp_path):
    argv = BASE + STEPS + ["--comms", "topk", "--ckpt-every", "4"]
    mesh = ptrain.main(argv + ["--backend", "mesh", "--ckpt-dir",
                               str(tmp_path / "mesh")], device="cpu")
    sim = ptrain.main(argv + ["--ckpt-dir", str(tmp_path / "sim")],
                      device="cpu")
    assert [r["step"] for r in mesh] == [r["step"] for r in sim] \
        == list(range(1, 9))
    for m, s in zip(mesh, sim):
        assert m["lvl"] == s["lvl"]
        assert m["wire_cum_bytes"] == s["wire_cum_bytes"]
        assert rel(m["loss"], s["loss"]) <= MESH_RTOL, (m, s)
    for step in (4, 8):
        gap = max(float(np.abs(a - b).max()) for a, b in zip(
            ckpt_params(tmp_path / "mesh", step),
            ckpt_params(tmp_path / "sim", step)))
        assert gap <= MESH_ATOL, (step, gap)
    # every rank restores the step-4 file and keeps its row: the resumed
    # run (its top-k residuals restart from zero, as in the reference)
    # against the sim resumed from the sim's step-4 file
    for run in ("mesh", "sim"):
        (tmp_path / f"{run}_part").mkdir()
        shutil.copy(tmp_path / run / "ckpt_00000004.msgpack",
                    tmp_path / f"{run}_part")
    mesh = ptrain.main(argv + ["--backend", "mesh", "--ckpt-dir",
                               str(tmp_path / "mesh_part")], device="cpu")
    sim = ptrain.main(argv + ["--ckpt-dir", str(tmp_path / "sim_part")],
                      device="cpu")
    assert [r["step"] for r in mesh] == [r["step"] for r in sim] == \
        [5, 6, 7, 8]
    for m, s in zip(mesh, sim):
        assert rel(m["loss"], s["loss"]) <= MESH_RTOL, (m, s)
    gap = max(float(np.abs(a - b).max()) for a, b in zip(
        ckpt_params(tmp_path / "mesh_part", 8),
        ckpt_params(tmp_path / "sim_part", 8)))
    assert gap <= MESH_ATOL, gap
