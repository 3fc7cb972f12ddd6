"""The port stands alone: no file of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, importing the port loads
no JAX, and every entry point refuses a CUDA device that is not there
instead of carrying on on the CPU."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def test_port_files_import_no_jax_and_no_reference():
    files = _port_files()
    assert len(files) >= 62
    bad = [(str(p.relative_to(ROOT)), m) for p in files
           for m in _imported_modules(p)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_port_files_import_no_msgpack():
    """The card's machine has no msgpack: the checkpoints' codec is the
    port's own (``repro_torch/checkpoint/_msgpack.py``)."""
    bad = [(str(p.relative_to(ROOT)), m) for p in _port_files()
           for m in _imported_modules(p) if m.split(".")[0] == "msgpack"]
    assert not bad, bad
    mods = set(_imported_modules(PORT / "checkpoint" / "ckpt.py"))
    assert "repro_torch.checkpoint" in mods


def test_the_scan_sees_imports():
    """Guard the guard: the scan must find the port's own imports."""
    mods = set(_imported_modules(PORT / "core" / "hsgd.py"))
    assert "torch" in mods and "repro_torch.core.topology" in mods


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import repro_torch.core, repro_torch.comms, repro_torch.data\n"
            "import repro_torch.models, repro_torch.optim\n"
            "import repro_torch.kernels.comms, repro_torch.kernels._build\n"
            "import repro_torch.kernels.attention, repro_torch.configs\n"
            "import repro_torch.kernels.ssd_scan\n"
            "import repro_torch.kernels.rglru_scan\n"
            "import repro_torch.models.transformer, repro_torch.serving\n"
            "import repro_torch.launch.serve, repro_torch.launch.mesh\n"
            "import repro_torch.core.divergence, repro_torch.core.theory\n"
            "import repro_torch.core.planner, repro_torch.experiments\n"
            "import repro_torch.experiments.common\n"
            "import repro_torch.runtime, repro_torch.population\n"
            "import repro_torch.experiments.bench_runtime\n"
            "import repro_torch.obs, repro_torch.obs.__main__\n"
            "import repro_torch.population.engine\n"
            "import repro_torch.experiments.bench_obs\n"
            "import repro_torch.experiments.bench_population\n"
            "import repro_torch.checkpoint, repro_torch.launch.train\n"
            "import repro_torch.data.synthetic\n"
            "import repro_torch.roofline, repro_torch.roofline.op_cost\n"
            "import repro_torch.experiments.roofline_table\n"
            "import repro_torch.experiments.run\n"
            "from repro_torch.experiments import (fig3_sandwich,\n"
            "    table2_time_to_acc, fig3c_grouping, fig_e4_participation,\n"
            "    fig_e8_multilevel, table1_bounds, plan_deployment)\n"
            "from repro_torch.examples import (quickstart, multilevel_hsgd,\n"
            "    population_hsgd, serve_decode, train_hsgd)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "assert 'msgpack' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the refusal "
                    "without one")


def test_entry_points_refuse_missing_cuda(no_cuda):
    from repro_torch.core import EngineConfig, HSGD, local_sgd, make_topology
    from repro_torch.device import resolve_device
    from repro_torch.experiments import (bench_obs, bench_population,
                                         common, fig3_sandwich,
                                         fig3c_grouping, fig_e4_participation,
                                         fig_e8_multilevel,
                                         table2_time_to_acc)
    from repro_torch.launch.mesh import launch
    from repro_torch.obs.__main__ import main as obs_main
    from repro_torch.models import (SimpleConfig, SimpleModel,
                                    params_from_numpy, params_to_numpy)
    from repro_torch.optim import sgd

    model = SimpleModel(SimpleConfig(kind="linear", input_dim=4,
                                     num_classes=3))
    engine = HSGD(model.loss, sgd(0.1),
                  make_topology("two_level", n=4, N=2, G=4, I=2))
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, device="cpu")
    world = common.make_world(8)
    sampled = HSGD(model.loss, sgd(0.1),
                   make_topology("two_level", n=4, N=2, G=4, I=2),
                   EngineConfig(population=(4, 4)))
    calls = [
        lambda: resolve_device(),
        lambda: model.init(gen),
        lambda: model.init(gen, device="cuda"),
        lambda: params_from_numpy(params_to_numpy(params)),
        lambda: engine.init(gen, model.init),
        lambda: engine.init_from_params(params),
        lambda: engine.init_from_params(params, device="cuda"),
        lambda: launch(print, 2),
        lambda: fig3_sandwich.main(),
        lambda: table2_time_to_acc.main(),
        lambda: fig3c_grouping.main(),
        lambda: fig_e4_participation.main(),
        lambda: fig_e8_multilevel.main(),
        lambda: fig_e4_participation.run(*world, local_sgd(8, 4), 1,
                                         0),
        lambda: common.trajectory(*world, make_topology(
            local_sgd(8, 4)), 1),
        lambda: common.steps_per_sec(*world, local_sgd(8, 4), T=1),
        lambda: fig3c_grouping.measured(*world, "cuda"),
        lambda: sampled.init_server(gen, model.init),
        lambda: sampled.init_server_from_params(params),
        lambda: bench_obs.main(),
        lambda: bench_population.main(),
        lambda: obs_main([]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_lm_entry_points_refuse_missing_cuda(no_cuda):
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.serve import main
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import build_model, params_from_numpy
    from repro_torch.models import params_to_numpy
    from repro_torch.serving import DecodeEngine

    model = build_model(reduced(get_config("qwen2-0.5b")))
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, device="cpu")
    calls = [
        lambda: model.init(gen),
        lambda: model.init(gen, device="cuda"),
        lambda: params_from_numpy(params_to_numpy(params)),
        lambda: DecodeEngine(model, params),
        lambda: model.init_cache(2, 8),
        lambda: main(["--arch", "qwen2-0.5b", "--reduced"]),
        lambda: train_main(["--arch", "qwen2-0.5b", "--reduced",
                            "--steps", "2"]),
        lambda: train_main(["--arch", "qwen2-0.5b", "--reduced",
                            "--steps", "2", "--backend", "mesh"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_examples_refuse_missing_cuda(no_cuda, tmp_path, monkeypatch):
    """Each twin of ``examples/`` asks for the card unless told
    ``device="cpu"``, and raises without one, before writing anything
    (train_hsgd neither to the paths it is given nor to a temporary
    directory of its own)."""
    import tempfile
    from repro_torch.examples import (multilevel_hsgd, population_hsgd,
                                      quickstart, serve_decode, train_hsgd)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    paths = {"--ckpt-dir": str(tmp_path / "ckpt"),
             "--out": str(tmp_path / "out.json")}
    calls = [quickstart.main, multilevel_hsgd.main, population_hsgd.main,
             serve_decode.main, lambda: train_hsgd.main(argv_overrides=paths),
             train_hsgd.main]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert not any(tmp_path.iterdir())


def test_chip_smoke_refuses_without_cuda(no_cuda, tmp_path):
    """Without a card, and alone in a directory, chip_smoke.py exits
    non-zero and prints no result line."""
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", alone / "chip_smoke.py")
    for cwd in (ROOT, alone):
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
