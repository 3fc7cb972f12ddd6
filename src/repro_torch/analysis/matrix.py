"""The audit's config matrix (PyTorch counterpart of the matrix in
``repro.analysis.__main__``): the reference's 15 configs, their engines,
and the run that audits them — the sim configs in this process, the six
mesh configs in one launch of eight ``gloo`` ranks, whose rank function
must live in an importable module (the spawned ranks import it)."""
from __future__ import annotations

from fnmatch import fnmatch

import torch

from repro_torch.analysis.budget import waivers_for
from repro_torch.analysis.engine import audit_engine
from repro_torch.analysis.report import SyncPlanReport
from repro_torch.device import resolve_device

MESH_WORKERS = 8

# one global period: two_level = (8 workers) 2 pods x 4, sync L2 every 4
# steps, L1 every 8; three_level adds an L3 sync every 2
_SPECS = {
    "two_level": ((2, 4), (8, 4)),
    "three_level": ((2, 2, 2), (8, 4, 2)),
}

# name -> (spec, executor, comms, optimizer, metrics)
CONFIGS = {
    "sim/two_level/off": ("two_level", "sim", None, "sgd", None),
    "sim/two_level/identity": ("two_level", "sim", "identity", "sgd", None),
    "sim/two_level/int8": ("two_level", "sim", "int8", "sgd", None),
    "sim/two_level/sign": ("two_level", "sim", "sign", "sgd", None),
    "sim/two_level/momentum-int8":
        ("two_level", "sim", "int8", "momentum", None),
    "sim/three_level/off": ("three_level", "sim", None, "sgd", None),
    "sim/three_level/int8": ("three_level", "sim", "int8", "sgd", None),
    "sim/two_level/probes": ("two_level", "sim", None, "sgd", "on"),
    "sim/three_level/probes": ("three_level", "sim", None, "sgd", "on"),
    "mesh/two_level/off": ("two_level", "mesh", None, "sgd", None),
    "mesh/two_level/identity": ("two_level", "mesh", "identity", "sgd", None),
    "mesh/two_level/int8": ("two_level", "mesh", "int8", "sgd", None),
    "mesh/two_level/sign": ("two_level", "mesh", "sign", "sgd", None),
    "mesh/two_level/exact-off": ("two_level", "mesh-exact", None, "sgd", None),
    "mesh/two_level/probes": ("two_level", "mesh", None, "sgd", "on"),
}


def build_engine(config: str, device="cuda"):
    """(engine, state, batch_fn) for one matrix entry — a tiny MLP so the
    whole audit is recording, not training.  A mesh entry needs the
    default process group of its eight ranks (see :func:`run_audits`)."""
    from repro_torch.core import EngineConfig, HSGD
    from repro_torch.core.executors import MeshExecutor
    from repro_torch.core.topology import HierarchySpec, make_topology
    from repro_torch.models.simple import SimpleConfig, SimpleModel
    from repro_torch.optim.optimizers import momentum, sgd

    spec_name, executor, comms, opt_name, metrics = CONFIGS[config]
    sizes, periods = _SPECS[spec_name]
    topo = make_topology("uniform", spec=HierarchySpec(sizes, periods))
    model = SimpleModel(SimpleConfig(kind="mlp", input_dim=16, hidden=8,
                                     num_classes=4))
    if executor == "mesh-exact":
        executor = MeshExecutor(exact=True)
    opt = momentum(0.1) if opt_name == "momentum" else sgd(0.1)
    eng = HSGD(model.loss, opt, topo,
               EngineConfig(executor=executor, comms=comms, metrics=metrics))
    state = eng.init(torch.Generator().manual_seed(0), model.init,
                     device=device)
    n = topo.n

    def batch_fn(t):
        x = torch.randn((n, 4, 16), generator=torch.Generator()
                        .manual_seed(t))
        return {"x": x, "y": torch.zeros((n, 4), dtype=torch.int32)}

    return eng, state, batch_fn


def audit_config(config: str, budget, device) -> SyncPlanReport:
    """The report of one matrix entry on ``device``, with the budget's
    waivers for it."""
    eng, state, batch_fn = build_engine(config, device)
    return audit_engine(eng, state, batch_fn, config=config,
                        waivers=waivers_for(budget, config))


def _mesh_rank(rank: int, configs, budget, device: str):
    """One rank of the mesh leg: every rank audits every config (the
    collectives need them all); rank 0's reports come back as dicts."""
    reports = [audit_config(c, budget, device).to_dict() for c in configs]
    return reports if rank == 0 else None


def run_audits(budget, patterns, device="cuda"):
    """The reports of the matrix entries matching ``patterns`` (all when
    empty): the sim ones here, the mesh ones in one launch of eight
    ``gloo`` ranks."""
    chosen = [c for c in CONFIGS
              if not patterns or any(fnmatch(c, p) for p in patterns)]
    dev = resolve_device(device)
    reports = [audit_config(c, budget, dev) for c in chosen
               if not c.startswith("mesh/")]
    mesh = [c for c in chosen if c.startswith("mesh/")]
    if mesh:
        from repro_torch.launch.mesh import launch
        dicts = launch(_mesh_rank, MESH_WORKERS, backend="gloo",
                       device=str(dev), args=(mesh, budget, str(dev)))
        reports += [SyncPlanReport.from_dict(d) for d in dicts]
    order = {c: i for i, c in enumerate(CONFIGS)}
    return sorted(reports, key=lambda r: order[r.config])
