"""End-to-end run: H-SGD-train a reduced qwen2-family LM on the
synthetic token stream, with checkpoints, divergence telemetry and the
simulated-time runtime; the twin of the JAX package's
``examples/train_hsgd.py``: :func:`repro_torch.launch.train.main` with the
reference's argv, token for token.

    PYTHONPATH=src python -m repro_torch.examples.train_hsgd [--device cpu]

The run is 8 workers in 2 groups (G=8, I=2) for 120 steps, momentum, the
int8 codec at every sync (its ``int8_scale_quantize`` kernel on the card),
the runtime with lognormal stragglers and a sync deadline, and
checkpoints at steps 60 and 120.  As in the reference, an existing
``--ckpt-dir`` is resumed from; so unless the caller names them,
``--ckpt-dir`` and ``--out`` (the reference's fixed ``/tmp`` paths) are
replaced by paths in a fresh temporary directory, and every run starts
afresh.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import Dict, List, Optional

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import train

ARGV = (
    "--arch", "qwen2-0.5b", "--reduced",
    "--workers", "8", "--groups", "2", "--G", "8", "--I", "2",
    "--steps", "120", "--batch", "4", "--seq", "64",
    "--lr", "3e-3", "--optimizer", "momentum",
    "--comms", "int8",
    "--runtime", "0.004,0.005:1e9,0.0003:1e10",
    "--straggler", "lognormal:0.8",
    "--deadline", "0.004",
    "--log-every", "10", "--divergence-every", "40",
    "--ckpt-dir", "/tmp/hsgd_ckpt", "--ckpt-every", "60",
    "--out", "/tmp/hsgd_history.json",
)
# the flags a caller may replace: the paths the run writes
PATH_FLAGS = ("--ckpt-dir", "--out")


def argv(overrides: Optional[Dict[str, str]] = None) -> List[str]:
    """:data:`ARGV` with the values of ``overrides``' flags (of
    :data:`PATH_FLAGS` only) replaced."""
    overrides = dict(overrides or {})
    bad = sorted(set(overrides) - set(PATH_FLAGS))
    if bad:
        raise ValueError(f"train_hsgd: only {PATH_FLAGS} may be replaced, "
                         f"not {bad}")
    out = list(ARGV)
    for flag, value in overrides.items():
        out[out.index(flag) + 1] = str(value)
    return out


def main(device: DeviceLike = "cuda",
         argv_overrides: Optional[Dict[str, str]] = None) -> List[Dict]:
    """Train as the reference's example does; returns the history.  The
    paths of :data:`PATH_FLAGS` that ``argv_overrides`` does not name go
    to a fresh temporary directory, named on stderr."""
    resolve_device(device)      # no card: raise before writing anything
    overrides = dict(argv_overrides or {})
    if not set(PATH_FLAGS) <= set(overrides):
        tmp = tempfile.mkdtemp(prefix="hsgd-train-")
        print(f"train_hsgd: writing to {tmp}", file=sys.stderr)
        overrides.setdefault("--ckpt-dir", os.path.join(tmp, "ckpt"))
        overrides.setdefault("--out", os.path.join(tmp, "history.json"))
    return train.main(argv(overrides), device=device)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    main(args.device, {flag: value for flag, value in (
        ("--ckpt-dir", args.ckpt_dir), ("--out", args.out)) if value})
