"""Roofline table: the twin of ``benchmarks/roofline_table.py``.

Renders the port's dry-run cache (``build/dryrun_torch.json``, which
``python -m repro_torch.launch.dryrun`` writes) into the per-(arch x shape
x mesh) three-term table, per H100 (:class:`repro_torch.roofline.HW`).
The records are the reference's: ``"arch|shape|mesh"`` keys, each with
``steps`` (every recorded step's ``RooflineReport.asdict()``), ``terms_s``,
``dominant``, ``useful_ratio``, ``mapping``, ``n_workers`` and, for
training, ``amortized``.  A step recorded on ``meta`` has no peak memory;
its record's ``rank0_resident_bytes`` (rank 0's local state and batch
shards) stands in for it in ``fits_hbm``.  :func:`save` writes such a
cache (``chip_smoke.py`` writes the card's priced calls with it) and
refuses the reference's own file.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

from repro_torch.roofline import HW

HBM_PER_CHIP = HW().hbm_bytes   # H100 SXM, 80 GB
DEFAULT = "build/dryrun_torch.json"
REFERENCE_FILE = "dryrun.json"


def load(path: str = DEFAULT) -> Dict:
    with open(path) as f:
        return json.load(f)


def save(results: Dict, path: str = DEFAULT) -> None:
    """Write ``results`` (records as above) to ``path``."""
    if os.path.basename(path) == REFERENCE_FILE:
        raise ValueError(f"{REFERENCE_FILE} is the JAX package's dry-run "
                         f"cache; the port writes its own ({DEFAULT})")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(results, f, indent=1)


def rows(results: Dict) -> List[Dict]:
    out = []
    for key, rec in sorted(results.items()):
        arch, shape, mesh = key.split("|")
        steps = rec["steps"]
        head_name = "global_sync" if "global_sync" in steps else \
            next(iter(steps))
        head = steps[head_name]
        peak = head.get("peak_memory_bytes") or 0
        held = peak or rec.get("rank0_resident_bytes") or 0
        row = {
            "arch": arch, "shape": shape, "mesh": mesh,
            "mapping": rec.get("mapping") or "-",
            "n_workers": rec.get("n_workers") or "-",
            "compute_s": rec["terms_s"]["compute"],
            "memory_s": rec["terms_s"]["memory"],
            "collective_s": rec["terms_s"]["collective"],
            "dominant": rec["dominant"],
            "useful_ratio": rec.get("useful_ratio", 0.0),
            "peak_gb": peak / 1e9,
            "fits_hbm": held <= HBM_PER_CHIP,
        }
        if "amortized" in rec:
            row["amortized_dominant"] = rec["amortized"]["dominant"]
        out.append(row)
    return out


def main(quick: bool = True, path: str = DEFAULT):
    if not os.path.exists(path):
        print(f"(roofline) no dry-run cache at {path}; run "
              "the port's dry run first (python -m repro_torch.launch."
              "dryrun)")
        return []
    rs = rows(load(path))
    cols = ["arch", "shape", "mesh", "mapping", "dominant", "compute_s",
            "memory_s", "collective_s", "useful_ratio", "peak_gb", "fits_hbm"]
    print("# Roofline table (per card, H100 SXM constants; decode/prefill = "
          "one serve step, train = global-sync step)")
    print(",".join(cols))
    for r in rs:
        print(",".join(
            f"{r[c]:.4g}" if isinstance(r[c], float) else str(r[c])
            for c in cols))
    doms = {}
    for r in rs:
        doms[r["dominant"]] = doms.get(r["dominant"], 0) + 1
    print("dominant-term histogram:", doms)
    return rs


if __name__ == "__main__":
    main()
