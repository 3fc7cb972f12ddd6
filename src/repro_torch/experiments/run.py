"""Experiment entrypoint: the twin of ``benchmarks/run.py``, one function
per paper table/figure, through the port's twins.

Prints a ``name,us_per_call,derived`` CSV summary line per experiment (the
per-experiment detail CSVs print above each summary).  Run:

    PYTHONPATH=src python -m repro_torch.experiments.run [--full] \\
        [--only NAME] [--device cpu|cuda]
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.experiments import (fig3_sandwich, fig3c_grouping,
                                     fig_e4_participation,
                                     fig_e8_multilevel, roofline_table,
                                     table1_bounds, table2_time_to_acc)

# (name, main(quick, device)): table1 and the roofline table run on the
# host and take no device
BENCHES = [
    ("table1_bounds", lambda quick, device: table1_bounds.main(quick)),
    ("fig3_sandwich", fig3_sandwich.main),
    ("fig3c_grouping", fig3c_grouping.main),
    ("table2_time_to_acc", table2_time_to_acc.main),
    ("fig_e8_multilevel", fig_e8_multilevel.main),
    ("fig_e4_participation", fig_e4_participation.main),
    ("roofline_table", lambda quick, device: roofline_table.main(quick)),
]


def main(argv=None):
    """Run the experiments; returns the summary rows (name, us, derived)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="longer runs / more seeds")
    ap.add_argument("--only", default="")
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    args = ap.parse_args(argv)

    summary = []
    for name, fn in BENCHES:
        if args.only and args.only not in name:
            continue
        print(f"\n===== {name} =====")
        t0 = time.time()
        derived = fn(quick=not args.full, device=args.device)
        us = (time.time() - t0) * 1e6
        summary.append((name, us, derived))

    print("\n# summary")
    print("name,us_per_call,derived")
    for name, us, derived in summary:
        d = json.dumps(derived, default=str)[:160].replace(",", ";")
        print(f"{name},{us:.0f},{d}")
    return summary


if __name__ == "__main__":
    main()
