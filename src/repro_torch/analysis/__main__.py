"""``python -m repro_torch.analysis`` — audit the reference configs and
gate on the committed budget (PyTorch counterpart of
``repro.analysis.__main__``).

The config matrix is the reference's 15: sim and mesh executors, two- and
three-level schedules, comms off / identity / compressing (int8, sign), a
momentum run (optimizer moments on the wire), the mesh ``exact=True``
replay, and metrics-on ``probes`` configs (the R6 overhead contract of the
divergence probe, on both backends).  The sim configs run in this process
on ``--device``; the six mesh configs run in ONE spawn of eight ``gloo``
ranks (:func:`repro_torch.launch.mesh.launch`, every rank on the one card
or on the CPU), and rank 0 hands their reports back.  A mesh collective
stages its operand through the host under ``gloo``: that is the port's
design on one card, counted as the collective, not as a transfer.

    python -m repro_torch.analysis                  # print the summaries
    python -m repro_torch.analysis --check          # diff vs the budget
    python -m repro_torch.analysis --update         # re-pin (merge)
    python -m repro_torch.analysis --out r.json     # dump the full reports
    python -m repro_torch.analysis --device cpu     # plain versions, CPU

``--device`` defaults to ``cuda``: the card, with the kernels.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis import (BUDGET_FILE, check_reports, load_budget,
                                  save_budget, update_budget)
from repro_torch.analysis.matrix import (CONFIGS,  # noqa: F401
                                         build_engine, run_audits)

ROOT = Path(__file__).resolve().parents[3]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="collective audit of the reference engine configs")
    ap.add_argument("--check", action="store_true",
                    help="fail (exit 1) on any budget regression")
    ap.add_argument("--update", action="store_true",
                    help="re-pin the audited configs in the budget (merge)")
    ap.add_argument("--budget", default=str(ROOT / BUDGET_FILE),
                    help=f"budget path (default: repo-root {BUDGET_FILE})")
    ap.add_argument("--out", default=None,
                    help="also write the full SyncPlanReport JSON here")
    ap.add_argument("--configs", default="",
                    help="comma-separated fnmatch filters (default: all)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, with the kernels; default) or cpu "
                         "(their plain versions)")
    args = ap.parse_args(argv)

    budget = load_budget(args.budget)
    patterns = [p for p in args.configs.split(",") if p]
    reports = run_audits(budget, patterns, args.device)

    for report in reports:
        print(report.summary())

    if args.out:
        payload = {"device": args.device,
                   "configs": {r.config: r.to_dict() for r in reports}}
        Path(args.out).write_text(json.dumps(payload, indent=2) + "\n",
                                  encoding="utf-8")
        print(f"wrote {args.out}")

    if args.update:
        save_budget(args.budget, update_budget(budget, reports))
        print(f"budget updated: {args.budget}")
        return 0

    regs, imps = check_reports(reports, budget)
    for msg in imps:
        print(f"IMPROVED  {msg}  (re-pin with --update)")
    for msg in regs:
        print(f"REGRESSED {msg}")
    if args.check and regs:
        print(f"collective audit: {len(regs)} regression(s)")
        return 1
    if args.check:
        print(f"collective audit: OK ({len(reports)} config(s), "
              f"{len(imps)} improvement note(s))")
    return 0


if __name__ == "__main__":
    sys.exit(main())
