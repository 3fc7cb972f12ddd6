"""Budget gating: diff live audit reports against a committed baseline
(PyTorch counterpart of ``repro.analysis.budget``, copied).

``ANALYSIS_budget_torch.json`` at the repo root pins, per audited
configuration, the comparable numbers of the port's sync plan — sync-op
counts, named axes, wire dtypes, payload bytes, round collective counts —
plus the accepted findings and the waivers that accept them.  (The
reference's ``ANALYSIS_budget.json`` is its own record; the parity tests
read it and nothing writes it.)  ``python -m repro_torch.analysis --check``
re-audits and fails on any **regression**:

* a new sync event / round signature, or a config missing from the budget
* sync-op or round-collective count growth (new collectives)
* a new operand dtype on a sync op (dtype upcasts)
* payload byte growth (per event or in the declared WireStats payload)
* a changed named-axis set (traffic crossing different mesh links)
* host reads / transfers beyond the recorded count
* any unwaived rule finding, and any finding not recorded in the budget

Shrinking numbers are reported as **improvements** — the check still
passes, with a note to re-pin via ``--update`` so the better numbers become
the new floor.  ``--update`` MERGES: waivers and entries for configs not
re-audited in this run (``--configs`` filters) are preserved verbatim.

Waiver format: ``budget["waivers"]`` maps an ``fnmatch`` config pattern to
``{rule_id: reason}`` — e.g. ``"*grouped*": {"R1": "..."}``.  The
compressed-collective configs (int8, sign) are deliberately un-waivable:
their R2 burn-down is done, and :func:`check_reports` treats any waiver
pattern that would re-cover them as a regression so the debt cannot quietly
return.
"""
from __future__ import annotations

import json
from fnmatch import fnmatch
from pathlib import Path
from typing import Any, Dict, Iterable, List, Tuple

from repro_torch.analysis.report import SyncPlanReport

BUDGET_FILE = "ANALYSIS_budget_torch.json"
# the reference's own budget: read by the parity tests, never written
REFERENCE_BUDGET_FILE = "ANALYSIS_budget.json"

# Configs whose R2 burn-down is complete: the compressed-collective lowering
# keeps the wire dtype on the collective, so re-waiving them (on any
# backend) would hide a real regression.  Probed with fnmatch against every
# waiver pattern in check_reports.
_UNWAIVABLE_PROBES = (
    "sim/two_level/int8", "mesh/two_level/int8",
    "sim/two_level/sign", "mesh/two_level/sign",
)


def load_budget(path) -> Dict[str, Any]:
    path = Path(path)
    if not path.is_file():
        return {"version": 1, "waivers": {}, "configs": {}}
    return json.loads(path.read_text(encoding="utf-8"))


def save_budget(path, budget: Dict[str, Any]) -> None:
    if Path(path).name == REFERENCE_BUDGET_FILE:
        raise ValueError(f"{REFERENCE_BUDGET_FILE} is the JAX package's "
                         f"record; the port's budget is {BUDGET_FILE}")
    Path(path).write_text(json.dumps(budget, indent=2, sort_keys=True) + "\n",
                          encoding="utf-8")


def waivers_for(budget: Dict[str, Any], config: str) -> Dict[str, str]:
    """Merge every waiver pattern matching ``config`` (specific patterns
    listed later override earlier ones on rule-id collisions)."""
    out: Dict[str, str] = {}
    for pattern, rules in (budget.get("waivers") or {}).items():
        if fnmatch(config, pattern):
            out.update(rules)
    return out


def entry_from_report(report: SyncPlanReport) -> Dict[str, Any]:
    """The comparable (budget-pinned) projection of a report."""
    return {
        "executor": report.executor,
        "codec": report.codec,
        "events": {k: {
            "sync_ops": ev.sync_ops,
            "axes": sorted(ev.axes),
            "wire_dtypes": sorted(ev.wire_dtypes),
            "payload_bytes": ev.payload_bytes,
        } for k, ev in sorted(report.events.items())},
        "rounds": {k: {
            "collective_count": rnd.collective_count,
            "callbacks": len(rnd.callbacks),
            "transfers": len(rnd.transfers),
        } for k, rnd in sorted(report.rounds.items())},
        "wire": None if report.wire is None else {
            "payload_bytes": report.wire["payload_bytes"],
            "wire_dtypes": sorted(report.wire["wire_dtypes"]),
        },
        "probes": None if report.probes is None else {
            "budget": report.probes.get("budget", 0),
            "rounds": {k: dict(v) for k, v in
                       sorted(report.probes.get("rounds", {}).items())},
        },
        "findings": sorted(f"{f.rule}:{f.subject}" for f in report.findings),
    }


def _diff_num(regs, imps, where: str, what: str, now: int, pinned: int):
    if now > pinned:
        regs.append(f"{where}: {what} grew {pinned} -> {now}")
    elif now < pinned:
        imps.append(f"{where}: {what} shrank {pinned} -> {now}")


def _diff_set(regs, imps, where: str, what: str, now, pinned):
    new, gone = sorted(set(now) - set(pinned)), sorted(set(pinned) - set(now))
    if new:
        regs.append(f"{where}: new {what} {new}")
    if gone:
        imps.append(f"{where}: {what} {gone} no longer present")


def diff_entry(config: str, entry: Dict[str, Any],
               pinned: Dict[str, Any]) -> Tuple[List[str], List[str]]:
    """(regressions, improvements) of a live entry vs its pinned baseline."""
    regs: List[str] = []
    imps: List[str] = []
    for kind in ("events", "rounds"):
        now, old = entry.get(kind, {}), pinned.get(kind, {})
        for key in sorted(set(now) - set(old)):
            regs.append(f"{config}: new {kind[:-1]} signature '{key}'")
        for key in sorted(set(old) - set(now)):
            imps.append(f"{config}: {kind[:-1]} '{key}' disappeared")
    for key in sorted(set(entry.get("events", {})) &
                      set(pinned.get("events", {}))):
        now, old = entry["events"][key], pinned["events"][key]
        where = f"{config} sync {key}"
        _diff_num(regs, imps, where, "sync ops", now["sync_ops"],
                  old["sync_ops"])
        _diff_set(regs, imps, where, "wire dtype(s)", now["wire_dtypes"],
                  old["wire_dtypes"])
        _diff_num(regs, imps, where, "payload bytes", now["payload_bytes"],
                  old["payload_bytes"])
        if sorted(now["axes"]) != sorted(old["axes"]):
            regs.append(f"{where}: named axes changed "
                        f"{old['axes']} -> {now['axes']}")
    for key in sorted(set(entry.get("rounds", {})) &
                      set(pinned.get("rounds", {}))):
        now, old = entry["rounds"][key], pinned["rounds"][key]
        where = f"{config} round {key}"
        _diff_num(regs, imps, where, "collectives", now["collective_count"],
                  old["collective_count"])
        _diff_num(regs, imps, where, "host callbacks", now["callbacks"],
                  old["callbacks"])
        _diff_num(regs, imps, where, "device transfers", now["transfers"],
                  old["transfers"])
    if entry.get("wire") and pinned.get("wire"):
        where = f"{config} wire"
        _diff_num(regs, imps, where, "declared payload bytes",
                  entry["wire"]["payload_bytes"],
                  pinned["wire"]["payload_bytes"])
        _diff_set(regs, imps, where, "declared wire dtype(s)",
                  entry["wire"]["wire_dtypes"], pinned["wire"]["wire_dtypes"])
    if entry.get("probes") and pinned.get("probes"):
        # pinned probe-overhead floor: extra ops per round may only shrink;
        # callbacks/transfers are additionally hard-zeroed by rule R6
        now_r = entry["probes"].get("rounds", {})
        old_r = pinned["probes"].get("rounds", {})
        for key in sorted(set(now_r) & set(old_r)):
            where = f"{config} probes {key}"
            _diff_num(regs, imps, where, "extra probe ops",
                      now_r[key].get("extra_ops", 0),
                      old_r[key].get("extra_ops", 0))
        _diff_num(regs, imps, f"{config} probes", "declared op budget",
                  entry["probes"].get("budget", 0),
                  pinned["probes"].get("budget", 0))
    _diff_set(regs, imps, config, "finding(s)", entry.get("findings", ()),
              pinned.get("findings", ()))
    return regs, imps


def check_reports(reports: Iterable[SyncPlanReport],
                  budget: Dict[str, Any]) -> Tuple[List[str], List[str]]:
    """Diff every report against the budget.  Returns (regressions,
    improvements); a check passes iff regressions is empty."""
    regs: List[str] = []
    imps: List[str] = []
    configs = budget.get("configs", {})
    for pattern, rules in (budget.get("waivers") or {}).items():
        hit = sorted(p for p in _UNWAIVABLE_PROBES if fnmatch(p, pattern))
        if hit:
            regs.append(
                f"waiver pattern '{pattern}' ({'/'.join(sorted(rules))}) "
                f"covers compressed-collective config(s) {hit} — their R2 "
                f"burn-down is complete and may not be re-waived")
    for report in reports:
        for f in report.unwaived:
            regs.append(f"{report.config}: unwaived finding {f.rule} "
                        f"{f.subject}: {f.message}")
        if report.config not in configs:
            regs.append(f"{report.config}: not in budget (run --update)")
            continue
        r, i = diff_entry(report.config, entry_from_report(report),
                          configs[report.config])
        regs += r
        imps += i
    return regs, imps


def update_budget(budget: Dict[str, Any],
                  reports: Iterable[SyncPlanReport]) -> Dict[str, Any]:
    """Re-pin the audited configs; everything else (waivers, configs not in
    ``reports``) carries over unchanged."""
    configs = dict(budget.get("configs", {}))
    for report in reports:
        configs[report.config] = entry_from_report(report)
    return {"version": budget.get("version", 1),
            "waivers": dict(budget.get("waivers", {})),
            "configs": configs}
