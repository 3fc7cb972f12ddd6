"""repro_torch.analysis — the collective auditor and sync-plan linter
(PyTorch counterpart of ``repro.analysis``).

A pass over what the engine's programs ship: the recorder (:mod:`.walker`)
runs one call under a dispatch mode and turns it into plain op records;
the engine (:mod:`.engine`) records a live :class:`~repro_torch.core.hsgd.
HSGD` into a :class:`~repro_torch.analysis.report.SyncPlanReport`; the
rules (:mod:`.rules`) lint the report (R1 sync-op count, R2 wire-dtype
honesty, R3 host-free round body, R4 rebuild detection, R5 wire-accounting
cross-check, R6 probe overhead); the budget (:mod:`.budget`) diffs reports
against the committed ``ANALYSIS_budget_torch.json`` so that new
collectives, dtype upcasts or byte growth fail the check.  Entry points:
``eng.audit(state, batch_fn)`` and ``python -m repro_torch.analysis
--check`` (see README.md, "Static analysis").
"""
from repro_torch.analysis.budget import (BUDGET_FILE, REFERENCE_BUDGET_FILE,
                                         check_reports, diff_entry,
                                         entry_from_report, load_budget,
                                         save_budget, update_budget,
                                         waivers_for)
from repro_torch.analysis.engine import audit_engine, event_key, round_key
from repro_torch.analysis.report import (EventAudit, Finding, RoundAudit,
                                         SyncPlanReport)
from repro_torch.analysis.rules import RULES, run_rules
from repro_torch.analysis.walker import (CALLBACK_PRIMS, COLLECTIVE_PRIMS,
                                         REDUCE_PRIMS, TRANSFER_PRIMS,
                                         JaxprSummary, OpRecord, fingerprint,
                                         record, trace)

__all__ = [
    "record", "trace", "fingerprint", "JaxprSummary", "OpRecord",
    "COLLECTIVE_PRIMS", "CALLBACK_PRIMS", "TRANSFER_PRIMS", "REDUCE_PRIMS",
    "EventAudit", "RoundAudit", "Finding", "SyncPlanReport",
    "RULES", "run_rules",
    "audit_engine", "event_key", "round_key",
    "BUDGET_FILE", "REFERENCE_BUDGET_FILE", "load_budget", "save_budget",
    "waivers_for", "entry_from_report", "diff_entry", "check_reports",
    "update_budget",
]
