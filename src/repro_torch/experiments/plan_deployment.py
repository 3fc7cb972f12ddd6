"""Deployment planning: choose (N, G, I) from Theorem 2 + a measured
communication-cost model (the paper's conclusion, made executable);
counterpart of the JAX package's ``examples/plan_deployment.py``, numpy
only, on the host.

    PYTHONPATH=src python -m repro_torch.experiments.plan_deployment
"""
from __future__ import annotations

from repro_torch.core import (CommModel, best_under_budget, enumerate_plans,
                              pareto_front)


def main():
    # paper Table E.1, CNN: near round 0.29 ms, far round 4.53 ms, 4 ms/iter
    comm = CommModel(compute_s=0.004, local_round_s=0.00029,
                     global_round_s=0.00453)

    plans = enumerate_plans(
        n=64, T=20_000, L=1.0, sigma2=1.0, eps_tilde2=1.0,
        f0_minus_fstar=2.0, comm=comm)

    front = pareto_front(plans)
    print(f"{len(plans)} candidate (N, G, I) plans; Pareto front "
          "(wall-clock vs Theorem-2 bound):")
    print(f"{'N':>3} {'G':>4} {'I':>3} {'bound':>10} {'wall(s)':>9}")
    for p in front[:12]:
        print(f"{p.N:>3} {p.G:>4} {p.I:>3} {p.bound:>10.4f} {p.wall_s:>9.1f}")

    budget = min(p.wall_s for p in plans) * 1.10
    best = best_under_budget(plans, budget)
    print(f"\nbest plan within {budget:.1f}s wall-clock: "
          f"N={best.N}, G={best.G}, I={best.I} "
          f"(bound {best.bound:.4f}, wall {best.wall_s:.1f}s) — note I < G: "
          "the planner rediscovers the paper's 'frequent local, rare global'.")
    return {"plans": len(plans), "pareto": len(front), "budget_s": budget,
            "best": {"N": best.N, "G": best.G, "I": best.I,
                     "bound": best.bound, "wall_s": best.wall_s}}


if __name__ == "__main__":
    main()
