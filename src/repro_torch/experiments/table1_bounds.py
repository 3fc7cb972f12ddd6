"""Table 1: numeric comparison of convergence bounds across the literature
(counterpart of the JAX package's ``benchmarks/table1_bounds.py``; numpy
only, runs on the host).

Evaluates every row's O-expression (unit constants) on a grid and reports the
fraction of the grid where ours is the tightest applicable bound, plus the
paper's three headline comparisons (vs Yu'19 general, vs Liu'20 at sigma=0,
vs Castiglia'21 at eps=0).

    PYTHONPATH=src python -m repro_torch.experiments.table1_bounds
"""
from __future__ import annotations

import itertools

from repro_torch.core import theory as th


def rows(quick: bool = True):
    ns = [16, 64] if quick else [16, 32, 64, 128]
    Ts = [2_000, 20_000]
    GIs = [(20, 5), (50, 5), (50, 10)]
    s2e2 = [(1.0, 1.0), (0.5, 2.0)]
    out = []
    wins_yu = wins_liu = wins_cast = total = 0
    for n, T, (G, I), (s2, e2) in itertools.product(ns, Ts, GIs, s2e2):
        N = max(2, n // 8)
        ours = th.table1_ours(n, N, T, G, I, s2, e2)
        yu = th.table1_yu2019(n, T, G, s2, e2)
        cast = th.table1_castiglia2021(n, T, G, I, s2)
        ours_s0 = th.table1_ours(n, N, T, G, I, 0.0, e2)
        liu_s0 = th.table1_liu2020(n, T, G, e2)
        ours_e0 = th.table1_ours(n, N, T, G, I, s2, 0.0)
        total += 1
        wins_yu += ours < yu
        wins_liu += ours_s0 < liu_s0
        wins_cast += ours_e0 < cast
        out.append({"n": n, "N": N, "T": T, "G": G, "I": I,
                    "sigma2": s2, "eps2": e2,
                    "ours": ours, "yu2019": yu,
                    "ours_sigma0": ours_s0, "liu2020_sigma0": liu_s0,
                    "ours_eps0": ours_e0, "castiglia2021_eps0": cast})
    summary = {"grid_points": total,
               "ours_tighter_than_yu2019": wins_yu / total,
               "ours_tighter_than_liu2020": wins_liu / total,
               "ours_tighter_than_castiglia2021": wins_cast / total}
    return out, summary


def main(quick: bool = True):
    table, summary = rows(quick)
    print("# Table 1 — bound comparison (unit-constant O-expressions)")
    hdr = list(table[0].keys())
    print(",".join(hdr))
    for r in table[:8]:
        print(",".join(f"{r[k]:.4g}" if isinstance(r[k], float) else str(r[k])
                       for k in hdr))
    print("summary:", summary)
    assert summary["ours_tighter_than_yu2019"] == 1.0
    assert summary["ours_tighter_than_liu2020"] == 1.0
    assert summary["ours_tighter_than_castiglia2021"] == 1.0
    return summary


if __name__ == "__main__":
    main()
