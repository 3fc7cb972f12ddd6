"""Numerical evaluation of every convergence bound in the paper.

Theorem 1 (two-level, fixed grouping), Corollary 1 (local SGD), Theorem 2
(random grouping), Theorem 3 (multi-level, random grouping), Lemmas 1-3, the
sandwich inequalities (16)(17)(23)(24), and the Table-1 comparison rows
(Yu et al. 2019, Liu et al. 2020, Castiglia et al. 2021).

Everything returns plain floats so the benchmark harness can emit Table 1 and
property tests can assert the algebra (recovery when N=1, sandwich, ...).
Numpy-only: a copy of ``repro.core.theory``, held bit for bit to it by the
tests.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

C_CONST = 40.0 / 3.0  # the paper's C


# ---------------------------------------------------------------------------
# Theorem 1: two-level, fixed (possibly non-uniform) grouping
# ---------------------------------------------------------------------------
def theorem1_bound(*, gamma: float, T: int, L: float, sigma2: float,
                   f0_minus_fstar: float, n: int, G: int,
                   group_sizes: Sequence[int], I_periods: Sequence[int],
                   eps_up2: float, eps_down2: Sequence[float]) -> float:
    """Eq. (11a)-(11c). Requires gamma < 1/(2 sqrt(6) G L)."""
    N = len(group_sizes)
    assert len(I_periods) == N and len(eps_down2) == N
    assert sum(group_sizes) == n
    c = C_CONST
    t11a = 2.0 * f0_minus_fstar / (gamma * T) + gamma * L * sigma2 / n
    t11b = (2.0 * c * gamma**2 * L**2 * G * (N - 1) / n * sigma2
            + 3.0 * c * gamma**2 * L**2 * G**2 * eps_up2)
    t11c = 0.0
    for ni, Ii, ei2 in zip(group_sizes, I_periods, eps_down2):
        t11c += 2.0 * c * gamma**2 * L**2 * sigma2 * (ni - 1) * Ii / n
        t11c += 3.0 * c * gamma**2 * L**2 * (ni / n) * Ii**2 * ei2
    return t11a + t11b + t11c


def corollary1_local_sgd_bound(*, gamma: float, T: int, L: float, sigma2: float,
                               f0_minus_fstar: float, n: int, P: int,
                               eps_tilde2: float) -> float:
    """Eq. (12): Theorem 1 with N=1 (single group of size n, I_1 = P = G)."""
    return theorem1_bound(
        gamma=gamma, T=T, L=L, sigma2=sigma2, f0_minus_fstar=f0_minus_fstar,
        n=n, G=P, group_sizes=[n], I_periods=[P],
        eps_up2=0.0, eps_down2=[eps_tilde2])


def lr_cap(G: int, L: float) -> float:
    return 1.0 / (2.0 * math.sqrt(6.0) * G * L)


# ---------------------------------------------------------------------------
# Lemmas 1 & 2 (random grouping divergence expectations)
# ---------------------------------------------------------------------------
def lemma1_rhs(n: int, N: int, eps_tilde2: float) -> float:
    return (N - 1) / (n - 1) * eps_tilde2


def lemma2_rhs(n: int, N: int, eps_tilde2: float) -> float:
    return (1.0 - (N - 1) / (n - 1)) * eps_tilde2


# ---------------------------------------------------------------------------
# Theorem 2: two-level random grouping (equal group sizes, common I)
# ---------------------------------------------------------------------------
def theorem2_bound(*, gamma: float, T: int, L: float, sigma2: float,
                   f0_minus_fstar: float, n: int, N: int, G: int, I: int,
                   eps_tilde2: float) -> float:
    c = C_CONST
    base = 2.0 * f0_minus_fstar / (gamma * T) + gamma * L * sigma2 / n
    noise = 2.0 * c * gamma**2 * L**2 * (
        (N - 1) / n * G + (1.0 - N / n) * I) * sigma2
    div = 3.0 * c * gamma**2 * L**2 * (
        (N - 1) / (n - 1) * G**2 + (1.0 - (N - 1) / (n - 1)) * I**2) * eps_tilde2
    return base + noise + div


def sandwich_noise_terms(n: int, N: int, G: int, I: int):
    """Eq. (16): ((1-1/n) I, middle, (1-1/n) G)."""
    mid = (N - 1) / n * G + (1.0 - N / n) * I
    return ((1.0 - 1.0 / n) * I, mid, (1.0 - 1.0 / n) * G)


def sandwich_div_terms(n: int, N: int, G: int, I: int):
    """Eq. (17): (I^2, middle, G^2)."""
    mid = (N - 1) / (n - 1) * G**2 + (1.0 - (N - 1) / (n - 1)) * I**2
    return (float(I**2), mid, float(G**2))


def remark5_ok(n: int, N: int, G: int, I: int, l: float, q: float) -> bool:
    """Remark 5 feasibility: G'=lG, I'=qI improves the bound's div terms."""
    m = G // I
    lmax = math.sqrt((1.0 / m**2) * (n - N) / N + 1.0)
    if not (1.0 < l < lmax):
        return False
    qmax = math.sqrt(max(0.0, 1.0 - m**2 * (l**2 - 1.0) * N / (n - N)))
    return q <= qmax


# ---------------------------------------------------------------------------
# Theorem 3: multi-level random grouping
# ---------------------------------------------------------------------------
def theorem3_A1(level: int, periods: Sequence[int],
                group_sizes: Sequence[int]) -> float:
    """A_1(l) = P_1 (1/prod_{j>l} N_j - 1/n) + P_{l+1} (1 - 1/prod_{j>l} N_j).

    NOTE on indexing: the paper prints prod_{j=l}^M and P_l, but that reading
    does NOT reduce to Theorem 2 at M=2 (it gives the sandwich's upper
    extreme (1-1/n)P_1 instead of the Theorem-2 middle term), contradicting
    Remark 6.  The reading with prod_{j=l+1}^M and P_{l+1} reduces exactly to
    Theorem 2 and satisfies (23)-(24); we implement that and record the
    erratum in DESIGN.md.
    """
    n = int(np.prod(group_sizes))
    prod_gt = int(np.prod(group_sizes[level:]))      # prod_{j=l+1..M} N_j
    return (periods[0] * (1.0 / prod_gt - 1.0 / n)
            + periods[level] * (1.0 - 1.0 / prod_gt))


def theorem3_A2(level: int, periods: Sequence[int],
                group_sizes: Sequence[int]) -> float:
    """A_2(l) = P_1^2 (n_l-1)/(n-1) + P_{l+1}^2 (1 - (n_l-1)/(n-1)).
    Same indexing erratum as A_1 (see theorem3_A1)."""
    n = int(np.prod(group_sizes))
    n_l = int(np.prod(group_sizes[:level]))          # n_l = prod_{j<=l} N_j
    frac = (n_l - 1) / (n - 1)
    return periods[0] ** 2 * frac + periods[level] ** 2 * (1.0 - frac)


def theorem3_bound(*, gamma: float, T: int, L: float, sigma2: float,
                   f0_minus_fstar: float, periods: Sequence[int],
                   group_sizes: Sequence[int], eps_tilde2: float) -> float:
    """Eq. (22). periods=(P_1..P_M), group_sizes=(N_1..N_M)."""
    M = len(group_sizes)
    assert len(periods) == M and M >= 2
    n = int(np.prod(group_sizes))
    c = C_CONST
    base = 2.0 * f0_minus_fstar / (gamma * T) + gamma * L * sigma2 / n
    acc = 0.0
    for lvl in range(1, M):
        a1 = theorem3_A1(lvl, periods, group_sizes)
        a2 = theorem3_A2(lvl, periods, group_sizes)
        acc += 2.0 * a1 * sigma2 + 3.0 * a2 * eps_tilde2
    return base + c * gamma**2 * L**2 * acc / (M - 1)


# ---------------------------------------------------------------------------
# Table 1 comparison rows (O-expressions evaluated with unit constants)
# ---------------------------------------------------------------------------
def table1_yu2019(n, T, P, sigma2, eps_tilde2):
    """Yu, Jin, Yang 2019 (local SGD): O((1+s^2)/sqrt(nT) + n/T (P s^2 + P^2 e^2))."""
    return (1 + sigma2) / math.sqrt(n * T) + n / T * (P * sigma2 + P**2 * eps_tilde2)


def table1_liu2020(n, T, G, eps_tilde2, B=2.5):
    """Liu et al. 2020 (full-batch H-SGD): O((1 + B^G e^2)/sqrt(nT)), B>2."""
    return (1 + B**G * eps_tilde2) / math.sqrt(n * T)


def table1_castiglia2021(n, T, G, I, sigma2):
    """Castiglia et al. 2021 (IID H-SGD): O((1+s^2)/sqrt(nT) + n/T G^2/I s^2)."""
    return (1 + sigma2) / math.sqrt(n * T) + n / T * (G**2 / I) * sigma2


def table1_ours(n, N, T, G, I, sigma2, eps_tilde2):
    """Our row: O((1+s^2)/sqrt(nT)
                 + ((N-1)(G s^2 + G^2 e^2) + (n-N)(I s^2 + I^2 e^2)) / T)."""
    return ((1 + sigma2) / math.sqrt(n * T)
            + ((N - 1) * (G * sigma2 + G**2 * eps_tilde2)
               + (n - N) * (I * sigma2 + I**2 * eps_tilde2)) / T)
