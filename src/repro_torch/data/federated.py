"""Non-IID federated data for the paper-experiment reproduction.

Numpy-only: the part of ``repro.data.federated`` the H-SGD experiments
need (``make_classification``, ``label_shard_partition``,
``dirichlet_partition``, ``FederatedDataset``),
copied and held equal to it by the tests.  The paper partitions its
datasets by label across workers (§6, Appendix E); offline we generate a
K-class Gaussian-mixture task and partition it the same way.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np


def make_classification(seed: int, num_classes: int = 10, dim: int = 32,
                        per_class: int = 200, spread: float = 1.2):
    """Gaussian mixture: class c ~ N(mu_c, I). Returns (x, y) arrays."""
    rng = np.random.default_rng(seed)
    mus = rng.normal(size=(num_classes, dim)) * spread
    xs, ys = [], []
    for c in range(num_classes):
        xs.append(mus[c] + rng.normal(size=(per_class, dim)))
        ys.append(np.full(per_class, c))
    x = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys).astype(np.int32)
    perm = rng.permutation(len(y))
    return x[perm], y[perm]


def label_shard_partition(y: np.ndarray, worker_labels: Sequence[Sequence[int]],
                          seed: int = 0, *,
                          n_workers: Optional[int] = None) -> List[np.ndarray]:
    """worker_labels[j] = labels assigned to worker j. Returns index lists.
    Samples of a label shared by multiple workers are split evenly."""
    if n_workers is not None and len(worker_labels) != n_workers:
        raise ValueError(
            f"label_shard_partition got {len(worker_labels)} worker label "
            f"sets but the topology has n={n_workers} workers — provide "
            f"exactly one label set per worker")
    present = set(np.unique(y).tolist())
    for j, labs in enumerate(worker_labels):
        missing = [int(l) for l in labs if int(l) not in present]
        if missing:
            raise ValueError(
                f"worker {j} is assigned label(s) {missing} that do not "
                f"occur in y (labels present: {sorted(present)}) — its "
                f"shard would be empty and batch() would fail later")
    rng = np.random.default_rng(seed)
    owners: Dict[int, List[int]] = {}
    for j, labs in enumerate(worker_labels):
        for lab in labs:
            owners.setdefault(int(lab), []).append(j)
    parts: List[List[int]] = [[] for _ in worker_labels]
    for lab, js in owners.items():
        idx = np.nonzero(y == lab)[0]
        rng.shuffle(idx)
        for k, chunk in enumerate(np.array_split(idx, len(js))):
            parts[js[k]].extend(chunk.tolist())
    return [np.asarray(sorted(p), np.int64) for p in parts]


def dirichlet_partition(y: np.ndarray, n_workers: int, alpha: float,
                        seed: int = 0) -> List[np.ndarray]:
    """Label-skew partition: per class, worker proportions ~ Dir(alpha)."""
    if n_workers < 1:
        raise ValueError(
            f"dirichlet_partition needs n_workers >= 1, got {n_workers} — "
            f"pass the topology's n (prod of its group sizes)")
    if not np.isfinite(alpha) or alpha <= 0:
        raise ValueError(
            f"dirichlet_partition needs alpha > 0, got {alpha!r} — the "
            f"Dirichlet concentration must be positive (small alpha ≈ 0.1 "
            f"gives strong label skew, large alpha ≈ 100 is near-IID)")
    rng = np.random.default_rng(seed)
    classes = np.unique(y)
    parts: List[List[int]] = [[] for _ in range(n_workers)]
    for c in classes:
        idx = np.nonzero(y == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * n_workers)
        cuts = (np.cumsum(props)[:-1] * len(idx)).astype(int)
        for j, chunk in enumerate(np.split(idx, cuts)):
            parts[j].extend(chunk.tolist())
    return [np.asarray(sorted(p), np.int64) for p in parts]


@dataclasses.dataclass
class FederatedDataset:
    """Per-worker datasets + minibatch sampler with leading worker axis.
    Batches are numpy; the engine moves them to its device."""
    x: np.ndarray
    y: np.ndarray
    parts: List[np.ndarray]
    seed: int = 0

    @property
    def n_workers(self) -> int:
        return len(self.parts)

    def require_workers(self, n: int) -> "FederatedDataset":
        """Assert this dataset's shard count matches the topology's ``n``."""
        if self.n_workers != n:
            raise ValueError(
                f"dataset has {self.n_workers} worker shards but the "
                f"topology expects n={n} — repartition with exactly one "
                f"shard per worker")
        empty = [j for j, p in enumerate(self.parts) if len(p) == 0]
        if empty:
            raise ValueError(
                f"worker shard(s) {empty} are empty — batch() cannot sample "
                f"from them; use a larger dataset or a less extreme split")
        return self

    def batch(self, step: int, batch_size: int) -> Dict[str, np.ndarray]:
        """IID minibatch per worker from that worker's shard (paper's SGD)."""
        xs, ys = [], []
        for j, part in enumerate(self.parts):
            rng = np.random.default_rng(
                (self.seed * 1_000_003 + step) * 613 + j)
            take = rng.integers(0, len(part), size=batch_size)
            xs.append(self.x[part[take]])
            ys.append(self.y[part[take]])
        return {"x": np.stack(xs), "y": np.stack(ys)}

    def global_batch(self, cap: int = 2048) -> Dict[str, np.ndarray]:
        idx = np.arange(min(cap, len(self.y)))
        return {"x": self.x[idx], "y": self.y[idx]}
