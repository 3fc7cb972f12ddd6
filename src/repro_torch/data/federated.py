"""Non-IID federated data for the paper-experiment reproduction.

Numpy-only: the part of ``repro.data.federated`` the H-SGD experiments
need (``make_classification``, ``label_shard_partition``,
``dirichlet_partition``, ``FederatedDataset`` and the population regime's
``PopulationShards``), copied and held equal to it by the tests.  The paper partitions its
datasets by label across workers (§6, Appendix E); offline we generate a
K-class Gaussian-mixture task and partition it the same way.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence

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

    def dominant_labels(self) -> List[int]:
        return [int(np.bincount(self.y[p]).argmax()) for p in self.parts]

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

    def full_per_worker(self, cap: int = 512) -> Dict[str, np.ndarray]:
        """Equal-size per-worker eval batches (for divergence measurement)."""
        m = min(cap, min(len(p) for p in self.parts))
        xs = np.stack([self.x[p[:m]] for p in self.parts])
        ys = np.stack([self.y[p[:m]] for p in self.parts])
        return {"x": xs, "y": ys}

    def global_batch(self, cap: int = 2048) -> Dict[str, np.ndarray]:
        idx = np.arange(min(cap, len(self.y)))
        return {"x": self.x[idx], "y": self.y[idx]}


# -- population-scale shards (virtual clients, nothing materialized) ----------

_SHARD_SALT = 0xDA7A5D  # data-layer namespace (population sampler: 0x90BC11)


def _shard_rng(seed: int, *ctx: int) -> np.random.Generator:
    return np.random.default_rng([_SHARD_SALT, int(seed)]
                                 + [int(c) for c in ctx])


@functools.lru_cache(maxsize=8)
def _mixture_means(seed: int, num_classes: int, dim: int,
                   spread: float) -> np.ndarray:
    """Class means of the Gaussian-mixture task — drawn exactly like
    :func:`make_classification` so a PopulationShards and a materialized
    dataset with the same seed describe the same task."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(num_classes, dim)) * spread).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class PopulationShards:
    """Shard specs for a population of virtual clients, without the data.

    A :class:`FederatedDataset` materializes every worker's shard, which is
    impossible at population scale (10^6+ clients).  PopulationShards
    instead *declares* the per-client shard of the same Gaussian-mixture
    task: which labels a client holds (``client_labels``), how many examples
    it has (``client_size`` — the lognormal law shared with
    ``repro_torch.population.sampler.default_client_sizes`` so fold-back
    weights and data agree), and the minibatch it contributes at a step
    (``batch``).  Everything is a counter-based function of
    ``(seed, client_id, step)``; total memory is the O(num_classes × dim)
    cached class means, independent of ``population``.

    Empty slots (``client_id == -1``, a drawn client that never responded)
    still synthesize a finite batch under the reserved context 0 — the
    engine masks those slots out of every sync and weighs them 0 at
    fold-back, so only finiteness matters, not content.
    """
    population: int
    num_classes: int = 10
    dim: int = 32
    seed: int = 0
    labels_per_client: int = 2
    spread: float = 1.2
    size_log_mean: float = 5.0
    size_log_sigma: float = 1.0

    def __post_init__(self):
        if self.population < 1:
            raise ValueError(f"population must be >= 1, got "
                             f"{self.population}")
        if not 1 <= self.labels_per_client <= self.num_classes:
            raise ValueError(
                f"labels_per_client={self.labels_per_client} must be in "
                f"[1, num_classes={self.num_classes}]")

    @property
    def mus(self) -> np.ndarray:
        return _mixture_means(self.seed, self.num_classes, self.dim,
                              float(self.spread))

    def _check_cid(self, client_id: int) -> int:
        cid = int(client_id)
        if cid >= self.population:
            raise ValueError(
                f"client_id {cid} is outside the declared population of "
                f"{self.population} — the sampler's Population cells must "
                f"multiply to at most this population")
        return cid

    def client_labels(self, client_id: int) -> np.ndarray:
        """The labels this client's shard holds (sorted, pure in
        ``(seed, client_id)``); label-skew analogue of the paper's split."""
        cid = self._check_cid(client_id)
        rng = _shard_rng(self.seed, 1, cid + 1)
        return np.sort(rng.choice(self.num_classes,
                                  size=self.labels_per_client,
                                  replace=False)).astype(np.int32)

    def client_size(self, client_id: int) -> int:
        """Example count of this client's shard; same lognormal law as
        ``default_client_sizes`` (0 for empty slots)."""
        from repro_torch.population.sampler import default_client_sizes
        self._check_cid(client_id)
        return int(default_client_sizes(self.seed, self.size_log_mean,
                                        self.size_log_sigma)(int(client_id)))

    def size_fn(self):
        """The ``sizes`` callable ``HSGD.run_sampled`` expects."""
        from repro_torch.population.sampler import default_client_sizes
        return default_client_sizes(self.seed, self.size_log_mean,
                                    self.size_log_sigma)

    def batch(self, client_ids: Sequence[int], step: int,
              batch_size: int) -> Dict[str, np.ndarray]:
        """Minibatches for the round's k hydrated slots: ``x`` is
        ``(k, B, dim)`` float32, ``y`` is ``(k, B)`` int32."""
        mus = self.mus
        xs, ys = [], []
        for cid in client_ids:
            labels = self.client_labels(cid)
            rng = _shard_rng(self.seed, 2, self._check_cid(cid) + 1,
                             int(step))
            y = labels[rng.integers(0, len(labels), size=batch_size)]
            x = mus[y] + rng.normal(size=(batch_size, self.dim)) \
                            .astype(np.float32)
            xs.append(x)
            ys.append(y)
        return {"x": np.stack(xs).astype(np.float32),
                "y": np.stack(ys).astype(np.int32)}

    def batch_fn(self, batch_size: int
                 ) -> Callable[[np.ndarray, int], Dict[str, np.ndarray]]:
        """The ``batch_fn(client_ids, t)`` callable ``run_sampled`` expects."""
        return lambda client_ids, t: self.batch(client_ids, t, batch_size)

    def describe(self) -> dict:
        return {"population": self.population,
                "num_classes": self.num_classes, "dim": self.dim,
                "seed": self.seed,
                "labels_per_client": self.labels_per_client,
                "spread": self.spread,
                "size_log_mean": self.size_log_mean,
                "size_log_sigma": self.size_log_sigma}
