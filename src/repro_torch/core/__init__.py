"""Hierarchical SGD in PyTorch: engine, topologies, aggregators, groupings,
divergences, bounds and the deployment planner (counterpart of
``repro.core``)."""
from repro_torch.core.aggregators import (Aggregator,
                                          CompressedAggregator,
                                          MeanAggregator, SignSGDAggregator,
                                          WeightedAggregator,
                                          make_aggregator,
                                          register_aggregator)
from repro_torch.core.divergence import (all_divergences, divergence_stack,
                                         downward_divergence_avg,
                                         downward_divergences,
                                         flatten_pytree_batch,
                                         global_divergence,
                                         partition_divergences,
                                         partition_divergences_tree,
                                         partition_residual,
                                         per_worker_grads,
                                         upward_divergence)
from repro_torch.core.executors import (Executor, MeshExecutor, SimExecutor,
                                        make_executor, register_executor)
from repro_torch.core.grouping import (Grouping, contiguous,
                                       diversity_grouping, group_iid,
                                       group_noniid, random_grouping,
                                       sample_participation)
from repro_torch.core.hierarchy import HierarchySpec, local_sgd, two_level
from repro_torch.core.hsgd import (HSGD, EngineConfig, HSGDState, Round,
                                   StaleOp, StaleSlot, StaleSnap,
                                   async_warmup, compile_schedule, run)
from repro_torch.core.planner import (CommModel, PlanPoint,
                                      best_under_budget, enumerate_plans,
                                      fastest_under_bound, pareto_front)
from repro_torch.core.topology import (GroupedTopology, SyncEvent, Topology,
                                       UniformTopology, make_topology,
                                       register_topology)

__all__ = [
    "HSGD", "EngineConfig", "HSGDState", "Round", "compile_schedule", "run",
    "StaleOp", "StaleSlot", "StaleSnap", "async_warmup",
    "Executor", "SimExecutor", "MeshExecutor", "make_executor",
    "register_executor",
    "Topology", "SyncEvent", "GroupedTopology", "UniformTopology",
    "make_topology", "register_topology",
    "Aggregator", "MeanAggregator", "CompressedAggregator",
    "WeightedAggregator", "SignSGDAggregator", "make_aggregator",
    "register_aggregator",
    "HierarchySpec", "local_sgd", "two_level",
    "CommModel", "PlanPoint", "best_under_budget", "enumerate_plans",
    "fastest_under_bound", "pareto_front",
    "Grouping", "contiguous", "group_iid", "group_noniid", "random_grouping",
    "sample_participation", "diversity_grouping",
    "all_divergences", "divergence_stack", "downward_divergence_avg",
    "downward_divergences", "flatten_pytree_batch", "global_divergence",
    "partition_divergences", "partition_divergences_tree",
    "partition_residual", "per_worker_grads", "upward_divergence",
]
