"""Hierarchical SGD in PyTorch: engine, topologies, aggregators, groupings
(counterpart of ``repro.core``)."""
from repro_torch.core.aggregators import (Aggregator,
                                          CompressedAggregator,
                                          MeanAggregator, SignSGDAggregator,
                                          WeightedAggregator,
                                          make_aggregator)
from repro_torch.core.executors import (Executor, MeshExecutor, SimExecutor,
                                        make_executor)
from repro_torch.core.grouping import (Grouping, contiguous,
                                       diversity_grouping, group_iid,
                                       group_noniid, random_grouping,
                                       sample_participation)
from repro_torch.core.hierarchy import HierarchySpec, local_sgd, two_level
from repro_torch.core.hsgd import (HSGD, EngineConfig, HSGDState, Round,
                                   compile_schedule)
from repro_torch.core.topology import (GroupedTopology, SyncEvent, Topology,
                                       UniformTopology, make_topology)

__all__ = [
    "HSGD", "EngineConfig", "HSGDState", "Round", "compile_schedule",
    "Executor", "SimExecutor", "MeshExecutor", "make_executor",
    "Topology", "SyncEvent", "GroupedTopology", "UniformTopology",
    "make_topology",
    "Aggregator", "MeanAggregator", "CompressedAggregator",
    "WeightedAggregator", "SignSGDAggregator", "make_aggregator",
    "HierarchySpec", "local_sgd", "two_level",
    "Grouping", "contiguous", "group_iid", "group_noniid", "random_grouping",
    "sample_participation", "diversity_grouping",
]
