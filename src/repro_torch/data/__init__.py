from repro_torch.data.federated import (FederatedDataset,
                                        PopulationShards,
                                        dirichlet_partition,
                                        label_shard_partition,
                                        make_classification)

__all__ = ["FederatedDataset", "PopulationShards", "dirichlet_partition",
           "label_shard_partition", "make_classification"]
