from repro_torch.data.federated import (FederatedDataset,
                                        dirichlet_partition,
                                        label_shard_partition,
                                        make_classification)

__all__ = ["FederatedDataset", "dirichlet_partition",
           "label_shard_partition", "make_classification"]
