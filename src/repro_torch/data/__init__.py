from repro_torch.data.federated import (FederatedDataset,
                                        label_shard_partition,
                                        make_classification)

__all__ = ["FederatedDataset", "label_shard_partition", "make_classification"]
