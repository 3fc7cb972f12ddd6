from repro_torch.data.federated import (FederatedDataset,
                                        PopulationShards,
                                        dirichlet_partition,
                                        label_shard_partition,
                                        make_classification)
from repro_torch.data.synthetic import (TokenStream, markov_fold,
                                        synth_lm_batch)

__all__ = ["FederatedDataset", "PopulationShards", "dirichlet_partition",
           "label_shard_partition", "make_classification", "TokenStream",
           "markov_fold", "synth_lm_batch"]
