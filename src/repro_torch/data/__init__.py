from repro_torch.data.loader import BatchLoader
from repro_torch.data.partition import (dirichlet_partition,
                                         iid_partition, iid_shard)
from repro_torch.data.synthetic import (SyntheticActionDataset,
                                        SyntheticLMDataset,
                                        make_dataset_for, stack_batches)

__all__ = ["SyntheticActionDataset", "SyntheticLMDataset",
           "make_dataset_for", "stack_batches", "iid_partition", "iid_shard",
           "dirichlet_partition", "BatchLoader"]
