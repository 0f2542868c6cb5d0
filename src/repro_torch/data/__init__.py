from repro_torch.data.partition import (ClientSplit, make_splits,
                                        pack_cohort, split_client)
from repro_torch.data.pipeline import cohort_batch
from repro_torch.data.synthetic import (DATASETS, FederatedDataset,
                                        fmnist_like, pad_like, sc_like)

__all__ = ["ClientSplit", "make_splits", "pack_cohort", "split_client",
           "cohort_batch", "DATASETS", "FederatedDataset", "fmnist_like",
           "pad_like", "sc_like"]
