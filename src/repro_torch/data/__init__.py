from repro_torch.data.partition import (ClientSplit, make_splits,
                                        pack_cohort, split_client)
from repro_torch.data.pipeline import cohort_batch, lm_batches
from repro_torch.data.synthetic import (DATASETS, FederatedDataset,
                                        fmnist_like, lm_token_stream,
                                        pad_like, sc_like)

__all__ = ["ClientSplit", "make_splits", "pack_cohort", "split_client",
           "cohort_batch", "lm_batches", "DATASETS", "FederatedDataset",
           "fmnist_like", "lm_token_stream", "pad_like", "sc_like"]
