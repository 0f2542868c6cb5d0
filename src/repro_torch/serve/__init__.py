"""Personalized serving: batched per-client inference from versioned
snapshots of the federation's personalized params, driven by query
arrival workloads on the training event loop.

Importing this package registers the serving plug-ins: the
``query-poisson`` / ``query-diurnal`` arrival processes (in the same
registry the training runtime uses) and the ``immediate`` / ``micro``
batch policies."""
from repro_torch.serve.engine import (QueryEngine, ServeResult, bucket_size,
                                      serve_step)
from repro_torch.serve.queue import (BatchPolicy, Immediate, MicroBatch,
                                     MicroBatchQueue, QueryRequest,
                                     as_batch_policy, get_batch_policy,
                                     register_batch_policy,
                                     registered_batch_policies)
from repro_torch.serve.runtime import QueryRuntime, summarize_records
from repro_torch.serve.snapshot import CohortView, Snapshot, SnapshotStore
from repro_torch.serve.workload import (DiurnalQueries, PoissonQueries,
                                        split_query_stream)

__all__ = [
    "QueryEngine", "ServeResult", "bucket_size", "serve_step",
    "BatchPolicy", "Immediate", "MicroBatch", "MicroBatchQueue",
    "QueryRequest", "as_batch_policy", "get_batch_policy",
    "register_batch_policy", "registered_batch_policies",
    "QueryRuntime", "summarize_records",
    "CohortView", "Snapshot", "SnapshotStore",
    "DiurnalQueries", "PoissonQueries", "split_query_stream",
]
