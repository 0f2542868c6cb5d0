"""Core of the port: the synchronous and the asynchronous federation on
one device, under SQMD or one of its baselines (FedMD, D-Dist, I-SGD)."""
from repro_torch.core.engine import (AsyncFederationEngine, Federation,
                                     FederationConfig, FederationEngine,
                                     History, evaluate, precision_recall)
from repro_torch.core.graph import (CollaborationGraph, ddist_graph,
                                    fedmd_graph, graph_stats,
                                    select_neighbors,
                                    select_neighbors_from_div)
from repro_torch.core.policies import (DDistPolicy, FedMDPolicy, ISGDPolicy,
                                       SQMDPolicy, ServerPolicy, as_policy)
from repro_torch.core.protocols import Protocol, ddist, fedmd, isgd, sqmd
from repro_torch.core.quality import candidate_mask, quality_scores
from repro_torch.core.runtime import (ClientRuntime, Clock, Event,
                                      EveryKUploads, EveryUpload, Quorum,
                                      ServerBus, SyncClock, Trigger,
                                      WallInterval, as_trigger, get_trigger,
                                      register_trigger, registered_triggers)
from repro_torch.core.schedules import (AlwaysOn, ArrivalProcess,
                                        BurstyArrivals, HeterogeneousCadence,
                                        RandomDropout, Schedule,
                                        ScheduleArrivals, StagedJoin,
                                        Straggler, StragglerLatency,
                                        as_arrivals, as_schedule,
                                        get_arrivals, get_schedule,
                                        register_arrivals, register_schedule,
                                        registered_arrivals,
                                        registered_schedules)
from repro_torch.core.server import (ServerState, init_server, policy_round,
                                     server_round, staleness_summary,
                                     upload_messengers)
from repro_torch.core.similarity import (NeighborIndex, divergence_matrix,
                                        similarity_matrix,
                                        update_divergence_cache)
from repro_torch.core.wire import (Codec, Dense32, Int8, Payload, as_codec,
                                   bytes_per_messenger, decode, encode,
                                   get_codec, payload_bytes, register_codec,
                                   registered_codecs)

__all__ = [
    "AsyncFederationEngine", "Federation", "FederationConfig",
    "FederationEngine", "History", "evaluate", "precision_recall",
    "CollaborationGraph", "graph_stats", "select_neighbors",
    "select_neighbors_from_div", "fedmd_graph", "ddist_graph",
    "SQMDPolicy", "FedMDPolicy", "DDistPolicy", "ISGDPolicy",
    "ServerPolicy", "as_policy", "Protocol", "sqmd", "fedmd", "ddist",
    "isgd", "candidate_mask", "quality_scores", "ClientRuntime", "Clock",
    "Event", "EveryKUploads", "EveryUpload", "Quorum", "ServerBus",
    "SyncClock", "Trigger", "WallInterval", "as_trigger", "get_trigger",
    "register_trigger", "registered_triggers", "AlwaysOn", "ArrivalProcess",
    "BurstyArrivals", "HeterogeneousCadence", "RandomDropout", "Schedule",
    "ScheduleArrivals", "StagedJoin", "Straggler", "StragglerLatency",
    "as_arrivals", "as_schedule", "get_arrivals", "get_schedule",
    "register_arrivals", "register_schedule", "registered_arrivals",
    "registered_schedules", "ServerState", "init_server", "policy_round",
    "server_round", "staleness_summary", "upload_messengers",
    "divergence_matrix", "similarity_matrix", "update_divergence_cache",
    "NeighborIndex", "Codec", "Dense32", "Int8", "Payload", "as_codec",
    "bytes_per_messenger", "decode", "encode", "get_codec",
    "payload_bytes", "register_codec", "registered_codecs",
]
