"""Durable protocol state store of the port (SQLite).

The port's own copy of janus_tpu/datastore: the row models and the
typed ops of the port's aggregation, collection and GC paths, with AES-GCM
encryption at rest for secret columns (`Crypter`). The schema is
janus_tpu's, so the rows two helpers write on the same request can be
compared column for column.
"""

from .models import (
    AcquiredAggregationJob,
    AcquiredCollectionJob,
    AggregateShareJob,
    AggregationJobModel,
    AggregationJobState,
    Batch,
    BatchAggregation,
    BatchAggregationState,
    BatchState,
    CollectionJobModel,
    CollectionJobState,
    LeaderStoredReport,
    Lease,
    OutstandingBatch,
    ReportAggregationModel,
    ReportAggregationState,
    ShardSpec,
)
from .store import Crypter, Datastore, EphemeralDatastore, LeaseConflict, Transaction, TxConflict

__all__ = [n for n in dir() if not n.startswith("_")]
