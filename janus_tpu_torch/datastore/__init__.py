"""Durable protocol state store of the port (SQLite or Postgres).

The port's own copy of janus_tpu/datastore: the row models and the
typed ops of the port's aggregation, collection, GC and taskprov paths,
with AES-GCM encryption at rest for secret columns (`Crypter`), the
Postgres engine (`PostgresDatastore`, over psycopg or `pg_fake`), and
the connection supervisor. The schema is janus_tpu's, so the rows two
helpers write on the same request can be compared column for column.
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
from .store import (
    Crypter,
    Datastore,
    DatastoreSupervisor,
    EphemeralDatastore,
    LeaseConflict,
    PostgresDatastore,
    Transaction,
    TxConflict,
    open_datastore,
)

__all__ = [n for n in dir() if not n.startswith("_")]
