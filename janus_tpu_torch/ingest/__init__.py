"""Admission-controlled, bounded upload ingest.

The serving front door for client report uploads: an
AdmissionController (token buckets + queue-depth watermarks + spent
deadlines, shedding with 429 or 503 + Retry-After) in front of an
IngestPipeline (decode, parallel HPKE-decrypt pool, validation, group
commit through the ReportWriteBatcher), and the durable upload spill
journal the writer falls back on while the datastore is unreachable
(UploadJournal, JournalReplayer). The port's own copy of
janus_tpu/ingest."""

from .admission import AdmissionConfig, AdmissionController, ShedError, TokenBucket
from .journal import JournalFull, JournalReplayer, UploadJournal
from .pipeline import IngestPipeline, UploadTicket, default_decrypt_workers

__all__ = [
    "AdmissionConfig",
    "AdmissionController",
    "IngestPipeline",
    "JournalFull",
    "JournalReplayer",
    "ShedError",
    "TokenBucket",
    "UploadJournal",
    "UploadTicket",
    "default_decrypt_workers",
]
