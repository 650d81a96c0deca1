"""Admission-controlled, bounded upload ingest.

The serving front door for client report uploads: an
AdmissionController (token buckets + queue-depth watermarks + spent
deadlines, shedding with 429 or 503 + Retry-After) in front of an
IngestPipeline (decode, parallel HPKE-decrypt pool, validation, group
commit through the ReportWriteBatcher). The port's own copy of
janus_tpu/ingest without the upload journal."""

from .admission import AdmissionConfig, AdmissionController, ShedError, TokenBucket
from .pipeline import IngestPipeline, UploadTicket, default_decrypt_workers

__all__ = [
    "AdmissionConfig",
    "AdmissionController",
    "IngestPipeline",
    "ShedError",
    "TokenBucket",
    "UploadTicket",
    "default_decrypt_workers",
]
