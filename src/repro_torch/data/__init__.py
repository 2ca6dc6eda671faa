"""HGum-schema'd data plane: host SER -> phit wire -> device DES -> batches
(counterpart of ``repro.data``)."""
from .schemas import batch_schema, request_schema, response_schema
from .pipeline import HGumBatchPipeline, SyntheticCorpus, pack_documents
from .prefetch import Prefetcher

__all__ = [
    "batch_schema", "request_schema", "response_schema",
    "HGumBatchPipeline", "SyntheticCorpus", "pack_documents", "Prefetcher",
]
