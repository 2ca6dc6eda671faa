"""The framework's own message schemas (copy of ``repro.data.schemas``)."""
from .schemas import batch_schema, request_schema, response_schema
