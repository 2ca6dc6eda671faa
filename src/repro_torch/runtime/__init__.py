"""Distributed runtime: sharding rules, framed channels, compression,
pipeline, and the continuous-batching serve scheduler.  On one card a
mesh axis is a tensor axis (see each module)."""
from .sharding import (
    ShardRules,
    batch_pspec,
    batch_shardings,
    cache_shardings,
    param_pspec,
    param_shardings,
    replicated,
)
from .channels import (
    FRAME_PHITS,
    crc32_words,
    frame_stream,
    make_framed_sender,
    pod_ring_exchange,
    unframe_stream,
)
from .compress import (
    compress_tree,
    cross_pod_mean_int8,
    decompress_tree,
    init_error,
    new_error,
)
from .pipeline import gpipe_forward, split_stages, stack_stage_params
from .scheduler import ContinuousBatcher, SchedulerConfig

__all__ = [
    "ContinuousBatcher", "SchedulerConfig",
    "ShardRules", "batch_pspec", "batch_shardings", "cache_shardings",
    "param_pspec", "param_shardings", "replicated",
    "FRAME_PHITS", "crc32_words", "frame_stream", "make_framed_sender",
    "pod_ring_exchange",
    "unframe_stream", "compress_tree", "cross_pod_mean_int8",
    "decompress_tree", "init_error", "new_error",
    "gpipe_forward", "split_stages", "stack_stage_params",
]
