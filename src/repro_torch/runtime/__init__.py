"""Runtime: the continuous-batching serve scheduler."""
from .scheduler import ContinuousBatcher, SchedulerConfig
