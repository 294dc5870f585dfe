"""Observability and long-run utilities."""

from .checkpoint import ChunkedAccumulator, resumable_bootstrap
from .profiling import StageTimer, log, trace

__all__ = ["ChunkedAccumulator", "StageTimer", "log", "resumable_bootstrap", "trace"]
