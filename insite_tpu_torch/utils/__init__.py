"""Tracing and timing tools."""

from insite_tpu_torch.utils.profiling import (time_blocked, trace,
                                              wall_clock_logger)

__all__ = ['time_blocked', 'trace', 'wall_clock_logger']
