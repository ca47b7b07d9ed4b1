"""Utilities: quality metrics, timers, profiling, logging, caching."""

from cvt_tpu.utils.metrics import recall_at_k, auc
from cvt_tpu.utils.timer import Timer
from cvt_tpu.utils.profile import trace, roofline
from cvt_tpu.utils.log import (CheckError, LRUCache, check, check_eq,
                               check_ge, check_gt, check_le, check_lt,
                               check_ne, check_option, get_logger,
                               init_logging)

__all__ = ["recall_at_k", "auc", "Timer", "trace", "roofline",
           "CheckError", "LRUCache", "check", "check_eq", "check_ge",
           "check_gt", "check_le", "check_lt", "check_ne",
           "check_option", "get_logger", "init_logging"]
