from upmix.utils.logging import get_logger
from upmix.utils.profiling import RealtimeMeter, time_fn

__all__ = ["get_logger", "RealtimeMeter", "time_fn"]
