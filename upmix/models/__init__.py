from upmix.models.offline import Upmixer, upmix_offline
from upmix.models.streaming import (
    BatchStreamingUpmixer,
    StreamingUpmixer,
    make_stream_pool,
)

__all__ = [
    "Upmixer",
    "upmix_offline",
    "StreamingUpmixer",
    "BatchStreamingUpmixer",
    "make_stream_pool",
]
