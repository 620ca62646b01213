from .async_engine import AsyncTierRuntime, QueueStats, Transfer  # noqa
from .clock import CallableClock, VirtualClock, WallClock, ensure_clock  # noqa
from .service import (FixedLatencyModel, GpuDirectQueueModel, Service,  # noqa
                      SsdQueueModel)
from .tiers import PendingFetch, TierSpec, TierStats, TieredStore  # noqa
