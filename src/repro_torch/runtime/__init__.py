from .async_engine import AsyncTierRuntime, QueueStats, Transfer  # noqa
from .clock import CallableClock, VirtualClock, WallClock, ensure_clock  # noqa
from .fabric import (NIC, FailureReport, HostView,  # noqa
                     RebalanceStats, RemoteFetch, ShardedTieredStore)
from .pool import PoolStats, PooledFetch, PooledStore  # noqa
from .repair import RepairLoop, RepairStats  # noqa
from .service import (FabricTopology, FixedLatencyModel,  # noqa
                      GpuDirectQueueModel, NetQueueModel, PoolLaneModel,
                      Service, SsdQueueModel)
from .tiers import PendingFetch, TierSpec, TierStats, TieredStore  # noqa
