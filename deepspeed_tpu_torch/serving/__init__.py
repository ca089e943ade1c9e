from .engine import ServingEngine  # noqa: F401
from .frontend import (AsyncEngineBridge, PriorityConfig,  # noqa: F401
                       PriorityScheduler, ServingFrontend, TenantPolicy,
                       TokenStream)
from .metrics import ServingMetrics  # noqa: F401
from .paged_pool import PagedKVPool, PagePoolExhausted  # noqa: F401
from .prefix_cache import PrefixCache  # noqa: F401
from .request import (FinishReason, RejectReason, Request,  # noqa: F401
                      RequestState)
from .resilience import (DegradationConfig, FaultInjector,  # noqa: F401
                         InjectedFault, InvariantViolation, LoadState,
                         ServingStalledError)
from .router import (ID_STRIDE, NoLiveReplicaError,  # noqa: F401
                     ReplicaRouter)
from .scheduler import FIFOScheduler  # noqa: F401
from .slot_pool import SlotPool  # noqa: F401
from .spec_decode import SpecDecodeConfig  # noqa: F401
