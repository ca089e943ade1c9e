from .engine import ServingEngine  # noqa: F401
from .metrics import ServingMetrics  # noqa: F401
from .paged_pool import PagedKVPool, PagePoolExhausted  # noqa: F401
from .prefix_cache import PrefixCache  # noqa: F401
from .request import (FinishReason, RejectReason, Request,  # noqa: F401
                      RequestState)
from .resilience.errors import (InvariantViolation,  # noqa: F401
                                ServingStalledError)
from .scheduler import FIFOScheduler  # noqa: F401
from .slot_pool import SlotPool  # noqa: F401
from .spec_decode import SpecDecodeConfig  # noqa: F401
