from repro_torch.serve.engine import (ContinuousEngine, HotSwapBridge,
                                      ServeEngine)
from repro_torch.serve.paged_cache import PagedCache
from repro_torch.serve.scheduler import Request, Scheduler

__all__ = ["ContinuousEngine", "HotSwapBridge", "PagedCache", "Request",
           "Scheduler", "ServeEngine"]
