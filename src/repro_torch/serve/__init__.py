from repro_torch.serve.engine import ContinuousEngine, ServeEngine
from repro_torch.serve.paged_cache import PagedCache
from repro_torch.serve.scheduler import Request, Scheduler

__all__ = ["ContinuousEngine", "PagedCache", "Request", "Scheduler",
           "ServeEngine"]
