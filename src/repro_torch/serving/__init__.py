from repro_torch.serving.api import (  # noqa: F401
    FINISH_CANCELLED, FINISH_DEADLINE, FINISH_LENGTH, FINISH_REASONS,
    FINISH_STOP, RequestHandle, RequestOutput, SamplingParams)
from repro_torch.serving.engine import Engine, Request  # noqa: F401
from repro_torch.serving.paged_cache import (  # noqa: F401
    PageAllocator, PagedKVCache, PrefixIndex, TRASH_PAGE)
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig  # noqa: F401
