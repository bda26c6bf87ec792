from dynamo_tpu_torch.runtime.engine import (
    AsyncEngine,
    Context,
    EngineContext,
    Operator,
    ResponseStream,
)
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

__all__ = [
    "AsyncEngine",
    "Context",
    "EngineContext",
    "Operator",
    "ResponseStream",
    "DistributedRuntime",
]
