"""Host streaming runtime: watermarks and event-time windows."""

from spatialflink_tpu_torch.runtime.watermarks import BoundedOutOfOrderness
from spatialflink_tpu_torch.runtime.windows import WindowAssembler, WindowSpec

__all__ = ["BoundedOutOfOrderness", "WindowAssembler", "WindowSpec"]
