"""Host streaming runtime: watermarks, event-time windows, realtime
micro-batches and count windows."""

from spatialflink_tpu_torch.runtime.watermarks import BoundedOutOfOrderness
from spatialflink_tpu_torch.runtime.windows import (MicroBatcher,
                                                    WindowAssembler,
                                                    WindowSpec, count_windows)

__all__ = ["BoundedOutOfOrderness", "MicroBatcher", "WindowAssembler",
           "WindowSpec", "count_windows"]
