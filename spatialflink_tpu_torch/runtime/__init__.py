"""Host streaming runtime: watermarks, event-time windows and their panes,
realtime micro-batches, count windows, and the standing-query registry
(``runtime.queryplane``)."""

from spatialflink_tpu_torch.runtime.watermarks import BoundedOutOfOrderness
from spatialflink_tpu_torch.runtime.windows import (MicroBatcher, PaneBuffer,
                                                    WindowAssembler,
                                                    WindowSpec, count_windows)

__all__ = ["BoundedOutOfOrderness", "MicroBatcher", "PaneBuffer",
           "WindowAssembler", "WindowSpec", "count_windows"]
