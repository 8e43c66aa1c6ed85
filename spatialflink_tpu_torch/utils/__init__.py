"""Host utilities (copies of ``spatialflink_tpu.utils`` padding/interner)."""

from spatialflink_tpu_torch.utils.interner import IdInterner
from spatialflink_tpu_torch.utils.padding import bucket_size, pad_to

__all__ = ["IdInterner", "bucket_size", "pad_to"]
