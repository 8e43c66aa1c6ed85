"""Bucketed padding (copy of ``spatialflink_tpu.utils.padding``).

Window batches are padded to power-of-two buckets, as in the JAX package,
so that both packages see the same batch capacities and padded slots.
"""

from __future__ import annotations

import numpy as np

MIN_BUCKET = 256


def bucket_size(n: int, min_bucket: int = MIN_BUCKET) -> int:
    """Smallest power-of-two bucket >= n (and >= min_bucket)."""
    if n <= min_bucket:
        return min_bucket
    return 1 << (int(n - 1)).bit_length()


def pad_to(arr: np.ndarray, size: int, axis: int = 0, fill=0) -> np.ndarray:
    """Pad ``arr`` along ``axis`` to ``size`` with ``fill``."""
    n = arr.shape[axis]
    if n == size:
        return arr
    if n > size:
        raise ValueError(f"array dim {n} exceeds pad size {size}")
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, size - n)
    return np.pad(arr, widths, constant_values=fill)
