"""Event-time watermarks (copy of ``spatialflink_tpu.runtime.watermarks``):
Flink's bounded out-of-orderness extractor."""

from __future__ import annotations


class BoundedOutOfOrderness:
    """Watermark = max event time seen - allowed lateness."""

    def __init__(self, allowed_lateness_ms: int = 0):
        self.allowed_lateness_ms = int(allowed_lateness_ms)
        self._max_ts: int = -(2**63)

    def on_event(self, ts_ms: int) -> int:
        if ts_ms > self._max_ts:
            self._max_ts = ts_ms
        return self.watermark

    @property
    def watermark(self) -> int:
        return self._max_ts - self.allowed_lateness_ms

    def is_late(self, ts_ms: int) -> bool:
        """A record older than the current watermark is late (its windows
        may already have fired)."""
        return ts_ms < self.watermark

    @staticmethod
    def bulk_keep_mask(ts_ms, allowed_lateness_ms: int = 0):
        """The add-time late check over a whole array at once: ``keep[i]``
        is False iff record i is late when the stream is fed in array
        order (the watermark is the running max of the EARLIER records
        minus the lateness), so a bulk replay drops what the record path
        drops."""
        import numpy as np

        ts = np.asarray(ts_ms, np.int64)
        keep = np.ones(ts.shape[0], bool)
        if ts.shape[0] > 1:
            prev_max = np.maximum.accumulate(ts)[:-1]
            keep[1:] = ts[1:] >= prev_max - int(allowed_lateness_ms)
        return keep
