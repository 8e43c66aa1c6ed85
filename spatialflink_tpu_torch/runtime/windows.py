"""Window assembly over decoded point chunks (port of ``WindowSpec``, the
columnar path of ``WindowAssembler`` and ``MicroBatcher`` in
``spatialflink_tpu.runtime.windows``, and of the count windows of
``SpatialOperator._count_windows``).

Event-time windows are Flink-compatible: a sliding window of (size, slide)
covers [start, start + size) for starts aligned to ``slide``; each record
belongs to the windows whose interval contains its event time. Windows seal
when the watermark passes their end; records below the watermark are late
and dropped. Emission granularity is one decoded chunk, as in the JAX
package.

Every buffer holds ``(PointChunk, idx)`` slices of decoded chunks (the port
cuts Point-object streams into chunks too), so a sealed buffer is a
:class:`LazyRecords` as it stands: the JAX package's ``_ColumnarSeg``
marker and ``_finalize_buffer``, which tell slices from plain records in a
buffer, have nothing to tell apart here.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Tuple

import numpy as np

from spatialflink_tpu_torch.runtime.watermarks import BoundedOutOfOrderness
from spatialflink_tpu_torch.streams.bulk import LazyRecords


@dataclass(frozen=True)
class WindowSpec:
    size_ms: int
    slide_ms: int

    @staticmethod
    def sliding(size_ms: int, slide_ms: int) -> "WindowSpec":
        return WindowSpec(size_ms, slide_ms)

    def assign_bulk(self, ts_ms) -> Tuple[np.ndarray, np.ndarray]:
        """Every (window start, record index) membership pair of an array
        of event times, sorted by (window, record order)."""
        ts = np.asarray(ts_ms, np.int64)
        n_max = -(-self.size_ms // self.slide_ms)
        offs = np.arange(n_max, dtype=np.int64) * self.slide_ms
        last = ts - (ts % self.slide_ms)
        starts = last[:, None] - offs[None, :]
        valid = starts > (ts[:, None] - self.size_ms)
        rec = np.broadcast_to(np.arange(ts.shape[0], dtype=np.int64)[:, None],
                              starts.shape)
        win_start, rec_idx = starts[valid], rec[valid]
        order = np.lexsort((rec_idx, win_start))
        return win_start[order], rec_idx[order]


def _keep_mask(watermarker: BoundedOutOfOrderness, ts: np.ndarray):
    """Per-record lateness decisions for one chunk against the per-record
    PREFIX watermark — identical to feeding the chunk one record at a
    time."""
    prior = max(watermarker._max_ts, -(2 ** 62))
    run_max = np.maximum.accumulate(ts)
    wm_before = np.empty_like(ts)
    wm_before[0] = prior
    np.maximum(run_max[:-1], prior, out=wm_before[1:])
    return ts >= wm_before - watermarker.allowed_lateness_ms


class WindowAssembler:
    """Buffers decoded chunks into event-time windows; yields sealed windows
    as ``(start, end, LazyRecords)`` in start order."""

    def __init__(self, spec: WindowSpec, allowed_lateness_ms: int = 0):
        self.spec = spec
        self.watermarker = BoundedOutOfOrderness(allowed_lateness_ms)
        self._buffers: Dict[int, List] = {}
        self.late_dropped = 0

    def add_parsed_chunk(self, chunk) -> Iterator[Tuple[int, int, LazyRecords]]:
        """Buffer one :class:`PointChunk` as ``(chunk, idx)`` slices per
        window (late records dropped), then seal what the watermark
        passed."""
        ts = np.asarray(chunk.parsed.ts, np.int64)
        if not ts.size:
            return
        keep = _keep_mask(self.watermarker, ts)
        self.late_dropped += int((~keep).sum())
        kept_idx = np.nonzero(keep)[0]
        if kept_idx.size:
            win, rec = self.spec.assign_bulk(ts[kept_idx])
            bounds = np.flatnonzero(np.r_[True, win[1:] != win[:-1], True])
            for lo, hi in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
                self._buffers.setdefault(int(win[lo]), []).append(
                    (chunk, kept_idx[rec[lo:hi]]))
        wm = self.watermarker.on_event(int(ts.max()))
        yield from self._seal_until(wm)

    def assemble(self, chunks) -> Iterator[Tuple[int, int, LazyRecords]]:
        """Drive a stream of decoded chunks to its end, then seal every
        remaining window."""
        for ch in chunks:
            yield from self.add_parsed_chunk(ch)
        yield from self.flush()

    def _seal_until(self, watermark: int):
        ready = sorted(s for s in self._buffers
                       if s + self.spec.size_ms <= watermark)
        for start in ready:
            yield (start, start + self.spec.size_ms,
                   LazyRecords(self._buffers.pop(start)))

    def flush(self):
        """Seal every remaining window (end of a bounded stream)."""
        for start in sorted(self._buffers):
            yield (start, start + self.spec.size_ms,
                   LazyRecords(self._buffers.pop(start)))


class MicroBatcher:
    """Tumbling count micro-batches of the realtime mode: the reference's
    trigger fires per element; this batches ``batch_size`` arrivals per
    device dispatch. A batch is cut strictly every ``batch_size`` records
    in arrival order, whatever the decode chunk size (a chunk larger than
    the batch is cut inside, smaller ones accumulate); its bounds are its
    first and last record's event time, and the trailing partial batch
    flushes at the end of the stream.

    The JAX package's ``snapshot``/``restore`` are not ported: the port
    has no checkpoint coordinator."""

    def __init__(self, batch_size: int):
        self.batch_size = max(1, int(batch_size))
        self._buf: List = []
        self._count = 0

    def add_chunk(self, chunk) -> Iterator[Tuple[int, int, LazyRecords]]:
        """Buffer one :class:`PointChunk` as slices, yielding every batch
        it completes."""
        n, pos = len(chunk), 0
        while pos < n:
            take = min(self.batch_size - self._count, n - pos)
            self._buf.append((chunk, np.arange(pos, pos + take)))
            self._count += take
            pos += take
            if self._count >= self.batch_size:
                yield self._cut()

    def batches(self, chunks: Iterable) -> Iterator[Tuple[int, int,
                                                          LazyRecords]]:
        """Drive a stream of decoded chunks to its end, then flush the
        partial batch."""
        for ch in chunks:
            yield from self.add_chunk(ch)
        if self._buf:
            yield self._cut()

    def _cut(self) -> Tuple[int, int, LazyRecords]:
        buf, self._buf, self._count = self._buf, [], 0
        (first, fi), (last, li) = buf[0], buf[-1]
        return (int(first.parsed.ts[fi[0]]), int(last.parsed.ts[li[-1]]),
                LazyRecords(buf))


def count_windows(chunks: Iterable, size: int, slide: int
                  ) -> Iterator[Tuple[int, int, LazyRecords]]:
    """Sliding count windows over a stream of decoded chunks (Flink
    ``countWindow(size, slide)`` on an unkeyed stream): every ``slide``
    arrivals, the last ``size`` records. A window's bounds are its
    records' min and max event time, and the end is INCLUSIVE, unlike the
    half-open time windows. Windows overlap by ``size - slide`` records,
    so one chunk's slices can sit in several windows; a trailing partial
    slide emits nothing."""
    size, slide = max(1, int(size)), max(1, int(slide))
    segs: deque = deque()  # (chunk, lo, hi): the last <= size arrivals
    held = arrived = 0
    for ch in chunks:
        n, pos = len(ch), 0
        while pos < n:
            take = min(slide - arrived % slide, n - pos)
            segs.append((ch, pos, pos + take))
            held += take
            arrived += take
            pos += take
            while held > size:  # drop the oldest records past `size`
                c, lo, hi = segs[0]
                drop = min(held - size, hi - lo)
                if drop == hi - lo:
                    segs.popleft()
                else:
                    segs[0] = (c, lo + drop, hi)
                held -= drop
            if arrived % slide == 0:
                ts = [c.parsed.ts[lo:hi] for c, lo, hi in segs]
                yield (int(min(t.min() for t in ts)),
                       int(max(t.max() for t in ts)),
                       LazyRecords([(c, np.arange(lo, hi))
                                    for c, lo, hi in segs]))
