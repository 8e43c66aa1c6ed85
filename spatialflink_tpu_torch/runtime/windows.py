"""Window assembly over decoded chunks (port of ``WindowSpec``,
``WindowAssembler``, ``PaneBuffer`` and ``MicroBatcher`` in
``spatialflink_tpu.runtime.windows``, and of the count windows and micro-
batches of ``SpatialOperator._count_windows`` / ``_micro_batches``).

Event-time windows are Flink-compatible: a sliding window of (size, slide)
covers [start, start + size) for starts aligned to ``slide``; each record
belongs to the windows whose interval contains its event time. Windows seal
when the watermark passes their end; records below the watermark are late
and dropped. Emission granularity is one decoded chunk, as in the JAX
package.

One chunk protocol serves both stream kinds: a chunk (a columnar
``PointChunk`` of a point stream, or a ``GeomChunk`` of parsed polygons and
linestrings) has a length, an int64 ``ts`` column and ``view(segs)``, which
turns ``(chunk, idx)`` slices into the window's records (``LazyRecords`` /
``GeomRecords``). Every buffer holds such slices (the port cuts object
streams into chunks too), so the JAX package's ``_ColumnarSeg`` marker and
``_finalize_buffer``, which tell slices from plain records in a buffer,
have nothing to tell apart here; the JAX package's per-record
``add_chunk`` / ``add_records`` paths of object streams are these same
slices.

Checkpoints: ``snapshot(encode)`` / ``restore(state, decode)`` of
:class:`WindowAssembler`, :class:`PaneBuffer` and :class:`MicroBatcher` are
the JAX package's JSON forms (each open buffer's records encoded one by
one, GeoJSON with raw epoch-ms in the coordinator's codec; point records
encode from their columns and decode in one native parse), so a buffer
saved by either package restores in the other. A restored buffer's records
wait until the next chunk arrives (or the stream ends); they then become
one chunk per buffer that shares that chunk's id interner, so a window
mixing restored and fresh records has one id space. Where the decode's
interner was itself restored from the checkpoint, the restored records
keep the ids the uninterrupted run gave them, and kNN ties break as they
would have.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from spatialflink_tpu_torch.runtime.watermarks import BoundedOutOfOrderness


@dataclass(frozen=True)
class WindowSpec:
    size_ms: int
    slide_ms: int

    @staticmethod
    def sliding(size_ms: int, slide_ms: int) -> "WindowSpec":
        return WindowSpec(size_ms, slide_ms)

    def pane_of(self, ts_ms: int) -> int:
        """Start of the slide-aligned pane [p, p + slide) holding
        ``ts_ms``."""
        return ts_ms - (ts_ms % self.slide_ms)

    def pane_decomposable(self) -> bool:
        """Every window [s, s + size) is exactly a union of slide-aligned
        panes: slide divides size, and slide < size (a tumbling window has
        overlap 1 and shares nothing)."""
        return (self.slide_ms < self.size_ms
                and self.size_ms % self.slide_ms == 0)

    def pane_starts(self, window_start: int) -> List[int]:
        """The pane starts covering window ``[window_start, +size)``."""
        return list(range(window_start, window_start + self.size_ms,
                          self.slide_ms))

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


def _view(segs):
    """A sealed buffer's records: its chunks' own view of the slices."""
    return segs[0][0].view(segs)


def view_objects(view) -> list:
    """A window's records (``LazyRecords`` / ``GeomRecords``) as objects
    (``Point`` or geometry), in order: the record shape of a snapshot."""
    if hasattr(view, "records"):  # GeomRecords
        return view.records()
    return list(view.take(np.arange(len(view))))


def encode_view(view, encode) -> list:
    """A window's records encoded one by one; point records straight from
    their columns where ``encode`` is the GeoJSON record codec (the same
    text, without a Point object per record)."""
    fmt = getattr(encode, "fmt", None)
    if fmt and hasattr(view, "take"):
        out = view.take(np.arange(len(view))).serialize_batch(fmt)
        if out is not None:
            return out
    return [encode(o) for o in view_objects(view)]


def decode_records(recs, decode):
    """Restored records: one columnar chunk (with an interner of its own)
    where the codec's point decode takes them all, else decoded
    objects."""
    fast = getattr(decode, "points", None)
    if fast is not None and recs:
        chunk = fast(recs)
        if chunk is not None:
            return chunk
    return [decode(r) for r in recs]


def restored_view(recs, decode):
    """Encoded records restored as a window's records, over one chunk."""
    return _view([_rebuild(decode_records(recs, decode))])


def _reintern(chunk, interner):
    """A point chunk with its ids interned through ``interner``, new ones
    in order of first appearance."""
    from spatialflink_tpu_torch.streams.bulk import ParsedPoints, PointChunk

    p = chunk.parsed
    uniq, first, inv = np.unique(p.obj_id, return_index=True,
                                 return_inverse=True)
    ids = np.empty(uniq.shape[0], np.int32)
    for j in np.argsort(first, kind="stable").tolist():
        ids[j] = interner.intern(p.interner.lookup(int(uniq[j])))
    parsed = ParsedPoints(x=p.x, y=p.y, ts=p.ts,
                          obj_id=ids[inv.reshape(-1)], interner=interner)
    return PointChunk(parsed=parsed, cells=chunk.cells,
                      ingest_ms=chunk.ingest_ms)


def _rebuild(restored, like=None):
    """``(chunk, idx)`` over one chunk of restored records (a columnar
    chunk of :func:`decode_records`, or objects). Points share ``like``'s
    interner (the chunk they will share windows with) when it has one;
    geometries go into a geometry chunk."""
    from spatialflink_tpu_torch.models import Point
    from spatialflink_tpu_torch.streams.bulk import (GeomChunk, PointChunk,
                                                     points_to_parsed)
    from spatialflink_tpu_torch.utils import IdInterner

    if isinstance(restored, PointChunk):
        chunk = (_reintern(restored, like.parsed.interner)
                 if isinstance(like, PointChunk) else restored)
    elif isinstance(restored[0], Point):
        interner = (like.parsed.interner if isinstance(like, PointChunk)
                    else IdInterner())
        chunk = PointChunk(parsed=points_to_parsed(restored, interner),
                           cells=np.array([p.cell for p in restored],
                                          np.int32),
                           ingest_ms=int(time.time() * 1000))
    else:
        chunk = GeomChunk(restored)
    return chunk, np.arange(len(chunk))


class _Restorable:
    """The restored-buffer plumbing the three assemblers share:
    ``_restored`` maps a buffer key to its restored records
    (:func:`decode_records`) until :meth:`_adopt` turns them into a chunk
    at the front of their buffer."""

    _restored: Dict

    def _adopt(self, like=None) -> None:
        if not self._restored:
            return
        restored, self._restored = self._restored, {}
        for key, recs in restored.items():
            if len(recs):
                self._buffer(key).insert(0, _rebuild(recs, like))

    def _decode_buffers(self, state: Dict, decode) -> Dict:
        return {int(k): decode_records(recs, decode)
                for k, recs in state.items()}

    def _encode_buffers(self, buffers: Dict, encode) -> Dict[str, list]:
        out = {str(k): encode_view(_view(segs), encode) if segs else []
               for k, segs in buffers.items()}
        for k, recs in self._restored.items():
            head = (encode_view(_view([(recs, np.arange(len(recs)))]),
                                encode) if not isinstance(recs, list)
                    else [encode(r) for r in recs])
            out.setdefault(str(k), [])[:0] = head
        return out


def _note_seals(starts) -> None:
    """Stamp the seal wall clock of every window a watermark sweep made
    ready, before any of them yields, on the telemetry session's latency
    plane (windows pulled later then count their wait behind earlier
    windows as ``queue``). One session check per sweep; nothing runs
    without a session."""
    from spatialflink_tpu_torch.utils import telemetry as _telemetry

    tel = _telemetry.active()
    if tel is None or not starts:
        return
    now = time.time()
    for s in starts:
        tel.latency.note_seal(s, now)


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


class WindowAssembler(_Restorable):
    """Buffers decoded chunks into event-time windows; yields sealed windows
    as ``(start, end, records)`` in start order."""

    def __init__(self, spec: WindowSpec, allowed_lateness_ms: int = 0):
        self.spec = spec
        self.watermarker = BoundedOutOfOrderness(allowed_lateness_ms)
        self._buffers: Dict[int, List] = {}
        self._restored: Dict[int, list] = {}
        self.late_dropped = 0

    def _buffer(self, start: int) -> List:
        return self._buffers.setdefault(start, [])

    def add_parsed_chunk(self, chunk) -> Iterator[Tuple]:
        """Buffer one decoded chunk as ``(chunk, idx)`` slices per window
        (late records dropped), then seal what the watermark passed."""
        self._adopt(chunk)
        ts = np.asarray(chunk.ts, np.int64)
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

    def assemble(self, chunks) -> Iterator[Tuple]:
        """Drive a stream of decoded chunks to its end, then seal every
        remaining window."""
        for ch in chunks:
            yield from self.add_parsed_chunk(ch)
        yield from self.flush()

    def _seal_until(self, watermark: int):
        ready = sorted(s for s in self._buffers
                       if s + self.spec.size_ms <= watermark)
        _note_seals(ready)
        for start in ready:
            yield (start, start + self.spec.size_ms,
                   _view(self._buffers.pop(start)))

    def flush(self):
        """Seal every remaining window (end of a bounded stream)."""
        self._adopt()
        ready = sorted(self._buffers)
        _note_seals(ready)
        for start in ready:
            yield (start, start + self.spec.size_ms,
                   _view(self._buffers.pop(start)))

    def snapshot(self, encode) -> dict:
        """The open windows for the checkpoint coordinator: the watermark,
        the late-drop count and every open window's records
        (``encode(record) -> str``). At a barrier every sealed window has
        been emitted, so this is what a resumed run needs beside the
        source position."""
        return {"watermark_max_ts": self.watermarker._max_ts,
                "late_dropped": self.late_dropped,
                "buffers": self._encode_buffers(self._buffers, encode)}

    def restore(self, state: dict, decode) -> None:
        """Inverse of :meth:`snapshot` (``decode(str) -> record``)."""
        self.watermarker._max_ts = int(state["watermark_max_ts"])
        self.late_dropped = int(state.get("late_dropped", 0))
        self._buffers = {}
        self._restored = self._decode_buffers(state["buffers"], decode)


class PaneBuffer(_Restorable):
    """Pane-sliced window assembly: each record is buffered ONCE, into its
    slide-aligned pane, and a sealed window is yielded as its list of
    panes, ``(start, end, [(pane_start, records), ...])`` in pane order,
    each pane's records a ``LazyRecords`` / ``GeomRecords`` view of its
    ``(chunk, idx)`` slices in arrival order.

    The window set, the sealing and the late drops are those of
    :class:`WindowAssembler` (the same watermark and the same per-record
    prefix-watermark late check, one seal sweep per chunk): a window exists
    iff one of its panes holds a record, and seals when the watermark
    passes its end. A pane is evicted once the watermark passes ``pane +
    size`` (its last window has sealed; a record that could still land in
    it would be late). Requires ``spec.pane_decomposable()``.

    The JAX package's per-record ``add`` (its geometry streams) is this
    chunk path: every stream reaches the port cut into chunks."""

    def __init__(self, spec: WindowSpec, allowed_lateness_ms: int = 0):
        if not spec.pane_decomposable():
            raise ValueError(
                f"PaneBuffer needs slide | size and slide < size, got "
                f"size={spec.size_ms} slide={spec.slide_ms}")
        self.spec = spec
        self.watermarker = BoundedOutOfOrderness(allowed_lateness_ms)
        self._panes: Dict[int, List] = {}
        self._restored: Dict[int, list] = {}
        self.late_dropped = 0
        #: every window start below this is emitted or final-empty
        self._next: Optional[int] = None

    def _buffer(self, pane: int) -> List:
        return self._panes.setdefault(pane, [])

    def add_parsed_chunk(self, chunk) -> Iterator[Tuple]:
        """Buffer one decoded chunk as ``(chunk, idx)`` slices per pane
        (late records dropped), then seal what the watermark passed."""
        self._adopt(chunk)
        ts = np.asarray(chunk.ts, np.int64)
        if not ts.size:
            return
        keep = _keep_mask(self.watermarker, ts)
        self.late_dropped += int((~keep).sum())
        kept_idx = np.nonzero(keep)[0]
        if kept_idx.size:
            kts = ts[kept_idx]
            pane = kts - kts % self.spec.slide_ms
            order = np.argsort(pane, kind="stable")
            pane_s = pane[order]
            bounds = np.flatnonzero(
                np.r_[True, pane_s[1:] != pane_s[:-1], True])
            for lo, hi in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
                self._panes.setdefault(int(pane_s[lo]), []).append(
                    (chunk, kept_idx[order[lo:hi]]))
        wm = self.watermarker.on_event(int(ts.max()))
        yield from self._seal_until(wm)

    def assemble(self, chunks) -> Iterator[Tuple]:
        """Drive a stream of decoded chunks to its end, then seal every
        remaining window."""
        for ch in chunks:
            yield from self.add_parsed_chunk(ch)
        yield from self.flush()

    def _seal_until(self, watermark: int) -> Iterator[Tuple]:
        if not self._panes:
            return
        limit = watermark - self.spec.size_ms  # starts <= limit seal
        lo = min(self._panes) - self.spec.size_ms + self.spec.slide_ms
        if self._next is not None:
            lo = max(lo, self._next)
        if lo > limit:
            return
        yield from self._emit_range(lo, limit)
        # every start <= limit is now emitted or final-empty (a kept record
        # has ts >= watermark, so its windows start past `limit`): record
        # that and drop the dead panes
        slide = self.spec.slide_ms
        self._next = limit - (limit % slide) + slide
        for p in [p for p in self._panes if p < self._next]:
            del self._panes[p]

    def _emit_range(self, lo: int, limit) -> Iterator[Tuple]:
        size, slide = self.spec.size_ms, self.spec.slide_ms
        starts = set()
        for p in self._panes:
            s = max(p - size + slide, lo)
            s1 = p if limit is None else min(p, limit)
            while s <= s1:
                starts.add(s)
                s += slide
        _note_seals(sorted(starts))
        for s in sorted(starts):
            panes = [(p, _view(self._panes[p]))
                     for p in range(s, s + size, slide) if p in self._panes]
            yield (s, s + size, panes)

    def flush(self) -> Iterator[Tuple]:
        """Seal every remaining window (end of a bounded stream)."""
        self._adopt()
        if not self._panes:
            return
        lo = min(self._panes) - self.spec.size_ms + self.spec.slide_ms
        if self._next is not None:
            lo = max(lo, self._next)
        yield from self._emit_range(lo, None)
        self._panes.clear()

    def snapshot(self, encode) -> dict:
        """The pane state for the checkpoint coordinator: the watermark,
        the late-drop count, the emitted frontier ``next`` and every live
        pane's records. A snapshot taken inside a seal sweep may emit an
        already delivered window again on resume; the window sink
        suppresses it, and nothing is lost."""
        return {"watermark_max_ts": self.watermarker._max_ts,
                "late_dropped": self.late_dropped,
                "next": self._next,
                "panes": self._encode_buffers(self._panes, encode)}

    def restore(self, state: dict, decode) -> None:
        """Inverse of :meth:`snapshot`."""
        self.watermarker._max_ts = int(state["watermark_max_ts"])
        self.late_dropped = int(state.get("late_dropped", 0))
        nxt = state.get("next")
        self._next = None if nxt is None else int(nxt)
        self._panes = {}
        self._restored = self._decode_buffers(state["panes"], decode)


class MicroBatcher(_Restorable):
    """Tumbling count micro-batches of the realtime mode: the reference's
    trigger fires per element; this batches ``batch_size`` arrivals per
    device dispatch. A batch is cut strictly every ``batch_size`` records
    in arrival order, whatever the decode chunk size (a chunk larger than
    the batch is cut inside, smaller ones accumulate); its bounds are its
    first and last record's event time, and the trailing partial batch
    flushes at the end of the stream. The open batch checkpoints like a
    window buffer."""

    def __init__(self, batch_size: int):
        self.batch_size = max(1, int(batch_size))
        self._buf: List = []
        self._count = 0
        self._restored: Dict[int, list] = {}

    def _buffer(self, _key) -> List:
        return self._buf

    def add_chunk(self, chunk) -> Iterator[Tuple]:
        """Buffer one decoded chunk as slices, yielding every batch it
        completes."""
        self._adopt(chunk)
        n, pos = len(chunk), 0
        while pos < n:
            take = min(self.batch_size - self._count, n - pos)
            self._buf.append((chunk, np.arange(pos, pos + take)))
            self._count += take
            pos += take
            if self._count >= self.batch_size:
                yield self._cut()

    def batches(self, chunks: Iterable) -> Iterator[Tuple]:
        """Drive a stream of decoded chunks to its end, then flush the
        partial batch."""
        for ch in chunks:
            yield from self.add_chunk(ch)
        self._adopt()
        if self._buf:
            yield self._cut()

    def snapshot(self, encode) -> dict:
        """The open micro-batch for the checkpoint coordinator."""
        return {"batch_size": self.batch_size,
                "records": self._encode_buffers({0: self._buf},
                                                encode).get("0", [])}

    def restore(self, state: dict, decode) -> None:
        """Inverse of :meth:`snapshot`: the restored records open the next
        batch."""
        recs = decode_records(state.get("records", []), decode)
        self._buf, self._restored = [], {0: recs} if len(recs) else {}
        self._count = len(recs)

    def _cut(self) -> Tuple:
        buf, self._buf, self._count = self._buf, [], 0
        (first, fi), (last, li) = buf[0], buf[-1]
        return int(first.ts[fi[0]]), int(last.ts[li[-1]]), _view(buf)


def count_windows(chunks: Iterable, size: int, slide: int
                  ) -> Iterator[Tuple]:
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
                ts = [c.ts[lo:hi] for c, lo, hi in segs]
                yield (int(min(t.min() for t in ts)),
                       int(max(t.max() for t in ts)),
                       _view([(c, np.arange(lo, hi)) for c, lo, hi in segs]))


# ------------------------------------------------------------------------ #
# two streams (the joins)


def merge_windows(gen_a: Iterable[Tuple], gen_b: Iterable[Tuple]
                  ) -> Iterator[Tuple]:
    """Outer merge of two start-ordered ``(start, end, records)`` window
    streams into ``(start, end, records_a | None, records_b | None)``.

    The JAX package's windowed join feeds the two streams record by record
    in time order through two assemblers and, after each record, emits the
    windows sealed on both sides or wholly below both watermarks. A window
    sealed on one side holds all of that side's records, and a window once
    emitted gets no more records on either side (they would be late), so
    every window of either side is emitted once, in start order: this
    merge of the two assemblers' own window streams."""
    gen_a, gen_b = iter(gen_a), iter(gen_b)
    a, b = next(gen_a, None), next(gen_b, None)
    while a is not None or b is not None:
        if b is None or (a is not None and a[0] < b[0]):
            yield a[0], a[1], a[2], None
            a = next(gen_a, None)
        elif a is None or b[0] < a[0]:
            yield b[0], b[1], None, b[2]
            b = next(gen_b, None)
        else:
            yield a[0], a[1], a[2], b[2]
            a, b = next(gen_a, None), next(gen_b, None)


def merge_by_time(chunks_a: Iterable, chunks_b: Iterable) -> Iterator[Tuple]:
    """Two streams of decoded chunks as one arrival sequence, in the order
    of the JAX package's ``heapq.merge`` on event time (side 0 first on
    equal keys), as ``(side, chunk, idx)`` runs.

    ``heapq.merge`` compares the heads of two streams that need not be in
    time order; its order equals a stable merge on each side's running
    maximum of event time, which is nondecreasing, so whole chunks merge
    with ``searchsorted``. A record's place is known once the other side
    has a later key, so the merge pulls one chunk at a time from the side
    that runs out."""
    its = (iter(chunks_a), iter(chunks_b))
    pend: Tuple[List, List] = ([], [])  # per side: (chunk, idx, keys)
    done = [False, False]
    runmax = [-(2 ** 63), -(2 ** 63)]

    def pull(s: int) -> None:
        for ch in its[s]:
            if len(ch):
                keys = np.maximum.accumulate(
                    np.maximum(np.asarray(ch.ts, np.int64), runmax[s]))
                runmax[s] = int(keys[-1])
                pend[s].append((ch, np.arange(len(ch)), keys))
                return
        done[s] = True

    def take(s: int, upto_key: int, strict: bool):
        """Pop the side's pending records with key < (or <=) upto_key."""
        out, keys = [], []
        while pend[s]:
            ch, idx, k = pend[s][0]
            cut = int(np.searchsorted(k, upto_key,
                                      side="left" if strict else "right"))
            if cut:
                out.append((ch, idx[:cut]))
                keys.append(k[:cut])
            if cut < k.size:
                pend[s][0] = (ch, idx[cut:], k[cut:])
                break
            pend[s].pop(0)
        return out, (np.concatenate(keys) if keys
                     else np.zeros(0, np.int64))

    def runs(side_segs, side_pos):
        """(side, chunk, idx) runs of the merged records, in merge order."""
        items = []
        for s in (0, 1):
            off = 0
            for ch, idx in side_segs[s]:
                pos = side_pos[s][off:off + idx.size]
                off += idx.size
                # split a segment where the other side's records interleave
                brk = np.flatnonzero(np.diff(pos) != 1) + 1
                for lo, hi in zip(np.r_[0, brk], np.r_[brk, idx.size]):
                    items.append((int(pos[lo]), s, ch, idx[lo:hi]))
        items.sort(key=lambda it: it[0])
        for _, s, ch, idx in items:
            yield s, ch, idx

    while True:
        for s in (0, 1):
            if not pend[s] and not done[s]:
                pull(s)
        if not pend[0] and not pend[1]:
            return
        if not pend[0] or not pend[1]:
            s = 0 if pend[0] else 1
            for ch, idx, _ in pend[s]:
                yield s, ch, idx
            pend[s].clear()
            continue
        last_a, last_b = int(pend[0][-1][2][-1]), int(pend[1][-1][2][-1])
        if last_a <= last_b:
            # every pending a is placed; b's with key < last_a go before it
            segs_a, ka = take(0, last_a, strict=False)
            segs_b, kb = take(1, last_a, strict=True)
        else:
            segs_a, ka = take(0, last_b, strict=False)
            segs_b, kb = take(1, last_b, strict=False)
        pos_a = np.arange(ka.size) + np.searchsorted(kb, ka, side="left")
        pos_b = np.arange(kb.size) + np.searchsorted(ka, kb, side="right")
        yield from runs((segs_a, segs_b), (pos_a, pos_b))
