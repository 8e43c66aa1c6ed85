"""The stop signals of a run (port of ``ControlTupleExit``,
``GracefulShutdown``, the shutdown flag and ``check_exit_control_tuple`` of
``spatialflink_tpu.utils.metrics``).

GeoFlink stops a Kafka job with a control tuple
(``HelperClass.checkExitControlTuple``): a record whose geometry type is
``control``. The decode raises :class:`ControlTupleExit` at the record
that carries it, after the records before it reached the pipeline, and the
driver ends the run with exit code 0. A SIGTERM sets the process-wide
shutdown flag; the decode sees it at the next record and raises
:class:`GracefulShutdown`, and the driver writes a final checkpoint.

The registry (port of ``Counter``, ``Meter``, ``MetricsRegistry``,
``REGISTRY``, ``set_registry`` and ``scoped_registry``): named counters and
meters, read at call time through ``metrics.REGISTRY`` so that
:func:`scoped_registry` can give a run or a test a registry of its own. The
adaptive grid counts into it: the prefilter's ``prefilter-records``,
``prefilter-kept``, ``prefilter-windows-skipped`` and
``prefilter-mask-recomputes``, and the repartition controller's
``repartitions``, ``grid-splits`` and ``grid-merges``.

The rest (port of ``degradation_snapshot``, ``metered``, ``trace`` and
``profile_to``): the degradation digest of the run summary, a metered
record stream, and the profiler. :func:`profile_to` runs a
``torch.profiler`` capture (CPU and CUDA activities) and writes its Chrome
trace; while it runs, :func:`trace` is a ``torch.profiler.record_function``
annotation, and a shared null context otherwise (one module flag read
per call), so a run without a capture opens no profiler range.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import deque
from typing import Dict, Iterable, Iterator, Optional


class ControlTupleExit(Exception):
    """A control tuple arrived: stop the job (the reference throws an
    IOException to end the Flink job)."""


class GracefulShutdown(ControlTupleExit):
    """A SIGTERM-style stop: the buffered records are drained into the
    pipeline, sealed windows emit, and the driver writes a final
    checkpoint and exits 0."""


_SHUTDOWN = threading.Event()


def request_shutdown() -> None:
    """Ask the running pipeline to stop at the next record boundary (safe
    in a signal handler: it only sets an event)."""
    _SHUTDOWN.set()


def shutdown_requested() -> bool:
    return _SHUTDOWN.is_set()


def clear_shutdown() -> None:
    """Reset the flag (at run start, and between tests)."""
    _SHUTDOWN.clear()


def check_exit_control_tuple(record) -> None:
    """Raise :class:`ControlTupleExit` if ``record`` (a raw GeoJSON string
    or dict, optionally in a Kafka ``{"value": ...}`` envelope) is a
    control tuple; a cheap substring test first."""
    obj = record
    if isinstance(obj, str):
        if '"control"' not in obj:
            return
        try:
            obj = json.loads(obj)
        except ValueError:
            return
    if isinstance(obj, dict):
        env = obj.get("value")
        if isinstance(env, dict):
            obj = env
        geom = obj.get("geometry", obj)
        if isinstance(geom, dict) and geom.get("type") == "control":
            raise ControlTupleExit("control tuple received")


class Counter:
    __slots__ = ("name", "count")

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def inc(self, n: int = 1) -> None:
        self.count += n


class Meter:
    """Events per second over a sliding time window (default 60 s), in
    one-second buckets (at most ``window_s`` of them)."""

    def __init__(self, name: str, window_s: float = 60.0):
        self.name = name
        self.window_s = window_s
        self.count = 0
        self._buckets = deque()  # [whole_second, n], ascending

    def mark(self, n: int = 1, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        self.count += n
        sec = int(now)
        if self._buckets and self._buckets[-1][0] == sec:
            self._buckets[-1][1] += n
        else:
            self._buckets.append([sec, n])
            self._evict(now)

    def _evict(self, now: float) -> None:
        horizon = now - self.window_s - 1
        while self._buckets and self._buckets[0][0] < horizon:
            self._buckets.popleft()

    def rate(self, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        self._evict(now)
        if not self._buckets:
            return 0.0
        span = max(now - self._buckets[0][0], 1.0)
        return sum(n for _, n in self._buckets) / span


class MetricsRegistry:
    """Named counters and meters; :meth:`snapshot` reads them all. Handle
    creation, reset and snapshot hold the instance lock; ``inc`` and
    ``mark`` do not."""

    def __init__(self):
        self.counters: Dict[str, Counter] = {}
        self.meters: Dict[str, Meter] = {}
        self._lock = threading.Lock()

    def reset(self) -> None:
        """Drop every counter and meter (handles taken before stay usable
        but are no longer read)."""
        with self._lock:
            self.counters.clear()
            self.meters.clear()

    def counter(self, name: str) -> Counter:
        with self._lock:
            if name not in self.counters:
                self.counters[name] = Counter(name)
            return self.counters[name]

    def meter(self, name: str, window_s: float = 60.0) -> Meter:
        with self._lock:
            if name not in self.meters:
                self.meters[name] = Meter(name, window_s)
            return self.meters[name]

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            counters = list(self.counters.items())
            meters = list(self.meters.items())
        out: Dict[str, float] = {}
        for n, c in counters:
            out[n] = c.count
        for n, m in meters:
            out[f"{n}.count"] = m.count
            out[f"{n}.rate"] = m.rate()
        return out


#: the process-wide default registry; read it as ``metrics.REGISTRY`` at
#: call time (a ``from ... import REGISTRY`` binds the registry of that
#: moment)
REGISTRY = MetricsRegistry()


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Install ``registry`` as the default; returns the previous one."""
    global REGISTRY
    old = REGISTRY
    REGISTRY = registry
    return old


@contextlib.contextmanager
def scoped_registry(registry: Optional[MetricsRegistry] = None
                    ) -> Iterator[MetricsRegistry]:
    """Run the block against a fresh (or the given) registry and restore
    the previous one on exit."""
    reg = MetricsRegistry() if registry is None else registry
    old = set_registry(reg)
    try:
        yield reg
    finally:
        set_registry(old)


#: counter-name prefixes that mean "the transport or pipeline degraded and
#: recovery machinery engaged" (the JAX package's chaos, retry, breaker,
#: dead-letter and verified-produce counters; the port bumps them once those
#: planes are ported)
DEGRADATION_PREFIXES = ("chaos-", "retry-", "breaker-", "dlq-",
                        "produce-verified")


def degradation_snapshot(registry: Optional[MetricsRegistry] = None
                         ) -> Dict[str, int]:
    """The non-zero degradation counters (:data:`DEGRADATION_PREFIXES`):
    the run summary's digest of how rough the transport was."""
    reg = REGISTRY if registry is None else registry
    with reg._lock:
        counters = sorted(reg.counters.items())
    return {n: c.count for n, c in counters
            if c.count and n.startswith(DEGRADATION_PREFIXES)}


def metered(stream: Iterable, meter: Meter,
            control_check: bool = False) -> Iterator:
    """A record stream that marks ``meter`` per record and, with
    ``control_check``, raises on a control tuple."""
    for rec in stream:
        if control_check:
            check_exit_control_tuple(rec)
        meter.mark()
        yield rec


_PROFILING = False
_NULL_CM = contextlib.nullcontext()


def trace(name: str):
    """A named ``torch.profiler.record_function`` range while a
    :func:`profile_to` capture runs; a shared null context otherwise. An
    exception raised in the block propagates unchanged."""
    if not _PROFILING:
        return _NULL_CM
    from torch.profiler import record_function

    return record_function(name)


@contextlib.contextmanager
def profile_to(log_dir: str, device=None):
    """Capture a ``torch.profiler`` trace of the block (CPU activity, and
    CUDA activity when ``device`` is a CUDA device or, with ``device``
    None, when CUDA is available) and write it to
    ``<log_dir>/trace.json`` (Chrome trace format, Perfetto-loadable).
    Annotations from :func:`trace` name the operators' stages in it."""
    global _PROFILING
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    dev = None if device is None else torch.device(device)
    cuda = (dev.type == "cuda" if dev is not None
            else torch.cuda.is_available())
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.__enter__()
    _PROFILING = True
    try:
        yield prof
    finally:
        _PROFILING = False
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
