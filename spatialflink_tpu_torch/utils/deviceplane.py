"""The device plane (port of ``spatialflink_tpu.utils.deviceplane`` for
CUDA): the compile registry, the recompile sentinel, device memory and
provenance, and the post-mortem flight recorder.

The port has no JIT, so "a compile" means one of two things here:

- a kernel library that :func:`~spatialflink_tpu_torch.ops.native.build`
  compiles with ``nvcc`` or that :func:`~spatialflink_tpu_torch.ops.native.
  load` loads into the process (:meth:`CompileRegistry.note_library`),
  with its nvcc seconds and its ``ptxas`` report;
- the first call of a kernel entry point at a new signature: the padded
  shapes and dtypes of its tensor arguments and the values of its static
  arguments, formed as the JAX package's ``_signature`` forms them
  (:func:`instrumented_kernel`, the twin of ``instrumented_jit``). A
  window batch padded to a bucket the run has seen costs one dict lookup
  on a tuple; no device value is read.

The sentinel (:meth:`CompileRegistry.begin_run` / :meth:`~CompileRegistry.
mark_warm` / :meth:`~CompileRegistry.end_run`) turns every compile after
the declared warmup into a ``recompile`` event and a ``device-recompiles``
count, and under ``--strict-recompile`` raises :class:`RecompileError`
(the driver exits 3).

:func:`backend_provenance` reports platform ``gpu`` for a CUDA run and
``cpu`` otherwise, with the card's name, the device count and the torch
and CUDA versions; :func:`device_memory` reads ``torch.cuda.
memory_stats`` (allocated bytes, current and peak) and the card's total
memory, and says ``available: False`` on the CPU. No probe synchronizes
the device or reads a tensor. :class:`FlightRecorder` dumps the post-mortem
bundle (``python -m spatialflink_tpu_torch.doctor``) on a crash, a strict
recompile abort, SIGUSR1 or an explicit :meth:`~FlightRecorder.dump`;
the file names and keys of the bundle, of :func:`status_block` and of the
registry's snapshot are the JAX package's, so either package's doctor
reads either package's bundle.

Nothing here runs per record: the registry's lookup runs per kernel call,
the probes per snapshot, and the recorder exists only under
``--postmortem-dir``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import signal
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from spatialflink_tpu_torch.utils import metrics as _metrics

#: bundle layout version (the doctor refuses bundles it cannot read); the
#: JAX package's, so the two packages' doctors read each other's bundles
BUNDLE_SCHEMA = 3


class RecompileError(Exception):
    """A compile after the declared warmup under ``--strict-recompile``."""


# --------------------------------------------------------------------- #
# signatures (the JAX package's ``_signature`` form: ``dtype[AxB]`` per
# tensor leaf, the Python value of a static argument, ``float32[]`` /
# ``int32[]`` / ``bool[]`` for a scalar that JAX would trace)

_SCALAR = {bool: "bool[]", int: "int32[]", float: "float32[]"}


def _leaves(x, out: list) -> None:
    """Flatten ``x`` as ``jax.tree_util.tree_leaves`` does: tuples, lists,
    named tuples, dataclasses and dicts (sorted keys) open up; None is an
    empty subtree."""
    if x is None:
        return
    if isinstance(x, (tuple, list)):
        for v in x:
            _leaves(v, out)
    elif isinstance(x, dict):
        for k in sorted(x):
            _leaves(x[k], out)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _leaves(getattr(x, f.name), out)
    else:
        out.append(x)


def _leaf_key(x):
    """The hashable key of one dynamic leaf."""
    shape = getattr(x, "shape", None)
    if shape is not None:
        return (tuple(shape), str(getattr(x, "dtype", "")))
    t = type(x)
    return _SCALAR.get(t, t.__name__)


def _leaf_str(x) -> str:
    shape = getattr(x, "shape", None)
    if shape is not None:
        dtype = str(getattr(x, "dtype", "?")).replace("torch.", "")
        return f"{dtype}[{'x'.join(str(int(d)) for d in shape)}]"
    t = type(x)
    if t in _SCALAR:
        return _SCALAR[t]
    r = repr(x)
    return r if len(r) <= 48 else r[:45] + "..."


def _static_str(x) -> str:
    r = repr(x)
    return r if len(r) <= 48 else r[:45] + "..."


def _key(args, kwargs, static: frozenset) -> tuple:
    leaves: list = []
    _leaves(args, leaves)
    key = [_leaf_key(v) for v in leaves]
    for k in sorted(kwargs):
        v = kwargs[k]
        if k in static:
            key.append((k, v if isinstance(v, (int, float, str, bool,
                                               type(None)))
                        else repr(v)))
        else:
            sub: list = []
            _leaves(v, sub)
            key.append((k, tuple(_leaf_key(s) for s in sub)))
    return tuple(key)


def _signature(args, kwargs, static: frozenset) -> str:
    leaves: list = []
    _leaves(args, leaves)
    parts = [_leaf_str(v) for v in leaves]
    for k in sorted(kwargs):
        v = kwargs[k]
        if k in static:
            parts.append(f"{k}={_static_str(v)}")
            continue
        sub: list = []
        _leaves(v, sub)
        parts.extend(f"{k}={_leaf_str(s)}" for s in sub)
    return "(" + ", ".join(parts) + ")"


class CompileEntry:
    """One instrumented kernel entry point's (or one kernel library's)
    compile history; :meth:`to_dict` has the JAX package's keys."""

    __slots__ = ("name", "module", "kind", "jit_kwargs", "compiles",
                 "recompiles", "trace_ms", "backend_compile_ms",
                 "signatures", "first_compile_ms", "last_compile_ms",
                 "seen", "ptxas")

    def __init__(self, name: str, module: str, jit_kwargs: dict,
                 kind: str = "kernel"):
        self.name = name
        self.module = module
        self.kind = kind
        self.jit_kwargs = {k: repr(v) for k, v in sorted(jit_kwargs.items())}
        self.compiles = 0
        self.recompiles = 0          # post-warmup compiles, cumulative
        #: wall ms of each new signature's first call (its host dispatch)
        self.trace_ms = 0.0
        #: nvcc wall ms of a library this process compiled
        self.backend_compile_ms = 0.0
        self.signatures: deque = deque(maxlen=8)
        self.first_compile_ms: Optional[int] = None
        self.last_compile_ms: Optional[int] = None
        #: the signature keys seen in this process (the hot path's lookup)
        self.seen: set = set()
        #: a library's ``ptxas_report`` rows
        self.ptxas: Optional[list] = None

    @property
    def qualname(self) -> str:
        return f"{self.module}.{self.name}"

    def cache_size(self) -> int:
        return len(self.seen)

    def to_dict(self, cost: bool = False) -> dict:
        out = {
            "name": self.name,
            "module": self.module,
            "kind": self.kind,
            "jit_kwargs": dict(self.jit_kwargs),
            "compiles": self.compiles,
            "recompiles": self.recompiles,
            "trace_ms": round(self.trace_ms, 3),
            "backend_compile_ms": round(self.backend_compile_ms, 3),
            "cache_size": self.cache_size(),
            "first_compile_ms": self.first_compile_ms,
            "last_compile_ms": self.last_compile_ms,
            "signatures": list(self.signatures),
        }
        if self.ptxas is not None:
            out["ptxas"] = list(self.ptxas)
        if cost:
            # XLA's cost analysis has no counterpart for a hand-written
            # kernel: PERF.md's bounds come from the chip script instead
            out["cost_analysis"] = None
            out["cost_analysis_error"] = "no cost analysis for CUDA kernels"
        return out


class CompileRegistry:
    """The process's ledger of instrumented kernel entry points and kernel
    libraries, with the recompile sentinel's state."""

    def __init__(self):
        self.entries: Dict[str, CompileEntry] = {}
        self._lock = threading.Lock()
        self.warm = False
        self.warm_reason: Optional[str] = None
        self.warm_at_ms: Optional[int] = None
        self.strict = False
        #: compiles since begin_run() / since its mark_warm()
        self.run_compiles = 0
        self.run_recompiles = 0
        self.total_compiles = 0

    # ------------------------------ feeding --------------------------- #

    def register(self, fun, jit_kwargs: dict,
                 kind: str = "kernel") -> CompileEntry:
        name = getattr(fun, "__qualname__", getattr(fun, "__name__", "?"))
        module = getattr(fun, "__module__", "?")
        entry = CompileEntry(name, module, jit_kwargs, kind)
        with self._lock:
            self.entries[f"{module}.{name}"] = entry
        return entry

    def _count(self, entry: CompileEntry, sig: str, dt_s: float) -> None:
        """One compile of ``entry``: counted, and after warmup a
        ``recompile`` event (and an abort under strict mode)."""
        now_ms = int(time.time() * 1000)
        with self._lock:
            entry.compiles += 1
            entry.trace_ms += dt_s * 1e3
            entry.signatures.append({"ts_ms": now_ms, "signature": sig,
                                     "post_warmup": self.warm})
            if entry.first_compile_ms is None:
                entry.first_compile_ms = now_ms
            entry.last_compile_ms = now_ms
            self.total_compiles += 1
            self.run_compiles += 1
            warm, strict = self.warm, self.strict
            if warm:
                entry.recompiles += 1
                self.run_recompiles += 1
        _metrics.REGISTRY.counter("device-compiles").inc()
        if warm:
            _metrics.REGISTRY.counter("device-recompiles").inc()
            from spatialflink_tpu_torch.utils.telemetry import emit_event

            emit_event("recompile", fn=entry.qualname, signature=sig,
                       warm_reason=self.warm_reason, strict=strict)
            if strict:
                raise RecompileError(
                    f"new kernel signature {entry.qualname}{sig} after "
                    f"declared warmup ({self.warm_reason!r}) under "
                    "--strict-recompile; the zero-recompile contract is "
                    "violated")

    def note_library(self, name: str, build_s: float = 0.0,
                     log: str = "") -> None:
        """A kernel library came into the process: compiled with nvcc
        (``build_s`` > 0, ``log`` its ``-Xptxas -v`` output) or loaded as
        built. Counted once per library per process."""
        key = f"spatialflink_tpu_torch.csrc.{name}"
        with self._lock:
            entry = self.entries.get(key)
            if entry is None:
                entry = self.entries[key] = CompileEntry(
                    name, "spatialflink_tpu_torch.csrc",
                    {"nvcc": "sm_90a"}, kind="library")
            if "library" in entry.seen:
                return
            entry.seen.add("library")
            entry.backend_compile_ms += build_s * 1e3
        if log:
            from spatialflink_tpu_torch.ops.native import ptxas_report

            entry.ptxas = ptxas_report(log)
        self._count(entry, f"(lib{name}.so, nvcc {build_s:.3f}s)" if build_s
                    else f"(lib{name}.so, loaded)", 0.0)

    # ------------------------------ sentinel -------------------------- #

    def begin_run(self, strict: bool = False) -> None:
        """Start a sentinel run: warmup re-opens, run counters reset."""
        with self._lock:
            self.warm = False
            self.warm_reason = None
            self.warm_at_ms = None
            self.strict = bool(strict)
            self.run_compiles = 0
            self.run_recompiles = 0

    def mark_warm(self, reason: str) -> None:
        """Declare warmup done: from here every compile is a ``recompile``
        event (and an abort under strict mode)."""
        with self._lock:
            if not self.warm:
                self.warm = True
                self.warm_reason = reason
                self.warm_at_ms = int(time.time() * 1000)
        from spatialflink_tpu_torch.utils.telemetry import emit_event

        emit_event("sentinel-warm", reason=reason)

    def end_run(self) -> None:
        """Close the sentinel run: warm and strict reset, so a later run in
        the process starts cold."""
        with self._lock:
            self.warm = False
            self.warm_reason = None
            self.strict = False

    # ------------------------------ reading --------------------------- #

    def snapshot(self, cost: bool = False) -> dict:
        """The registry document (the JAX package's ``GET /compile``)."""
        with self._lock:
            entries = list(self.entries.values())
            head = {
                "ts_ms": int(time.time() * 1000),
                "functions": len(entries),
                "total_compiles": self.total_compiles,
                "run_compiles": self.run_compiles,
                "post_warmup_compiles": self.run_recompiles,
                "warm": self.warm,
                "warm_reason": self.warm_reason,
                "warm_at_ms": self.warm_at_ms,
                "strict": self.strict,
            }
        head["entries"] = sorted((e.to_dict(cost=cost) for e in entries),
                                 key=lambda d: (-d["compiles"], d["name"]))
        return head


_REGISTRY = CompileRegistry()


def registry() -> CompileRegistry:
    """The process's compile registry."""
    return _REGISTRY


def instrumented_kernel(fun=None, *, static=()):
    """Register a kernel entry point in the compile registry: its first
    call at each new signature (tensor shapes and dtypes, the values of the
    keyword arguments named in ``static``) is counted as a compile. A
    signature already seen costs one set lookup on a tuple. Usable bare or
    as ``instrumented_kernel(static=("n", "k"))``."""
    if fun is None:
        return lambda f: instrumented_kernel(f, static=static)
    statics = frozenset(static)
    entry = _REGISTRY.register(
        fun, {"static_argnames": tuple(static)} if static else {})
    seen = entry.seen

    @functools.wraps(fun)
    def wrapper(*args, **kwargs):
        key = _key(args, kwargs, statics)
        if key in seen:
            return fun(*args, **kwargs)
        t0 = time.perf_counter()
        out = fun(*args, **kwargs)
        seen.add(key)
        _REGISTRY._count(entry, _signature(args, kwargs, statics),
                         time.perf_counter() - t0)
        return out

    wrapper.compile_entry = entry
    return wrapper


# --------------------------------------------------------------------- #
# device resources


_PROVENANCE: Dict[str, dict] = {}


def _run_platform(device=None) -> str:
    """``gpu`` for a CUDA run, ``cpu`` otherwise (``device`` None: the
    default device of the port's entry points, CUDA when present)."""
    import torch

    if device is None:
        return "gpu" if torch.cuda.is_available() else "cpu"
    return "gpu" if torch.device(device).type == "cuda" else "cpu"


def backend_provenance(target: str = "gpu", device=None) -> dict:
    """Backend identity for snapshots and bundles: platform (``gpu`` or
    ``cpu``), the card's name, the device count, the torch and CUDA
    versions, and whether the platform is ``target``
    (``valid_for_target``; false on the CPU). Cached per platform."""
    import torch

    platform = _run_platform(device)
    prov = _PROVENANCE.get(platform)
    if prov is None:
        cuda = platform == "gpu"
        n = torch.cuda.device_count() if cuda else 0
        prov = _PROVENANCE[platform] = {
            "platform": platform,
            "device_kind": (torch.cuda.get_device_name(0) if cuda
                            else "cpu"),
            "device_count": n if cuda else 1,
            "local_device_count": n if cuda else 1,
            "process_index": 0,
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
        }
    out = dict(prov)
    out["target"] = target
    out["valid_for_target"] = out["platform"] == target
    return out


def device_memory(device=None) -> List[dict]:
    """Per-card memory rows: ``torch.cuda.memory_stats`` (allocated bytes,
    current and peak) and the card's total memory. A CPU run reports one
    row that says ``available: False``, as the JAX package's CPU device
    does."""
    import torch

    if _run_platform(device) != "gpu":
        return [{"id": 0, "kind": "cpu", "available": False}]
    rows = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        rows.append({
            "id": i, "kind": torch.cuda.get_device_name(i),
            "available": True,
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(torch.cuda.get_device_properties(i)
                               .total_memory) or None,
        })
    return rows


def memory_gauges(rows: Optional[List[dict]] = None, device=None) -> dict:
    """Live and peak gauges over :func:`device_memory` rows: the largest
    bytes in use over the cards and the summed peak; None values when no
    row has stats."""
    rows = device_memory(device) if rows is None else rows
    avail = [r for r in rows if r.get("available")]
    if not avail:
        return {"available": False, "bytes_in_use": None,
                "peak_bytes_in_use": None}
    return {
        "available": True,
        "bytes_in_use": max(r["bytes_in_use"] for r in avail),
        "peak_bytes_in_use": sum(r["peak_bytes_in_use"] for r in avail),
    }


def _d2h_bytes(reg: Optional[_metrics.MetricsRegistry] = None) -> int:
    """Device-to-host bytes read back on the pane path (the pane readback
    counters of ``operators.base``)."""
    reg = reg if reg is not None else _metrics.REGISTRY
    return (reg.counter("pane-partial-readback-bytes").count
            + reg.counter("pane-merged-readback-bytes").count)


def status_block(tel=None, registry_=None) -> dict:
    """The ``device`` block of every status snapshot: provenance, the
    sentinel's counts, the memory gauges, the d2h bytes and the kernel
    libraries loaded. Built per snapshot, never per record; the session's
    ``device`` decides the platform."""
    reg = _REGISTRY
    device = getattr(tel, "device", None)
    mem = memory_gauges(device=device)
    out = {
        "backend": backend_provenance(device=device),
        "compiles": reg.total_compiles,
        "run_compiles": reg.run_compiles,
        "recompiles": reg.run_recompiles,
        "warm": reg.warm,
        "strict": reg.strict,
        "mem_available": mem["available"],
        "mem_bytes_in_use": mem["bytes_in_use"],
        "mem_peak_bytes": mem["peak_bytes_in_use"],
        "d2h_bytes": _d2h_bytes(registry_),
    }
    with reg._lock:
        libs = sorted(e.name for e in reg.entries.values()
                      if e.kind == "library" and e.compiles)
    if libs:
        # the kernel libraries in the process (a port-only key: the JAX
        # block has no counterpart, and a CPU run has none)
        out["libraries"] = libs
    return out


def device_payload(tel=None) -> dict:
    """The bundle's ``device`` document: provenance, per-card memory, the
    transfer accounting, the dispatch-overlap distribution, the compile
    summary and the flight recorder's state."""
    device = getattr(tel, "device", None)
    mem_rows = device_memory(device)
    reg = _REGISTRY
    out = {
        "ts_ms": int(time.time() * 1000),
        "backend": backend_provenance(device=device),
        "memory": {"devices": mem_rows, **memory_gauges(mem_rows)},
        "transfer": {"d2h_bytes": _d2h_bytes()},
        "compile": {
            "functions": len(reg.entries),
            "total_compiles": reg.total_compiles,
            "post_warmup_compiles": reg.run_recompiles,
            "warm": reg.warm,
            "warm_reason": reg.warm_reason,
            "strict": reg.strict,
        },
    }
    if tel is not None:
        out["transfer"]["bytes_moved_by_family"] = {
            label: f.get("bytes_moved", 0)
            for label, f in tel.costs._families_dict().items()}
        h = tel.histograms.get("dispatch-overlap-ratio")
        out["dispatch_overlap"] = h.to_dict() if h is not None else {
            "count": 0}
    else:
        out["dispatch_overlap"] = {"count": 0}
    rec = active_recorder()
    out["recorder"] = ({"active": False} if rec is None else
                       {"active": True, "dir": rec.out_dir,
                        "dumps": rec.dumps, "notes": rec.total_notes})
    return out


# --------------------------------------------------------------------- #
# flight recorder


_ACTIVE_RECORDER: Optional["FlightRecorder"] = None


def active_recorder() -> Optional["FlightRecorder"]:
    return _ACTIVE_RECORDER


class FlightRecorder:
    """A bounded ring of run lifecycle notes and the post-mortem bundle
    dumper (``--postmortem-dir``, which also starts a telemetry session).
    A dump writes one directory:

    ========== ========================================================
    file        contents
    ========== ========================================================
    manifest    schema version, dump reason, timestamps, error, files
    status      the shared status snapshot
    compile     the compile registry (sentinel state)
    device      provenance, per-card memory, transfer
    events      the telemetry event ring
    traces      recent window-trace summaries
    latency     the stage-budget decomposition and backpressure series
    tenants     the per-tenant cost ledger
    flight      this recorder's note ring
    config      the run's fingerprint (option, family, flags)
    ========== ========================================================

    Triggers: a crash (driver), a strict-recompile abort, SIGUSR1, or an
    explicit :meth:`dump`; at most ``max_dumps`` bundles per run.
    :meth:`attach_health` hooks an SLO evaluator's breaches (the port's
    driver has no ``--slo`` yet, so nothing attaches one)."""

    def __init__(self, out_dir: str, config: Optional[dict] = None,
                 capacity: int = 512, max_dumps: int = 8):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.config = config or {}
        self._ring: deque = deque(maxlen=max(1, int(capacity)))
        self._lock = threading.Lock()
        self.total_notes = 0
        self.dumps = 0
        self.max_dumps = int(max_dumps)
        self._dumped_reasons: set = set()
        self._old_handler = None
        self._signum = signal.SIGUSR1
        self._signal_installed = False
        self._signal_dumps: List[threading.Thread] = []
        global _ACTIVE_RECORDER
        _ACTIVE_RECORDER = self

    # ------------------------------ notes ----------------------------- #

    def note(self, kind: str, **fields) -> None:
        ev = {"ts_ms": int(time.time() * 1000), "kind": kind}
        ev.update(fields)
        with self._lock:
            self.total_notes += 1
            self._ring.append(ev)

    # ------------------------------ triggers -------------------------- #

    def install_signal(self, signum: int = signal.SIGUSR1) -> None:
        """SIGUSR1 dumps a bundle without stopping the run. Main thread
        only; skipped elsewhere. The handler only starts a thread that
        dumps: Python runs it in the main thread between bytecodes, maybe
        while that thread holds a lock the dump takes (this recorder's, a
        session's), so dumping in the handler itself could deadlock the
        run. :meth:`close` waits for the dumps still writing."""
        def on_signal(signum, frame) -> None:
            t = threading.Thread(target=self.dump, args=("signal",),
                                 name="flight-recorder-dump", daemon=True)
            self._signal_dumps.append(t)
            t.start()

        try:
            old = signal.signal(signum, on_signal)
            with self._lock:
                self._old_handler = old
                self._signum = signum
                self._signal_installed = True
        except ValueError:
            with self._lock:
                self._signal_installed = False

    def attach_health(self, health) -> None:
        """Dump a bundle at the first breach of an SLO evaluator."""
        hooks = getattr(health, "hooks", None)
        if hooks is not None:
            hooks.append(self._on_breach)

    def _on_breach(self, check: str, value, threshold) -> None:
        self.note("slo-breach", check=check, value=value,
                  threshold=threshold)
        self.dump_once("slo-breach", "slo-breach",
                       detail={"check": check, "value": value,
                               "threshold": threshold})

    def dump_once(self, key: str, reason: str,
                  detail: Optional[dict] = None) -> Optional[str]:
        """:meth:`dump` at most once per ``key`` per run."""
        with self._lock:
            if key in self._dumped_reasons:
                return None
            self._dumped_reasons.add(key)
        return self.dump(reason, detail=detail)

    def close(self) -> None:
        global _ACTIVE_RECORDER
        with self._lock:
            restore = (self._old_handler
                       if self._signal_installed else None)
            signum = self._signum
            self._signal_installed = False
        if restore is not None:
            try:
                signal.signal(signum, restore)
            except ValueError:
                pass
        for t in self._signal_dumps:
            t.join(timeout=60.0)
        if _ACTIVE_RECORDER is self:
            _ACTIVE_RECORDER = None

    # ------------------------------ dumping --------------------------- #

    def dump(self, reason: str, error: Optional[BaseException] = None,
             detail: Optional[dict] = None) -> Optional[str]:
        """Write one bundle; returns its directory (None once the run's
        dump budget is spent). Each file is written on its own, so one
        that fails does not lose the others."""
        with self._lock:
            if self.dumps >= self.max_dumps:
                return None
            self.dumps += 1
            seq = self.dumps
        ts = time.strftime("%Y%m%dT%H%M%S")
        bundle = os.path.join(self.out_dir, f"bundle-{ts}-{seq:02d}-{reason}")
        os.makedirs(bundle, exist_ok=True)
        self.note("dump", reason=reason, bundle=bundle)

        from spatialflink_tpu_torch.utils import telemetry as _telemetry

        tel = _telemetry.active()
        files: List[str] = []

        def write(name: str, build) -> None:
            try:
                payload = build()
            except Exception as e:
                payload = {"error": f"{type(e).__name__}: {e}"}
            path = os.path.join(bundle, name + ".json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f, sort_keys=True, default=repr)
            os.replace(tmp, path)
            files.append(name + ".json")

        write("status", lambda: _telemetry.status_snapshot())
        write("compile", lambda: _REGISTRY.snapshot())
        write("device", lambda: device_payload(tel))
        write("events", lambda: {
            "events": tel.events.list() if tel is not None else [],
            "total": tel.events.total if tel is not None else 0})
        write("traces", lambda: {
            "recent": (tel.traces.recent(32)
                       if tel is not None and tel.traces is not None else []),
            "enabled": tel is not None and tel.traces is not None})
        write("latency", lambda: (
            tel.latency.payload(tel=tel) if tel is not None
            else {"stages": {}, "recent": [],
                  "note": "no telemetry session at dump time"}))
        write("tenants", lambda: (
            tel.tenants.payload() if tel is not None
            else {"tenants": {}, "n": 0,
                  "note": "no telemetry session at dump time"}))
        with self._lock:
            ring = list(self._ring)
        write("flight", lambda: {"notes": ring, "total": self.total_notes})
        write("config", lambda: self.config)
        manifest = {
            "schema": BUNDLE_SCHEMA,
            "reason": reason,
            "ts_ms": int(time.time() * 1000),
            "error": (f"{type(error).__name__}: {error}"
                      if error is not None else None),
            "detail": detail,
            "files": sorted(files),
        }
        tmp = os.path.join(bundle, "manifest.json.tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f, sort_keys=True)
        os.replace(tmp, os.path.join(bundle, "manifest.json"))
        _telemetry.emit_event("postmortem-dump", reason=reason,
                              bundle=bundle)
        return bundle
