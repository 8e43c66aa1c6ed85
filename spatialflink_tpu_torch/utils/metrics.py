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

The JAX module's counters, meters and degradation digest wait for the
telemetry plane (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import json
import threading


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
