"""Bind the native ingest (``ingest.cpp``: the point parsers and the WKT /
GeoJSON polygon and linestring parsers) with :mod:`ctypes`.

The library is the host target ``"ingest"`` of
:mod:`spatialflink_tpu_torch.ops.native`: compiled at first use with
``g++ -O3 -shared -fPIC -std=c++17`` into
``spatialflink_tpu_torch/_build/libingest-<hash>.so``. There is no
fallback: without a compiler, or when the compile fails, :func:`lib`
raises with the compiler's output, and no environment variable turns the
native parse off.
"""

from __future__ import annotations

import ctypes
import threading

from spatialflink_tpu_torch.ops import native as _native

_lock = threading.Lock()
_lib = None

_D = ctypes.POINTER(ctypes.c_double)
_I64 = ctypes.POINTER(ctypes.c_int64)
_U64 = ctypes.POINTER(ctypes.c_uint64)
_I32 = ctypes.POINTER(ctypes.c_int32)
#: the outputs every point parser writes: x, y, ts, id hash, id span start
#: and length, reject line indices, reject count
_OUTS = [_D, _D, _I64, _U64, _I64, _I32, _I64, ctypes.POINTER(ctypes.c_long)]
#: the outputs every geometry parser writes: ts, id hash, id span start and
#: length, is-polygon, ring offset and count per record, bbox (4 per
#: record), vertex offset and size per ring, vertex x and y, reject line
#: indices, reject count
_GEOM_OUTS = [_I64, _U64, _I64, _I32, ctypes.POINTER(ctypes.c_int8), _I64,
              _I32, _D, _I64, _I32, _D, _D, _I64,
              ctypes.POINTER(ctypes.c_long)]


def lib() -> ctypes.CDLL:
    """The bound library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _native.function(
                "ingest", "sf_parse_points_csv",
                [ctypes.c_char_p, ctypes.c_long, ctypes.c_char, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, *_OUTS],
                ctypes.c_long)
            _native.function(
                "ingest", "sf_parse_points_geojson",
                [ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p,
                 ctypes.c_char_p, *_OUTS], ctypes.c_long)
            _native.function(
                "ingest", "sf_parse_wkt_geoms",
                [ctypes.c_char_p, ctypes.c_long, ctypes.c_char,
                 *_GEOM_OUTS], ctypes.c_long)
            _native.function(
                "ingest", "sf_parse_geojson_geoms",
                [ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p,
                 ctypes.c_char_p, *_GEOM_OUTS], ctypes.c_long)
            _lib = _native.load("ingest")
    return _lib
