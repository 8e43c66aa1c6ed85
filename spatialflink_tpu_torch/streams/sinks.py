"""Result sinks (port of ``StdoutSink`` and ``FileSink`` of
``spatialflink_tpu.streams.sinks``) and the file replay source."""

from __future__ import annotations

import sys
from typing import Iterator, Optional

from spatialflink_tpu_torch.streams.formats import serialize_geojson


class StdoutSink:
    """Prints each emitted item (the driver emits one dict per window)."""

    def emit(self, record):
        print(record, file=sys.stdout)

    def close(self):
        sys.stdout.flush()


class FileSink:
    """Newline-delimited result records, one GeoJSON Feature per line (the
    JAX driver's default ``--output-format``)."""

    def __init__(self, path: str, *, date_format: Optional[str] = None):
        self.date_format = date_format
        self.records_written = 0
        self._f = open(path, "w")

    def emit(self, record):
        self._f.write(serialize_geojson(record, date_format=self.date_format)
                      + "\n")
        self.records_written += 1

    def close(self):
        self._f.close()


def file_lines(path: str) -> Iterator[str]:
    """The non-blank lines of a newline-delimited record file, stripped
    (the replay source of ``--input1``)."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield line
