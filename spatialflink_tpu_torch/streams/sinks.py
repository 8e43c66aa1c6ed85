"""Result sinks (port of ``StdoutSink`` and ``FileSink`` of
``spatialflink_tpu.streams.sinks``) and the file replay source."""

from __future__ import annotations

import json
import sys
from typing import Iterator, Optional

from spatialflink_tpu_torch.streams.formats import serialize_spatial


class StdoutSink:
    """Prints each emitted item (the driver emits one dict per window)."""

    def emit(self, record):
        print(record, file=sys.stdout)

    def close(self):
        sys.stdout.flush()


class FileSink:
    """Newline-delimited result records, as the JAX package's ``FileSink``
    writes them: a spatial record serialized in ``fmt`` (GeoJSON, WKT, CSV
    or TSV, honouring ``delimiter`` and ``date_format``), any other record
    (a kNN (objID, distance) pair) as a JSON line."""

    def __init__(self, path: str, fmt: str = "GeoJSON", *,
                 delimiter: str = ",", date_format: Optional[str] = None):
        self.fmt = fmt
        self.delimiter = delimiter
        self.date_format = date_format
        self.records_written = 0
        self._f = open(path, "w")

    def emit(self, record):
        if hasattr(record, "obj_id"):
            line = serialize_spatial(record, self.fmt,
                                     delimiter=self.delimiter,
                                     date_format=self.date_format)
        else:
            line = json.dumps(record, default=str)
        self._f.write(line + "\n")
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
