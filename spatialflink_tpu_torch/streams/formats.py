"""Point wire formats: CSV / TSV / GeoJSON (port of the point parts of
``spatialflink_tpu.streams.formats``), plus the bracket-string coordinate
lists of the config.

- CSV/TSV rows use a 4-index schema [oID, time, x, y]; quotes are stripped
  and whitespace around delimiters is tolerated.
- GeoJSON records arrive as a Kafka envelope ``{"value": {...}}``, a bare
  Feature, or a bare geometry.
- Numeric timestamps are epoch millis; strings go through the date format
  (UTC) and fall back to 0 when they do not parse.

Point streams only: a polygon or linestring record in a declared point
stream is an off-type record (:class:`OffTypeRecord`).
"""

from __future__ import annotations

import json
import re
from datetime import datetime, timezone
from typing import List, Optional, Sequence, Union

from spatialflink_tpu_torch.models import Point

DEFAULT_DATE_FORMAT = "%Y-%m-%d %H:%M:%S"


class OffTypeRecord(ValueError):
    """A well-formed record of another geometry type than Point."""


def parse_timestamp(value,
                    date_format: Optional[str] = DEFAULT_DATE_FORMAT) -> int:
    """-> epoch millis. Numbers pass through; strings go through the date
    format (UTC), 0 when they do not parse."""
    if value is None:
        return 0
    if isinstance(value, (int, float)):
        return int(value)
    s = str(value).strip().strip('"')
    if s.isdigit():
        return int(s)
    try:
        dt = datetime.strptime(s, date_format or DEFAULT_DATE_FORMAT)
        return int(dt.replace(tzinfo=timezone.utc).timestamp() * 1000)
    except (ValueError, TypeError):
        return 0


def format_timestamp(ms: int,
                     date_format: Optional[str] = None) -> Union[int, str]:
    if not date_format:
        return int(ms)
    return datetime.fromtimestamp(int(ms) / 1000,
                                  tz=timezone.utc).strftime(date_format)


def csv_splitter(delimiter: str):
    """The field split of one CSV/TSV line: whitespace around delimiters
    is tolerated."""
    return re.compile(r"\s*" + re.escape(delimiter) + r"\s*").split


def parse_csv(line: str, *, delimiter: str = ",", schema: Sequence = (0, 1, 2, 3),
              date_format: Optional[str] = DEFAULT_DATE_FORMAT) -> Point:
    """A Point from a delimited line; ``schema`` gives the column indices
    of [oID, timestamp, x, y] (None = absent)."""
    fields = csv_splitter(delimiter)(line.replace('"', "").strip())
    oid = fields[schema[0]] if schema[0] is not None else ""
    ts = (parse_timestamp(fields[schema[1]], date_format)
          if schema[1] is not None else 0)
    return Point.create(float(fields[schema[2]]), float(fields[schema[3]]),
                        obj_id=oid, timestamp=ts)


def parse_geojson(record: Union[str, dict], *,
                  date_format: Optional[str] = DEFAULT_DATE_FORMAT,
                  property_obj_id: str = "oID",
                  property_timestamp: str = "timestamp") -> Point:
    """A Point from a GeoJSON record; raises :class:`OffTypeRecord` for a
    record of another geometry type."""
    obj = json.loads(record) if isinstance(record, str) else record
    if "value" in obj and isinstance(obj["value"], dict):
        obj = obj["value"]
    props = obj.get("properties") or {}
    geom = obj.get("geometry") or obj
    oid = props.get(property_obj_id, "")
    oid = "" if oid is None else str(oid).strip('"')
    ts = parse_timestamp(props.get(property_timestamp), date_format)
    gtype = str(geom.get("type", ""))
    if gtype.lower() != "point":
        raise OffTypeRecord(gtype or "untyped")
    coords = geom.get("coordinates")
    return Point.create(coords[0], coords[1], obj_id=oid, timestamp=ts)


#: printable ASCII minus `"` and `\`: renders identically bare-quoted
_JSON_SAFE_RE = re.compile(r'^[ !#-\[\]-~]*$')


def _json_str(s: str) -> str:
    return '"%s"' % s if _JSON_SAFE_RE.match(s) else json.dumps(s)


def serialize_geojson(p: Point, *,
                      date_format: Optional[str] = None) -> str:
    """One output record as a GeoJSON Feature, byte-identical to the JAX
    package's serializer."""
    ts = format_timestamp(p.timestamp, date_format)
    tsj = ts if isinstance(ts, int) else _json_str(ts)
    return ('{"geometry": {"type": "Point", "coordinates": [%r, %r]}, '
            '"properties": {"oID": %s, "timestamp": %s}, '
            '"type": "Feature"}' % (p.x, p.y, _json_str(p.obj_id), tsj))


_BRACKET_PAIR_RE = re.compile(r"\[([^\[\]]+?)\]")


def parse_bracket_coords(s: str) -> List[tuple]:
    """``"[100.0, 0.0], [103.0, 0.0]"`` -> [(100.0, 0.0), (103.0, 0.0)];
    malformed pairs are skipped."""
    out = []
    for m in _BRACKET_PAIR_RE.finditer(s or ""):
        parts = re.split(r"\s*,\s*", m.group(1).strip())
        try:
            out.append((float(parts[0]), float(parts[1])))
        except (ValueError, IndexError):
            continue
    return out


def parse_bracket_rings(s: str) -> List[List[tuple]]:
    """``"[[x, y], ...], [[x, y], ...]"`` -> list of coordinate lists."""
    return [parse_bracket_coords(m.group(1))
            for m in re.finditer(r"\[(\[.+?\])\](?=\s*(?:,|$))", s or "")]
