"""Spatial wire formats: GeoJSON / WKT / CSV / TSV (port of
``spatialflink_tpu.streams.formats``), plus the bracket-string coordinate
lists of the config.

- GeoJSON records arrive as a Kafka envelope ``{"value": {...}}``, a bare
  Feature, or a bare geometry; every geometry type parses
  (:func:`parse_geojson`).
- WKT strings may carry delimited ``oID, timestamp`` fields before the
  geometry, which is found anywhere in the line (:func:`parse_wkt`).
- CSV/TSV point rows use a 4-index schema [oID, time, x, y]; polygon and
  linestring rows carry a parenthesised coordinate string, with or without
  its WKT keyword (:func:`parse_csv_geometry`). Quotes are stripped and
  whitespace around delimiters is tolerated.
- Numeric timestamps are epoch millis; strings go through the date format
  (UTC) and fall back to 0 when they do not parse.

:func:`parse_spatial` and :func:`serialize_spatial` dispatch on the format;
the serializers write the JAX package's bytes.
"""

from __future__ import annotations

import json
import re
from datetime import datetime, timezone
from typing import List, Optional, Sequence, Union

from spatialflink_tpu_torch.index import UniformGrid
from spatialflink_tpu_torch.models import (GeometryCollection, LineString,
                                            MultiLineString, MultiPoint,
                                            MultiPolygon, Point, Polygon,
                                            SpatialObject)

DEFAULT_DATE_FORMAT = "%Y-%m-%d %H:%M:%S"  # reference conf "yyyy-MM-dd HH:mm:ss"


def parse_timestamp(value, date_format: Optional[str] = DEFAULT_DATE_FORMAT) -> int:
    """-> epoch millis. Numbers pass through; strings go through the date
    format (UTC), falling back to 0 on failure like the reference's swallowed
    ParseException (``Deserialization.java:186-189``)."""
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


# --------------------------------------------------------------------------- #
# GeoJSON

def _geometry_from_geojson(geom: dict, grid, obj_id, ts) -> SpatialObject:
    gtype = geom.get("type", "").lower()
    coords = geom.get("coordinates")
    if gtype == "point":
        return Point.create(coords[0], coords[1], grid, obj_id, ts)
    if gtype == "polygon":
        return Polygon.create(coords, grid, obj_id, ts)
    if gtype == "linestring":
        return LineString.create(coords, grid, obj_id, ts)
    if gtype == "multipoint":
        return MultiPoint.create(coords, grid, obj_id, ts)
    if gtype == "multipolygon":
        return MultiPolygon.create(coords, grid, obj_id, ts)
    if gtype == "multilinestring":
        return MultiLineString.create(coords, grid, obj_id, ts)
    if gtype == "geometrycollection":
        parts = [
            _geometry_from_geojson(g, grid, obj_id, ts)
            for g in geom.get("geometries", [])
        ]
        return GeometryCollection.create(parts, obj_id, ts)
    raise ValueError(f"unsupported GeoJSON geometry type: {geom.get('type')!r}")


def parse_geojson(
    record: Union[str, dict],
    grid: Optional[UniformGrid] = None,
    *,
    date_format: Optional[str] = DEFAULT_DATE_FORMAT,
    property_obj_id: str = "oID",
    property_timestamp: str = "timestamp",
) -> SpatialObject:
    obj = json.loads(record) if isinstance(record, str) else record
    # Kafka envelope -> feature -> geometry fallbacks
    if "value" in obj and isinstance(obj["value"], dict):
        obj = obj["value"]
    props = obj.get("properties") or {}
    geom = obj.get("geometry") or obj  # "geometry": null falls back too
    oid = props.get(property_obj_id, "")
    oid = "" if oid is None else str(oid).strip('"')
    ts = parse_timestamp(props.get(property_timestamp), date_format)
    return _geometry_from_geojson(geom, grid, oid, ts)


#: printable ASCII minus the two characters json.dumps escapes (`"` and
#: `\`): strings matching this render identically bare-quoted
_JSON_SAFE_RE = re.compile(r'^[ !#-\[\]-~]*$')


def _coords_json(obj: SpatialObject):
    if isinstance(obj, Point):
        return [obj.x, obj.y], "Point"
    if isinstance(obj, MultiPolygon):
        return [[[list(c) for c in ring] for ring in p.rings] for p in obj.polygons], "MultiPolygon"
    if isinstance(obj, Polygon):
        return [[list(c) for c in ring] for ring in obj.rings], "Polygon"
    if isinstance(obj, MultiLineString):
        return [[list(c) for c in l.coords_list] for l in obj.lines], "MultiLineString"
    if isinstance(obj, LineString):
        return [list(c) for c in obj.coords_list], "LineString"
    if isinstance(obj, MultiPoint):
        return [list(c) for c in obj.points], "MultiPoint"
    raise ValueError(f"cannot serialize {type(obj).__name__} coordinates")


def serialize_geojson(obj: SpatialObject, *, date_format: Optional[str] = None) -> str:
    """Feature JSON matching the reference's output schemas
    (``Serialization.java:17-51``)."""
    if type(obj) is Point:
        # hot-path Point serializer: byte-identical to the json.dumps of
        # the dict below (same key order/separators; %r is float.__repr__,
        # exactly json's float formatting; strings with characters json
        # would escape still go through json.dumps) at a fraction of the
        # cost — result sinks serialize every selected record, which
        # dominated the batched pipeline's wall clock (equivalence pinned
        # by tests/test_batched_path.py against the dict path)
        ts = format_timestamp(obj.timestamp, date_format)
        tsj = (ts if isinstance(ts, int)
               else ('"%s"' % ts if _JSON_SAFE_RE.match(ts)
                     else json.dumps(ts)))
        oid = obj.obj_id
        oj = ('"%s"' % oid if _JSON_SAFE_RE.match(oid)
              else json.dumps(oid))
        return ('{"geometry": {"type": "Point", "coordinates": [%r, %r]}, '
                '"properties": {"oID": %s, "timestamp": %s}, '
                '"type": "Feature"}'
                % (obj.x, obj.y, oj, tsj))
    if isinstance(obj, GeometryCollection):
        geometry = {
            "type": "GeometryCollection",
            "geometries": [
                {"type": _coords_json(g)[1], "coordinates": _coords_json(g)[0]}
                for g in obj.geometries
            ],
        }
    else:
        coords, gtype = _coords_json(obj)
        geometry = {"type": gtype, "coordinates": coords}
    return json.dumps(
        {
            "geometry": geometry,
            "properties": {
                "oID": obj.obj_id,
                "timestamp": format_timestamp(obj.timestamp, date_format),
            },
            "type": "Feature",
        }
    )


# --------------------------------------------------------------------------- #
# WKT

# single source of the geometry keyword set (longest-first so the regex
# alternation never matches a prefix of a longer keyword); _WKT_RE, the CSV
# coordinate-string keyword sniff, and the type-name map all derive from it
WKT_KEYWORDS = ("GEOMETRYCOLLECTION", "MULTIPOLYGON", "MULTILINESTRING",
                "MULTIPOINT", "POLYGON", "LINESTRING", "POINT")
_WKT_KEYWORDS_ALT = "|".join(WKT_KEYWORDS)

_WKT_RE = re.compile(
    rf"({_WKT_KEYWORDS_ALT})\s*"
    r"(\(+[^A-Z]*\)|\([^)]*\))",
    re.IGNORECASE,
)


def _parse_wkt_coords(body: str) -> List[tuple]:
    return [
        tuple(float(v) for v in pair.split()[:2])
        for pair in body.split(",")
        if pair.strip()
    ]


def parse_wkt(
    line: str,
    grid: Optional[UniformGrid] = None,
    *,
    delimiter: str = ",",
    date_format: Optional[str] = DEFAULT_DATE_FORMAT,
    obj_id: str = "",
    timestamp: int = 0,
) -> SpatialObject:
    """Parse a WKT geometry found anywhere in ``line``; leading/trailing
    delimited fields (if any) are ignored here — trajectory variants extract
    oID/time from the caller's schema before calling."""
    m = _WKT_RE.search(line)
    if not m:
        raise ValueError(f"no WKT geometry in line: {line[:80]!r}")
    if line[: m.start()].count("(") != line[: m.start()].count(")"):
        # the matched keyword is nested inside an unrecognized outer keyword's
        # parens (e.g. a misspelled GEOMETRYCOLLECTION); erroring beats a
        # silent parse of the wrong record
        raise ValueError(
            f"WKT geometry nested under unrecognized keyword: {line[:80]!r}")
    gtype = m.group(1).upper()
    body = line[m.start(2): _find_balanced_end(line, m.start(2))].strip()
    inner = body[1:-1].strip()  # strip the outermost parens
    if gtype == "GEOMETRYCOLLECTION":
        # recursive inner parse (``Deserialization.java:836`` plain, ``:854``
        # trajectory); components inherit the collection's oID/timestamp
        parts = [
            parse_wkt(part, grid, delimiter=delimiter, date_format=date_format,
                      obj_id=obj_id, timestamp=timestamp)
            for part in _split_top_level(inner)
        ]
        return GeometryCollection.create(parts, obj_id, timestamp)
    if gtype == "POINT":
        (xy,) = _parse_wkt_coords(inner)
        return Point.create(xy[0], xy[1], grid, obj_id, timestamp)
    if gtype == "LINESTRING":
        return LineString.create(_parse_wkt_coords(inner), grid, obj_id, timestamp)
    if gtype == "POLYGON":
        rings = [_parse_wkt_coords(_strip_parens(r)) for r in _split_top_level(inner)]
        return Polygon.create(rings, grid, obj_id, timestamp)
    if gtype == "MULTIPOINT":
        # both "(1 2, 3 4)" and "((1 2), (3 4))" forms are legal WKT
        pts = [_parse_wkt_coords(_strip_parens(p))[0] for p in _split_top_level(inner)]
        return MultiPoint.create(pts, grid, obj_id, timestamp)
    if gtype == "MULTILINESTRING":
        lines = [_parse_wkt_coords(_strip_parens(r)) for r in _split_top_level(inner)]
        return MultiLineString.create(lines, grid, obj_id, timestamp)
    if gtype == "MULTIPOLYGON":
        polys = [
            [_parse_wkt_coords(_strip_parens(r)) for r in _split_top_level(_strip_parens(poly))]
            for poly in _split_top_level(inner)
        ]
        return MultiPolygon.create(polys, grid, obj_id, timestamp)
    raise ValueError(f"unsupported WKT type {gtype}")


def _find_balanced_end(s: str, start: int) -> int:
    depth = 0
    for i in range(start, len(s)):
        if s[i] == "(":
            depth += 1
        elif s[i] == ")":
            depth -= 1
            if depth == 0:
                return i + 1
    raise ValueError("unbalanced WKT parentheses")


def _split_top_level(body: str) -> List[str]:
    """Split on commas at paren depth 0: '(a,b), (c)' -> ['(a,b)', '(c)']."""
    out, level, cur = [], 0, []
    for ch in body:
        if ch == "(":
            level += 1
        elif ch == ")":
            level -= 1
        if ch == "," and level == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    tail = "".join(cur).strip()
    if tail:
        out.append(tail)
    return out


def _strip_parens(s: str) -> str:
    s = s.strip()
    return s[1:-1].strip() if s.startswith("(") and s.endswith(")") else s


def serialize_wkt(obj: SpatialObject, *, delimiter: str = ",",
                  date_format: Optional[str] = None,
                  include_fields: bool = False) -> str:
    """WKT text for ``obj``; with ``include_fields`` the objID and timestamp
    ride as delimiter-separated PREFIX fields (``"oid, ts, WKT"``).

    The reference's WKT output schemas carry both fields too
    (``Serialization.java:53-96`` — objID prefix, date-formatted timestamp
    SUFFIX, quoted); we normalize to the prefix position because that is the
    field order our WKT *parser* (and the reference's CSV convention)
    accepts, making serialize->parse a lossless round trip — a documented
    deviation from the reference's asymmetric output-only suffix form. Both
    fields are emitted whenever either is set (an empty oid keeps the ts
    from being mis-read as the oid)."""
    body = _serialize_wkt_body(obj)
    if include_fields and (obj.obj_id or obj.timestamp):
        ts = format_timestamp(obj.timestamp, date_format)
        # an empty oid must still occupy its field — quoted, so the parser's
        # blank-field filter keeps it and the ts is not mis-read as the oid
        oid = str(obj.obj_id) if obj.obj_id else '""'
        return f"{oid}{delimiter} {ts}{delimiter} {body}"
    return body


def _serialize_wkt_body(obj: SpatialObject) -> str:
    if isinstance(obj, Point):
        return f"POINT ({obj.x} {obj.y})"
    if isinstance(obj, LineString):
        return "LINESTRING (" + ", ".join(f"{x} {y}" for x, y in obj.coords_list) + ")"
    if isinstance(obj, MultiPolygon):
        return "MULTIPOLYGON (" + ", ".join(
            "(" + ", ".join(
                "(" + ", ".join(f"{x} {y}" for x, y in ring) + ")" for ring in p.rings
            ) + ")"
            for p in obj.polygons
        ) + ")"
    if isinstance(obj, Polygon):
        return "POLYGON (" + ", ".join(
            "(" + ", ".join(f"{x} {y}" for x, y in ring) + ")" for ring in obj.rings
        ) + ")"
    if isinstance(obj, MultiPoint):
        return "MULTIPOINT (" + ", ".join(f"({x} {y})" for x, y in obj.points) + ")"
    if isinstance(obj, MultiLineString):
        return "MULTILINESTRING (" + ", ".join(
            "(" + ", ".join(f"{x} {y}" for x, y in l.coords_list) + ")" for l in obj.lines
        ) + ")"
    if isinstance(obj, GeometryCollection):
        # ``Serialization.java:682-774`` (GeometryCollectionToWKTOutputSchema)
        return "GEOMETRYCOLLECTION (" + ", ".join(
            _serialize_wkt_body(g) for g in obj.geometries
        ) + ")"
    raise ValueError(f"cannot WKT-serialize {type(obj).__name__}")


# --------------------------------------------------------------------------- #
# bracket-style coordinate strings (CLI/config query geometry;
# ``HelperClass.java:145-221``)

_BRACKET_PAIR_RE = re.compile(r"\[([^\[\]]+?)\]")


def parse_bracket_coords(s: str) -> List[tuple]:
    """``"[100.0, 0.0], [103.0, 0.0]"`` -> [(100.0, 0.0), (103.0, 0.0)]
    (``HelperClass.getCoordinates``, :145-161). Malformed pairs are skipped
    like the reference's swallowed per-match exceptions."""
    out = []
    for m in _BRACKET_PAIR_RE.finditer(s or ""):
        parts = re.split(r"\s*,\s*", m.group(1).strip())
        try:
            out.append((float(parts[0]), float(parts[1])))
        except (ValueError, IndexError):
            continue
    return out


def parse_bracket_rings(s: str) -> List[List[tuple]]:
    """``"[[x, y], ...], [[x, y], ...]"`` -> list of coordinate lists
    (``HelperClass.getListCoordinates``, :163-179)."""
    return [parse_bracket_coords(m.group(1))
            for m in re.finditer(r"\[(\[.+?\])\](?=\s*(?:,|$))", s or "")]


def parse_bracket_polygons(s: str) -> List[List[List[tuple]]]:
    """``"[[[x, y], ...]], [[[x, y], ...]]"`` -> list of single-ring polygons
    (``HelperClass.getListListCoordinates``, :181-201)."""
    # re-wrap the inner text so the first/last pair regain their brackets,
    # exactly like the reference's '"[" + group + "]"'
    return [[parse_bracket_coords("[" + m.group(1) + "]")]
            for m in re.finditer(r"\[\[\[(.+?)\]\]\]", s or "")]


# --------------------------------------------------------------------------- #
# CSV / TSV

def parse_csv(
    line: str,
    grid: Optional[UniformGrid] = None,
    *,
    delimiter: str = ",",
    schema: Sequence[int] = (0, 1, 2, 3),
    date_format: Optional[str] = DEFAULT_DATE_FORMAT,
    geometry: str = "Point",
) -> SpatialObject:
    """Spatial object from a delimited line.

    Points: ``schema`` gives the column indices of [oID, timestamp, x, y]
    (``Deserialization.java:288-330``). Other geometry types carry a
    parenthesized coordinate string — with or without the WKT keyword, like
    ``CSVTSVToSpatialPolygon`` (``Deserialization.java:487-516``), which
    splits on parens/commas/spaces directly and never requires the keyword.
    """
    if geometry != "Point":
        return parse_csv_geometry(
            line, geometry, grid, delimiter=delimiter,
            date_format=date_format, schema=schema)
    fields = re.split(r"\s*" + re.escape(delimiter) + r"\s*", line.replace('"', "").strip())
    oid = fields[schema[0]] if schema[0] is not None else ""
    ts = parse_timestamp(fields[schema[1]], date_format) if schema[1] is not None else 0
    x = float(fields[schema[2]])
    y = float(fields[schema[3]])
    return Point.create(x, y, grid, oid, ts)


def parse_csv_geometry(
    line: str,
    geometry: str,
    grid: Optional[UniformGrid] = None,
    *,
    delimiter: str = ",",
    date_format: Optional[str] = DEFAULT_DATE_FORMAT,
    schema: Sequence[int] = (0, 1, 2, 3),
) -> SpatialObject:
    """Polygon/linestring/multi from a delimited coordinate-string row
    (``Deserialization.java:1367-1565`` ``convertCoordinates`` family).

    The geometry column is a nested-paren coordinate string, e.g.
    ``((116.0 40.0, 116.1 40.0, 116.1 40.1, 116.0 40.0))``; a leading WKT
    keyword is optional and, when present, overrides ``geometry`` the way the
    reference's ``str.contains("MULTIPOLYGON")`` check promotes to multi
    (``Deserialization.java:504-516``). Optional [oID, timestamp] prefix
    fields before the coordinate string are honored (trajectory variants).
    """
    start = line.find("(")
    if start < 0:
        raise ValueError(f"no coordinate string in CSV row: {line[:80]!r}")
    prefix = line[:start]
    # \b keeps an oID like "seg_LINESTRING" from being sniffed as the keyword
    m = re.search(rf"\b({_WKT_KEYWORDS_ALT})\s*$", prefix, re.IGNORECASE)
    keyword = None
    if m:
        keyword = m.group(1).upper()
        prefix = prefix[: m.start()]
    fields = [f for f in re.split(r"\s*" + re.escape(delimiter) + r"\s*", prefix)
              if f.strip()]
    # schema gives the [oID, timestamp] column positions among the prefix
    # fields, same contract as the Point path (x/y slots are unused here —
    # the geometry column replaces them)
    oid_i, ts_i = (schema[0], schema[1]) if len(schema) >= 2 else (0, 1)
    oid = (fields[oid_i].replace('"', "")
           if oid_i is not None and oid_i < len(fields) else "")
    ts = (parse_timestamp(fields[ts_i], date_format)
          if ts_i is not None and ts_i < len(fields) else 0)
    body = line[start:_find_balanced_end(line, start)]
    if keyword is None:
        keyword = {kw.lower(): kw for kw in WKT_KEYWORDS}.get(geometry.lower())
        if keyword is None:
            raise ValueError(f"unsupported CSV geometry type {geometry!r}")
        # promote to multi when the nesting depth says so, mirroring the
        # reference's keyword sniffing for keyword-less coordinate strings
        depth = len(body) - len(body.lstrip("("))
        if keyword == "POLYGON" and depth >= 3:
            keyword = "MULTIPOLYGON"
        elif keyword == "LINESTRING" and depth >= 2:
            keyword = "MULTILINESTRING"
    return parse_wkt(f"{keyword} {body}", grid, delimiter=delimiter,
                     date_format=date_format, obj_id=oid, timestamp=ts)


def serialize_csv(obj: SpatialObject, *, delimiter: str = ",",
                  date_format: Optional[str] = None) -> str:
    if isinstance(obj, Point):
        return delimiter.join(
            [str(obj.obj_id), str(format_timestamp(obj.timestamp, date_format)),
             str(obj.x), str(obj.y)]
        )
    # non-point geometries ride as WKT-in-CSV, like the reference's
    # coordinate-string variants
    return delimiter.join(
        [str(obj.obj_id), str(format_timestamp(obj.timestamp, date_format)),
         serialize_wkt(obj)]
    )


# --------------------------------------------------------------------------- #
# dispatch

def parse_spatial(
    record,
    fmt: str,
    grid: Optional[UniformGrid] = None,
    *,
    delimiter: str = ",",
    schema: Sequence[int] = (0, 1, 2, 3),
    date_format: Optional[str] = DEFAULT_DATE_FORMAT,
    property_obj_id: str = "oID",
    property_timestamp: str = "timestamp",
    geometry: str = "Point",
) -> SpatialObject:
    """Single entry point: fmt in {GeoJSON, WKT, CSV, TSV} (case-insensitive),
    mirroring the ``inputType`` dispatch (``Deserialization.java:47-115``)."""
    f = fmt.lower()
    if f == "geojson":
        return parse_geojson(
            record, grid, date_format=date_format,
            property_obj_id=property_obj_id, property_timestamp=property_timestamp,
        )
    if f == "wkt":
        # trajectory WKT lines may prefix oID/time fields before the geometry;
        # only the text BEFORE the geometry match is field-split (a bare
        # multi-coordinate WKT contains commas that are not field separators)
        line = record if isinstance(record, str) else str(record)
        oid, ts = "", 0
        m = _WKT_RE.search(line)
        prefix = line[: m.start()] if m else ""
        fields = [
            f_ for f_ in re.split(r"\s*" + re.escape(delimiter) + r"\s*", prefix)
            if f_.strip()
        ]
        if fields:
            # strip() aligns WKT-prefix ids with the CSV parser (which
            # strips the whole line first) and with the native bulk parser's
            # trimmed field hash — one interned id per logical object no
            # matter which parse path a line takes
            oid = fields[0].replace('"', "").strip()
            if len(fields) > 1:
                ts = parse_timestamp(fields[1], date_format)
        return parse_wkt(line, grid, delimiter=delimiter, date_format=date_format,
                         obj_id=oid, timestamp=ts)
    if f in ("csv", "tsv"):
        d = "\t" if f == "tsv" else delimiter
        return parse_csv(record, grid, delimiter=d, schema=schema,
                         date_format=date_format, geometry=geometry)
    raise ValueError(f"unknown input format {fmt!r}")


def serialize_spatial(obj: SpatialObject, fmt: str, *, delimiter: str = ",",
                      date_format: Optional[str] = None) -> str:
    f = fmt.lower()
    if f == "geojson":
        return serialize_geojson(obj, date_format=date_format)
    if f == "wkt":
        # carry objID/timestamp like the reference's WKT output schemas
        # (prefix-normalized; see serialize_wkt)
        return serialize_wkt(obj, delimiter=delimiter,
                             date_format=date_format, include_fields=True)
    if f in ("csv", "tsv"):
        return serialize_csv(obj, delimiter="\t" if f == "tsv" else delimiter,
                             date_format=date_format)
    raise ValueError(f"unknown output format {fmt!r}")
