"""YAML config (port of ``spatialflink_tpu.config``).

Reads the same ``conf/spatialflink-conf.yml`` schema as the JAX package —
the reference's key names, with the leading ``!!`` java type tag tolerated
— into the same dataclasses. Fields of features this port does not run yet
(panes, mesh parallelism) are parsed so that the driver can refuse them;
of the output block only the delimiter is read (``--output``'s CSV/TSV/WKT
fields); keys no ported code reads (trajectory and Kafka settings) are
ignored.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from spatialflink_tpu_torch.index import UniformGrid
from spatialflink_tpu_torch.models import LineString, Point, Polygon

SUPPORTED_FORMATS = ("GeoJSON", "WKT", "CSV", "TSV")
SUPPORTED_WINDOW_TYPES = ("TIME", "COUNT")


class ConfigError(ValueError):
    """A missing or invalid config field."""


def _req(d: Dict[str, Any], key: str, where: str):
    if key not in d or d[key] is None:
        raise ConfigError(f"{where}: missing required key {key!r}")
    return d[key]


def _opt(d: Dict[str, Any], key: str, default):
    v = d.get(key)
    return default if v is None else v


def _normalize_delimiter(v: str) -> str:
    # TSV delimiters are written as a literal TAB, "\t" or "\\\\t"
    if v in ("\\t", "\\\\t", "\t"):
        return "\t"
    return v


def _coord_pairs(v) -> List[Tuple[float, float]]:
    """queryPoints: a YAML list of [x, y] pairs, or the bracket-string form
    '"[116.5, 40.5], [117.0, 40.7]"'."""
    if isinstance(v, str):
        from spatialflink_tpu_torch.streams.formats import parse_bracket_coords

        return parse_bracket_coords(v)
    return [tuple(map(float, p)) for p in v]


def _coord_lists(v) -> List[List[Tuple[float, float]]]:
    """queryPolygons/queryLineStrings: YAML nested lists, or the
    bracket-string form '"[[x, y], ...], [[x, y], ...]"'."""
    if isinstance(v, str):
        from spatialflink_tpu_torch.streams.formats import parse_bracket_rings

        return parse_bracket_rings(v)
    return [[tuple(map(float, c)) for c in grp] for grp in v]


def _java_date_format_to_python(fmt: Optional[str]) -> Optional[str]:
    """yyyy-MM-dd HH:mm:ss -> %Y-%m-%d %H:%M:%S (SimpleDateFormat subset)."""
    if not fmt:
        return None
    out = str(fmt)
    for j, p in (("yyyy", "%Y"), ("yy", "%y"), ("MM", "%m"), ("dd", "%d"),
                 ("HH", "%H"), ("mm", "%M"), ("ss", "%S"), ("SSS", "%f")):
        out = out.replace(j, p)
    return out


@dataclass
class StreamConfig:
    """One ``inputStream{1,2}`` block."""

    topic_name: str = ""
    format: str = "GeoJSON"
    date_format: Optional[str] = "%Y-%m-%d %H:%M:%S"
    geojson_obj_id_attr: str = "oID"
    geojson_timestamp_attr: str = "timestamp"
    csv_tsv_schema: Sequence[int] = (0, 1, 2, 3)
    grid_bbox: Tuple[float, float, float, float] = (0.0, 0.0, 1.0, 1.0)
    num_grid_cells: int = 100
    cell_length: float = 0.0
    delimiter: str = ","

    def geojson_kwargs(self) -> dict:
        return {"property_obj_id": self.geojson_obj_id_attr,
                "property_timestamp": self.geojson_timestamp_attr,
                "date_format": self.date_format}

    @classmethod
    def from_dict(cls, d: Dict[str, Any], where: str) -> "StreamConfig":
        fmt = str(_req(d, "format", where))
        if fmt not in SUPPORTED_FORMATS:
            raise ConfigError(
                f"{where}.format: {fmt!r} not in {SUPPORTED_FORMATS}")
        bbox = _req(d, "gridBBox", where)
        if len(bbox) != 4:
            raise ConfigError(
                f"{where}.gridBBox: need [minX, minY, maxX, maxY]")
        num_cells = int(_opt(d, "numGridCells", 0))
        cell_len = float(_opt(d, "cellLength", 0.0))
        if num_cells <= 0 and cell_len <= 0:
            raise ConfigError(
                f"{where}: one of numGridCells/cellLength must be positive")
        gj = list(_opt(d, "geoJSONSchemaAttr", ["oID", "timestamp"]))
        schema = [int(i) for i in _opt(d, "csvTsvSchemaAttr", [0, 1, 2, 3])]
        return cls(
            topic_name=str(_req(d, "topicName", where)),
            format=fmt,
            date_format=_java_date_format_to_python(
                _opt(d, "dateFormat", "yyyy-MM-dd HH:mm:ss")),
            geojson_obj_id_attr=gj[0] if gj else "oID",
            geojson_timestamp_attr=gj[1] if len(gj) > 1 else "timestamp",
            csv_tsv_schema=schema,
            grid_bbox=tuple(float(v) for v in bbox),
            num_grid_cells=num_cells,
            cell_length=cell_len,
            delimiter=_normalize_delimiter(str(_opt(d, "delimiter", ","))),
        )

    def make_grid(self) -> UniformGrid:
        """Grid per the stream's bbox; a positive cellLength wins."""
        min_x, min_y, max_x, max_y = self.grid_bbox
        if self.cell_length > 0:
            return UniformGrid(min_x, max_x, min_y, max_y,
                               cell_length=self.cell_length)
        return UniformGrid(min_x, max_x, min_y, max_y,
                           num_grid_partitions=self.num_grid_cells)


@dataclass
class QueryConfig:
    """``query:`` block."""

    option: int = 1
    approximate: bool = False
    multi_query: bool = False  # all query objects in one dispatch
    parallelism: int = 0       # not yet ported: the driver refuses > 1
    hosts: int = 0             # not yet ported: the driver refuses > 1
    panes: bool = False        # not yet ported: the driver refuses it
    radius: float = 0.0
    k: int = 10
    query_points: List[Tuple[float, float]] = field(default_factory=list)
    query_polygons: List[List[Tuple[float, float]]] = field(
        default_factory=list)
    query_linestrings: List[List[Tuple[float, float]]] = field(
        default_factory=list)
    allowed_lateness_s: int = 0

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "QueryConfig":
        th = _opt(d, "thresholds", {})
        return cls(
            option=int(_req(d, "option", "query")),
            approximate=bool(_opt(d, "approximate", False)),
            multi_query=bool(_opt(d, "multiQuery", False)),
            parallelism=int(_opt(d, "parallelism", 0)),
            hosts=int(_opt(d, "hosts", 0)),
            panes=bool(_opt(d, "panes", False)),
            radius=float(_opt(d, "radius", 0.0)),
            k=int(_opt(d, "k", 10)),
            query_points=_coord_pairs(_opt(d, "queryPoints", [])),
            query_polygons=_coord_lists(_opt(d, "queryPolygons", [])),
            query_linestrings=_coord_lists(_opt(d, "queryLineStrings", [])),
            allowed_lateness_s=int(_opt(th, "outOfOrderTuples", 0)),
        )


@dataclass
class WindowConfig:
    """``window:`` block — TIME windows in seconds."""

    type: str = "TIME"
    interval_s: float = 5.0
    step_s: float = 5.0

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "WindowConfig":
        wt = str(_opt(d, "type", "TIME")).upper()
        if wt not in SUPPORTED_WINDOW_TYPES:
            raise ConfigError(
                f"window.type: {wt!r} not in {SUPPORTED_WINDOW_TYPES}")
        interval = float(_req(d, "interval", "window"))
        step = float(_opt(d, "step", interval))
        if interval <= 0 or step <= 0:
            raise ConfigError("window.interval/step must be positive")
        return cls(type=wt, interval_s=interval, step_s=step)


@dataclass
class OutputStreamConfig:
    """``outputStream:`` block (the field delimiter of ``--output``)."""

    delimiter: str = ","

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "OutputStreamConfig":
        return cls(delimiter=_normalize_delimiter(
            str(_opt(d, "delimiter", ","))))


@dataclass
class Params:
    """Validated full config."""

    input1: StreamConfig = field(default_factory=StreamConfig)
    input2: StreamConfig = field(default_factory=StreamConfig)
    query: QueryConfig = field(default_factory=QueryConfig)
    window: WindowConfig = field(default_factory=WindowConfig)
    output: OutputStreamConfig = field(default_factory=OutputStreamConfig)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Params":
        in1 = StreamConfig.from_dict(_req(d, "inputStream1", "config"),
                                     "inputStream1")
        in2_raw = d.get("inputStream2")
        in2 = (StreamConfig.from_dict(in2_raw, "inputStream2")
               if in2_raw else in1)
        return cls(
            input1=in1,
            input2=in2,
            query=QueryConfig.from_dict(_req(d, "query", "config")),
            window=WindowConfig.from_dict(_req(d, "window", "config")),
            output=OutputStreamConfig.from_dict(_opt(d, "outputStream", {})),
        )

    @classmethod
    def from_yaml(cls, path: str) -> "Params":
        import yaml

        with open(path, "r", encoding="utf-8") as f:
            text = f.read()
        text = re.sub(r"^!!\S+\s*\n", "", text)  # the java type tag
        data = yaml.safe_load(text)
        if not isinstance(data, dict):
            raise ConfigError(f"{path}: not a mapping")
        return cls.from_dict(data)

    def grids(self) -> Tuple[UniformGrid, UniformGrid]:
        """(uGrid, qGrid): the grids of input streams 1 and 2."""
        return self.input1.make_grid(), self.input2.make_grid()

    def query_point_objects(self, grid: UniformGrid) -> List[Point]:
        return [Point.create(x, y, grid=grid)
                for x, y in self.query.query_points]

    def query_polygon_objects(self, grid: UniformGrid) -> List[Polygon]:
        return [Polygon.create([list(c)], grid=grid)
                for c in self.query.query_polygons]

    def query_linestring_objects(self, grid: UniformGrid) -> List[LineString]:
        return [LineString.create(list(c), grid=grid)
                for c in self.query.query_linestrings]

    def window_ms(self) -> Tuple[int, int]:
        return (int(self.window.interval_s * 1000),
                int(self.window.step_s * 1000))
