"""The port's native point ingest (``spatialflink_tpu_torch/native``) on the
CPU: ``bulk_parse_csv`` / ``bulk_parse_geojson`` against the JAX package's
native parsers and against the port's plain parser
(``bulk_parse_csv_plain``, or the per-record parse for GeoJSON), on the
cases of tests/test_native_ingest.py and on random rows (hypothesis).
Columns must be equal, and so must the interner's contents and order: kNN
breaks distance ties by interned id. Also: the decode's interner after
every chunk, the loader's errors, and concurrent first builds."""

import dataclasses
import os
import threading
from datetime import datetime, timezone

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from spatialflink_tpu import driver as JD
from spatialflink_tpu.config import Params as JParams
from spatialflink_tpu.streams import bulk as JB
from spatialflink_tpu.utils import IdInterner as JIdInterner

from spatialflink_tpu_torch import driver as TD
from spatialflink_tpu_torch import native
from spatialflink_tpu_torch.ops import native as N
from spatialflink_tpu_torch.config import Params as TParams
from spatialflink_tpu_torch.streams import bulk as TB
from spatialflink_tpu_torch.streams import formats as TF
from spatialflink_tpu_torch.utils import IdInterner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(REPO, "conf", "spatialflink-conf.yml")


def _geo(oid, ts, x, y):
    return ('{"geometry": {"type": "Point", "coordinates": [%s, %s]}, '
            '"properties": {"oID": %s, "timestamp": %s}}' % (x, y, oid, ts))


CSV_CASES = {
    "plain": (["obj%d,%d,%r,%r" % (i % 7, 1700000000000 + i * 10,
                                   116 + i * 0.001, 40 + i * 0.002)
               for i in range(500)], {}),
    "quotes-spaces": (['"a1" , 123 , 1.5 , 2.5', "a2,456,3.25,4.75",
                       '" a1 ",124,1.5,2.5'], {}),
    "tsv-schema-permuted": (["7.5\t1.25\tcar9\t1700000005000",
                             "8.5\t2.25\tcar10\t1700000006000"],
                            dict(delimiter="\t", schema=(2, 3, 0, 1))),
    "iso-dates": (["t1,2024-01-15 12:30:00,1.0,2.0",
                   "t2,1700000000000,3.0,4.0",
                   "t3,2024-01-15 12:31:00,5.0,6.0",
                   "t2,2024-01-15 12:32:00,7.0,8.0"], {}),
    "no-oid-no-ts": (["1.0,2.0", "3.0,4.0"], dict(schema=(None, None, 0, 1))),
}

GEOJSON_CASES = {
    "plain": [_geo('"v%d"' % (i % 5), 1700000000000 + i, 116 + i * 0.01,
                   40 + i * 0.01) for i in range(200)],
    "numeric-null-oid": [_geo("42", 100, 1.0, 2.0),
                         _geo("null", 200, 3.0, 4.0)],
    "bool-oid": [_geo('"b"', 50, 0.5, 0.5), _geo("true", 100, 1.0, 2.0),
                 _geo('"a"', 150, 1.5, 2.5)],
    "kafka-envelope": ['{"topic": "t", "timestamp": 1699000000001, '
                       '"value": %s}' % _geo('"env1"', 4242, 7.5, 8.5)],
    "coordinates-in-properties": [
        '{"properties": {"coordinates": "fake", "oID": "c1", "timestamp": '
        '9}, "geometry": {"type": "Point", "coordinates": [5.0, 6.0]}}'],
    "quoted-int-timestamp": [_geo('"q"', '"1700000000123"', 9.0, 8.0)],
}


def _columns(parsed):
    return (parsed.x, parsed.y, parsed.ts, parsed.obj_id,
            parsed.interner.to_list())


def assert_same_parse(got, want):
    for g, w in zip(_columns(got), _columns(want)):
        if isinstance(w, list):
            assert g == w
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", sorted(CSV_CASES))
def test_csv_equals_jax_native_and_plain(case):
    lines, kw = CSV_CASES[case]
    data = ("\n\n" + "\n".join(lines) + "\n\n").encode()  # blank lines
    got = TB.bulk_parse_csv(data, **kw)
    assert len(got) == len(lines)
    assert_same_parse(got, JB.bulk_parse_csv(data, **kw))
    assert_same_parse(got, TB.bulk_parse_csv_plain(lines, **kw))


@pytest.mark.parametrize("case", sorted(GEOJSON_CASES))
def test_geojson_equals_jax_native_and_per_record(case):
    lines = GEOJSON_CASES[case]
    data = "\n".join(lines).encode()
    got = TB.bulk_parse_geojson(data)
    assert_same_parse(got, JB.bulk_parse_geojson(data))
    pts = [TF.parse_geojson(ln, date_format=None) for ln in lines]
    np.testing.assert_array_equal(got.x, [p.x for p in pts])
    np.testing.assert_array_equal(got.y, [p.y for p in pts])
    np.testing.assert_array_equal(got.ts, [p.timestamp for p in pts])
    assert [got.interner.lookup(int(i)) for i in got.obj_id] == \
        [p.obj_id for p in pts]


def test_geojson_non_point_raises():
    poly = ('{"geometry": {"type": "Polygon", "coordinates": '
            '[[[0,0],[1,0],[1,1],[0,0]]]}, "properties": {"oID": "p1", '
            '"timestamp": 5}}')
    data = "\n".join([_geo('"a"', 1, 1.0, 2.0), poly]).encode()
    with pytest.raises(ValueError):
        TB.bulk_parse_geojson(data)
    with pytest.raises(ValueError):
        JB.bulk_parse_geojson(data)


def test_shared_interner_across_calls():
    """Ids already interned keep their number; new ones follow in the
    native order."""
    ti, ji = IdInterner(), JIdInterner()
    for block in (["b,1,1.0,1.0", "a,2,2.0,2.0"],
                  ["c,3,3.0,3.0", "a,2024-01-15 12:30:00,4.0,4.0",
                   "d,2024-01-15 12:30:01,5.0,5.0", "b,4,6.0,6.0"]):
        data = "\n".join(block).encode()
        got = TB.bulk_parse_csv(data, interner=ti)
        want = JB.bulk_parse_csv(data, interner=ji)
        assert_same_parse(got, want)
        assert ti.to_list() == ji.to_list()


_ids = st.text(alphabet="ab xyz_\"09", min_size=0, max_size=6)
_ts = st.one_of(st.integers(0, 2 ** 45).map(str),
                st.datetimes(min_value=datetime(2001, 1, 1),
                             max_value=datetime(2030, 1, 1)).map(
                    lambda d: d.strftime("%Y-%m-%d %H:%M:%S")))
_coord = st.floats(-180.0, 180.0, allow_nan=False).map(repr)


@settings(max_examples=40, deadline=None)
@given(st.lists(st.tuples(_ids, _ts, _coord, _coord), min_size=1,
                max_size=40))
def test_random_csv_rows(rows):
    lines = [",".join(r) for r in rows]
    data = "\n".join(lines).encode()
    # an id made of blanks and quotes only is still an id ("")
    got = TB.bulk_parse_csv(data)
    assert_same_parse(got, JB.bulk_parse_csv(data))
    assert_same_parse(got, TB.bulk_parse_csv_plain(lines))


def _params(cls, fmt):
    p = cls.from_yaml(CONF)
    return dataclasses.replace(p, input1=dataclasses.replace(p.input1,
                                                             format=fmt))


@pytest.mark.parametrize("fmt", ["CSV", "GeoJSON"])
def test_decode_interner_after_every_chunk(fmt):
    """The decode of a stream whose chunks mix integer and date-string
    timestamps (CSV) or string, numeric and bool ids (GeoJSON): after
    every chunk the port's interner equals the JAX package's."""
    rng = np.random.default_rng(5)
    lines = []
    for i in range(1800):
        o, t = int(rng.integers(0, 400)), 1700000000000 + 7 * i
        x, y = rng.uniform(115.6, 117.5), rng.uniform(39.7, 41.0)
        if fmt == "CSV":
            ts = (datetime.fromtimestamp(t // 1000, tz=timezone.utc)
                  .strftime("%Y-%m-%d %H:%M:%S") if i % 5 == 0 else str(t))
            lines.append(f"o{o},{ts},{x!r},{y!r}")
        else:
            oid = ("true" if o % 50 == 0 else str(o) if o % 3 == 0
                   else f'"o{o}"')
            lines.append(_geo(oid, t, x, y))
    jp, tp = _params(JParams, fmt), _params(TParams, fmt)
    grid = tp.grids()[0]
    calls = TB.bulk_parse_csv.calls + TB.bulk_parse_geojson.calls
    want = list(JD.decode_chunks(iter(lines), jp.input1, jp.grids()[0],
                                 chunk=512))
    got = list(TD.decode_chunks(iter(lines), tp.input1, grid, chunk=512))
    assert TB.bulk_parse_csv.calls + TB.bulk_parse_geojson.calls \
        == calls + len(got) == calls + 4
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cells, w.cells)
        # the interners only grow, and they end equal: so they were
        # equal after every chunk
        assert_same_parse(g.parsed, w.parsed)
    assert sum(len(g) for g in got) == len(lines)


def _fresh_build(monkeypatch, build_dir, source=None):
    """The ingest library unbound and built (when asked) into
    ``build_dir``, from ``source`` when given."""
    monkeypatch.setattr(N, "BUILD_DIR", build_dir)
    monkeypatch.setattr(N, "_LIBS", {})
    monkeypatch.setattr(native, "_lib", None)
    if source is not None:
        monkeypatch.setitem(N.HOST_SOURCES, "ingest", source)


def test_loader_raises_without_compiler(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g[+][+] not found"):
        native.lib()
    with pytest.raises(RuntimeError, match="g[+][+] not found"):
        TB.bulk_parse_csv(b"a,1,1.0,2.0")
    assert not (tmp_path / "build").exists()


def test_loader_raises_with_the_compiler_output(monkeypatch, tmp_path):
    bad = tmp_path / "ingest.cpp"
    bad.write_text("extern \"C\" long sf_parse_points_csv( {\n")
    _fresh_build(monkeypatch, tmp_path / "build", bad)
    with pytest.raises(RuntimeError, match="(?s)g[+][+] failed.*error:"):
        native.lib()
    assert list((tmp_path / "build").iterdir()) == []  # no half library


def test_concurrent_first_builds(monkeypatch, tmp_path):
    """Four builds started at once into an empty build directory all give
    the one library (and its compiler log), and it loads."""
    _fresh_build(monkeypatch, tmp_path)
    errors = []

    def run():
        try:
            N.build(["ingest"])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)
    threads = [threading.Thread(target=run) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    lib = N.library_path("ingest")
    assert not errors
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        lib.with_suffix(".log").name, lib.name]
    assert native.lib().sf_parse_points_csv is not None
