"""Bulk replay (``--bulk``) and ``--limit`` on the CPU, second part (split
off test_torch_bulk.py to keep each file short under parallel workers):
``run_option_bulk`` against the port's own record path over the same
records (options 1, 6, 51, 16, 66, 101, multiQuery 1 / 51 / 21, 51 and 1
with panes), and the CLI's ``--bulk`` and ``--limit`` against the JAX
CLI's stdout, and the refused combinations.
"""

import pytest
import torch

from spatialflink_tpu import driver as JD

from spatialflink_tpu_torch import driver as TD
from spatialflink_tpu_torch.config import Params as TParams

from test_torch_bulk import BULK, _input, _params, _results, files  # noqa: F401
from test_torch_join import CONF, GEOMS, POINTS, QPOINTS

torch.set_num_threads(1)



def _record_keys(parsed, idx):
    lk = parsed.interner.lookup
    return [(lk(int(parsed.obj_id[i])), int(parsed.ts[i])) for i in idx]


@pytest.mark.parametrize("option,multi,panes", BULK)
def test_bulk_matches_the_record_path(files, option, multi, panes):
    """Each window's result, its index lists mapped back to the parsed
    records (join: both sides), equals the record path's run of the same
    file: the same records in the same order (kNN: the same (objID,
    distance) lists)."""
    spec = TD.CASES[option]
    p = _params(TParams, option, multi=multi, panes=panes)
    bulk = _results(TD.run_option_bulk(p, _input(files, option),
                                       str(files["queries"]), device="cpu"))
    lines = GEOMS if spec.stream != "Point" else POINTS
    rec = TD.run_option(p, iter(lines), iter(QPOINTS), device="cpu")
    rec = [(r.window_start, r.window_end, r.records) for r in rec]
    assert [w[:2] for w in bulk] == [w[:2] for w in rec]
    if spec.family == "knn":
        assert [w[2] for w in bulk] == [w[2] for w in rec]
        return
    if spec.stream != "Point":
        parsed = TD._bulk_parse_geom_stream(p, _input(files, option))
    else:
        parsed = TD._bulk_parse_stream(p.input1, _input(files, option), 1)

    def key(r):
        return (r.obj_id, r.timestamp)

    for (_s, _e, got, _x), (_s2, _e2, want) in zip(bulk, rec):
        if spec.family == "join":
            qparsed = TD._bulk_parse_stream(p.input2, str(files["queries"]),
                                            1)
            assert [(_record_keys(parsed, [a])[0],
                     _record_keys(qparsed, [b])[0]) for a, b in got] == \
                [(key(a), key(b)) for a, b in want]
        elif multi:
            assert [_record_keys(parsed, q) for q in got] == \
                [[key(r) for r in q] for q in want]
        else:
            assert _record_keys(parsed, got) == [key(r) for r in want]


# ---------------------------------------------------------------------- #
# the CLI


def _cli(files, tmp_path, option, extra):
    conf = tmp_path / "conf.yml"
    conf.write_text(open(CONF).read().replace("radius: 0.5", "radius: 0.05"))
    spec = TD.CASES[option]
    args = ["--config", str(conf), "--option", str(option), "--input1",
            _input(files, option), "--format",
            "GeoJSON" if spec.stream != "Point" else "CSV"]
    if spec.family == "join":
        args += ["--input2", str(files["queries"]), "--format2", "CSV"]
    return args + extra


@pytest.mark.parametrize("option,extra", [
    (1, ["--bulk"]), (51, ["--bulk", "--panes"]), (101, ["--bulk"]),
    (16, ["--bulk"]), (2, ["--bulk"]), (1, ["--bulk", "--limit", "50"]),
    (101, ["--limit", "300"]), (1, ["--limit", "0"]),
    (51, ["--limit", "450"])])
def test_cli_matches_jax(files, tmp_path, capsys, option, extra):
    """stdout and stderr's notes byte for byte: --bulk (and its fall-back
    for realtime 2, and its note that it ignores --limit), and --limit
    cutting each stream (a join's both) as the JAX driver cuts them."""
    args = _cli(files, tmp_path, option, extra)
    assert JD.main(args) == 0
    want = capsys.readouterr()
    assert TD.main(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert got.out == want.out

    def notes(err):
        return [ln for ln in err.splitlines()
                if "--bulk" in ln or "emitted" in ln]
    assert notes(got.err) == notes(want.err)


@pytest.mark.parametrize("flags", [["--bulk", "--kafka-follow"],
                                   ["--limit", "5", "--dlq"],
                                   ["--chaos", "plan.json"]])
def test_unported_combinations_are_refused(files, tmp_path, capsys, flags):
    """The live Kafka mode, the dead-letter queue and the chaos broker stay
    with a later slice: refused as not yet ported, never accepted and
    ignored (--kafka, --resume and --checkpoint, refused here before, run
    since their slice: tests/test_torch_kafka.py,
    test_torch_recovery.py)."""
    assert TD.main(_cli(files, tmp_path, 1, flags)
                   + ["--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "not yet ported to spatialflink_tpu_torch" in err
    assert flags[-2 if flags[-1].endswith(".json") else -1] in err
