"""Post-mortem and preflight doctor (port of ``spatialflink_tpu.doctor``).

``python -m spatialflink_tpu_torch.doctor`` reads what the flight
recorder (``--postmortem-dir``) writes:

- ``summarize BUNDLE`` — one digest of a post-mortem bundle: dump reason,
  error, backend, throughput and window counters, health verdict,
  compile and recompile counts with the latest signatures, the stage
  budget, the last flight-recorder notes and events.
- ``diff A B`` — two bundles side by side (backend, counters, compiles,
  latency); a cross-backend pair is flagged. Exit 0; an unreadable
  bundle or a schema mismatch exits 2.
- ``tenants BUNDLE`` — the per-tenant cost table of a bundle.
- ``preflight [--require-backend gpu]`` — is the card there: backend
  provenance against the required platform, memory statistics, and a
  kernel library built or loaded through the compile registry. Exit 0 =
  ready.

The bundle schema and the text of ``summarize``, ``diff`` and ``tenants``
are the JAX package's, so each package's doctor reads the other's
bundles and prints the same lines. ``fleet`` (a ``--fleet-dir``) is not
ported yet. ``--json`` prints one JSON document instead of text.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from spatialflink_tpu_torch.utils import deviceplane


# --------------------------------------------------------------------- #
# bundle IO


def load_bundle(path: str) -> dict:
    """Read one flight-recorder bundle directory into a dict keyed by file
    stem (manifest/status/compile/device/events/traces/flight/config).
    Raises ValueError on a missing/unreadable manifest or a schema this
    doctor does not speak."""
    manifest_path = os.path.join(path, "manifest.json")
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: not a post-mortem bundle "
                         f"(manifest.json unreadable: {e})")
    schema = manifest.get("schema")
    if schema != deviceplane.BUNDLE_SCHEMA:
        raise ValueError(f"{path}: bundle schema {schema!r} != "
                         f"{deviceplane.BUNDLE_SCHEMA} (this doctor is too "
                         "old or the bundle too new)")
    out = {"manifest": manifest, "path": path}
    for name in manifest.get("files", []):
        stem = name[:-5] if name.endswith(".json") else name
        try:
            with open(os.path.join(path, name)) as f:
                out[stem] = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            out[stem] = {"error": f"unreadable: {e}"}
    return out


def _bundle_digest(b: dict) -> dict:
    """The comparable core of one bundle (summarize renders it, diff
    subtracts it)."""
    manifest = b.get("manifest", {})
    status = b.get("status", {}) or {}
    st = status.get("status", {}) or {}
    device = b.get("device", {}) or {}
    compile_ = b.get("compile", {}) or {}
    health = status.get("health")
    return {
        "path": b.get("path"),
        "reason": manifest.get("reason"),
        "ts_ms": manifest.get("ts_ms"),
        "error": manifest.get("error"),
        "backend": (device.get("backend") or {}).get("platform"),
        "device_kind": (device.get("backend") or {}).get("device_kind"),
        "valid_for_target": (device.get("backend") or {}).get(
            "valid_for_target"),
        "records_in": st.get("records_in", 0),
        "windows": st.get("windows_evaluated", 0),
        "throughput_rps": st.get("throughput_rps", 0.0),
        "slo_breaches": st.get("slo_breaches", 0),
        "healthy": None if health is None else health.get("healthy"),
        "unhealthy_checks": ([] if health is None else
                             sorted(n for n, c in health["checks"].items()
                                    if not c["ok"])),
        "compiles": compile_.get("total_compiles", 0),
        "post_warmup_compiles": compile_.get("post_warmup_compiles", 0),
        "warm": compile_.get("warm"),
        "mem_bytes_in_use": (device.get("memory") or {}).get("bytes_in_use"),
        "d2h_bytes": (device.get("transfer") or {}).get("d2h_bytes", 0),
        "dispatch_overlap_p50": (device.get("dispatch_overlap") or {}).get(
            "p50"),
        "events": len((b.get("events") or {}).get("events", [])),
        "notes": (b.get("flight") or {}).get("total", 0),
        "record_emit_p99_ms": ((b.get("latency") or {}).get("record_emit")
                               or {}).get("p99"),
        "budgeted_windows": ((b.get("latency") or {}).get("sum_check")
                             or {}).get("windows", 0),
    }


def _latency_table(latency: dict) -> List[str]:
    """The stage-budget table of a bundle's latency decomposition — the
    offline answer to "which stage blew the budget": per-stage count /
    p50 / p99 / total, chain stages first (their totals decompose
    record→emit), downstream sink stages after."""
    stages = latency.get("stages") or {}
    if not stages:
        return []
    chain = list(latency.get("chain_stages")
                 or ("buffer", "queue", "dispatch", "inflight", "merge",
                     "emit"))
    order = [s for s in chain if s in stages] + sorted(
        s for s in stages if s not in chain)
    total_ms = sum((stages[s].get("sum") or 0.0) for s in order
                   if s in chain)
    lines = ["stage        windows      p50 ms      p99 ms    total ms  "
             "share"]
    for s in order:
        h = stages[s]
        share = ((h.get("sum") or 0.0) / total_ms * 100) if total_ms \
            and s in chain else None
        lines.append(
            f"{s:<12} {h.get('count', 0):>7} {h.get('p50', 0.0):>11.3f} "
            f"{h.get('p99', 0.0):>11.3f} {h.get('sum', 0.0):>11.1f}  "
            + (f"{share:>4.0f}%" if share is not None else "    -"))
    re_h = latency.get("record_emit") or {}
    if re_h.get("count"):
        lines.append(
            f"{'record→emit':<12} {re_h['count']:>7} {re_h['p50']:>11.3f} "
            f"{re_h['p99']:>11.3f} {re_h.get('sum', 0.0):>11.1f}   100%")
    check = latency.get("sum_check") or {}
    if check.get("windows"):
        lines.append(f"sum check    {check['windows']} window(s), max "
                     f"residual {check.get('max_residual_ms', 0.0)} ms")
    bp = (latency.get("backpressure") or {}).get("series") or []
    stalls = sum(1 for bkt in bp if bkt.get("stall"))
    if bp:
        lines.append(f"backpressure {len(bp)} bucket(s), {stalls} "
                     "stalled")
    return lines


# --------------------------------------------------------------------- #
# commands


def summarize(path: str, as_json: bool = False,
              out=None) -> int:
    # resolve at call time: a def-time sys.stdout default would pin
    # whatever stream was installed at first import (pytest capture)
    out = sys.stdout if out is None else out
    b = load_bundle(path)
    d = _bundle_digest(b)
    if as_json:
        print(json.dumps(d, sort_keys=True), file=out)
        return 0
    print(f"bundle     {path}", file=out)
    print(f"reason     {d['reason']}" + (f" — {d['error']}" if d["error"]
                                         else ""), file=out)
    print(f"backend    {d['backend']} ({d['device_kind']}), "
          f"valid_for_target={d['valid_for_target']}", file=out)
    print(f"pipeline   {d['records_in']} records in, {d['windows']} windows, "
          f"{d['throughput_rps']:.0f} rec/s", file=out)
    if d["healthy"] is not None:
        bad = ",".join(d["unhealthy_checks"]) or "-"
        print(f"health     {'ok' if d['healthy'] else 'BREACH'} "
              f"(failing: {bad}; {d['slo_breaches']} breach transition(s))",
              file=out)
    print(f"compiles   {d['compiles']} total, "
          f"{d['post_warmup_compiles']} post-warmup (warm={d['warm']})",
          file=out)
    for e in (b.get("compile") or {}).get("entries", [])[:5]:
        sig = e["signatures"][-1]["signature"] if e["signatures"] else "?"
        print(f"  {e['compiles']:3d}x {e['name']}  last {sig[:80]}",
              file=out)
    if d["dispatch_overlap_p50"] is not None:
        print(f"overlap    p50 {d['dispatch_overlap_p50']:.2f}", file=out)
    for line in _latency_table(b.get("latency") or {}):
        print(f"latency    {line}", file=out)
    print(f"transfer   d2h {d['d2h_bytes']} B; device mem in use "
          f"{d['mem_bytes_in_use']}", file=out)
    notes = (b.get("flight") or {}).get("notes", [])[-5:]
    for nte in notes:
        extra = {k: v for k, v in nte.items() if k not in ("ts_ms", "kind")}
        print(f"note       {nte.get('kind')} {extra}", file=out)
    evs = (b.get("events") or {}).get("events", [])[-5:]
    for ev in evs:
        print(f"event      #{ev.get('seq')} {ev.get('kind')}", file=out)
    return 0


def diff(path_a: str, path_b: str, as_json: bool = False,
         out=None) -> int:
    out = sys.stdout if out is None else out
    a, b = load_bundle(path_a), load_bundle(path_b)
    da, db = _bundle_digest(a), _bundle_digest(b)
    rows = []
    for key in ("reason", "error", "backend", "device_kind", "healthy",
                "unhealthy_checks", "records_in", "windows",
                "throughput_rps", "slo_breaches", "compiles",
                "post_warmup_compiles", "d2h_bytes",
                "dispatch_overlap_p50", "mem_bytes_in_use",
                "record_emit_p99_ms", "budgeted_windows"):
        va, vb = da.get(key), db.get(key)
        rows.append({"field": key, "a": va, "b": vb, "equal": va == vb})
    doc = {"a": path_a, "b": path_b,
           "cross_backend": da["backend"] != db["backend"],
           "rows": rows}
    if as_json:
        print(json.dumps(doc, sort_keys=True), file=out)
        return 0
    print(f"A: {path_a}  ({da['reason']})", file=out)
    print(f"B: {path_b}  ({db['reason']})", file=out)
    if doc["cross_backend"]:
        print(f"WARNING: cross-backend diff ({da['backend']} vs "
              f"{db['backend']}) — throughput/latency deltas are not "
              "comparable (the bench_diff pairing rule)", file=out)
    for r in rows:
        mark = " " if r["equal"] else "*"
        print(f"{mark} {r['field']:<22} {r['a']!r:>24} | {r['b']!r}",
              file=out)
    return 0


def preflight(require_backend: str = "gpu", as_json: bool = False,
              out=None) -> int:
    """Backend, memory and kernel-build readiness; exit non-zero when the
    platform the operator asked for is not what the process would run
    on."""
    out = sys.stdout if out is None else out
    import time as _time

    checks: List[dict] = []

    def check(name: str, ok: Optional[bool], detail) -> None:
        checks.append({"check": name, "ok": ok, "detail": detail})

    prov = None
    try:
        prov = deviceplane.backend_provenance(target=require_backend)
        check("backend", prov["platform"] == require_backend,
              f"platform={prov['platform']} device_kind="
              f"{prov['device_kind']} x{prov['device_count']} "
              f"(required: {require_backend})")
    except Exception as e:
        check("backend", False, f"backend probe failed: {e}")
    mem = deviceplane.memory_gauges()
    check("memory_stats", None if not mem["available"] else True,
          ("memory_stats available, "
           f"in_use={mem['bytes_in_use']}" if mem["available"]
           else "no memory_stats on this backend (normal on CPU)"))
    # build probe: one kernel library through the registry — proves nvcc
    # (or the built library) and that the sentinel would see it
    try:
        from spatialflink_tpu_torch.ops import native

        reg = deviceplane.registry()
        key = "spatialflink_tpu_torch.csrc.range_mask"
        known = key in reg.entries
        t0 = _time.perf_counter()
        native.load("range_mask")
        dt_ms = (_time.perf_counter() - t0) * 1e3
        entry = reg.entries.get(key)
        seen = entry is not None and "library" in entry.seen
        check("compile_probe", seen,
              f"librange_mask ready in {dt_ms:.0f}ms, "
              + ("registered by an earlier load" if known
                 else "registered by this load" if seen
                 else "the registry did not see it"))
    except Exception as e:
        check("compile_probe", False, f"kernel build failed: {e}")
    try:
        from spatialflink_tpu_torch.ops import native

        built = sorted(p.name for p in native.BUILD_DIR.glob("lib*.so"))
        check("compilation_cache", None if not built else True,
              (f"{len(built)} built librar"
               f"{'y' if len(built) == 1 else 'ies'} in {native.BUILD_DIR}"
               if built else f"nothing built yet in {native.BUILD_DIR} "
               "(the first run compiles every kernel)"))
    except Exception as e:
        check("compilation_cache", None, f"unreadable: {e}")
    failed = [c for c in checks if c["ok"] is False]
    doc = {"ready": not failed, "require_backend": require_backend,
           "provenance": prov, "checks": checks, "analysis": None}
    if as_json:
        print(json.dumps(doc, sort_keys=True), file=out)
    else:
        for c in checks:
            mark = {True: "ok  ", False: "FAIL", None: "note"}[c["ok"]]
            print(f"{mark} {c['check']:<18} {c['detail']}", file=out)
        print(("ready" if not failed else
               f"NOT READY ({', '.join(c['check'] for c in failed)})"),
              file=out)
    return 0 if not failed else 1


def tenants(path: str, as_json: bool = False, out=None) -> int:
    """The per-tenant cost table of one bundle's ``tenants.json`` —
    the post-mortem answer to "who was paying when it died": attributed
    kernel-ms with shares, bytes moved, records in/out, windows, and the
    SLO/shed/quota counters, plus the fairness summary and the worst
    per-dispatch attribution residual (the conservation check)."""
    out = sys.stdout if out is None else out
    b = load_bundle(path)
    ten = b.get("tenants") or {}
    rows = ten.get("tenants") or {}
    doc = {"path": path, "tenants": rows,
           "fairness": ten.get("fairness"),
           "default_tenant": ten.get("default_tenant"),
           "pending": ten.get("pending"),
           "max_residual_ms": ten.get("max_residual_ms")}
    if as_json:
        print(json.dumps(doc, sort_keys=True), file=out)
        return 0
    print(f"bundle     {path}", file=out)
    if not rows:
        print("tenants    (no tenant ledger in this bundle — no telemetry "
              "session at dump time)", file=out)
        return 0
    total_ms = sum(float(r.get("kernel_ms") or 0.0) for r in rows.values())
    print(f"{'tenant':<16} {'kernel ms':>10} {'share':>6} {'bytes':>12} "
          f"{'rec in':>9} {'rec out':>8} {'windows':>8} {'slo':>4} "
          f"{'shed':>5} {'quota':>6}", file=out)
    for t, r in sorted(rows.items(),
                       key=lambda kv: -float(kv[1].get("kernel_ms") or 0.0)):
        kms = float(r.get("kernel_ms") or 0.0)
        share = f"{kms / total_ms * 100:.0f}%" if total_ms else "-"
        print(f"{t:<16} {kms:>10.1f} {share:>6} "
              f"{int(r.get('bytes_moved') or 0):>12} "
              f"{int(r.get('records_in') or 0):>9} "
              f"{int(r.get('records_out') or 0):>8} "
              f"{int(r.get('windows') or 0):>8} "
              f"{int(r.get('slo_breaches') or 0):>4} "
              f"{int(r.get('shed') or 0):>5} "
              f"{int(r.get('quota_rejections') or 0):>6}", file=out)
    fair = ten.get("fairness") or {}
    if fair.get("top") is not None:
        print(f"fairness   top {fair.get('top')} "
              f"({(fair.get('top_share') or 0.0) * 100:.0f}%), max/min "
              f"share {(fair.get('max_share') or 0.0) * 100:.0f}%/"
              f"{(fair.get('min_share') or 0.0) * 100:.0f}%, "
              f"gini {fair.get('gini') or 0.0:.2f}", file=out)
    resid = ten.get("max_residual_ms")
    if resid is not None:
        print(f"residual   max attribution residual {float(resid):.6f} ms "
              "(per-dispatch conservation: attributed sums to measured)",
              file=out)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # `doctor --preflight` and `doctor preflight` both work, as in the JAX
    # package
    if "--preflight" in argv:
        argv[argv.index("--preflight")] = "preflight"
    ap = argparse.ArgumentParser(
        prog="python -m spatialflink_tpu_torch.doctor",
        description="preflight the device plane; summarize/diff "
                    "post-mortem bundles")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON document instead of text")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("preflight", help="backend/memory/compile readiness")
    p.add_argument("--require-backend", default="gpu",
                   choices=("cpu", "gpu"),
                   help="platform the run must land on (default gpu: a "
                        "run that would land on the CPU exits non-zero)")
    s = sub.add_parser("summarize", help="digest one bundle")
    s.add_argument("bundle")
    d = sub.add_parser("diff", help="compare two bundles")
    d.add_argument("bundle_a")
    d.add_argument("bundle_b")
    tn = sub.add_parser("tenants", help="per-tenant cost table from one "
                                        "bundle: attributed kernel-ms "
                                        "shares, quota/shed counters, "
                                        "fairness, attribution residual")
    tn.add_argument("bundle")
    fl = sub.add_parser("fleet", help="one table over a --fleet-dir "
                                      "(not yet ported: refused)")
    fl.add_argument("fleet_dir")
    args = ap.parse_args(argv)
    try:
        if args.cmd == "preflight":
            return preflight(args.require_backend, as_json=args.json)
        if args.cmd == "summarize":
            return summarize(args.bundle, as_json=args.json)
        if args.cmd == "fleet":
            print("doctor fleet: not yet ported to spatialflink_tpu_torch "
                  "(the fleet supervisor is not ported)", file=sys.stderr)
            return 2
        if args.cmd == "tenants":
            return tenants(args.bundle, as_json=args.json)
        return diff(args.bundle_a, args.bundle_b, as_json=args.json)
    except ValueError as e:
        print(f"doctor: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
