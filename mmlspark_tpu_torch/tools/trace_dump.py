"""Fetch tail-captured traces from a serving worker (or a whole fleet
via its coordinator) and render them.

The port's copy of ``tools/trace_dump.py``: the tool reads nothing but
the HTTP endpoints, which the port's ``ServingServer`` and
``ServingCoordinator`` answer as the JAX package's do, so it is carried
over as it is (the same output for the same replies).

A worker retains every slow (over its ``slow_trace_ms`` route
threshold — adaptive by default, tracking the route's p95) or non-ok
(error/shed/deadline/timeout) trace in its flight-recorder store (see
docs/observability.md "Tracing"). This CLI lists that store,
pretty-prints one trace's span tree, or writes the Chrome
``trace_event`` JSON that ``chrome://tracing`` and
https://ui.perfetto.dev open directly:

    python -m mmlspark_tpu_torch.tools.trace_dump http://worker:8000 --list
    python -m mmlspark_tpu_torch.tools.trace_dump http://worker:8000 --list --slow
    python -m mmlspark_tpu_torch.tools.trace_dump http://worker:8000 <trace-id>
    python -m mmlspark_tpu_torch.tools.trace_dump http://worker:8000 <trace-id> -o t.json
    python -m mmlspark_tpu_torch.tools.trace_dump http://worker:8000 --slowest -o t.json

With ``--fleet`` the URL names a ServingCoordinator instead: ``--list``
shows every worker's captures in one listing (worker-attributed,
slowest first, dead workers reported on stderr), and fetching a trace
returns the MERGED distributed tree — the client's failover schedule
with each worker's span tree stitched under its egress attempt
(``GET /fleet/traces`` / ``GET /fleet/trace/<id>``; the Perfetto
export renders each worker in its own lane):

    python -m mmlspark_tpu_torch.tools.trace_dump --fleet http://coordinator:8000 --list
    python -m mmlspark_tpu_torch.tools.trace_dump --fleet http://coordinator:8000 <trace-id>
    python -m mmlspark_tpu_torch.tools.trace_dump --fleet http://coordinator:8000 --slowest -o t.json

``--alerts`` / ``--slo`` switch to the SLO engine instead of the
trace store (docs/observability.md "SLOs and alerting"): ``--alerts``
prints the compact alert view (state, violating window pair,
attribution), ``--slo`` the full burn-rate report per policy. Both
compose with ``--fleet`` (merged evaluation, per-worker blocks):

    python -m mmlspark_tpu_torch.tools.trace_dump http://worker:8000 --alerts
    python -m mmlspark_tpu_torch.tools.trace_dump http://worker:8000 --slo
    python -m mmlspark_tpu_torch.tools.trace_dump --fleet http://coordinator:8000 --alerts

``--query`` / ``--range`` switch to the retrospective plane (the
embedded TSDB — docs/observability.md "The retrospective plane"):
``--query EXPR`` prints the instant result table, ``--range EXPR``
renders each returned series as an ANSI sparkline row (min/max/last
alongside). Both compose with ``--fleet`` (the coordinator fans the
expression out and merges the series under worker labels):

    python -m mmlspark_tpu_torch.tools.trace_dump http://worker:8000 \\
        --query 'rate(serving_requests_total[60s])'
    python -m mmlspark_tpu_torch.tools.trace_dump http://worker:8000 \\
        --range 'quantile(0.95, serving_dispatch_latency_ms[300s])' \\
        --window 600 --step 10
    python -m mmlspark_tpu_torch.tools.trace_dump --fleet http://coordinator:8000 \\
        --range 'serving:decode_ttft_ms:p95'

``--incidents`` / ``--profile`` switch to the postmortem plane
(docs/observability.md "The postmortem plane"): ``--incidents`` lists
captured incident bundles (fleet-wide and worker-attributed with
``--fleet``), ``--fetch <id> -o dir`` downloads one bundle's artifacts
into a directory (verifying the manifest digests), and ``--profile``
renders a collapsed-stack top-table from the always-on sampling
profiler's ``GET /profile/cpu`` (``--baseline N`` switches to the
differential "which frames got hotter" table):

    python -m mmlspark_tpu_torch.tools.trace_dump http://worker:8000 --incidents
    python -m mmlspark_tpu_torch.tools.trace_dump --fleet http://coordinator:8000 --incidents
    python -m mmlspark_tpu_torch.tools.trace_dump http://worker:8000 --incidents \\
        --fetch inc-... -o ./bundle
    python -m mmlspark_tpu_torch.tools.trace_dump http://worker:8000 --profile --window 30
    python -m mmlspark_tpu_torch.tools.trace_dump http://worker:8000 --profile --baseline 60

stdlib-only on the wire (urllib): runs anywhere the worker is
reachable, no client deps.
"""

from __future__ import annotations

import argparse
import json
import sys
from urllib.error import HTTPError
from urllib.parse import quote
from urllib.request import urlopen


def _get_json(url: str, timeout: float = 10.0):
    with urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def _print_tree(node: dict, depth: int = 0) -> None:
    flag = "" if node["status"] == "ok" else f"  [{node['status']}]"
    worker = node.get("worker")
    wtag = f"  ({worker})" if worker else ""
    attrs = node.get("attrs") or {}
    extra = "".join(f" {k}={v}" for k, v in sorted(attrs.items())
                    if k != "route")
    print(f"{'  ' * depth}{node['name']:<{max(24 - 2 * depth, 1)}} "
          f"@{node['start_ms']:>9.3f}ms  {node['duration_ms']:>9.3f}ms"
          f"{extra}{wtag}{flag}")
    for child in sorted(node.get("children", []),
                        key=lambda c: c["start_ms"]):
        _print_tree(child, depth + 1)


def _print_listing(traces: list, fleet: bool) -> None:
    for t in traces:
        wcol = f" {t.get('worker', ''):<22}" if fleet else ""
        print(f"{t['trace_id']:<34}{wcol} {t['root']:<12} "
              f"{t.get('route', ''):<14} "
              f"{t['duration_ms']:>10.3f}ms  {t['reason']:<9} "
              f"spans={t['n_spans']}")
    if not traces:
        print("(no retained traces — nothing slow or failed yet)",
              file=sys.stderr)


def _fmt_window(w: dict) -> str:
    mark = "  << VIOLATED" if w.get("violated") else ""
    return (f"long {w['long_s']:>6.0f}s burn={w.get('burn_long', 0):>7.2f}"
            f"  short {w['short_s']:>5.0f}s "
            f"burn={w.get('burn_short', 0):>7.2f}"
            f"  (fires at {w['burn_threshold']}x){mark}")


def _print_alert(a: dict, depth: int = 0) -> None:
    pad = "  " * depth
    print(f"{pad}{a['policy']:<20} [{a['state']:<8}] "
          f"{a['kind']}  objective={a['objective']}")
    for w in a.get("windows") or []:
        print(f"{pad}  {_fmt_window(w)}")
    for row in a.get("attribution") or []:
        labels = ",".join(f"{k}={v}"
                          for k, v in sorted(row["labels"].items()))
        print(f"{pad}  burning: {labels}  bad={row['bad']:.0f}")


def _print_alerts_view(view: dict, depth: int = 0) -> None:
    pad = "  " * depth
    alerts = view.get("alerts") or []
    print(f"{pad}firing={view.get('firing', 0)}  "
          f"active_alerts={len(alerts)}")
    for a in alerts:
        _print_alert(a, depth)


def _print_slo_report(rep: dict, depth: int = 0) -> None:
    pad = "  " * depth
    for p in rep.get("policies") or []:
        flag = "  << VIOLATED" if p.get("violated") else ""
        print(f"{pad}{p['policy']:<20} [{p.get('state', '?'):<8}] "
              f"{p['kind']}  objective={p['objective']}{flag}")
        for w in p.get("windows") or []:
            print(f"{pad}  {_fmt_window(w)}")
        extras = []
        if "error_rate" in p:
            extras.append(f"error_rate={p['error_rate']}")
            extras.append(f"bad={p.get('bad', 0):.0f}/"
                          f"{p.get('total', 0):.0f}")
        if p.get("measured_ms") is not None:
            extras.append(f"p{int(p.get('quantile', 0.95) * 100)}="
                          f"{p['measured_ms']}ms "
                          f"(target {p.get('threshold_ms')}ms)")
        if extras:
            print(f"{pad}  {'  '.join(extras)}")
        for row in p.get("attribution") or []:
            labels = ",".join(f"{k}={v}"
                              for k, v in sorted(row["labels"].items()))
            print(f"{pad}  burning: {labels}  bad={row['bad']:.0f}")


def _run_slo_mode(base: str, fleet: bool, mode: str) -> None:
    """``--alerts`` / ``--slo``: one worker's view, or the
    coordinator's merged evaluation with per-worker blocks."""
    if not fleet:
        body = _get_json(f"{base}/{mode}")
        if mode == "alerts":
            _print_alerts_view(body)
        else:
            _print_slo_report(body)
        return
    body = _get_json(f"{base}/fleet/{mode}")
    print(f"fleet: firing={body.get('firing', 0)}")
    fleet_block = body.get("fleet") or {}
    if mode == "alerts":
        _print_alerts_view(fleet_block, 1)
    else:
        _print_slo_report(fleet_block, 1)
    for wk, view in sorted((body.get("workers") or {}).items()):
        if isinstance(view, dict) and "error" in view:
            print(f"worker {wk}: unreachable ({view['error']})",
                  file=sys.stderr)
            continue
        print(f"worker {wk}:")
        if mode == "alerts":
            _print_alerts_view(view, 1)
        else:
            _print_slo_report(view, 1)


_BLOCKS = "▁▂▃▄▅▆▇█"


def _dim(s: str) -> str:
    return f"\x1b[2m{s}\x1b[0m" if sys.stdout.isatty() else s


def _bold(s: str) -> str:
    return f"\x1b[1m{s}\x1b[0m" if sys.stdout.isatty() else s


def _labels_str(labels: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(labels.items())) \
        or "(no labels)"


def _sparkline(values: list) -> str:
    """One series as unicode block characters, normalized to its own
    min/max (shape over scale: a latency series and a rate series are
    both readable at a glance)."""
    lo, hi = min(values), max(values)
    span = hi - lo
    if span <= 0:
        return _BLOCKS[0] * len(values)
    return "".join(
        _BLOCKS[int((v - lo) / span * (len(_BLOCKS) - 1))]
        for v in values)


def _fmt_val(v: float) -> str:
    if v == 0:
        return "0"
    if abs(v) >= 1000:
        return f"{v:.0f}"
    if abs(v) >= 1:
        return f"{v:.2f}".rstrip("0").rstrip(".")
    return f"{v:.4g}"


def _print_query_errors(body: dict) -> None:
    for wk, err in sorted((body.get("errors") or {}).items()):
        print(f"(worker {wk} unreachable: {err})", file=sys.stderr)


def _run_query_mode(base: str, fleet: bool, expr: str) -> None:
    """``--query``: the instant value table (one row per labelset,
    worker-attributed with --fleet)."""
    url = (f"{base}/fleet/query" if fleet else f"{base}/query") \
        + f"?expr={quote(expr, safe='')}"
    body = _get_json(url)
    _print_query_errors(body)
    results = body.get("results") or []
    print(_dim(f"{expr}  at={body.get('at')}  "
               f"{len(results)} result(s)"))
    if not results:
        print("(no data — is the recorder running and the series "
              "populated?)", file=sys.stderr)
        return
    width = max(len(_labels_str(r.get("labels") or {}))
                for r in results)
    for r in results:
        print(f"  {_labels_str(r.get('labels') or {}):<{width}}  "
              f"{_bold(_fmt_val(r['value']))}")


def _run_range_mode(base: str, fleet: bool, expr: str,
                    window: float, step: float) -> None:
    """``--range``: one ANSI sparkline row per returned series —
    ``/query_range`` over the trailing ``window`` seconds at ``step``
    resolution, the worker's newest recorded data as the right
    edge."""
    url = (f"{base}/fleet/query_range" if fleet
           else f"{base}/query_range") \
        + (f"?expr={quote(expr, safe='')}&start=-{window}"
           f"&step={step}")
    body = _get_json(url)
    _print_query_errors(body)
    series = body.get("series") or []
    start, end = body.get("start"), body.get("end")
    span = f"[{start:.0f}s .. {end:.0f}s]" \
        if start is not None and end is not None else ""
    print(_dim(f"{expr}  {span} step={body.get('step', step)}s  "
               f"{len(series)} series"))
    if not series:
        print("(no data — is the recorder running and the series "
              "populated?)", file=sys.stderr)
        return
    width = max(len(_labels_str(s.get("labels") or {}))
                for s in series)
    for s in series:
        vals = [p[1] for p in s.get("points") or []
                if p[1] is not None]
        if not vals:
            continue
        print(f"  {_labels_str(s.get('labels') or {}):<{width}}  "
              f"{_sparkline(vals)}  "
              + _dim(f"min={_fmt_val(min(vals))} "
                     f"max={_fmt_val(max(vals))} "
                     f"last={_fmt_val(vals[-1])} n={len(vals)}"))


def _get_bytes(url: str, timeout: float = 30.0) -> bytes:
    with urlopen(url, timeout=timeout) as resp:
        return resp.read()


def _fmt_ts(unix) -> str:
    if not unix:
        return "-"
    import datetime
    return datetime.datetime.fromtimestamp(float(unix)) \
        .strftime("%Y-%m-%d %H:%M:%S")


def _run_incidents_mode(base: str, fleet: bool) -> None:
    """``--incidents``: the captured-bundle inventory (fleet-wide and
    worker-attributed with --fleet), newest first."""
    if fleet:
        body = _get_json(f"{base}/fleet/incidents")
        incidents = body.get("incidents") or []
        for wk, err in sorted((body.get("errors") or {}).items()):
            print(f"(worker {wk}: {err})", file=sys.stderr)
    else:
        incidents = _get_json(f"{base}/incidents").get("incidents") or []
    for inc in incidents:
        wcol = f" {inc.get('worker', ''):<22}" if fleet else ""
        size_kb = (inc.get("bytes") or 0) / 1024.0
        state = "complete" if inc.get("complete") else "PARTIAL"
        print(f"{inc['id']:<44}{wcol} {inc.get('policy') or '?':<22} "
              f"{_fmt_ts(inc.get('at_unix')):<20} {state:<9} "
              f"files={inc.get('n_files', 0)} {size_kb:8.1f}KiB")
    if not incidents:
        print("(no incident bundles — nothing has fired, or capture "
              "is disabled)", file=sys.stderr)


def _run_fetch_mode(base: str, fleet: bool, inc_id: str,
                    out_dir: str) -> None:
    """``--fetch <id> -o dir``: download one bundle's artifacts,
    verifying each file against the manifest's SHA-256 digest. With
    --fleet the bundle is located via /fleet/incidents and fetched
    from the worker that holds it."""
    import hashlib
    import os
    if fleet:
        listing = _get_json(f"{base}/fleet/incidents")
        match = next((i for i in listing.get("incidents") or []
                      if i["id"] == inc_id), None)
        if match is None:
            raise SystemExit(f"incident {inc_id} not found on any "
                             f"worker (see --incidents)")
        base = f"http://{match['worker']}"
    info = _get_json(f"{base}/incidents/{quote(inc_id, safe='')}")
    manifest = info.get("manifest") or {}
    files = manifest.get("files") or {}
    names = sorted(set(info.get("present") or []) | set(files))
    if not names:
        raise SystemExit(f"incident {inc_id} has no artifacts")
    os.makedirs(out_dir, exist_ok=True)
    for name in names:
        body = _get_bytes(
            f"{base}/incidents/{quote(inc_id, safe='')}/{name}")
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(body)
        want = (files.get(name) or {}).get("sha256")
        got = hashlib.sha256(body).hexdigest()
        mark = ("ok" if want == got else
                ("UNVERIFIED" if want is None else "DIGEST MISMATCH"))
        print(f"  {name:<22} {len(body):>9} bytes  {mark}")
    print(f"fetched {len(names)} artifacts to {out_dir} "
          f"(complete={bool(manifest.get('complete'))})")


def _run_profile_mode(base: str, window: float,
                      baseline: float) -> None:
    """``--profile``: the always-on sampling profiler's window as a
    collapsed-stack top-table; with ``--baseline N`` the differential
    hotter-frames table instead."""
    if baseline:
        body = _get_json(f"{base}/profile/cpu?window_s={window}"
                         f"&baseline_s={baseline}")
        print(_dim(f"differential: last {window:.0f}s "
                   f"({body.get('cur_samples', 0)} samples) vs prior "
                   f"{baseline:.0f}s ({body.get('base_samples', 0)} "
                   f"samples)"))
        print(_bold(f"{'delta':>8} {'cur':>7} {'base':>7}  frame "
                    f"(hotter)"))
        for r in body.get("hotter") or []:
            print(f"{r['delta_share']:>+8.1%} {r['cur_share']:>7.1%} "
                  f"{r['base_share']:>7.1%}  {r['frame']}")
        cold = body.get("colder") or []
        if cold:
            print(_bold(f"{'delta':>8} {'cur':>7} {'base':>7}  frame "
                        f"(colder)"))
            for r in cold[:5]:
                print(f"{r['delta_share']:>+8.1%} "
                      f"{r['cur_share']:>7.1%} "
                      f"{r['base_share']:>7.1%}  {r['frame']}")
        return
    body = _get_json(f"{base}/profile/cpu?window_s={window}")
    stages = body.get("stages") or {}
    total = body.get("thread_samples") or 0
    print(_dim(f"cpu profile: last {window:.0f}s, "
               f"{body.get('samples', 0)} samples at "
               f"{body.get('hz', 0):.0f}hz"))
    if total:
        print("stages: " + "  ".join(
            f"{k}={v / total:.0%}" for k, v in stages.items()))
    print(_bold(f"{'samples':>8} {'share':>7}  stack (leaf last)"))
    for row in body.get("top_stacks") or []:
        stack = row["stack"]
        if len(stack) > 160:
            stack = "..." + stack[-157:]
        print(f"{row['count']:>8} {row['share']:>7.1%}  {stack}")
    if not body.get("top_stacks"):
        print("(no samples in the window — is the profiler enabled?)",
              file=sys.stderr)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("worker", help="worker base url, e.g. "
                                   "http://127.0.0.1:8000 (a "
                                   "coordinator url with --fleet)")
    ap.add_argument("trace_id", nargs="?",
                    help="trace to fetch (see --list)")
    ap.add_argument("--fleet", action="store_true",
                    help="URL is a ServingCoordinator: list every "
                         "worker's captures, fetch MERGED distributed "
                         "traces (per-worker Perfetto lanes)")
    ap.add_argument("--alerts", action="store_true",
                    help="print the SLO engine's compact alert view "
                         "(GET /alerts; /fleet/alerts with --fleet) "
                         "instead of traces")
    ap.add_argument("--slo", action="store_true",
                    help="print the full burn-rate report per policy "
                         "(GET /slo; /fleet/slo with --fleet) instead "
                         "of traces")
    ap.add_argument("--query", metavar="EXPR",
                    help="instant TSDB query (GET /query; /fleet/query "
                         "with --fleet): a selector, rate(sel[w]), "
                         "increase(sel[w]), or quantile(q, hist[w])")
    ap.add_argument("--range", metavar="EXPR", dest="range_expr",
                    help="range TSDB query rendered as ANSI sparklines "
                         "(GET /query_range; /fleet/query_range with "
                         "--fleet)")
    ap.add_argument("--incidents", action="store_true",
                    help="list captured incident bundles (GET "
                         "/incidents; /fleet/incidents with --fleet) — "
                         "docs/observability.md 'The postmortem plane'")
    ap.add_argument("--fetch", metavar="INCIDENT_ID",
                    help="with --incidents: download one bundle's "
                         "artifacts into the -o directory, verifying "
                         "manifest digests")
    ap.add_argument("--profile", action="store_true",
                    help="render a collapsed-stack top-table from the "
                         "always-on sampling profiler (GET "
                         "/profile/cpu?window_s=<--window>)")
    ap.add_argument("--baseline", type=float, default=0.0,
                    help="with --profile: differential mode — diff the "
                         "window against the N seconds before it and "
                         "rank frames by how much hotter they got")
    ap.add_argument("--window", type=float, default=300.0,
                    help="with --range: trailing seconds to render "
                         "(default 300); with --profile: the profile "
                         "window")
    ap.add_argument("--step", type=float, default=10.0,
                    help="with --range: evaluation step seconds "
                         "(default 10)")
    ap.add_argument("--list", action="store_true",
                    help="list retained traces and exit")
    ap.add_argument("--slow", action="store_true",
                    help="with --list: only threshold-retained traces "
                         "(drop error/shed/deadline captures; worker "
                         "mode only)")
    ap.add_argument("--slowest", action="store_true",
                    help="pick the longest retained trace instead of "
                         "naming one")
    ap.add_argument("-o", "--out", metavar="PATH",
                    help="write Perfetto/chrome://tracing trace_event "
                         "JSON here instead of printing the span tree")
    args = ap.parse_args(argv)
    base = args.worker.rstrip("/")
    trace_base = f"{base}/fleet/trace" if args.fleet else f"{base}/trace"

    if args.alerts or args.slo:
        _run_slo_mode(base, args.fleet,
                      "alerts" if args.alerts else "slo")
        return

    if args.incidents or args.fetch:
        if args.fetch:
            _run_fetch_mode(base, args.fleet, args.fetch,
                            args.out or args.fetch)
        else:
            _run_incidents_mode(base, args.fleet)
        return
    if args.profile:
        # --window's 300s default is the --range window; profiles
        # default to the last 30s (the ring holds ~180s)
        window = args.window if args.window != 300.0 else 30.0
        _run_profile_mode(base, window, args.baseline)
        return

    if args.query:
        _run_query_mode(base, args.fleet, args.query)
        return
    if args.range_expr:
        _run_range_mode(base, args.fleet, args.range_expr,
                        args.window, args.step)
        return

    if args.list or args.slowest:
        if args.fleet:
            fleet = _get_json(f"{base}/fleet/traces")
            traces = fleet["traces"]
            for wk, err in sorted(fleet.get("errors", {}).items()):
                print(f"(worker {wk} unreachable: {err})",
                      file=sys.stderr)
        else:
            traces = _get_json(f"{base}/traces"
                               + ("?slow=1" if args.slow else ""))
        if args.list:
            _print_listing(traces, args.fleet)
            return
        if not traces:
            raise SystemExit("no retained traces to pick --slowest from")
        # both listings arrive slowest-first, but stay explicit: the
        # choice must not depend on a server-side sort contract
        args.trace_id = max(traces,
                            key=lambda t: t["duration_ms"])["trace_id"]

    if not args.trace_id:
        raise SystemExit("need a trace id, --list, or --slowest")

    try:
        if args.out:
            pf = _get_json(
                f"{trace_base}/{args.trace_id}?format=perfetto")
            with open(args.out, "w") as f:
                json.dump(pf, f)
            print(f"wrote {len(pf['traceEvents'])} events to {args.out} "
                  f"(open in chrome://tracing or ui.perfetto.dev)")
        else:
            tr = _get_json(f"{trace_base}/{args.trace_id}")
            workers = tr.get("workers")
            wline = f"  workers={','.join(workers)}" if workers else ""
            print(f"trace {tr['trace_id']}  route={tr['route']}  "
                  f"status={tr['status']}  reason={tr['reason']}  "
                  f"{tr['duration_ms']}ms{wline}")
            for wk, err in sorted(
                    (tr.get("workers_failed") or {}).items()):
                print(f"(worker {wk} unreachable: {err})",
                      file=sys.stderr)
            _print_tree(tr["tree"])
    except HTTPError as e:
        if e.code == 404:
            raise SystemExit(
                f"trace {args.trace_id} not retained (fast + ok traces "
                f"are tail-dropped; see --list)") from e
        raise


if __name__ == "__main__":
    main()
