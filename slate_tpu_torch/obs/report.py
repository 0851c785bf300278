"""RunReport: the versioned machine-readable run record, and its CLI.

Counterpart of ``slate_tpu/obs/report.py``, with its schema
(``slate_tpu.obs.run_report`` v1) unchanged: a report from either package
passes the other's ``validate_report``, and ``--check`` decides the same
on the same pair of reports.  The port fills the ``ft``, ``ir`` and
``serve`` sections (its flat serve counters); ``mem`` and ``num`` come
with the memory and numerics slice, and every section is optional.

CLI::

    python -m slate_tpu_torch.obs.report REPORT.json              # pretty-print
    python -m slate_tpu_torch.obs.report --check NEW.json OLD.json [--threshold 1.5]
    python -m slate_tpu_torch.obs.report --trend LEDGER_DIR [--last 8]

``--check`` exits 1 when a shared metric regressed by more than the ratio
threshold (direction inferred per metric: *_seconds / *_bytes / *_error
are lower-is-better, throughput-style names higher-is-better), 2 when the
comparison is inconclusive.  ``--trend`` gates the newest report of a
ledger directory (one JSON report a file, names sorting oldest first)
against the per-key median of the prior ones: the same exit codes, 2 with
fewer than 3 usable entries.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional, Tuple

import os

from .metrics import REGISTRY, flatten_snapshot, serve_counts
from . import span as _span

SCHEMA = "slate_tpu.obs.run_report"
VERSION = 1

# substrings marking a metric as lower-is-better; everything else
# (gflops, gops, value, mfu, overlap_eff, ...) is treated as
# higher-is-better.  "critical_path" / "exposed" / "comm_s" / "wall_s"
# cover the flight recorder's sched.* timing keys.
_LOWER_BETTER = ("second", "time", "byte", "error", "err", "resid", "latency",
                 "uncorrectable", "critical_path", "exposed", "comm_s",
                 "wall_s", "compute_s",
                 # mixed-precision refinement outcomes: more iterations /
                 # escalations / full-f64 fallbacks per solve = worse
                 "iters_total", "escalated", "fallback",
                 # memory observability: OOM events are the failure the
                 # mem gate exists to pre-empt ("byte" already covers the
                 # residency maxima)
                 "oom",
                 # numerics observability: element growth, condition
                 # estimates, gauge alarms and per-solve iteration counts /
                 # trajectory lengths rising = accuracy health degrading
                 # under a fixed workload (num.chol_margin_min and the
                 # history_drop convergence ratio stay higher-is-better)
                 "growth", "condest", "alarm", "routed", "ir_iters",
                 "history_len",
                 # QR/eig-chain orthogonality-loss proxy rising = the
                 # implicit Q degrading under a fixed workload (the
                 # num.*_orth_margin gauge keys name the same loss)
                 "orth_loss", "orth_margin",
                 # serving runtime: misses/retraces/rejections rising
                 # under a fixed request stream = cache hygiene or
                 # admission coverage degrading (hits/traces/warmups
                 # stay direction-neutral counts that gate on equality)
                 "cache_miss", "retrace", "admission_reject",
                 # request-level SLA surface: rejected /
                 # failed terminal outcomes (counts AND rates) rising
                 # under a fixed request stream = the degradation
                 # ladder resolving fewer requests ("latency" above
                 # already covers the quantile keys the CI gate
                 # --ignores as wall-clock); "reject_" catches both the
                 # outcome_reject_* counts and the outcome_rate_reject_*
                 # shares, "failed_" both failed_info and failed_error
                 "reject_", "failed_",
                 # elastic reliability: steps lost to an unsnapshotted
                 # window (recovery cost) and FtError retries rising
                 # under a fixed injection = checkpoint cadence or
                 # resilience coverage degrading (snapshots/resumes/
                 # reshards stay direction-neutral activity counts)
                 "lost_steps", "retries")

# metric-name prefixes that form versioned report SECTIONS: when the new
# report carries them and the old artifact predates the section entirely
# (e.g. sched.* against a pre-flight report, ft_* against a pre-FT
# BENCH_*.json, ir_* against a pre-mixed-precision report, mem.*/mem_*
# against a pre-memory-observability report), --check reports each key
# as inconclusive instead of silently ignoring it or failing the whole
# check
_SECTION_PREFIXES = ("sched.", "ft_", "ir_", "mem_", "mem.", "num_",
                     "num.", "serve_", "serve.")

# pure cost-model estimates with no better/worse direction: halving the
# XLA flop estimate is usually an optimization, doubling may be a bigger
# problem — either way it is information, not a gate (checked before the
# _LOWER_BETTER substrings, so bytes_accessed stays neutral too)
_NEUTRAL = frozenset({"flops", "transcendentals", "bytes_accessed",
                      # a sampling COUNT is instrumentation volume, not a
                      # quality direction (the sampled maxima gate instead)
                      "mem_samples",
                      # aliased donation bytes RISING is an improvement
                      # (more buffers reused), and a collapse to zero is
                      # gated by the higher-is-better donation_*_alias_frac
                      # keys — the raw byte count itself has no direction
                      "mem.alias_bytes"})


def _env_info() -> dict:
    """torch's version, the platform (``cuda`` or ``cpu``) and the number
    of cards."""
    import torch

    cuda = torch.cuda.is_available()
    return {"torch": torch.__version__, "platform": "cuda" if cuda else "cpu",
            "device_count": torch.cuda.device_count() if cuda else 0}


def make_report(
    name: str,
    config: Optional[dict] = None,
    values: Optional[Dict[str, float]] = None,
    include_spans: bool = True,
) -> dict:
    """Build a RunReport dict from the current metrics registry + span
    stream, plus explicit headline ``values``."""
    spans = list(_span.FINISHED) if include_spans else []
    base = min((s["t0"] for s in spans), default=0.0)
    from ..ft.policy import ft_counter_values
    from ..linalg.refine import ir_counter_values
    from .context import current as _ctx_current

    cfg = dict(config or {})
    # a report written under a TraceContext is joinable against its spans
    ctx = _ctx_current()
    if ctx is not None and "trace_id" not in cfg:
        cfg["trace_id"] = ctx.trace_id

    return {
        "schema": SCHEMA,
        "version": VERSION,
        "name": name,
        "created_unix": time.time(),
        "env": _env_info(),
        "config": cfg,
        "values": {k: float(v) for k, v in (values or {}).items()},
        # fault-tolerance totals (ft.* counters) accumulated this run
        "ft": ft_counter_values(),
        # mixed-precision refinement totals (ir.* counters)
        "ir": ir_counter_values(),
        # the flat serve counters (the Ozaki plane cache, the condest memo)
        "serve": serve_counts(),
        "metrics": REGISTRY.snapshot(),
        "spans": [
            {
                "name": s["name"],
                "tags": s.get("tags", {}),
                "start_s": s["t0"] - base,
                "dur_s": s["t1"] - s["t0"],
                "depth": s.get("depth", 0),
                "parent": s.get("parent"),
                "metrics": s.get("metrics", {}),
            }
            for s in spans
        ],
    }


def write_report(path: str, name: str, config: Optional[dict] = None,
                 values: Optional[Dict[str, float]] = None) -> str:
    rep = make_report(name, config, values)
    with open(path, "w") as f:
        json.dump(rep, f, indent=1)
    return path


def write_checked_report(out_dir: Optional[str], fname: str, name: str,
                         config: Optional[dict] = None,
                         values: Optional[Dict[str, float]] = None) -> Tuple[dict, List[str], int]:
    """The smokes' report step: write a RunReport to ``out_dir/fname``
    (a temporary directory when ``out_dir`` is None), read it back, and
    return (the report, its ``validate_report`` problems, the exit code of
    ``--check`` of the report against itself: 0 when it passes)."""
    import contextlib
    import io
    import tempfile

    with contextlib.ExitStack() as es:
        if out_dir is None:
            out_dir = es.enter_context(tempfile.TemporaryDirectory())
        os.makedirs(out_dir, exist_ok=True)
        path = write_report(os.path.join(out_dir, fname), name, config, values)
        with open(path) as f:
            doc = json.load(f)
        with contextlib.redirect_stdout(io.StringIO()):
            rc = main(["--check", path, path])
    return doc, validate_report(doc), rc


def validate_report(rep) -> List[str]:
    """Schema check; returns problems (empty list == valid)."""
    errs: List[str] = []
    if not isinstance(rep, dict):
        return ["report must be an object"]
    if rep.get("schema") != SCHEMA:
        errs.append(f"schema must be {SCHEMA!r}, got {rep.get('schema')!r}")
    if not isinstance(rep.get("version"), int):
        errs.append("version must be an int")
    if not isinstance(rep.get("name"), str) or not rep.get("name"):
        errs.append("name must be a non-empty string")
    if not isinstance(rep.get("created_unix"), (int, float)):
        errs.append("created_unix must be a number")
    vals = rep.get("values")
    if not isinstance(vals, dict) or any(
        not isinstance(v, (int, float)) for v in vals.values()
    ):
        errs.append("values must map metric name -> number")
    m = rep.get("metrics")
    if not isinstance(m, dict) or any(
        not isinstance(m.get(k), list) for k in ("counters", "gauges", "histograms")
    ):
        errs.append("metrics must hold counters/gauges/histograms lists")
    for sec in ("ft", "ir", "mem", "num", "serve"):  # optional (older reports predate these)
        sv = rep.get(sec)
        if sv is not None and (
            not isinstance(sv, dict)
            or any(not isinstance(v, (int, float)) for v in sv.values())
        ):
            errs.append(f"{sec} must map outcome name -> number")
    spans = rep.get("spans")
    if not isinstance(spans, list):
        errs.append("spans must be a list")
    else:
        for i, s in enumerate(spans):
            if not isinstance(s, dict) or not s.get("name"):
                errs.append(f"spans[{i}]: missing name")
            elif not isinstance(s.get("dur_s"), (int, float)) or s["dur_s"] < 0:
                errs.append(f"spans[{i}]: bad dur_s")
    return errs


def load_values(doc: dict, include_series: bool = False) -> Dict[str, float]:
    """Comparable scalar metrics from a RunReport OR a legacy BENCH_*.json
    line ({"metric", "value", "extras": {...}}).

    By default only the headline ``values`` of a RunReport are returned —
    they are workload-keyed and comparable across runs.  The flattened
    counter/gauge/histogram series (``comm_bytes|span=...`` etc.) scale
    with however much work a run happened to do, so they only join the
    comparison on request (``include_series=True`` / ``--all-metrics``),
    for same-config run pairs."""
    vals: Dict[str, float] = {}
    if doc.get("schema") == "slate_tpu.obs.flight_report":
        # FlightReports (obs.flight) carry a ready-made flat values
        # section (sched.* + modeled bytes); gate it directly
        return {k: float(v) for k, v in (doc.get("values") or {}).items()
                if isinstance(v, (int, float))}
    if doc.get("schema") == SCHEMA:
        vals.update(doc.get("values", {}))
        # ft.* outcome totals gate like any metric: under a fixed fault
        # injection (ft.smoke), a drop in detected/corrected is a
        # detection-coverage regression — including a collapse to zero
        # (check_regression fails higher-is-better metrics that hit 0).
        # An ALL-zero section (no FT activity this run) stays out of the
        # comparison surface entirely: those zeros cannot gate and would
        # pollute headline-values-only comparisons.  The fully-lost-
        # coverage case (every counter zero under injection) is gated by
        # ft.smoke's absolute assertions, not this relative check.
        ftvals = {k: v for k, v in (doc.get("ft") or {}).items()
                  if isinstance(v, (int, float))}
        if any(ftvals.values()):
            vals.update({f"ft_{k}": float(v) for k, v in ftvals.items()})
        # ir.* refinement totals gate the same way: under a fixed solve
        # workload, converged dropping (or fallbacks rising) is a
        # mixed-precision coverage regression; an all-zero section (no
        # mixed solves this run) stays out of the comparison surface
        irvals = {k: v for k, v in (doc.get("ir") or {}).items()
                  if isinstance(v, (int, float))}
        if any(irvals.values()):
            vals.update({f"ir_{k}": float(v) for k, v in irvals.items()})
        # mem.* totals gate the same way: under a fixed instrumented
        # workload a live/peak-byte maximum rising is a residency
        # regression (and oom_events appearing is the crash the gate
        # exists to pre-empt); an all-zero section (no sampling this
        # run) stays out of the comparison surface
        memvals = {k: v for k, v in (doc.get("mem") or {}).items()
                   if isinstance(v, (int, float))}
        if any(memvals.values()):
            vals.update({f"mem_{k}": float(v) for k, v in memvals.items()})
        # num.* totals gate the same way: under a fixed monitored
        # workload, worst growth/condest rising (or alarms appearing) is
        # an accuracy-health regression; an all-zero section (nothing
        # monitored this run) stays out of the comparison surface
        numvals = {k: v for k, v in (doc.get("num") or {}).items()
                   if isinstance(v, (int, float))}
        if any(numvals.values()):
            vals.update({f"num_{k}": float(v) for k, v in numvals.items()})
        # serve.* totals gate the same way: under a fixed request stream,
        # cache misses / retraces / admission rejects rising is a serving
        # hygiene regression; an all-zero section (no serving activity
        # this run) stays out of the comparison surface
        srvvals = {k: v for k, v in (doc.get("serve") or {}).items()
                   if isinstance(v, (int, float))}
        if any(srvvals.values()):
            vals.update({f"serve_{k}": float(v) for k, v in srvvals.items()})
        if include_series:
            vals.update(flatten_snapshot(doc.get("metrics", {})))
        return {k: float(v) for k, v in vals.items()
                if isinstance(v, (int, float))}
    if "metric" in doc and "value" in doc:  # legacy bench line
        if isinstance(doc["value"], (int, float)):
            vals[doc["metric"]] = float(doc["value"])
        for k, v in (doc.get("extras") or {}).items():
            if isinstance(v, (int, float)):
                vals[k] = float(v)
        return vals
    if "results" in doc:  # legacy SWEEP_*.json
        for r in doc["results"]:
            if isinstance(r.get("gflops"), (int, float)) and r.get("ok"):
                vals[f"{r['routine']}_n{r['n']}_gflops"] = float(r["gflops"])
        return vals
    if isinstance(doc.get("tail"), str):  # driver BENCH_*.json wrapper:
        # the bench stdout rides in "tail"; its last parsable JSON object
        # line with a "metric" key is the headline record
        for line in reversed(doc["tail"].splitlines()):
            if not line.startswith("{"):
                continue
            try:
                inner = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(inner, dict) and "metric" in inner:
                return load_values(inner)
        raise ValueError(
            "BENCH wrapper has no parsable metric line in its tail "
            f"(rc={doc.get('rc')}) — cannot gate against it")
    raise ValueError("unrecognized report format (not a RunReport, bench "
                     "line, or sweep file)")


def ledger_load(ledger_dir: str, last: Optional[int] = None) -> List[dict]:
    """The JSON reports of a ledger directory, oldest first (file names
    sort by time), the newest ``last`` when given; unreadable entries are
    skipped."""
    try:
        names = sorted(n for n in os.listdir(ledger_dir) if n.endswith(".json"))
    except OSError:
        return []
    paths = [os.path.join(ledger_dir, n) for n in names]
    if last:
        paths = paths[-last:]
    docs: List[dict] = []
    for p in paths:
        try:
            with open(p) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        if isinstance(doc, dict):
            doc["_ledger_path"] = p
            docs.append(doc)
    return docs


def lower_is_better(name: str) -> bool:
    low = name.lower()
    return any(tok in low for tok in _LOWER_BETTER)


def inconclusive_keys(
    new_vals: Dict[str, float], old_vals: Dict[str, float]
) -> List[str]:
    """Sectioned metrics (``sched.*`` / ``ft_*``) present only in the NEW
    report: the old artifact predates that metrics section, so the keys
    are per-key INCONCLUSIVE — neither passed nor regressed (the
    mixed-schema case: a flight report against a pre-flight RunReport, an
    ft-carrying report against a pre-FT BENCH_*.json)."""
    return sorted(
        k for k in new_vals
        if k not in old_vals and k.startswith(_SECTION_PREFIXES)
    )


def check_regression(
    new_vals: Dict[str, float],
    old_vals: Dict[str, float],
    threshold: float = 1.5,
) -> Tuple[List[str], int]:
    """Compare shared metrics; returns (failure messages, n compared).
    A metric fails when it is worse than the old value by more than the
    ratio threshold in its own direction."""
    failures: List[str] = []
    compared = 0
    for name in sorted(set(new_vals) & set(old_vals)):
        if name.split("|", 1)[0] in _NEUTRAL:
            continue  # directionless cost estimates never gate
        old, new = old_vals[name], new_vals[name]
        if old != 0 and new == 0 and not lower_is_better(name):
            # a higher-is-better metric collapsing to exactly zero is the
            # worst regression, not an undefined ratio (e.g. ft_detected
            # 5 -> 0 under a fixed fault injection = detection coverage
            # lost; gflops -> 0 = the op never ran)
            compared += 1
            failures.append(f"{name}: collapsed to 0 (was {old:.4g})")
            continue
        if old == 0 or new == 0:
            continue  # ratios undefined; absolute-zero metrics can't gate
        if (old < 0) != (new < 0):
            continue
        compared += 1
        ratio = new / old if lower_is_better(name) else old / new
        if ratio > threshold:
            direction = "rose" if lower_is_better(name) else "fell"
            failures.append(
                f"{name}: {direction} {ratio:.2f}x beyond threshold "
                f"{threshold}x ({old:.4g} -> {new:.4g})"
            )
    return failures, compared


def trend_baseline(
    history: List[Dict[str, float]], min_runs: int = 2
) -> Tuple[Dict[str, float], List[str]]:
    """Per-key median over the history runs that carry the key — the
    robust N-run baseline ``--trend`` gates against (one outlier run
    cannot drag it).  Keys carried by fewer than ``min_runs`` history
    entries come back separately as thin: one prior run is a pair, not
    a trend, so those keys are per-key inconclusive."""
    from statistics import median

    carriers: Dict[str, List[float]] = {}
    for vals in history:
        for k, v in vals.items():
            carriers.setdefault(k, []).append(v)
    base = {k: float(median(vs)) for k, vs in carriers.items()
            if len(vs) >= min_runs}
    thin = sorted(k for k, vs in carriers.items() if len(vs) < min_runs)
    return base, thin


def _pretty(rep: dict) -> str:
    lines = [f"RunReport {rep.get('name')!r} (schema {rep.get('schema')} "
             f"v{rep.get('version')})"]
    env = rep.get("env") or {}
    if env:
        lines.append("  env: " + ", ".join(f"{k}={v}" for k, v in sorted(env.items())))
    cfg = rep.get("config") or {}
    if cfg:
        lines.append("  config: " + ", ".join(f"{k}={v}" for k, v in sorted(cfg.items())))
    vals = rep.get("values") or {}
    if vals:
        lines.append("  values:")
        for k, v in sorted(vals.items()):
            lines.append(f"    {k:<44} {v:>14.4g}")
    m = rep.get("metrics") or {}
    for kind in ("counters", "gauges"):
        for e in m.get(kind, []):
            tagstr = ",".join(f"{k}={v}" for k, v in sorted((e.get("tags") or {}).items()))
            lines.append(f"  {kind[:-1]:<8} {e['name']}{{{tagstr}}} = {e['value']:.6g}")
    for e in m.get("histograms", []):
        tagstr = ",".join(f"{k}={v}" for k, v in sorted((e.get("tags") or {}).items()))
        lines.append(
            f"  hist     {e['name']}{{{tagstr}}} n={e['count']} sum={e['sum']:.6g}"
        )
    spans = rep.get("spans") or []
    if spans:
        lines.append(f"  spans ({len(spans)}):")
        for s in spans[:64]:
            pad = "  " * int(s.get("depth", 0))
            lines.append(
                f"    {pad}{s['name']}  {s['dur_s'] * 1e3:.2f} ms"
                + (f"  comm={s['metrics'].get('comm_bytes', 0):,.0f}B"
                   if s.get("metrics", {}).get("comm_bytes") else "")
            )
        if len(spans) > 64:
            lines.append(f"    ... {len(spans) - 64} more")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m slate_tpu_torch.obs.report", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("report", nargs="?", help="RunReport JSON to pretty-print")
    ap.add_argument("--check", nargs=2, metavar=("NEW", "OLD"),
                    help="compare NEW against OLD (RunReport or BENCH_*.json)")
    ap.add_argument("--trend", metavar="LEDGER_DIR",
                    help="gate the newest report of a ledger directory "
                         "against the per-key median of the prior ones "
                         "(N-run regression detection)")
    ap.add_argument("--last", type=int, default=8,
                    help="--trend window: newest N ledger entries to "
                         "consider (default 8)")
    ap.add_argument("--threshold", type=float, default=1.5,
                    help="worse-than ratio that fails --check (default 1.5)")
    ap.add_argument("--all-metrics", action="store_true",
                    help="gate the flattened counter/histogram series too "
                         "(only meaningful for same-config run pairs; the "
                         "default gates the headline values only)")
    ap.add_argument("--ignore", action="append", default=[],
                    metavar="GLOB",
                    help="metric-name glob to exclude from --check "
                         "(repeatable); e.g. 'sched.*_s' keeps a flight "
                         "gate on the deterministic byte/count keys while "
                         "skipping millisecond wall-clock keys a slower "
                         "CI machine would flake")
    args = ap.parse_args(argv)

    if args.trend:
        import fnmatch

        docs = ledger_load(args.trend, last=max(3, args.last))
        usable = []
        for d in docs:
            try:
                vals = load_values(d, args.all_metrics)
            except ValueError:
                continue  # timed-out/unrecognized entries stay out
            if args.ignore:
                vals = {k: v for k, v in vals.items()
                        if not any(fnmatch.fnmatch(k, g)
                                   for g in args.ignore)}
            usable.append((d, vals))
        if len(usable) < 3:
            print(f"obs.report: trend inconclusive — {len(usable)} usable "
                  f"ledger entr{'y' if len(usable) == 1 else 'ies'} under "
                  f"{args.trend} (need >= 3: a latest run plus >= 2 of "
                  "history)")
            return 2
        latest_doc, latest_vals = usable[-1]
        history = [v for _, v in usable[:-1]]
        baseline, thin = trend_baseline(history)
        where = latest_doc.get("_ledger_path", "<latest>")
        tr = (latest_doc.get("config") or {}).get("trace_id", "")
        print(f"obs.report: trend — gating {where}"
              + (f" (trace_id {tr})" if tr else "")
              + f" against the median of {len(history)} prior run(s)")
        for key in sorted(set(latest_vals) - set(baseline)):
            # thin (one prior carrier) or brand-new keys alike: one or
            # zero prior points is a pair at best, not a trend
            print(f"  INCONCLUSIVE {key} = {latest_vals[key]:.6g} — "
                  f"carried by {'1' if key in thin else '0'} prior "
                  "ledger entr" + ("y" if key in thin else "ies"))
        failures, compared = check_regression(
            latest_vals, baseline, args.threshold)
        if compared == 0:
            print("obs.report: trend inconclusive — no metric shared by "
                  "the latest entry and >= 2 prior ones")
            return 2
        if failures:
            print(f"obs.report: trend — {len(failures)} regression(s) over "
                  f"{compared} gated metric(s):")
            for msg in failures:
                print(f"  FAIL {msg}")
            return 1
        print(f"obs.report: trend OK — {compared} metric(s) within "
              f"{args.threshold}x of the {len(history)}-run median")
        return 0

    if args.check:
        new_path, old_path = args.check
        try:
            with open(new_path) as f:
                new_doc = json.load(f)
            with open(old_path) as f:
                old_doc = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"obs.report: cannot read report: {e}")
            return 2
        if new_doc.get("schema") == SCHEMA:
            errs = validate_report(new_doc)
            if errs:
                print(f"obs.report: {new_path} is not a valid RunReport:")
                for e in errs:
                    print(f"  {e}")
                return 2
        elif new_doc.get("schema") == "slate_tpu.obs.flight_report":
            from .flight import validate_flight_report

            errs = validate_flight_report(new_doc)
            if errs:
                print(f"obs.report: {new_path} is not a valid FlightReport:")
                for e in errs:
                    print(f"  {e}")
                return 2
        if (new_doc.get("schema") == SCHEMA == old_doc.get("schema")
                and new_doc.get("config") != old_doc.get("config")):
            print(f"obs.report: note — configs differ "
                  f"({new_doc.get('config')} vs {old_doc.get('config')}); "
                  "only matching metric names are compared")
        try:
            new_vals = load_values(new_doc, args.all_metrics)
            old_vals = load_values(old_doc, args.all_metrics)
            if args.ignore:
                import fnmatch

                def _keep(vals):
                    return {k: v for k, v in vals.items()
                            if not any(fnmatch.fnmatch(k, g)
                                       for g in args.ignore)}

                new_vals, old_vals = _keep(new_vals), _keep(old_vals)
            failures, compared = check_regression(
                new_vals, old_vals, args.threshold
            )
        except ValueError as e:
            # an unrecognized/timed-out artifact is INCONCLUSIVE (2), not
            # a regression (1)
            print(f"obs.report: {e}")
            return 2
        # sectioned metrics the old artifact predates: per-key
        # inconclusive, never a failure of the whole check
        for key in inconclusive_keys(new_vals, old_vals):
            print(f"  INCONCLUSIVE {key} = {new_vals[key]:.6g} — section "
                  "absent from the old artifact")
        if compared == 0:
            print("obs.report: no shared metrics to compare")
            return 2
        if failures:
            print(f"obs.report: {len(failures)} regression(s) over "
                  f"{compared} shared metric(s):")
            for msg in failures:
                print(f"  FAIL {msg}")
            return 1
        print(f"obs.report: OK — {compared} shared metric(s) within "
              f"{args.threshold}x")
        return 0

    if not args.report:
        ap.error("give a REPORT to print or --check NEW OLD")
    with open(args.report) as f:
        rep = json.load(f)
    errs = validate_report(rep) if rep.get("schema") == SCHEMA else []
    print(_pretty(rep) if rep.get("schema") == SCHEMA else json.dumps(rep, indent=1))
    if errs:
        print("validation problems:")
        for e in errs:
            print(f"  {e}")
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
