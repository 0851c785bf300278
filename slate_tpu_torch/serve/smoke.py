"""Serve smoke: the acceptance run of the serving core.

Counterpart of ``slate_tpu/serve/smoke.py``, on the 2 x 4 virtual mesh on
one device.  It asserts:

(a) **Batched throughput**: the stacked batch driver solves B same-shaped
    SPD problems >= 3x faster (solves/s) than the loop of one-at-a-time
    mesh solves (``posv_mesh``, warm), and every batched solution is
    bitwise the single verb's;
(b) **No steady-state rebuilds**: after warm-up, more batches through the
    executable cache build nothing (``assert_steady``);
(c) **Ragged packing**: pack -> solve -> unpack gives each problem bitwise
    what it gives packed alone, and the unpadded solve to 1e-10;
(d) **Tuned table**: the committed artifact loads, validates, and the
    request path resolves unset options through it (explicit still wins);
(e) **Request-level SLA**: a meshless Router stream leaves a non-empty
    latency histogram per accuracy class with p50 <= p95 <= p99, every
    request attributed to exactly one outcome, and a valid Perfetto request
    timeline, and the Prometheus export (``serve.stats``) carries the
    request counter and the latency summary with its p99.

It writes ``serve.report.json`` (RunReport, ``serve`` section and the
headline values; machine-dependent rates carry ``_runtime_``) and
``serve_sla.report.json`` under ``--out``.

Usage::

    python -m slate_tpu_torch.serve.smoke [--device cpu|cuda] [--out DIR] [--n 512] [--batch 8]

The device defaults to the card; without one it raises unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

OUT_DIR = os.path.join("artifacts", "serve_torch")


def _fence(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _spd_stack(rng, batch: int, n: int, device):
    import numpy as np
    import torch

    g = rng.standard_normal((batch, n, n))
    return torch.from_numpy(np.einsum("bij,bkj->bik", g, g) / n + 2 * np.eye(n)[None]).to(device)


def measure_throughput(mesh, n: int = 512, batch: int = 8, nrhs: int = 1, reps: int = 3,
                       loop_reps: int = 2) -> dict:
    """Warm solves/s of the stacked batch driver against the one-at-a-time
    mesh-driver loop on B SPD f64 problems on ``mesh.device``, and whether
    every batched row is bitwise ``posv_array`` of its problem."""
    import numpy as np
    import torch

    from ..linalg.chol import posv_array
    from ..parallel.drivers import posv_mesh
    from ..types import Option
    from .batch import posv_batched
    from .cache import executable_cache, make_key

    dev = mesh.device
    rng = np.random.default_rng(0)
    spd = _spd_stack(rng, batch, n, dev)
    b = torch.from_numpy(rng.standard_normal((batch, n, nrhs))).to(dev)

    # one mesh dispatch per problem (the direct f64 driver: fixed work per
    # request, no refinement trip count in the denominator)
    opts = {Option.MixedPrecision: "off"}
    loop_nb = 64
    posv_mesh(spd[0], b[0], mesh, loop_nb, opts)
    _fence(dev)
    t0 = time.perf_counter()
    for _ in range(loop_reps):
        for i in range(batch):
            posv_mesh(spd[i], b[i], mesh, loop_nb, opts)
        _fence(dev)
    loop_s = (time.perf_counter() - t0) / loop_reps

    # the serving path: one built program over the stack, through the cache
    key = make_key("posv_batched", (spd, b), batch=batch, mesh=None)
    executable_cache.warmup(key, lambda: posv_batched, (spd, b))
    prog = executable_cache.get_or_build(key, lambda: posv_batched)
    t0 = time.perf_counter()
    for _ in range(reps):
        xs, info = prog(spd, b)
        _fence(dev)
    bat_s = (time.perf_counter() - t0) / reps

    bitwise = all(torch.equal(xs[i], posv_array(spd[i], b[i])[0]) for i in range(batch))
    return {
        "n": n, "batch": batch, "key": key,
        "loop_solves_per_s": batch / loop_s,
        "batched_solves_per_s": batch / bat_s,
        "speedup": loop_s / bat_s,
        "bitwise": bitwise,
        "info_ok": bool((info == 0).all()),
    }


def run_sla_phase(out_dir: str, failures: list, device) -> dict:
    """(e) A deterministic meshless request stream through the Router (both
    condest classes and one admission reject); asserts the trace and SLA
    contracts and writes ``serve_sla.report.json`` and the Perfetto request
    timeline."""
    import numpy as np
    import torch

    from ..obs import perfetto, report
    from ..types import SlateError
    from . import trace as serve_trace
    from .router import Router
    from .stats import prometheus_text, stats_snapshot

    rng = np.random.default_rng(3)
    n = 48
    router = Router(bins=(64,), hbm_budget=1 << 30, device=device)
    traces_before = len(serve_trace.finished_traces())
    requests = 0

    def t(x):
        return torch.from_numpy(x).to(device)

    def spd(sz):
        g = rng.standard_normal((sz, sz))
        return t(g @ g.T / sz + 2 * np.eye(sz))

    b = t(rng.standard_normal((n, 2)))
    # friendly gesv x2, posv x3, hostile gesv x2 (cond 1e9, past
    # CONDEST_THRESHOLD)
    for _ in range(2):
        router.solve("gesv", t(rng.standard_normal((n, n)) + n * np.eye(n)), b)
        requests += 1
    for _ in range(3):
        router.solve("posv", spd(n), b)
        requests += 1
    q1, _ = np.linalg.qr(rng.standard_normal((n, n)))
    q2, _ = np.linalg.qr(rng.standard_normal((n, n)))
    sing = np.logspace(0, -9, n)
    for _ in range(2):
        router.solve("gesv", t(q1 @ np.diag(sing) @ q2), b)
        requests += 1
    # one admission reject: a router whose budget admits nothing
    tiny = Router(bins=(64,), hbm_budget=10_000, device=device)
    try:
        tiny.solve("posv", spd(n), b)
        failures.append("SLA phase: 10kB-budget router admitted an n=48 solve -- admission "
                        "model broken")
    except SlateError:
        pass
    requests += 1

    traces = serve_trace.finished_traces()[traces_before:]
    if len(traces) != requests:
        failures.append(f"SLA phase: {requests} requests produced {len(traces)} finished traces")
    if any(tr.outcome is None for tr in traces):
        failures.append("SLA phase: a finished trace has no terminal outcome")
    sla = serve_trace.sla_values()
    total_outcomes = sum(v for k, v in sla.items()
                         if k.startswith("outcome_") and not k.startswith("outcome_rate_"))
    if total_outcomes != requests:
        failures.append(f"SLA phase: outcome totals {total_outcomes} != request count "
                        f"{requests} -- a request is unattributed or double-attributed")
    for op, klass in (("gesv", "friendly"), ("gesv", "hostile"), ("posv", "friendly")):
        if sla.get(f"latency_count_{op}_{klass}", 0) <= 0:
            failures.append(f"SLA phase: empty latency histogram for ({op}, {klass})")
            continue
        p50, p95, p99 = (sla[f"latency_{q}_{op}_{klass}_s"] for q in ("p50", "p95", "p99"))
        if not 0 <= p50 <= p95 <= p99:
            failures.append(f"SLA phase: quantiles not monotone for ({op}, {klass}): "
                            f"{p50} / {p95} / {p99}")
    trace_path = os.path.join(out_dir, "serve_requests.trace.json")
    perfetto.write_request_trace(trace_path, traces)
    with open(trace_path) as f:
        errs = perfetto.validate_chrome_trace(json.load(f))
    if errs:
        failures.append(f"SLA phase: request timeline invalid: {errs[:3]}")
    text = prometheus_text(stats_snapshot())
    for needle in ("slate_tpu_serve_requests", "slate_tpu_serve_latency_s", 'quantile="0.99"'):
        if needle not in text:
            failures.append(f"SLA phase: {needle!r} missing from the Prometheus export")
    sla_rep_path = os.path.join(out_dir, "serve_sla.report.json")
    report.write_report(sla_rep_path, name="serve_sla",
                        config={"n": n, "bins": "64", "driver": "router_meshless",
                                "device": str(torch.device(device))},
                        values={"serve.sla_requests": float(requests),
                                "serve.sla_traces": float(len(traces))})
    with open(sla_rep_path) as f:
        errs = report.validate_report(json.load(f))
    if errs:
        failures.append(f"SLA RunReport schema: {errs}")
    return {"requests": requests, "traces": len(traces), "report": sla_rep_path,
            "trace": trace_path}


def run_smoke(out_dir: str, n: int = 512, batch: int = 8, device=None) -> int:
    import numpy as np
    import torch

    from .. import obs
    from ..linalg.chol import posv_array
    from ..obs import report
    from ..obs.flight import default_mesh
    from ..types import Option
    from . import metrics as serve_metrics
    from .batch import pack_block_diag, posv_batched, unpack_block_diag
    from .cache import executable_cache, make_key
    from .table import load_tuned_table, resolve_request_options

    mesh = default_mesh(device)
    dev = mesh.device
    obs.reset()
    obs.enable()
    serve_metrics.reset()
    executable_cache.clear()
    failures = []

    # (a) batched throughput and bitwise rows
    thr = measure_throughput(mesh, n=n, batch=batch)
    print(f"serve.smoke: loop {thr['loop_solves_per_s']:.2f} solves/s, batched "
          f"{thr['batched_solves_per_s']:.2f} solves/s ({thr['speedup']:.1f}x, B={batch}, "
          f"n={n}, {dev})")
    if thr["speedup"] < 3.0:
        failures.append(f"batched speedup {thr['speedup']:.2f}x < 3x the one-at-a-time loop -- "
                        "the serving headline regressed")
    if not thr["bitwise"]:
        failures.append("batched solutions are not bitwise-equal to the single-problem verb")
    if not thr["info_ok"]:
        failures.append("batched factorization reported nonzero info")

    # (b) steady state: more traffic, no rebuild
    before = executable_cache.snapshot_traces()
    rng = np.random.default_rng(1)
    for _ in range(5):
        spd = _spd_stack(rng, batch, n, dev)
        bb = torch.from_numpy(rng.standard_normal((batch, n, 1))).to(dev)
        key = make_key("posv_batched", (spd, bb), batch=batch, mesh=None)
        executable_cache.get_or_build(key, lambda: posv_batched)(spd, bb)
    _fence(dev)
    try:
        executable_cache.assert_steady(before)
    except AssertionError as e:
        failures.append(str(e))

    # (c) ragged packing: each unpacked solution bitwise the problem packed
    # alone (co-packed blocks add only exact zeros), and the unpadded solve
    # to 1e-10
    sizes, m = [48, 33, 64], 64
    k = len(sizes)
    ops_, rhs_ = [], []
    for sz in sizes:
        g = rng.standard_normal((sz, sz))
        ops_.append(torch.from_numpy(g @ g.T / sz + 2 * np.eye(sz)).to(dev))
        rhs_.append(torch.from_numpy(rng.standard_normal((sz, 2))).to(dev))
    a_pack, b_pack = pack_block_diag(ops_, m, rhs_)
    x_pack, _f, info = posv_array(a_pack, b_pack)
    got = unpack_block_diag(x_pack, sizes, m, [2] * k)
    pack_ok = int(info) == 0
    eye = torch.eye(m, dtype=a_pack.dtype, device=dev)
    zero = torch.zeros((m, 2), dtype=a_pack.dtype, device=dev)
    for i in range(k):
        solo_a, solo_b = pack_block_diag([ops_[j] if j == i else eye for j in range(k)], m,
                                         [rhs_[j] if j == i else zero for j in range(k)])
        ref = unpack_block_diag(posv_array(solo_a, solo_b)[0], sizes, m, [2] * k)[i]
        lone = posv_array(ops_[i], rhs_[i])[0]
        if not torch.equal(got[i], ref) or not torch.allclose(got[i], lone, rtol=1e-10,
                                                              atol=1e-10):
            pack_ok = False
    if not pack_ok:
        failures.append("block-diagonal pack -> solve -> unpack lost per-problem exactness "
                        "(blocks interacted)")

    # (d) tuned table: the committed artifact and its resolution
    table = load_tuned_table()
    tuned_entries = len(table["entries"]) if table else 0
    if table is None:
        failures.append("committed tuned table missing or invalid (artifacts/serve/tuned.json)")
    else:
        merged = resolve_request_options(None, "potrf", 96, "float64", (2, 4))
        if Option.Lookahead not in merged:
            failures.append("tuned table did not resolve an unset Lookahead")
        if os.environ.get("SLATE_TPU_BCAST_IMPL") and merged.get(Option.BcastImpl) is not None:
            failures.append("tuned tier overrode the environment BcastImpl pin -- precedence "
                            "chain broken")
        explicit = resolve_request_options({Option.Lookahead: 0}, "potrf", 96, "float64",
                                           (2, 4))
        if explicit.get(Option.Lookahead) != 0:
            failures.append("explicit option lost to the tuned table")

    # (e) request-level SLA
    os.makedirs(out_dir, exist_ok=True)
    sla = run_sla_phase(out_dir, failures, dev)

    rep_path = os.path.join(out_dir, "serve.report.json")
    values = {
        "serve.posv_runtime_loop_solves_per_s": thr["loop_solves_per_s"],
        "serve.posv_runtime_batched_solves_per_s": thr["batched_solves_per_s"],
        "serve.posv_runtime_speedup": thr["speedup"],
        "serve.cache_programs": float(len(executable_cache)),
        "serve.batched_bitwise_ok": float(thr["bitwise"]),
        "serve.pack_roundtrip_ok": float(pack_ok),
        "serve.tuned_entries": float(tuned_entries),
    }
    report.write_report(rep_path, name="serve_smoke",
                        config={"n": n, "batch": batch, "grid": "2x4", "driver": "posv_batched",
                                "device": str(dev)},
                        values=values)
    with open(rep_path) as f:
        rep = json.load(f)
    errs = report.validate_report(rep)
    if errs:
        failures.append(f"RunReport schema: {errs}")
    serve_sec = rep.get("serve") or {}
    if serve_sec.get("traces", 0) <= 0:
        failures.append("serve counter section missing trace counts -- obs.report is not "
                        "folding serve.* in")
    if serve_sec.get("cache_misses", 0) > serve_sec.get("traces", 0):
        failures.append("cache misses exceed traces -- a built program never counted?")
    obs.disable()

    if failures:
        print(f"serve.smoke: FAILED with {len(failures)} problem(s):")
        for msg in failures:
            print(f"  FAIL {msg}")
        return 1
    print(f"serve.smoke: OK -- {thr['speedup']:.1f}x batched speedup, "
          f"{int(serve_sec['traces'])} build(s) over {len(executable_cache)} program(s), "
          f"0 rebuilds, {sla['requests']} SLA request(s) fully attributed, report {rep_path} + "
          f"{sla['report']}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m slate_tpu_torch.serve.smoke")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run_smoke(args.out, args.n, args.batch, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
