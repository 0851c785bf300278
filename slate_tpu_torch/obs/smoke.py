"""Obs smoke: a small instrumented distributed Cholesky on the virtual
2 x 4 mesh, emitting and validating one RunReport and one Perfetto trace.

Counterpart of ``slate_tpu/obs/smoke.py``.  It proves that a
``potrf_dist`` run produces (a) a schema-valid RunReport with wall, cold
and execute seconds and comm bytes, (b) a Perfetto trace with nested
driver and phase spans (``smoke`` > ``dist_chol`` > ``dist_chol:cold`` /
``dist_chol:execute`` > ``potrf_dist``), and (c) that ``obs.report
--check`` passes an unchanged report and flags a 2x regression.  The port
has no compile step, so ``measure``'s first phase is ``cold`` (where
``slate_tpu``'s is ``compile``) and the report carries no flop estimate.

    python -m slate_tpu_torch.obs.smoke [--out artifacts/obs_torch] [--n 96] [--nb 8]
        [--device cpu|cuda]

Runs on the card unless asked for the host; without a card and no
``--device cpu`` it raises.  Prints one line and exits 0, or lists the
failures and exits 1.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import io
import json
import os
import sys
import tempfile
from typing import Optional


def run_smoke(out_dir: Optional[str] = None, n: int = 96, nb: int = 8,
              device: Optional[str] = None) -> dict:
    """The smoke; returns {"ok", "failures", "report", "trace", "spans",
    "comm_bytes"}.  ``out_dir`` None writes into a temporary directory."""
    import numpy as np
    import torch

    from ..parallel import from_dense, potrf_dist
    from . import perfetto, report
    from .flight import default_mesh
    from .metrics import REGISTRY
    from .span import driver_span, enable, enabled, measure, reset

    mesh = default_mesh(device)
    was = enabled()
    reset()
    enable()
    tmp = None
    if out_dir is None:
        tmp = tempfile.TemporaryDirectory()
        out_dir = tmp.name
    try:
        rng = np.random.default_rng(0)
        g = rng.standard_normal((n, n))
        spd = torch.from_numpy((g @ g.T / n + 2 * np.eye(n)).astype(np.float32))
        ad = from_dense(spd, mesh, nb, diag_pad_one=True)

        with driver_span("smoke", n=n, nb=nb, grid="2x4"):
            (_, info), m = measure("dist_chol", lambda d: potrf_dist(d), ad,
                                   tags={"n": n, "nb": nb})
        failures = []
        if int(info) != 0:
            failures.append(f"potrf_dist reported info={int(info)}")
        REGISTRY.gauge_set("potrf_gflops", n**3 / 3 / max(m["execute_seconds"], 1e-12) / 1e9)

        os.makedirs(out_dir, exist_ok=True)
        rep_path = os.path.join(out_dir, "smoke_report.json")
        trace_path = os.path.join(out_dir, "smoke_trace.json")
        values = {k: m.get(k, 0.0) for k in ("wall_seconds", "compile_seconds",
                                             "execute_seconds", "comm_bytes")}
        report.write_report(rep_path, name="obs_smoke",
                            config={"n": n, "nb": nb, "grid": "2x4", "driver": "potrf_dist",
                                    "device": str(mesh.device)},
                            values=values)
        perfetto.write_chrome_trace(trace_path)

        # (a) the RunReport: valid, with the acceptance metrics
        with open(rep_path) as f:
            rep = json.load(f)
        errs = report.validate_report(rep)
        if errs:
            failures.append(f"RunReport schema: {errs}")
        for key in ("wall_seconds", "compile_seconds", "comm_bytes"):
            if key not in rep["values"]:
                failures.append(f"RunReport missing value {key}")
        if rep["values"].get("comm_bytes", 0) <= 0:
            failures.append("RunReport comm_bytes not positive: the audit absorption broke")
        if "flops" in rep["values"] and rep["values"]["flops"] <= 0:
            failures.append("RunReport flop estimate not positive")

        # (b) the trace: loadable, with nested driver and phase spans
        with open(trace_path) as f:
            tr = json.load(f)
        errs = perfetto.validate_chrome_trace(tr)
        if errs:
            failures.append(f"trace schema: {errs[:4]}")
        names = {e["name"] for e in tr["traceEvents"]}
        for want in ("smoke", "dist_chol", "dist_chol:cold", "potrf_dist"):
            if want not in names:
                failures.append(f"trace missing span {want!r}")
        parents = {e["args"].get("parent") for e in tr["traceEvents"] if e["ph"] == "X"}
        if "dist_chol" not in parents:
            failures.append("trace spans carry no nesting (no parent=dist_chol)")

        # (c) report --check: unchanged passes, a 2x regression fails
        regressed = copy.deepcopy(rep)
        for k in regressed["values"]:
            if report.lower_is_better(k):
                regressed["values"][k] *= 2.0
            else:
                regressed["values"][k] /= 2.0
        bad_path = os.path.join(out_dir, "smoke_report_regressed.json")
        with open(bad_path, "w") as f:
            json.dump(regressed, f)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc_same = report.main(["--check", rep_path, rep_path])
            rc_bad = report.main(["--check", bad_path, rep_path])
        if rc_same != 0:
            failures.append(f"--check of an unchanged report exited {rc_same} (want 0)")
        if rc_bad != 1:
            failures.append(f"--check of a 2x-regressed report exited {rc_bad} (want 1)")
        if failures:
            failures.append(buf.getvalue())
        return {"ok": not failures, "failures": failures,
                "report": rep_path if tmp is None else None,
                "trace": trace_path if tmp is None else None,
                "spans": len(rep["spans"]), "comm_bytes": rep["values"]["comm_bytes"],
                "trace_events": len(tr["traceEvents"]), "check_rc": [rc_same, rc_bad]}
    finally:
        if not was:
            from .span import disable

            disable()
        if tmp is not None:
            tmp.cleanup()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m slate_tpu_torch.obs.smoke")
    ap.add_argument("--out", default=os.path.join("artifacts", "obs_torch"))
    ap.add_argument("--n", type=int, default=96)
    ap.add_argument("--nb", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="the mesh's device (default: the card)")
    args = ap.parse_args(argv)
    res = run_smoke(args.out, args.n, args.nb, args.device)
    if not res["ok"]:
        print(f"obs.smoke: FAILED with {len(res['failures'])} problem(s):")
        for msg in res["failures"]:
            print(f"  FAIL {msg}")
        return 1
    print(f"obs.smoke: OK — report {res['report']} ({res['spans']} spans, "
          f"{res['comm_bytes']:,.0f} comm B/dev audited), trace {res['trace']} "
          f"({res['trace_events']} events)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
