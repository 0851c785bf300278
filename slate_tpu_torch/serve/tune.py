"""Autotuner: sweep schedule knobs per cache key, persist the winners.

Counterpart of ``slate_tpu/serve/tune.py``.  ``python -m
slate_tpu_torch.serve.tune`` flies the flight recorder (``obs.flight``) over
every (BcastImpl, Lookahead depth, nb) combination of the swept ops and
picks each key's winner by the measured schedule metrics:
``sched.critical_path_s`` first, ``sched.exposed_comm_s`` as the tie-break.
For gemm the stationary variant (GemmA against GemmC) is timed at a
thin-output serving shape.

On one card the mesh is virtual: a flight's ``bcast`` rows time indexing,
fences and the host's enqueue, not a link, so a tuned winner here says
which schedule runs fastest on this card's virtual mesh and nothing about
a network.  The table is written to ``artifacts/serve/tuned_torch.json`` by
default (``serve.table`` schema); the committed ``artifacts/serve/tuned.json``
is never overwritten.

Usage::

    python -m slate_tpu_torch.serve.tune [--out artifacts/serve/tuned_torch.json]
        [--ops summa,potrf,getrf_nopiv] [--n 96] [--quick] [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

from .table import DEFAULT_TABLE_PATH, TORCH_TABLE_PATH, entry_key, write_table

SWEEP_IMPLS = ("doubling", "ring", "psum")
SWEEP_DEPTHS = {"summa": (0, 1, 2), "potrf": (0, 1), "getrf_nopiv": (0, 1)}
SWEEP_NB = (8, 16)


def _objective(values: Dict[str, float]) -> Tuple[float, float]:
    return (values["sched.critical_path_s"], values["sched.exposed_comm_s"])


def sweep_op(op: str, n: int, mesh, nbs=SWEEP_NB, impls=SWEEP_IMPLS,
             depths: Optional[Tuple[int, ...]] = None, log=print) -> Tuple[Dict, List[Dict]]:
    """All (nb, impl, depth) flights of one op; returns (winner entry, the
    sweep's rows)."""
    from ..obs.flight import run_flight

    depths = depths if depths is not None else SWEEP_DEPTHS[op]
    swept: List[Dict] = []
    best = None
    for nb in nbs:
        for impl in impls:
            for depth in depths:
                t0 = time.time()
                rep = run_flight(op, n=n, nb=nb, depth=depth, bcast_impl=impl, mesh=mesh)
                v = rep["values"]
                row = {
                    "nb": nb, "bcast_impl": impl, "lookahead": depth,
                    "critical_path_s": v["sched.critical_path_s"],
                    "overlap_eff": v["sched.overlap_eff"],
                    "exposed_comm_s": v["sched.exposed_comm_s"],
                    "resid": v["resid"],
                    "sweep_s": round(time.time() - t0, 2),
                }
                swept.append(row)
                log(f"  {op} nb={nb} impl={impl:>8} depth={depth}: "
                    f"crit={row['critical_path_s'] * 1e3:8.2f} ms "
                    f"overlap={row['overlap_eff']:.3f} "
                    f"exposed={row['exposed_comm_s'] * 1e3:8.2f} ms")
                if best is None or _objective(v) < _objective(
                        {"sched.critical_path_s": best["critical_path_s"],
                         "sched.exposed_comm_s": best["exposed_comm_s"]}):
                    best = row
    entry = {
        "bcast_impl": best["bcast_impl"],
        "lookahead": int(best["lookahead"]),
        "nb": int(best["nb"]),
        "objective": {
            "critical_path_s": best["critical_path_s"],
            "overlap_eff": best["overlap_eff"],
            "exposed_comm_s": best["exposed_comm_s"],
        },
    }
    return entry, swept


def time_gemm_method(n: int, nb: int, mesh, reps: int = 3) -> Dict[str, float]:
    """Stationary-variant timing at the thin-output serving shape (n x n
    times n x 2 nb): GemmA against GemmC, by warm host-clock seconds with
    the card fenced (the flight recorder cannot arbitrate it: GemmA has no
    k-loop to record)."""
    import numpy as np
    import torch

    from ..parallel.dist import from_dense
    from ..parallel.summa import gemm_summa
    from ..types import MethodGemm

    def fence():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    rng = np.random.default_rng(0)
    ad = from_dense(torch.from_numpy(rng.standard_normal((n, n))), mesh, nb)
    bd = from_dense(torch.from_numpy(rng.standard_normal((n, 2 * nb))), mesh, nb)
    out = {}
    for method in (MethodGemm.GemmA, MethodGemm.GemmC):
        gemm_summa(1.0, ad, bd, method=method)  # warm
        fence()
        t0 = time.perf_counter()
        for _ in range(reps):
            gemm_summa(1.0, ad, bd, method=method)
        fence()
        out[method.value] = (time.perf_counter() - t0) / reps
    return out


def run_tune(out: str, ops: List[str], n: int, quick: bool = False, log=print,
             device: Optional[str] = None) -> int:
    from ..obs.flight import default_mesh
    from ..parallel.mesh import mesh_shape

    if os.path.abspath(out) == os.path.abspath(DEFAULT_TABLE_PATH):
        log(f"serve.tune: refusing to overwrite the committed table {out}")
        return 2
    mesh = default_mesh(device)
    grid = mesh_shape(mesh)
    nbs = (SWEEP_NB[0],) if quick else SWEEP_NB
    entries: Dict[str, Dict] = {}
    for op in ops:
        log(f"serve.tune: sweeping {op} (n={n}, grid={grid[0]}x{grid[1]}, {mesh.device})")
        entry, _swept = sweep_op(op, n, mesh, nbs=nbs, log=log)
        if op == "summa":
            times = time_gemm_method(n, entry["nb"], mesh)
            entry["method"] = min(times, key=times.get)
            entry["method_runtime_s"] = {k: round(v, 6) for k, v in times.items()}
            key_op = "gemm"
        else:
            key_op = {"potrf": "potrf", "getrf_nopiv": "gesv"}.get(op, op)
        entries[entry_key(key_op, n, "float64", grid)] = entry
        # factor winners serve the solve verbs built on them too
        if op == "potrf":
            entries[entry_key("posv", n, "float64", grid)] = dict(entry)
    path = write_table(out, entries, config={
        "n": n, "grid": f"{grid[0]}x{grid[1]}", "ops": ops, "device": str(mesh.device),
        "impls": list(SWEEP_IMPLS), "nbs": list(nbs), "quick": quick,
        "objective": "min sched.critical_path_s, tie-break sched.exposed_comm_s (obs.flight "
                     "measured; on one card the virtual mesh's bcast rows are indexing)",
    })
    log(f"serve.tune: wrote {len(entries)} entries to {path}")
    for key, entry in sorted(entries.items()):
        log(f"  {key}: impl={entry['bcast_impl']} depth={entry['lookahead']} nb={entry['nb']}"
            + (f" method={entry['method']}" if "method" in entry else ""))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m slate_tpu_torch.serve.tune",
                                 description=__doc__)
    ap.add_argument("--out", default=TORCH_TABLE_PATH)
    ap.add_argument("--ops", default="summa,potrf,getrf_nopiv",
                    help="comma-separated flight ops to sweep")
    ap.add_argument("--n", type=int, default=96)
    ap.add_argument("--quick", action="store_true", help="single nb, for fast re-tunes")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run_tune(args.out, [o for o in args.ops.split(",") if o], args.n, args.quick,
                    device=args.device)


if __name__ == "__main__":
    sys.exit(main())
