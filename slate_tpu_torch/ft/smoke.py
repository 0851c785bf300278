"""FT smoke: the acceptance run of the port's ABFT layer.

Counterpart of ``slate_tpu/ft/smoke.py`` on the virtual 2 x 4 mesh:
injects one deterministic single-tile fault per op class and asserts the
detect -> locate -> correct path, with ``slate_tpu``'s seeds and operands
(f64, ``utils.testing.generate``):

1. gemm: a trailing-accumulator fault -> exact correction;
2. potrf: a finalized-panel store fault -> exact algebraic repair;
3. LU-nopiv: a finalized-panel store fault -> exact algebraic repair;
4. recompute: live-data (trailing) corruption of potrf -> one recompute;
5. a persistent double fault in LU-nopiv -> ``FtError``;
6. trsm: a corrupted already-solved X tile -> exact correction;
7. her2k: a trailing-accumulator fault -> exact correction from the
   dual-sided carried checksums (the GEMM repair class);

then the ``ft.*`` counters (detected >= 7, corrected >= 5, recomputed >= 1,
uncorrectable >= 1, ``slate_tpu``'s floors).  Prints one JSON line (the
scenarios and the counters; RunReports come with the observability slice)
and exits non-zero if any scenario failed.

Usage::

    python -m slate_tpu_torch.ft.smoke [--device cpu|cuda] [--n 64] [--nb 8]
"""

from __future__ import annotations

import argparse
import json
import sys


def run_smoke(device: str = "cuda", n: int = 64, nb: int = 8) -> dict:
    """Run the seven scenarios; returns {"ok", "scenarios", "counters"}."""
    import numpy as np
    import torch

    from ..obs import reset
    from ..parallel import make_mesh, to_dense
    from ..utils.testing import generate
    from . import abft, inject
    from .policy import FtError, FtPolicy, ft_counter_values

    reset()
    mesh = make_mesh(2, 4, device=device)
    grid = (2, 4)
    nt = -(-n // nb)

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    a_np, b_np = generate("randn", n, seed=0), generate("randn", n, seed=1)
    spd_np = n * generate("spd", n, seed=2)
    dd_np = generate("dominant", n, seed=3)
    a, b, spd, dd = dev(a_np), dev(b_np), dev(spd_np), dev(dd_np)
    scenarios = {}

    def record(name, ok, **detail):
        scenarios[name] = {"ok": bool(ok), **detail}

    def rel(x, ref):
        return float(np.abs(x - ref).max() / np.abs(ref).max())

    # (1) gemm: single trailing-accumulator fault -> exact correction
    f = inject.seeded_fault(11, "gemm", nt, grid, phase="trailing")
    with inject.fault_scope(inject.FaultPlan([f])):
        c, rep = abft.gemm_ft(1.0, a, b, mesh, nb, policy=FtPolicy.Correct)
    err = rel(c.cpu().numpy(), a_np @ b_np)
    record("gemm", rep.action == "corrected" and err < 1e-12, action=rep.action, err=err)

    # (2) potrf: finalized-panel store fault -> exact algebraic repair
    f = inject.seeded_fault(12, "potrf", nt, grid, phase="panel")
    with inject.fault_scope(inject.FaultPlan([f])):
        l, info, rep = abft.potrf_ft(spd, mesh, nb, policy=FtPolicy.Correct)
    ld = np.tril(to_dense(l).cpu().numpy())
    resid = rel(ld @ ld.T, spd_np)
    record("potrf", rep.action == "corrected" and int(info) == 0 and resid < 1e-12,
           action=rep.action, info=int(info), resid=resid)

    # (3) LU-nopiv: finalized-panel store fault -> exact algebraic repair
    f = inject.seeded_fault(13, "getrf_nopiv", nt, grid, phase="panel")
    with inject.fault_scope(inject.FaultPlan([f])):
        lu, info, rep = abft.getrf_nopiv_ft(dd, mesh, nb, policy=FtPolicy.Correct)
    lud = to_dense(lu).cpu().numpy()
    resid = rel((np.tril(lud, -1) + np.eye(n)) @ np.triu(lud), dd_np)
    record("getrf_nopiv", rep.action == "corrected" and int(info) == 0 and resid < 1e-10,
           action=rep.action, info=int(info), resid=resid)

    # (4) live-data corruption -> the recompute escalation still lands clean
    f = inject.seeded_fault(14, "potrf", nt, grid, phase="trailing")
    with inject.fault_scope(inject.FaultPlan([f])):
        l, info, rep = abft.potrf_ft(spd, mesh, nb, policy=FtPolicy.Correct)
    ld = np.tril(to_dense(l).cpu().numpy())
    resid = rel(ld @ ld.T, spd_np)
    record("recompute", rep.action == "recomputed" and resid < 1e-12,
           action=rep.action, resid=resid)

    # (5) persistent double fault -> structured FtError.  Mild scale faults
    # keep the elimination finite (info == 0), so the CHECKSUM path must
    # catch them
    faults = [
        inject.Fault("getrf_nopiv", k=1, phase="trailing", ti=4, tj=5, r=4 % 2, c=5 % 4,
                     mode=inject.MODE_SCALE, value=3.0, persist=True),
        inject.Fault("getrf_nopiv", k=2, phase="trailing", ti=6, tj=4, r=6 % 2, c=4 % 4,
                     mode=inject.MODE_SCALE, value=3.0, persist=True),
    ]
    try:
        with inject.fault_scope(inject.FaultPlan(faults)):
            abft.getrf_nopiv_ft(dd, mesh, nb, policy=FtPolicy.Correct)
        record("double_fault", False, reason="no FtError raised")
    except FtError as e:
        record("double_fault", bool(e.detections), reason=e.reason,
               detections=len(e.detections))

    # (6) trsm: the solution-checksum carrier — a corrupted already-solved X
    # tile is final data, exactly repaired from its checksum columns
    tl_np = np.tril(a_np) + n * np.eye(n)
    brhs_np = generate("randn", n, seed=4)[:, : 2 * nb]
    f = inject.Fault("trsm", k=nt - 1, phase="trailing", ti=1, tj=0, r=1 % 2, c=0 % 4,
                     mode=inject.MODE_SCALE, value=3.0)
    with inject.fault_scope(inject.FaultPlan([f])):
        x, rep = abft.trsm_ft(dev(tl_np), dev(brhs_np), mesh, nb, policy=FtPolicy.Correct)
    terr = rel(x.cpu().numpy(), np.linalg.solve(tl_np, brhs_np))
    record("trsm", rep.action == "corrected" and terr < 1e-10, action=rep.action, err=terr)

    # (7) her2k: an injected accumulator fault is final data, exactly
    # repaired from the dual-sided carried checksums (the GEMM repair class)
    f = inject.Fault("her2k", k=nt - 1, phase="trailing", ti=3, tj=1, r=3 % 2, c=1 % 4,
                     mode=inject.MODE_SCALE, value=3.0)
    with inject.fault_scope(inject.FaultPlan([f])):
        c2k, rep = abft.her2k_ft(1.0, a, b, mesh, nb, policy=FtPolicy.Correct)
    herr = rel(c2k.cpu().numpy(), a_np @ b_np.T + b_np @ a_np.T)
    record("her2k", rep.action == "corrected" and herr < 1e-12, action=rep.action, err=herr)

    ftv = ft_counter_values()
    counters = {k: ftv[k] for k in ("detected", "corrected", "recomputed", "uncorrectable")}
    record("counters", counters["detected"] >= 7 and counters["corrected"] >= 5
           and counters["recomputed"] >= 1 and counters["uncorrectable"] >= 1)
    return {"ok": all(s["ok"] for s in scenarios.values()), "device": device, "n": n, "nb": nb,
            "grid": "2x4", "scenarios": scenarios, "counters": counters}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m slate_tpu_torch.ft.smoke")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--nb", type=int, default=8)
    args = ap.parse_args(argv)
    res = run_smoke(args.device, args.n, args.nb)
    print(json.dumps(res), flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
