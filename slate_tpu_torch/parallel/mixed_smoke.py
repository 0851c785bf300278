"""Mixed-precision smoke: the acceptance run of the mesh mixed solve.

Counterpart of ``slate_tpu/parallel/mixed_smoke.py``.  Solves one general
and one SPD f64 system on a virtual 2 x 4 mesh through the DEFAULT drivers
(``gesv_mesh`` / ``posv_mesh``, the Option.MixedPrecision=auto ladder of
``parallel/dist_refine.py``) and checks the acceptance surface end to end:

- ``off`` is the direct f64 path: the same launches and the same bits as
  ``_gesv_mesh_plain`` (``slate_tpu`` compares jaxprs);
- ``auto`` factors in f32, converges, and x meets the refinement gate
  ||r|| <= ||x|| ||A|| eps sqrt(n);
- the Ozaki int8 residual (``Option.ResidualImpl=ozaki``) meets the same
  gate;
- the GMRES-IR tier converges on its own tolerance;
- the ``ir.*`` counters move (the RunReport check comes with the
  observability slice).

It reads ``SLATE_TPU_BCAST_IMPL`` / ``SLATE_TPU_PANEL_IMPL`` like every mesh
kernel.  Usage::

    python -m slate_tpu_torch.parallel.mixed_smoke [--device cpu] [--n 96] [--nb 16]

On the card by default; prints one JSON line and exits 0 when every check
passes.
"""

from __future__ import annotations

import argparse
import json
import sys


def run_smoke(device: str = "cuda", n: int = 96, nb: int = 16) -> dict:
    """The checks above on ``device``; returns {"ok", "failures", "values",
    "ir"}."""
    import numpy as np
    import torch

    from ..linalg.refine import ir_counter_values
    from ..ops import kernels
    from ..types import Option
    from ..utils.testing import refine_gate_ok
    from .drivers import _gesv_mesh_plain, gesv_mesh, gesv_mixed_gmres_mesh, posv_mesh
    from .mesh import make_mesh

    mesh = make_mesh(2, 4, device=device)
    rng = np.random.default_rng(0)

    def t(x):
        return torch.as_tensor(x, device=device)

    a = t(rng.standard_normal((n, n)) + n * np.eye(n))
    g = rng.standard_normal((n, n))
    spd = t(g @ g.T / n + 2 * np.eye(n))
    b = t(rng.standard_normal((n, 2)))
    failures, vals = [], {}
    ir0 = ir_counter_values()

    def check(name, ok, detail=""):
        if not ok:
            failures.append(f"{name}: {detail}")

    def gate(a_, x_, b_):
        return float((b_ - a_ @ x_).abs().sum(dim=1).max()), refine_gate_ok(a_, x_, b_)

    def launches():
        return {k: getattr(kernels, k).launches for k in (
            "chol_panel_tiles", "chol_trailing_update", "summa_update", "lu_panel_tiles",
            "lu_rowsolve_tiles", "lu_trailing_update")}

    # (1) the off switch: the direct f64 path, launch for launch and bitwise
    off = {Option.MixedPrecision: "off"}
    l0 = launches()
    x_off, i_off = gesv_mesh(a, b, mesh, nb, opts=off)
    l1 = launches()
    x_pl, i_pl = _gesv_mesh_plain(a, b, mesh, nb, opts=off)
    l2 = launches()
    same_launches = {k: l1[k] - l0[k] for k in l0} == {k: l2[k] - l1[k] for k in l0}
    check("off-identity", same_launches and torch.equal(x_off, x_pl) and int(i_off) == int(i_pl),
          "MixedPrecision=off is not the direct path")

    # (2) the default ladder: f32 factor + refinement meets the gate
    x, info = gesv_mesh(a, b, mesh, nb)
    vals["gesv_mixed_resid"], ok = gate(a, x, b)
    check("gesv-auto", int(info) == 0 and ok, f"info={int(info)} rnorm={vals['gesv_mixed_resid']}")
    xp, infop = posv_mesh(spd, b, mesh, nb)
    vals["posv_mixed_resid"], okp = gate(spd, xp, b)
    check("posv-auto", int(infop) == 0 and okp,
          f"info={int(infop)} rnorm={vals['posv_mixed_resid']}")

    # (3) the Ozaki int8 residual meets the same gate
    xo, infoo = gesv_mesh(a, b, mesh, nb, opts={Option.ResidualImpl: "ozaki"})
    vals["gesv_ozaki_resid"], oko = gate(a, xo, b)
    check("gesv-ozaki", int(infoo) == 0 and oko,
          f"info={int(infoo)} rnorm={vals['gesv_ozaki_resid']}")

    # (4) the GMRES-IR tier converges on its own tolerance
    xg, rg, infog = gesv_mixed_gmres_mesh(a, b[:, :1], mesh, nb)
    tol = (np.finfo(np.float64).eps * np.sqrt(n)
           * float(torch.linalg.vector_norm(b[:, :1], dim=0).max()))
    vals["gesv_gmres_resid"] = float(rg)
    check("gesv-gmres", int(infog) == 0 and float(rg) <= tol and bool(torch.isfinite(xg).all()),
          f"info={int(infog)} rnorm={float(rg)} tol={tol}")

    # (5) the ir.* counters carry the solves
    ir1 = ir_counter_values()
    ir = {k: ir1[k] - ir0[k] for k in ir1}
    check("ir-counters", ir["solves"] >= 3 and ir["converged"] >= 3 and ir["gmres_solves"] >= 1,
          f"ir deltas {ir}")
    return {"ok": not failures, "failures": failures, "values": vals, "ir": ir, "device": device}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m slate_tpu_torch.parallel.mixed_smoke")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=96)
    ap.add_argument("--nb", type=int, default=16)
    args = ap.parse_args(argv)
    res = run_smoke(args.device, args.n, args.nb)
    print(json.dumps(res))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
