"""The port's mesh dryrun: four of ``slate_tpu``'s dryrun phases on a
virtual 2 x 4 mesh.

    python -m slate_tpu_torch.parallel.dryrun [--device cpu|cuda]

Counterpart of ``__graft_entry__.py``'s ``dryrun_multichip``, in its order
and with its seeded operands (n = 64, nb = 8, 16 right-hand sides):

- ``posv_chain``: the f32 SPD system distributed, factored
  (``potrf_dist``), solved with two ``trsm_dist`` calls and multiplied back
  with ``gemm_summa``; the normwise backward error under 100 n eps32;
- ``gesv_pp``: ``gesv_mesh`` (partial pivoting), the same gate;
- ``hemm_summa``: ``hemm_summa(Side.Left, 1.0, H, B)`` with H = (G + G^T)/2
  in f32, its relative error against H B under 1e-4;
- ``panel_pallas``: the LU half, ``getrf_nopiv_dist`` under PanelImpl
  pallas, its reconstruction residual under 100 n eps32.

Prints one JSON line (``{"n_devices": 8, "phases": {...}, "ok": ...}``) and
exits non-zero if a phase failed.  The other phases (``stedc_dist``,
``heev_chain``, ``flight_timeline``, ``mem``) come with their slices.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..types import Diag, Op, Side, Uplo
from .dist import from_dense, to_dense
from .dist_blas3 import hemm_summa
from .dist_chol import potrf_dist
from .dist_lu import getrf_nopiv_dist
from .dist_trsm import trsm_dist
from .drivers import gesv_mesh
from .mesh import make_mesh
from .summa import gemm_summa

N, NRHS, NB = 64, 16, 8


def posv_chain_operands(n: int = N, nrhs: int = NRHS):
    """The posv_chain operands, made exactly as ``__graft_entry__.py`` makes
    them (numpy, seed 0): A = G G^T + n I and B, f32."""
    ops = dryrun_operands(n, nrhs)
    return ops["a"], ops["b"]


def dryrun_operands(n: int = N, nrhs: int = NRHS):
    """Every operand of the ported phases, drawn from one numpy generator
    (seed 0) in ``__graft_entry__.py``'s order: G, B (posv_chain), the
    gesv_pp matrix, the two stedc_dist vectors (drawn and dropped here),
    then the strict upper part of the panel_pallas LU matrix; and the
    hemm_summa phase's H = (G + G^T) / 2."""
    rng = np.random.default_rng(0)
    g = rng.standard_normal((n, n)).astype(np.float32)
    a = g @ g.T + n * np.eye(n, dtype=np.float32)
    b = rng.standard_normal((n, nrhs)).astype(np.float32)
    am = rng.standard_normal((n, n)).astype(np.float32)
    rng.standard_normal(96)  # stedc_dist's d and e
    rng.standard_normal(95)
    lum = (np.tril(g) + n * np.eye(n) + np.triu(rng.standard_normal((n, n)), 1)).astype(np.float32)
    hm = ((g + g.T) / 2).astype(np.float32)
    return {"a": a, "b": b, "am": am, "lum": lum, "hm": hm}


def posv_chain(a: torch.Tensor, b: torch.Tensor, mesh, nb: int = NB, **opts):
    """from_dense -> potrf_dist -> two trsm_dist -> gemm_summa residual.
    Returns (x dense, info, eta); ``opts`` (lookahead, bcast_impl, ...)
    reach every driver that takes them."""
    n = a.shape[0]
    ad = from_dense(a, mesh, nb, diag_pad_one=True)
    bd = from_dense(b, mesh, nb)
    solve_opts = {k: v for k, v in opts.items() if k in ("lookahead", "bcast_impl")}
    gemm_opts = {k: v for k, v in opts.items() if k in ("lookahead", "bcast_impl", "update_impl")}
    l, info = potrf_dist(ad, overwrite_a=True, **opts)
    y = trsm_dist(l, bd, Uplo.Lower, Op.NoTrans, Diag.NonUnit, **solve_opts)
    x = trsm_dist(l, y, Uplo.Lower, Op.ConjTrans, Diag.NonUnit, **solve_opts)
    ax = gemm_summa(1.0, from_dense(a, mesh, nb), x, **gemm_opts)
    xd = to_dense(x)
    eta = float((to_dense(ax) - b).abs().max()
                / (a.abs().max() * xd.abs().max() * n + b.abs().max()))
    return xd, info, eta


def gesv_pp(am: torch.Tensor, b: torch.Tensor, mesh, nb: int = NB):
    """gesv_mesh (partial pivoting) and its normwise backward error.
    Returns (x, info, eta)."""
    n = am.shape[0]
    x, info = gesv_mesh(am, b, mesh, nb)
    eta = float((am @ x - b).abs().max()
                / (am.abs().max() * x.abs().max() * n + b.abs().max()))
    return x, info, eta


def hemm_residual(hm: torch.Tensor, b: torch.Tensor, mesh, nb: int = NB) -> float:
    """hemm_summa(Side.Left, 1.0, H, B) against H @ B: max|HB - C| /
    max|HB|."""
    hc = to_dense(hemm_summa(Side.Left, 1.0, from_dense(hm, mesh, nb), from_dense(b, mesh, nb)))
    ref = hm @ b
    return float((hc - ref).abs().max() / (ref.abs().max() + 1e-30))


def lu_panel_residual(lum: torch.Tensor, mesh, nb: int = NB):
    """getrf_nopiv_dist under PanelImpl pallas and its reconstruction
    residual max|L U - A| / max|A|.  Returns (info, residual)."""
    lu, info = getrf_nopiv_dist(from_dense(lum, mesh, nb, diag_pad_one=True),
                                panel_impl="pallas", overwrite_a=True)
    lun = to_dense(lu)
    eye = torch.eye(lum.shape[0], dtype=lum.dtype, device=lum.device)
    rec = (lun.tril(-1) + eye) @ lun.triu()
    return info, float((rec - lum).abs().max() / lum.abs().max())


def dryrun(device: str = "cuda") -> dict:
    mesh = make_mesh(2, 4, device=device)
    ops = {k: torch.from_numpy(v).to(device) for k, v in dryrun_operands().items()}
    gate = 100 * N * float(np.finfo(np.float32).eps)
    result = {"n_devices": 8, "device": device, "phases": {}, "ok": True}

    def posv():
        _, info, eta = posv_chain(ops["a"], ops["b"], mesh)
        if int(info) != 0:
            raise RuntimeError(f"potrf_dist info={int(info)}")
        if not eta < gate:
            raise RuntimeError(f"distributed solve backward error {eta}")
        return {"eta": eta}

    def pp():
        _, info, eta = gesv_pp(ops["am"], ops["b"], mesh)
        if int(info) != 0 or not eta < gate:
            raise RuntimeError(f"gesv_mesh (partial pivot) info={int(info)} eta={eta}")
        return {"eta": eta}

    def hemm():
        r_h = hemm_residual(ops["hm"], ops["b"], mesh)
        if not r_h < 1e-4:
            raise RuntimeError(f"hemm_summa residual {r_h}")
        return {"resid": r_h}

    def panel():
        info, r_lu = lu_panel_residual(ops["lum"], mesh)
        if int(info) != 0 or not r_lu < gate:
            raise RuntimeError(f"getrf_nopiv_dist[pallas] info={int(info)} resid={r_lu}")
        return {"resid_lu": r_lu}

    for name, fn in (("posv_chain", posv), ("gesv_pp", pp), ("hemm_summa", hemm),
                     ("panel_pallas", panel)):
        t0 = time.time()
        try:
            result["phases"][name] = dict(fn(), seconds=round(time.time() - t0, 3))
        except Exception as e:  # noqa: BLE001 -- recorded in the phase line, exit code 1
            result["ok"] = False
            result["phases"][name] = {"error": f"{type(e).__name__}: {e}",
                                      "seconds": round(time.time() - t0, 3)}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    result = dryrun(args.device)
    print(json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
