"""The port's mesh dryrun: seven of ``slate_tpu``'s eight dryrun phases on a
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
- ``stedc_dist``: the sharded divide and conquer on a random f32
  tridiagonal of n = 96, max|T Z - Z diag(w)| under 1e-3;
- ``heev_chain``: ``heev_mesh`` (he2hb_dist, the chase, stedc_dist, both
  back-transforms) on (G + G^T) / 2 in f32, max|A Z - Z diag(w)| /
  (max|A| n) and max|Z^T Z - I| each under 100 n eps32;
- ``panel_pallas``: the LU half, ``getrf_nopiv_dist`` under PanelImpl
  pallas, its reconstruction residual under 100 n eps32;
- ``flight_timeline``: ``obs.flight.run_flight("potrf", n=64, nb=8,
  depth=1)`` on the same mesh: its residual under 100 n eps32, the
  overlap efficiency exactly 0 at depth 0 and in (0, 1] at depth 1, and
  the critical path, exposed and total ``bcast`` seconds and the modeled
  bytes (on one card the ``bcast`` rows are indexing: their seconds are
  fence and host overhead, not wire time).

Prints one JSON line (``{"n_devices": 8, "phases": {...}, "ok": ...}``) and
exits non-zero if a phase failed.  The eighth phase (``mem``) comes with
the memory slice.
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
from .dist_stedc import stedc_dist
from .drivers import gesv_mesh, heev_mesh
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
    gesv_pp matrix, the two stedc_dist vectors, then the strict upper part
    of the panel_pallas LU matrix; and the hemm_summa phase's
    H = (G + G^T) / 2 and the heev_chain phase's (G + G^T) / 2, made as
    ``__graft_entry__.py`` makes each."""
    rng = np.random.default_rng(0)
    g = rng.standard_normal((n, n)).astype(np.float32)
    a = g @ g.T + n * np.eye(n, dtype=np.float32)
    b = rng.standard_normal((n, nrhs)).astype(np.float32)
    am = rng.standard_normal((n, n)).astype(np.float32)
    sd = rng.standard_normal(96).astype(np.float32)  # stedc_dist's d and e
    se = rng.standard_normal(95).astype(np.float32)
    lum = (np.tril(g) + n * np.eye(n) + np.triu(rng.standard_normal((n, n)), 1)).astype(np.float32)
    hm = ((g + g.T) / 2).astype(np.float32)
    he = (g + g.T).astype(np.float32) / 2
    return {"a": a, "b": b, "am": am, "lum": lum, "hm": hm, "sd": sd, "se": se, "he": he}


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


def stedc_residual(d: torch.Tensor, e: torch.Tensor, mesh) -> float:
    """``stedc_dist`` on the tridiagonal (d, e): max|T Z - Z diag(w)|."""
    w, z = stedc_dist(d, e, mesh)
    t = torch.diag(d) + torch.diag(e, 1) + torch.diag(e, -1)
    return float((t @ z - z * w).abs().max())


def heev_chain(he: torch.Tensor, mesh, nb: int = NB):
    """``heev_mesh`` on the Hermitian ``he``: (w, Z, residual
    max|A Z - Z diag(w)| / (max|A| n), orthogonality max|Z^H Z - I|)."""
    n = he.shape[0]
    w, z = heev_mesh(he, mesh, nb=nb)
    r_eig = float((he @ z - z * w).abs().max() / (he.abs().max() * n))
    eye = torch.eye(n, dtype=z.dtype, device=z.device)
    orth = float((z.conj().T @ z - eye).abs().max())
    return w, z, r_eig, orth


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

    def stedc():
        rs = stedc_residual(ops["sd"], ops["se"], mesh)
        if not rs < 1e-3:
            raise RuntimeError(f"stedc_dist residual {rs}")
        return {"resid": rs}

    def eig_chain():
        _, _, r_eig, orth = heev_chain(ops["he"], mesh)
        if not (r_eig < gate and orth < gate):
            raise RuntimeError(f"heev_mesh resid={r_eig} orth={orth}")
        return {"resid": r_eig, "orth": orth}

    def panel():
        info, r_lu = lu_panel_residual(ops["lum"], mesh)
        if int(info) != 0 or not r_lu < gate:
            raise RuntimeError(f"getrf_nopiv_dist[pallas] info={int(info)} resid={r_lu}")
        return {"resid_lu": r_lu}

    def flight_timeline():
        from ..obs import flight

        rep = flight.run_flight("potrf", n=N, nb=NB, depth=1, mesh=mesh)
        s = rep["sched"]
        if not rep["values"]["resid"] <= gate:
            raise RuntimeError(f"flight potrf resid {rep['values']['resid']}")
        if not (s["overlap_eff_la0"] == 0.0 and 0.0 < s["overlap_eff"] <= 1.0):
            raise RuntimeError(f"flight overlap_eff {s['overlap_eff']} (la0 "
                               f"{s['overlap_eff_la0']}): lookahead overlap not visible")
        return {"overlap_eff": s["overlap_eff"], "overlap_eff_la0": s["overlap_eff_la0"],
                "critical_path_s": s["critical_path_s"], "exposed_comm_s": s["exposed_comm_s"],
                "total_comm_s": s["total_comm_s"], "model_bytes": rep["model"]["total_bytes"]}

    for name, fn in (("posv_chain", posv), ("gesv_pp", pp), ("hemm_summa", hemm),
                     ("stedc_dist", stedc), ("heev_chain", eig_chain), ("panel_pallas", panel),
                     ("flight_timeline", flight_timeline)):
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
