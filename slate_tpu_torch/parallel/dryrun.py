"""The port's mesh dryrun: ``slate_tpu``'s ``posv_chain`` phase on a virtual
2 x 4 mesh.

    python -m slate_tpu_torch.parallel.dryrun [--device cpu|cuda]

Counterpart of the ``posv_chain`` phase of ``__graft_entry__.py``'s
``dryrun_multichip``: the same seeded f32 SPD system (n = 64, 16 right-hand
sides, nb = 8) is distributed, factored (``potrf_dist``), solved with two
``trsm_dist`` calls and multiplied back with ``gemm_summa``; the normwise
backward error must stay under 100 n eps32.  Prints one JSON line with the
phase's result (``{"n_devices": 8, "phases": {"posv_chain": {...}}, "ok":
...}``) and exits non-zero if the phase failed.  The other dryrun phases
come with their slices.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..types import Diag, Op, Uplo
from .dist import from_dense, to_dense
from .dist_chol import potrf_dist
from .dist_trsm import trsm_dist
from .mesh import make_mesh
from .summa import gemm_summa

N, NRHS, NB = 64, 16, 8


def posv_chain_operands(n: int = N, nrhs: int = NRHS):
    """The dryrun's operands, made exactly as ``__graft_entry__.py`` makes
    them (numpy, seed 0): A = G G^T + n I and B, f32."""
    rng = np.random.default_rng(0)
    g = rng.standard_normal((n, n)).astype(np.float32)
    a = g @ g.T + n * np.eye(n, dtype=np.float32)
    b = rng.standard_normal((n, nrhs)).astype(np.float32)
    return a, b


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


def dryrun(device: str = "cuda") -> dict:
    mesh = make_mesh(2, 4, device=device)
    a, b = posv_chain_operands()
    result = {"n_devices": 8, "device": device, "phases": {}, "ok": True}
    t0 = time.time()
    try:
        a_t, b_t = torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)
        _, info, eta = posv_chain(a_t, b_t, mesh)
        gate = 100 * N * float(np.finfo(np.float32).eps)
        if int(info) != 0:
            raise RuntimeError(f"potrf_dist info={int(info)}")
        if not eta < gate:
            raise RuntimeError(f"distributed solve backward error {eta}")
        result["phases"]["posv_chain"] = {"eta": eta, "seconds": round(time.time() - t0, 3)}
    except Exception as e:  # noqa: BLE001 -- recorded in the phase line, exit code 1
        result["ok"] = False
        result["phases"]["posv_chain"] = {"error": f"{type(e).__name__}: {e}",
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
