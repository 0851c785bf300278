"""Collective-volume audit over the port's distributed drivers.

Counterpart of ``slate_tpu/obs/comm_audit.py``: runs the mesh drivers on a
virtual 2 x 4 mesh with the byte counters of ``parallel.comm`` active and
writes a markdown table: per-driver payload bytes, estimated received
bytes per device (ring-lowering formulas), collective call counts, and the
ratio to the 2D communication lower-bound scale n^2 itemsize / sqrt(P)
(Irony-Toledo-Tiskin).  On one card the verbs are indexing; the bytes are
what a real p x q mesh would move.  The byte totals also land in the
metrics registry (``comm_bytes`` counters tagged driver=...).

    python -m slate_tpu_torch.obs.comm_audit [--n 256] [--nb 16]
        [--out artifacts/comm_audit_torch.md] [--report R.json] [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import math
import os


def summarize(records, p, q):
    """(payload_bytes_total, received_bytes_total, n_calls, by_op) per
    device.

    Ring-lowering receive estimates per executed collective with local
    payload B over an axis of size s: psum (all-reduce) ~ 2 B (s-1)/s,
    psum_scatter (reduce-scatter) ~ B (s-1)/s, all_gather ~ B (s-1).

    ``ppermute`` records come from the broadcast engine's rooted
    ring/doubling hop schedules (parallel/comm.py) and already carry
    LINK bytes — operand bytes x source→target pairs of that hop — so
    the per-device receive estimate is nbytes / s.  A whole rooted
    broadcast of payload B therefore sums to B (s-1)/s per device —
    HALF the masked-psum path's 2 B (s-1)/s for the same panel, which
    is the Option.BcastImpl win tests/test_comm_audit.py asserts.
    """
    payload = recv = calls = 0
    by_op = {}
    for op, nbytes, mult in records:
        if "[p]" in op:
            s = p
        elif "[q]" in op:
            s = q
        else:  # tuple axis, e.g. psum[('p', 'q')] (chase_apply streaming)
            s = p * q
        if op.startswith("psum_scatter"):
            r = nbytes * (s - 1) / s
        elif op.startswith("psum"):
            r = 2 * nbytes * (s - 1) / s
        elif op.startswith("ppermute"):
            r = nbytes / s  # nbytes is link bytes for the hop; avg / device
        else:  # all_gather
            r = nbytes * (s - 1)
        payload += nbytes * mult
        recv += r * mult
        calls += mult
        agg = by_op.setdefault(op.split("[")[0], [0, 0])
        agg[0] += nbytes * mult
        agg[1] += mult
    return payload, recv, calls, by_op


def run_audit(n: int, nb: int, device: str = "cuda"):
    """Run every audited driver once; returns (rows, p, q) where each row
    is (name, payload, recv, calls, by_op, flops)."""
    import numpy as np
    import torch

    from ..parallel import (
        from_dense, gemm_summa, getrf_pp_dist, heev_mesh, potrf_dist, trsm_dist,
    )
    from ..parallel.comm import comm_audit
    from ..parallel.dist_blas3 import hemm_summa
    from ..parallel.dist_chol import pbtrf_band_dist
    from ..parallel.dist_lu import gbtrf_band_dist
    from ..types import MethodGemm, MethodHemm, MethodTrsm, Op, Side, Uplo
    from .flight import default_mesh
    from .metrics import REGISTRY

    mesh = default_mesh(device)
    p, q = 2, 4
    rng = np.random.default_rng(0)
    an = rng.standard_normal((n, n)).astype(np.float32)
    spdn = (an @ an.T / n + 2 * np.eye(n)).astype(np.float32)
    a, spd = torch.from_numpy(an), torch.from_numpy(spdn)

    rows = []

    def run(name, fn, flops):
        with comm_audit() as recs:
            fn()
        payload, recv, calls, by_op = summarize(recs, p, q)
        for op, (nbytes, _) in by_op.items():
            REGISTRY.counter_add("comm_bytes", nbytes, driver=name, op=op)
        rows.append((name, payload, recv, calls, by_op, flops))

    nrhs = max(nb, n // 16)  # thin RHS: the stationary-A regime
    b_thin = torch.from_numpy(rng.standard_normal((n, nrhs)).astype(np.float32))

    ad = from_dense(a, mesh, nb)
    bd = from_dense(a, mesh, nb)
    run("gemm_summa (C-stationary)",
        lambda: gemm_summa(1.0, ad, bd, method=MethodGemm.GemmC), 2 * n**3)
    btd = from_dense(b_thin, mesh, nb)
    run("gemm_summa (A-stationary, thin C)",
        lambda: gemm_summa(1.0, ad, btd, method=MethodGemm.GemmA), 2 * n**2 * nrhs)
    sd = from_dense(spd, mesh, nb, diag_pad_one=True)
    run("potrf_dist", lambda: potrf_dist(sd), n**3 / 3)
    gd = from_dense(a, mesh, nb, diag_pad_one=True)
    run("getrf_pp_dist", lambda: getrf_pp_dist(gd), 2 * n**3 / 3)
    tlow = torch.tril(a) + n * torch.eye(n)
    td = from_dense(tlow, mesh, nb, diag_pad_one=True)
    run("trsm_dist TrsmA (NoTrans, thin B)",
        lambda: trsm_dist(td, btd, Uplo.Lower, Op.NoTrans, method=MethodTrsm.TrsmA),
        n**2 * nrhs)
    run("trsm_dist TrsmA (Trans, thin B)",
        lambda: trsm_dist(td, btd, Uplo.Lower, Op.Trans, method=MethodTrsm.TrsmA),
        n**2 * nrhs)
    hd = from_dense(spd, mesh, nb)
    run("hemm_summa HemmA (thin B)",
        lambda: hemm_summa(Side.Left, 1.0, hd, btd, uplo=Uplo.Lower, conj=False,
                           method=MethodHemm.HemmA), 2 * n**2 * nrhs)
    # band kernels at band cost
    kd = 2 * nb
    iv = np.arange(n)
    bmask = torch.from_numpy(np.abs(np.subtract.outer(iv, iv)) <= kd)
    spd_band = torch.where(bmask, spd, 0) + kd * torch.eye(n)
    sbd = from_dense(spd_band, mesh, nb, diag_pad_one=True)
    run(f"pbtrf_band_dist (kd={kd})", lambda: pbtrf_band_dist(sbd, kd), n * kd * kd)
    gb = torch.where(bmask, a, 0) + kd * torch.eye(n)
    gbd = from_dense(gb, mesh, nb, diag_pad_one=True)
    run(f"gbtrf_band_dist (kl=ku={kd})", lambda: gbtrf_band_dist(gbd, kd, kd),
        2 * n * kd * 2 * kd)
    # the distributed eig chain: he2hb + band gather + sharded stedc + the
    # chase back-transform + the stage-1 back-transform
    heig = (a + a.T) / 2
    run("heev_mesh (vectors, full chain)", lambda: heev_mesh(heig.to(mesh.device), mesh, nb=nb),
        4 * n**3 / 3)
    return rows, p, q


def render(rows, p, q, n, nb) -> str:
    itemsize = 4  # f32
    lb = n * n * itemsize / math.sqrt(p * q)  # 2D lower-bound scale/device
    lines = [
        "# Collective-volume audit of the PyTorch port (virtual 2 x 4 mesh, per-call byte counters)",
        "",
        f"Config: n={n}, nb={nb}, grid {p}x{q}, f32.  Counters live in "
        "`slate_tpu_torch/parallel/comm.py` (`comm_audit`): every call of an "
        "audited verb records its per-device payload, as a real p x q mesh "
        "would move it.  Received-bytes estimates use ring "
        "lowerings: psum ~ 2B(s-1)/s, all_gather ~ B(s-1) per device; "
        "`ppermute` hop records (the Option.BcastImpl broadcast engine) "
        "carry link bytes directly, B_hop/s per device — a whole rooted "
        "broadcast is B(s-1)/s, half the masked-psum path.",
        "",
        f"2D lower-bound scale per device: n^2 * 4B / sqrt(P) = {lb:,.0f} B.",
        "",
        "| driver | payload B/dev | est. received B/dev | collective execs | recv / (n^2/sqrt(P)) | bytes/flop |",
        "|---|---|---|---|---|---|",
    ]
    for name, payload, recv, calls, by_op, flops in rows:
        lines.append(
            f"| {name} | {payload:,.0f} | {recv:,.0f} | {calls:,} | "
            f"{recv / lb:.2f} | {recv / flops:.4f} |"
        )
    lines += [
        "",
        "Per-op breakdown (payload bytes x executions):",
        "",
    ]
    for name, _, _, _, by_op, _ in rows:
        det = ", ".join(f"{op}: {v[0]:,}B / {v[1]:,}x" for op, v in sorted(by_op.items()))
        lines.append(f"- **{name}**: {det}")
    lines += [
        "",
        "Reading the table: under the broadcast engine's default lowering",
        "(Option.BcastImpl auto -> ppermute hops) SUMMA's received volume",
        "is ~1.4 n^2/sqrt(P) per device — the classic 2D algorithm's ~2x",
        "with its loop broadcasts HALVED; rerun with",
        "SLATE_TPU_BCAST_IMPL=psum to see the all-reduce volumes.",
        "The factorizations sit at the same n^2-class scale, so doubling n",
        "at 4x the devices holds received-bytes/device constant — the 2D",
        "weak-scaling invariant (BASELINE config #3).  The `collective",
        "execs` column is the latency story: getrf's per-column pivot",
        "all_gathers dominate call counts at O(n) tiny messages, the",
        "documented cost of partial pivoting (reference: per-column",
        "MPI exchanges in Tile_getrf.hh / internal_swap.cc).",
        "",
        "Stationary-A rows (trsmA / gemmA / hemmA, thin B): received",
        "volume is B/C-sized, far below the n^2-class stationary-C rows —",
        "A never moves, the stationary-A win (src/trsmA.cc, hemmA.cc).",
        "Band rows: volumes collapse to the O(n k)-class window traffic",
        "(tiles outside the band are never communicated).  The heev_mesh",
        "row audits the whole distributed eig chain — he2hb two-sided",
        "updates, band gather, sharded stedc merges, the streamed chase",
        "back-transform (psum over both axes), and unmtr_he2hb.",
    ]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(prog="python -m slate_tpu_torch.obs.comm_audit")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--nb", type=int, default=16)
    ap.add_argument("--out", default=os.path.join(repo, "artifacts", "comm_audit_torch.md"))
    ap.add_argument("--report", default=None,
                    help="also write a RunReport JSON with the byte counters")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="the mesh's device (default: the card)")
    args = ap.parse_args(argv)

    rows, p, q = run_audit(args.n, args.nb, args.device)
    text = render(rows, p, q, args.n, args.nb)
    out = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        f.write(text)
    print(text)
    print(f"wrote {out}")
    if args.report:
        from .report import write_report

        values = {}
        for name, payload, recv, calls, _, flops in rows:
            key = "".join(c if c.isalnum() else "_" for c in name).strip("_")
            values[f"{key}_payload_bytes"] = float(payload)
            values[f"{key}_recv_bytes"] = float(recv)
        write_report(args.report, name="comm_audit",
                     config={"n": args.n, "nb": args.nb, "grid": f"{p}x{q}"},
                     values=values)
        print(f"wrote {args.report}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
