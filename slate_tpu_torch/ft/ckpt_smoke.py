"""Checkpoint / restart smoke: the acceptance run of ``ft.ckpt`` and
``ft.elastic``.

Counterpart of ``slate_tpu/ft/ckpt_smoke.py`` on the virtual 2 x 4 mesh,
with ``slate_tpu``'s operands (f64, ``utils.testing.generate``) and seeds:

1. checkpointed-run identity: the segment chains give the plain drivers'
   results BITWISE for potrf, the no-pivot LU, the partial-pivot LU, the
   distributed CAQR (geqrf: multi-array carry) and the two-stage eig
   stage-1 reduction (he2hb: multi-array carry);
2. kill -> resume on the SAME mesh is bitwise the uninterrupted run
   (deterministic seeded preemption) for all five ops;
3. kill -> resume on a RESHAPED mesh (2 x 4 -> 4 x 2) gives the bitwise
   same factor through the ring redistribution for the tile-stack ops;
   the multi-array ops REFUSE the reshaped grid (their carries are
   grid-locked);
4. a snapshot survives a disk round trip (``Checkpoint.save`` / ``load``),
   multi-array forms included;
5. an IN-SEGMENT kill runs, then loses, exactly the steps since the last
   snapshot (``ft.ckpt_lost_steps``), and the ASYNC snapshot path is
   bitwise the sync one;
6. the ``ft.ckpt_*`` recovery-cost counters (snapshots, snapshot bytes,
   kills, lost steps, in-segment kills, async snapshots and overlap,
   resumes, reshards, redistribute bytes) move; also the ring
   redistribution bitwise the eager one on a ragged operand.

Prints one JSON line: every check, the factors' largest difference from
the uninterrupted runs, and the ``ft.ckpt_*`` counter deltas.
``slate_tpu`` also writes them into a RunReport and gates it with
``obs.report --check``; RunReports come with the observability slice.
Exits non-zero if any check failed.

Usage::

    python -m slate_tpu_torch.ft.ckpt_smoke [--device cpu|cuda] [--n 64] [--nb 8]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def result_tensors(x) -> list:
    """Every tensor of a checkpointed (or plain) driver's result, in order:
    a DistMatrix's tiles, the (L, info) / (LU, perm, info) tuples and the
    DistQR / DistTwoStage fields, flattened (what "bitwise" compares)."""
    from ..parallel.dist import DistMatrix

    if isinstance(x, DistMatrix):
        return [x.tiles]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in result_tensors(v)]
    return [x]


def run_smoke(device: str = "cuda", n: int = 64, nb: int = 8) -> dict:
    """Run the checks; returns {"ok", "checks", "failures", ...}."""
    import numpy as np
    import torch

    from ..linalg.eig import _he2hb_panel_count
    from ..parallel import from_dense, make_mesh, redistribute, to_dense
    from ..parallel.dist_chol import potrf_dist
    from ..parallel.dist_lu import getrf_nopiv_dist, getrf_pp_dist
    from ..parallel.dist_qr import geqrf_dist
    from ..parallel.dist_twostage import he2hb_dist
    from ..types import SlateError
    from ..utils.testing import generate
    from . import ckpt, elastic, inject
    from .policy import ft_counter_values

    start = ft_counter_values()
    mesh = make_mesh(2, 4, device=device)
    mesh42 = make_mesh(4, 2, device=device)
    nt = -(-n // nb)
    every = max(2, nt // 3)
    if nt < every + 2:
        raise ValueError(f"ckpt_smoke: nt={nt} leaves no post-snapshot step to kill "
                         f"(every={every}); use n/nb >= 4")
    checks, failures = {}, []

    def check(name, ok, detail=""):
        checks[name] = bool(ok)
        if not ok:
            failures.append(f"{name}: {detail}")

    def bitwise(ref, got):
        return all(torch.equal(r, g) for r, g in zip(result_tensors(ref), result_tensors(got)))

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    gen = dev(generate("randn", n, seed=2))
    sd = from_dense(dev(n * generate("spd", n, seed=0)), mesh, nb, diag_pad_one=True)
    dd = from_dense(dev(generate("dominant", n, seed=1)), mesh, nb, diag_pad_one=True)
    gd = from_dense(gen, mesh, nb, diag_pad_one=True)
    qd = from_dense(gen, mesh, nb)
    hd = from_dense(dev(generate("spd", n, seed=4)), mesh, nb)
    he_steps = _he2hb_panel_count(n, nb)

    # (op, operand, plain driver, checkpointed driver, loop steps, multi):
    # multi ops carry grid-locked arrays -- same-mesh resume bitwise,
    # reshaped grid refused
    cases = {
        "potrf": (sd, potrf_dist, ckpt.potrf_ckpt, nt, False),
        "getrf_nopiv": (dd, getrf_nopiv_dist, ckpt.getrf_nopiv_ckpt, nt, False),
        "getrf_pp": (gd, getrf_pp_dist, ckpt.getrf_pp_ckpt, nt, False),
        "geqrf": (qd, geqrf_dist, ckpt.geqrf_ckpt, nt, True),
        "he2hb": (hd, he2hb_dist, ckpt.he2hb_ckpt, he_steps, True),
    }

    resid = {}
    for op, (d, plain, ckpted, steps, multi) in cases.items():
        ref = plain(d)
        check(f"{op}-uninterrupted", bitwise(ref, ckpted(d, every=every)),
              "checkpointed chain != plain driver (bitwise)")

        # deterministic kill -> Preempted carrying the last snapshot
        kill = inject.seeded_kill(20 + steps, op, steps)
        if not every <= kill.k < steps:  # keep the smoke resumable
            kill = inject.KillFault(op, min(every + 1, steps - 1))
        try:
            with inject.fault_scope(inject.FaultPlan([kill])):
                ckpted(d, every=every)
            check(f"{op}-kill", False, "no Preempted raised")
            continue
        except ckpt.Preempted as e:
            ck = e.checkpoint
        check(f"{op}-snapshot", ck is not None and ck.step == (kill.k // every) * every,
              f"checkpoint {ck and ck.step} for kill at {kill.k} (every={every})")

        # disk round trip, then resume on the SAME mesh: bitwise
        with tempfile.TemporaryDirectory() as td:
            ck = ckpt.Checkpoint.load(ck.save(os.path.join(td, "ck.npz")))
        res = elastic.resume(ck, mesh)
        check(f"{op}-resume-same-mesh", bitwise(ref, res),
              "resumed run != uninterrupted run (bitwise)")

        if multi:
            # grid-locked carries: the reshaped grid must be refused
            try:
                elastic.resume(ck, mesh42)
                check(f"{op}-reshaped-refused", False,
                      "reshaped resume of a grid-locked carry succeeded")
            except SlateError:
                check(f"{op}-reshaped-refused", True)
            resid[op] = float((to_dense(ref[0]) - to_dense(res[0])).abs().max())
            continue

        # the SAME checkpoint on the reshaped 4 x 2 mesh: bitwise factor
        res2 = elastic.resume(ck, mesh42)
        check(f"{op}-resume-reshaped", torch.equal(to_dense(ref[0]), to_dense(res2[0])),
              "reshaped resume != uninterrupted run (bitwise)")
        if op == "getrf_pp":
            check("getrf_pp-perm-reshaped", torch.equal(ref[1][:n], res2[1][:n]),
                  "reshaped resume changed the pivot permutation")
        check(f"{op}-info", int(ref[-1]) == int(res[-1]) == int(res2[-1]),
              f"info {int(ref[-1])} vs {int(res[-1])} / {int(res2[-1])}")
        resid[op] = float((to_dense(ref[0]) - to_dense(res2[0])).abs().max())

    # in-segment kill (step-level arm): the partial segment runs, the loss
    # is exactly kill.k - the last snapshot, and resume is bitwise
    ref_p = potrf_dist(sd)
    k_in = every + 1
    before = ft_counter_values()
    ck_in = None
    try:
        with inject.fault_scope(inject.FaultPlan([inject.KillFault("potrf", k_in, in_segment=True)])):
            ckpt.potrf_ckpt(sd, every=every)
        check("inseg-kill", False, "no Preempted raised")
    except ckpt.Preempted as e:
        ck_in = e.checkpoint
    after = ft_counter_values()
    lost = after["ckpt_lost_steps"] - before["ckpt_lost_steps"]
    check("inseg-lost-steps", lost == k_in - every
          and after["ckpt_inseg_kills"] - before["ckpt_inseg_kills"] == 1,
          f"lost {lost}, want {k_in - every}")
    if ck_in is not None:
        check("inseg-resume", bitwise(ref_p, elastic.resume(ck_in, mesh)),
              "in-segment kill resume != uninterrupted (bitwise)")

    # async snapshots: bitwise the sync path, the counters move
    before = ft_counter_values()
    got_async = ckpt.potrf_ckpt(sd, every=every, async_snapshots=True)
    after = ft_counter_values()
    check("async-bitwise", bitwise(ref_p, got_async), "async-snapshot run != plain (bitwise)")
    check("async-counters", after["ckpt_async_snapshots"] > before["ckpt_async_snapshots"]
          and after["ckpt_snapshots"] > before["ckpt_snapshots"], f"async counters {after}")

    # the ring redistribution bitwise the eager one on a ragged operand
    # (the primitive the reshaped resume rides)
    rd = from_dense(dev(generate("randn", n, seed=3)[: n - nb // 2]), mesh, nb)
    ea = redistribute(rd, mesh42, impl="eager")
    sm = redistribute(rd, mesh42, impl="shardmap")
    check("redistribute-bitwise", torch.equal(ea.tiles, sm.tiles),
          "shardmap redistribute != eager (bitwise)")

    end = ft_counter_values()
    ftv = {k: end[k] - start[k] for k in end if k.startswith("ckpt_")}
    check("counters",
          ftv["ckpt_snapshots"] >= 5 and ftv["ckpt_kills"] >= 6
          and ftv["ckpt_resumes"] >= 9 and ftv["ckpt_reshards"] >= 3
          and ftv["ckpt_snapshot_bytes"] > 0 and ftv["ckpt_redistribute_bytes"] > 0
          and ftv["ckpt_inseg_kills"] >= 1 and ftv["ckpt_async_snapshots"] >= 1,
          f"ckpt counters {ftv}")
    return {"ok": not failures, "device": device, "n": n, "nb": nb, "grid": "2x4",
            "regrid": "4x2", "every": every, "checks": checks, "failures": failures,
            "resume_max_abs_diff": resid, "counters": ftv}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m slate_tpu_torch.ft.ckpt_smoke")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--nb", type=int, default=8)
    args = ap.parse_args(argv)
    res = run_smoke(args.device, args.n, args.nb)
    print(json.dumps(res), flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
