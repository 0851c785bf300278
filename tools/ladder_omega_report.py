"""The refined f64 mesh gesv's componentwise backward error over seeds, and
with planted faults in the diagonal block's unit-L^-1: the readings that
``chip_smoke.py``'s GESV_LADDER_OMEGA limit sits between.

The ladder's refinement stops at a normwise gate (||r|| <= ||x|| ||A|| eps
sqrt(n)), which does not bound omega row by row, so the refined solve's
omega depends on where its last step lands.  Re-run this when the f32 LU
kernels change, and keep the limit above the sound seeds and below the
faults.

Run on a card from the repository root (chip_smoke.py's gesv_mesh case:
uniform[-1, 1), 32 right-hand sides, virtual 2 x 4 mesh, nb = 256)::

    python3 tools/ladder_omega_report.py [--n 8192] [--seeds 13]

One JSON line per case: the seed or the planted scale (rows 64 on of the
second 32-wide block column of every unit-L^-1 times the scale; 0 drops
that slab; under IR alone, as chip_smoke's planted run), the tier,
iterations, omega in units of 10 sqrt(n) eps, eta, the refinement's gate,
seconds, and the gates of chip_smoke.ladder_faults it fails.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

PLANTED_SCALES = (0.0, 1 + 1e-3, 1 + 1e-5, 1 + 1e-7)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=cs.MIXED_GESV_N)
    ap.add_argument("--seeds", type=int, default=13)
    args = ap.parse_args()
    import torch

    from slate_tpu_torch import parallel as mp
    from slate_tpu_torch.ops import kernels

    f64 = torch.float64
    mesh = mp.make_mesh(cs.P, cs.Q, device="cuda")
    wa = cs.lu_matrix("pp", cs.MIXED_WARMUP_N, f64, cs.SEED + 162, torch)
    wb = cs.randn((cs.MIXED_WARMUP_N, cs.NRHS), f64, cs.SEED + 161, torch)
    mp.gesv_mesh(wa, wb, mesh, cs.NB)
    del wa, wb

    def show(case, r):
        limit = cs.GESV_LADDER_OMEGA * r["omega_gate"]
        print(json.dumps({"case": case, "n": r["n"], "tier": r["tier"], "iters": r["iters"],
                          "omega": r["omega"], "omega_ratio": r["omega"] / r["omega_gate"],
                          "eta": r["eta"], "refine_gate_ok": r["refine_gate_ok"],
                          "seconds": r["seconds"], "faults": cs.ladder_faults(r, limit)}),
              flush=True)

    # chip_smoke's seed first, then its extra seeds, then more
    seeds = [165, *cs.GESV_LADDER_SEEDS]
    seeds += [seeds[-1] + 2 * k for k in range(1, max(0, args.seeds - len(seeds)) + 1)]
    for s in seeds[:args.seeds]:
        show(f"seed {s}", cs.gesv_ladder_case(s, args.n, mesh, mp, kernels, torch))
    for scale in PLANTED_SCALES:
        with cs.planted_unit_linv_fault(kernels, scale):
            show(f"planted {scale!r}", cs.gesv_ladder_case(165, args.n, mesh, mp, kernels, torch,
                                                          opts=cs.ir_alone()))


if __name__ == "__main__":
    main()
