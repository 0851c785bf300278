"""Time the port's mesh partial-pivot LU factor (``getrf_mesh``) on the card
for several checkouts of the repo, each in its own process, in the order
given: for an A/B, ``--roots parent . . parent``.

Each process imports ``slate_tpu_torch`` from its root, warms up at n =
2048, then factors a seeded uniform[-1, 1) f32 (or f64) operand on a
virtual 2 x 4 mesh at nb = 256 (``Option.MixedPrecision`` off, as
chip_smoke.py's mesh_gesv_pp phase) and prints one JSON line: the factor's
seconds to the card's completion, info, and a SHA-256 of the packed factor
and the permutation (equal digests: bitwise-equal factors).

    python3 tools/torch_mesh_pp_ab.py --roots parent . . parent \\
        --out chiprun_out/mesh_pp_ab.jsonl

Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_CHILD = r'''
import hashlib, json, sys, time
sys.path.insert(0, ".")
import torch
from slate_tpu_torch import parallel as mp
from slate_tpu_torch.types import Option

n, dtype = int(sys.argv[1]), getattr(torch, sys.argv[2])
torch.backends.cuda.matmul.allow_tf32 = False
opts = {Option.MixedPrecision: "off"}
mesh = mp.make_mesh(2, 4, device="cuda")


def operand(m, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.rand((m, m), generator=g, dtype=dtype, device="cuda").mul_(2).sub_(1)


lu, perm, info = mp.getrf_mesh(operand(2048, 70), mesh, 256, opts=opts)
assert int(info) == 0
del lu, perm
a = operand(n, 71)
torch.cuda.synchronize()
t = time.perf_counter()
lu, perm, info = mp.getrf_mesh(a, mesh, 256, opts=opts)
torch.cuda.synchronize()
seconds = time.perf_counter() - t
h = hashlib.sha256(lu.tiles.cpu().numpy().tobytes())
h.update(perm.cpu().numpy().tobytes())
print(json.dumps({"n": n, "dtype": sys.argv[2], "seconds": seconds, "info": int(info),
                  "digest": h.hexdigest()[:16]}))
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", required=True, help="checkout roots, in run order")
    ap.add_argument("--n", type=int, default=32768)
    ap.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    args = ap.parse_args()
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    rc = 0
    lines = []
    for root in args.roots:
        r = subprocess.run([sys.executable, "-c", _CHILD, str(args.n), args.dtype],
                           cwd=root, capture_output=True, text=True)
        try:
            rec = json.loads(r.stdout.strip().splitlines()[-1])
        except (IndexError, json.JSONDecodeError):
            rec, rc = {"error": r.stderr.strip()[-2000:]}, 1
        rec.update({"root": root, "gpu": gpu})
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
