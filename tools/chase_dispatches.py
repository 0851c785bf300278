#!/usr/bin/env python3
"""Count the PyTorch operator dispatches of the port's bulge chases, per
wavefront step.

    python3 tools/chase_dispatches.py [--n 300] [--w 16] [--device cpu]

The chases (``linalg.eig.hb2st``, ``linalg.svd.tb2bd``) are eager host
loops, so their time on the card is the number of dispatches a step times
the host's cost of one.  Counts every aten operator call (views included)
under a ``TorchDispatchMode`` while one chase runs on a random band, and
prints one JSON line: the steps, the dispatches a step and the most
frequent operators.  The count does not depend on the device.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from slate_tpu_torch.linalg import eig, svd  # noqa: E402


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] = self.ops.get(str(func), 0) + 1
        return func(*args, **(kwargs or {}))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=300)
    ap.add_argument("--w", type=int, default=16)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    n, w = args.n, args.w
    g = torch.Generator().manual_seed(0)
    a = torch.randn(n, n, generator=g, dtype=torch.float32).to(args.device)
    band = torch.triu(torch.tril(a + a.T, w), -w)
    upper = torch.triu(torch.tril(a, w))
    hops = -(-(n - 1) // w)
    out = {"n": n, "w": w}
    for name, fn, x, steps in (("hb2st", eig.hb2st, band, 4 * (n - 3) + hops),
                               ("tb2bd", svd.tb2bd, upper, 4 * (n - 2) + hops)):
        with Count() as c:
            fn(x, w)
        total = sum(c.ops.values())
        top = sorted(c.ops.items(), key=lambda kv: -kv[1])[:8]
        out[name] = {"steps": steps, "dispatches_per_step": total / steps,
                     "top": {k: v / steps for k, v in top}}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
