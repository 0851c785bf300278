"""The RBT solve's componentwise backward error in both packages on the CPU:
``slate_tpu.linalg.rbt.gesv_rbt_array`` and the port's
``slate_tpu_torch.linalg.rbt.gesv_rbt_array`` (each with its own random
butterflies), beside the no-pivot and partial-pivot solves of slate_tpu, on
uniform[-1, 1) operands with 32 right-hand sides.

It answers whether a reading of chip_smoke.py's gesv_rbt phase above the
LU family's 10 sqrt(n) eps line is the method's (the reference reads the
same) or the port's.  Run from the repository root on the CPU::

    JAX_PLATFORMS=cpu python3 tools/rbt_omega_probe.py [--n 1024] [--seeds 3]

One JSON line per (dtype, seed): omega in units of 10 sqrt(n) eps (the
residual in f64) and eta for each solve.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    jax.config.update("jax_enable_x64", True)
    from slate_tpu.linalg import lu as jlu
    from slate_tpu.linalg import rbt as jrbt
    from slate_tpu.types import MethodLU
    from slate_tpu_torch.linalg import rbt as trbt

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--seeds", type=int, default=3)
    args = ap.parse_args()
    n = args.n

    def readings(a, x, b):
        a, x, b = (np.asarray(v, np.float64) for v in (a, x, b))
        r = np.abs(a @ x - b)
        omega = float((r / (np.abs(a) @ np.abs(x) + np.abs(b))).max())
        eta = float(r.max() / (np.abs(a).max() * np.abs(x).max() * n + np.abs(b).max()))
        return omega, eta

    for dtype in (np.float32, np.float64):
        line = 10 * np.sqrt(n) * np.finfo(dtype).eps
        for seed in range(args.seeds):
            rng = np.random.default_rng(seed)
            a = (2 * rng.random((n, n)) - 1).astype(dtype)
            b = rng.standard_normal((n, 32)).astype(dtype)
            xs = {
                "slate_tpu_rbt": jrbt.gesv_rbt_array(jnp.asarray(a), jnp.asarray(b),
                                                     key=jax.random.PRNGKey(seed))[0],
                "port_rbt": trbt.gesv_rbt_array(torch.from_numpy(a), torch.from_numpy(b),
                                                generator=torch.Generator().manual_seed(seed))[0],
                "slate_tpu_nopiv": jlu.gesv_array(jnp.asarray(a), jnp.asarray(b), MethodLU.NoPiv)[0],
                "slate_tpu_pp": jlu.gesv_array(jnp.asarray(a), jnp.asarray(b), MethodLU.PartialPiv)[0],
            }
            out = {"dtype": np.dtype(dtype).name, "n": n, "seed": seed}
            for k, x in xs.items():
                omega, eta = readings(a, np.asarray(x), b)
                out[k] = {"omega_over_line": omega / line, "eta": eta}
            print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
