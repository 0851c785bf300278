#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (slate_tpu_torch) on one GPU.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA card.  Phases, each
printing one JSON line before the next starts (any failure exits non-zero):

1. card:   device name, and the ``nvidia-smi`` name and power limit line;
2. build:  every csrc/*.cu with nvcc into slate_tpu_torch/_build/ (seconds);
3. kernel: chol_diag_inv against its plain twin at nb = 256, f32 and f64
           (SPD blocks within tolerance, a non-SPD block NaN from the same
           column), with kernel, twin and library times and the bound;
4. posv f32 at n = 32768, nrhs = 32 through linalg.posv_array (the
           panel-stepped scan form): info, backward error, 128 kernel
           launches, seconds after one warm-up run, peak memory;
5. posv f64 at n = 32768 (the left-looking form, 8 panels x 16 leaves);
6. small:  the entry() solve (n = 1024) against torch.linalg.solve in f64;
7. non-SPD: one negative pivot gives the expected info in both forms;
8. kernels: the line of every ported kernel, then the card line and, last,
           {"ok": true, "device": {...}}.

Imports nothing of JAX or of the JAX package.  Without a CUDA device, or
outside a checkout, it exits non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import time

NB = 256
N_MAIN = 32768
NRHS = 32
SEED = 0
# published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit):
# HBM 3.35 TB/s; 67 TFLOP/s f32 and 34 TFLOP/s f64 outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {"float32": 67e12, "float64": 34e12}


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_ms(fn, reps, torch):
    """Mean milliseconds of fn() over reps calls, by CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def spd_block(nb, dtype, seed, torch):
    g = torch.randn((nb, nb), generator=torch.Generator(device="cuda").manual_seed(seed),
                    dtype=torch.float64, device="cuda")
    return (g @ g.T / nb + torch.eye(nb, dtype=torch.float64, device="cuda")).to(dtype)


def dominant_spd(n, dtype, seed, torch):
    """Symmetric uniform[-1, 1) + n I: diagonally dominant, hence SPD, made
    on the device with no n^3 product."""
    u = torch.rand((n, n), generator=torch.Generator(device="cuda").manual_seed(seed),
                   dtype=dtype, device="cuda")
    u.mul_(2).sub_(1)
    a = u.tril()
    a.add_(u.tril(-1).T)
    del u
    a.diagonal().add_(n)
    return a


def eta(a, x, b, torch):
    """Normwise backward error max|AX-B| / (max|A| max|X| n + max|B|)."""
    r = (torch.matmul(a, x) - b).abs().max()
    return float(r / (a.abs().max() * x.abs().max() * a.shape[0] + b.abs().max()))


def kernel_phase(dtype, kernels, torch):
    name = str(dtype).replace("torch.", "")
    eps = torch.finfo(dtype).eps
    a = spd_block(NB, dtype, SEED + 1, torch)
    l, x = kernels.chol_diag_inv(a)
    torch.cuda.synchronize()
    lp, xp = kernels.chol_diag_inv_plain(a)
    anorm = float(a.abs().max())
    # tolerance: 100 nb eps max|A| for L, 100 nb eps max|L^-1| max|A| for
    # L^-1 -- the O(eps cond) class of two summation orders
    tol_l = 100 * NB * eps * anorm
    tol_x = 100 * NB * eps * float(xp.abs().max()) * anorm
    err_l = float((l - lp).abs().max())
    err_x = float((x - xp).abs().max())
    check(torch.isfinite(l).all() and torch.isfinite(x).all(), f"{name}: non-finite kernel output")
    check(err_l < tol_l and err_x < tol_x,
          f"{name}: kernel vs twin |dL| {err_l} (tol {tol_l}), |dX| {err_x} (tol {tol_x})")
    # non-SPD: NaN from the same column in kernel and twin
    bad = a.clone()
    j = 100
    bad[j, j] = -1.0
    lb, xb = kernels.chol_diag_inv(bad)
    lbp, xbp = kernels.chol_diag_inv_plain(bad)
    nan_k = torch.isnan(lb.diagonal()).nonzero()
    nan_p = torch.isnan(lbp.diagonal()).nonzero()
    first_k = int(nan_k[0]) if len(nan_k) else -1
    first_p = int(nan_p[0]) if len(nan_p) else -1
    check(first_k == first_p == j, f"{name}: first NaN column kernel {first_k}, twin {first_p}, expected {j}")
    check(torch.equal(torch.isnan(lb), torch.isnan(lbp)) and torch.equal(torch.isnan(xb), torch.isnan(xbp)),
          f"{name}: NaN patterns of kernel and twin differ")
    ms = cuda_ms(lambda: kernels.chol_diag_inv(a), 200, torch)
    plain_ms = cuda_ms(lambda: kernels.chol_diag_inv_plain(a), 3, torch)

    def library():
        lo, _ = torch.linalg.cholesky_ex(a)
        torch.linalg.solve_triangular(lo, eye, upper=False)

    eye = torch.eye(NB, dtype=dtype, device="cuda")
    library_ms = cuda_ms(library, 200, torch)
    # the lower triangle of A read once (the kernel never reads the upper),
    # dense L and L^-1 written once
    nbytes = (NB * (NB + 1) // 2 + 2 * NB * NB) * a.element_size()
    flops = 2 * NB ** 3 / 3  # factor nb^3/3 + triangular inverse nb^3/3
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_FLOPS_S[name] * 1e3
    row = {
        "name": f"chol_diag_inv[{name}]", "route": "cuda",
        "source": "slate_tpu_torch/csrc/chol_diag_inv.cu",
        "replaces": "slate_tpu/ops/pallas_ops.py:471",
        "launches": None, "max_abs_err": max(err_l, err_x),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }
    emit({"phase": f"kernel_{name}", "nb": NB, "err_L": err_l, "tol_L": tol_l,
          "err_Linv": err_x, "tol_Linv": tol_x, "nan_first_col": first_k,
          "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
          "bound_ms": row["bound_ms"], "bound_by": row["bound_by"]})
    return row


def posv_phase(dtype, kernels, posv_array, torch):
    name = str(dtype).replace("torch.", "")
    n = N_MAIN
    a = dominant_spd(n, dtype, SEED + 2, torch)
    b = torch.randn((n, NRHS), generator=torch.Generator(device="cuda").manual_seed(SEED + 3),
                    dtype=dtype, device="cuda")
    x, f, info = posv_array(a, b)  # warm-up: cuBLAS/cuSOLVER handles, allocator
    del x, f, info
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.chol_diag_inv.launches = 0
    t0 = time.perf_counter()
    x, f, info = posv_array(a, b)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.chol_diag_inv.launches
    peak = torch.cuda.max_memory_allocated()
    del f
    e = eta(a, x, b, torch)
    gate = 100 * n * torch.finfo(dtype).eps
    emit({"phase": f"posv_{name}", "n": n, "nrhs": NRHS, "info": int(info), "eta": e,
          "eta_gate": gate, "kernel_launches": launches, "seconds": seconds,
          "peak_mem_bytes": peak, "x_finite": bool(torch.isfinite(x).all())})
    check(int(info) == 0, f"posv {name}: info {int(info)}")
    check(e < gate, f"posv {name}: eta {e} >= {gate}")
    check(tuple(x.shape) == (n, NRHS) and bool(torch.isfinite(x).all()), f"posv {name}: bad solution")
    check(launches == n // NB, f"posv {name}: {launches} kernel launches, expected {n // NB}")
    del a, b, x
    torch.cuda.empty_cache()
    return launches


def small_phase(torch):
    from slate_tpu_torch.entry import entry

    fn, (a, b) = entry(device="cuda")
    x, info = fn(a, b)
    ref = torch.linalg.solve(a.double(), b.double())
    rel = float((x.double() - ref).abs().max() / ref.abs().max())
    e = eta(a.double(), x.double(), b.double(), torch)
    emit({"phase": "small_entry", "n": a.shape[0], "info": int(info), "rel_err_vs_f64_solve": rel, "eta": e})
    # f32 solve of a well-conditioned (cond ~ 4) system against an f64 solve
    check(int(info) == 0 and rel < 1e-4, f"entry posv: info {int(info)}, rel err {rel}")


def non_spd_phase(kernels, potrf_array, torch):
    # f32 scan form at the main size: the breakdown sits in the last panel
    # step of its bucket (steps 32..63 of 128), where the info code is
    # 1 + the first bad pivot; earlier in a bucket slate_tpu's masked
    # full-width update NaN-poisons the bucket's earlier diagonals too, and
    # the port reproduces that (tests/test_torch_chol.py)
    # f64 left-looking form at n = 8192 (nb = 2048): info is 1 + the bad pivot
    out = {"phase": "non_spd"}
    for dtype, n, j in ((torch.float32, N_MAIN, 63 * NB + 50), (torch.float64, 8192, 5000)):
        a = dominant_spd(n, dtype, SEED + 4, torch)
        a[j, j] = -1.0
        _, info = potrf_array(a)
        name = str(dtype).replace("torch.", "")
        out[f"{name}_n"], out[f"{name}_info"], out[f"{name}_expected"] = n, int(info), j + 1
        del a
        torch.cuda.empty_cache()
    emit(out)
    for name in ("float32", "float64"):
        check(out[f"{name}_info"] == out[f"{name}_expected"],
              f"non-SPD {name}: info {out[f'{name}_info']}, expected {out[f'{name}_expected']}")


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "slate_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository (slate_tpu_torch/ missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    from slate_tpu_torch.linalg.chol import posv_array, potrf_array
    from slate_tpu_torch.ops import _build, kernels

    # 1. card
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else ""
    check(smi_line, f"nvidia-smi failed: {smi.stderr.strip()}")
    emit({"phase": "card", "device": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi_line, "torch": torch.__version__, "cuda": torch.version.cuda})
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 residual products (the default)

    # 2. build (one source so far; a later slice with several starts their
    # nvcc processes together)
    t0 = time.perf_counter()
    built = sorted(f[:-3] for f in os.listdir(_build.CSRC_DIR) if f.endswith(".cu"))
    for name in built:
        _build.load(name)
    emit({"phase": "build", "sources": built, "seconds": time.perf_counter() - t0})

    # 3. kernel vs twin
    rows = [kernel_phase(dt, kernels, torch) for dt in (torch.float32, torch.float64)]

    # 4-5. the main path
    for row, dt in zip(rows, (torch.float32, torch.float64)):
        row["launches"] = posv_phase(dt, kernels, posv_array, torch)

    # 6-7. small reference solve, non-SPD info codes
    small_phase(torch)
    non_spd_phase(kernels, potrf_array, torch)

    # 8. kernels line, card line, result
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
