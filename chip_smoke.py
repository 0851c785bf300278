#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (slate_tpu_torch) on one GPU.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA card.  Phases, each
printing one JSON line before the next starts (any failure exits non-zero):

1. card:   device name, and the ``nvidia-smi`` name and power limit line;
2. build:  every csrc/*.cu with nvcc into slate_tpu_torch/_build/, one nvcc
           per source, all started together (seconds);
3. kernel: chol_diag_inv against its plain twin at nb = 256, f32 and f64
           (SPD blocks within tolerance, a non-SPD block NaN from the same
           column), with kernel, twin and library times and the bound;
4. posv f32 at n = 32768, nrhs = 32 through linalg.posv_array (the
           panel-stepped scan form): info, backward error, 128 kernel
           launches, seconds after one warm-up run, peak memory;
5. posv f64 at n = 32768 (the left-looking form, 8 panels x 16 leaves);
6. small:  the entry() solve (n = 1024) against torch.linalg.solve in f64;
7. non-SPD: one negative pivot gives the expected info in both forms;
8. the mesh kernels against their plain twins at the mesh path's shapes
   (nb = 256, a virtual 2 x 4 grid): chol_panel_tiles and
   chol_trailing_update (f32, f64) and summa_update (f32), with kernel,
   twin and library times and the bound;
9. mesh_posv f32 at n = 32768, nrhs = 32, nb = 256 on a virtual 2 x 4 mesh
   (from_dense -> potrf_dist -> two trsm_dist -> gemm_summa residual):
   info, backward error, the panel and trailing-update launch counts
   derived from the code, seconds after one warm-up run, peak memory;
10. mesh_posv f64 at n = 16384;
11. mesh_gemm f32: a square gemm_summa (GemmC) at n = 16384 against
   torch.matmul, 64 summa_update launches;
12. the LU kernels against their plain twins at the mesh LU's shapes
   (f32 n = 32768, f64 n = 16384): lu_panel_tiles (diagonal block + the
   owning column's (2, 1, mtl) tiles), lu_rowsolve_tiles (the owning row's
   (1, 4, ntl) tiles) and lu_trailing_update (the bucket-0 window with the
   lookahead exclusions), with kernel, twin and library times and the bound;
   the packed L\\U holds L and U each at its own scale and to A by
   reconstruction;
13. mesh_gesv_nopiv f32 at n = 32768 and f64 at n = 16384 (uniform[-1, 1)
   + n I): getrf_nopiv_mesh -> two trsm_dist, info, the normwise backward
   error (gate 100 n eps) and the componentwise one (gate 10 sqrt(n) eps,
   the residual in f64), the launches of all three LU kernels derived from
   ``bucket_plan``, split seconds after a warm-up solve at n = 2048, peak
   memory;
14. mesh_gesv_pp (gesv_mesh, partial pivoting) f32 at n = 32768 and f64 at
   n = 16384 (MixedPrecision off) on uniform[-1, 1): getrf_mesh ->
   permute_rows_dist -> two trsm_dist, nt lu_rowsolve_tiles launches and
   no update kernel (the update is pinned to the matmul form);
15. mesh_gesv_tntpiv f32 at n = 8192 (the tournament is many small torch
   ops per step, so this size keeps the script well inside its limit);
16. mesh_invariants at n = 4096: bitwise across lookahead 0/1/2 and across
   the psum/ring/doubling lowerings, and the non-SPD info rule;
17. lu_invariants at n = 4096: the no-pivot and partial-pivot solves
   bitwise across lookahead 0/1/2 and psum/ring/doubling, and a zero
   column j giving info j + 1;
18. dryrun: the port's dryrun (posv_chain, gesv_pp, the LU panel_pallas
   half; n = 64, nb = 8, 2 x 4);
19. kernels: the line of every ported kernel (one row per kernel and
   dtype), then the card line and, last, {"ok": true, "device": {...}}.

Imports nothing of JAX or of the JAX package.  Without a CUDA device, or
outside a checkout, it exits non-zero and prints no result.
"""

import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

NB = 256
N_MAIN = 32768
NRHS = 32
SEED = 0
# published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit):
# HBM 3.35 TB/s; 67 TFLOP/s f32 outside the tensor cores, 67 TFLOP/s f64 on
# the FP64 tensor cores (DMMA, IEEE double)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {"float32": 67e12, "float64": 67e12}
# the mesh path: a virtual 2 x 4 grid; f64 runs at half the f32 size
P, Q = 2, 4
MESH_N = {"float32": 32768, "float64": 16384}
GEMM_N = 16384
INVARIANT_N = 4096


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


# ---------------------------------------------------------------------------
# the mesh slice: virtual 2 x 4 grid on the card
# ---------------------------------------------------------------------------


def dname(dtype):
    return str(dtype).replace("torch.", "")


def row_of(name, dtype, source, replaces, err, ms, plain_ms, library_ms, nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS_S[dname(dtype)] * 1e3
    return {"name": f"{name}[{dname(dtype)}]", "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": library_ms}


def randn(shape, dtype, seed, torch, scale=1.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=dtype, device="cuda") * scale


def mesh_tiles(n, dtype, seed, torch, local_view):
    """A random cyclic tile stack of an n x n matrix and its local view
    (p, q, mtl, ntl, nb, nb): the strides the mesh drivers hand the kernels."""
    t = randn((n // NB, n // NB, NB, NB), dtype, seed, torch)
    return t, local_view(t, P, Q)


def kernel_panel_phase(dtype, kernels, local_view, torch):
    """chol_panel_tiles at the f32/f64 mesh path's widest panel: the owning
    column's p x mtl tiles of a bucket-0 view, strided."""
    name = dname(dtype)
    eps = torch.finfo(dtype).eps
    n = MESH_N[name]
    t, loc = mesh_tiles(n, dtype, SEED + 11, torch, local_view)
    pcol = loc[:, 1:2, :, 1]  # (p, 1, mtl, nb, nb), as panel(k) slices it
    dtile = spd_block(NB, dtype, SEED + 12, torch)
    lk, sk = kernels.chol_panel_tiles(dtile, pcol)
    torch.cuda.synchronize()
    lp, sp = kernels.chol_panel_tiles_plain(dtile, pcol)
    _, xk = kernels.chol_diag_inv(dtile)  # the L^-1 the panel kernel solved with
    _, xp = kernels.chol_diag_inv_plain(dtile)
    # L: chol_diag_inv's 100 nb eps max|A|; solved tiles: panel_solve_tol
    tol_l = 100 * NB * eps * float(dtile.abs().max())
    tol_s = panel_solve_tol(pcol, xk, xp, eps)
    smax = float(sp.abs().max())
    err_l = float((lk - lp).abs().max())
    err_s = float((sk - sp).abs().max())
    check(bool(torch.isfinite(sk).all()), f"chol_panel_tiles {name}: non-finite output")
    check(tol_s < 1e-2 * smax, f"chol_panel_tiles {name}: tolerance {tol_s} does not separate "
                               f"a wrong output from max|solved| {smax}")
    check(err_l < tol_l and err_s < tol_s,
          f"chol_panel_tiles {name}: |dL| {err_l} (tol {tol_l}), |dS| {err_s} (tol {tol_s})")
    ms = cuda_ms(lambda: kernels.chol_panel_tiles(dtile, pcol), 20, torch)
    plain_ms = cuda_ms(lambda: kernels.chol_panel_tiles_plain(dtile, pcol), 2, torch)

    def library():
        lo, _ = torch.linalg.cholesky_ex(dtile)
        torch.linalg.solve_triangular(lo.T, pcol, upper=True, left=False)

    library_ms = cuda_ms(library, 20, torch)
    ntiles = pcol.shape[0] * pcol.shape[2]
    isz = dtile.element_size()
    nbytes = (NB * (NB + 1) // 2 + NB * NB + 2 * ntiles * NB * NB) * isz
    # factor nb^3/3 + triangular inverse nb^3/3, then one product with the
    # triangular L^-T per tile, nb^3
    flops = 2 * NB ** 3 / 3 + NB ** 3 * ntiles
    row = row_of("chol_panel_tiles", dtype, "slate_tpu_torch/csrc/tile_gemm.cu",
                 "slate_tpu/ops/pallas_ops.py:491", max(err_l, err_s), ms, plain_ms, library_ms,
                 nbytes, flops)
    emit({"phase": f"kernel_chol_panel_tiles_{name}", "tiles": list(pcol.shape), "err_L": err_l,
          "tol_L": tol_l, "err_solved": err_s, "tol_solved": tol_s, "max_abs_solved": smax,
          "kernel_ms": ms,
          "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": row["bound_ms"],
          "bound_by": row["bound_by"]})
    del t, loc, pcol
    torch.cuda.empty_cache()
    return row


def panel_solve_tol(tiles, xk, xp, eps):
    """Bound on |tiles @ xk^T - tiles @ xp^T| as the kernel and the twin
    compute it: each sums nb products, within nb eps (|T| |X|^T) of the exact
    product of its operands, and the two inverses' own difference adds
    |T| |xk - xp|^T.  Elementwise, then the largest."""
    nb = xk.shape[-1]
    t = tiles.abs()
    bound = nb * eps * (t @ xk.abs().T + t @ xp.abs().T) + t @ (xk - xp).abs().T
    return float(bound.max())


def gemm_tol(nb, eps, amax, bmax, cmax):
    """Kernel vs twin of a tile update: two k-ordered FMA sums of nb
    products, whose rounding errors grow as a random walk (a few sqrt(nb)
    eps max|a| max|b|), plus one rounding each of the final add/subtract
    (cmax: the largest |c| before or after).  A TF32 product (10-bit
    mantissa, ~4e3 f32 eps) lies far outside it."""
    return 8 * math.sqrt(nb) * eps * amax * bmax + 2 * eps * cmax


def kernel_update_phase(which, dtype, kernels, local_view, local_indices, torch):
    """chol_trailing_update (bucket-0 view of the mesh posv, lower-tile
    mask), lu_trailing_update (bucket-0 view of the mesh LU, the lookahead
    exclusions of one row and one column slot) or summa_update (the mesh
    gemm's accumulator) against its twin."""
    name = dname(dtype)
    eps = torch.finfo(dtype).eps
    n = GEMM_N if which == "summa_update" else MESH_N[name]
    t, loc = mesh_tiles(n, dtype, SEED + 21, torch, local_view)
    _, _, I, J, _, _ = loc.shape
    pan = randn((P, 1, I, NB, NB), dtype, SEED + 22, torch, 0.1)
    rhs = randn((1, Q, J, NB, NB), dtype, SEED + 23, torch, 0.1)
    if which == "chol_trailing_update":
        _, _, i_log, j_log = local_indices(P, Q, I, J, "cuda")
        mask = i_log[:, :, :, None] >= j_log[:, :, None, :]  # the trailing lower tiles
        run = lambda v: kernels.chol_trailing_update(v, pan, rhs, mask)  # noqa: E731
        plain = lambda v: kernels.chol_trailing_update_plain(v, pan, rhs, mask)  # noqa: E731
        library = lambda: torch.matmul(pan.unsqueeze(-3), rhs.unsqueeze(-4).transpose(-1, -2))  # noqa: E731
        replaces = "slate_tpu/ops/pallas_ops.py:738"
    elif which == "lu_trailing_update":
        mask = torch.ones((P, Q, I, J), dtype=torch.bool, device="cuda")
        mask[:, :, 1, :] = False  # excl_kr
        mask[:, :, :, 1] = False  # excl_kc
        run = lambda v: kernels.lu_trailing_update(v, pan, rhs, mask)  # noqa: E731
        plain = lambda v: kernels.lu_trailing_update_plain(v, pan, rhs, mask)  # noqa: E731
        library = lambda: torch.matmul(pan.unsqueeze(-3), rhs.unsqueeze(-4))  # noqa: E731
        replaces = "slate_tpu/ops/pallas_ops.py:777"
    else:
        mask = torch.ones((P, Q, I, J), dtype=torch.bool, device="cuda")
        run = lambda v: kernels.summa_update(v, pan, rhs)  # noqa: E731
        plain = lambda v: kernels.summa_update_plain(v, pan, rhs)  # noqa: E731
        library = lambda: torch.matmul(pan.unsqueeze(-3), rhs.unsqueeze(-4))  # noqa: E731
        replaces = "slate_tpu/ops/pallas_ops.py:711"
    before = loc.clone()
    run(loc)
    torch.cuda.synchronize()
    got = loc.clone()
    loc.copy_(before)
    plain(loc)
    want = loc.clone()
    loc.copy_(before)
    tol = gemm_tol(NB, eps, float(pan.abs().max()), float(rhs.abs().max()),
                   max(float(before.abs().max()), float(want.abs().max())))
    err = float((got - want).abs().max())
    keep = ~mask
    untouched = bool(torch.equal(got[keep], before[keep])) if bool(keep.any()) else True
    del got, want
    check(err < tol, f"{which} {name}: kernel vs twin {err} (tol {tol})")
    check(untouched, f"{which} {name}: the kernel wrote a masked tile")
    ms = cuda_ms(lambda: run(loc), 5, torch)
    plain_ms = cuda_ms(lambda: plain(loc), 2, torch)
    library_ms = cuda_ms(library, 3, torch)
    live = int(mask.sum())
    isz = loc.element_size()
    nbytes = (pan.numel() + rhs.numel() + 2 * live * NB * NB) * isz + mask.numel() * 4
    flops = 2 * NB ** 3 * live
    row = row_of(which, dtype, "slate_tpu_torch/csrc/tile_gemm.cu", replaces, err, ms, plain_ms,
                 library_ms, nbytes, flops)
    emit({"phase": f"kernel_{which}_{name}", "grid": [P, Q, I, J], "unmasked_tiles": live,
          "err": err, "tol": tol, "masked_untouched": untouched, "kernel_ms": ms,
          "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": row["bound_ms"],
          "bound_by": row["bound_by"]})
    del t, loc, before
    torch.cuda.empty_cache()
    return row


COUNTED = ("chol_diag_inv", "chol_panel_tiles", "chol_trailing_update", "summa_update",
           "lu_panel_tiles", "lu_rowsolve_tiles", "lu_trailing_update")


def reset_counts(kernels):
    for name in COUNTED:
        getattr(kernels, name).launches = 0


def read_counts(kernels):
    return {name: getattr(kernels, name).launches for name in COUNTED}


def expected_potrf_launches(nt, la, bucket_plan):
    """Launches of one potrf_dist, derived from its loop: one panel per
    step; per bucket of s steps, s bulk updates and, at lookahead >= 1, s
    narrow refreshes plus one drain."""
    panel = trailing = 0
    for k0, k1, _, _ in bucket_plan(nt, P, Q):
        s = k1 - k0
        panel += s
        trailing += s + (s + 1 if la >= 1 else 0)
    return {"chol_panel_tiles": panel, "chol_trailing_update": trailing}


def mesh_posv_phase(dtype, kernels, mp, bucket_plan, torch):
    """from_dense -> potrf_dist -> two trsm_dist (the solve, timed) ->
    gemm_summa residual, at the size users run on one card."""
    from slate_tpu_torch.types import Diag, Op, Uplo

    name = dname(dtype)
    n = MESH_N[name]
    mesh = mp.make_mesh(P, Q, device="cuda")
    a = dominant_spd(n, dtype, SEED + 31, torch)
    b = torch.randn((n, NRHS), generator=torch.Generator(device="cuda").manual_seed(SEED + 32),
                    dtype=dtype, device="cuda")

    def solve(split):
        """The solve; ``split`` collects the seconds of each step (a
        synchronise after each, a few microseconds)."""
        t = time.perf_counter()

        def mark(name):
            nonlocal t
            torch.cuda.synchronize()
            now = time.perf_counter()
            split[name] = now - t
            t = now

        ad = mp.from_dense(a, mesh, NB, diag_pad_one=True)
        bd = mp.from_dense(b, mesh, NB)
        mark("from_dense")
        l, info = mp.potrf_dist(ad, overwrite_a=True)
        mark("potrf_dist")
        y = mp.trsm_dist(l, bd, Uplo.Lower, Op.NoTrans, Diag.NonUnit)
        mark("trsm_dist_lower")
        x = mp.trsm_dist(l, y, Uplo.Lower, Op.ConjTrans, Diag.NonUnit)
        mark("trsm_dist_upper")
        return l, x, info

    l, x, info = solve({})  # warm-up: handles, allocator, kernel loads
    del l, x, info
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    split = {}
    t0 = time.perf_counter()
    l, x, info = solve(split)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    del l
    t1 = time.perf_counter()
    ax = mp.to_dense(mp.gemm_summa(1.0, mp.from_dense(a, mesh, NB), x))
    torch.cuda.synchronize()
    residual_seconds = time.perf_counter() - t1
    counts = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    xd = mp.to_dense(x)
    e = float((ax - b).abs().max() / (a.abs().max() * xd.abs().max() * n + b.abs().max()))
    gate = 100 * n * torch.finfo(dtype).eps
    nt = n // NB
    want = expected_potrf_launches(nt, 1, bucket_plan)
    emit({"phase": f"mesh_posv_{name}", "n": n, "nrhs": NRHS, "nb": NB, "grid": [P, Q],
          "info": int(info), "eta": e, "eta_gate": gate, "launches": counts,
          "expected_launches": want, "solve_seconds": seconds, "split_seconds": split,
          "residual_seconds": residual_seconds, "peak_mem_bytes": peak,
          "x_finite": bool(torch.isfinite(xd).all())})
    check(int(info) == 0, f"mesh posv {name}: info {int(info)}")
    check(e < gate, f"mesh posv {name}: eta {e} >= {gate}")
    check(tuple(xd.shape) == (n, NRHS) and bool(torch.isfinite(xd).all()),
          f"mesh posv {name}: bad solution")
    for k, v in want.items():
        check(counts[k] == v, f"mesh posv {name}: {counts[k]} {k} launches, expected {v}")
    del a, b, x, xd, ax
    torch.cuda.empty_cache()
    return counts


def mesh_gemm_phase(kernels, mp, torch):
    from slate_tpu_torch.types import MethodGemm, select_gemm_method

    dtype = torch.float32
    n = GEMM_N
    mesh = mp.make_mesh(P, Q, device="cuda")
    a = randn((n, n), dtype, SEED + 41, torch)
    b = randn((n, n), dtype, SEED + 42, torch)
    ad, bd = mp.from_dense(a, mesh, NB), mp.from_dense(b, mesh, NB)
    method = select_gemm_method(ad.mt, bd.nt, ad.nt)
    check(method == MethodGemm.GemmC, f"mesh gemm: {method} selected, expected GemmC")
    mp.gemm_summa(1.0, ad, bd)  # warm-up
    torch.cuda.synchronize()
    reset_counts(kernels)
    t0 = time.perf_counter()
    c = mp.gemm_summa(1.0, ad, bd)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts(kernels)
    del ad, bd
    cd = mp.to_dense(c)
    del c
    ref = torch.matmul(a, b)  # full f32 (TF32 off)
    rel = float((cd - ref).abs().max() / ref.abs().max())
    # f32 sums of k = 16384 products in two orders differ by ~sqrt(k) eps
    # relative to the largest entry; a TF32 product would be ~10x the gate
    gate = 4 * math.sqrt(n) * torch.finfo(dtype).eps
    emit({"phase": "mesh_gemm_float32", "n": n, "nb": NB, "grid": [P, Q], "method": method.name,
          "rel_err_vs_matmul": rel, "gate": gate, "launches": counts, "seconds": seconds,
          "tflops": 2 * n ** 3 / seconds / 1e12})
    check(rel < gate, f"mesh gemm: relative error {rel} >= {gate}")
    check(counts["summa_update"] == n // NB,
          f"mesh gemm: {counts['summa_update']} summa_update launches, expected {n // NB}")
    del a, b, cd, ref
    torch.cuda.empty_cache()
    return counts


def mesh_invariants_phase(mp, posv_chain, torch):
    """Bitwise across lookahead depths and broadcast lowerings (the whole
    chain), and the non-SPD info rule (1 + the first bad pivot)."""
    n = INVARIANT_N
    mesh = mp.make_mesh(P, Q, device="cuda")
    a = dominant_spd(n, torch.float32, SEED + 51, torch)
    b = randn((n, NRHS), torch.float32, SEED + 52, torch)
    runs = {}
    for la in (0, 1, 2):
        runs[f"lookahead{la}"] = posv_chain(a, b, mesh, NB, lookahead=la)[0]
    for impl in ("psum", "ring", "doubling"):
        runs[f"bcast_{impl}"] = posv_chain(a, b, mesh, NB, bcast_impl=impl)[0]
    base = runs["lookahead1"]
    equal = {k: bool(torch.equal(v, base)) for k, v in runs.items()}
    j = 9 * NB + 77  # inside diagonal tile 9, step 9 of bucket 2
    bad = a.clone()
    bad[j, j] = -1.0
    _, info = mp.potrf_dist(mp.from_dense(bad, mesh, NB, diag_pad_one=True))
    emit({"phase": "mesh_invariants", "n": n, "bitwise_equal": equal, "non_spd_info": int(info),
          "expected_info": j + 1})
    check(all(equal.values()), f"mesh invariants: not bitwise equal: {equal}")
    check(int(info) == j + 1, f"mesh invariants: non-SPD info {int(info)}, expected {j + 1}")
    del a, b, bad, runs
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the LU slice: the three LU kernels and the three mesh LU solves
# ---------------------------------------------------------------------------


def lu_block(nb, dtype, seed, torch):
    """A diagonal block that factors stably without pivoting: randn + nb I."""
    g = randn((nb, nb), torch.float64, seed, torch)
    g.diagonal().add_(nb)
    return g.to(dtype)


def solve_tol(tiles, xk, xp, eps, left):
    """Bound on |tiles @ xk - tiles @ xp| (``left``: |xk @ tiles - xp @ tiles|)
    as the kernel and the twin compute it: each sums nb products, within
    nb eps of the exact product of its operands, and the two inverses' own
    difference adds its product with |tiles|.  Elementwise, the largest."""
    nb = xk.shape[-1]
    t = tiles.abs()
    if left:
        bound = nb * eps * (xk.abs() @ t + xp.abs() @ t) + (xk - xp).abs() @ t
    else:
        bound = nb * eps * (t @ xk.abs() + t @ xp.abs()) + t @ (xk - xp).abs()
    return float(bound.max())


def lu_factor_check(a, lk, lp, eps, torch):
    """The kernel's packed L\\U ``lk`` of block ``a`` against the twin's
    ``lp`` and against ``a`` itself.  L (strict lower) and U (upper) each
    hold to 100 nb eps of the twin's largest entry of that factor: the
    entries of L are ~1/nb of U's, so one limit for both would pass a zero
    L.  U's largest entry is its diagonal (~nb for randn + nb I), so the
    off-diagonal entries are held by the reconstruction: LU - A, the product
    taken in f64, within 3 nb eps |L||U| elementwise.  That is the backward
    error bound of an LU in any summation order (gamma_nb, unit roundoff
    eps / 2) plus the check's own product, with room; a factor with L zero
    or off by 1e-3 relative fails it.  Returns the readings and limits."""
    nb = a.shape[-1]
    lo_k, lo_p, up_k, up_p = lk.tril(-1), lp.tril(-1), lk.triu(), lp.triu()
    lmax, umax = float(lo_p.abs().max()), float(up_p.abs().max())
    l64 = lk.double().tril(-1) + torch.eye(nb, dtype=torch.float64, device=lk.device)
    u64 = lk.double().triu()
    res = (l64 @ u64 - a.double()).abs()
    bound = 3 * nb * eps * (l64.abs() @ u64.abs())
    ratio = torch.nan_to_num(res / bound, nan=0.0, posinf=float("inf"))  # 0/0: exact
    return {"err_L": float((lo_k - lo_p).abs().max()), "tol_L": 100 * nb * eps * lmax,
            "max_abs_L": lmax, "err_U": float((up_k - up_p).abs().max()),
            "tol_U": 100 * nb * eps * umax, "max_abs_U": umax,
            "rec_ratio": float(ratio.max()), "rec_rel_limit": 3 * nb * eps}


def lu_factor_ok(c):
    """Each limit separates a wrong factor (below 1e-2 of what it holds)
    and each reading is within its limit."""
    return (c["tol_L"] < 1e-2 * c["max_abs_L"] and c["tol_U"] < 1e-2 * c["max_abs_U"]
            and c["rec_rel_limit"] < 1e-2 and c["err_L"] < c["tol_L"] and c["err_U"] < c["tol_U"]
            and c["rec_ratio"] <= 1)


def kernel_lu_panel_phase(dtype, kernels, local_view, torch):
    """lu_panel_tiles (the owning column's p x mtl tiles of the mesh LU's
    bucket-0 view) and lu_rowsolve_tiles (the owning row's q x ntl tiles)
    against their twins, strided as the driver slices them."""
    name = dname(dtype)
    eps = torch.finfo(dtype).eps
    n = MESH_N[name]
    t, loc = mesh_tiles(n, dtype, SEED + 61, torch, local_view)
    pcol = loc[:, 1:2, :, 1]  # (p, 1, mtl, nb, nb)
    prow = loc[1:2, :, 2]  # (1, q, ntl, nb, nb)
    dtile = lu_block(NB, dtype, SEED + 62, torch)
    lk, sk = kernels.lu_panel_tiles(dtile, pcol)
    rk = kernels.lu_rowsolve_tiles(lk, prow)
    torch.cuda.synchronize()
    lp, sp = kernels.lu_panel_tiles_plain(dtile, pcol)
    rp = kernels.lu_rowsolve_tiles_plain(lk, prow)
    # the U^-1 and unit-L^-1 the kernels solved with: each kernel applied to
    # the identity (I U^-1 and L^-1 I are exact for finite inverses)
    eye = torch.eye(NB, dtype=dtype, device="cuda")[None]
    uk, linvk = kernels.lu_panel_tiles(dtile, eye)[1][0], kernels.lu_rowsolve_tiles(lk, eye)[0]
    _, up = kernels.lu_diag_inv_plain(dtile)
    linvp = kernels.unit_linv_plain(lk)
    fac = lu_factor_check(dtile, lk, lp, eps, torch)
    # solved tiles: solve_tol, which must separate a wrong output from the
    # largest solved value
    tol_s = solve_tol(pcol, uk, up, eps, left=False)
    tol_r = solve_tol(prow, linvk, linvp, eps, left=True)
    smax, rmax = float(sp.abs().max()), float(rp.abs().max())
    err_l = max(fac["err_L"], fac["err_U"])
    err_s = float((sk - sp).abs().max())
    err_r = float((rk - rp).abs().max())
    check(bool(torch.isfinite(sk).all()) and bool(torch.isfinite(rk).all()),
          f"LU panel kernels {name}: non-finite output")
    check(tol_s < 1e-2 * smax and tol_r < 1e-2 * rmax,
          f"LU panel kernels {name}: tolerances {tol_s}, {tol_r} do not separate a wrong output "
          f"from max|solved| {smax}, {rmax}")
    check(lu_factor_ok(fac), f"lu_panel_tiles {name}: packed L\\U {fac}")
    check(err_s < tol_s, f"lu_panel_tiles {name}: |dS| {err_s} (tol {tol_s})")
    check(err_r < tol_r, f"lu_rowsolve_tiles {name}: |dS| {err_r} (tol {tol_r})")
    isz = dtile.element_size()
    rows = []
    for kname, run, plain, library, err, tiles, flops, nbytes, replaces in (
            ("lu_panel_tiles", lambda: kernels.lu_panel_tiles(dtile, pcol),
             lambda: kernels.lu_panel_tiles_plain(dtile, pcol),
             lambda: torch.linalg.solve_triangular(
                 torch.linalg.lu_factor_ex(dtile, pivot=False)[0].triu(), pcol, upper=True,
                 left=False),
             max(err_l, err_s), pcol,
             # factor 2 nb^3 / 3 + U^-1 nb^3 / 3, then one product with the
             # triangular U^-1 per tile, nb^3
             NB ** 3 + NB ** 3 * pcol.shape[0] * pcol.shape[2],
             # the block read, L\U written, each tile read and written once
             (2 * NB * NB + 2 * pcol.shape[0] * pcol.shape[2] * NB * NB) * isz,
             "slate_tpu/ops/pallas_ops.py:543"),
            ("lu_rowsolve_tiles", lambda: kernels.lu_rowsolve_tiles(lk, prow),
             lambda: kernels.lu_rowsolve_tiles_plain(lk, prow),
             lambda: torch.linalg.solve_triangular(lk, prow, upper=False, left=True,
                                                   unitriangular=True),
             err_r, prow,
             # unit-L^-1 nb^3 / 3, then one triangular product per tile, nb^3
             NB ** 3 / 3 + NB ** 3 * prow.shape[1] * prow.shape[2],
             # the strict lower triangle read, each tile read and written once
             (NB * (NB - 1) // 2 + 2 * prow.shape[1] * prow.shape[2] * NB * NB) * isz,
             "slate_tpu/ops/pallas_ops.py:590")):
        ms = cuda_ms(run, 20, torch)
        plain_ms = cuda_ms(plain, 2, torch)
        library_ms = cuda_ms(library, 20, torch)
        row = row_of(kname, dtype, "slate_tpu_torch/csrc/lu_diag_inv.cu", replaces, err, ms,
                     plain_ms, library_ms, nbytes, flops)
        rows.append(row)
        emit({"phase": f"kernel_{kname}_{name}", "tiles": list(tiles.shape),
              "err_solved": err_s if kname == "lu_panel_tiles" else err_r,
              "tol_solved": tol_s if kname == "lu_panel_tiles" else tol_r,
              "max_abs_solved": smax if kname == "lu_panel_tiles" else rmax,
              **(fac if kname == "lu_panel_tiles" else {}), "kernel_ms": ms,
              "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": row["bound_ms"],
              "bound_by": row["bound_by"]})
    del t, loc, pcol, prow
    torch.cuda.empty_cache()
    return rows


LU_KERNELS = ("lu_panel_tiles", "lu_rowsolve_tiles", "lu_trailing_update")
MESH_LU_N = {("nopiv", "float32"): 32768, ("nopiv", "float64"): 16384,
             ("pp", "float32"): 32768, ("pp", "float64"): 16384,
             ("tntpiv", "float32"): 8192}
WARMUP_N = 2048


def expected_lu_launches(form, nt, la, bucket_plan):
    """Launches of one LU factor, derived from its loop.  No pivoting: one
    panel column and one panel row per step; per bucket of s steps, s bulk
    updates at lookahead 0, and at lookahead >= 1 s - 1 narrow refreshes
    of two launches (column and row; the first step carries no update),
    s - 1 bulk updates and the drain.  Tournament: nt panels and rows, the
    update pinned to the matmul form.  Partial pivot: nt panel rows only
    (its column factor is torch ops)."""
    if form == "pp":
        return {"lu_panel_tiles": 0, "lu_rowsolve_tiles": nt, "lu_trailing_update": 0}
    if form == "tntpiv":
        return {"lu_panel_tiles": nt, "lu_rowsolve_tiles": nt, "lu_trailing_update": 0}
    trailing = 0
    for k0, k1, _, _ in bucket_plan(nt, P, Q):
        s = k1 - k0
        trailing += (3 * s - 2) if la >= 1 else s
    return {"lu_panel_tiles": nt, "lu_rowsolve_tiles": nt, "lu_trailing_update": trailing}


def omega(a, x, b, torch, rows=4096):
    """Componentwise backward error (Oettli-Prager) max_i |AX - B|_i /
    (|A||X| + |B|)_i, the residual taken in f64 over blocks of rows, so the
    check adds no rounding of its size.  A right-sized but wrong X reads
    ~1/sqrt(n) or more (the operand's own scale cancels out)."""
    x64, w = x.double(), 0.0
    for r0 in range(0, a.shape[0], rows):
        a64, b64 = a[r0:r0 + rows].double(), b[r0:r0 + rows].double()
        r = (a64 @ x64 - b64).abs()
        w = max(w, float((r / (a64.abs() @ x64.abs() + b64.abs())).max()))
    return w


def omega_gate(n, dtype, torch):
    """The tighter gate on the LU solves: 10 sqrt(n) eps.  The n-term sums
    of a backward-stable factor and solve round as a random walk (sqrt(n)
    eps), with a factor 10 for pivot growth; a wrong X of the right size
    reads ~1/sqrt(n) or more, >= 100x the gate at n = 32768."""
    return 10 * math.sqrt(n) * torch.finfo(dtype).eps


def lu_matrix(form, n, dtype, seed, torch):
    """uniform[-1, 1), plus n I for the no-pivot solve, made on the device."""
    a = torch.rand((n, n), generator=torch.Generator(device="cuda").manual_seed(seed),
                   dtype=dtype, device="cuda")
    a.mul_(2).sub_(1)
    if form == "nopiv":
        a.diagonal().add_(n)
    return a


def mesh_lu_phase(form, dtype, kernels, mp, bucket_plan, torch):
    """getrf_*_mesh -> permute_rows_dist -> two trsm_dist (the gesv_*_mesh
    solve, timed step by step) on a virtual 2 x 4 mesh, after a warm-up
    gesv_*_mesh at n = 2048; then the backward error of the solution."""
    from slate_tpu_torch.types import Diag, Op, Option, Uplo

    name = dname(dtype)
    n = MESH_LU_N[(form, name)]
    mesh = mp.make_mesh(P, Q, device="cuda")
    opts = {Option.MixedPrecision: "off"}
    getrf = {"nopiv": mp.getrf_nopiv_mesh, "pp": mp.getrf_mesh, "tntpiv": mp.getrf_tntpiv_mesh}[form]
    gesv = {"nopiv": mp.gesv_nopiv_mesh, "pp": mp.gesv_mesh, "tntpiv": mp.gesv_tntpiv_mesh}[form]
    aw = lu_matrix(form, WARMUP_N, dtype, SEED + 70, torch)
    xw, infow = gesv(aw, aw[:, :NRHS].clone(), mesh, NB, opts=opts)  # handles, allocator, kernel loads
    check(int(infow) == 0 and bool(torch.isfinite(xw).all()), f"mesh {form} {name}: warm-up failed")
    del aw, xw
    a = lu_matrix(form, n, dtype, SEED + 71, torch)
    b = randn((n, NRHS), dtype, SEED + 72, torch)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    split = {}
    t0 = t = time.perf_counter()

    def mark(step):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        split[step] = now - t
        t = now

    out = getrf(a, mesh, NB, opts=opts)
    mark("getrf")
    lu, info = out[0], out[-1]
    bd = mp.from_dense(b, mesh, NB)
    if form != "nopiv":
        bd = mp.permute_rows_dist(bd, out[1])
    mark("from_dense_permute")
    y = mp.trsm_dist(lu, bd, Uplo.Lower, Op.NoTrans, Diag.Unit)
    mark("trsm_dist_lower")
    x = mp.to_dense(mp.trsm_dist(lu, y, Uplo.Upper, Op.NoTrans))
    mark("trsm_dist_upper")
    seconds = time.perf_counter() - t0
    counts = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    del lu, y, bd, out
    e = eta(a, x, b, torch)
    gate = 100 * n * torch.finfo(dtype).eps
    w, w_gate = omega(a, x, b, torch), omega_gate(n, dtype, torch)
    nt = n // NB
    want = expected_lu_launches(form, nt, 1, bucket_plan)
    emit({"phase": f"mesh_gesv_{form}_{name}", "n": n, "nrhs": NRHS, "nb": NB, "grid": [P, Q],
          "info": int(info), "eta": e, "eta_gate": gate, "omega": w, "omega_gate": w_gate,
          "launches": counts,
          "expected_launches": want, "solve_seconds": seconds, "split_seconds": split,
          "peak_mem_bytes": peak, "x_finite": bool(torch.isfinite(x).all())})
    check(int(info) == 0, f"mesh {form} {name}: info {int(info)}")
    check(e < gate, f"mesh {form} {name}: eta {e} >= {gate}")
    check(w < w_gate, f"mesh {form} {name}: omega {w} >= {w_gate}")
    check(tuple(x.shape) == (n, NRHS) and bool(torch.isfinite(x).all()),
          f"mesh {form} {name}: bad solution")
    for k, v in want.items():
        check(counts[k] == v, f"mesh {form} {name}: {counts[k]} {k} launches, expected {v}")
    del a, b, x
    torch.cuda.empty_cache()
    return counts


def lu_invariants_phase(mp, torch):
    """No pivoting and partial pivoting: bitwise across lookahead 0/1/2 and
    the psum/ring/doubling lowerings (the whole solve), and a zero column
    j giving info j + 1."""
    from slate_tpu_torch.types import Option

    n = INVARIANT_N
    mesh = mp.make_mesh(P, Q, device="cuda")
    b = randn((n, NRHS), torch.float32, SEED + 81, torch)
    out = {"phase": "lu_invariants", "n": n}
    ok = True
    for form, gesv, getrf in (("nopiv", mp.gesv_nopiv_mesh, mp.getrf_nopiv_mesh),
                              ("pp", mp.gesv_mesh, mp.getrf_mesh)):
        a = lu_matrix(form, n, torch.float32, SEED + 80, torch)
        runs = {}
        for la in (0, 1, 2):
            runs[f"lookahead{la}"] = gesv(a, b, mesh, NB, opts={Option.Lookahead: la})[0]
        for impl in ("psum", "ring", "doubling"):
            runs[f"bcast_{impl}"] = gesv(a, b, mesh, NB, opts={Option.BcastImpl: impl})[0]
        base = runs["lookahead1"]
        equal = {k: bool(torch.equal(v, base)) for k, v in runs.items()}
        j = 9 * NB + 77
        a[:, j] = 0
        info = int(getrf(a, mesh, NB)[-1])
        out[form] = {"bitwise_equal": equal, "zero_column": j, "info": info,
                     "expected_info": j + 1}
        ok = ok and all(equal.values()) and info == j + 1
        del a, runs
        torch.cuda.empty_cache()
    emit(out)
    check(ok, f"LU invariants failed: {out}")


def dryrun_phase():
    from slate_tpu_torch.parallel import dryrun

    res = dryrun.dryrun("cuda")
    emit({"phase": "dryrun", **res})
    check(res["ok"], f"dryrun failed: {res['phases']}")


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
    from slate_tpu_torch import parallel as mp
    from slate_tpu_torch.parallel.comm import bucket_plan, local_indices
    from slate_tpu_torch.parallel.dryrun import posv_chain

    # 1. card
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else ""
    check(smi_line, f"nvidia-smi failed: {smi.stderr.strip()}")
    emit({"phase": "card", "device": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi_line, "torch": torch.__version__, "cuda": torch.version.cuda})
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 residual products (the default)

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    names = sorted(f[:-3] for f in os.listdir(_build.CSRC_DIR) if f.endswith(".cu"))
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.load, names))
    emit({"phase": "build", "sources": names, "seconds": time.perf_counter() - t0})

    # 3. kernel vs twin
    rows = [kernel_phase(dt, kernels, torch) for dt in (torch.float32, torch.float64)]
    # 4-5. the single-chip path
    for row, dt in zip(rows, (torch.float32, torch.float64)):
        row["launches"] = posv_phase(dt, kernels, posv_array, torch)
    # 6-7. small reference solve, non-SPD info codes
    small_phase(torch)
    non_spd_phase(kernels, potrf_array, torch)

    # 8. the mesh kernels vs their twins
    mesh_rows = {}
    for dt in (torch.float32, torch.float64):
        mesh_rows[("chol_panel_tiles", dt)] = kernel_panel_phase(dt, kernels, mp.local_view, torch)
        mesh_rows[("chol_trailing_update", dt)] = kernel_update_phase(
            "chol_trailing_update", dt, kernels, mp.local_view, local_indices, torch)
    mesh_rows[("summa_update", torch.float32)] = kernel_update_phase(
        "summa_update", torch.float32, kernels, mp.local_view, local_indices, torch)

    # 9-11. the mesh paths; every count is read right after its path
    counts = {dt: mesh_posv_phase(dt, kernels, mp, bucket_plan, torch)
              for dt in (torch.float32, torch.float64)}
    counts[torch.float32]["summa_update"] = mesh_gemm_phase(kernels, mp, torch)["summa_update"]
    for (name, dt), row in mesh_rows.items():
        row["launches"] = counts[dt][name]
        check(row["launches"], f"{row['name']}: no launch on its path")
    rows += list(mesh_rows.values())

    # 12. the LU kernels vs their twins
    lu_rows = {}
    for dt in (torch.float32, torch.float64):
        for row in kernel_lu_panel_phase(dt, kernels, mp.local_view, torch):
            lu_rows[(row["name"].split("[")[0], dt)] = row
        lu_rows[("lu_trailing_update", dt)] = kernel_update_phase(
            "lu_trailing_update", dt, kernels, mp.local_view, local_indices, torch)

    # 13-15. the mesh LU solves; every count is read right after its path.
    # The no-pivot solve reaches all three kernels; its counts go in the
    # kernels line
    lu_counts = {dt: mesh_lu_phase("nopiv", dt, kernels, mp, bucket_plan, torch)
                 for dt in (torch.float32, torch.float64)}
    for dt in (torch.float32, torch.float64):
        mesh_lu_phase("pp", dt, kernels, mp, bucket_plan, torch)
    mesh_lu_phase("tntpiv", torch.float32, kernels, mp, bucket_plan, torch)
    for (name, dt), row in lu_rows.items():
        row["launches"] = lu_counts[dt][name]
        check(row["launches"], f"{row['name']}: no launch on its path")
    rows += list(lu_rows.values())

    # 16-18. invariants and the dryrun
    mesh_invariants_phase(mp, posv_chain, torch)
    lu_invariants_phase(mp, torch)
    dryrun_phase()

    # 19. kernels line, card line, result
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
