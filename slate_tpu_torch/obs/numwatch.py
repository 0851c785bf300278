"""numwatch: the num.* artifact CLI -- seeded numerics gauges, distributed
condition estimates and the mixed ladder's health routing on the mesh.

Counterpart of ``slate_tpu/obs/numwatch.py``, with its passes, keys and
report.  CLI::

    python -m slate_tpu_torch.obs.numwatch <op> [--n 48] [--nb 8] \\
        [--impl ring] [--out NUM.report.json] [--device cpu|cuda]
    python -m slate_tpu_torch.obs.numwatch --smoke [--out DIR] [--device cpu|cuda]

``<op>`` is one of lu / potrf / mixed / qr.  Each pass runs seeded inputs
(``utils.testing.generate``, the same values as ``slate_tpu``'s: the
Wilkinson growth matrix, a prescribed-spectrum ill-conditioned matrix, a
near-singular-diagonal SPD matrix) through the monitored drivers
(Option.NumMonitor=on) and writes a RunReport whose headline ``values``
carry ``slate_tpu``'s ``num.*`` keys:

- ``num.lu_growth_*``: the growth gauge; the Wilkinson input realizes the
  partial-pivot bound 2^(n-1) exactly;
- ``num.chol_margin_*`` / ``num.chol_diag_min_*``: the Schur-diagonal
  margin (the near-singular SPD input pins it at 1/cond);
- ``num.gecondest_*`` / ``num.pocondest_*``: the distributed estimates
  beside the single-chip ones (``*_match_rel``);
- ``num.routed_gmres`` / ``num.ir_iters_*`` / ``num.ir_history_len_*``:
  the ladder's health routing and the trajectory's shape;
- ``num.qr_orth_*`` / ``num.he2hb_orth_margin``: the orthogonality gauges,
  the fused geqrf's equal to the checkpointed chain's (a 0.0 key);
- ``num.*_runtime_*``: wall clock (machine-dependent: gate with
  ``--ignore 'num.*_runtime_*'``).

Everything but the runtime keys is a function of (matrix, schedule),
and the same under every Option.BcastImpl, which ``--smoke`` asserts
psum against ring.  The passes run on the card (``--device cuda``, the
default) or on the host (``--device cpu``); without a card and without
``--device cpu`` they raise.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time
from typing import Dict, Optional

NUM_OPS = ("lu", "potrf", "mixed", "qr")
CONDEST_PARITY_RTOL = 1e-6  # distributed vs single-chip probe sequences
MARGIN_RTOL = 1e-3  # seeded 1/cond margin reproduction

_N_DEFAULT = 48
_NB_DEFAULT = 8
_ART_DIR = os.path.join("artifacts", "obs_torch")


def _mesh_default(device: Optional[str] = None):
    """The 2 x 4 virtual mesh on the card, or on the host when asked."""
    import torch

    from ..parallel import make_mesh

    device = device or "cuda"
    if str(device).startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("numwatch runs on the card by default and no CUDA device is "
                           "available; pass device='cpu' (--device cpu) for a host run")
    return make_mesh(2, 4, device=device)


def _dist(a, mesh, nb, pad=True):
    import torch

    from ..parallel.dist import from_dense

    return from_dense(torch.as_tensor(a, device=mesh.device), mesh, nb, diag_pad_one=pad)


def _run_lu(n, nb, mesh, impl) -> Dict[str, float]:
    """The monitored partial-pivot and no-pivot growth gauges, and the
    distributed general condition estimate beside the single-chip one."""
    import torch

    from ..linalg.lu import getrf_array
    from ..linalg.norms import gecondest
    from ..ops.tile_ops import genorm
    from ..parallel.dist_aux import gecondest_dist, norm_dist
    from ..parallel.dist_lu import getrf_nopiv_dist, getrf_pp_dist
    from ..types import Norm
    from ..utils.testing import generate
    from . import numerics

    vals: Dict[str, float] = {}
    w = generate("wilkinson", n)
    _lu, _perm, info = getrf_pp_dist(_dist(w, mesh, nb), bcast_impl=impl, num_monitor="on")
    assert int(info) == 0
    vals["num.lu_growth_wilkinson"] = numerics.last_gauges("getrf_pp")["growth"]
    d = generate("dominant", n, seed=1)
    _lu2, info2 = getrf_nopiv_dist(_dist(d, mesh, nb), bcast_impl=impl, num_monitor="on")
    assert int(info2) == 0
    vals["num.lu_growth_dominant"] = numerics.last_gauges("getrf_nopiv")["growth"]

    g = generate("svd", n, seed=2, cond=1e6)
    lu, perm, info3 = getrf_pp_dist(_dist(g, mesh, nb), bcast_impl=impl)
    assert int(info3) == 0
    anorm = norm_dist(Norm.One, _dist(g, mesh, nb, pad=False))
    rc_d = float(gecondest_dist(lu, perm, anorm, bcast_impl=impl))
    gt = torch.as_tensor(g, device=mesh.device)
    rc_s = float(gecondest(Norm.One, getrf_array(gt), genorm(Norm.One, gt)))
    vals["num.gecondest_cond"] = 1.0 / rc_d
    vals["num.gecondest_match_rel"] = abs(rc_d - rc_s) / rc_s
    return vals


def _run_potrf(n, nb, mesh, impl) -> Dict[str, float]:
    """The monitored Cholesky margins (benign and seeded near-breakdown)
    and the distributed SPD condition estimate beside the single-chip
    one."""
    import torch

    from ..linalg.chol import potrf_array
    from ..linalg.norms import pocondest
    from ..ops.tile_ops import genorm
    from ..parallel.dist_aux import norm_dist, pocondest_dist
    from ..parallel.dist_chol import potrf_dist
    from ..types import Norm, Uplo
    from ..utils.testing import generate
    from . import numerics

    vals: Dict[str, float] = {}
    well = generate("spd", n, seed=3)
    _l, info = potrf_dist(_dist(well, mesh, nb), bcast_impl=impl, num_monitor="on")
    assert int(info) == 0
    vals["num.chol_margin_well"] = numerics.last_gauges("potrf")["margin"]
    near = generate("spd_neardiag", n, seed=4, cond=1e8)
    _l2, info2 = potrf_dist(_dist(near, mesh, nb), bcast_impl=impl, num_monitor="on")
    assert int(info2) == 0
    gn = numerics.last_gauges("potrf")
    vals["num.chol_margin_near"] = gn["margin"]
    vals["num.chol_diag_min_near"] = gn["diag_min"]

    ill = generate("spd_svd", n, seed=5, cond=1e5)
    ld, info3 = potrf_dist(_dist(ill, mesh, nb), bcast_impl=impl)
    assert int(info3) == 0
    anorm = norm_dist(Norm.One, _dist(ill, mesh, nb, pad=False))
    rc_d = float(pocondest_dist(ld, anorm, bcast_impl=impl))
    it = torch.as_tensor(ill, device=mesh.device)
    f, _ = potrf_array(it, Uplo.Lower)
    rc_s = float(pocondest(Norm.One, f, genorm(Norm.One, it)))
    vals["num.pocondest_cond"] = 1.0 / rc_d
    vals["num.pocondest_match_rel"] = abs(rc_d - rc_s) / rc_s
    return vals


def _run_mixed(n, nb, mesh, impl) -> Dict[str, float]:
    """The health-routed ladder end to end: a cond-1e8 input routes to
    GMRES-IR on its measured condition estimate, a healthy one converges
    in IR with its trajectory exported."""
    import numpy as np
    import torch

    from ..parallel.drivers import gesv_mesh
    from ..types import Option
    from ..utils.testing import generate
    from . import numerics
    from .metrics import REGISTRY

    rng = np.random.default_rng(6)
    b = rng.standard_normal((n, 2))
    bt = torch.as_tensor(b, device=mesh.device)
    opts = {Option.NumMonitor: "on", Option.BcastImpl: impl}
    vals: Dict[str, float] = {}

    ill = generate("svd", n, seed=7, cond=1e8)
    routed0 = REGISTRY.counter_value("num.routed_gmres", op="gesv")
    x, info = gesv_mesh(torch.as_tensor(ill, device=mesh.device), bt, mesh, nb, opts=opts)
    assert int(info) == 0
    vals["num.routed_gmres"] = REGISTRY.counter_value("num.routed_gmres", op="gesv") - routed0
    vals["num.condest_cond"] = numerics.last_gauges("gesv").get("cond", 0.0)
    xn = x.cpu().numpy()
    r = b - ill @ xn
    scale = np.abs(ill).sum(axis=1).max() * max(np.abs(xn).max(), 1e-300)
    vals["num.mixed_ill_rel_resid"] = float(np.abs(r).max() / scale)

    wellm = generate("dominant", n, seed=8)
    _x2, info2 = gesv_mesh(torch.as_tensor(wellm, device=mesh.device), bt, mesh, nb, opts=opts)
    assert int(info2) == 0
    hist = numerics.last_history("gesv")
    vals["num.ir_history_len_well"] = float(len(hist))
    vals["num.ir_iters_well"] = max(float(len(hist)) - 1, 0.0)
    if len(hist) >= 2:
        vals["num.ir_history_drop_well"] = hist[0][0] / max(hist[-1][0], 1e-300)
    for gauge in REGISTRY.snapshot().get("gauges", []):
        if gauge["name"] == "ft.online_disc":
            vals["num.ft_online_disc"] = float(gauge["value"])
    return vals


def _run_qr(n, nb, mesh, impl) -> Dict[str, float]:
    """The orthogonality gauges: the monitored geqrf beside its
    checkpointed chain on the same operand (bitwise equal: a 0.0 key), an
    ill-conditioned operand (finite, recorded), and he2hb's gauge."""
    import numpy as np

    from ..ft import ckpt
    from ..parallel.dist_qr import geqrf_dist
    from ..parallel.dist_twostage import he2hb_dist
    from ..utils.testing import generate
    from . import numerics

    vals: Dict[str, float] = {}
    rng = np.random.default_rng(9)
    a = rng.standard_normal((n, n))
    ad = _dist(a, mesh, nb, pad=False)
    geqrf_dist(ad, bcast_impl=impl, num_monitor="on")
    fused = numerics.last_gauges("geqrf")["qr_orth_loss"]
    vals["num.qr_orth_margin_fused"] = fused
    numerics.clear_last("geqrf")
    ckpt.geqrf_ckpt(ad, every=2, bcast_impl=impl, num_monitor="on")
    chained = numerics.last_gauges("geqrf")["qr_orth_loss"]
    vals["num.qr_orth_margin_ckpt"] = chained
    vals["num.qr_orth_fused_vs_ckpt_err"] = abs(fused - chained)

    ill = generate("svd", n, seed=10, cond=1e10)
    geqrf_dist(_dist(ill, mesh, nb, pad=False), bcast_impl=impl, num_monitor="on")
    vals["num.qr_orth_margin_ill"] = numerics.last_gauges("geqrf")["qr_orth_loss"]

    spd = generate("spd", n, seed=11)
    he2hb_dist(_dist(spd, mesh, nb, pad=False), bcast_impl=impl, num_monitor="on")
    vals["num.he2hb_orth_margin"] = numerics.last_gauges("he2hb")["he2hb_orth_loss"]
    return vals


_RUNNERS = {"lu": _run_lu, "potrf": _run_potrf, "mixed": _run_mixed, "qr": _run_qr}


def run_numwatch(op: str, n: int = _N_DEFAULT, nb: int = _NB_DEFAULT,
                 bcast_impl: str = "ring", mesh=None, device: Optional[str] = None) -> dict:
    """One numwatch pass on ``mesh`` (default: the 2 x 4 mesh on
    ``device``, the card unless ``"cpu"``).  Returns the RunReport dict;
    every non-runtime ``num.*`` value is reproducible at fixed (n, nb,
    grid)."""
    from ..parallel.mesh import mesh_shape
    from . import report

    if op not in _RUNNERS:
        raise ValueError(f"unknown numwatch op {op!r}; expected {NUM_OPS}")
    if mesh is None:
        mesh = _mesh_default(device)
    p, q = mesh_shape(mesh)
    t0 = time.perf_counter()
    values = _RUNNERS[op](n, nb, mesh, bcast_impl)
    values[f"num.{op}_runtime_wall_s"] = time.perf_counter() - t0
    rep = report.make_report(
        f"numwatch_{op}",
        config={"op": op, "n": n, "nb": nb, "grid": f"{p}x{q}", "bcast_impl": bcast_impl,
                "device": str(mesh.device)},
        values=values,
        include_spans=False,
    )
    # the gauges live only in the headline num.* keys; the process-wide num
    # section (whatever else this process monitored) would re-enter the
    # gate as un-ignorable num_* keys, so a numwatch report carries it empty
    rep["num"] = {}
    return rep


def write_num_report(path: str, rep: dict) -> str:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(rep, f, indent=1)
    return path


def _smoke_checks(op: str, n: int, vals: Dict[str, float], out_dir: str) -> list:
    """The acceptance bounds of one pass (``slate_tpu``'s)."""
    from . import numerics, perfetto

    failures = []
    if op == "lu":
        grow = vals["num.lu_growth_wilkinson"]
        if grow != 2.0 ** (n - 1):
            failures.append(f"lu: Wilkinson growth {grow:.6g} != closed-form 2^{n - 1}")
        if grow <= numerics.GROWTH_THRESHOLD:
            failures.append(f"lu: Wilkinson growth {grow:.3g} did not trip the alarm threshold")
        if vals["num.lu_growth_dominant"] > 4.0:
            failures.append(f"lu: benign growth {vals['num.lu_growth_dominant']:.3g} > 4")
        if vals["num.gecondest_match_rel"] > CONDEST_PARITY_RTOL:
            failures.append(f"lu: distributed gecondest off single-chip by "
                            f"{vals['num.gecondest_match_rel']:.2e}")
    if op == "potrf":
        near = vals["num.chol_margin_near"]
        if abs(near - 1e-8) > MARGIN_RTOL * 1e-8:
            failures.append(f"potrf: seeded near-breakdown margin {near:.6g} != 1/cond = 1e-8")
        if vals["num.pocondest_match_rel"] > CONDEST_PARITY_RTOL:
            failures.append(f"potrf: distributed pocondest off single-chip by "
                            f"{vals['num.pocondest_match_rel']:.2e}")
    if op == "mixed":
        if vals["num.routed_gmres"] < 1:
            failures.append("mixed: the cond-1e8 input did not route to the GMRES tier")
        if vals["num.condest_cond"] <= numerics.CONDEST_THRESHOLD:
            failures.append(f"mixed: condest {vals['num.condest_cond']:.3g} under the threshold")
        if vals["num.ir_history_len_well"] < 1:
            failures.append("mixed: no IR trajectory exported for the healthy solve")
        hist = numerics.last_history("gesv")
        trace = perfetto.chrome_trace()
        trace["traceEvents"].extend(perfetto.numerics_counter_events(hist, op="gesv"))
        terrs = perfetto.validate_chrome_trace(trace)
        if terrs:
            failures.append(f"mixed: numerics trace invalid: {terrs[:3]}")
        if hist and not any(e.get("name") == "num.ir_rnorm[gesv]" for e in trace["traceEvents"]):
            failures.append("mixed: num.ir_rnorm counter track missing")
        with open(os.path.join(out_dir, "num_mixed.trace.json"), "w") as f:
            json.dump(trace, f, indent=1)
    if op == "qr":
        if vals["num.qr_orth_fused_vs_ckpt_err"] != 0.0:
            failures.append("qr: fused geqrf gauge differs from the checkpointed chain's")
        for key in ("num.qr_orth_margin_fused", "num.he2hb_orth_margin"):
            if not 0.0 < vals[key] < 1e-10:
                failures.append(f"qr: {key} = {vals[key]:.3g} outside (0, 1e-10)")
    return failures


def run_smoke(out_dir: str, device: Optional[str] = None, n: int = _N_DEFAULT,
              nb: int = _NB_DEFAULT) -> list:
    """All four passes under ring and psum: schema-valid reports, the
    acceptance bounds, gauges bitwise the same across the two lowerings,
    and ``--check`` passing an unchanged report while flagging a seeded 4x
    gauge regression.  Returns the failures."""
    import contextlib
    import io

    from . import report

    os.makedirs(out_dir, exist_ok=True)
    failures = []
    mesh = _mesh_default(device)
    for op in NUM_OPS:
        rep = run_numwatch(op, n=n, nb=nb, bcast_impl="ring", mesh=mesh)
        errs = report.validate_report(rep)
        if errs:
            failures.append(f"{op} schema: {errs[:4]}")
        vals = rep["values"]
        failures += _smoke_checks(op, n, vals, out_dir)
        rep_psum = run_numwatch(op, n=n, nb=nb, bcast_impl="psum", mesh=mesh)
        for k, v in vals.items():
            if "_runtime_" not in k and rep_psum["values"].get(k) != v:
                failures.append(f"{op}: {k} differs across bcast impls (ring {v!r} vs psum "
                                f"{rep_psum['values'].get(k)!r})")
        path = write_num_report(os.path.join(out_dir, f"num_{op}.report.json"), rep)
        worse = copy.deepcopy(rep)
        for k in list(worse["values"]):
            if "growth" in k or "cond" in k or "orth_margin" in k:
                worse["values"][k] = worse["values"][k] * 4.0
        worse_path = os.path.join(out_dir, f"num_{op}.worse.json")
        with open(worse_path, "w") as f:
            json.dump(worse, f)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc_same = report.main(["--check", path, path, "--ignore", "num.*_runtime_*"])
            rc_worse = report.main(["--check", worse_path, path, "--ignore", "num.*_runtime_*",
                                    "--threshold", "2"])
        os.remove(worse_path)
        if rc_same != 0:
            failures.append(f"{op}: --check of an unchanged num report exited {rc_same}")
        if rc_worse != 1:
            failures.append(f"{op}: --check missed the seeded 4x gauge regression "
                            f"(exited {rc_worse})")
        headline = {k: v for k, v in sorted(vals.items()) if "_runtime_" not in k}
        print(f"obs.numwatch smoke: {op} ok: "
              + ", ".join(f"{k.split('num.', 1)[1]}={v:.4g}"
                          for k, v in list(headline.items())[:4]) + f" -> {path}")
    return failures


def _smoke(out_dir: str, device: Optional[str] = None) -> int:
    failures = run_smoke(out_dir, device)
    if failures:
        print(f"obs.numwatch smoke: FAILED with {len(failures)} problem(s):")
        for msg in failures:
            print(f"  FAIL {msg}")
        return 1
    print(f"obs.numwatch smoke: OK: reports in {out_dir}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m slate_tpu_torch.obs.numwatch",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("op", nargs="?", choices=NUM_OPS, help="numerics pass to run")
    ap.add_argument("--n", type=int, default=_N_DEFAULT)
    ap.add_argument("--nb", type=int, default=_NB_DEFAULT)
    ap.add_argument("--impl", default="ring", help="bcast impl (psum|ring|doubling|auto)")
    ap.add_argument("--out", default=None,
                    help=f"report path (default {_ART_DIR}/num_<op>.report.json; for --smoke: "
                         "the artifact directory)")
    ap.add_argument("--device", default="cuda", help="cuda (default, the card) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="acceptance run: the four passes, psum / ring bitwise, the seeded "
                         "regression gate")
    args = ap.parse_args(argv)
    if args.smoke:
        return _smoke(args.out or _ART_DIR, args.device)
    if not args.op:
        ap.error("give an op to run or --smoke")
    rep = run_numwatch(args.op, n=args.n, nb=args.nb, bcast_impl=args.impl, device=args.device)
    out = args.out or os.path.join(_ART_DIR, f"num_{args.op}.report.json")
    write_num_report(out, rep)
    for k, v in sorted(rep["values"].items()):
        print(f"  {k:<36} {v:.6g}")
    print(f"  wrote {out}")
    return 0


if __name__ == "__main__":
    # runpy loads this file as __main__; delegate to the canonical module
    # instance so that shared module state is single
    from slate_tpu_torch.obs import numwatch as _canonical

    sys.exit(_canonical.main())
