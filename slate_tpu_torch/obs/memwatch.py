"""memwatch: the mem.* artifact CLI -- one traced call of a mesh kernel
beside the MemoryModel, and a sampled run.

Counterpart of ``slate_tpu/obs/memwatch.py``.  CLI::

    python -m slate_tpu_torch.obs.memwatch <op> [--n 96] [--nb 8] \\
        [--depth 1] [--impl ring] [--out MEM.report.json] [--device cpu|cuda]
    python -m slate_tpu_torch.obs.memwatch --smoke [--out DIR] [--device cpu|cuda]

``<op>`` is one of summa / potrf / getrf_nopiv / trsm / geqrf / he2hb.  The
report is a RunReport whose headline ``values`` carry the ``mem.*`` keys:

- ``mem.arg/out/temp/alias_bytes``: one call's traced bytes
  (``obs.memory.traced_memory``, the port's counterpart of XLA's
  compile-time buffer assignment): deterministic at a fixed shape and the
  same on the host and on the card, so they gate an extra-copy regression;
- ``mem.model_workspace/peak_bytes`` and ``mem.model_err_frac``: the
  MemoryModel's virtual-mesh terms beside the traced ones (the card holds
  every device of the 2 x 4 mesh);
- ``mem.*_runtime_*``: the live bytes and the allocator's peak of one
  sampled run and, on the card, the allocator's peak over the traced call
  above the bytes live before it (``..._alloc_peak_bytes``, beside the
  traced ``out + temp``): machine-dependent, gate with ``--ignore
  'mem.*_runtime_*'``.

``slate_tpu`` also reports ``mem.donation_*_alias_frac`` from its
``analysis/`` donation registry, which the port does not have yet: the
passes run without donations.  ``--smoke`` runs summa and potrf: valid
reports, the model within 10% of the traced ``temp``, ``--check`` passing
an unchanged report and flagging a seeded 2x ``mem.temp_bytes`` (summa,
whose traced temp is 0, a seeded 2x ``mem.peak_bytes``), and a
flight Gantt whose memory counter track validates.  The passes run on the
card (``--device cuda``, the default) or on the host (``--device cpu``);
without a card and without ``--device cpu`` they raise.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
from typing import Dict, Optional

MEM_OPS = ("summa", "potrf", "getrf_nopiv", "trsm", "geqrf", "he2hb")
MODEL_TOL = 0.10  # acceptance: modelled workspace within 10% of the traced temp

_ART_DIR = os.path.join("artifacts", "obs_torch")


def _mesh_default(device: Optional[str] = None):
    import torch

    from ..parallel import make_mesh

    device = device or "cuda"
    if str(device).startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("memwatch runs on the card by default and no CUDA device is "
                           "available; pass device='cpu' (--device cpu) for a host run")
    return make_mesh(2, 4, device=device)


def build_case(op: str, n: int, nb: int, mesh, depth: int, impl: str, seed: int = 0):
    """(fn over tile stacks, its tile-stack arguments) of one mesh kernel:
    the traced call, on :func:`_operands`' f32 operands."""
    from ..parallel.dist import DistMatrix, from_dense

    a, b = _operands(op, n, mesh, seed)
    if op == "summa":
        from ..parallel.summa import gemm_summa
        from ..types import MethodGemm

        ad, bd = from_dense(a, mesh, nb), from_dense(b, mesh, nb)

        def fn(at, bt):
            return gemm_summa(1.0, DistMatrix(tiles=at, m=n, n=n, nb=nb, mesh=mesh),
                              DistMatrix(tiles=bt, m=n, n=n, nb=nb, mesh=mesh),
                              method=MethodGemm.GemmC, lookahead=depth, bcast_impl=impl)

        return fn, (ad.tiles, bd.tiles)
    if op in ("potrf", "getrf_nopiv"):
        from ..parallel.dist_chol import potrf_dist
        from ..parallel.dist_lu import getrf_nopiv_dist

        drv = potrf_dist if op == "potrf" else getrf_nopiv_dist
        ad = from_dense(a, mesh, nb, diag_pad_one=True)

        def fn(at):
            return drv(DistMatrix(tiles=at, m=n, n=n, nb=nb, mesh=mesh, diag_pad=True),
                       lookahead=depth, bcast_impl=impl)

        return fn, (ad.tiles,)
    if op == "trsm":
        from ..parallel.dist_trsm import trsm_dist
        from ..types import MethodTrsm, Op, Uplo

        ad, bd = from_dense(a, mesh, nb, diag_pad_one=True), from_dense(b, mesh, nb)

        def fn(at, bt):
            return trsm_dist(DistMatrix(tiles=at, m=n, n=n, nb=nb, mesh=mesh, diag_pad=True),
                             DistMatrix(tiles=bt, m=n, n=n, nb=nb, mesh=mesh), Uplo.Lower,
                             Op.NoTrans, method=MethodTrsm.TrsmB, lookahead=depth,
                             bcast_impl=impl)

        return fn, (ad.tiles, bd.tiles)
    if op in ("geqrf", "he2hb"):
        from ..parallel.dist_qr import geqrf_dist
        from ..parallel.dist_twostage import he2hb_dist

        drv = geqrf_dist if op == "geqrf" else he2hb_dist
        ad = from_dense(a, mesh, nb)

        def fn(at):
            return drv(DistMatrix(tiles=at, m=n, n=n, nb=nb, mesh=mesh), bcast_impl=impl)

        return fn, (ad.tiles,)
    raise ValueError(f"unknown memwatch op {op!r}; expected {MEM_OPS}")


def _operands(op: str, n: int, mesh, seed: int):
    """The f32 operands of ``op``: a general A (SPD for potrf / he2hb,
    diagonally dominant for getrf_nopiv, lower triangular for trsm) and B.
    Host draws (numpy) up to n = 4096, card draws above."""
    import numpy as np
    import torch

    dev = mesh.device
    if n <= 4096:
        rng = np.random.default_rng(seed)
        a = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)).to(dev)
    else:
        g = torch.Generator(device=dev).manual_seed(seed)
        a = torch.randn((n, n), generator=g, device=dev, dtype=torch.float32)
        b = torch.randn((n, n), generator=g, device=dev, dtype=torch.float32)
    eye = torch.eye(n, dtype=a.dtype, device=dev)
    if op in ("potrf", "he2hb"):
        a = torch.addmm(eye, a, a.T, beta=2.0, alpha=1.0 / n)
    elif op == "getrf_nopiv":
        a = torch.tril(a) + n * eye + torch.triu(b, 1)
    elif op == "trsm":
        a = torch.tril(a) + n * eye
    return a, b


def run_memwatch(op: str, n: int = 96, nb: int = 8, depth: int = 1,
                 bcast_impl: str = "ring", mesh=None, device: Optional[str] = None,
                 with_runtime: bool = True) -> dict:
    """One memwatch pass: the traced call, the MemoryModel beside it and
    (``with_runtime``) one sampled run.  Returns the RunReport dict."""
    import torch

    from ..parallel.mesh import mesh_shape
    from . import memmodel, memory, report
    from . import span as _span

    if mesh is None:
        mesh = _mesh_default(device)
    p, q = mesh_shape(mesh)
    fn, args = build_case(op, n, nb, mesh, depth, bcast_impl)
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(mesh.device)
        torch.cuda.reset_peak_memory_stats(mesh.device)
        base = torch.cuda.memory_allocated(mesh.device)
    measured, out = memory.traced_memory(fn, *args)
    if cuda:
        # the caching allocator's peak over the same call, beside the tally
        # (it rounds each block up to 512 bytes and holds library workspaces)
        torch.cuda.synchronize(mesh.device)
        alloc_peak = float(torch.cuda.max_memory_allocated(mesh.device) - base)
    del out
    model = memmodel.MemoryModel(op, n, nb, (p, q), "float32", lookahead=depth,
                                 bcast_impl=bcast_impl)
    ws = model.virtual_workspace_bytes
    temp = measured["temp_bytes"]
    err = abs(ws - temp) / max(temp, 1.0) if temp or ws else 0.0
    values: Dict[str, float] = {
        "mem.arg_bytes": measured["arg_bytes"],
        "mem.out_bytes": measured["out_bytes"],
        "mem.temp_bytes": temp,
        "mem.alias_bytes": measured["alias_bytes"],
        "mem.peak_bytes": measured["peak_bytes"],
        "mem.model_workspace_bytes": float(ws),
        "mem.model_peak_bytes": float(model.virtual_peak_bytes),
        "mem.model_err_frac": err,
    }
    if cuda:
        values[f"mem.{op}_runtime_alloc_peak_bytes"] = alloc_peak
    if with_runtime:
        with _span.force_enabled(), memory.force_sampling():
            res = fn(*args)
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            s = memory.sample(f"memwatch_{op}")
            del res
        values[f"mem.{op}_runtime_live_bytes"] = s["live_bytes"]
        values[f"mem.{op}_runtime_peak_bytes_in_use"] = max(s["peak_bytes_in_use"].values(),
                                                            default=0.0)
    rep = report.make_report(
        f"memwatch_{op}",
        config={"op": op, "n": n, "nb": nb, "grid": f"{p}x{q}", "lookahead": depth,
                "bcast_impl": bcast_impl, "device": str(mesh.device)},
        values=values,
        include_spans=False,
    )
    # the machine-dependent numbers live only in the op-qualified
    # mem.*_runtime_* keys; the process-wide mem section would re-enter the
    # gate as un-ignorable mem_* keys, so a memwatch report carries it empty
    rep["mem"] = {}
    return rep


def write_mem_report(path: str, rep: dict) -> str:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(rep, f, indent=1)
    return path


def flight_memory_trace(mesh, n: int = 32, nb: int = 8, **flight_kw) -> dict:
    """A potrf flight with memory sampling forced on (``flight_kw`` to
    ``obs.flight.run_flight``), as a Perfetto trace with the memory counter
    track beside the Gantt."""
    from . import flight, memory, perfetto

    with memory.force_sampling():
        rep = flight.run_flight("potrf", n=n, nb=nb, depth=1, mesh=mesh, **flight_kw)
    return perfetto.flight_chrome_trace(rep["events"], rep["hop_events"], grid=(2, 4),
                                        mem_samples=rep["mem_samples"])


def run_smoke(out_dir: str, device: Optional[str] = None, n: int = 96, nb: int = 8) -> list:
    """summa and potrf: valid reports, the model within MODEL_TOL of the
    traced temp, ``--check`` passing an unchanged report and flagging a
    seeded 2x ``mem.temp_bytes``, then a flight Gantt whose memory counter
    track validates.  Returns the failures."""
    import contextlib
    import io

    from . import perfetto, report

    os.makedirs(out_dir, exist_ok=True)
    failures = []
    mesh = _mesh_default(device)
    for op in ("summa", "potrf"):
        rep = run_memwatch(op, n=n, nb=nb, depth=1, bcast_impl="ring", mesh=mesh)
        errs = report.validate_report(rep)
        if errs:
            failures.append(f"{op} schema: {errs[:4]}")
        vals = rep["values"]
        if op == "potrf" and vals["mem.temp_bytes"] <= 0:
            failures.append(f"{op}: temp bytes not positive")
        if vals["mem.model_err_frac"] > MODEL_TOL:
            failures.append(f"{op}: model workspace off by {vals['mem.model_err_frac']:.1%} "
                            f"(> {MODEL_TOL:.0%}): model {vals['mem.model_workspace_bytes']:,.0f}"
                            f" vs traced {vals['mem.temp_bytes']:,.0f}")
        path = write_mem_report(os.path.join(out_dir, f"mem_{op}.report.json"), rep)
        # the gate must trip on a seeded extra copy: an unchanged report
        # passes, a doubled traced temp fails.  summa makes no transient
        # bytes, and a zero cannot gate (--check skips a zero baseline, as
        # slate_tpu's), so its seed doubles the traced peak instead
        worse = copy.deepcopy(rep)
        key = "mem.temp_bytes" if vals["mem.temp_bytes"] > 0 else "mem.peak_bytes"
        worse["values"][key] = 2 * vals[key]
        worse_path = os.path.join(out_dir, f"mem_{op}.worse.json")
        with open(worse_path, "w") as f:
            json.dump(worse, f)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc_same = report.main(["--check", path, path, "--ignore", "mem.*_runtime_*"])
            rc_worse = report.main(["--check", worse_path, path, "--ignore", "mem.*_runtime_*"])
        os.remove(worse_path)
        if rc_same != 0:
            failures.append(f"{op}: --check of an unchanged mem report exited {rc_same}")
        if rc_worse != 1:
            failures.append(f"{op}: --check missed the seeded 2x {key} (exited {rc_worse})")
        print(f"obs.memwatch smoke: {op} ok: temp {vals['mem.temp_bytes']:,.0f} B, model err "
              f"{vals['mem.model_err_frac']:.1%} -> {path}")
    tr = flight_memory_trace(mesh)
    terrs = perfetto.validate_chrome_trace(tr)
    if terrs:
        failures.append(f"flight memory trace invalid: {terrs[:3]}")
    if not any(e.get("ph") == "C" and e.get("name", "").startswith("mem.")
               for e in tr["traceEvents"]):
        failures.append("flight trace has no memory counter track")
    with open(os.path.join(out_dir, "mem_flight_potrf.trace.json"), "w") as f:
        json.dump(tr, f)
    return failures


def _smoke(out_dir: str, device: Optional[str] = None) -> int:
    failures = run_smoke(out_dir, device)
    if failures:
        print(f"obs.memwatch smoke: FAILED with {len(failures)} problem(s):")
        for msg in failures:
            print(f"  FAIL {msg}")
        return 1
    print(f"obs.memwatch smoke: OK: reports in {out_dir}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m slate_tpu_torch.obs.memwatch",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("op", nargs="?", choices=MEM_OPS, help="mesh kernel to trace")
    ap.add_argument("--n", type=int, default=96)
    ap.add_argument("--nb", type=int, default=8)
    ap.add_argument("--depth", type=int, default=1)
    ap.add_argument("--impl", default="ring", help="bcast impl (psum|ring|doubling|auto)")
    ap.add_argument("--out", default=None,
                    help=f"report path (default {_ART_DIR}/mem_<op>.report.json; for --smoke: "
                         "the artifact directory)")
    ap.add_argument("--device", default="cuda", help="cuda (default, the card) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="acceptance run (summa + potrf at n = 96, nb = 8)")
    args = ap.parse_args(argv)
    if args.smoke:
        return _smoke(args.out or _ART_DIR, args.device)
    if not args.op:
        ap.error("give an op to trace or --smoke")
    rep = run_memwatch(args.op, n=args.n, nb=args.nb, depth=args.depth, bcast_impl=args.impl,
                       device=args.device)
    out = args.out or os.path.join(_ART_DIR, f"mem_{args.op}.report.json")
    write_mem_report(out, rep)
    v = rep["values"]
    print(f"memwatch {args.op}: arg {v['mem.arg_bytes']:,.0f}  out {v['mem.out_bytes']:,.0f}  "
          f"temp {v['mem.temp_bytes']:,.0f}  alias {v['mem.alias_bytes']:,.0f} B")
    print(f"  model workspace {v['mem.model_workspace_bytes']:,.0f} "
          f"(err {v['mem.model_err_frac']:.1%}), peak {v['mem.model_peak_bytes']:,.0f} B")
    print(f"  wrote {out}")
    return 0


if __name__ == "__main__":
    from slate_tpu_torch.obs import memwatch as _canonical

    sys.exit(_canonical.main())
