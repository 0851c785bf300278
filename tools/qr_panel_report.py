"""Times of csrc/qr_panel.cu at the QR paths' shapes, for builds of the
kernel with extra compiler flags: A/B comparisons and per-phase profiles.

Each variant is csrc/qr_panel.cu compiled with the port's nvcc flags plus
its own -D flags (e.g. ``-DQR_PROFILE`` for the phase timings), loaded in turn in place of the
kernel, checked against the twin on one edge panel, and timed by CUDA events
(10 launches after a warm-up) at the gels leaf, the CAQR merge and the mesh
panel, f32 and f64, with one empty column exchange and one block barrier at
each grid (``kernels.qr_sync_ms``).  Variants run in the order given, then
in reverse, on one card.  A QR_PROFILE variant adds, per shape, the mean
over the launch's CTAs of the microseconds each phase took (clock64 at the
SM clock nvidia-smi reads).

Run on a card from the repository root::

    python3 tools/qr_panel_report.py base= prof=-DQR_PROFILE

One JSON line per build and per run; the last line names the card, its
power limit and SM clock.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from slate_tpu_torch.ops import _build, kernels  # noqa: E402
from slate_tpu_torch.utils import testing  # noqa: E402

# the QR_PROFILE slots that the kernel marks (csrc/qr_panel.cu, QR_MARK)
PHASES = {0: "start", 5: "column steps", 6: "block out", 7: "V_b^T products", 8: "barrier A",
          9: "Y = T_b^T P", 10: "barrier B", 11: "T rows", 12: "trailing update", 13: "block end"}
# (batch, m, w) at the paths' shapes: the gels leaf, the CAQR merge, the mesh panel
SHAPES = {"leaf": {torch.float32: (1, 32768, 64), torch.float64: (1, 16384, 64)},
          "merge": {torch.float32: (1, 512, 256), torch.float64: (1, 512, 256)},
          "mesh_panel": {torch.float32: (2, 16384, 256), torch.float64: (2, 8192, 256)}}


def emit(obj):
    print(json.dumps(obj), flush=True)


def build(item, out_dir):
    name, flags = item
    out = os.path.join(out_dir, f"qr_panel_{name}.so")
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, *flags, "-o", out, os.path.join(_build.CSRC_DIR, "qr_panel.cu")]
    p = subprocess.run(cmd, capture_output=True, text=True)
    log = p.stdout + p.stderr
    return name, p.returncode, out, [ln.strip() for ln in log.splitlines() if "spill" in ln], log[-2000:]


def use(path):
    _build._LOADED["qr_panel"] = ctypes.CDLL(path)
    kernels._QR_FNS.clear()
    kernels._QR_PLANS.clear()


def cuda_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def run(tag, a):
    if tag == "mesh_panel":
        return kernels.qr_panel_offset(a, [0] * a.shape[0])
    return kernels.qr_panel(a)


def main(argv):
    variants = dict(arg.split("=", 1) for arg in argv) or {"base": ""}
    variants = {k: v.split() for k, v in variants.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    sm_mhz = float(smi.split(",")[-1].split()[0])
    out_dir = tempfile.mkdtemp(prefix="qr_panel_report_")
    with ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(lambda it: build(it, out_dir), variants.items()))
    libs = {}
    for name, rc, path, spills, log in built:
        emit({"build": name, "flags": variants[name], "rc": rc, "spills": spills, "log": log if rc else ""})
        if rc == 0:
            libs[name] = path
    xs = {}
    for tag, by in SHAPES.items():
        for dt, (b, m, w) in by.items():
            g = torch.Generator(device="cuda").manual_seed(m + w)
            xs[(tag, dt)] = torch.randn((b, m, w), generator=g, dtype=dt, device="cuda")
    for name in list(libs) + list(reversed(list(libs))):
        use(libs[name])
        lib = _build._LOADED["qr_panel"]
        res = {"variant": name}
        for dt in (torch.float32, torch.float64):
            a = torch.from_numpy(testing.qr_edge_panel(1000, 100, "neg0", 7)).to(dt).cuda()
            c = testing.qr_panel_check(a, kernels.qr_panel(a), kernels.qr_panel_plain(a), False)
            res[f"check_ok_{str(dt)[6:]}"] = testing.qr_panel_ok(c)
        for (tag, dt), a in xs.items():
            key = f"{tag}_{str(dt)[6:]}"
            res[f"{key}_ms"] = cuda_ms(lambda: run(tag, a))
            res[f"{key}_exchange_us"] = 1e3 * kernels.qr_sync_ms(dt, *a.shape, "exchange", 500)
            res[f"{key}_barrier_us"] = 1e3 * kernels.qr_sync_ms(dt, *a.shape, "barrier", 500)
        if hasattr(lib, "qr_prof_read"):
            buf = np.zeros((1024, 16), dtype=np.int64)
            lib.qr_prof_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
            for (tag, dt), a in xs.items():
                lib.qr_prof_read(buf.ctypes.data, 1)
                run(tag, a)
                torch.cuda.synchronize()
                lib.qr_prof_read(buf.ctypes.data, 1)
                ctas = kernels._qr_plan(dt, *a.shape, a.device)[0] * a.shape[0]
                mean = buf[:ctas].mean(0)
                res[f"profile_us_{tag}_{str(dt)[6:]}"] = {PHASES[k]: round(float(mean[k]) / sm_mhz, 1)
                                                          for k in PHASES}
        emit(res)
    emit({"card": smi})


if __name__ == "__main__":
    main(sys.argv[1:])
