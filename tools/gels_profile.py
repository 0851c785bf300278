"""Where one single-chip least-squares solve spends the card's time:
``linalg.qr.gels_array`` (32 right-hand sides) under torch.profiler, the
device time summed by kernel name against the host clock of the call.

Run on a card from the repository root (chip_smoke.py's gels shape)::

    python3 tools/gels_profile.py [--m 32768] [--n 16384] [--dtype float32]

Prints the seconds of two timed calls after a warm-up at 2048 x 1024 (the
first meets each leaf shape's plan), then one JSON line: the profiled
call's wall seconds, its device seconds and the 20 largest device-time
entries (milliseconds, launches, name).
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from slate_tpu_torch.linalg import qr  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=32768)
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, args.dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn((args.m, args.n), generator=g, device="cuda", dtype=dt)
    b = torch.randn((args.m, 32), generator=g, device="cuda", dtype=dt)
    qr.gels_array(a[:2048, :1024].contiguous(), b[:2048].contiguous())
    torch.cuda.synchronize()
    for _ in range(2):
        t0 = time.perf_counter()
        qr.gels_array(a, b)
        torch.cuda.synchronize()
        print(json.dumps({"gels_seconds": time.perf_counter() - t0}), flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        qr.gels_array(a, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        ms = getattr(e, "self_device_time_total", 0) / 1e3
        if ms and e.device_type.name == "CUDA":
            rows.append((round(ms, 3), e.count, e.key[:80]))
    rows.sort(reverse=True)
    print(json.dumps({"wall_seconds": wall, "device_seconds": sum(r[0] for r in rows) / 1e3,
                      "top": rows[:20], "card": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
