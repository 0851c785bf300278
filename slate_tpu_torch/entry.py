"""The port's entry point, mirroring ``__graft_entry__.entry``."""

from __future__ import annotations

import torch


def entry(device="cuda"):
    """(fn, example_args): the flagship forward step, an SPD solve (posv)
    at n = 1024, f32, 32 right-hand sides, operands from seeded
    generators on ``device``.  ``fn(a, b)`` returns (x, info)."""
    from .linalg.chol import posv_array

    n, nrhs = 1024, 32
    g = torch.randn((n, n), generator=torch.Generator(device=device).manual_seed(0),
                    dtype=torch.float32, device=device)
    a = g @ g.T + n * torch.eye(n, dtype=torch.float32, device=device)
    b = torch.randn((n, nrhs), generator=torch.Generator(device=device).manual_seed(1),
                    dtype=torch.float32, device=device)

    def fn(a, b):
        x, _, info = posv_array(a, b)
        return x, info

    return fn, (a, b)
