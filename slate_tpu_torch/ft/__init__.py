"""Algorithm-based fault tolerance (ABFT) for the distributed kernels.

Counterpart of ``slate_tpu/ft``: checksum-carrying variants of the mesh
kernels detect — and where the algebra allows, correct — silent
single-tile data corruption, in the style of Huang & Abraham (1984)
generalized to full factorizations by Du, Bosilca & Dongarra (PPoPP 2012).

- ``checksum``: tile-level row/column checksum encode / residual on the
  device, locate / threshold on the host.
- ``abft``: checksum-carrying SUMMA gemm (the hand-written
  ``csrc/ft_summa_update.cu`` step), mesh Cholesky, LU-nopiv, trsm and
  her2k / syr2k on the virtual mesh, with fault hooks at the panel / broadcast / trailing
  phases of every k-step, and the dense ``gemm_checked``.
- ``inject``: deterministic seeded fault plans (zero / scale /
  bitflip-style element perturbation of a chosen tile at a chosen k-step
  on a chosen mesh coordinate), transient (one-shot) or persistent.
- ``policy``: the per-op ``FtPolicy`` knob (off | detect | correct |
  recompute) plumbed as ``Option.FaultTolerance`` through
  ``parallel/drivers.py`` and ``api.py``, the structured ``FtError``, and
  the ``ft.*`` counters.
- ``python -m slate_tpu_torch.ft.smoke`` is the acceptance run: one
  injected fault per op class on the virtual 2 x 4 mesh.
- ``ckpt``: the checkpointed mesh k-loops (``potrf_ckpt``,
  ``getrf_nopiv_ckpt``, ``getrf_pp_ckpt``, ``geqrf_ckpt``, ``he2hb_ckpt``)
  as segment chains with host snapshots (``Checkpoint``), ``Preempted`` at
  an injected ``KillFault``; ``Option.Checkpoint`` in the mesh drivers.
- ``elastic``: ``resume`` a snapshot on the same or a reshaped mesh,
  ``reshard`` a live matrix.  ``python -m slate_tpu_torch.ft.ckpt_smoke``
  is their acceptance run.
"""

from .policy import (  # noqa: F401
    FtError,
    FtPolicy,
    FtReport,
    ft_counter_values,
    resolve_policy,
)
from .inject import (  # noqa: F401
    Fault,
    FaultPlan,
    KillFault,
    fault_scope,
    seeded_kill,
)
from .ckpt import (  # noqa: F401
    Checkpoint,
    Preempted,
    geqrf_ckpt,
    getrf_nopiv_ckpt,
    getrf_pp_ckpt,
    he2hb_ckpt,
    potrf_ckpt,
)
from .elastic import reshard, resumable, resume  # noqa: F401

__all__ = [
    "FtError",
    "FtPolicy",
    "FtReport",
    "ft_counter_values",
    "resolve_policy",
    "Fault",
    "FaultPlan",
    "KillFault",
    "fault_scope",
    "seeded_kill",
    "Checkpoint",
    "Preempted",
    "geqrf_ckpt",
    "getrf_nopiv_ckpt",
    "getrf_pp_ckpt",
    "he2hb_ckpt",
    "potrf_ckpt",
    "reshard",
    "resumable",
    "resume",
]
