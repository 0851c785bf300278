"""The executable cache: one built program per request class.

Counterpart of ``slate_tpu/serve/cache.py``.  ``slate_tpu`` pins one jitted
program per ``CacheKey`` -- (op, shape signature, dtype, batch, mesh,
resolved Options) -- and counts its traces, so that steady-state traffic
re-traces nothing.  torch has no jit, so here the cache holds the built
callable (the stacked loop over the single verbs, ``serve.batch``), and the
``traces`` counter counts builds: one per key, at its first miss.
``slate_tpu``'s jit traces once per key on the same request stream, so the
two counts agree and ``assert_steady`` keeps its meaning: no new build in
steady state.  A key is also where a captured CUDA graph of its program
would live.

``slate_tpu``'s ``enable_persistent_compilation_cache`` (JAX's on-disk
compile cache) has no counterpart: the port's kernels persist in
``slate_tpu_torch/_build/`` already.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from .metrics import serve_count


class CacheKey(NamedTuple):
    """The request-class identity every built program is pinned to."""

    op: str            # driver name ("posv", "gesv", "gemm", "potrf", ...)
    shape: Tuple       # problem shape signature, e.g. ((8, 512, 512), (8, 512, 1))
    dtype: str         # operand dtype in slate_tpu's names ("float64", ...)
    batch: int         # stack depth B (1 = single problem)
    mesh: str          # mesh descriptor ("none" = the single-card stacked path)
    opts: Tuple        # sorted resolved-option items, e.g. (("bcast_impl", "ring"),)


def dtype_name(x) -> str:
    """``slate_tpu``'s dtype name of a tensor or dtype: ``"float64"``, never
    ``"torch.float64"`` (the tuned table and the cache keys are keyed on
    it)."""
    dt = x.dtype if isinstance(x, torch.Tensor) else x
    return str(dt).replace("torch.", "")


def options_signature(opts: Optional[Dict]) -> Tuple:
    """Canonical hashable form of a resolved Options mapping (enum keys and
    values collapse to their ``.value``; an unhashable value to its repr),
    sorted by key."""
    if not opts:
        return ()
    items = []
    for k, v in opts.items():
        vv = getattr(v, "value", v)
        try:
            hash(vv)
        except TypeError:
            vv = repr(vv)
        items.append((str(getattr(k, "value", k)), vv))
    return tuple(sorted(items, key=repr))


def mesh_signature(mesh) -> str:
    """``"none"`` without a mesh, else ``<device type>:<p>x<q>`` of the
    virtual mesh (``"cuda:2x4"``, ``"cpu:2x4"``)."""
    if mesh is None:
        return "none"
    return f"{mesh.device.type}:{mesh.p}x{mesh.q}"


def make_key(op: str, args: Tuple[torch.Tensor, ...], batch: int = 1, mesh=None,
             opts: Optional[Dict] = None) -> CacheKey:
    return CacheKey(
        op=op,
        shape=tuple(tuple(a.shape) for a in args),
        dtype=dtype_name(args[0]),
        batch=batch,
        mesh=mesh_signature(mesh),
        opts=options_signature(opts),
    )


class ExecutableCache:
    """Key -> pinned built program, with build ("trace") accounting."""

    def __init__(self) -> None:
        self._programs: Dict[CacheKey, Callable] = {}
        self._trace_counts: Dict[CacheKey, int] = {}
        self._pinned: set = set()

    def __len__(self) -> int:
        return len(self._programs)

    def contains(self, key: CacheKey) -> bool:
        """Pure membership probe (no counter side effects): the request
        tracer labels a lookup hit or miss with it before ``get_or_build``
        performs (and counts) the real lookup."""
        return key in self._programs

    def get_or_build(self, key: CacheKey, build: Callable[[], Callable]):
        """A hit returns the pinned program; a miss builds it with
        ``build()``, counts the build as the key's trace and pins it."""
        prog = self._programs.get(key)
        if prog is not None:
            serve_count("cache_hits")
            return prog
        serve_count("cache_misses")
        prog = build()
        self._trace_counts[key] = self._trace_counts.get(key, 0) + 1
        serve_count("traces")
        self._programs[key] = prog
        return prog

    def warmup(self, key: CacheKey, build: Callable[[], Callable], example_args: Tuple) -> None:
        """Build ``key`` ahead of traffic and run it once on representative
        operands (the kernels load and the allocator takes its blocks), so
        the first real request is a pure execution."""
        prog = self.get_or_build(key, build)
        out = prog(*example_args)
        first = out[0] if isinstance(out, tuple) else out
        if isinstance(first, torch.Tensor) and first.is_cuda:
            torch.cuda.synchronize(first.device)
        serve_count("warmups")
        self._pinned.add(key)

    def pin(self, key: CacheKey) -> None:
        self._pinned.add(key)

    def trace_count(self, key: CacheKey) -> int:
        return self._trace_counts.get(key, 0)

    def total_traces(self) -> int:
        return sum(self._trace_counts.values())

    def assert_steady(self, before: Optional[Dict[CacheKey, int]] = None) -> None:
        """Zero-rebuild assertion: every known key has been built at most
        once (or exactly its count in the ``before`` snapshot: take one with
        ``snapshot_traces`` after warm-up, run traffic, then assert)."""
        ref = before if before is not None else {}
        for key, count in self._trace_counts.items():
            want = ref.get(key, 1)
            if count > want:
                raise AssertionError(
                    f"serve cache retraced {key.op} {key.shape} {count - want} time(s) past "
                    "steady state -- the key is not capturing everything the program "
                    "depends on")

    def snapshot_traces(self) -> Dict[CacheKey, int]:
        return dict(self._trace_counts)

    def clear_unpinned(self) -> None:
        for key in list(self._programs):
            if key not in self._pinned:
                del self._programs[key]
                self._trace_counts.pop(key, None)

    def clear(self) -> None:
        self._programs.clear()
        self._trace_counts.clear()
        self._pinned.clear()


# The process-wide cache the Router and the smoke use; tests may build
# their own instances.
executable_cache = ExecutableCache()
