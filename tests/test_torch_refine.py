"""The port's mixed-precision refinement (slate_tpu_torch.linalg.refine)
against slate_tpu.linalg.refine.

The same seeded numpy operands on the CPU, real and complex, one and
several right-hand sides.  Classic IR (``gesv_mixed_array``,
``posv_mixed_array``): the iteration count, the converged flag and info
equal to ``slate_tpu``'s, and the ``ir.*`` counter deltas equal (the
single-chip drivers bump none, in both packages); on an ill-conditioned
input (cond 1e9 in f64) the f32 factor cannot converge and both packages
take the fallback (iters -1).  GMRES-IR (both forms): the solution and the
worst residual norm, with a column whose right-hand side lies in an
invariant subspace (the Arnoldi process breaks down, the Hessenberg matrix
is rank-deficient and the least-squares step must take the minimum-norm
answer) beside a regular one.  Every converged x passes ``gate_cte``'s
gate ||b - A x||_inf <= ||x||_inf ||A||_inf eps sqrt(n); the two packages'
solutions agree to 10 n eps max|x|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu.linalg import refine as jref
from slate_tpu.types import Option as JOption
from slate_tpu.utils.testing import generate
from slate_tpu_torch.linalg import refine as tref
from slate_tpu_torch.ops.tile_ops import genorm
from slate_tpu_torch.types import Norm, Option

# the suite runs in several worker processes that share the cores: one
# intra-op thread each (torch defaults to one a core, which oversubscribes them)
torch.set_num_threads(1)

N = 48


def _eps(dtype):
    return float(np.finfo(dtype).eps)


def _passes_gate(a, x, b):
    """||b - A x||_inf <= ||x||_inf cte, cte = gate_cte(||A||_inf)."""
    ta, tx, tb = (torch.from_numpy(np.ascontiguousarray(v)) for v in (a, x, b))
    if tx.dim() == 1:
        tx, tb = tx[:, None], tb[:, None]
    cte = tref.gate_cte(genorm(Norm.Inf, ta), a.shape[0], ta.dtype)
    return bool(genorm(Norm.Inf, tb - ta @ tx) <= genorm(Norm.Inf, tx) * cte)


def _spd(n, dtype, seed):
    return generate("spd", n, dtype=dtype, seed=seed)


def _run(kind, a, b, jopts=None, topts=None):
    """Both packages' refined solve and their ir.* counter deltas."""
    jfn = {"gesv": jref.gesv_mixed_array, "posv": jref.posv_mixed_array}[kind]
    tfn = {"gesv": tref.gesv_mixed_array, "posv": tref.posv_mixed_array}[kind]
    j0, t0 = jref.ir_counter_values(), tref.ir_counter_values()
    jr = jfn(jnp.asarray(a), jnp.asarray(b), opts=jopts)
    tr = tfn(torch.from_numpy(a), torch.from_numpy(b), opts=topts)
    j1, t1 = jref.ir_counter_values(), tref.ir_counter_values()
    jd = {k: j1[k] - j0[k] for k in j1}
    td = {k: t1[k] - t0[k] for k in t1}
    return jr, tr, jd, td


@pytest.mark.parametrize("kind,dtype,nrhs", [
    ("gesv", np.float64, 1), ("gesv", np.complex128, 3),
    ("posv", np.float64, 3), ("posv", np.complex128, 1)])
def test_classic_ir_matches_jax(kind, dtype, nrhs):
    a = generate("rands", N, dtype=dtype, seed=2) if kind == "gesv" else _spd(N, dtype, 2)
    b = generate("rands", N, nrhs, dtype=dtype, seed=3)
    jr, tr, jd, td = _run(kind, a, b)
    assert int(tr.iters) == int(jr.iters) > 0
    assert bool(tr.converged) == bool(jr.converged) is True
    assert int(tr.info) == int(jr.info) == 0
    assert td == jd and set(td) == {"solves", "converged", "iters_total", "gmres_solves",
                                    "escalated_gmres", "fallback", "residual_gemm_bytes"}
    x = tr.x.numpy()
    assert _passes_gate(a, x, b)
    assert np.abs(x - np.asarray(jr.x)).max() <= 10 * N * _eps(dtype) * np.abs(x).max()


@pytest.mark.parametrize("kind", ["gesv", "posv"])
def test_ill_conditioned_input_takes_the_fallback(kind):
    """cond 1e9: the f32 factor's refinement cannot meet the f64 gate, and
    both packages fall back to the full f64 solve (iters -1, converged
    false, info 0); without the fallback both return the unconverged x
    after MaxIterations steps."""
    n = 40
    a = generate("svd", n, dtype=np.float64, seed=4, cond=1e9)
    if kind == "posv":
        a = a @ a.T + 1e-9 * np.eye(n)  # SPD, cond ~1e9 by the same spectrum squared
        a = (a + a.T) / 2
    b = generate("rands", n, 2, dtype=np.float64, seed=5)
    jr, tr, jd, td = _run(kind, a, b)
    assert int(tr.iters) == int(jr.iters) == -1
    assert bool(tr.converged) == bool(jr.converged) is False
    assert int(tr.info) == int(jr.info) == 0 and td == jd
    assert np.abs(tr.x.numpy() - np.asarray(jr.x)).max() <= 1e-6 * np.abs(np.asarray(jr.x)).max()
    jr, tr, jd, td = _run(kind, a, b, {JOption.UseFallbackSolver: False, JOption.MaxIterations: 4},
                          {Option.UseFallbackSolver: False, Option.MaxIterations: 4})
    assert int(tr.iters) == int(jr.iters) == 4
    assert bool(tr.converged) == bool(jr.converged) is False and td == jd


def _invariant_system(dtype):
    """A = diag(2 I_4, G) with G well conditioned: the f32 LU of A is exact
    on the first block, so for b = (1, 1, 1, 1, 0, ...) the preconditioned
    operator maps b's direction onto itself exactly and Arnoldi breaks
    down after one step (h = 0).  Column 1 is a regular right-hand side."""
    a = np.zeros((N, N), dtype=dtype)
    a[:4, :4] = 2 * np.eye(4)
    a[4:, 4:] = generate("rands", N - 4, dtype=dtype, seed=6) + 4 * np.eye(N - 4)
    b = np.zeros((N, 2), dtype=dtype)
    b[:4, 0] = 1
    b[:, 1] = generate("rands", N, 1, dtype=dtype, seed=7)[:, 0]
    return a, b


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_gesv_gmres_matches_jax_through_a_breakdown(dtype):
    a, b = _invariant_system(dtype)
    j0, t0 = jref.ir_counter_values(), tref.ir_counter_values()
    xj, rj = jref.gesv_mixed_gmres_array(jnp.asarray(a), jnp.asarray(b), restart=10)
    xt, rt = tref.gesv_mixed_gmres_array(torch.from_numpy(a), torch.from_numpy(b), restart=10)
    j1, t1 = jref.ir_counter_values(), tref.ir_counter_values()
    assert {k: t1[k] - t0[k] for k in t1} == {k: j1[k] - j0[k] for k in j1}
    xt = xt.numpy()
    np.testing.assert_array_equal(xt[:, 0], np.asarray(xj)[:, 0])  # the exact min-norm step
    np.testing.assert_array_equal(xt[:4, 0], 0.5)
    assert np.abs(xt - np.asarray(xj)).max() <= 10 * N * _eps(dtype) * np.abs(xt).max()
    # the worst column stalls at rounding level, a few times its tolerance
    # sqrt(n) eps ||b||, in both packages
    stall = 1e3 * np.sqrt(N) * _eps(dtype) * np.linalg.norm(b[:, 1])
    assert float(rt) <= stall and float(rj) <= stall
    assert _passes_gate(a, xt, b)


def test_gmres_single_vector_and_posv_form_match_jax():
    a = generate("rands", N, dtype=np.float64, seed=8)
    b = generate("rands", N, 1, dtype=np.float64, seed=9)[:, 0]
    xj, rj = jref.gesv_mixed_gmres_array(jnp.asarray(a), jnp.asarray(b))
    xt, rt = tref.gesv_mixed_gmres_array(torch.from_numpy(a), torch.from_numpy(b))
    assert xt.shape == (N,) and rt.dim() == 0
    assert np.abs(xt.numpy() - np.asarray(xj)).max() <= 10 * N * _eps(np.float64) * np.abs(xj).max()
    assert _passes_gate(a, xt.numpy(), b)
    spd = _spd(N, np.complex128, 10)
    bb = generate("rands", N, 2, dtype=np.complex128, seed=11)
    xj, rj = jref.posv_mixed_gmres_array(jnp.asarray(spd), jnp.asarray(bb))
    xt, rt = tref.posv_mixed_gmres_array(torch.from_numpy(spd), torch.from_numpy(bb))
    assert np.abs(xt.numpy() - np.asarray(xj)).max() <= 10 * N * _eps(np.float64) * np.abs(xj).max()
    assert float(rt) <= 1e3 * np.sqrt(N) * _eps(np.float64) * np.linalg.norm(bb, axis=0).max()
    assert _passes_gate(spd, xt.numpy(), bb)


def test_gate_cte_is_real_and_matches_jax():
    """anorm in the real dtype of the matrix, as genorm gives it."""
    for dtype, tdt, rdt in [(np.float64, torch.float64, np.float64),
                            (np.complex128, torch.complex128, np.float64),
                            (np.float32, torch.float32, np.float32)]:
        anorm = np.asarray(3.7, dtype=rdt)
        got = tref.gate_cte(torch.from_numpy(anorm), 1000, tdt, 2.0)
        want = jref.gate_cte(jnp.asarray(anorm), 1000, dtype, 2.0)
        assert not got.is_complex() and got.dtype == torch.from_numpy(anorm).dtype
        assert float(got) == float(np.real(np.asarray(want)))


def test_ir_counters_on_the_port_registry():
    from slate_tpu_torch.obs import REGISTRY

    before = tref.ir_counter_values()
    tref.ir_count("ir.solves", "gesv")
    tref.ir_count("ir.iters_total", "posv", 3)
    tref.ir_gauge("ir.iters", 3, "posv")
    after = tref.ir_counter_values()
    assert after["solves"] - before["solves"] == 1
    assert after["iters_total"] - before["iters_total"] == 3
    assert REGISTRY.gauge_value("ir.iters", op="posv") == 3.0
