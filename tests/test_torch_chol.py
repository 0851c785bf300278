"""The port's single-chip SPD solve (slate_tpu_torch) against slate_tpu.

Every test feeds the same seeded numpy operands
(``slate_tpu.utils.testing.generate``) to the JAX function and to its port
and compares the results.  The port runs on the CPU here, where its
diagonal-block wrapper takes the plain twin of the CUDA kernel; the JAX side
runs its Pallas kernel in interpret mode under ``use_panel_impl("pallas")``
where the compared form reaches it.
"""

import ast
import contextlib
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu import api as jax_api
from slate_tpu import types as jt
from slate_tpu.blas3 import blas3 as jb
from slate_tpu.core import matrix as jm
from slate_tpu.linalg import chol as jc
from slate_tpu.ops import pallas_ops as po
from slate_tpu.utils.testing import generate
from slate_tpu_torch import api as torch_api
from slate_tpu_torch import types as tt
from slate_tpu_torch.blas3 import blas3 as tb
from slate_tpu_torch.core import matrix as tm
from slate_tpu_torch.linalg import chol as tc
from slate_tpu_torch.ops import kernels as tk
from slate_tpu_torch.ops.matmul import matmul, matmul_sub_
from slate_tpu_torch.utils import testing as tut

# the suite runs in several worker processes that share the cores: one
# intra-op thread each (torch defaults to one a core, which oversubscribes them)
torch.set_num_threads(1)

# the module (ops/__init__ exports the function matmul under the same name)
mm = importlib.import_module("slate_tpu_torch.ops.matmul")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = [np.float32, np.float64]


def _eps(dtype):
    return float(np.finfo(dtype).eps)


def _tol(n, dtype, scale=1.0):
    # the O(eps * n * scale) class the two frameworks' summation orders and
    # explicit-inverse panels stay within (test_pallas_panels.py's form)
    return 100 * n * _eps(dtype) * scale


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eta(a, x, b):
    """Normwise backward error, the gate of __graft_entry__'s posv phase."""
    a, x, b = (np.asarray(v, np.float64) for v in (a, x, b))
    n = a.shape[0]
    return np.abs(a @ x - b).max() / (np.abs(a).max() * np.abs(x).max() * n + np.abs(b).max())


@pytest.fixture(autouse=True)
def _default_panel_impl(monkeypatch):
    monkeypatch.delenv(tk.PANEL_IMPL_ENV, raising=False)
    monkeypatch.delenv(po.PANEL_IMPL_ENV, raising=False)


# ---------------------------------------------------------------------------
# the three factorization forms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [64, 72])  # 72 = ragged: the pad path
@pytest.mark.parametrize("dtype", DTYPES)
def test_potrf_scan_matches_jax(n, dtype):
    a = generate("spd", n, dtype=dtype, seed=n)
    with po.use_panel_impl("pallas"):
        l_ref = np.asarray(jc._potrf_scan(jnp.asarray(a), nb=16))
    l = tc._potrf_scan(_t(a), nb=16).numpy()
    # tolerance 100 n eps max|A|, on the lower triangle (the upper holds
    # the masked update's leftovers in both packages)
    assert np.abs(np.tril(l) - np.tril(l_ref)).max() < _tol(n, dtype, np.abs(a).max())


@pytest.mark.parametrize("n", [64, 72])
def test_potrf_left_looking_matches_jax(n):
    a = generate("spd", n, dtype=np.float64, seed=n + 1)
    with po.use_panel_impl("pallas"):
        l_ref = np.asarray(jc._potrf_left_looking(jnp.asarray(a), nb=16))
    l = tc.potrf_left_looking_staged(_t(a), nb=16).numpy()
    assert np.abs(l - l_ref).max() < _tol(n, np.float64, np.abs(a).max())


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_potrf_and_inv_matches_jax(impl, monkeypatch):
    # leaves of 16 (both packages' recursion base patched at test time): the
    # recursion and, under xla, the f32-seeded f64 leaf
    for mod in (jb, jc, tb, tc):
        monkeypatch.setattr(mod, "_NB", 16)
    n = 48
    a = generate("spd", n, dtype=np.float64, seed=5)
    with po.use_panel_impl(impl):
        l_ref, x_ref = (np.asarray(v) for v in jc._potrf_and_inv(jnp.asarray(a)))
    with tk.use_panel_impl(impl):
        l, x = (v.numpy() for v in tc._potrf_and_inv(_t(a)))
    assert np.abs(l - l_ref).max() < _tol(n, np.float64, np.abs(a).max())
    assert np.abs(x - x_ref).max() < _tol(n, np.float64, np.abs(x_ref).max() * np.abs(a).max())


@pytest.mark.parametrize("n", [64, 300])  # 300: one recursion split at 256
@pytest.mark.parametrize("dtype", DTYPES)
def test_potrf_lower_matches_jax(n, dtype):
    a = generate("spd", n, dtype=dtype, seed=7)
    l_ref = np.asarray(jc._potrf_lower(jnp.asarray(a)))
    l = tc._potrf_lower(_t(a)).numpy()
    assert np.abs(np.tril(l) - np.tril(l_ref)).max() < _tol(n, dtype, np.abs(a).max())


# ---------------------------------------------------------------------------
# triangular solve: all eight (side, uplo, op) cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("side", ["Left", "Right"])
@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
@pytest.mark.parametrize("op", ["NoTrans", "Trans", "ConjTrans"])
def test_trsm_array_matches_jax(side, uplo, op):
    n, k = 40, 24
    a = generate("rands", n, dtype=np.float64, seed=1) + n * np.eye(n)
    b = generate("randn", n, k, dtype=np.float64, seed=2)
    if side == "Right":
        b = np.ascontiguousarray(b.T)
    ref = np.asarray(jb.trsm_array(jt.Side[side], jt.Uplo[uplo], jt.Op[op], jt.Diag.NonUnit,
                                   2.0, jnp.asarray(a), jnp.asarray(b)))
    out = tb.trsm_array(tt.Side[side], tt.Uplo[uplo], tt.Op[op], tt.Diag.NonUnit,
                        2.0, _t(a), _t(b)).numpy()
    assert np.abs(out - ref).max() < _tol(n, np.float64, np.abs(ref).max())


@pytest.mark.parametrize("n,k,diag", [(16, 40, "NonUnit"), (300, 8, "NonUnit"), (300, 8, "Unit")])
def test_trsm_wide_rhs_and_recursion_match_jax(n, k, diag):
    a = generate("rands", n, dtype=np.float32, seed=3) + n * np.eye(n, dtype=np.float32)
    b = generate("randn", n, k, dtype=np.float32, seed=4)
    args = (jt.Side.Left, jt.Uplo.Lower, jt.Op.NoTrans, jt.Diag[diag], 1.0)
    ref = np.asarray(jb.trsm_array(*args, jnp.asarray(a), jnp.asarray(b)))
    out = tb.trsm_array(tt.Side.Left, tt.Uplo.Lower, tt.Op.NoTrans, tt.Diag[diag], 1.0,
                        _t(a), _t(b)).numpy()
    assert np.abs(out - ref).max() < _tol(n, np.float32, np.abs(ref).max())


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_posv_scan_path_matches_jax(impl, dtype, monkeypatch):
    # n = 64 > 32: both packages take the panel-stepped scan form
    monkeypatch.setattr(jc, "_POTRF_SCAN_MIN_N", 32)
    monkeypatch.setattr(tc, "_POTRF_SCAN_MIN_N", 32)
    n, k = 64, 8
    a = generate("spd", n, dtype=dtype, seed=21)
    b = generate("randn", n, k, dtype=dtype, seed=22)
    with po.use_panel_impl(impl):
        x_ref, f_ref, info_ref = (np.asarray(v) for v in jc.posv_array(jnp.asarray(a), jnp.asarray(b)))
    with tk.use_panel_impl(impl):
        x, f, info = tc.posv_array(_t(a), _t(b))
    assert int(info) == int(info_ref) == 0
    # backward-error gate eta < 100 n eps on both sides
    assert _eta(a, x.numpy(), b) < 100 * n * _eps(dtype)
    assert _eta(a, x_ref, b) < 100 * n * _eps(dtype)
    # elementwise: 100 n eps, scaled by max|A| (factor) and max|X| cond-free
    assert np.abs(f.numpy() - f_ref).max() < _tol(n, dtype, np.abs(a).max())
    assert np.abs(x.numpy() - x_ref).max() < _tol(n, dtype, np.abs(x_ref).max() * np.abs(a).max())


@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
def test_posv_default_path_and_views_match_jax(uplo):
    n, k = 96, 4
    a = generate("spd_svd", n, dtype=np.float64, seed=31, cond=1e4)
    b = generate("randn", n, k, dtype=np.float64, seed=32)
    stored = np.tril(a) if uplo == "Lower" else np.triu(a)
    x_ref, f_ref, info_ref = jc.posv(jm.HermitianMatrix.from_array(jnp.asarray(stored), jt.Uplo[uplo]),
                                     jnp.asarray(b))
    x, f, info = tc.posv(tm.HermitianMatrix.from_array(_t(stored), tt.Uplo[uplo]), _t(b))
    assert f.uplo.name == f_ref.uplo.name == uplo
    assert int(info) == int(info_ref) == 0
    assert np.abs(f.data.numpy() - np.asarray(f_ref.data)).max() < _tol(n, np.float64, np.abs(a).max())
    assert np.abs(x.numpy() - np.asarray(x_ref)).max() < _tol(n, np.float64, 1e4 * np.abs(x_ref).max())
    assert _eta(a, x.numpy(), b) < 100 * n * _eps(np.float64)


def test_api_chol_verbs_match_jax():
    n, k = 80, 3
    a = generate("spd", n, dtype=np.float64, seed=41)
    b = generate("randn", n, k, dtype=np.float64, seed=42)
    l_ref, _ = jax_api.chol_factor(jnp.asarray(a))
    l, info = torch_api.chol_factor(_t(a))
    assert int(info) == 0
    assert np.abs(l.numpy() - np.asarray(l_ref)).max() < _tol(n, np.float64, np.abs(a).max())
    x, info = torch_api.chol_solve(_t(a), _t(b))
    x_ref, _ = jax_api.chol_solve(jnp.asarray(a), jnp.asarray(b))
    x2 = torch_api.chol_solve_using_factor(l, _t(b))
    assert int(info) == 0
    assert np.abs(x.numpy() - np.asarray(x_ref)).max() < _tol(n, np.float64, np.abs(x_ref).max())
    assert torch.equal(x, x2)


def test_entry_solves_on_cpu():
    from slate_tpu_torch.entry import entry

    fn, (a, b) = entry(device="cpu")
    x, info = fn(a, b)
    assert a.shape == (1024, 1024) and b.shape == (1024, 32) and x.dtype == torch.float32
    assert int(info) == 0
    assert _eta(a.numpy(), x.numpy(), b.numpy()) < 100 * 1024 * _eps(np.float32)


# ---------------------------------------------------------------------------
# where the drivers compute: tensors where they lie, anything else on the card
# ---------------------------------------------------------------------------


def _facade_calls():
    n, k = 24, 3
    a = generate("spd", n, dtype=np.float64, seed=91)
    b = generate("randn", n, k, dtype=np.float64, seed=92)
    c = generate("randn", n, k, dtype=np.float64, seed=93)
    l = np.linalg.cholesky(a)
    return {
        "posv": lambda cv, **kw: tc.posv(cv(a), cv(b), **kw)[0],
        "potrf": lambda cv, **kw: tc.potrf(cv(a), **kw)[0].data,
        "potrs": lambda cv, **kw: tc.potrs(tm.TriangularMatrix.from_array(cv(l), tt.Uplo.Lower), cv(b), **kw),
        "gemm": lambda cv, **kw: tb.gemm(2.0, cv(a), cv(b), 0.5, cv(c), **kw),
        "trsm": lambda cv, **kw: tb.trsm(tt.Side.Left, 1.0, cv(l), cv(b), **kw),
        "chol_factor": lambda cv, **kw: torch_api.chol_factor(cv(a), **kw)[0],
        "chol_solve": lambda cv, **kw: torch_api.chol_solve(cv(a), cv(b), **kw)[0],
        "chol_solve_using_factor": lambda cv, **kw: torch_api.chol_solve_using_factor(cv(l), cv(b), **kw),
    }


FACADES = list(_facade_calls())


@pytest.mark.parametrize("name", FACADES)
def test_numpy_operands_go_to_the_card(name):
    # a numpy operand is neither a CPU tensor nor device="cpu": the driver
    # computes on the card (as jnp.asarray lands on the default device), so
    # on a machine without one it is refused instead of running on the host
    call = _facade_calls()[name]
    if torch.cuda.is_available():
        assert call(np.asarray).is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            call(np.asarray)


@pytest.mark.parametrize("name", FACADES)
def test_device_cpu_and_cpu_tensors_compute_on_the_host(name):
    call = _facade_calls()[name]
    from_tensors = call(_t)
    from_numpy = call(np.asarray, device="cpu")
    assert from_tensors.device.type == from_numpy.device.type == "cpu"
    # the same operands on the same device: the same numbers
    assert torch.equal(from_tensors, from_numpy)


def test_operand_device_rule():
    x = np.zeros((2, 2))
    assert tm.operand_device(x) == torch.device(tm.DEFAULT_DEVICE) == torch.device("cuda")
    assert tm.operand_device(x, "cpu") == torch.device("cpu")
    assert tm.operand_device(torch.zeros(2, 2)) == torch.device("cpu")
    view = tm.HermitianMatrix.from_array(torch.zeros(2, 2), tt.Uplo.Lower)
    assert tm.operand_device(view) == torch.device("cpu")


# ---------------------------------------------------------------------------
# info codes: bitwise equal to slate_tpu's
# ---------------------------------------------------------------------------


def _non_spd(n, dtype, j):
    a = generate("spd", n, dtype=dtype, seed=51)
    a[j, j] = -2.0
    return a


@pytest.mark.parametrize("form,n,j", [
    ("lower", 40, 0), ("lower", 300, 270), ("scan", 64, 0), ("scan", 64, 37), ("scan", 72, 70),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_non_spd_info_matches_jax(form, n, j, dtype, monkeypatch):
    if form == "scan":
        monkeypatch.setattr(jc, "_POTRF_SCAN_MIN_N", 32)
        monkeypatch.setattr(tc, "_POTRF_SCAN_MIN_N", 32)
    a = _non_spd(n, dtype, j)
    with po.use_panel_impl("pallas"):
        _, info_ref = jc.potrf_array(jnp.asarray(a))
    _, info = tc.potrf_array(_t(a))
    assert info.dtype == torch.int32
    assert int(info) == int(np.asarray(info_ref)) > 0


@pytest.mark.parametrize("form,j", [
    # scan, nb = 8 at n = 64: four buckets of two steps.  A breakdown in a
    # bucket's first step NaN-poisons the bucket's earlier diagonals through
    # the masked full-width update (17, 23: the first bad diagonal reads
    # 17); one in its last step does not (30, 45).  Both packages agree.
    ("scan", 17), ("scan", 23), ("scan", 30), ("scan", 45),
    ("left_looking", 5), ("left_looking", 33),
])
def test_non_spd_first_bad_pivot_matches_jax(form, j):
    a = _non_spd(64, np.float32 if form == "scan" else np.float64, j)

    def first_bad(l):
        d = np.diag(np.asarray(l))
        bad = ~(np.isfinite(d) & (d > 0))
        return int(np.argmax(bad)) + 1 if bad.any() else 0

    with po.use_panel_impl("pallas"):
        if form == "scan":
            ref = first_bad(jc._potrf_scan(jnp.asarray(a), nb=8))
        else:
            ref = first_bad(jc._potrf_left_looking(jnp.asarray(a), nb=16))
    if form == "scan":
        got = first_bad(tc._potrf_scan(_t(a), nb=8).numpy())
    else:
        got = first_bad(tc.potrf_left_looking_staged(_t(a), nb=16).numpy())
    assert got == ref > 0


# ---------------------------------------------------------------------------
# types, helpers, matmul tiers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cls", ["Uplo", "Op", "Diag", "Side", "Target", "Precision", "Option"])
def test_enums_round_trip_by_name(cls):
    jcls, tcls = getattr(jt, cls), getattr(tt, cls)
    assert [m.name for m in jcls] == [m.name for m in tcls]
    assert [m.value for m in jcls] == [m.value for m in tcls]
    for member in jcls:
        if cls == "Option":
            ported = tut.options_from_names({member: 1})
            assert list(ported) == [tcls[member.name]]
        else:
            ported = tut.options_from_names({"Precision": member})
            assert ported[tt.Option.Precision] is tcls[member.name]
            back = tut.options_from_names({tt.Option.Precision: ported[tt.Option.Precision]})
            assert back[tt.Option.Precision] is tcls[member.name]


def test_options_and_defaults_carry_across():
    jopts = {jt.Option.Precision: jt.Precision.High, "BlockSize": 64, jt.Option.Target: jt.Target.Host}
    topts = tut.options_from_names(jopts)
    assert topts == {tt.Option.Precision: tt.Precision.High, tt.Option.BlockSize: 64,
                     tt.Option.Target: tt.Target.Host}
    for key in jt.Option:
        jv, tv = jt.get_option(None, key), tt.get_option(None, tt.Option[key.name])
        assert (jv is None and tv is None) or getattr(jv, "name", jv) == getattr(tv, "name", tv)
    assert tt.get_option({"precision": "fast"}, tt.Option.Precision) == "fast"


@pytest.mark.parametrize("kind", ["spd", "spd_svd", "rands", "randn", "spd_neardiag"])
def test_generate_is_seeded_identically(kind):
    np.testing.assert_array_equal(generate(kind, 12, dtype=np.float32, seed=9),
                                  tut.generate(kind, 12, dtype=np.float32, seed=9))
    (t,) = tut.from_numpy([generate(kind, 12, seed=9)], device="cpu")
    assert t.dtype == torch.float64 and t.device.type == "cpu"


@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
def test_tri_project_and_symmetrize_match_jax(uplo):
    a = generate("randn", 9, dtype=np.float64, seed=61)
    a[0, 8] = a[8, 0] = np.nan  # the unreferenced triangle must not leak
    for diag in ("NonUnit", "Unit"):
        ref = np.asarray(jm.tri_project(jnp.asarray(a), jt.Uplo[uplo], jt.Diag[diag]))
        np.testing.assert_array_equal(tm.tri_project(_t(a), tt.Uplo[uplo], tt.Diag[diag]).numpy(), ref)
    keep = np.tril(a) if uplo == "Lower" else np.triu(a)
    keep = np.where(np.isnan(keep), 0.0, keep)
    ref = np.asarray(jm.symmetrize(jnp.asarray(keep), jt.Uplo[uplo], conj=True))
    np.testing.assert_array_equal(tm.symmetrize(_t(keep), tt.Uplo[uplo], conj=True).numpy(), ref)


def test_matmul_precision_tiers():
    a = _t(generate("randn", 64, dtype=np.float32, seed=71))
    b = _t(generate("randn", 64, dtype=np.float32, seed=72))
    exact = a.double() @ b.double()
    err = {p: float((matmul(a, b, precision=p).double() - exact).abs().max() / exact.abs().max())
           for p in tt.Precision}
    # Highest/Emulated: full f32 (~2^-24 per op); Fast: bf16 operands (~2^-8)
    assert err[tt.Precision.Highest] < 1e-5 and err[tt.Precision.Emulated] < 1e-5
    assert 1e-4 < err[tt.Precision.Fast] < 5e-2
    assert matmul(a, b, precise=False).dtype == torch.float32
    # the in-place trailing update at each tier is c - a@b at that tier,
    # within 100 k eps max|c - a@b| (the fused update sums in another order)
    c = _t(generate("randn", 64, dtype=np.float32, seed=73))
    for p in tt.Precision:
        want = c - matmul(a, b, precision=p)
        got = matmul_sub_(c.clone(), a, b, precision=p)
        assert float((got - want).abs().max()) < _tol(64, np.float32, float(want.abs().max()))
    # Highest on the host never touches the process-global TF32 flag
    flags = torch.backends.cuda.matmul
    old = flags.allow_tf32
    try:
        flags.allow_tf32 = True
        assert isinstance(mm._tf32_scope(a, tt.Precision.Highest), contextlib.nullcontext)
        matmul(a, b)
        assert flags.allow_tf32 is True
    finally:
        flags.allow_tf32 = old


def test_gemm_matches_jax():
    a = generate("randn", 20, 12, dtype=np.float64, seed=81)
    b = generate("randn", 12, 16, dtype=np.float64, seed=82)
    c = generate("randn", 20, 16, dtype=np.float64, seed=83)
    ref = np.asarray(jb.gemm(2.0, jnp.asarray(a), jnp.asarray(b), 0.5, jnp.asarray(c)))
    out = tb.gemm(2.0, _t(a), _t(b), 0.5, _t(c)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-13, atol=1e-13)


# ---------------------------------------------------------------------------
# the port never imports JAX or the JAX package
# ---------------------------------------------------------------------------


def _port_files():
    pkg = os.path.join(REPO, "slate_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(pkg):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    return files


def test_port_imports_no_jax():
    files = _port_files()
    assert len(files) > 10
    for mod in ("linalg/qr.py", "parallel/dist_qr.py", "ops/kernels.py", "ft/abft.py",
                "ft/checksum.py", "ft/inject.py", "ft/policy.py", "ft/smoke.py", "obs/metrics.py",
                "linalg/lu.py", "linalg/norms.py", "linalg/refine.py", "linalg/tri.py",
                "ops/tile_ops.py", "ops/matmul.py", "ops/ozaki.py", "parallel/summa.py",
                "parallel/dist_aux.py", "parallel/dist_refine.py", "parallel/mixed_smoke.py",
                "parallel/dist_blas3.py", "linalg/tridiag.py", "linalg/eig.py", "linalg/svd.py",
                "parallel/dist_twostage.py", "parallel/dist_stedc.py", "linalg/band.py",
                "linalg/indefinite.py", "linalg/rbt.py", "core/grid.py", "parallel/mesh.py",
                "parallel/dist.py", "ft/ckpt.py", "ft/elastic.py", "ft/ckpt_smoke.py",
                "obs/context.py", "obs/span.py", "obs/report.py", "obs/perfetto.py",
                "obs/schedule.py", "obs/flight.py", "obs/comm_audit.py", "obs/smoke.py",
                "obs/numerics.py", "obs/numwatch.py", "obs/memory.py", "obs/memmodel.py",
                "obs/memwatch.py", "serve/__init__.py", "serve/batch.py", "serve/budget.py",
                "serve/cache.py", "serve/metrics.py", "serve/router.py", "serve/smoke.py",
                "serve/table.py", "serve/trace.py", "serve/tune.py", "api.py", "obs/live.py",
                "serve/stats.py", "serve/queue.py", "serve/controller.py", "serve/service.py",
                "serve/queue_smoke.py"):
        assert os.path.join(REPO, "slate_tpu_torch", mod) in files
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("jax", "jaxlib", "slate_tpu"), f"{path} imports {mod}"
