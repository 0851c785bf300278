"""The port's kernel module (slate_tpu_torch.ops.kernels) against slate_tpu.

The same seeded numpy blocks (``slate_tpu.utils.testing.generate``) go
through ``slate_tpu.ops.pallas_ops.chol_diag_inv_pallas`` (Pallas interpret
mode on the CPU, as tests/test_pallas_panels.py runs it) and through the
port's plain twin ``chol_diag_inv_plain``, which is what the wrapper runs on
a CPU tensor.  The CUDA kernel itself is compared with the twin on the card
(the ``cuda`` test below, and chip_smoke.py).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu.ops import pallas_ops as po
from slate_tpu.utils.testing import generate
from slate_tpu_torch.ops import _build
from slate_tpu_torch.ops import kernels as tk

# the suite runs in several worker processes that share the cores: one
# intra-op thread each (torch defaults to one a core, which oversubscribes them)
torch.set_num_threads(1)

DTYPES = [np.float32, np.float64]


def _tol(nb, dtype, scale=1.0):
    # the documented explicit-inverse class of pallas_ops.py: the twin runs
    # the same op sequence as _chol_inv_body, only in another framework
    return 100 * nb * float(np.finfo(dtype).eps) * scale


def _non_spd(nb, dtype, j):
    a = generate("spd", nb, dtype=dtype, seed=11)
    a[j, j] = -1.0  # the Schur complement's pivot j goes negative
    return a


@pytest.mark.parametrize("nb", [8, 16])
@pytest.mark.parametrize("dtype", DTYPES)
def test_chol_diag_inv_plain_matches_pallas(nb, dtype):
    a = generate("spd", nb, dtype=dtype, seed=nb)
    l_ref, x_ref = (np.asarray(v) for v in po.chol_diag_inv_pallas(jnp.asarray(a)))
    l, x = (v.numpy() for v in tk.chol_diag_inv_plain(torch.from_numpy(a)))
    anorm = float(np.abs(a).max())
    # tolerance 100 nb eps max|A| for L, 100 nb eps max|X| max|A| for X
    assert np.abs(l - l_ref).max() < _tol(nb, dtype, anorm)
    assert np.abs(x - x_ref).max() < _tol(nb, dtype, float(np.abs(x_ref).max()) * anorm)
    np.testing.assert_array_equal(np.triu(l, 1), 0)
    np.testing.assert_array_equal(np.triu(x, 1), 0)


@pytest.mark.parametrize("nb,j", [(8, 3), (16, 0), (16, 9)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_chol_diag_inv_plain_non_spd_nan_pattern(nb, j, dtype):
    a = _non_spd(nb, dtype, j)
    l_ref, x_ref = (np.asarray(v) for v in po.chol_diag_inv_pallas(jnp.asarray(a)))
    l, x = (v.numpy() for v in tk.chol_diag_inv_plain(torch.from_numpy(a)))
    # NaN from the same column in both, in L and in L^-1 (bitwise pattern)
    np.testing.assert_array_equal(np.isnan(l), np.isnan(l_ref))
    np.testing.assert_array_equal(np.isnan(x), np.isnan(x_ref))
    first = int(np.argmax(np.isnan(np.diag(l))))
    assert np.isnan(np.diag(l)).any() and first == int(np.argmax(np.isnan(np.diag(l_ref))))
    assert np.isfinite(l[:first, :first]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wrapper_takes_twin_on_cpu_without_counting(dtype):
    a = torch.from_numpy(generate("spd", 16, dtype=np.float64, seed=2)).to(dtype)
    before = tk.chol_diag_inv.launches
    l, x = tk.chol_diag_inv(a)
    l2, x2 = tk.chol_diag_inv_plain(a)
    assert torch.equal(l, l2) and torch.equal(x, x2)
    assert tk.chol_diag_inv.launches == before  # only a kernel launch counts


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        tk.chol_diag_inv(torch.empty((8, 8), device="meta"))


def test_panel_impl_resolution_chain(monkeypatch):
    monkeypatch.delenv(tk.PANEL_IMPL_ENV, raising=False)
    assert tk.resolve_panel_impl() == "auto"
    monkeypatch.setenv(tk.PANEL_IMPL_ENV, "xla")
    assert tk.resolve_panel_impl() == "xla"
    with tk.use_panel_impl("pallas"):  # context beats the environment
        assert tk.resolve_panel_impl() == "pallas"
        assert tk.resolve_panel_impl("auto") == "auto"  # explicit beats both
    assert tk.resolve_panel_impl() == "xla"
    with pytest.raises(ValueError, match="unknown panel impl"):
        tk.resolve_panel_impl("triton")


@pytest.mark.parametrize("impl,engaged", [("auto", True), ("pallas", True), ("xla", False)])
def test_panel_engaged(impl, engaged, monkeypatch):
    monkeypatch.delenv(tk.PANEL_IMPL_ENV, raising=False)
    with tk.use_panel_impl(impl):
        assert tk.panel_engaged(torch.float32) is engaged
        assert tk.panel_engaged(torch.float64) is engaged
        assert tk.panel_engaged(torch.complex64) is False


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_DIRS", [str(tmp_path)])
    monkeypatch.setattr(_build, "_LOADED", {})
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.load("chol_diag_inv")
    # and the wrapper raises too on a CUDA tensor: no fallback to the twin
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        tk._chol_diag_inv_fn(torch.float32)
    with pytest.raises(_build.KernelBuildError, match="no kernel source"):
        _build.load("no_such_kernel")
    assert os.path.exists(os.path.join(_build.CSRC_DIR, "chol_diag_inv.cu"))


def test_library_name_hashes_the_included_headers(monkeypatch, tmp_path):
    # an edited header must give a new library name, or a stale build loads
    (tmp_path / "k.cu").write_text('#include "outer.cuh"\n#include <cuda_runtime.h>\n')
    (tmp_path / "outer.cuh").write_text('#pragma once\n  #  include "inner.cuh"\n')
    (tmp_path / "inner.cuh").write_text("// v1\n")
    (tmp_path / "unused.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    assert _build._sources("k") == ["k.cu", "outer.cuh", "inner.cuh"]
    first = _build._lib_path("k")
    (tmp_path / "unused.cuh").write_text("// v2\n")
    assert _build._lib_path("k") == first
    (tmp_path / "inner.cuh").write_text("// v2\n")
    second = _build._lib_path("k")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "outer.cuh"\n// edited\n')
    assert _build._lib_path("k") not in (first, second)
    # the shipped sources: both diagonal-block kernels hash their shared
    # header, both tile-GEMM kernels theirs
    monkeypatch.undo()
    for name in ("chol_diag_inv", "lu_diag_inv"):
        assert _build._sources(name) == [f"{name}.cu", "diag_block.cuh"]
    for name in ("tile_gemm", "ft_summa_update"):
        assert _build._sources(name) == [f"{name}.cu", "tile_mma.cuh"]


def _chip_smoke():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_ladder_gates_fail_a_nan_solution():
    """chip_smoke.py's omega reads NaN for a NaN X (max() would drop it to
    0), so ladder_faults fails such a solve on omega as well as on info,
    eta and the refinement gate; a sound solve passes every gate."""
    from slate_tpu_torch.utils.testing import refine_gate_ok

    cs = _chip_smoke()
    rng = np.random.default_rng(3)
    n = 24
    a = torch.from_numpy(rng.uniform(-1, 1, (n, n)) + n * np.eye(n))
    b = torch.from_numpy(rng.standard_normal((n, 2)))
    limit = cs.GESV_LADDER_OMEGA * cs.omega_gate(n, torch.float64, torch)

    def reading(x):
        return {"info": 0, "x_finite": bool(torch.isfinite(x).all()),
                "eta": cs.eta(a, x, b, torch), "eta_gate": 100 * n * np.finfo(np.float64).eps,
                "omega": cs.omega(a, x, b, torch), "tier": "ir", "iters": 2.0,
                "refine_gate_ok": refine_gate_ok(a, x, b)}

    sound = reading(torch.linalg.solve(a, b))
    assert cs.ladder_faults(sound, limit) == []
    bad = torch.linalg.solve(a, b)
    bad[5, 1] = float("nan")
    r = reading(bad)
    assert np.isnan(r["omega"])
    assert cs.ladder_faults(r, limit) == ["info", "eta", "omega", "refine_gate"]

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_twin_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    nb = 256
    a = torch.from_numpy(generate("spd", nb, dtype=np.float64, seed=7)).to(dtype).cuda()
    before = tk.chol_diag_inv.launches
    l, x = tk.chol_diag_inv(a)
    torch.cuda.synchronize()
    assert tk.chol_diag_inv.launches == before + 1
    lp, xp = tk.chol_diag_inv_plain(a)
    anorm = float(a.abs().max())
    npd = np.float32 if dtype == torch.float32 else np.float64
    assert float((l - lp).abs().max()) < _tol(nb, npd, anorm)
    assert float((x - xp).abs().max()) < _tol(nb, npd, float(xp.abs().max()) * anorm)


# ---------------------------------------------------------------------------
# the mesh kernels' twins against slate_tpu's Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


def _update_operands(dtype, mtl=3, ntl=4, nb=8, seed=0):
    rng = np.random.default_rng(seed)
    acc = rng.standard_normal((mtl, ntl, nb, nb)).astype(dtype)
    pan = rng.standard_normal((mtl, nb, nb)).astype(dtype)
    rhs = rng.standard_normal((ntl, nb, nb)).astype(dtype)
    lower = np.arange(mtl)[:, None] >= np.arange(ntl)[None, :]
    return acc, pan, rhs, lower


def _gemm_tol(nb, dtype, *arrays):
    # two summation orders of nb products each: 2 nb eps sum|a||b|, plus the
    # final add; the scale is nb max|a| max|b| + max|c|
    acc, pan, rhs = arrays
    scale = nb * np.abs(pan).max() * np.abs(rhs).max() + np.abs(acc).max()
    return 4 * nb * float(np.finfo(dtype).eps) * scale


@pytest.mark.parametrize("dtype", DTYPES)
def test_summa_update_plain_matches_pallas(dtype):
    acc, pan, rhs, _ = _update_operands(dtype)
    ref = np.asarray(po.summa_update_pallas(jnp.asarray(acc), jnp.asarray(pan), jnp.asarray(rhs)))
    # the twin over a one-device grid: (1, 1, I, J, nb, nb)
    got = tk.summa_update_plain(torch.from_numpy(acc)[None, None].clone(),
                                torch.from_numpy(pan)[None, None], torch.from_numpy(rhs)[None, None])
    assert np.abs(got[0, 0].numpy() - ref).max() < _gemm_tol(8, dtype, acc, pan, rhs)


@pytest.mark.parametrize("dtype", DTYPES)
def test_chol_trailing_update_plain_matches_pallas(dtype):
    acc, pan, rhs, lower = _update_operands(dtype, seed=1)
    ref = np.asarray(po.chol_trailing_update_pallas(
        jnp.asarray(acc), jnp.asarray(pan), jnp.asarray(rhs), jnp.asarray(lower)))
    got = tk.chol_trailing_update_plain(torch.from_numpy(acc)[None, None].clone(),
                                        torch.from_numpy(pan)[None, None],
                                        torch.from_numpy(rhs)[None, None],
                                        torch.from_numpy(lower)[None, None])[0, 0].numpy()
    assert np.abs(got - ref).max() < _gemm_tol(8, dtype, acc, pan, rhs)
    # masked tiles are untouched, bitwise, in both
    np.testing.assert_array_equal(got[~lower], acc[~lower])
    np.testing.assert_array_equal(ref[~lower], acc[~lower])


@pytest.mark.parametrize("nb", [8, 16])
@pytest.mark.parametrize("dtype", DTYPES)
def test_chol_panel_tiles_plain_matches_pallas(nb, dtype):
    d = generate("spd", nb, dtype=dtype, seed=nb + 3)
    tiles = generate("randn", 5 * nb, nb, dtype=dtype, seed=nb + 4).reshape(5, nb, nb)
    l_ref, s_ref = (np.asarray(v) for v in po.chol_panel_tiles_pallas(jnp.asarray(d), jnp.asarray(tiles)))
    l, s = (v.numpy() for v in tk.chol_panel_tiles_plain(torch.from_numpy(d), torch.from_numpy(tiles)))
    _, x_ref = (np.asarray(v) for v in po.chol_diag_inv_pallas(jnp.asarray(d)))
    x = tk.chol_diag_inv_plain(torch.from_numpy(d))[1].numpy()
    assert np.abs(l - l_ref).max() < _tol(nb, dtype, float(np.abs(d).max()))
    # solved tiles: each side sums nb products, within nb eps |T||X|^T of the
    # exact product of its operands, and the two L^-1 differ by |X - X_ref|
    t = np.abs(tiles)
    tol_s = (nb * float(np.finfo(dtype).eps) * (t @ np.abs(x).T + t @ np.abs(x_ref).T)
             + t @ np.abs(x - x_ref).T).max()
    assert tol_s < 1e-2 * np.abs(s_ref).max()  # a wrong output cannot pass
    assert np.abs(s - s_ref).max() < tol_s


@pytest.mark.parametrize("j", [0, 5])
def test_chol_panel_tiles_plain_non_spd_nan_pattern(j):
    d = _non_spd(8, np.float32, j)
    tiles = generate("randn", 16, 8, dtype=np.float32, seed=9).reshape(2, 8, 8)
    l_ref, s_ref = (np.asarray(v) for v in po.chol_panel_tiles_pallas(jnp.asarray(d), jnp.asarray(tiles)))
    l, s = (v.numpy() for v in tk.chol_panel_tiles_plain(torch.from_numpy(d), torch.from_numpy(tiles)))
    np.testing.assert_array_equal(np.isnan(l), np.isnan(l_ref))
    np.testing.assert_array_equal(np.isnan(s), np.isnan(s_ref))


def test_mesh_wrappers_take_twins_on_cpu_without_counting():
    acc, pan, rhs, lower = (torch.from_numpy(v)[None, None] if isinstance(v, np.ndarray) else v
                            for v in _update_operands(np.float64, seed=2))
    before = (tk.summa_update.launches, tk.chol_trailing_update.launches, tk.chol_panel_tiles.launches)
    assert torch.equal(tk.summa_update(acc.clone(), pan, rhs), tk.summa_update_plain(acc.clone(), pan, rhs))
    assert torch.equal(tk.chol_trailing_update(acc.clone(), pan, rhs, lower),
                       tk.chol_trailing_update_plain(acc.clone(), pan, rhs, lower))
    d = torch.from_numpy(generate("spd", 8, dtype=np.float64, seed=3))
    for got, want in zip(tk.chol_panel_tiles(d, pan[0, 0]), tk.chol_panel_tiles_plain(d, pan[0, 0])):
        assert torch.equal(got, want)
    assert (tk.summa_update.launches, tk.chol_trailing_update.launches,
            tk.chol_panel_tiles.launches) == before


def test_mesh_wrappers_refuse_other_devices():
    meta = torch.empty((1, 1, 2, 2, 8, 8), device="meta")
    pan = torch.empty((1, 1, 2, 8, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tk.summa_update(meta, pan, pan)
    with pytest.raises(ValueError, match="unsupported device"):
        tk.chol_trailing_update(meta, pan, pan, torch.ones((1, 1, 2, 2), dtype=torch.bool))
    with pytest.raises(ValueError, match="unsupported device"):
        tk.chol_panel_tiles(torch.empty((8, 8), device="meta"), pan)


def test_update_impl_resolution_chain(monkeypatch):
    monkeypatch.delenv(tk.UPDATE_IMPL_ENV, raising=False)
    assert tk.resolve_update_impl() == "auto"
    monkeypatch.setenv(tk.UPDATE_IMPL_ENV, "xla")
    assert tk.resolve_update_impl() == "xla"
    with tk.use_update_impl("pallas"):
        assert tk.resolve_update_impl() == "pallas"
        assert tk.resolve_update_impl("auto") == "auto"
        with tk.update_impl_scope("xla"):  # a driver's pinned impl beats the chain
            assert tk.update_engaged(torch.float32) is False
    assert tk.resolve_update_impl() == "xla"
    with pytest.raises(ValueError, match="unknown update impl"):
        tk.resolve_update_impl("triton")


@pytest.mark.parametrize("impl,engaged", [("auto", True), ("pallas", True), ("xla", False)])
def test_update_engaged(impl, engaged, monkeypatch):
    monkeypatch.delenv(tk.UPDATE_IMPL_ENV, raising=False)
    with tk.use_update_impl(impl):
        assert tk.update_engaged(torch.float32) is engaged
        assert tk.update_engaged(torch.float64) is engaged
        # bf16 and complex keep the plain form on every device
        assert tk.update_engaged(torch.bfloat16) is False
        assert tk.update_engaged(torch.complex64) is False


def test_panel_impl_scope_beats_the_chain(monkeypatch):
    monkeypatch.setenv(tk.PANEL_IMPL_ENV, "pallas")
    with tk.panel_impl_scope("xla"):
        assert tk.panel_engaged(torch.float32) is False
    assert tk.panel_engaged(torch.float32) is True


def test_tile_gemm_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_DIRS", [str(tmp_path)])
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.load("tile_gemm")
    # the wrapper raises on the way to a CUDA launch: no fallback to the twin
    for dtype in (torch.float32, torch.float64):
        with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
            tk._tile_gemm_fn(dtype)
    assert os.path.exists(os.path.join(_build.CSRC_DIR, "tile_gemm.cu"))


# ---------------------------------------------------------------------------
# the LU kernels' twins against slate_tpu's Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


def _lu_block(nb, dtype, seed):
    """randn + nb I: factors stably without pivoting."""
    return (generate("randn", nb, dtype=dtype, seed=seed) + nb * np.eye(nb)).astype(dtype)


@pytest.mark.parametrize("nb", [8, 16])
@pytest.mark.parametrize("dtype", DTYPES)
def test_lu_panel_tiles_plain_matches_pallas(nb, dtype):
    d = _lu_block(nb, dtype, nb + 5)
    tiles = generate("randn", 5 * nb, nb, dtype=dtype, seed=nb + 6).reshape(5, nb, nb)
    lu_ref, s_ref = (np.asarray(v) for v in po.lu_panel_tiles_pallas(jnp.asarray(d), jnp.asarray(tiles)))
    lu, s = (v.numpy() for v in tk.lu_panel_tiles_plain(torch.from_numpy(d), torch.from_numpy(tiles)))
    x = tk.lu_diag_inv_plain(torch.from_numpy(d))[1].numpy()
    assert np.abs(lu - lu_ref).max() < _tol(nb, dtype, float(np.abs(d).max()))
    # solved tiles: nb eps (|T||X| + |T||X_ref|) + |T||X - X_ref|, with the
    # reference's U^-1 recovered from its own output (U^-1 = solve of I)
    x_ref = np.asarray(po.lu_panel_tiles_pallas(jnp.asarray(d), jnp.asarray(np.eye(nb, dtype=dtype)[None]))[1][0])
    t = np.abs(tiles)
    eps = float(np.finfo(dtype).eps)
    tol_s = (nb * eps * (t @ np.abs(x) + t @ np.abs(x_ref)) + t @ np.abs(x - x_ref)).max()
    assert tol_s < 1e-2 * np.abs(s_ref).max()  # a wrong output cannot pass
    assert np.abs(s - s_ref).max() < tol_s
    np.testing.assert_array_equal(np.tril(x, -1), 0)


@pytest.mark.parametrize("nb", [8, 16])
@pytest.mark.parametrize("dtype", DTYPES)
def test_lu_rowsolve_tiles_plain_matches_pallas(nb, dtype):
    d = _lu_block(nb, dtype, nb + 7)
    lu = tk.lu_diag_inv_plain(torch.from_numpy(d))[0].numpy()
    tiles = generate("randn", 4 * nb, nb, dtype=dtype, seed=nb + 8).reshape(4, nb, nb)
    ref = np.asarray(po.lu_rowsolve_tiles_pallas(jnp.asarray(lu), jnp.asarray(tiles)))
    got = tk.lu_rowsolve_tiles_plain(torch.from_numpy(lu), torch.from_numpy(tiles)).numpy()
    linv = tk.unit_linv_plain(torch.from_numpy(lu)).numpy()
    scale = float(np.abs(linv).max() * np.abs(tiles).max())
    assert np.abs(got - ref).max() < _tol(nb, dtype, scale)
    np.testing.assert_array_equal(np.triu(linv, 1), 0)
    np.testing.assert_array_equal(np.diag(linv), 1)


@pytest.mark.parametrize("nb,j", [(8, 0), (8, 5), (16, 11)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_lu_panel_tiles_plain_zero_pivot_pattern(nb, j, dtype):
    # a zero pivot: the factor divides by 1 (finite), U^-1 by the raw 0, and
    # the non-finite pattern of the solved tiles is the Pallas kernel's
    d = _lu_block(nb, dtype, 17)
    d[j, :] = 0
    tiles = generate("randn", 2 * nb, nb, dtype=dtype, seed=18).reshape(2, nb, nb)
    lu_ref, s_ref = (np.asarray(v) for v in po.lu_panel_tiles_pallas(jnp.asarray(d), jnp.asarray(tiles)))
    lu, s = (v.numpy() for v in tk.lu_panel_tiles_plain(torch.from_numpy(d), torch.from_numpy(tiles)))
    assert np.isfinite(lu).all() and lu[j, j] == 0 == lu_ref[j, j]
    np.testing.assert_array_equal(np.isfinite(s), np.isfinite(s_ref))
    assert not np.isfinite(s).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_lu_trailing_update_plain_matches_pallas(dtype):
    acc, pan, rhs, _ = _update_operands(dtype, seed=4)
    keep = np.ones((3, 4), bool)
    keep[1, :] = False  # excl_kr
    keep[:, 2] = False  # excl_kc
    ref = np.asarray(po.lu_trailing_update_pallas(jnp.asarray(acc), jnp.asarray(pan), jnp.asarray(rhs),
                                                  jnp.asarray(keep)))
    got = tk.lu_trailing_update_plain(torch.from_numpy(acc)[None, None].clone(),
                                      torch.from_numpy(pan)[None, None], torch.from_numpy(rhs)[None, None],
                                      torch.from_numpy(keep)[None, None])[0, 0].numpy()
    assert np.abs(got - ref).max() < _gemm_tol(8, dtype, acc, pan, rhs)
    np.testing.assert_array_equal(got[~keep], acc[~keep])
    np.testing.assert_array_equal(ref[~keep], acc[~keep])


def test_lu_wrappers_take_twins_on_cpu_without_counting():
    acc, pan, rhs, lower = (torch.from_numpy(v)[None, None] for v in _update_operands(np.float64, seed=5))
    d = torch.from_numpy(_lu_block(8, np.float64, 6))
    names = ("lu_panel_tiles", "lu_rowsolve_tiles", "lu_trailing_update")
    before = [getattr(tk, n).launches for n in names]
    for got, want in zip(tk.lu_panel_tiles(d, pan[0, 0]), tk.lu_panel_tiles_plain(d, pan[0, 0])):
        assert torch.equal(got, want)
    assert torch.equal(tk.lu_rowsolve_tiles(d, pan[0, 0]), tk.lu_rowsolve_tiles_plain(d, pan[0, 0]))
    assert torch.equal(tk.lu_trailing_update(acc.clone(), pan, rhs, lower),
                       tk.lu_trailing_update_plain(acc.clone(), pan, rhs, lower))
    assert [getattr(tk, n).launches for n in names] == before


def test_lu_wrappers_refuse_other_devices():
    meta = torch.empty((8, 8), device="meta")
    tiles = torch.empty((1, 1, 2, 8, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tk.lu_panel_tiles(meta, tiles[0, 0])
    with pytest.raises(ValueError, match="unsupported device"):
        tk.lu_rowsolve_tiles(meta, tiles[0, 0])
    with pytest.raises(ValueError, match="unsupported device"):
        tk.lu_trailing_update(torch.empty((1, 1, 2, 2, 8, 8), device="meta"), tiles, tiles,
                              torch.ones((1, 1, 2, 2), dtype=torch.bool))


def test_lu_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_DIRS", [str(tmp_path)])
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    for entry in ("lu_diag_inv", "unit_linv"):
        for dtype in (torch.float32, torch.float64):
            with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
                tk._lu_fn(entry, dtype)
    assert os.path.exists(os.path.join(_build.CSRC_DIR, "lu_diag_inv.cu"))


# ---------------------------------------------------------------------------
# the Householder panel kernels (csrc/qr_panel.cu): dispatch and refusals on
# the host; their twins against the Pallas kernels are in test_torch_qr.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl,engaged", [("auto", True), ("pallas", True), ("xla", False)])
def test_qr_gate_dispatch(impl, engaged, monkeypatch):
    """pallas/auto send every real panel to the wrappers (bf16/f16 as f32),
    xla and complex keep the plain pair."""
    from slate_tpu_torch.linalg import qr as tqr

    monkeypatch.delenv(tk.PANEL_IMPL_ENV, raising=False)
    calls = []
    monkeypatch.setattr(tqr, "qr_panel", lambda a: calls.append(a.dtype) or tk.qr_panel_plain(a))
    monkeypatch.setattr(tqr, "qr_panel_offset",
                        lambda a, r: calls.append(a.dtype) or tk.qr_panel_offset_plain(a, r))
    g = torch.Generator().manual_seed(3)
    dtypes = (torch.float32, torch.float64, torch.bfloat16, torch.float16, torch.complex64)
    with tk.use_panel_impl(impl):
        for dt in dtypes:
            a = torch.randn((8, 4), generator=g, dtype=torch.float64).to(dt)
            outs = tqr._panel_qr_t(a) + tqr._panel_qr_offset_t(a, 2)
            assert all(x.dtype == dt for x in outs)
    f32, f64 = torch.float32, torch.float64
    assert calls == ([f32, f32, f64, f64, f32, f32, f32, f32] if engaged else [])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_qr_half_panel_is_the_f32_panel_cast_back(dtype, monkeypatch):
    """Under auto a half-precision panel is the f32 panel rounded to its
    dtype, bitwise; under xla it runs the plain pair in its own dtype."""
    from slate_tpu_torch.linalg import qr as tqr

    monkeypatch.delenv(tk.PANEL_IMPL_ENV, raising=False)
    a = torch.randn((24, 8), generator=torch.Generator().manual_seed(4)).to(dtype)
    with tk.use_panel_impl("auto"):
        got = tqr._panel_qr_t(a) + tqr._panel_qr_offset_t(a, 5)
    want = tk.qr_panel_plain(a.float()) + tk.qr_panel_offset_plain(a.float(), 5)
    for g, w in zip(got, want):
        assert torch.equal(g, w.to(dtype))
    with tk.use_panel_impl("xla"):
        plain = tqr._panel_qr_t(a)
    for g, w in zip(plain, tk.qr_panel_plain(a)):
        assert torch.equal(g, w)


def test_qr_wrappers_refuse_other_devices():
    meta = torch.empty((64, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tk.qr_panel(meta)
    with pytest.raises(ValueError, match="unsupported device"):
        tk.qr_panel_offset(meta, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        tk.qr_panel_offset(torch.empty((2, 64, 8), device="meta"), [0, 8])


def test_qr_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_DIRS", [str(tmp_path)])
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    for dtype in (torch.float32, torch.float64):
        with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
            tk._qr_fns(dtype)
    assert os.path.exists(os.path.join(_build.CSRC_DIR, "qr_panel.cu"))


# ---------------------------------------------------------------------------
# the checksum-carrying SUMMA step: ft_summa_update_plain against slate_tpu's
# interpreted ft_summa_update_pallas (test_pallas_panels.py's shapes)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid", [False, True], ids=["one-device", "virtual-2x4"])
def test_ft_summa_update_plain_matches_pallas(grid):
    rng = np.random.default_rng(42)
    I, J, nb = 4, 3, 8
    acc = rng.standard_normal((I, J, nb, nb))
    pan = rng.standard_normal((I, nb, nb))
    urow = rng.standard_normal((J, nb, nb))
    w1, w2 = rng.standard_normal(I), rng.standard_normal(I)
    part0 = rng.standard_normal((2, J, nb, nb))
    out_ref, part_ref = (np.asarray(v) for v in po.ft_summa_update_pallas(
        *(jnp.asarray(x) for x in (acc, pan, urow, w1, w2, part0))))
    t = torch.from_numpy
    if grid:
        # the same step on every device of a 2 x 4 grid: the panels and the
        # weights read through stride 0, one launch's worth of tiles
        acc_t = t(acc)[None, None].repeat(2, 4, 1, 1, 1, 1)
        part_t = t(part0)[None, None].repeat(2, 4, 1, 1, 1, 1)
        args = (t(pan)[None, None].expand(2, 1, I, nb, nb), t(urow)[None, None].expand(1, 4, J, nb, nb),
                t(w1).view(1, 1, I), t(w2).view(1, 1, I))
    else:
        acc_t, part_t = t(acc.copy())[None, None], t(part0.copy())[None, None]
        args = (t(pan)[None, None], t(urow)[None, None], t(w1)[None, None], t(w2)[None, None])
    out, part = tk.ft_summa_update(acc_t, args[0], args[1], args[2], args[3], part_t)
    assert tk.ft_summa_update.launches == 0  # CPU tensors take the twin
    # f64, two frameworks' sums of nb products: atol 1e-12 as the Pallas test
    np.testing.assert_allclose(out.numpy(), np.broadcast_to(out_ref, out.shape), rtol=0, atol=1e-12)
    np.testing.assert_allclose(part.numpy(), np.broadcast_to(part_ref, part.shape), rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# the tile kernels (csrc/tile_ops.cu): dispatch and refusals on the host;
# their twins against the interpreted Pallas kernels are in
# test_torch_tile_ops.py
# ---------------------------------------------------------------------------

TILE_WRAPPERS = ("transpose_tiles", "geadd_tiles", "genorm_max_tiles")


def test_tile_wrappers_take_twins_on_cpu_without_counting():
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((8, 16, 128)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((8, 16, 128)).astype(np.float32))
    before = [getattr(tk, w).launches for w in TILE_WRAPPERS]
    assert torch.equal(tk.transpose_tiles(a), tk.transpose_tiles_plain(a))
    assert torch.equal(tk.geadd_tiles(0.3, a, -2.0, b), tk.geadd_tiles_plain(0.3, a, -2.0, b))
    assert torch.equal(tk.genorm_max_tiles(a), tk.genorm_max_tiles_plain(a))
    assert [getattr(tk, w).launches for w in TILE_WRAPPERS] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_geadd_twin_rounds_once_from_exact_products(dtype):
    """alpha and beta are rounded to the dtype, then alpha a + beta b is
    formed where both products are exact (f64 for f32, f32 for bf16) and
    rounded once: the correctly rounded sum, entry by entry."""
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.standard_normal((8, 8, 128)).astype(np.float32)).to(dtype)
    b = torch.from_numpy(rng.standard_normal((8, 8, 128)).astype(np.float32)).to(dtype)
    al, be = (float(torch.tensor(x, dtype=dtype)) for x in (0.1, -1.3))
    exact = al * a.double() + be * b.double()  # exact: the f64 products and sum of narrow values
    assert torch.equal(tk.geadd_tiles_plain(0.1, a, -1.3, b), exact.to(dtype))


def test_genorm_max_twin_propagates_nan():
    a = torch.ones((8, 4, 128))
    a[6, 2, 9] = float("nan")
    got = tk.genorm_max_tiles(a)
    assert torch.isnan(got[6]) and torch.equal(got[torch.arange(8) != 6], torch.ones(7))


def test_tile_wrappers_refuse_other_devices():
    a = torch.empty((8, 16, 128), device="meta")
    for call in (lambda: tk.transpose_tiles(a), lambda: tk.geadd_tiles(1.0, a, 1.0, a),
                 lambda: tk.genorm_max_tiles(a)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()


def test_tile_ops_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_DIRS", [str(tmp_path)])
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    for kernel in ("transpose", "geadd", "genorm_max"):
        for dtype in (torch.float32, torch.bfloat16):
            with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
                tk._tile_fn(kernel, dtype)
    assert os.path.exists(os.path.join(_build.CSRC_DIR, "tile_ops.cu"))
