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
