"""The port's single-chip LU factorizations (slate_tpu_torch.linalg.lu)
against slate_tpu.linalg.lu.

The same seeded numpy operands go through each of ``slate_tpu``'s forms and
the port's same form, both called directly on the CPU: ``getrf_array``
(the CPU branch, the recursive ``_getrf_rec``), ``_getrf_left_looking``
(the f64 form the card takes at 4096 <= n <= 8192) with its panel
``_getrf_rec_inv``, ``getrf_nopiv_array`` and ``getrf_tntpiv_array``, over
square (n = 64, 100, 256), tall and wide shapes in f32, f64, c64 and c128;
and ``getrf_array``'s dispatch rule.  The scanned form and the singular
inputs are in tests/test_torch_lu_scan.py.

Bitwise: perm and info.  The factors hold to 100 n eps max|A| (two
frameworks, two summation orders), the class tests/test_torch_lu.py uses.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu.linalg import lu as jlu
from slate_tpu.utils.testing import generate
from slate_tpu_torch.linalg import lu as tlu

# the suite runs in several worker processes that share the cores: one
# intra-op thread each (torch defaults to one a core, which oversubscribes them)
torch.set_num_threads(1)


def _eps(dtype):
    return float(np.finfo(dtype).eps)


def _same(jf, tf, a):
    """perm and info bitwise; lu within 100 n eps max|A|."""
    jlu_, jperm = (np.asarray(x) for x in jf[:2])
    tlu_, tperm = (x.numpy() for x in tf[:2])
    np.testing.assert_array_equal(tperm, jperm)
    if len(jf) == 3:
        assert int(tf[2]) == int(jf[2])
        assert tf[2].dtype == torch.int32
    n = min(a.shape)
    assert tlu_.shape == jlu_.shape
    assert np.abs(tlu_ - jlu_).max() <= 100 * n * _eps(a.dtype) * np.abs(a).max()


def _reconstructs(f, a):
    """P A = L U within 100 n eps |L||U| (the port's factor on its own)."""
    lu_, perm = f.lu.numpy().astype(np.complex128), f.perm.numpy()
    m, n = a.shape
    k = min(m, n)
    low = np.tril(lu_, -1)[:, :k] + np.eye(m, k)
    up = np.triu(lu_)[:k]
    bound = 100 * k * _eps(a.dtype) * (np.abs(low) @ np.abs(up))
    assert np.all(np.abs(a[perm] - low @ up) <= bound + 1e-300)


# (m, n, dtype): n in {64, 100}, a tall and a wide shape (n = 256 and c128
# in the no-pivot test: slate_tpu's recursive trace at 256 costs ~8 s here)
REC_CASES = [(64, 64, np.float32), (100, 100, np.complex64), (120, 70, np.float64),
             (4, 8, np.float64)]


@pytest.mark.parametrize("m,n,dtype", REC_CASES)
def test_getrf_array_matches_jax(m, n, dtype):
    a = generate("randn", m, n, dtype=dtype, seed=m + n)
    tf = tlu.getrf_array(torch.from_numpy(a))
    _same(jlu.getrf_array(jnp.asarray(a)), tf, a)
    _reconstructs(tf, a)
    assert np.abs(np.tril(tf.lu.numpy(), -1)).max() <= 1  # partial pivoting: |L| <= 1


def test_getrf_left_looking_matches_jax():
    """Three panels of 64 over n = 160 (padded to 192): the forward
    substitution, the Schur gemm, the recursive inverse panels and the
    history permutes."""
    a = generate("randn", 160, dtype=np.float64, seed=17)
    jl, jp = jlu._getrf_left_looking(jnp.asarray(a), nb=64)
    tl, tp = tlu._getrf_left_looking(torch.from_numpy(a), nb=64)
    _same((jl, jp), (tl, tp), a)
    assert tl.shape == (160, 160)


def test_getrf_rec_inv_returns_the_unit_l_inverse():
    a = generate("randn", 130, 96, dtype=np.float64, seed=18)  # leaves of 64 and 32
    jl, jp, ji = jlu._getrf_rec_inv(jnp.asarray(a))
    tl, tp, ti = tlu._getrf_rec_inv(torch.from_numpy(a))
    _same((jl, jp), (tl, tp), a)
    l11 = np.tril(tl.numpy()[:96], -1) + np.eye(96)
    assert np.abs(ti.numpy() @ l11 - np.eye(96)).max() < 1e3 * 96 * _eps(np.float64)
    assert np.abs(ti.numpy() - np.asarray(ji)).max() < 1e-10


def test_getrf_nopiv_matches_jax():
    for n, dtype in [(64, np.float64), (256, np.complex128)]:
        a = generate("randn", n, dtype=dtype, seed=n) + n * np.eye(n, dtype=dtype)
        tf = tlu.getrf_nopiv_array(torch.from_numpy(a))
        _same(jlu.getrf_nopiv_array(jnp.asarray(a)), tf, a)
        assert tf.perm.tolist() == list(range(n))


@pytest.mark.parametrize("n,nb,dtype", [(100, 16, np.float32), (64, 8, np.complex128)])
def test_getrf_tntpiv_matches_jax(n, nb, dtype):
    a = generate("randn", n, dtype=dtype, seed=n + nb)
    tf = tlu.getrf_tntpiv_array(torch.from_numpy(a), nb=nb)
    _same(jlu.getrf_tntpiv_array(jnp.asarray(a), nb=nb), tf, a)
    _reconstructs(tf, a)


# ---------------------------------------------------------------------------
# getrf_array's dispatch: a CUDA tensor takes slate_tpu's accelerator branch
# ---------------------------------------------------------------------------


class _OnCard(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``, to read the dispatch rule."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("n,dtype,on_card,form", [
    (4096, torch.float64, True, "left_looking"),
    (8192, torch.complex128, True, "left_looking"),
    (8256, torch.float64, True, "scan"),
    (4095, torch.float64, True, "rec"),
    (4096, torch.float32, True, "rec"),
    (8192, torch.float64, False, "rec"),
])
def test_getrf_array_dispatch(n, dtype, on_card, form, monkeypatch):
    calls = []

    def record(name):
        def fn(a, *args):
            calls.append(name)
            eye = torch.eye(2, dtype=dtype)
            out = (eye, torch.arange(2))
            return tlu.LUFactors(*out, tlu._lu_info(eye)) if name == "scan" else out
        return fn

    monkeypatch.setattr(tlu, "_getrf_left_looking", record("left_looking"))
    monkeypatch.setattr(tlu, "getrf_scan_array", record("scan"))
    monkeypatch.setattr(tlu, "_getrf_rec", record("rec"))
    a = torch.zeros((n, 1), dtype=dtype).expand(n, n)  # no n^2 storage
    if on_card:
        a = a.as_subclass(_OnCard)
    f = tlu.getrf_array(a)
    assert calls == [form] and int(f.info) == 0


def test_short_panel_window_raises():
    with pytest.raises(RuntimeError, match="window"):
        tlu._window(torch.zeros((10, 12)), 0, 8, 10, 8)
