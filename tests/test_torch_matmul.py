"""The port's matmul layer (slate_tpu_torch.ops.matmul and the blocked GEMM
of ops.kernels) against slate_tpu.ops.matmul.

``matmul_pallas``: the port's plain twin (what the wrapper runs on a CPU
tensor) against ``slate_tpu``'s Pallas kernel itself, run on the CPU under
``jax.experimental.pallas.tpu.force_tpu_interpret_mode()``, in f32 and bf16
at ragged shapes with the default and small blocks.  Both sum in f32 in
different orders, so they hold to ``utils.testing.matmul_pallas_excess``:
|C - C'| <= (1 + e) 9 sqrt(k) eps32 (|A||B|) + e |C'| elementwise (e = 0 for
f32, the dtype's eps for a bf16 output).  f64 and complex raise
``TypeError`` in the port (the TPU's Mosaic takes neither; ``slate_tpu``
runs them only in interpret mode).

The dispatch: each Precision tier, ``f64_emulation``, ``Precision.Emulated``
and the Ozaki branch, forced in both packages by the same monkeypatches as
``tests/test_ozaki.py`` (``_tpu_is_default`` True and a lowered gate), at
S = 9 and 6: the Ozaki products are bitwise equal across the packages.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from slate_tpu.types import Precision as JPrecision
from slate_tpu_torch.ops import kernels as tk
from slate_tpu_torch.types import Precision
from slate_tpu_torch.utils.testing import matmul_pallas_excess

# the suite runs in several worker processes that share the cores: one
# intra-op thread each (torch defaults to one a core, which oversubscribes them)
torch.set_num_threads(1)

jmm = importlib.import_module("slate_tpu.ops.matmul")
tmm = importlib.import_module("slate_tpu_torch.ops.matmul")

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, k)).astype(np.float32), rng.standard_normal((k, n)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,blocks", [
    ((200, 130, 70), (128, 128, 128)),   # ragged m, k, n against 128 blocks
    ((300, 257, 129), (512, 512, 512)),  # the default blocks, clamped
    ((260, 520, 140), (128, 256, 256)),  # several k blocks
])
def test_matmul_pallas_matches_the_interpreted_kernel(dtype, shape, blocks):
    m, k, n = shape
    a, b = _operands(m, k, n, sum(shape))
    with pltpu.force_tpu_interpret_mode():
        cj = jmm.matmul_pallas(jnp.asarray(a, _JDT[dtype]), jnp.asarray(b, _JDT[dtype]), *blocks)
    at, bt = _t(a).to(_TDT[dtype]), _t(b).to(_TDT[dtype])
    before = tk.matmul_pallas.launches
    ct = tmm.matmul_pallas(at, bt, *blocks)
    assert tk.matmul_pallas.launches == before  # a CPU call runs the twin, counts nothing
    assert ct.shape == (m, n) and ct.dtype == _TDT[dtype]
    want = torch.from_numpy(np.array(cj.astype(jnp.float32))).to(_TDT[dtype])
    assert matmul_pallas_excess(at, bt, ct, want) <= 1.0
    # and the f32 accumulation is real: far inside the bf16 input rounding
    ref = a.astype(np.float64) @ b.astype(np.float64)
    rel = np.abs(ct.float().numpy() - ref).max() / np.abs(ref).max()
    assert rel < (1e-5 if dtype == "float32" else 2e-2)


def test_matmul_pallas_blocks_keep_the_reference_clamp(monkeypatch):
    seen = []
    monkeypatch.setattr(tk, "matmul_pallas", lambda a, b, bm, bn, bk: seen.append((bm, bn, bk)))
    for (m, k, n), blocks in [((200, 130, 70), (512, 512, 512)), ((1000, 64, 3000), (512, 512, 512)),
                              ((129, 129, 129), (64, 1024, 128))]:
        tmm.matmul_pallas(torch.zeros((m, k)), torch.zeros((k, n)), *blocks)
        bm, bn, bk = blocks
        want = (min(bm, jmm._ceil_mult(m)), min(bn, jmm._ceil_mult(n)), min(bk, jmm._ceil_mult(k)))
        assert seen[-1] == want
    for x in (1, 127, 128, 129, 1000):
        assert tmm._ceil_mult(x) == jmm._ceil_mult(x)


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex64, torch.complex128])
def test_matmul_pallas_refuses_what_mosaic_refuses(dtype):
    a = torch.zeros((8, 8), dtype=dtype)
    with pytest.raises(TypeError, match="f32, bf16, f16"):
        tmm.matmul_pallas(a, a)
    with pytest.raises(TypeError):
        tk.matmul_pallas_plain(a, a)
    with pytest.raises(TypeError):  # mixed dtypes too
        tmm.matmul_pallas(torch.zeros((8, 8)), torch.zeros((8, 8), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="need"):
        tmm.matmul_pallas(torch.zeros((8, 4)), torch.zeros((8, 4)))


def test_default_dispatch_never_takes_the_pallas_gemm():
    assert tmm._use_pallas(torch.zeros(2, 2), torch.zeros(2, 2)) is False
    assert jmm._use_pallas(jnp.zeros((2, 2)), jnp.zeros((2, 2))) is False
    assert tmm._tpu_is_default() is False
    assert (tmm._OZAKI_MIN_ELEMS, tmm._OZAKI_MIN_DIM) == (jmm._OZAKI_MIN_ELEMS, jmm._OZAKI_MIN_DIM)


def test_precision_tiers_match_the_reference():
    a, b = _operands(48, 40, 24, 1)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    for tier in (Precision.Highest, Precision.High, Precision.Emulated):
        ct = tmm.matmul(_t(a), _t(b), precision=tier).numpy()
        cj = np.asarray(jmm.matmul(jnp.asarray(a), jnp.asarray(b), precision=JPrecision(tier.value)))
        assert np.abs(ct - cj).max() <= 2 * 40 * np.finfo(np.float32).eps * (np.abs(a) @ np.abs(b)).max()
    # Fast: operands rounded to bf16, products summed in f32 (the MXU's
    # DEFAULT; XLA:CPU ignores the precision, so the check is against that)
    fast = tmm.matmul(_t(a), _t(b), precise=False).numpy()
    a16 = _t(a).to(torch.bfloat16).double().numpy()
    b16 = _t(b).to(torch.bfloat16).double().numpy()
    assert np.abs(fast - a16 @ b16).max() < 1e-5 * np.abs(ref).max()
    assert np.abs(fast - ref).max() > 1e-4 * np.abs(ref).max()
    # f64 keeps the plain product off a TPU in both packages
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    c64 = tmm.matmul(_t(a64), _t(b64)).numpy()
    assert np.abs(c64 - np.asarray(jmm.matmul(jnp.asarray(a64), jnp.asarray(b64)))).max() < 1e-13


def _force_ozaki(monkeypatch):
    # the same monkeypatches as tests/test_ozaki.py, on both packages
    for mod in (jmm, tmm):
        monkeypatch.setattr(mod, "_tpu_is_default", lambda: True)
        monkeypatch.setattr(mod, "_use_pallas", lambda *_: False)
        monkeypatch.setattr(mod, "_OZAKI_MIN_ELEMS", 256**3)
        monkeypatch.setattr(mod, "_OZAKI_MIN_DIM", 256)


def test_forced_ozaki_branch_is_bitwise_the_reference(monkeypatch):
    _force_ozaki(monkeypatch)
    rng = np.random.default_rng(3)
    A = rng.standard_normal((256, 256))
    B = rng.standard_normal((256, 256))
    REF = A @ B
    for tier, jtier, gate in ((None, None, 1e-13), (Precision.Fast, JPrecision.Fast, 1e-8)):
        ct = tmm.matmul(_t(A), _t(B), precision=tier).numpy()
        cj = np.asarray(jmm.matmul(jnp.asarray(A), jnp.asarray(B), precision=jtier))
        np.testing.assert_array_equal(ct, cj)  # S = 9 / S = 6 on both sides
        assert np.abs(ct - REF).max() / np.abs(REF).max() < gate
    # the Fast tier really took 6 slices (less accurate than 9)
    c9 = tmm.matmul(_t(A), _t(B)).numpy()
    c6 = tmm.matmul(_t(A), _t(B), precise=False).numpy()
    assert np.abs(c6 - REF).max() > np.abs(c9 - REF).max()
    ac, bc = A + 1j * A[::-1], B - 1j * B
    ct = tmm.matmul(_t(ac), _t(bc)).numpy()
    np.testing.assert_array_equal(ct, np.asarray(jmm.matmul(jnp.asarray(ac), jnp.asarray(bc))))
    assert np.abs(ct - ac @ bc).max() / np.abs(ac @ bc).max() < 1e-12


def test_ozaki_opt_outs_and_gate(monkeypatch):
    _force_ozaki(monkeypatch)
    rng = np.random.default_rng(4)
    A = rng.standard_normal((256, 256))
    B = rng.standard_normal((256, 256))
    oz = tmm.matmul(_t(A), _t(B)).numpy()
    plain = (_t(A) @ _t(B)).numpy()
    assert not np.array_equal(oz, plain)  # the branch is taken
    np.testing.assert_array_equal(tmm.matmul(_t(A), _t(B), precision=Precision.Emulated).numpy(),
                                  plain)
    with tmm.f64_emulation():
        np.testing.assert_array_equal(tmm.matmul(_t(A), _t(B)).numpy(), plain)
    assert tmm._F64_DISPATCH["ozaki"] is True
    small = rng.standard_normal((32, 40)), rng.standard_normal((40, 24))
    np.testing.assert_array_equal(tmm.matmul(*map(_t, small)).numpy(),
                                  (_t(small[0]) @ _t(small[1])).numpy())
    # f32 never takes the f64 branch
    a32 = _t(A.astype(np.float32))
    np.testing.assert_array_equal(tmm.matmul(a32, a32).numpy(), (a32 @ a32).numpy())
