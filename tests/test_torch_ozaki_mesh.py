"""The port's Ozaki mesh SUMMA (parallel.summa.gemm_summa_ozaki) against
slate_tpu.parallel.summa's.

BITWISE across the packages and across the (2, 4), (1, 8) and (2, 2) grids
(the digit grids come from global row and column maxima, the f64 fold
follows the logical k order), with and without a presplit A carried over
from ``slate_tpu`` through ``utils.testing.ozaki_split_from_numpy``.  The
audited broadcast bytes equal ``residual_comm_bytes`` and ``slate_tpu``'s
audit: exactly 9/8 of the f64 GemmC volume under psum and ring.  The
stationary-A plane cache keys on the tensor's storage and version: an
in-place write misses, a reuse counts ``ozaki_presplit_hits``.  n = 96,
nb = 16, two right-hand sides (``tests/test_mixed_mesh.py``'s shapes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import cpu_devices

from slate_tpu.parallel import from_dense as jfrom_dense
from slate_tpu.parallel import make_mesh as jmake_mesh
from slate_tpu.parallel import to_dense as jto_dense
from slate_tpu.parallel.comm import comm_audit as jcomm_audit
from slate_tpu.parallel.dist_refine import residual_comm_bytes as jresidual_comm_bytes
from slate_tpu.parallel.summa import gemm_summa as jgemm_summa
from slate_tpu.parallel.summa import gemm_summa_ozaki as jgemm_summa_ozaki
from slate_tpu.parallel.summa import ozaki_presplit as jozaki_presplit
from slate_tpu.types import MethodGemm as JMethodGemm
from slate_tpu_torch.obs.metrics import serve_counts
from slate_tpu_torch.parallel import from_dense, make_mesh, to_dense
from slate_tpu_torch.parallel import summa as tsumma
from slate_tpu_torch.parallel.comm import comm_audit
from slate_tpu_torch.parallel.dist_refine import residual_comm_bytes
from slate_tpu_torch.types import MethodGemm
from slate_tpu_torch.utils.testing import ozaki_split_from_numpy

# the suite runs in several worker processes that share the cores: one
# intra-op thread each (torch defaults to one a core, which oversubscribes them)
torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _same(j, t):
    j, t = np.asarray(j), t.numpy()
    assert j.shape == t.shape and j.dtype == t.dtype
    np.testing.assert_array_equal(j.view(np.uint8), t.view(np.uint8))


N, NB = 96, 16


def _residual_operands(seed=42):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((N, N)) + N * np.eye(N)
    return a, rng.standard_normal((N, 2)), rng.standard_normal((N, 2))


@pytest.mark.parametrize("grid", [(2, 4), (1, 8), (2, 2)])
def test_gemm_summa_ozaki_is_bitwise_the_reference_on_every_grid(grid):
    p, q = grid
    a, x, b = _residual_operands()
    jm = jmake_mesh(p, q, devices=cpu_devices(p * q))
    tm = make_mesh(p, q, device="cpu")
    cj = jto_dense(jgemm_summa_ozaki(-1.0, jfrom_dense(jnp.asarray(a), jm, NB, diag_pad_one=True),
                                     jfrom_dense(jnp.asarray(x), jm, NB), 1.0,
                                     jfrom_dense(jnp.asarray(b), jm, NB)))
    ad = from_dense(_t(a), tm, NB, diag_pad_one=True)
    ct = to_dense(tsumma.gemm_summa_ozaki(-1.0, ad, from_dense(_t(x), tm, NB), 1.0,
                                          from_dense(_t(b), tm, NB)))
    _same(cj, ct)
    assert np.abs(ct.numpy() - (b - a @ x)).max() < 1e-11
    # the 2 x 4 grid's result on every grid (the fold follows the logical k)
    ref = tsumma.gemm_summa_ozaki(-1.0, from_dense(_t(a), make_mesh(2, 4, device="cpu"), NB,
                                                   diag_pad_one=True),
                                  from_dense(_t(x), make_mesh(2, 4, device="cpu"), NB), 1.0,
                                  from_dense(_t(b), make_mesh(2, 4, device="cpu"), NB))
    _same(to_dense(ref).numpy(), ct)


def test_presplit_carried_from_the_reference_is_bitwise_the_inline_split():
    a, x, b = _residual_operands(3)
    jm = jmake_mesh(2, 4, devices=cpu_devices(8))
    tm = make_mesh(2, 4, device="cpu")
    js = jozaki_presplit(jfrom_dense(jnp.asarray(a), jm, NB, diag_pad_one=True))
    ad = from_dense(_t(a), tm, NB, diag_pad_one=True)
    ts = tsumma.ozaki_presplit(ad)
    _same(js.qa, ts.qa)
    _same(js.ea, ts.ea)
    carried = ozaki_split_from_numpy(np.asarray(js.qa), np.asarray(js.ea), tm)
    xd, bd = from_dense(_t(x), tm, NB), from_dense(_t(b), tm, NB)
    inline = tsumma.gemm_summa_ozaki(-1.0, ad, xd, 1.0, bd).tiles
    _same(inline.numpy(), tsumma.gemm_summa_ozaki(-1.0, ad, xd, 1.0, bd, a_split=carried).tiles)
    _same(inline.numpy(), tsumma.gemm_summa_ozaki(-1.0, ad, xd, 1.0, bd, a_split=ts).tiles)
    with pytest.raises(ValueError, match="planes"):
        tsumma.gemm_summa_ozaki(-1.0, ad, xd, 1.0, bd, n_slices=6, a_split=ts)
    with pytest.raises(TypeError, match="f64"):
        tsumma.gemm_summa_ozaki(-1.0, ad, from_dense(_t(x).float(), tm, NB))
    with pytest.raises(ValueError, match="ozaki_split_from_numpy"):
        ozaki_split_from_numpy(np.asarray(js.qa).astype(np.int16), np.asarray(js.ea), tm)


def test_presplit_cache_misses_after_an_in_place_write():
    a, _, _ = _residual_operands(9)
    tm = make_mesh(2, 4, device="cpu")
    tsumma.clear_ozaki_split_cache()
    ad = from_dense(_t(a), tm, NB, diag_pad_one=True)
    c0 = serve_counts()
    s1 = tsumma.ozaki_presplit_cached(ad)
    s2 = tsumma.ozaki_presplit_cached(ad)
    c1 = serve_counts()
    assert s2 is s1
    assert c1["ozaki_presplits"] - c0["ozaki_presplits"] == 1
    assert c1["ozaki_presplit_hits"] - c0["ozaki_presplit_hits"] == 1
    # a write into A's tiles in place (as matmul_sub_ / overwrite_a do)
    ad.tiles[0, 0, 0, 0] += 1.0
    s3 = tsumma.ozaki_presplit_cached(ad)
    c2 = serve_counts()
    assert s3 is not s1
    assert c2["ozaki_presplits"] - c1["ozaki_presplits"] == 1
    assert c2["ozaki_presplit_hits"] == c1["ozaki_presplit_hits"]
    assert not torch.equal(s3.qa, s1.qa)
    _same(tsumma.ozaki_presplit(ad).qa.numpy(), s3.qa)
    # another n_slices is another entry; an operand above the byte ceiling bypasses
    assert tsumma.ozaki_presplit_cached(ad, 6).qa.shape[0] == 6
    tsumma.clear_ozaki_split_cache()


def test_presplit_cache_misses_after_a_write_past_the_version_counter():
    """Writes through ``.data`` and through a numpy alias of A's tiles leave
    the version counter (the cache key) as it was; the hit's bitwise check
    against the entry's copy misses, and the planes are A's new ones."""
    a, _, _ = _residual_operands(9)
    tm = make_mesh(2, 4, device="cpu")
    tsumma.clear_ozaki_split_cache()
    ad = from_dense(_t(a), tm, NB, diag_pad_one=True)
    s1 = tsumma.ozaki_presplit_cached(ad)
    version = ad.tiles._version
    alias = ad.tiles.numpy()
    for write in (lambda: ad.tiles.data[0, 0, 1, 2].mul_(3.0), lambda: alias.__setitem__(
            (1, 0, 0, 0), alias[1, 0, 0, 0] + 1.0)):
        write()
        assert ad.tiles._version == version  # the key is unchanged
        c0 = serve_counts()
        s2 = tsumma.ozaki_presplit_cached(ad)
        c1 = serve_counts()
        assert s2 is not s1 and not torch.equal(s2.qa, s1.qa)
        assert c1["ozaki_presplits"] - c0["ozaki_presplits"] == 1
        assert c1["ozaki_presplit_hits"] == c0["ozaki_presplit_hits"]
        _same(tsumma.ozaki_presplit(ad).qa.numpy(), s2.qa)
        assert tsumma.ozaki_presplit_cached(ad) is s2  # the new planes are a hit
        s1 = s2
    tsumma.clear_ozaki_split_cache()


AUDIT_NB = 11  # a tile size of this file alone (see the audit test)


def _total(records):
    return sum(nbytes * m for _, nbytes, m in records)


@pytest.mark.parametrize("impl", ["psum", "ring"])
def test_ozaki_residual_comm_volume_is_the_reference(impl):
    """9 int8 planes on the f64 schedule: exactly 9/8 of the f64 GemmC
    volume, equal to residual_comm_bytes and to slate_tpu's audit."""
    p, q = 2, 4
    nb = AUDIT_NB
    rng = np.random.default_rng(5)
    a = rng.standard_normal((8 * nb, 8 * nb)) + 8 * nb * np.eye(8 * nb)
    x, b = rng.standard_normal((8 * nb, 2)), rng.standard_normal((8 * nb, 2))
    tm = make_mesh(p, q, device="cpu")
    ad = from_dense(_t(a), tm, nb, diag_pad_one=True)
    xd, bd = from_dense(_t(x), tm, nb), from_dense(_t(b), tm, nb)
    mt, ntb, kt = ad.tiles.shape[0], bd.tiles.shape[1], ad.nt
    with comm_audit() as oz:
        tsumma.gemm_summa_ozaki(-1.0, ad, xd, 1.0, bd, bcast_impl=impl)
    with comm_audit() as f64:
        tsumma.gemm_summa(-1.0, ad, xd, 1.0, bd, method=MethodGemm.GemmC, bcast_impl=impl)
    expect_oz = residual_comm_bytes(mt, ntb, kt, nb, p, q, impl, "ozaki")
    expect_f64 = residual_comm_bytes(mt, ntb, kt, nb, p, q, impl, "f64")
    assert _total(oz) == expect_oz and _total(f64) == expect_f64
    assert _total(oz) * 8 == _total(f64) * 9
    assert expect_oz == jresidual_comm_bytes(mt, ntb, kt, nb, p, q, impl, "ozaki")
    # slate_tpu audits when it traces: shapes no other test compiles
    # (nb = AUDIT_NB) make these its first traces, without clearing the caches
    jm = jmake_mesh(p, q, devices=cpu_devices(8))
    jad = jfrom_dense(jnp.asarray(a), jm, nb, diag_pad_one=True)
    jxd, jbd = jfrom_dense(jnp.asarray(x), jm, nb), jfrom_dense(jnp.asarray(b), jm, nb)
    with jcomm_audit() as joz:
        jgemm_summa_ozaki(-1.0, jad, jxd, 1.0, jbd, bcast_impl=impl).tiles.block_until_ready()
    with jcomm_audit() as jf64:
        jgemm_summa(-1.0, jad, jxd, 1.0, jbd, method=JMethodGemm.GemmC,
                    bcast_impl=impl).tiles.block_until_ready()
    assert _total(joz) == _total(oz) and _total(jf64) == _total(f64)
