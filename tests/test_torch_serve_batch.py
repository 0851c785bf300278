"""The port's stacked batch drivers, bins and block-diagonal packing against
slate_tpu's serve/batch.py, and the serving verbs of api.py.

Within the port each stacked row is bitwise its single verb (the loop's
contract, slate_tpu's ``lax.map`` one).  Against slate_tpu: ``bin_for``,
``pad_to_bin``, ``pad_rhs_to_bin`` and ``pack_block_diag`` /
``unpack_block_diag`` bitwise on the same arrays, ``packed_problems``
deltas exactly; the solutions in the class of the driver that ran (posv /
gesv at n <= 64: elementwise within 1e-10 relative of slate_tpu's; the
mesh posv at nb = 8: 1e-8 of the library solve, as tests/test_serve.py).
A packed solution is bitwise the same problem packed alone, also with a
bin (20) that is not a multiple of the mesh tile (8), where a tile
straddles two problems.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_serve_common import counter_deltas, j, spd_np, spd_stack_np, t, tmesh24

from slate_tpu.serve import batch as jbatch
from slate_tpu.serve.table import TUNED_SCHEMA, TUNED_VERSION
from slate_tpu_torch import api
from slate_tpu_torch.linalg.chol import posv_array, potrf_array
from slate_tpu_torch.linalg.lu import gesv_array
from slate_tpu_torch.serve import batch
from slate_tpu_torch.serve.table import use_tuned_table
from slate_tpu_torch.types import MethodLU, Option

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    yield
    jax.clear_caches()
    gc.collect()


def _table(entries):
    return {"schema": TUNED_SCHEMA, "version": TUNED_VERSION, "entries": entries}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_batched_rows_bitwise_their_single_verbs(rng, dtype):
    B, n, nrhs = 3, 48, 2
    spd = t(spd_stack_np(rng, B, n)).to(dtype)
    b = t(rng.standard_normal((B, n, nrhs))).to(dtype)
    xs, info = batch.posv_batched(spd, b)
    assert info.dtype == torch.int32 and bool((info == 0).all())
    for i in range(B):
        assert torch.equal(xs[i], posv_array(spd[i], b[i])[0])
    ga = t(rng.standard_normal((B, n, n)) + n * np.eye(n)[None]).to(dtype)
    for method in (MethodLU.PartialPiv, MethodLU.NoPiv):
        xg, infog = batch.gesv_batched(ga, b, method)
        assert bool((infog == 0).all())
        for i in range(B):
            assert torch.equal(xg[i], gesv_array(ga[i], b[i], method)[0])
    l, infol = batch.potrf_batched(spd)
    for i in range(B):
        li, ii = potrf_array(spd[i])
        assert torch.equal(l[i], li) and int(infol[i]) == int(ii)


def test_batched_drivers_match_jax(rng):
    """posv / gesv / potrf / gemm stacks against slate_tpu's lax.map forms
    on the same arrays."""
    B, n = 3, 40
    spd = spd_stack_np(rng, B, n)
    ga = rng.standard_normal((B, n, n)) + n * np.eye(n)[None]
    b = rng.standard_normal((B, n, 2))
    xj, ij = jbatch.posv_batched(j(spd), j(b))
    xt, it = batch.posv_batched(t(spd), t(b))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-10, atol=1e-13)
    assert it.tolist() == np.asarray(ij).tolist()
    xj, ij = jbatch.gesv_batched(j(ga), j(b))
    xt, it = batch.gesv_batched(t(ga), t(b))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-10, atol=1e-13)
    assert it.tolist() == np.asarray(ij).tolist()
    lj, ij = jbatch.potrf_batched(j(spd))
    lt, it = batch.potrf_batched(t(spd))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-12, atol=1e-13)
    c = rng.standard_normal((B, n, 2))
    gj = jbatch.gemm_batched(0.5, j(ga), j(b), 2.0, j(c))
    gt = batch.gemm_batched(0.5, t(ga), t(b), 2.0, t(c))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-12, atol=1e-12)
    assert tuple(batch.gemm_batched(1.0, t(ga), t(b)).shape) == (B, n, 2)
    assert set(batch.BATCHED_DRIVERS) == set(jbatch.BATCHED_DRIVERS)


def test_non_spd_row_reports_its_own_info(rng):
    spd = spd_stack_np(rng, 3, 16)
    spd[1] = -np.eye(16)
    b = rng.standard_normal((3, 16, 1))
    xj, ij = jbatch.posv_batched(j(spd), j(b))
    xt, it = batch.posv_batched(t(spd), t(b))
    assert it.tolist() == np.asarray(ij).tolist() and it.tolist()[1] != 0
    assert torch.equal(xt[0], posv_array(t(spd[0]), t(b[0]))[0])


@pytest.mark.parametrize("n", [1, 100, 128, 129, 256, 1000, 4096, 4097])
def test_bin_for_matches_jax(n):
    assert batch.bin_for(n) == jbatch.bin_for(n)
    assert batch.bin_for(n, (48, 16)) == jbatch.bin_for(n, (48, 16))
    assert batch.DEFAULT_BINS == jbatch.DEFAULT_BINS


@pytest.mark.parametrize("n,m,factorizable", [(5, 8, True), (5, 8, False), (8, 8, True),
                                              (1, 16, True), (13, 20, True)])
def test_pad_to_bin_bitwise_jax(rng, n, m, factorizable):
    a = rng.standard_normal((n, n))
    got = batch.pad_to_bin(t(a), m, factorizable).numpy()
    np.testing.assert_array_equal(got, np.asarray(jbatch.pad_to_bin(j(a), m, factorizable)))
    rhs = rng.standard_normal((n, 3))
    np.testing.assert_array_equal(batch.pad_rhs_to_bin(t(rhs), m).numpy(),
                                  np.asarray(jbatch.pad_rhs_to_bin(j(rhs), m)))
    with pytest.raises(ValueError, match="exceeds bin"):
        batch.pad_to_bin(t(rng.standard_normal((m + 1, m + 1))), m)


@pytest.mark.parametrize("sizes,m", [([20, 33, 64], 64), ([7, 8], 8), ([13, 20, 1, 17], 20)])
def test_pack_and_unpack_bitwise_jax(rng, sizes, m):
    ops_ = [spd_np(rng, s) for s in sizes]
    rhs_ = [rng.standard_normal((s, 1 + i % 3)) for i, s in enumerate(sizes)]
    with counter_deltas() as d:
        aj, bj = jbatch.pack_block_diag([j(o) for o in ops_], m, [j(r) for r in rhs_])
        at, bt = batch.pack_block_diag([t(o) for o in ops_], m, [t(r) for r in rhs_])
    assert d["jax"] == d["torch"] == {"packed_problems": len(sizes)}
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    x = rng.standard_normal(bt.shape)
    nr = [r.shape[1] for r in rhs_]
    for got, want in zip(batch.unpack_block_diag(t(x), sizes, m, nr),
                         jbatch.unpack_block_diag(j(x), sizes, m, nr)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    a_only, none = batch.pack_block_diag([t(o) for o in ops_], m)
    assert none is None and torch.equal(a_only, at)


def _packed_alone(ops_, rhs_, sizes, m, i, solve):
    """Problem i packed with identity neighbours and zero right-hand sides."""
    k = len(sizes)
    eye = torch.eye(m, dtype=torch.float64)
    zero = torch.zeros((m, rhs_[0].shape[1]), dtype=torch.float64)
    a, b = batch.pack_block_diag([ops_[q] if q == i else eye for q in range(k)], m,
                                 [rhs_[q] if q == i else zero for q in range(k)])
    return batch.unpack_block_diag(solve(a, b), sizes, m)[i]


def test_pack_roundtrip_bitwise_packed_alone(rng):
    """tests/test_serve.py's round trip: each unpacked solution bitwise the
    problem packed alone, and the unpadded solve to 1e-10."""
    m, sizes, nrhs = 64, [20, 33, 64], 2
    ops_ = [t(spd_np(rng, s)) for s in sizes]
    rhs_ = [t(rng.standard_normal((s, nrhs))) for s in sizes]
    a, b = batch.pack_block_diag(ops_, m, rhs_)
    x, _f, info = posv_array(a, b)
    assert int(info) == 0
    got = batch.unpack_block_diag(x, sizes, m, [nrhs] * 3)
    for i in range(3):
        ref = _packed_alone(ops_, rhs_, sizes, m, i, lambda aa, bb: posv_array(aa, bb)[0])
        assert torch.equal(got[i], ref)
        lone = np.linalg.solve(ops_[i].numpy(), rhs_[i].numpy())
        assert np.abs(got[i].numpy() - lone).max() < 1e-10


@pytest.mark.parametrize("m", [20, 24])
def test_mesh_pack_bitwise_packed_alone_straddling_tiles(rng, m):
    """The mesh posv at nb = 8 on 2 x 4: with bin 20 tiles straddle two
    problems (20 is not a multiple of 8), and each problem's solution is
    still bitwise the problem packed alone (the panel kernel twins' explicit
    inverse of a mixed diagonal tile keeps the blocks apart); bin 24 is the
    aligned control."""
    from slate_tpu_torch.parallel.drivers import posv_mesh

    mesh = tmesh24()
    sizes = [m, m - 3, m - 7, m - 1]
    ops_ = [t(spd_np(rng, s)) for s in sizes]
    rhs_ = [t(rng.standard_normal((s, 2))) for s in sizes]
    opts = {Option.MixedPrecision: "off", Option.PanelImpl: "pallas"}

    def solve(a, b):
        x, info = posv_mesh(a, b, mesh, 8, opts)
        assert int(info) == 0
        return x

    a, b = batch.pack_block_diag(ops_, m, rhs_)
    got = batch.unpack_block_diag(solve(a, b), sizes, m)
    for i in range(len(sizes)):
        assert torch.equal(got[i], _packed_alone(ops_, rhs_, sizes, m, i, solve))
        lone = np.linalg.solve(ops_[i].numpy(), rhs_[i].numpy())
        assert np.abs(got[i].numpy() - lone).max() < 1e-10


def test_posv_packed_mesh_consumes_tuned_table(rng):
    """The packed mesh solve resolves unset options through the tuned table
    (nb 8 from the table's n = 128 entry), and its solutions agree with
    slate_tpu's packed mesh solve and the library's."""
    from slate_tpu.serve.table import use_tuned_table as juse_tuned_table

    from torch_serve_common import jmesh24

    sizes = [48, 64]
    ops_ = [spd_np(rng, s) for s in sizes]
    rhs_ = [rng.standard_normal((s, 2)) for s in sizes]
    tbl = _table({"posv|n=128|dtype=float64|grid=2x4":
                  {"bcast_impl": "ring", "lookahead": 0, "nb": 8}})
    with counter_deltas() as d:
        with juse_tuned_table(tbl):
            xj, ij = jbatch.posv_packed_mesh([j(o) for o in ops_], [j(r) for r in rhs_],
                                             jmesh24(), bins=(64,))
        with use_tuned_table(tbl):
            xt, it = batch.posv_packed_mesh([t(o) for o in ops_], [t(r) for r in rhs_],
                                            tmesh24(), bins=(64,))
    assert d["jax"] == d["torch"]
    assert d["torch"]["tuned_resolutions"] == 1 and d["torch"]["packed_problems"] == 2
    assert int(it) == int(ij) == 0
    for i in range(2):
        ref = np.linalg.solve(ops_[i], rhs_[i])
        assert np.abs(xt[i].numpy() - ref).max() < 1e-8
        np.testing.assert_allclose(xt[i].numpy(), np.asarray(xj[i]), rtol=1e-9, atol=1e-11)


def test_api_batched_verbs(rng):
    B, n = 2, 24
    spd = spd_stack_np(rng, B, n)
    ga = rng.standard_normal((B, n, n)) + n * np.eye(n)[None]
    b = rng.standard_normal((B, n, 3))
    x, info = api.chol_solve_batched(t(spd), t(b))
    ref = batch.posv_batched(t(spd), t(b))
    assert torch.equal(x, ref[0]) and torch.equal(info, ref[1])
    x, info = api.lu_solve_batched(spd, b, device="cpu")  # numpy operands on the host
    assert x.device.type == "cpu" and torch.equal(x, batch.gesv_batched(t(spd), t(b))[0])
    x, _ = api.lu_solve_batched(t(ga), t(b), MethodLU.NoPiv)
    assert torch.equal(x, batch.gesv_batched(t(ga), t(b), MethodLU.NoPiv)[0])
    c = api.multiply_batched(1.0, t(ga), t(b))
    np.testing.assert_allclose(c.numpy(), np.einsum("bij,bjk->bik", ga, b), rtol=1e-12)
    c2 = api.multiply_batched(2.0, ga, b, 1.0, c.numpy(), device="cpu")
    np.testing.assert_allclose(c2.numpy(), 3 * c.numpy(), rtol=1e-12)


def test_numpy_operands_go_to_the_card(rng, monkeypatch):
    """Numpy operands of the serving verbs go to the card: with one present
    the outputs lie there; without one they raise rather than fall back to
    the host (``device="cpu"`` asks for the host)."""
    spd = spd_stack_np(rng, 2, 8)
    b = rng.standard_normal((2, 8, 1))
    monkeypatch.setenv("SLATE_TPU_HBM_BYTES", str(1 << 30))
    if torch.cuda.is_available():
        x, info = api.chol_solve_batched(spd, b)
        assert x.is_cuda and info.is_cuda
        r = api.serve_router(bins=(8,))
        assert r.solve("posv", spd[0], b[0]).is_cuda
        return
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        api.chol_solve_batched(spd, b)
    r = api.serve_router(bins=(8,))
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        r.solve("posv", spd[0], b[0])
    monkeypatch.delenv("SLATE_TPU_HBM_BYTES")
    with pytest.raises((AssertionError, RuntimeError, ValueError)):
        api.serve_router()  # the default budget is the card's memory
    host = api.serve_router(bins=(8,), device="cpu", hbm_budget=1 << 30)
    assert host.solve("posv", spd[0], b[0]).device.type == "cpu"
    assert api.chol_solve_batched(spd, b, device="cpu")[0].device.type == "cpu"


def test_jnp_pack_dtype_roundtrip_f32(rng):
    """f32 packing keeps the dtype and matches slate_tpu's bitwise."""
    ops_ = [spd_np(rng, 5).astype(np.float32), spd_np(rng, 7).astype(np.float32)]
    aj, _ = jbatch.pack_block_diag([jnp.asarray(o) for o in ops_], 8)
    at, _ = batch.pack_block_diag([t(o) for o in ops_], 8)
    assert at.dtype == torch.float32
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
