"""The port's distributed LU solves (slate_tpu_torch.parallel) against
slate_tpu.parallel.

The same seeded numpy operands go through ``slate_tpu``'s mesh LU drivers on
the 8 forced CPU devices of conftest.py (a 2 x 4 mesh; PanelImpl and
UpdateImpl ``pallas``, so the three LU Pallas kernels run interpreted) and
through the port's drivers on a virtual 2 x 4 mesh on the CPU, where the
kernel wrappers take their plain twins.  n = 64 and a padded n = 100,
nb = 8, f32 and f64, for ``gesv_mesh`` (partial pivoting),
``gesv_nopiv_mesh`` and ``gesv_tntpiv_mesh``.

Bitwise: pivot vectors, info codes, audited comm bytes per op, and the
port's own results across lookahead depths and broadcast lowerings.  The
factors hold to 100 n eps max|A| (two frameworks, two summation orders, the
explicit-inverse LU panels), and both solutions to the backward-error gate
eta < 100 n eps.
"""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import cpu_devices

from slate_tpu import types as jt
from slate_tpu.parallel import comm as jcomm
from slate_tpu.parallel import drivers as jdrv
from slate_tpu.parallel import from_dense as jfrom_dense
from slate_tpu.parallel import make_mesh as jmake_mesh
from slate_tpu.parallel import to_dense as jto_dense
from slate_tpu.parallel import trsm_dist as jtrsm_dist
from slate_tpu.parallel.dist_lu import getrf_nopiv_dist as jgetrf_nopiv_dist
from slate_tpu.parallel.dist_lu import getrf_pp_dist as jgetrf_pp_dist
from slate_tpu.parallel.dist_lu import getrf_tntpiv_dist as jgetrf_tntpiv_dist
from slate_tpu.parallel.dist_lu import permute_rows_dist as jpermute_rows_dist
from slate_tpu.utils.testing import generate
from slate_tpu_torch import types as tt
from slate_tpu_torch.ops import kernels as tk
from slate_tpu_torch.parallel import comm as tcomm
from slate_tpu_torch.parallel import dist_refine as trefine
from slate_tpu_torch.parallel import dryrun as tdry
from slate_tpu_torch import parallel as tp
from slate_tpu_torch.utils.testing import dist_from_numpy

# the suite runs in several worker processes that share the cores: one
# intra-op thread each (torch defaults to one a core, which oversubscribes them)
torch.set_num_threads(1)

NB = 8
DTYPES = [np.float32, np.float64]
SIZES = [64, 100]  # 100: a padded tile grid (13 tiles -> 16)
FORMS = ["pp", "nopiv", "tntpiv"]

_J_GETRF = {"pp": jdrv.getrf_mesh, "nopiv": jdrv.getrf_nopiv_mesh, "tntpiv": jdrv.getrf_tntpiv_mesh}
_J_GESV = {"pp": jdrv.gesv_mesh, "nopiv": jdrv.gesv_nopiv_mesh, "tntpiv": jdrv.gesv_tntpiv_mesh}
_T_GETRF = {"pp": tp.getrf_mesh, "nopiv": tp.getrf_nopiv_mesh, "tntpiv": tp.getrf_tntpiv_mesh}
_T_GESV = {"pp": tp.gesv_mesh, "nopiv": tp.gesv_nopiv_mesh, "tntpiv": tp.gesv_tntpiv_mesh}
_J_DIST = {"pp": jgetrf_pp_dist, "nopiv": jgetrf_nopiv_dist, "tntpiv": jgetrf_tntpiv_dist}
_T_DIST = {"pp": tp.getrf_pp_dist, "nopiv": tp.getrf_nopiv_dist, "tntpiv": tp.getrf_tntpiv_dist}


def _eps(dtype):
    return float(np.finfo(dtype).eps)


def _jmesh():
    return jmake_mesh(2, 4, devices=cpu_devices(8))


def _tmesh():
    return tp.make_mesh(2, 4, device="cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _operands(form, n, dtype, nrhs=5, seed=0):
    """A general random system; the no-pivot form gets + n I (diagonally
    dominant, so it factors stably without pivoting)."""
    a = generate("randn", n, dtype=dtype, seed=seed + n)
    if form == "nopiv":
        a = a + n * np.eye(n, dtype=dtype)
    b = generate("randn", n, nrhs, dtype=dtype, seed=seed + n + 1)
    return a, b


def _eta(a, x, b):
    n = a.shape[0]
    return np.abs(a @ x - b).max() / (np.abs(a).max() * np.abs(x).max() * n + np.abs(b).max())


@pytest.fixture(autouse=True)
def _default_impls(monkeypatch):
    for env in (tk.PANEL_IMPL_ENV, tk.UPDATE_IMPL_ENV, tcomm.BCAST_IMPL_ENV, trefine.MIXED_ENV,
                "SLATE_TPU_CKPT"):
        monkeypatch.delenv(env, raising=False)


_J_OPTS = {jt.Option.PanelImpl: "pallas", jt.Option.UpdateImpl: "pallas",
           jt.Option.NumMonitor: "off", jt.Option.MixedPrecision: "off"}
_T_OPTS = {tt.Option.MixedPrecision: "off"}


# ---------------------------------------------------------------------------
# JAX references, computed once per configuration
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_lu(form, n, dtype_name):
    dtype = np.dtype(dtype_name).type
    a, b = _operands(form, n, dtype)
    mesh = _jmesh()
    out = _J_GETRF[form](jnp.asarray(a), mesh, NB, opts=_J_OPTS)
    x, info_s = _J_GESV[form](jnp.asarray(a), jnp.asarray(b), mesh, NB, opts=_J_OPTS)
    return {"lu": np.asarray(jto_dense(out[0])), "tiles": np.asarray(out[0].tiles),
            "perm": None if form == "nopiv" else np.asarray(out[1]),
            "info": int(out[-1]), "x": np.asarray(x), "info_solve": int(info_s)}


def _port_lu(form, n, dtype, **opts):
    a, b = _operands(form, n, dtype)
    mesh = _tmesh()
    topts = {**_T_OPTS, **{tt.Option[k]: v for k, v in opts.items()}}
    out = _T_GETRF[form](_t(a), mesh, NB, opts=topts)
    x, info_s = _T_GESV[form](_t(a), _t(b), mesh, NB, opts=topts)
    return {"lu": tp.to_dense(out[0]).numpy(), "tiles": out[0].tiles.numpy(),
            "perm": None if form == "nopiv" else out[1].numpy(),
            "info": int(out[-1]), "x": x.numpy(), "info_solve": int(info_s)}


# ---------------------------------------------------------------------------
# comm audit: bytes per op equal to slate_tpu's, under every lowering
# (a unique shape per lowering: slate_tpu records at trace time)
# ---------------------------------------------------------------------------


def _totals(records):
    out = {}
    for op, nbytes, mult in records:
        out[op] = out.get(op, 0) + nbytes * mult
    return out


@pytest.mark.parametrize("impl,n", [("psum", 40), ("ring", 56), ("doubling", 72)])
def test_lu_audit_bytes_match_jax(impl, n):
    # permute_rows_dist once (pp): a second call at the same shapes is a jit
    # cache hit in slate_tpu and records nothing
    nb = 4
    jm, tm = _jmesh(), _tmesh()
    for form in FORMS:
        a, b = _operands(form, n, np.float64, nrhs=3)
        with jcomm.comm_audit() as jrec:
            out = _J_DIST[form](jfrom_dense(jnp.asarray(a), jm, nb, diag_pad_one=True),
                                bcast_impl=impl, num_monitor="off")
            if form == "pp":
                jpermute_rows_dist(jfrom_dense(jnp.asarray(b), jm, nb), out[1])
        with tcomm.comm_audit() as trec:
            out = _T_DIST[form](tp.from_dense(_t(a), tm, nb, diag_pad_one=True), bcast_impl=impl)
            if form == "pp":
                tp.permute_rows_dist(tp.from_dense(_t(b), tm, nb), out[1])
        jt_, tt_ = _totals(jrec), _totals(trec)
        assert jt_ and jt_ == tt_, form
        ops = set(jt_)
        assert any(op.startswith("ppermute") for op in ops) is (impl != "psum")


# ---------------------------------------------------------------------------
# the solves against slate_tpu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_lu_factor_matches_jax(form, n, dtype):
    ref = _jax_lu(form, n, np.dtype(dtype).name)
    got = _port_lu(form, n, dtype)
    a, _ = _operands(form, n, dtype)
    assert got["info"] == ref["info"] == 0
    if form != "nopiv":
        np.testing.assert_array_equal(got["perm"], ref["perm"])
        assert got["perm"].shape == (ref["tiles"].shape[0] * NB,)  # the padded row space
    assert np.abs(got["lu"] - ref["lu"]).max() < 100 * n * _eps(dtype) * np.abs(a).max()


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_lu_solve_eta_under_gate(form, n, dtype):
    ref = _jax_lu(form, n, np.dtype(dtype).name)
    got = _port_lu(form, n, dtype)
    a, b = _operands(form, n, dtype)
    assert got["info_solve"] == ref["info_solve"] == 0
    for res in (ref, got):
        assert _eta(a.astype(np.float64), res["x"], b) < 100 * n * _eps(dtype)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("j", [0, 37, 63])
def test_zero_column_info_matches_jax(form, j):
    n = 64
    a, _ = _operands(form, n, np.float64)
    a[:, j] = 0
    ref = _J_GETRF[form](jnp.asarray(a), _jmesh(), NB, opts=_J_OPTS)[-1]
    got = _T_GETRF[form](_t(a), _tmesh(), NB)[-1]
    assert got.dtype == torch.int32
    assert int(got) == int(ref) == j + 1


def test_nan_column_pivots_match_jax():
    n = 64
    a, _ = _operands("pp", n, np.float64)
    a[20, 11] = np.nan
    ref = _J_GETRF["pp"](jnp.asarray(a), _jmesh(), NB, opts=_J_OPTS)
    got = _T_GETRF["pp"](_t(a), _tmesh(), NB)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert int(got[-1]) == int(ref[-1]) > 0


# ---------------------------------------------------------------------------
# the port's own invariants: bitwise across lookahead and lowerings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", [("Lookahead", 0), ("Lookahead", 2), ("BcastImpl", "psum"),
                                     ("BcastImpl", "ring"), ("BcastImpl", "doubling")])
@pytest.mark.parametrize("form", FORMS)
def test_lu_invariance_bitwise(form, variant):
    base = _port_lu(form, 100, np.float64, Lookahead=1)
    got = _port_lu(form, 100, np.float64, **{variant[0]: variant[1]})
    for key in ("tiles", "x"):
        np.testing.assert_array_equal(got[key], base[key])
    if form != "nopiv":
        np.testing.assert_array_equal(got["perm"], base["perm"])


def test_nopiv_panel_impl_xla_matches_pallas():
    pal = _port_lu("nopiv", 64, np.float64, PanelImpl="pallas")
    xla = _port_lu("nopiv", 64, np.float64, PanelImpl="xla", UpdateImpl="xla")
    a, _ = _operands("nopiv", 64, np.float64)
    assert pal["info"] == xla["info"] == 0
    assert np.abs(pal["lu"] - xla["lu"]).max() < 100 * 64 * _eps(np.float64) * np.abs(a).max()


# ---------------------------------------------------------------------------
# the solve stage alone: slate_tpu's factor through the port's solves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", SIZES)
def test_port_solves_on_the_jax_factor(n):
    a, b = _operands("pp", n, np.float64)
    jm = _jmesh()
    lu, perm, info = jdrv.getrf_mesh(jnp.asarray(a), jm, NB, opts=_J_OPTS)
    bd = jpermute_rows_dist(jfrom_dense(jnp.asarray(b), jm, NB), perm)
    y = jtrsm_dist(lu, bd, jt.Uplo.Lower, jt.Op.NoTrans, jt.Diag.Unit)
    ref = np.asarray(jto_dense(jtrsm_dist(lu, y, jt.Uplo.Upper, jt.Op.NoTrans)))
    tm = _tmesh()
    tlu = dist_from_numpy(np.asarray(lu.tiles), lu.m, lu.n, NB, tm)
    pb = tp.permute_rows_dist(tp.from_dense(_t(b), tm, NB), torch.from_numpy(np.asarray(perm)))
    ty = tp.trsm_dist(tlu, pb, tt.Uplo.Lower, tt.Op.NoTrans, tt.Diag.Unit)
    x = tp.to_dense(tp.trsm_dist(tlu, ty, tt.Uplo.Upper, tt.Op.NoTrans)).numpy()
    assert np.abs(x - ref).max() < 100 * n * _eps(np.float64) * np.abs(ref).max()
    assert _eta(a, x, b) < 100 * n * _eps(np.float64)


def test_permute_rows_matches_jax_bitwise():
    n = 100
    b = generate("randn", n, 7, dtype=np.float64, seed=3)
    mt = 16
    perm = np.random.default_rng(4).permutation(mt * NB)
    ref = np.asarray(jto_dense(jpermute_rows_dist(jfrom_dense(jnp.asarray(b), _jmesh(), NB),
                                                  jnp.asarray(perm))))
    got = tp.to_dense(tp.permute_rows_dist(tp.from_dense(_t(b), _tmesh(), NB), perm)).numpy()
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="padded row space"):
        tp.permute_rows_dist(tp.from_dense(_t(b), _tmesh(), NB), perm[:n])


def test_dist_from_numpy_round_trip():
    a = generate("randn", 100, dtype=np.float64, seed=5)
    d = tp.from_dense(_t(a), _tmesh(), NB, diag_pad_one=True)
    back = dist_from_numpy(d.tiles.numpy(), 100, 100, NB, _tmesh())
    np.testing.assert_array_equal(tp.to_dense(back).numpy(), a)
    with pytest.raises(ValueError, match="tiles"):
        dist_from_numpy(np.zeros((2, 2, 4, 4)), 8, 8, NB, _tmesh())


# ---------------------------------------------------------------------------
# options: what the slice refuses, the mixed-precision chain
# ---------------------------------------------------------------------------


def test_f64_gesv_mesh_mixed_route_is_not_ported():
    """(Named when the ladder was refused.)  An f64 gesv_mesh with a 2-D B
    now routes through the mixed ladder under auto and ir, meeting the
    refinement gate and counting ``ir.solves``; off runs the direct path;
    f32 takes the direct path under auto."""
    from slate_tpu_torch.linalg.refine import ir_counter_values

    a, b = _operands("pp", 64, np.float64)

    def gate(x):
        r = np.abs(b - a @ x).sum(axis=1).max()
        return r <= (np.abs(x).sum(axis=1).max() * np.abs(a).sum(axis=1).max()
                     * _eps(np.float64) * np.sqrt(64))

    solves = ir_counter_values()["solves"]
    x, info = tp.gesv_mesh(_t(a), _t(b), _tmesh(), NB)  # auto
    assert int(info) == 0 and gate(x.numpy())
    x, info = tp.gesv_mesh(a, b, _tmesh(), NB, opts={tt.Option.MixedPrecision: "ir"})
    assert int(info) == 0 and gate(x.numpy())
    assert ir_counter_values()["solves"] == solves + 2
    with trefine.use_mixed("off"):
        x, info = tp.gesv_mesh(_t(a), _t(b), _tmesh(), NB)
    assert int(info) == 0 and _eta(a, x.numpy(), b) < 100 * 64 * _eps(np.float64)
    assert ir_counter_values()["solves"] == solves + 2
    # f32 runs the direct path under auto
    a32, b32 = a.astype(np.float32), b.astype(np.float32)
    assert int(tp.gesv_mesh(_t(a32), _t(b32), _tmesh(), NB)[1]) == 0


def test_mixed_resolution_chain(monkeypatch):
    assert trefine.resolve_mixed() == "auto"
    monkeypatch.setenv(trefine.MIXED_ENV, "gmres")
    assert trefine.resolve_mixed() == "gmres"
    with trefine.use_mixed("off"):
        assert trefine.resolve_mixed() == "off"
        assert trefine.resolve_mixed({tt.Option.MixedPrecision: "ir"}) == "ir"
    with pytest.raises(ValueError, match="unknown mixed-precision mode"):
        trefine.resolve_mixed({"mixed_precision": "half"})
    with pytest.raises(ValueError, match="unknown mixed-precision mode"):
        with trefine.use_mixed("x"):
            pass
    assert trefine.MIXED_MODES == ("off", "ir", "gmres", "auto")


@pytest.mark.parametrize("form", FORMS)
def test_unported_options_raise(form, monkeypatch):
    a, _ = _operands(form, 64, np.float32)
    # FaultTolerance is ported: nopiv reroutes to the ABFT LU, the pivoted
    # forms have no ABFT form and run plain (both as slate_tpu); with
    # Checkpoint it is refused as in slate_tpu.  Checkpoint alone routes
    # nopiv and pp to their checkpointed chains (the plain bits); tntpiv
    # has no checkpointed form and raises
    assert int(_T_GETRF[form](_t(a), _tmesh(), NB, opts={tt.Option.FaultTolerance: "detect"})[-1]) == 0
    with pytest.raises(ValueError, match="cannot be combined"):
        _T_GETRF[form](_t(a), _tmesh(), NB,
                       opts={tt.Option.FaultTolerance: "detect", tt.Option.Checkpoint: 4})
    plain = _T_GETRF[form](_t(a), _tmesh(), NB)
    for opts, env in (({tt.Option.Checkpoint: 4}, None), (None, "2")):
        if env:
            monkeypatch.setenv("SLATE_TPU_CKPT", env)
        if form == "tntpiv":
            with pytest.raises(NotImplementedError, match="Checkpoint"):
                _T_GETRF[form](_t(a), _tmesh(), NB, opts=opts)
        else:
            got = _T_GETRF[form](_t(a), _tmesh(), NB, opts=opts)
            assert torch.equal(got[0].tiles, plain[0].tiles)
            assert all(torch.equal(x, y) for x, y in zip(got[1:], plain[1:]))
    monkeypatch.delenv("SLATE_TPU_CKPT")
    # Option.NumMonitor is ported: "on" gives the plain run's bits
    got = _T_GETRF[form](_t(a), _tmesh(), NB, opts={tt.Option.NumMonitor: "on"})
    assert torch.equal(got[0].tiles, plain[0].tiles)
    assert all(torch.equal(x, y) for x, y in zip(got[1:], plain[1:]))
    assert int(_T_GETRF[form](_t(a), _tmesh(), NB, opts={tt.Option.FaultTolerance: "off"})[-1]) == 0
    with pytest.raises(ValueError, match="identity-padded"):
        _T_DIST[form](tp.from_dense(_t(a[:60, :60]), _tmesh(), NB))


def test_method_lu_round_trips_by_name():
    for m in jt.MethodLU:
        assert tt.MethodLU[m.name].value == m.value


def test_drivers_default_to_the_card():
    # numpy operands go to the mesh's device, and make_mesh defaults to cuda
    assert tp.make_mesh(2, 4).device.type == "cuda"


# ---------------------------------------------------------------------------
# the port's dryrun: gesv_pp and the LU half of panel_pallas
# ---------------------------------------------------------------------------


def test_dryrun_lu_phases_on_the_host(capsys):
    assert tdry.main(["--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    gate = 100 * 64 * _eps(np.float32)
    assert res["ok"] and res["phases"]["gesv_pp"]["eta"] < gate
    assert res["phases"]["panel_pallas"]["resid_lu"] < gate


def test_dryrun_lu_operands_match_the_reference():
    ops = tdry.dryrun_operands()
    rng = np.random.default_rng(0)
    n = 64
    g = rng.standard_normal((n, n)).astype(np.float32)
    rng.standard_normal((n, 16))
    np.testing.assert_array_equal(ops["am"], rng.standard_normal((n, n)).astype(np.float32))
    rng.standard_normal(96).astype(np.float32)
    rng.standard_normal(95).astype(np.float32)
    lum = (np.tril(g) + n * np.eye(n) + np.triu(rng.standard_normal((n, n)), 1)).astype(np.float32)
    np.testing.assert_array_equal(ops["lum"], lum)


def test_dryrun_gesv_pp_matches_jax():
    ops = tdry.dryrun_operands()
    xj, info = jdrv.gesv_mesh(jnp.asarray(ops["am"]), jnp.asarray(ops["b"]), _jmesh(), NB)
    x, info_t, eta = tdry.gesv_pp(_t(ops["am"]), _t(ops["b"]), _tmesh())
    assert int(info) == int(info_t) == 0 and eta < 100 * 64 * _eps(np.float32)
    assert _eta(ops["am"].astype(np.float64), np.asarray(xj), ops["b"]) < 100 * 64 * _eps(np.float32)


# ---------------------------------------------------------------------------
# complex pivoted LU: the argmax sentinel in the real dtype of |a|
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["pp", "tntpiv"])
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_complex_pivoted_lu_matches_jax(form, dtype):
    """gesv_mesh and gesv_tntpiv_mesh on A = randn + i randn (n = 64,
    nb = 8, 2 x 4, 4 right-hand sides): perm and info bitwise slate_tpu's,
    both solutions under eta < 100 n eps."""
    n = 64
    a = generate("randn", n, dtype=dtype, seed=11)
    b = generate("randn", n, 4, dtype=dtype, seed=12)
    jm, tm = _jmesh(), _tmesh()
    jlu = _J_GETRF[form](jnp.asarray(a), jm, NB, opts=_J_OPTS)
    tlu = _T_GETRF[form](_t(a), tm, NB, opts=_T_OPTS)
    np.testing.assert_array_equal(tlu[1].numpy(), np.asarray(jlu[1]))
    assert int(tlu[-1]) == int(jlu[-1]) == 0
    xj, ij = _J_GESV[form](jnp.asarray(a), jnp.asarray(b), jm, NB, opts=_J_OPTS)
    xt, it = _T_GESV[form](_t(a), _t(b), tm, NB, opts=_T_OPTS)
    assert int(it) == int(ij) == 0
    for x in (np.asarray(xj), xt.numpy()):
        assert _eta(a.astype(np.complex128), x, b) < 100 * n * _eps(dtype)
