"""The port's mesh eigensolver (slate_tpu_torch.parallel: he2hb_dist,
gather_diagband, stedc_dist, chase_apply_dist, unmtr_he2hb_dist,
heev_mesh and the dryrun's stedc_dist / heev_chain phases) against
slate_tpu.parallel on the CPU.

``slate_tpu`` runs its chain stage by stage on the 8 forced CPU devices of
conftest.py (a 2 x 4 mesh) once per module (``jchain``), each stage under
its own comm audit: it records at trace time, so the chain uses a shape no
other test compiles (n = 42, nb = 6 -- 7 tile rows padded to 8 -- and
BcastImpl ``ring``).  The port runs on a virtual 2 x 4 mesh, each stage
fed ``slate_tpu``'s output of the stage before (``dist_from_numpy``,
``disttwostage_from_numpy``).  Tolerances, each with its reason (A's
entries O(1)):

- the band within 10 n eps max|A| (the same panels, the update's sums in
  another order);
- the diagonal-band gather is data movement: bitwise;
- stedc_dist on the same (d, e): w within 10 n eps ||T||, Z by residual and
  orthogonality within 10 n eps; its row interleave and eigen-sort are
  permutations: the port's finale on slate_tpu's merge-tree output equals
  slate_tpu's Z bitwise;
- the back-transforms on the same factors and Z within 10 n eps max|Z|;
- heev_mesh: w within 10 n eps ||A||, residual max|A Z - Z W| / ||A|| and
  orthogonality within 10 n eps;
- audited comm bytes per op equal; the lowerings bitwise within the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import cpu_devices

from slate_tpu.linalg import eig as jeig
from slate_tpu.parallel import comm as jcomm
from slate_tpu.parallel import dist_stedc as jds
from slate_tpu.parallel import dist_twostage as jdt
from slate_tpu.parallel import from_dense as jfrom_dense
from slate_tpu.parallel import make_mesh as jmake_mesh
from slate_tpu.parallel import to_dense as jto_dense
from slate_tpu_torch import parallel as tp
from slate_tpu_torch import types as tt
from slate_tpu_torch.linalg import tridiag as ttd
from slate_tpu_torch.parallel import comm as tcomm
from slate_tpu_torch.parallel import dist_stedc as tds
from slate_tpu_torch.parallel import dryrun as tdry
from slate_tpu_torch.utils.testing import dist_from_numpy, disttwostage_from_numpy, generate

# the suite runs in several worker processes that share the cores: one
# intra-op thread each (torch defaults to one a core, which oversubscribes them)
torch.set_num_threads(1)

N, NB, IMPL = 42, 6, "ring"
C = 10
EPS = float(np.finfo(np.float64).eps)


def _t(x):
    return torch.from_numpy(np.array(x))


def _totals(records):
    out = {}
    for op, nbytes, mult in records:
        out[op] = out.get(op, 0) + nbytes * mult
    return out


def _tmesh():
    return tp.make_mesh(2, 4, device="cpu")


def _herm(n, seed, dtype=np.float64):
    g = generate("randn", n, n, dtype=dtype, seed=seed)
    return (g + g.conj().T) / 2


@pytest.fixture(autouse=True)
def _default_impls(monkeypatch):
    monkeypatch.delenv(tcomm.BCAST_IMPL_ENV, raising=False)
    monkeypatch.delenv("SLATE_TPU_CKPT", raising=False)


@pytest.fixture(scope="module")
def jchain():
    """slate_tpu's heev_mesh chain on A (N x N, f64), stage by stage, each
    stage's outputs as numpy and its audited totals."""
    jm = jmake_mesh(2, 4, devices=cpu_devices(8))
    a = _herm(N, 1)
    out, audits = {"a": a}, {}
    with jcomm.comm_audit() as rec:
        f = jdt.he2hb_dist(jfrom_dense(jnp.asarray(a), jm, NB), bcast_impl=IMPL)
    audits["he2hb"] = _totals(rec)
    out.update(band=np.asarray(f.band.tiles), vq=np.asarray(f.vq), tq=np.asarray(f.tq),
               vl=np.asarray(f.vl), tl=np.asarray(f.tl))
    with jcomm.comm_audit() as rec:
        bd = jdt.gather_diagband(f.band, NB)
    audits["gather"] = _totals(rec)
    out["diagband"] = np.asarray(bd)
    bd = jeig.symmetrize_diagband(bd, NB)
    d, e, f2, _ = jax.jit(jeig.hb2st, static_argnums=(1, 2, 3))(bd, NB, 1, True)
    out.update(d=np.asarray(d), e=np.asarray(e), vs=np.asarray(f2.vs), taus=np.asarray(f2.taus))
    with jcomm.comm_audit() as rec:
        w, z = jds.stedc_dist(d, e, jm, bcast_impl=IMPL)
    audits["stedc"] = _totals(rec)
    out.update(w=np.asarray(w), z=np.asarray(z))
    with jcomm.comm_audit() as rec:
        z2 = jdt.chase_apply_dist(f2.vs, f2.taus, z, N, NB, jm, bcast_impl=IMPL)
    audits["chase"] = _totals(rec)
    out["z2"] = np.asarray(z2)
    with jcomm.comm_audit() as rec:
        zd = jto_dense(jdt.unmtr_he2hb_dist(f, jfrom_dense(z2, jm, NB)))
    audits["unmtr"] = _totals(rec)
    out["zfinal"] = np.asarray(zd)
    out["audits"] = audits
    return out


def test_he2hb_dist_band_and_audit(jchain):
    a = jchain["a"]
    with tcomm.comm_audit() as rec:
        f = tp.he2hb_dist(tp.from_dense(_t(a), _tmesh(), NB), bcast_impl=IMPL)
    assert _totals(rec) == jchain["audits"]["he2hb"] and _totals(rec)
    tol = C * N * EPS * np.abs(a).max()
    assert np.abs(f.band.tiles.numpy() - jchain["band"]).max() <= tol
    assert tuple(f.vq.shape) == jchain["vq"].shape and tuple(f.tq.shape) == jchain["tq"].shape
    assert tuple(f.vl.shape) == jchain["vl"].shape
    # the reflectors at their own scale (unit pivots): the same panels
    assert np.abs(f.vq.numpy() - jchain["vq"]).max() <= tol
    assert np.abs(f.tq.numpy() - jchain["tq"]).max() <= tol


def test_gather_diagband_bitwise(jchain):
    band = dist_from_numpy(jchain["band"], N, N, NB, _tmesh(), diag_pad=False)
    with tcomm.comm_audit() as rec:
        got = tp.gather_diagband(band, NB)
    np.testing.assert_array_equal(got.numpy(), jchain["diagband"])
    assert _totals(rec) == jchain["audits"]["gather"]


def test_stedc_dist_on_reference_tridiagonal(jchain):
    d, e = jchain["d"], jchain["e"]
    with tcomm.comm_audit() as rec:
        w, z = tp.stedc_dist(_t(d), _t(e), _tmesh(), bcast_impl=IMPL)
    assert _totals(rec) == jchain["audits"]["stedc"]
    t = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    tnorm = np.abs(np.linalg.eigvalsh(t)).max()
    assert np.abs(w.numpy() - jchain["w"]).max() <= C * N * EPS * tnorm
    zn = z.numpy()
    assert np.abs(t @ zn - zn * w.numpy()).max() <= C * N * EPS * tnorm
    assert np.abs(zn.T @ zn - np.eye(N)).max() <= C * N * EPS


def test_stedc_dist_interleave_and_sort_bitwise():
    """The finale (row un-interleave + eigen-sort) is a permutation: the
    port's, from its own stacked-row rule, applied to slate_tpu's merge-tree
    output reproduces slate_tpu's stedc_dist bitwise (n = 100 pads to
    N = 128: two levels and a pad block)."""
    jm = jmake_mesh(2, 4, devices=cpu_devices(8))
    n = 100
    rng = np.random.default_rng(17)
    d, e = rng.standard_normal(n), rng.standard_normal(n - 1)
    wj, zj = jds.stedc_dist(jnp.asarray(d), jnp.asarray(e), jm)
    levels, big_n = ttd._levels(n)
    scale = np.abs(d).max() + 2 * np.abs(e).max() + 1
    dp = np.concatenate([d, np.full(big_n - n, 4 * scale)])
    ep = np.concatenate([e, np.zeros(big_n - n)])
    seams = 32 * np.arange(1, big_n // 32) - 1
    dp[seams] -= ep[seams]
    dp[seams + 1] -= ep[seams]
    w_raw, z_raw = jds._stedc_dist_jit(jnp.asarray(dp), jnp.asarray(ep), jm, 2, 4, big_n, levels,
                                       jcomm.resolve_bcast_impl(None))
    inv = torch.as_tensor(np.argsort(tds.stacked_rows(2, big_n)))
    order = torch.argsort(_t(w_raw)[:n], stable=True)
    got = tds._stedc_finale(_t(z_raw), inv, order, 2, 4, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(zj))
    np.testing.assert_array_equal(_t(w_raw)[:n][order].numpy(), np.asarray(wj))


def test_chase_apply_dist_on_reference_factors(jchain):
    with tcomm.comm_audit() as rec:
        got = tp.chase_apply_dist(_t(jchain["vs"]), _t(jchain["taus"]), _t(jchain["z"]), N, NB,
                                  _tmesh(), bcast_impl=IMPL)
    assert _totals(rec) == jchain["audits"]["chase"]
    assert np.abs(got.numpy() - jchain["z2"]).max() <= C * N * EPS * np.abs(jchain["z"]).max()


def test_unmtr_he2hb_dist_on_reference_factors(jchain):
    mesh = _tmesh()
    f = disttwostage_from_numpy(jchain["band"], jchain["vq"], jchain["tq"], jchain["vl"],
                                jchain["tl"], N, N, NB, mesh)
    with tcomm.comm_audit() as rec:
        got = tp.to_dense(tp.unmtr_he2hb_dist(f, tp.from_dense(_t(jchain["z2"]), mesh, NB)))
    assert _totals(rec) == jchain["audits"]["unmtr"]
    assert np.abs(got.numpy() - jchain["zfinal"]).max() <= C * N * EPS * np.abs(jchain["z2"]).max()


def test_heev_mesh_end_to_end(jchain):
    a = jchain["a"]
    mesh = _tmesh()
    norm2 = np.abs(jchain["w"]).max()
    outs = {}
    for impl in ("psum", "ring", "doubling"):
        outs[impl] = tp.heev_mesh(_t(a), mesh, nb=NB, opts={tt.Option.BcastImpl: impl})
    w, z = outs["ring"]
    assert np.abs(w.numpy() - jchain["w"]).max() <= C * N * EPS * norm2
    zn = z.numpy()
    assert np.abs(a @ zn - zn * w.numpy()).max() <= C * N * EPS * norm2
    assert np.abs(zn.T @ zn - np.eye(N)).max() <= C * N * EPS
    for impl in ("psum", "doubling"):  # the lowerings move bytes differently, never a value
        np.testing.assert_array_equal(outs[impl][0].numpy(), w.numpy())
        np.testing.assert_array_equal(outs[impl][1].numpy(), zn)
    wr, zr = tp.heev_mesh(_t(a), mesh, nb=NB, distributed_solver=False)
    assert np.abs(wr.numpy() - jchain["w"]).max() <= C * N * EPS * norm2
    assert np.abs(a @ zr.numpy() - zr.numpy() * wr.numpy()).max() <= C * N * EPS * norm2
    wv = tp.heev_mesh(_t(a), mesh, nb=NB, want_vectors=False)
    assert np.abs(wv.numpy() - jchain["w"]).max() <= C * N * EPS * norm2


def test_heev_mesh_complex_and_fallback():
    """A complex Hermitian input (the phases fold into the back-transform)
    against LAPACK's eigenvalues; n <= 32 takes stedc_dist's replicated
    fallback, which is stedc itself."""
    n = 36
    a = _herm(n, 3, np.complex128)
    w, z = tp.heev_mesh(_t(a), _tmesh(), nb=4)
    ref = np.linalg.eigvalsh(a)
    norm2 = np.abs(ref).max()
    assert np.abs(w.numpy() - ref).max() <= C * n * EPS * norm2
    zn = z.numpy()
    assert np.abs(a @ zn - zn * w.numpy()).max() <= C * n * EPS * norm2
    assert np.abs(zn.conj().T @ zn - np.eye(n)).max() <= C * n * EPS
    rng = np.random.default_rng(2)
    d, e = _t(rng.standard_normal(20)), _t(rng.standard_normal(19))
    with tcomm.comm_audit() as rec:
        wd, zd = tp.stedc_dist(d, e, _tmesh())
    ws, zs = ttd.stedc(d, e)
    np.testing.assert_array_equal(wd.numpy(), ws.numpy())
    np.testing.assert_array_equal(zd.numpy(), zs.numpy())
    assert rec == []


def test_heev_mesh_refuses_what_is_not_ported(monkeypatch):
    # Option.Checkpoint is ported (stage 1 through ft.ckpt.he2hb_ckpt):
    # by option and by environment it gives the plain run's bits
    a = _t(_herm(16, 4))
    w0, z0 = tp.heev_mesh(a, _tmesh(), nb=4)
    w1, z1 = tp.heev_mesh(a, _tmesh(), nb=4, opts={tt.Option.Checkpoint: 2})
    assert torch.equal(w0, w1) and torch.equal(z0, z1)
    monkeypatch.setenv("SLATE_TPU_CKPT", "3")
    w2, z2 = tp.heev_mesh(a, _tmesh(), nb=4)
    assert torch.equal(w0, w2) and torch.equal(z0, z2)
    monkeypatch.delenv("SLATE_TPU_CKPT")
    # Option.NumMonitor is ported: "on" gives the plain bits (stage 1
    # records its orthogonality gauge)
    w3, z3 = tp.heev_mesh(a, _tmesh(), nb=4, opts={tt.Option.NumMonitor: "on"})
    assert torch.equal(w0, w3) and torch.equal(z0, z3)
    f0 = tp.he2hb_dist(tp.from_dense(a, _tmesh(), 4))
    f1 = tp.he2hb_dist(tp.from_dense(a, _tmesh(), 4), num_monitor="on")
    assert torch.equal(f0.band.tiles, f1.band.tiles) and torch.equal(f0.vq, f1.vq)


def test_dryrun_eig_phases():
    """The dryrun's stedc_dist (n = 96 f32, residual < 1e-3) and heev_chain
    (n = 64, nb = 8 f32, residual and orthogonality < 100 n eps32) phases
    on the dryrun's operands, and the six phases in the reference's order."""
    raw = tdry.dryrun_operands()
    rng = np.random.default_rng(0)  # __graft_entry__.py's draws, in its order
    g = rng.standard_normal((tdry.N, tdry.N)).astype(np.float32)
    rng.standard_normal((tdry.N, tdry.NRHS))
    rng.standard_normal((tdry.N, tdry.N))
    np.testing.assert_array_equal(raw["sd"], rng.standard_normal(96).astype(np.float32))
    np.testing.assert_array_equal(raw["se"], rng.standard_normal(95).astype(np.float32))
    np.testing.assert_array_equal(raw["he"], (g + g.T).astype(np.float32) / 2)
    ops = {k: torch.from_numpy(v) for k, v in raw.items()}
    mesh = _tmesh()
    assert tdry.stedc_residual(ops["sd"], ops["se"], mesh) < 1e-3
    gate = 100 * tdry.N * float(np.finfo(np.float32).eps)
    _, _, r_eig, orth = tdry.heev_chain(ops["he"], mesh)
    assert r_eig < gate and orth < gate
    res = tdry.dryrun("cpu")
    assert res["ok"] and list(res["phases"]) == ["posv_chain", "gesv_pp", "hemm_summa",
                                                 "stedc_dist", "heev_chain", "panel_pallas",
                                                 "flight_timeline", "mem"]
