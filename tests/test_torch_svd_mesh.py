"""The port's mesh SVD (slate_tpu_torch.parallel: ge2tb_dist,
unmbr_ge2tb_u_dist / _v_dist, gather_diagband, chase_apply_dist over both
reflector families, svd_mesh) against slate_tpu.parallel on the CPU.

``slate_tpu`` runs its svd_mesh chain stage by stage on the 8 forced CPU
devices of conftest.py (a 2 x 4 mesh) once per module (``jchain``), each
stage under its own comm audit, on a shape no other test compiles (m = 50,
n = 36, nb = 6: 9 x 6 tiles padded to 12 x 8); its Golub-Kahan solve runs
under ``jax.jit`` (the eager bdsqr compiles op by op).  The port runs on a
virtual 2 x 4 mesh, each stage fed ``slate_tpu``'s output of the stage
before (``dist_from_numpy``, ``disttwostage_from_numpy``).  Tolerances,
each with its reason (A's entries O(1), k = max(m, n)):

- the band and the reflectors within 10 k eps max|A| (the same panels, the
  updates' sums in another order);
- the diagonal-band gather is data movement: bitwise;
- the back-transforms on the same factors and Z within 10 k eps max|Z|;
- svd_mesh: s within 10 k eps s_max, A = U S V^H within 10 k eps s_max,
  U and V orthonormal within 10 k eps; the m < n swap the same;
- audited comm bytes per op equal (ge2tb_dist's skipped last LQ steps
  included).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import cpu_devices

from slate_tpu.linalg import svd as jsvd
from slate_tpu.parallel import comm as jcomm
from slate_tpu.parallel import dist_twostage as jdt
from slate_tpu.parallel import from_dense as jfrom_dense
from slate_tpu.parallel import make_mesh as jmake_mesh
from slate_tpu.parallel import to_dense as jto_dense
from slate_tpu_torch import parallel as tp
from slate_tpu_torch.parallel import comm as tcomm
from slate_tpu_torch.utils.testing import dist_from_numpy, disttwostage_from_numpy, generate

# the suite runs in several worker processes that share the cores: one
# intra-op thread each (torch defaults to one a core, which oversubscribes them)
torch.set_num_threads(1)

M, N, NB = 50, 36, 6
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


@pytest.fixture(autouse=True)
def _default_impls(monkeypatch):
    monkeypatch.delenv(tcomm.BCAST_IMPL_ENV, raising=False)


@pytest.fixture(scope="module")
def jchain():
    """slate_tpu's svd_mesh chain on A (M x N, f64), stage by stage."""
    jm = jmake_mesh(2, 4, devices=cpu_devices(8))
    a = generate("randn", M, N, dtype=np.float64, seed=5)
    out, audits = {"a": a}, {}
    with jcomm.comm_audit() as rec:
        f = jdt.ge2tb_dist(jfrom_dense(jnp.asarray(a), jm, NB))
    audits["ge2tb"] = _totals(rec)
    out.update(band=np.asarray(f.band.tiles), vq=np.asarray(f.vq), tq=np.asarray(f.tq),
               vl=np.asarray(f.vl), tl=np.asarray(f.tl))
    with jcomm.comm_audit() as rec:
        bd = jdt.gather_diagband(f.band, NB)[:N]
    audits["gather"] = _totals(rec)
    out["diagband"] = np.asarray(bd)
    d, e, f2, pu, pv = jax.jit(jsvd.tb2bd, static_argnums=(1, 2, 3))(bd, NB, 1, True)
    s, ub, vb = jax.jit(jsvd.bdsqr)(d, e)
    out.update(s=np.asarray(s), ub=np.asarray(ub), lvs=np.asarray(f2.lvs),
               ltaus=np.asarray(f2.ltaus))
    with jcomm.comm_audit() as rec:
        u = jdt.chase_apply_dist(f2.lvs, f2.ltaus, pu[:, None] * ub, N, NB, jm)
    audits["chase"] = _totals(rec)
    out["u_band"] = np.asarray(u)
    u_full = jnp.zeros((M, N)).at[:N].set(u)
    with jcomm.comm_audit() as rec:
        ud = jto_dense(jdt.unmbr_ge2tb_u_dist(f, jfrom_dense(u_full, jm, NB)))
    audits["unmbr_u"] = _totals(rec)
    out.update(u_full=np.asarray(u_full), u=np.asarray(ud))
    v = jdt.chase_apply_dist(f2.rvs, f2.rtaus, pv[:, None] * vb, N, NB, jm)
    with jcomm.comm_audit() as rec:
        vd = jto_dense(jdt.unmbr_ge2tb_v_dist(f, jfrom_dense(v, jm, NB)))
    audits["unmbr_v"] = _totals(rec)
    out.update(v_band=np.asarray(v), v=np.asarray(vd))
    out["audits"] = audits
    return out


def test_ge2tb_dist_band_and_audit(jchain):
    a = jchain["a"]
    with tcomm.comm_audit() as rec:
        f = tp.ge2tb_dist(tp.from_dense(_t(a), _tmesh(), NB))
    assert _totals(rec) == jchain["audits"]["ge2tb"] and _totals(rec)
    tol = C * M * EPS * np.abs(a).max()
    assert np.abs(f.band.tiles.numpy() - jchain["band"]).max() <= tol
    for name in ("vq", "tq", "vl", "tl"):
        got, want = getattr(f, name).numpy(), jchain[name]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= tol, name


def test_gather_diagband_bitwise(jchain):
    band = dist_from_numpy(jchain["band"], M, N, NB, _tmesh(), diag_pad=False)
    with tcomm.comm_audit() as rec:
        got = tp.gather_diagband(band, NB)[:N]
    np.testing.assert_array_equal(got.numpy(), jchain["diagband"])
    assert _totals(rec) == jchain["audits"]["gather"]


def test_chase_apply_dist_on_reference_family(jchain):
    z = jchain["ub"]
    with tcomm.comm_audit() as rec:
        got = tp.chase_apply_dist(_t(jchain["lvs"]), _t(jchain["ltaus"]), _t(z), N, NB, _tmesh())
    assert _totals(rec) == jchain["audits"]["chase"]
    assert np.abs(got.numpy() - jchain["u_band"]).max() <= C * N * EPS * np.abs(z).max()


def test_unmbr_ge2tb_dist_on_reference_factors(jchain):
    mesh = _tmesh()
    f = disttwostage_from_numpy(jchain["band"], jchain["vq"], jchain["tq"], jchain["vl"],
                                jchain["tl"], M, N, NB, mesh)
    with tcomm.comm_audit() as rec:
        u = tp.to_dense(tp.unmbr_ge2tb_u_dist(f, tp.from_dense(_t(jchain["u_full"]), mesh, NB)))
    assert _totals(rec) == jchain["audits"]["unmbr_u"]
    assert np.abs(u.numpy() - jchain["u"]).max() <= C * M * EPS * np.abs(jchain["u_full"]).max()
    with tcomm.comm_audit() as rec:
        v = tp.to_dense(tp.unmbr_ge2tb_v_dist(f, tp.from_dense(_t(jchain["v_band"]), mesh, NB)))
    assert _totals(rec) == jchain["audits"]["unmbr_v"]
    assert np.abs(v.numpy() - jchain["v"]).max() <= C * N * EPS * np.abs(jchain["v_band"]).max()


@pytest.mark.parametrize("transpose", [False, True])
def test_svd_mesh_end_to_end(jchain, transpose):
    """svd_mesh on A and on A^T (the m < n swap) against slate_tpu's chain."""
    a = jchain["a"].T if transpose else jchain["a"]
    u, s, vh = tp.svd_mesh(_t(a), _tmesh(), nb=NB)
    smax = float(jchain["s"][0])
    k = max(a.shape)
    assert np.abs(s.numpy() - jchain["s"]).max() <= C * k * EPS * smax
    un, vhn = u.numpy(), vh.numpy()
    assert un.shape == (a.shape[0], N) and vhn.shape == (N, a.shape[1])
    assert np.abs((un * s.numpy()) @ vhn - a).max() <= C * k * EPS * smax
    assert np.abs(un.T @ un - np.eye(N)).max() <= C * k * EPS
    assert np.abs(vhn @ vhn.T - np.eye(N)).max() <= C * k * EPS
    sv = tp.svd_mesh(_t(a), _tmesh(), nb=NB, want_vectors=False)
    assert np.abs(sv.numpy() - jchain["s"]).max() <= C * k * EPS * smax


def test_svd_mesh_complex():
    """A complex A (the chase's phases fold into both back-transforms)
    against LAPACK's singular values."""
    a = generate("randn", 30, 22, dtype=np.complex128, seed=8)
    u, s, vh = tp.svd_mesh(_t(a), _tmesh(), nb=4)
    ref = np.linalg.svd(a, compute_uv=False)
    assert np.abs(s.numpy() - ref).max() <= C * 30 * EPS * ref[0]
    un, vhn = u.numpy(), vh.numpy()
    assert np.abs((un * s.numpy()) @ vhn - a).max() <= C * 30 * EPS * ref[0]
    assert np.abs(un.conj().T @ un - np.eye(22)).max() <= C * 30 * EPS
