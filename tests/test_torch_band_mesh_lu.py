"""The port's mesh band LU (slate_tpu_torch.parallel.gbtrf_band_dist)
against slate_tpu.parallel, and the windowed pivot panel it shares with the
dense partial-pivot LU.

The same seeded numpy operands go through ``slate_tpu`` on the 8 forced CPU
devices of conftest.py (a 2 x 4 mesh) and through the port on a virtual
2 x 4 mesh on the CPU: n = 64 and a padded n = 60, nb = 8, bands narrower
than a tile (kl = ku = 2) and of two tiles (kl = ku = 16 = 2 nb, as
tests/test_lookahead.py's strict-schedule test), in f32, f64 and
complex128; random, not diagonally dominant, so the windows pivot.

Bitwise: the permutation over the padded row space, every info code (a
zero pivot included), the audited comm bytes per op under each lowering (a
fresh trace of ``slate_tpu``'s kernel on tile sizes no other test uses),
the port's factor across lookahead 0 / 1 / 3 (the strict schedule runs at
every depth) and the lowerings, and the shared panel: on a band operand
its band windows are bitwise the whole-height, whole-width panel and
swaps of ``getrf_pp_dist``.
Window parity: finite garbage at the operand's scale in every tile outside
the band envelope of the operand handed to ``gbtrf_band_dist``; the port's
output and pivots match ``slate_tpu``'s over the whole grid.  Stated
tolerance: the packed factor within C_FACTOR n eps max|A| of
``slate_tpu``'s (c = 1: the same pivots give the same eliminations, whose
sums of at most (wd_l + wd_u) nb terms run in another order).
"""

import gc
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import cpu_devices

from slate_tpu import parallel as jp
from slate_tpu.parallel import comm as jcomm
from slate_tpu.parallel import dist_lu as jdl
from slate_tpu_torch import parallel as tp
from slate_tpu_torch.parallel import comm as tcomm
from slate_tpu_torch.parallel import dist_chol as tdc
from slate_tpu_torch.parallel import dist_lu as tdl
from slate_tpu_torch.parallel.comm import local_indices
from slate_tpu_torch.parallel.dist import local_view

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    """Drop the module's compiled JAX programs when it ends: each holds
    memory mappings, and an xdist worker that keeps them for the whole
    run can reach the per-process map limit (vm.max_map_count)."""
    yield
    jax.clear_caches()
    gc.collect()


NB = 8
C_FACTOR = 1.0
GB_CASES = [(64, 2, 2, "float64"), (64, 16, 16, "float64"), (60, 16, 16, "float64"),
            (64, 3, 11, "float32"), (64, 5, 2, "complex128")]


def _jmesh():
    return jp.make_mesh(2, 4, devices=cpu_devices(8))


def _tmesh():
    return tp.make_mesh(2, 4, device="cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eps(dtype):
    return float(np.finfo(np.dtype(dtype)).eps)


def _rand(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def _project(a, kl, ku):
    i, j = np.indices(a.shape)
    return np.where((i - j <= kl) & (j - i <= ku), a, 0).astype(a.dtype)


def _operand(n, kl, ku, dtype, garbage=False):
    a = _project(_rand((n, n), dtype, 3 * n + kl + 7 * ku), kl, ku)
    if garbage:
        nt = -(-n // NB)
        ti, tj = np.indices((nt, nt))
        lo, hi = (ti - tj) * NB - (NB - 1), (ti - tj) * NB + (NB - 1)  # i - j over a tile
        empty = (hi < -ku) | (lo > kl)
        mask = np.kron(empty, np.ones((NB, NB), bool))[:n, :n]
        a = np.where(mask, _rand((n, n), dtype, n) * np.abs(a).max(), a).astype(dtype)
    return a


def _totals(records):
    out = {}
    for op, nbytes, mult in records:
        out[op] = out.get(op, 0) + nbytes * mult
    return out


@functools.lru_cache(maxsize=None)
def _jax_gbtrf(n, kl, ku, dtype, garbage=False):
    a = _operand(n, kl, ku, dtype, garbage)
    lu, perm, info = jdl.gbtrf_band_dist(
        jp.from_dense(jnp.asarray(a), _jmesh(), NB, diag_pad_one=True), kl, ku, bcast_impl="psum")
    return np.asarray(jp.to_dense(lu)), np.asarray(perm), int(info)


@pytest.mark.parametrize("n,kl,ku,dtype", GB_CASES)
def test_gbtrf_band_dist_matches_jax(n, kl, ku, dtype):
    lu_ref, perm_ref, info_ref = _jax_gbtrf(n, kl, ku, dtype)
    a = _operand(n, kl, ku, dtype)
    lu, perm, info = tp.gbtrf_band_dist(tp.from_dense(_t(a), _tmesh(), NB, diag_pad_one=True),
                                        kl, ku)
    assert info.dtype == torch.int32 and int(info) == info_ref == 0
    np.testing.assert_array_equal(perm.numpy(), perm_ref)
    assert perm.shape == (lu.mt * NB,)  # the padded row space
    assert not np.array_equal(perm_ref, np.arange(perm_ref.size))  # the windows pivoted
    got = tp.to_dense(lu).numpy()
    assert np.abs(got - lu_ref).max() <= C_FACTOR * n * _eps(dtype) * np.abs(a).max()


@pytest.mark.parametrize("n,kl,ku,dtype", [(64, 2, 2, "float64"), (64, 16, 16, "float64"),
                                           (60, 3, 11, "complex128")])
def test_gbtrf_band_dist_window_parity_with_garbage(n, kl, ku, dtype):
    """Garbage in every tile outside the band envelope, handed straight to
    the factor: tiles no window reaches come back untouched, and the ones
    the slot-rounded windows reach (candidate rows, swap columns, the
    update window) enter both packages' arithmetic the same way."""
    lu_ref, perm_ref, info_ref = _jax_gbtrf(n, kl, ku, dtype, garbage=True)
    a = _operand(n, kl, ku, dtype, garbage=True)
    lu, perm, info = tp.gbtrf_band_dist(tp.from_dense(_t(a), _tmesh(), NB, diag_pad_one=True),
                                        kl, ku)
    got = tp.to_dense(lu).numpy()
    assert int(info) == info_ref
    np.testing.assert_array_equal(perm.numpy(), perm_ref)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(lu_ref))
    fin = ~np.isnan(lu_ref)
    assert np.abs(got[fin] - lu_ref[fin]).max() <= C_FACTOR * n * _eps(dtype) * np.abs(a).max()


@pytest.mark.parametrize("j", [0, 37, 63])
def test_gbtrf_band_dist_zero_pivot_info_matches_jax(j):
    n, kl, ku = 64, 4, 3
    a = _operand(n, kl, ku, "float64")
    a[:, j] = 0
    _, perm_ref, info_ref = jdl.gbtrf_band_dist(
        jp.from_dense(jnp.asarray(a), _jmesh(), NB, diag_pad_one=True), kl, ku, bcast_impl="psum")
    _, perm, info = tp.gbtrf_band_dist(tp.from_dense(_t(a), _tmesh(), NB, diag_pad_one=True), kl, ku)
    assert int(info) == int(info_ref) == j + 1
    np.testing.assert_array_equal(perm.numpy(), np.asarray(perm_ref))


def test_gbtrf_band_dist_bitwise_across_lookahead_and_lowerings():
    n, kl, ku = 64, 2 * NB, 2 * NB
    a = _operand(n, kl, ku, "float64")
    ad = tp.from_dense(_t(a), _tmesh(), NB, diag_pad_one=True)
    base, base_perm, _ = tp.gbtrf_band_dist(ad, kl, ku, lookahead=0)
    for la in (1, 3):
        lu, perm, _ = tp.gbtrf_band_dist(ad, kl, ku, lookahead=la)
        assert torch.equal(lu.tiles, base.tiles) and torch.equal(perm, base_perm), la
    for impl in ("psum", "ring", "doubling", "auto"):
        lu, perm, _ = tp.gbtrf_band_dist(ad, kl, ku, bcast_impl=impl)
        assert torch.equal(lu.tiles, base.tiles) and torch.equal(perm, base_perm), impl


@pytest.mark.parametrize("impl,nb,n,kl,ku", [("psum", 5, 40, 3, 6), ("ring", 7, 56, 9, 4),
                                             ("doubling", 5, 45, 12, 12)])
def test_gbtrf_band_dist_audit_bytes_match_jax(impl, nb, n, kl, ku):
    a = _operand(n, kl, ku, "float64")
    jm = _jmesh()
    ja = jp.from_dense(jnp.asarray(a), jm, nb, diag_pad_one=True)
    nt = ja.nt
    wd_l = min(((nb - 1) + kl) // nb + 1, nt)
    wd_u = min(((nb - 1) + kl + ku) // nb + 1, nt)
    wd_usw = min(((nb - 1) + 2 * kl + ku) // nb + 1, nt)
    with jcomm.comm_audit() as jrec:
        jax.make_jaxpr(jdl._gb_pp_jit.__wrapped__, static_argnums=tuple(range(1, 10)))(
            ja.tiles, jm, 2, 4, nt, n, wd_l, wd_u, wd_usw, impl)
    with tcomm.comm_audit() as trec:
        tp.gbtrf_band_dist(tp.from_dense(_t(a), _tmesh(), nb, diag_pad_one=True), kl, ku,
                           bcast_impl=impl)
    want = _totals(jrec)
    assert want and _totals(trec) == want
    assert any(op.startswith("ppermute") for op in want) is (impl != "psum")


@pytest.mark.parametrize("k", [0, 3, 6])
def test_band_window_panel_is_the_whole_height_panel(k):
    """On a band operand narrower than the grid, the windowed panel and
    swaps of ``gbtrf_band_dist``'s step k are bitwise the whole-height,
    whole-width ones that ``getrf_pp_dist`` runs: every nonzero candidate
    row lies in the row window, and every nonzero of a moved row in the
    swap column window."""
    n, kl, ku, p, q = 128, 3, 2, 2, 4
    a = _operand(n, kl, ku, "float64")
    nt = n // NB
    wd_l = ((NB - 1) + kl) // NB + 1
    wd_u = ((NB - 1) + kl + ku) // NB + 1
    wd_usw = ((NB - 1) + 2 * kl + ku) // NB + 1
    outs = []
    for windowed in (False, True):
        t = tp.from_dense(_t(a), _tmesh(), NB, diag_pad_one=True).tiles
        loc = local_view(t, p, q)
        mtl, ntl = loc.shape[2], loc.shape[3]
        if windowed:
            wlr = min(-(-wd_l // p) + 1, mtl)
            wlc = min(-(-wd_u // q) + 1, ntl)
            wlsw = min(-(-((wd_l - 1) + wd_usw) // q) + 1, ntl)
            assert wlr < mtl and wlsw < ntl
            w = tdc._BandWindows(nt, p, q, mtl, ntl, wlr, wlc, "cpu")
            sw = tdc._BandWindows(nt, p, q, mtl, ntl, wlr, wlsw, "cpu",
                                  col_base=lambda ks: np.maximum(ks - (wd_l - 1), 0))
            gids = (w.i_win[k][..., None] * NB + torch.arange(NB)).reshape(p, wlr * NB)
            slots, cols = w.rows[k], sw.cols[k]
            tslot = tdl._tile_slots(w.sr[k], nt, p, wlr)
            win = (slots, torch.from_numpy(tslot), tslot)
        else:
            _, _, i_log, _ = local_indices(p, q, mtl, ntl)
            gids = tdl._flat_gids(i_log, NB)
            slots, cols = tdl._all_slots(p, mtl, "cpu"), tdl._all_slots(q, ntl, "cpu")
            tslot = tdl._tile_slots(np.zeros(p, np.int64), nt, p, mtl)
            win = (slots, torch.from_numpy(tslot), tslot)
        rowperm = np.arange(nt * NB)
        flat, piv = tdl._pp_panel_factor(loc, k, p, q, nt, n, gids, win)
        tdl._pp_apply_swaps(loc, rowperm, flat, piv.numpy(), k, p, q, nt, slots, cols)
        outs.append((piv, t, rowperm))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    np.testing.assert_array_equal(outs[0][2], outs[1][2])
    assert (outs[0][2] != np.arange(nt * NB)).any()  # the step pivoted


# ---------------------------------------------------------------------------
# windows narrower than the grid: slate_tpu's swap window misses L history
# ---------------------------------------------------------------------------


def _lu_residual(lu, perm, a):
    """max|P A - L U| from a packed factor and the global row permutation."""
    n = a.shape[0]
    ell = np.tril(lu, -1) + np.eye(n)
    return np.abs(a[perm[:n]] - ell @ np.triu(lu)).max()


def test_gbtrf_band_dist_swaps_carry_the_whole_l_history():
    """n = 128, nb = 8: 16 tiles, so the windows are narrower than the grid.
    slate_tpu starts every swap column window at k - (wd_l - 1) and misses
    the multipliers of a row an earlier step moved down from above tile k:
    its P A - L U reads O(1).  The port's window reaches the oldest history
    of the rows it moves, so P A = L U within C_FACTOR n eps max|A|; the
    pivots, the info and U are slate_tpu's (later steps never read the
    stale multipliers)."""
    n, kl, ku = 128, 2, 2
    a = _operand(n, kl, ku, "float64")
    jlu, jperm, jinfo = jdl.gbtrf_band_dist(
        jp.from_dense(jnp.asarray(a), _jmesh(), NB, diag_pad_one=True), kl, ku, bcast_impl="psum")
    lu_ref, perm_ref = np.asarray(jp.to_dense(jlu)), np.asarray(jperm)
    lu, perm, info = tp.gbtrf_band_dist(tp.from_dense(_t(a), _tmesh(), NB, diag_pad_one=True), kl, ku)
    got = tp.to_dense(lu).numpy()
    tol = C_FACTOR * n * _eps("float64") * np.abs(a).max()
    np.testing.assert_array_equal(perm.numpy(), perm_ref)
    assert int(info) == int(jinfo) == 0
    assert np.abs(np.triu(got) - np.triu(lu_ref)).max() <= tol
    assert _lu_residual(got, perm.numpy(), a) <= tol
    assert _lu_residual(lu_ref, perm_ref, a) > 1e-3  # slate_tpu's stale multipliers


def test_gbtrf_band_dist_audit_differs_only_by_the_widened_swaps(monkeypatch):
    """Against a fresh trace of slate_tpu's kernel on a grid wider than its
    windows (nb = 3, 16 tiles): every op's bytes are slate_tpu's except the
    row exchange (psum over the mesh rows), which carries exactly the
    columns the widened swap windows add."""
    nb, n, kl, ku = 3, 48, 1, 1
    a = _operand(n, kl, ku, "float64")
    jm = _jmesh()
    ja = jp.from_dense(jnp.asarray(a), jm, nb, diag_pad_one=True)
    nt = ja.nt
    wd_l = min(((nb - 1) + kl) // nb + 1, nt)
    wd_u = min(((nb - 1) + kl + ku) // nb + 1, nt)
    wd_usw = min(((nb - 1) + 2 * kl + ku) // nb + 1, nt)
    wlsw = min(-(-((wd_l - 1) + wd_usw) // 4) + 1, nt // 4)
    with jcomm.comm_audit() as jrec:
        jax.make_jaxpr(jdl._gb_pp_jit.__wrapped__, static_argnums=tuple(range(1, 10)))(
            ja.tiles, jm, 2, 4, nt, n, wd_l, wd_u, wd_usw, "psum")
    widths = []
    swap_rows = tdl._swap_rows

    def spy(loc, pos, slot_ok, pos2row, p, nb_, cols):
        widths.append((len(pos), cols.shape[1]))
        return swap_rows(loc, pos, slot_ok, pos2row, p, nb_, cols)

    monkeypatch.setattr(tdl, "_swap_rows", spy)
    with tcomm.comm_audit() as trec:
        tp.gbtrf_band_dist(tp.from_dense(_t(a), _tmesh(), nb, diag_pad_one=True), kl, ku,
                           bcast_impl="psum")
    want, got = _totals(jrec), _totals(trec)
    extra = sum(npos * (w - wlsw) for npos, w in widths) * nb * 8
    assert extra > 0 and all(w >= wlsw for _, w in widths)
    assert set(got) == set(want)
    for op in want:
        assert got[op] == want[op] + (extra if op == "psum[p]" else 0), op
