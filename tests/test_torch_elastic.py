"""The port's elastic resume (slate_tpu_torch.ft.elastic): the three
carry-rebuild tiers, ``reshard``, the host relayout helpers, the device
rule, and snapshot files shared with slate_tpu.

Within the port, bitwise: a resume on the same grid, on a reshaped grid
of the same device count (the ring redistribution, its audited bytes
``redistribute_wire_bytes``) and on a grid of another device count (the
host relayout, fresh pad tiles the identity), for the three tile-stack
ops; the pp permutation re-based onto the new padded row space.  Against
``slate_tpu``: ``_regrow``, ``_rowperm_to_rows`` and the host tile
permutations bitwise on the same arrays, and potrf snapshot files
written by either package resumed in the other (also on a reshaped
grid) within 100 n eps max|A| of the other's uninterrupted factor.
"""

import gc

import jax
import numpy as np
import pytest
import torch

from torch_ckpt_common import (  # noqa: F401 (no_ckpt_env: an autouse fixture)
    CASES,
    EVERY,
    N,
    NB,
    NT,
    TILE_OPS,
    assert_bitwise,
    ckpt,
    elastic,
    jckpt,
    jdist,
    jelastic,
    jkill,
    jmesh,
    kill,
    no_ckpt_env,
    operand,
    tdist,
    tmesh,
    within_class,
    xla_panels,
)

from slate_tpu.parallel import to_dense as jto_dense
from slate_tpu_torch import parallel as tp
from slate_tpu_torch.ft.policy import ft_counter_values
from slate_tpu_torch.types import SlateError

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def killed():
    """Per tile-stack op: (operand, uninterrupted result, the snapshot of a
    kill at step 5)."""
    out = {}
    for op in TILE_OPS:
        d = tdist(op)
        chain = CASES[op][3]
        out[op] = (d, chain(d, every=EVERY), kill(op, lambda: chain(d, every=EVERY), 5))
    return out


# ---------------------------------------------------------------------------
# the host helpers against slate_tpu's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grow", [(8, 8, 9, 9), (8, 8, 12, 12), (12, 12, 8, 8), (8, 8, 8, 8),
                                  (9, 8, 12, 8)])
def test_regrow_matches_slate_tpu(grow):
    mt1, nt1, mt2, nt2 = grow
    logi = np.random.default_rng(sum(grow)).standard_normal((mt1, nt1, 4, 4))
    for diag_pad in (True, False):
        got = elastic._regrow(logi, mt2, nt2, 4, diag_pad)
        want = jelastic._regrow(logi, mt2, nt2, 4, diag_pad)
        np.testing.assert_array_equal(got, want)
        assert got.shape == (mt2, nt2, 4, 4)


@pytest.mark.parametrize("mglob2", [NT * NB, 72, 96, 40])
def test_rowperm_to_rows_matches_slate_tpu(killed, mglob2):
    ck = killed["getrf_pp"][2]
    got = elastic._rowperm_to_rows(ck, mglob2)
    np.testing.assert_array_equal(got, jelastic._rowperm_to_rows(ck, mglob2))
    assert got.dtype == np.int64
    assert elastic._rowperm_to_rows(killed["potrf"][2], mglob2) is None


@pytest.mark.parametrize("p,q", [(2, 4), (4, 2), (3, 2), (1, 8)])
def test_host_tile_permutations_match_slate_tpu(p, q):
    t = np.random.default_rng(p * 10 + q).standard_normal((12, 24, 2, 2))
    np.testing.assert_array_equal(ckpt._cyclic_to_logical(t, p, q), jckpt._cyclic_to_logical(t, p, q))
    np.testing.assert_array_equal(ckpt._logical_to_cyclic(t, p, q), jckpt._logical_to_cyclic(t, p, q))
    np.testing.assert_array_equal(ckpt._cyclic_to_logical(ckpt._logical_to_cyclic(t, p, q), p, q), t)


# ---------------------------------------------------------------------------
# the three tiers, within the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", TILE_OPS)
def test_same_grid_tier(killed, op):
    d, ref, ck = killed[op]
    before = ft_counter_values()
    assert_bitwise(ref, elastic.resume(ck, tmesh()), op)
    after = ft_counter_values()
    assert after["ckpt_reshards"] == before["ckpt_reshards"]
    assert after["ckpt_redistribute_bytes"] == before["ckpt_redistribute_bytes"]
    assert after["ckpt_resumes"] - before["ckpt_resumes"] == 1


@pytest.mark.parametrize("op", TILE_OPS)
def test_ring_tier(killed, op):
    """2 x 4 -> 4 x 2: the snapshot lands on its 2 x 4 grid over the new
    mesh's own device ids (any ids) and moves by the ring, whose audited
    bytes are counted."""
    d, ref, ck = killed[op]
    wire = tp.redistribute_wire_bytes(d.tiles.shape, 2, 4, 8)
    results = []
    for ids in (range(8), range(8, 16)):
        before = ft_counter_values()
        res = elastic.resume(ck, tmesh(4, 2, devices=ids))
        after = ft_counter_values()
        assert after["ckpt_redistribute_bytes"] - before["ckpt_redistribute_bytes"] == wire
        assert after["ckpt_reshards"] - before["ckpt_reshards"] == 1
        assert torch.equal(tp.to_dense(ref[0]), tp.to_dense(res[0])) and int(res[-1]) == 0
        results.append(res)
    assert torch.equal(results[0][0].tiles, results[1][0].tiles)
    assert_bitwise(results[0][1:], results[1][1:], op)


@pytest.mark.parametrize("grid", [(2, 2), (1, 3), (3, 2)])
@pytest.mark.parametrize("op", TILE_OPS)
def test_host_relayout_tier(killed, op, grid):
    """Another device count: the logical grid cropped or grown for the new
    lcm (1 x 3: 9 tiles; 3 x 2: 12), fresh pad tiles the identity; the
    data region and info bitwise, pp's perm prefix bitwise."""
    d, ref, ck = killed[op]
    mesh = tmesh(*grid)
    res = elastic.resume(ck, mesh)
    mt2 = tp.padded_tiles(N, NB, mesh)
    assert res[0].tiles.shape[:2] == (mt2, mt2) and res[0].mesh == mesh
    assert torch.equal(tp.to_dense(ref[0]), tp.to_dense(res[0]))
    assert int(res[-1]) == int(ref[-1]) == 0
    if op == "getrf_pp":
        assert res[1].numel() == mt2 * NB and torch.equal(res[1][:N], ref[1][:N])
        assert torch.equal(res[1][N:], torch.arange(N, mt2 * NB))


def test_reshard_counts_its_traffic():
    d = tdist("potrf")
    before = ft_counter_values()
    assert elastic.reshard(d, tmesh()) is d  # identical layout: nothing moves
    mid = ft_counter_values()
    assert mid["ckpt_reshards"] == before["ckpt_reshards"]
    out = elastic.reshard(d, tmesh(4, 2))
    after = ft_counter_values()
    assert after["ckpt_reshards"] - mid["ckpt_reshards"] == 1
    assert after["ckpt_redistribute_bytes"] - mid["ckpt_redistribute_bytes"] == \
        tp.redistribute_wire_bytes(d.tiles.shape, 2, 4, 8)
    assert torch.equal(tp.to_dense(out), tp.to_dense(d)) and out.mesh == tmesh(4, 2)


def test_unknown_op_is_not_resumable(killed):
    ck = killed["potrf"][2]
    bad = ckpt.Checkpoint(**{**ck.__dict__, "op": "gemm"})
    assert elastic.resumable(ck) and not elastic.resumable(bad)
    with pytest.raises(SlateError, match="unknown op"):
        elastic.resume(bad, tmesh())


def test_outputs_on_the_mesh_device():
    """The ckpt drivers and resume compute on the DistMatrix's device:
    every output tensor lies on ``mesh.device``, and a resume onto a mesh
    on the card goes to the card (here: CUDA is missing, so it raises
    instead of staying on the host)."""
    for op in CASES:
        chain = CASES[op][3]
        mesh = tmesh()
        d = tdist(op, mesh)
        ck = kill(op, lambda: chain(d, every=EVERY), 4)
        for res in (chain(d, every=EVERY), elastic.resume(ck, mesh)):
            for x in res:
                if isinstance(x, tp.DistMatrix):
                    assert x.mesh == mesh, op
                    x = x.tiles
                assert x.device == mesh.device, op
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            elastic.resume(ck, tp.make_mesh(2, 4))  # the default mesh: the card


# ---------------------------------------------------------------------------
# snapshot files shared with slate_tpu
# ---------------------------------------------------------------------------


def test_potrf_snapshot_files_resume_in_the_other_package(tmp_path):
    """A potrf snapshot saved by slate_tpu resumes in the port (on the
    same grid and on 4 x 2), and the port's resumes in slate_tpu, each
    within the class of the other package's uninterrupted factor."""
    a = operand("spd")
    scale = float(np.abs(a).max())
    with xla_panels():
        jd, td = jdist("potrf"), tdist("potrf")
        jref = jckpt.potrf_ckpt(jd, every=EVERY, num_monitor="off")
        tref = ckpt.potrf_ckpt(td, every=EVERY)
        jk = jkill("potrf", lambda: jckpt.potrf_ckpt(jd, every=EVERY, num_monitor="off"), 4)
        tk = kill("potrf", lambda: ckpt.potrf_ckpt(td, every=EVERY), 4)
        from_j = ckpt.Checkpoint.load(jk.save(str(tmp_path / "from_slate_tpu.npz")))
        from_t = jckpt.Checkpoint.load(tk.save(str(tmp_path / "from_port.npz")))
        assert (from_j.op, from_j.step, from_j.grid, from_j.nbytes) == (
            "potrf", 3, (2, 4), tk.nbytes)
        want_j = np.asarray(jto_dense(jref[0]))
        for mesh in (tmesh(), tmesh(4, 2)):
            got, info = elastic.resume(from_j, mesh)
            assert within_class(tp.to_dense(got).numpy(), want_j, scale) <= 1 and int(info) == 0
        got_j, jinfo = jelastic.resume(from_t, jmesh())
        assert within_class(np.asarray(jto_dense(got_j)), tp.to_dense(tref[0]).numpy(), scale) <= 1
        assert int(jinfo) == 0
