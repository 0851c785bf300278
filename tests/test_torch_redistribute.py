"""The port's redistribute (slate_tpu_torch.parallel.redistribute, eager and
the ring all-to-all), the device identity of its virtual meshes, the tile
-> rank maps of core/grid.py and comm.ppermute_a, against slate_tpu.

``slate_tpu`` runs on the 8 forced CPU devices of conftest.py; the port on
virtual meshes on the CPU whose device ids are the same positions (jax CPU
device k is virtual id k).  Everything here is bitwise: the tiles (in
cyclic storage and after ``from_cyclic``), m, n, nb and ``diag_pad``, the
fresh identity pad tiles, the audited ppermute records, the grid maps and
every ``ValueError``.  Shapes mirror tests/test_parallel.py:406-477 and
tests/test_comm_audit.py:441.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import cpu_devices

from slate_tpu import parallel as jp
from slate_tpu.core import grid as jgrid
from slate_tpu.core.tiling import from_cyclic as jfrom_cyclic
from slate_tpu.parallel import comm as jcomm
from slate_tpu.parallel import dist as jdist
from slate_tpu.types import GridOrder as JGridOrder
from slate_tpu_torch import parallel as tp
from slate_tpu_torch.core import grid as tgrid
from slate_tpu_torch.core.tiling import from_cyclic as tfrom_cyclic
from slate_tpu_torch.parallel import comm as tcomm
from slate_tpu_torch.parallel import dist as tdist
from slate_tpu_torch.types import GridOrder

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    """Drop the module's compiled JAX programs when it ends (each holds
    memory mappings; an xdist worker keeping them all can reach the
    per-process map limit)."""
    yield
    jax.clear_caches()
    gc.collect()


NB = 16


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def _spd(n, seed):
    g = _rand((n, n), seed)
    return g @ g.T + n * np.eye(n)


def _jm(p, q, ndev=8, order=None):
    return jp.make_mesh(p, q, devices=cpu_devices(ndev), order=order)


def _tm(p, q, ndev=8, order=None):
    return tp.make_mesh(p, q, device="cpu", devices=range(ndev), order=order)


def _same_layout(t, j):
    assert (t.m, t.n, t.nb, t.diag_pad) == (j.m, j.n, j.nb, j.diag_pad)
    np.testing.assert_array_equal(t.tiles.numpy(), np.asarray(j.tiles))


# ---------------------------------------------------------------------------
# the grid maps and the virtual mesh's device identity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order", ["Row", "Col"])
def test_grid_maps_match_jax(order):
    to, jo = GridOrder[order], JGridOrder[order]
    tiles = [(i, j) for i in range(7) for j in range(9)]
    for p, q in ((2, 4), (3, 2), (1, 5)):
        for tf, jf in ((tgrid.process_2d_grid(to, p, q), jgrid.process_2d_grid(jo, p, q)),
                       (tgrid.device_2d_grid(to, p, q), jgrid.device_2d_grid(jo, p, q)),
                       (tgrid.process_1d_grid(to, p * q), jgrid.process_1d_grid(jo, p * q)),
                       (tgrid.device_1d_grid(to, q), jgrid.device_1d_grid(jo, q)),
                       (tgrid.transpose_grid(tgrid.process_2d_grid(to, p, q)),
                        jgrid.transpose_grid(jgrid.process_2d_grid(jo, p, q)))):
            assert [tf(ij) for ij in tiles] == [jf(ij) for ij in tiles]
    for k in range(1, 33):
        assert tgrid.grid_2d_factor(k) == jgrid.grid_2d_factor(k)


@pytest.mark.parametrize("args", [(2, 4, 8, "Row"), (2, 4, 8, "Col"), (4, 2, 8, "Col"),
                                  (1, 8, 8, "Row"), (2, 2, 4, "Col"), (None, None, 8, "Row"),
                                  (None, 2, 8, "Row"), (4, None, 8, "Col"), (2, 3, 8, "Row")])
def test_make_mesh_device_grid_matches_jax(args):
    p, q, ndev, order = args
    jm = jp.make_mesh(p, q, devices=cpu_devices(ndev), order=JGridOrder[order])
    tm = tp.make_mesh(p, q, device="cpu", devices=range(ndev), order=GridOrder[order])
    ids = {d: k for k, d in enumerate(cpu_devices(ndev))}
    assert tm.devices == tuple(tuple(ids[d] for d in row) for row in jm.devices)
    assert (tm.p, tm.q) == jp.mesh_shape(jm)


def test_make_mesh_rules():
    with pytest.raises(ValueError):
        jp.make_mesh(3, 3, devices=cpu_devices(8))
    with pytest.raises(ValueError):
        tp.make_mesh(3, 3, device="cpu", devices=range(8))
    with pytest.raises(ValueError):
        tp.make_mesh(device="cpu")  # neither p, q nor devices
    with pytest.raises(ValueError):
        tp.make_mesh(2, 2, device="cpu", devices=[0, 1, 1, 2])
    m = tp.make_mesh(2, 4, device="cpu")
    assert m == tp.make_mesh(2, 4, device="cpu") == tp.make_mesh(2, 4, device="cpu", devices=range(8))
    assert hash(m) == hash(tp.make_mesh(2, 4, device="cpu"))
    assert m.devices == ((0, 1, 2, 3), (4, 5, 6, 7))
    assert tp.make_mesh(2, 4, device="cpu", devices=[7, 6, 5, 4, 3, 2, 1, 0]) != m
    # a grid order keeps its own placement
    assert tp.make_mesh(2, 4, device="cpu", order=GridOrder.Col).devices == ((0, 2, 4, 6), (1, 3, 5, 7))


def test_ppermute_a_moves_and_records_link_bytes():
    """The hop: target t receives source s's payload, untargeted devices
    receive zeros, and the record is payload bytes x pairs under the
    enclosing audit_scope (tests/test_comm_audit.py's
    ``test_ppermute_a_records_link_bytes``)."""
    x = torch.arange(2 * 4 * 3, dtype=torch.float64).view(2, 4, 3)
    ring = [((i + 1) % 4, i) for i in range(4)]
    with tcomm.comm_audit() as recs:
        with tcomm.audit_scope(5):
            y = tcomm.ppermute_a(x, "q", ring)
        z = tcomm.ppermute_a(x, "p", [(0, 1)])
    assert torch.equal(y, x[:, [1, 2, 3, 0]])
    assert torch.equal(z[1], x[0]) and not z[0].any()
    assert recs == [("ppermute[q]", 3 * 8 * 4, 5), ("ppermute[p]", 3 * 8 * 1, 1)]

    def fn(v):
        with jcomm.audit_scope(5):
            return jcomm.ppermute_a(v, "q", ring)

    with jcomm.comm_audit() as jrecs:
        jax.make_jaxpr(jax.vmap(fn, axis_name="q"))(jnp.zeros((4, 3)))
    assert jrecs == recs[:1]


# ---------------------------------------------------------------------------
# redistribute: the two lowerings against each other and against slate_tpu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid2", [(4, 2), (1, 8)])
def test_redistribute_shardmap_matches_eager_and_jax(grid2):
    a = _rand((90, 70), 1)
    jd = jp.from_dense(jnp.asarray(a), _jm(2, 4), NB)
    td = tp.from_dense(_t(a), _tm(2, 4), NB)
    jm2, tm2 = _jm(*grid2), _tm(*grid2)
    te = tp.redistribute(td, tm2, impl="eager")
    ts = tp.redistribute(td, tm2, impl="shardmap")
    assert (te.m, te.n, te.nb, te.diag_pad) == (ts.m, ts.n, ts.nb, ts.diag_pad)
    assert torch.equal(te.tiles, ts.tiles) and ts.mesh == tm2
    for tt_, impl in ((te, "eager"), (ts, "shardmap")):
        jj = jp.redistribute(jd, jm2, impl=impl)
        _same_layout(tt_, jj)
        np.testing.assert_array_equal(tfrom_cyclic(tt_.tiles, *grid2).numpy(),
                                      np.asarray(jfrom_cyclic(jj.tiles, *grid2)))
    assert torch.equal(tp.to_dense(ts), _t(a))
    assert tp.redistribute(td, tm2).tiles.equal(ts.tiles)  # auto takes the ring


def test_redistribute_2x2_to_degenerate_4x1():
    a = _rand((52, 52), 2)
    jd = jp.from_dense(jnp.asarray(a), _jm(2, 2, 4), NB)
    td = tp.from_dense(_t(a), _tm(2, 2, 4), NB)
    jm2, tm2 = _jm(4, 1, 4), _tm(4, 1, 4)
    te = tp.redistribute(td, tm2, impl="eager")
    ts = tp.redistribute(td, tm2, impl="shardmap")
    assert torch.equal(te.tiles, ts.tiles)
    _same_layout(ts, jp.redistribute(jd, jm2, impl="shardmap"))
    assert torch.equal(tp.to_dense(ts), _t(a))
    # and back from the 1 x 8 ring's mirror, a 8 x 1 column
    td8 = tp.from_dense(_t(a), _tm(1, 8), NB)
    back = tp.redistribute(td8, _tm(8, 1), impl="shardmap")
    assert torch.equal(back.tiles, tp.redistribute(td8, _tm(8, 1), impl="eager").tiles)


@pytest.mark.parametrize("order", ["Row", "Col"])
def test_redistribute_across_grid_orders(order):
    """A Col-ordered target places the same ids elsewhere: the ring's
    coordinate map follows the ids, and the result is the eager one."""
    a = _rand((90, 70), 3)
    td = tp.from_dense(_t(a), _tm(2, 4), NB)
    tm2 = _tm(4, 2, order=GridOrder[order])
    ts = tp.redistribute(td, tm2, impl="shardmap")
    assert torch.equal(ts.tiles, tp.redistribute(td, tm2, impl="eager").tiles)
    jd = jp.from_dense(jnp.asarray(a), _jm(2, 4), NB)
    _same_layout(ts, jp.redistribute(jd, _jm(4, 2, order=JGridOrder[order]), impl="shardmap"))


def test_redistribute_roundtrip_bitwise_keeps_diag_pad():
    """Mesh reshape and nb change 16 -> 32 -> 16 (the eager retile) is
    bitwise, and a diag-padded operand keeps its identity pad (flag and
    bytes), as tests/test_parallel.py::test_redistribute_roundtrip_bitwise."""
    a = _spd(90, 4)
    td = tp.from_dense(_t(a), _tm(2, 4), NB, diag_pad_one=True)
    d2 = tp.redistribute(td, _tm(4, 2), nb=32)
    assert d2.diag_pad and d2.nb == 32
    d2.require_diag_pad("roundtrip")
    d3 = tp.redistribute(d2, _tm(2, 4), nb=16)
    assert d3.diag_pad
    assert torch.equal(d3.tiles, td.tiles)
    jd = jp.from_dense(jnp.asarray(a), _jm(2, 4), NB, diag_pad_one=True)
    _same_layout(d2, jp.redistribute(jd, _jm(4, 2), nb=32))


def test_redistribute_fresh_pad_tiles_are_identity():
    """40 / 16 -> 3 data tiles; the lcm(2, 4) = 4 grid grows to lcm(1, 8) =
    8: tiles 3..7 of the diagonal are fresh and get the identity under
    both lowerings, bitwise slate_tpu's."""
    a = _spd(90, 5)[:40, :40]
    td = tp.from_dense(_t(a), _tm(2, 4), NB, diag_pad_one=True)
    jd = jp.from_dense(jnp.asarray(a), _jm(2, 4), NB, diag_pad_one=True)
    assert tdist.fresh_pad_diag_range(4, 4, 8, 8) == jdist.fresh_pad_diag_range(4, 4, 8, 8) == (4, 8)
    for impl in ("eager", "shardmap"):
        g = tp.redistribute(td, _tm(1, 8), impl=impl)
        assert g.diag_pad, impl
        logi = tfrom_cyclic(g.tiles, 1, 8).numpy()
        for t in range(3, 8):
            np.testing.assert_array_equal(logi[t, t], np.eye(NB), err_msg=f"{impl} pad tile {t}")
        _same_layout(g, jp.redistribute(jd, _jm(1, 8), impl=impl))
    # a source without diag_pad grows zero pad tiles
    z = tp.redistribute(tp.from_dense(_t(a), _tm(2, 4), NB), _tm(1, 8), impl="shardmap")
    assert not z.diag_pad and not tfrom_cyclic(z.tiles, 1, 8)[4:, 4:].any()


def test_redistribute_audit_matches_jax_and_wire_bytes():
    """The ring's audited records equal slate_tpu's (a fresh trace of its
    ``_redist_shardmap_fn``) at tests/test_comm_audit.py:441's shape, and
    their sum ``redistribute_wire_bytes`` = 9216 * 26."""
    jm, jm2 = _jm(2, 4), _jm(4, 2)
    jd = jp.from_dense(jnp.zeros((96, 96)), jm, 8)
    cmap = jdist._shardmap_coord_map(jm, jm2)
    dims = (4, 2, jd.tiles.shape[0], jd.tiles.shape[1], jdist.padded_tiles(96, 8, jm2),
            jdist.padded_tiles(96, 8, jm2), 8)
    with jcomm.comm_audit() as jrecs:
        jax.make_jaxpr(lambda t: jdist._redist_shardmap_fn(t, jm, 2, 4, dims, cmap, False))(jd.tiles)
    td = tp.from_dense(torch.zeros((96, 96), dtype=torch.float64), _tm(2, 4), 8)
    assert tdist._shardmap_coord_map(td.mesh, _tm(4, 2)) == cmap
    with tcomm.comm_audit() as trecs:
        tp.redistribute(td, _tm(4, 2), impl="shardmap")
    assert trecs == jrecs
    want = tdist.redistribute_wire_bytes(td.tiles.shape, 2, 4, 8)
    assert want == jdist.redistribute_wire_bytes(jd.tiles.shape, 2, 4, 8) == 9216 * (2 * 3 * 4 + 1 * 2)
    assert sum(b * m for _, b, m in trecs) == want
    # the eager lowering and the identical layout record nothing
    with tcomm.comm_audit() as erecs:
        tp.redistribute(td, _tm(4, 2), impl="eager")
        assert tp.redistribute(td, _tm(2, 4)) is td
    assert erecs == []


@pytest.mark.parametrize("grids", [((1, 8), (8, 1)), ((4, 1), (2, 2)), ((2, 2), (1, 4))])
def test_redistribute_wire_bytes_other_grids(grids):
    (p, q), (p2, q2) = grids
    a = _rand((70, 90), 6)
    td = tp.from_dense(_t(a), _tm(p, q, p * q), NB)
    with tcomm.comm_audit() as recs:
        out = tp.redistribute(td, _tm(p2, q2, p * q), impl="shardmap")
    assert sum(b * m for _, b, m in recs) == tdist.redistribute_wire_bytes(td.tiles.shape, p, q, 8)
    assert torch.equal(tp.to_dense(out), _t(a))


def test_redistribute_value_errors():
    a = _rand((64, 64), 7)
    td = tp.from_dense(_t(a), _tm(2, 4), NB)
    jd = jp.from_dense(jnp.asarray(a), _jm(2, 4), NB)
    for impl_call in (lambda: tp.redistribute(td, _tm(4, 2), impl="ring"),
                      lambda: tp.redistribute(td, _tm(4, 2), nb=32, impl="shardmap"),
                      lambda: tp.redistribute(td, _tm(2, 2, 4), impl="shardmap"),
                      lambda: tp.redistribute(td, tp.make_mesh(2, 4, device="cpu",
                                                               devices=range(8, 16)),
                                              impl="shardmap")):
        with pytest.raises(ValueError):
            impl_call()
    for impl_call in (lambda: jp.redistribute(jd, _jm(4, 2), impl="ring"),
                      lambda: jp.redistribute(jd, _jm(4, 2), nb=32, impl="shardmap"),
                      lambda: jp.redistribute(jd, _jm(2, 2, 4), impl="shardmap")):
        with pytest.raises(ValueError):
            impl_call()
    # not a re-arrangement: auto and eager move the data all the same
    sub = _tm(2, 2, 4)
    assert tdist._shardmap_coord_map(td.mesh, sub) is None
    assert torch.equal(tp.to_dense(tp.redistribute(td, sub)), _t(a))
    assert tp.REDIST_IMPLS == jdist.REDIST_IMPLS
