"""The port's checkpointed LU chains (``getrf_nopiv_ckpt``,
``getrf_pp_ckpt``), against themselves and against slate_tpu.

Within the port, bitwise: the chains against ``getrf_nopiv_dist`` /
``getrf_pp_dist`` at lookahead 0, 1 and 2; kill -> resume on the same
mesh and on a reshaped 4 x 2 mesh (pp: the permutation's first n entries
too), through a disk round trip for pp; in-segment kills; async
snapshots; the mesh drivers' routing.  Against ``slate_tpu`` on the same
numpy operands (tests/test_ckpt.py's shapes, panels pinned to xla): the
factors within 100 n eps max|A|, info, pivots, kill steps and the
snapshot metadata bitwise, and a pp snapshot file written by either
package resumed in the other.
"""

import gc

import jax
import numpy as np
import pytest
import torch

from torch_ckpt_common import (  # noqa: F401 (no_ckpt_env: an autouse fixture)
    EVERY,
    JCKPT,
    N,
    NB,
    NT,
    assert_bitwise,
    ckpt,
    elastic,
    jckpt,
    jdist,
    jelastic,
    jkill,
    jmesh,
    kill,
    meta,
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
from slate_tpu_torch.parallel import comm
from slate_tpu_torch.types import Option

torch.set_num_threads(1)

OPS = ("getrf_nopiv", "getrf_pp")
PLAIN = {"getrf_nopiv": tp.getrf_nopiv_dist, "getrf_pp": tp.getrf_pp_dist}
CHAIN = {"getrf_nopiv": ckpt.getrf_nopiv_ckpt, "getrf_pp": ckpt.getrf_pp_ckpt}


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def runs():
    out = {}
    for op in OPS:
        d = tdist(op)
        out[op] = (d, PLAIN[op](d), CHAIN[op](d, every=EVERY))
    return out


@pytest.mark.parametrize("la", [0, 1, 2])
@pytest.mark.parametrize("op", OPS)
def test_chain_bitwise_plain_at_every_lookahead(runs, op, la):
    d, _, got = runs[op]
    assert_bitwise(PLAIN[op](d, lookahead=la), got, f"{op} lookahead {la}")


@pytest.mark.parametrize("op", OPS)
def test_kill_resume_bitwise_same_mesh(runs, op):
    d, ref, _ = runs[op]
    ck = kill(op, lambda: CHAIN[op](d, every=EVERY), 4)
    assert (ck.op, ck.step, ck.every, ck.grid) == (op, 3, EVERY, (2, 4))
    assert ck.growth_abort == (op == "getrf_nopiv")  # slate_tpu's default gate, recorded
    if op == "getrf_pp":
        assert ck.rowperm.dtype == np.int64 and ck.rowperm.shape == (NT * NB,)
    else:
        assert ck.rowperm is None
    assert_bitwise(ref, elastic.resume(ck, tmesh()), f"{op} resume")
    assert_bitwise(ref, elastic.resume(ck, tmesh()), f"{op} second resume")


@pytest.mark.parametrize("op", OPS)
def test_resume_reshaped_mesh(runs, op):
    d, ref, _ = runs[op]
    ck = kill(op, lambda: CHAIN[op](d, every=EVERY), 5)
    before = ft_counter_values()
    with comm.comm_audit() as recs:
        res = elastic.resume(ck, tmesh(4, 2), bcast_impl="psum")
    after = ft_counter_values()
    # the ring's hops are the only ppermutes under the psum lowering
    ring = sum(b * m for name, b, m in recs if name.startswith("ppermute"))
    wire = tp.redistribute_wire_bytes(d.tiles.shape, 2, 4, 8)
    assert ring == wire == after["ckpt_redistribute_bytes"] - before["ckpt_redistribute_bytes"]
    assert after["ckpt_reshards"] - before["ckpt_reshards"] == 1
    assert res[0].mesh == tmesh(4, 2)
    assert torch.equal(tp.to_dense(ref[0]), tp.to_dense(res[0]))
    assert int(res[-1]) == int(ref[-1]) == 0
    if op == "getrf_pp":
        # the data prefix bitwise; the re-based pad rows fixed points
        assert torch.equal(ref[1][:N], res[1][:N])
        assert torch.equal(res[1][N:], torch.arange(N, res[1].numel()))


@pytest.mark.parametrize("op", OPS)
def test_in_segment_kill_and_async(runs, op):
    d, ref, _ = runs[op]
    before = ft_counter_values()
    ck = kill(op, lambda: CHAIN[op](d, every=EVERY), 5, in_segment=True)
    after = ft_counter_values()
    assert ck.step == 3 and after["ckpt_lost_steps"] - before["ckpt_lost_steps"] == 2
    ck_b = kill(op, lambda: CHAIN[op](d, every=EVERY), 5)
    np.testing.assert_array_equal(ck.tiles, ck_b.tiles)
    if op == "getrf_pp":
        np.testing.assert_array_equal(ck.rowperm, ck_b.rowperm)
    assert_bitwise(ref, elastic.resume(ck, tmesh()), f"{op} in-segment resume")
    assert_bitwise(ref, CHAIN[op](d, every=EVERY, async_snapshots=True), f"{op} async chain")
    ck_a = kill(op, lambda: CHAIN[op](d, every=EVERY, async_snapshots=True), 5)
    np.testing.assert_array_equal(ck_a.tiles, ck_b.tiles)


def test_pp_disk_roundtrip(runs, tmp_path):
    d, ref, _ = runs["getrf_pp"]
    ck = kill("getrf_pp", lambda: ckpt.getrf_pp_ckpt(d, every=EVERY), 4)
    ck2 = ckpt.Checkpoint.load(ck.save(str(tmp_path / "pp.npz")))
    assert meta(ck2) == meta(ck)
    np.testing.assert_array_equal(ck2.rowperm, ck.rowperm)
    assert_bitwise(ref, elastic.resume(ck2, tmesh()), "pp disk resume")


@pytest.mark.parametrize("op", OPS)
def test_drivers_route_checkpoint(op, monkeypatch):
    """getrf_nopiv_mesh / gesv_nopiv_mesh and getrf_mesh / gesv_mesh with
    Option.Checkpoint run the checkpointed chain: the plain bits."""
    calls = []
    real = getattr(ckpt, f"{op}_ckpt")

    def spy(*args, **kwargs):
        calls.append(kwargs["every"])
        return real(*args, **kwargs)

    monkeypatch.setattr(ckpt, f"{op}_ckpt", spy)
    getrf, gesv = {"getrf_nopiv": (tp.getrf_nopiv_mesh, tp.gesv_nopiv_mesh),
                   "getrf_pp": (tp.getrf_mesh, tp.gesv_mesh)}[op]
    a = torch.from_numpy(operand("dom" if op == "getrf_nopiv" else "general"))
    b = torch.from_numpy(np.random.default_rng(4).standard_normal((N, 2)))
    off = {Option.MixedPrecision: "off"}
    f0 = getrf(a, tmesh(), NB)
    f1 = getrf(a, tmesh(), NB, opts={Option.Checkpoint: 3})
    assert_bitwise(f0, f1, op)
    x0 = gesv(a, b, tmesh(), NB, opts=off)
    x1 = gesv(a, b, tmesh(), NB, opts={**off, Option.Checkpoint: 2})
    assert torch.equal(x0[0], x1[0]) and calls == [3, 2]


# ---------------------------------------------------------------------------
# against slate_tpu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", OPS)
def test_lu_ckpt_parity_with_slate_tpu(op):
    a = operand("dom" if op == "getrf_nopiv" else "general")
    scale = float(np.abs(a).max())
    with xla_panels():
        jd, td = jdist(op), tdist(op)
        jout = JCKPT[op](jd, every=EVERY, num_monitor="off")
        tout = CHAIN[op](td, every=EVERY)
        assert within_class(tp.to_dense(tout[0]).numpy(), np.asarray(jto_dense(jout[0])), scale) <= 1
        assert int(tout[-1]) == int(jout[-1]) == 0
        if op == "getrf_pp":
            np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
        jk = jkill(op, lambda: JCKPT[op](jd, every=EVERY, num_monitor="off"), 4)
        tk = kill(op, lambda: CHAIN[op](td, every=EVERY), 4)
        assert meta(tk) == meta(jk) and tk.growth_abort == jk.growth_abort
        assert within_class(tk.tiles, np.asarray(jk.tiles), scale) <= 1
        if op == "getrf_pp":
            np.testing.assert_array_equal(tk.rowperm, np.asarray(jk.rowperm))
        jr = jelastic.resume(jk, jmesh())
        tr = elastic.resume(tk, tmesh())
        assert within_class(tp.to_dense(tr[0]).numpy(), np.asarray(jto_dense(jr[0])), scale) <= 1
        if op == "getrf_pp":
            np.testing.assert_array_equal(tr[1].numpy(), np.asarray(jr[1]))


def test_pp_snapshot_files_resume_in_the_other_package(tmp_path):
    """A pp snapshot saved by slate_tpu resumes in the port, and the
    reverse, each matching the other package's uninterrupted factor
    within the class and its pivots bitwise."""
    a = operand("general")
    scale = float(np.abs(a).max())
    with xla_panels():
        jd, td = jdist("getrf_pp"), tdist("getrf_pp")
        jref = jckpt.getrf_pp_ckpt(jd, every=EVERY, num_monitor="off")
        tref = ckpt.getrf_pp_ckpt(td, every=EVERY)
        jk = jkill("getrf_pp", lambda: jckpt.getrf_pp_ckpt(jd, every=EVERY, num_monitor="off"), 4)
        tk = kill("getrf_pp", lambda: ckpt.getrf_pp_ckpt(td, every=EVERY), 4)
        from_j = ckpt.Checkpoint.load(jk.save(str(tmp_path / "from_slate_tpu.npz")))
        from_t = jckpt.Checkpoint.load(tk.save(str(tmp_path / "from_port.npz")))
        got_t = elastic.resume(from_j, tmesh())
        got_j = jelastic.resume(from_t, jmesh())
        assert within_class(tp.to_dense(got_t[0]).numpy(), np.asarray(jto_dense(jref[0])), scale) <= 1
        assert within_class(np.asarray(jto_dense(got_j[0])), tp.to_dense(tref[0]).numpy(), scale) <= 1
        np.testing.assert_array_equal(got_t[1].numpy(), np.asarray(jref[1]))
        np.testing.assert_array_equal(np.asarray(got_j[1]), tref[1].numpy())
        assert int(got_t[2]) == int(got_j[2]) == 0
