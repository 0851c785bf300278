"""The port's multi-array checkpointed chains (``geqrf_ckpt``: flat local
matrices, the T_loc stack and the tree V / T stacks; ``he2hb_ckpt``: flat
local matrices, the reflector and compact-WY stacks), against themselves
and against slate_tpu.

Within the port, bitwise: the chains against ``geqrf_dist`` /
``he2hb_dist``; kill -> resume on the same mesh through a disk round trip;
the refusal of a reshaped grid (the auxiliary carries are grid-locked)
and a resume on a same-shape grid of other device ids; in-segment kills;
async snapshots; the snapshot's arrays in ``slate_tpu``'s global layout;
``geqrf_mesh`` / ``gels_mesh`` / ``heev_mesh`` routing.  Against
``slate_tpu`` on the same numpy operands (tests/test_ckpt.py's shapes):
the factors and auxiliary stacks within 100 n eps of their scale, the
snapshot metadata bitwise, and a geqrf snapshot file written by either
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

from slate_tpu.linalg.eig import _he2hb_panel_count as j_panel_count
from slate_tpu.parallel import to_dense as jto_dense
from slate_tpu_torch import parallel as tp
from slate_tpu_torch.ft.policy import ft_counter_values
from slate_tpu_torch.linalg.eig import _he2hb_panel_count
from slate_tpu_torch.types import Option, SlateError

torch.set_num_threads(1)

OPS = ("geqrf", "he2hb")
PLAIN = {"geqrf": tp.geqrf_dist, "he2hb": tp.he2hb_dist}
CHAIN = {"geqrf": ckpt.geqrf_ckpt, "he2hb": ckpt.he2hb_ckpt}
KEYS = {"geqrf": ("tls", "tvs", "tts"), "he2hb": ("vqs", "tqs")}
CASE_KIND = {"geqrf": "general", "he2hb": "spd"}
HE_STEPS = _he2hb_panel_count(N, NB)  # 7 panel steps


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


@pytest.mark.parametrize("op", OPS)
def test_chain_bitwise_plain(runs, op):
    _, ref, got = runs[op]
    assert_bitwise(ref, got, op)


@pytest.mark.parametrize("every", [1, 2, 4, 7])
@pytest.mark.parametrize("op", OPS)
def test_chain_bitwise_at_every_interval(runs, op, every):
    d, ref, _ = runs[op]
    assert_bitwise(ref, CHAIN[op](d, every=every), f"{op} every {every}")


@pytest.mark.parametrize("op", OPS)
def test_kill_resume_bitwise_through_disk(runs, op, tmp_path):
    d, ref, _ = runs[op]
    ck = kill(op, lambda: CHAIN[op](d, every=EVERY), 4)
    assert (ck.op, ck.step, ck.grid, ck.rowperm) == (op, 3, (2, 4), None)
    assert set(ck.arrays) == set(KEYS[op])
    ck2 = ckpt.Checkpoint.load(ck.save(str(tmp_path / f"{op}.npz")))
    assert meta(ck2) == meta(ck)
    for k in KEYS[op]:
        np.testing.assert_array_equal(ck2.arrays[k], ck.arrays[k])
    assert_bitwise(ref, elastic.resume(ck2, tmesh()), f"{op} resume")
    assert_bitwise(ref, elastic.resume(ck2, tmesh()), f"{op} second resume")
    # the resumed loops write copies: the snapshot stays as it was
    np.testing.assert_array_equal(ck2.tiles, ck.tiles)
    for k in KEYS[op]:
        np.testing.assert_array_equal(ck2.arrays[k], ck.arrays[k])


def test_snapshot_arrays_in_global_layout(runs):
    """tls is (p nt, nb, nb) with mesh row r's stack at [r nt:(r + 1) nt]
    (DistQR.tloc's layout); the he2hb reflectors (steps, p mfl, nb) by
    mesh row, as DistTwoStage.vq."""
    d, ref, _ = runs["geqrf"]
    ck = kill("geqrf", lambda: ckpt.geqrf_ckpt(d, every=EVERY), 5)
    assert ck.arrays["tls"].shape == ref.tloc.shape == (2 * NT, NB, NB)
    assert ck.arrays["tvs"].shape == tuple(ref.treev.shape)
    assert ck.arrays["tts"].shape == tuple(ref.treet.shape)
    # steps 0-2 are final in the snapshot, steps 3.. still zero
    t = ck.arrays["tls"].reshape(2, NT, NB, NB)
    np.testing.assert_array_equal(t[:, :3], ref.tloc.view(2, NT, NB, NB)[:, :3].numpy())
    assert not t[:, 3:].any()
    d, ref, _ = runs["he2hb"]
    ck = kill("he2hb", lambda: ckpt.he2hb_ckpt(d, every=EVERY), 4)
    assert ck.arrays["vqs"].shape == tuple(ref.vq.shape) and ck.arrays["tqs"].shape == tuple(ref.tq.shape)
    np.testing.assert_array_equal(ck.arrays["vqs"][:3], ref.vq[:3].numpy())


@pytest.mark.parametrize("op", OPS)
def test_reshaped_grid_refused_other_ids_resume(runs, op):
    d, ref, _ = runs[op]
    ck = kill(op, lambda: CHAIN[op](d, every=EVERY), 4)
    with pytest.raises(SlateError, match="grid-locked"):
        elastic.resume(ck, tmesh(4, 2))
    before = ft_counter_values()["ckpt_reshards"]
    res = elastic.resume(ck, tmesh(2, 4, devices=range(8, 16)))
    assert ft_counter_values()["ckpt_reshards"] == before  # a same-shape grid
    for r, g in zip(ref[1:], res[1:]):
        assert torch.equal(r, g)
    assert torch.equal(ref[0].tiles, res[0].tiles)


@pytest.mark.parametrize("op", OPS)
def test_in_segment_kill_and_async(runs, op):
    d, ref, _ = runs[op]
    before = ft_counter_values()
    ck = kill(op, lambda: CHAIN[op](d, every=EVERY), 5, in_segment=True)
    assert ft_counter_values()["ckpt_lost_steps"] - before["ckpt_lost_steps"] == 2
    ck_b = kill(op, lambda: CHAIN[op](d, every=EVERY), 5)
    for k in KEYS[op]:
        np.testing.assert_array_equal(ck.arrays[k], ck_b.arrays[k])
    np.testing.assert_array_equal(ck.tiles, ck_b.tiles)
    assert_bitwise(ref, elastic.resume(ck, tmesh()), f"{op} in-segment resume")
    assert_bitwise(ref, CHAIN[op](d, every=EVERY, async_snapshots=True), f"{op} async")
    ck_a = kill(op, lambda: CHAIN[op](d, every=EVERY, async_snapshots=True), 5)
    for k in KEYS[op]:
        np.testing.assert_array_equal(ck_a.arrays[k], ck_b.arrays[k])


def test_he2hb_without_panels_and_refusals():
    """n <= nb + 1 has no panel step: he2hb_ckpt is he2hb_dist; a
    non-square he2hb and a wide geqrf raise as the plain drivers do."""
    small = tp.from_dense(torch.from_numpy(operand("spd")[:NB, :NB]), tmesh(), NB)
    assert_bitwise(tp.he2hb_dist(small), ckpt.he2hb_ckpt(small, every=1), "no panel")
    wide = tp.from_dense(torch.from_numpy(operand("general")[:40]), tmesh(), NB)
    with pytest.raises(ValueError, match="square"):
        ckpt.he2hb_ckpt(wide, every=EVERY)
    with pytest.raises(ValueError, match="m >= n"):
        ckpt.geqrf_ckpt(tp.from_dense(torch.from_numpy(operand("general")[:, :40].T.copy()),
                                      tmesh(), NB), every=EVERY)
    # Option.NumMonitor is ported: the monitored chain gives the plain bits
    gd = tdist("geqrf")
    assert_bitwise(ckpt.geqrf_ckpt(gd, every=EVERY),
                   ckpt.geqrf_ckpt(gd, every=EVERY, num_monitor="on"), "monitored geqrf")


def test_drivers_route_checkpoint(monkeypatch):
    """geqrf_mesh / gels_mesh and heev_mesh's stage 1 with
    Option.Checkpoint run geqrf_ckpt / he2hb_ckpt: the plain bits."""
    calls = []
    for name in ("geqrf_ckpt", "he2hb_ckpt"):
        real = getattr(ckpt, name)

        def spy(*args, _real=real, _name=name, **kwargs):
            calls.append((_name, kwargs["every"]))
            return _real(*args, **kwargs)

        monkeypatch.setattr(ckpt, name, spy)
    a = torch.from_numpy(operand("general"))
    b = torch.from_numpy(np.random.default_rng(6).standard_normal((N, 2)))
    x0 = tp.gels_mesh(a, b, tmesh(), NB)
    x1 = tp.gels_mesh(a, b, tmesh(), NB, opts={Option.Checkpoint: 3})
    assert torch.equal(x0[0], x1[0]) and torch.equal(x0[1], x1[1])
    h = torch.from_numpy(operand("spd"))
    w0, z0 = tp.heev_mesh(h, tmesh(), NB)
    w1, z1 = tp.heev_mesh(h, tmesh(), NB, opts={Option.Checkpoint: 2})
    assert torch.equal(w0, w1) and torch.equal(z0, z1)
    assert calls == [("geqrf_ckpt", 3), ("he2hb_ckpt", 2)]


# ---------------------------------------------------------------------------
# against slate_tpu
# ---------------------------------------------------------------------------


def _factor_parts(op, out):
    """(dense factor, auxiliary stacks) of a DistQR / DistTwoStage of either
    package, as numpy."""
    if op == "geqrf":
        dense = out.fact
        aux = (out.tloc, out.treev, out.treet)
    else:
        dense = out.band
        aux = (out.vq, out.tq)
    to_np = (lambda x: tp.to_dense(x).numpy()) if isinstance(dense, tp.DistMatrix) else (
        lambda x: np.asarray(jto_dense(x)))
    return to_np(dense), [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in aux]


@pytest.mark.parametrize("op", OPS)
def test_multi_ckpt_parity_with_slate_tpu(op):
    assert HE_STEPS == j_panel_count(N, NB)
    a = operand(CASE_KIND[op])
    scale = float(np.abs(a).max()) * np.sqrt(N)
    with xla_panels():
        jd, td = jdist(op), tdist(op)
        jout = JCKPT[op](jd, every=EVERY, num_monitor="off")
        tout = CHAIN[op](td, every=EVERY)
        (jf, jaux), (tf, taux) = _factor_parts(op, jout), _factor_parts(op, tout)
        assert within_class(tf, jf, scale) <= 1
        for t, j in zip(taux, jaux):
            assert t.shape == j.shape and within_class(t, j, max(float(np.abs(j).max()), 1.0)) <= 1
        jk = jkill(op, lambda: JCKPT[op](jd, every=EVERY, num_monitor="off"), 4)
        tk = kill(op, lambda: CHAIN[op](td, every=EVERY), 4)
        assert meta(tk) == meta(jk) and set(tk.arrays) == set(jk.arrays)
        assert within_class(tk.tiles, np.asarray(jk.tiles), scale) <= 1


def test_geqrf_snapshot_files_resume_in_the_other_package(tmp_path):
    a = operand("general")
    scale = float(np.abs(a).max()) * np.sqrt(N)
    with xla_panels():
        jd, td = jdist("geqrf"), tdist("geqrf")
        jref = jckpt.geqrf_ckpt(jd, every=EVERY, num_monitor="off")
        tref = ckpt.geqrf_ckpt(td, every=EVERY)
        jk = jkill("geqrf", lambda: jckpt.geqrf_ckpt(jd, every=EVERY, num_monitor="off"), 4)
        tk = kill("geqrf", lambda: ckpt.geqrf_ckpt(td, every=EVERY), 4)
        from_j = ckpt.Checkpoint.load(jk.save(str(tmp_path / "from_slate_tpu.npz")))
        from_t = jckpt.Checkpoint.load(tk.save(str(tmp_path / "from_port.npz")))
        got_t = _factor_parts("geqrf", elastic.resume(from_j, tmesh()))
        got_j = _factor_parts("geqrf", jelastic.resume(from_t, jmesh()))
        want_j, want_t = _factor_parts("geqrf", jref), _factor_parts("geqrf", tref)
        assert within_class(got_t[0], want_j[0], scale) <= 1
        assert within_class(got_j[0], want_t[0], scale) <= 1
        for g, w in zip(got_t[1] + got_j[1], want_j[1] + want_t[1]):
            assert within_class(g, w, max(float(np.abs(w).max()), 1.0)) <= 1
