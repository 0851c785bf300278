"""The port's checkpointed Cholesky chain (slate_tpu_torch.ft.ckpt), its
snapshots, kills and counters, against itself and against slate_tpu.

Within the port, bitwise: the chain against ``potrf_dist`` at lookahead
0, 1 and 2; kill -> resume on the same mesh; a disk round trip; async
snapshots against sync ones; the in-segment kill's lost steps; a snapshot
never aliasing the live carry (the port's loops write the carry in
place); the injector deterministic and one-shot; counter deltas through
``ft.policy.ft_counter_values``; Option.Checkpoint off calling the plain
driver; the mesh drivers' routing.  Against ``slate_tpu`` on the same
numpy operand (tests/test_ckpt.py's shapes): the factor within
100 n eps max|A|, info and the snapshot metadata bitwise.
"""

import gc

import jax
import numpy as np
import pytest
import torch

from torch_ckpt_common import (  # noqa: F401 (no_ckpt_env: an autouse fixture)
    EVERY,
    N,
    NB,
    NT,
    assert_bitwise,
    ckpt,
    elastic,
    inject,
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
from slate_tpu_torch.types import Option, SlateError

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def potrf_runs():
    """The plain factor and the chain's, on the shared SPD operand."""
    d = tdist("potrf")
    return d, tp.potrf_dist(d), ckpt.potrf_ckpt(d, every=EVERY)


# ---------------------------------------------------------------------------
# within the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("la", [0, 1, 2])
def test_chain_bitwise_plain_at_every_lookahead(potrf_runs, la):
    d, _, got = potrf_runs
    assert_bitwise(tp.potrf_dist(d, lookahead=la), got, f"lookahead {la}")


@pytest.mark.parametrize("every", [1, 2, 5, NT, NT + 3])
def test_chain_bitwise_at_every_interval(potrf_runs, every):
    d, ref, _ = potrf_runs
    before = ft_counter_values()
    assert_bitwise(ref, ckpt.potrf_ckpt(d, every=every), f"every {every}")
    snaps = ft_counter_values()["ckpt_snapshots"] - before["ckpt_snapshots"]
    assert snaps == (NT - 1) // every


def test_input_untouched_by_chain_kill_and_resume(potrf_runs):
    d, ref, _ = potrf_runs
    before = d.tiles.clone()
    ck = kill("potrf", lambda: ckpt.potrf_ckpt(d, every=EVERY), 4)
    elastic.resume(ck, tmesh())
    assert torch.equal(d.tiles, before)


def test_kill_resume_bitwise_same_mesh(potrf_runs):
    d, ref, _ = potrf_runs
    ck = kill("potrf", lambda: ckpt.potrf_ckpt(d, every=EVERY), 4)
    assert ck is not None and (ck.op, ck.step, ck.every, ck.grid) == ("potrf", 3, EVERY, (2, 4))
    assert (ck.m, ck.n, ck.nb, ck.num_monitor, ck.rowperm, ck.arrays) == (N, N, NB, False, None, {})
    assert ck.tiles.shape == (NT, NT, NB, NB) and ck.tiles.dtype == np.float64
    held = ck.tiles.copy()
    assert_bitwise(ref, elastic.resume(ck, tmesh()), "resume")
    # the resumed loop writes a copy: the snapshot is unchanged and resumes
    # again, bitwise
    np.testing.assert_array_equal(ck.tiles, held)
    assert_bitwise(ref, elastic.resume(ck, tmesh()), "second resume")


def test_kill_at_the_boundary_and_before_the_first_snapshot(potrf_runs):
    d, ref, _ = potrf_runs
    ck = kill("potrf", lambda: ckpt.potrf_ckpt(d, every=EVERY), EVERY)
    assert ck.step == EVERY
    assert_bitwise(ref, elastic.resume(ck, tmesh()), "boundary kill")
    assert kill("potrf", lambda: ckpt.potrf_ckpt(d, every=EVERY), 1) is None
    assert not elastic.resumable(None)
    with pytest.raises(SlateError, match="missing"):
        elastic.resume(None, tmesh())


def test_persistent_kill_re_kills_the_resume(potrf_runs):
    d, ref, _ = potrf_runs
    plan = inject.FaultPlan([inject.KillFault("potrf", 4, persist=True)])
    with inject.fault_scope(plan):
        with pytest.raises(ckpt.Preempted) as ei:
            ckpt.potrf_ckpt(d, every=EVERY)
        with pytest.raises(ckpt.Preempted) as ei2:
            elastic.resume(ei.value.checkpoint, tmesh())
    assert ei2.value.checkpoint is ei.value.checkpoint  # no new boundary before step 4
    assert_bitwise(ref, elastic.resume(ei.value.checkpoint, tmesh()), "after the plan")


def test_disk_roundtrip(potrf_runs, tmp_path):
    d, ref, _ = potrf_runs
    ck = kill("potrf", lambda: ckpt.potrf_ckpt(d, every=EVERY), 4)
    ck2 = ckpt.Checkpoint.load(ck.save(str(tmp_path / "ck.npz")))
    assert meta(ck2) == meta(ck)
    assert (ck2.bcast_impl, ck2.panel_impl, ck2.growth_abort, ck2.async_snapshots) == (
        ck.bcast_impl, ck.panel_impl, ck.growth_abort, ck.async_snapshots)
    np.testing.assert_array_equal(ck.tiles, ck2.tiles)
    assert_bitwise(ref, elastic.resume(ck2, tmesh()), "disk resume")


def test_in_segment_kill_loses_steps_since_snapshot(potrf_runs):
    d, ref, _ = potrf_runs
    before = ft_counter_values()
    ck = kill("potrf", lambda: ckpt.potrf_ckpt(d, every=EVERY), 5, in_segment=True)
    after = ft_counter_values()
    assert ck is not None and ck.step == 3
    assert after["ckpt_lost_steps"] - before["ckpt_lost_steps"] == 5 - 3
    assert after["ckpt_inseg_kills"] - before["ckpt_inseg_kills"] == 1
    # the partial segment ran on the live carry: the snapshot is a copy,
    # equal to the one a boundary kill at the same step leaves
    ck_b = kill("potrf", lambda: ckpt.potrf_ckpt(d, every=EVERY), 5)
    np.testing.assert_array_equal(ck.tiles, ck_b.tiles)
    assert_bitwise(ref, elastic.resume(ck, tmesh()), "in-segment resume")


def test_async_snapshots_bitwise(potrf_runs):
    d, ref, _ = potrf_runs
    before = ft_counter_values()
    assert_bitwise(ref, ckpt.potrf_ckpt(d, every=EVERY, async_snapshots=True), "async chain")
    after = ft_counter_values()
    assert after["ckpt_async_snapshots"] - before["ckpt_async_snapshots"] == 2
    assert after["ckpt_snapshots"] - before["ckpt_snapshots"] == 2  # fenced and counted
    assert after["ckpt_async_overlap_s"] >= before["ckpt_async_overlap_s"]
    ck_a = kill("potrf", lambda: ckpt.potrf_ckpt(d, every=EVERY, async_snapshots=True), 4)
    ck_s = kill("potrf", lambda: ckpt.potrf_ckpt(d, every=EVERY), 4)
    assert ck_a.step == ck_s.step == 3 and ck_a.async_snapshots and not ck_s.async_snapshots
    np.testing.assert_array_equal(ck_a.tiles, ck_s.tiles)
    # the async preference rides the snapshot into the resume
    before = ft_counter_values()
    assert_bitwise(ref, elastic.resume(ck_a, tmesh()), "async resume")
    assert ft_counter_values()["ckpt_async_snapshots"] - before["ckpt_async_snapshots"] == 1


@pytest.mark.parametrize("op", ["potrf", "getrf_pp", "geqrf", "he2hb"])
def test_snapshot_never_aliases_the_carry(op):
    """A snapshot is a host copy: writing the carry after it leaves it
    unchanged (``.cpu()`` / ``.numpy()`` of a CPU tensor would alias)."""
    d = tdist(op)
    st = ckpt._carry_init(op, d)
    ck = ckpt._snapshot(op, d, st, 3, EVERY, "auto", "auto")
    pend = ckpt._PendingSnapshot(op, d, st, 3, EVERY, "auto", "auto", False, True)
    held = [ck.tiles.copy()] + [v.copy() for v in ck.arrays.values()]
    for v in st.values():
        if isinstance(v, torch.Tensor):
            v.add_(1.0)
        else:
            v[:] = v[::-1].copy()  # the pp row permutation
    ck_a = pend.wait()
    for snap in (ck, ck_a):
        got = [snap.tiles] + list(snap.arrays.values())
        for x, want in zip(got, held):
            np.testing.assert_array_equal(x, want)
        if op == "getrf_pp":
            np.testing.assert_array_equal(snap.rowperm, np.arange(NT * NB))
    assert ck.nbytes == ck_a.nbytes


def test_snapshot_tiles_are_logical(potrf_runs):
    """The device permutation into logical order agrees with the host
    form ``_cyclic_to_logical`` (and ``_logical_to_cyclic`` inverts it)."""
    d, _, _ = potrf_runs
    ck = ckpt._snapshot("potrf", d, {"tiles": d.tiles}, 0, EVERY, "auto", "auto")
    np.testing.assert_array_equal(ck.tiles, ckpt._cyclic_to_logical(d.tiles.numpy(), 2, 4))
    np.testing.assert_array_equal(ckpt._logical_to_cyclic(ck.tiles, 2, 4), d.tiles.numpy())


def test_kill_injector_deterministic_and_one_shot():
    from slate_tpu.ft import inject as jinject

    k1, k2 = inject.seeded_kill(5, "potrf", NT), inject.seeded_kill(5, "potrf", NT)
    assert (k1.op, k1.k) == (k2.op, k2.k) and 1 <= k1.k < NT
    # a seed draws slate_tpu's kill step
    for seed in range(20):
        for op, steps in (("potrf", NT), ("he2hb", 7), ("getrf_pp", 64)):
            assert inject.seeded_kill(seed, op, steps).k == jinject.seeded_kill(seed, op, steps).k
    plan = inject.FaultPlan([inject.KillFault("potrf", 4)])
    with inject.fault_scope(plan):
        (kf,) = inject.armed_kills("potrf")
        plan.consume_fault(kf)
        assert inject.armed_kills("potrf") == []
    persist = inject.FaultPlan([inject.KillFault("potrf", 4, persist=True)])
    with inject.fault_scope(persist):
        (kf,) = inject.armed_kills("potrf")
        persist.consume_fault(kf)
        assert len(inject.armed_kills("potrf")) == 1
    with inject.fault_scope(plan):
        ints, _ = inject.spec_arrays("potrf")
        assert not ints[:, 0].any()  # kills never enter a kernel spec


def test_ckpt_counters(potrf_runs):
    d, _, _ = potrf_runs
    before = ft_counter_values()
    ck = kill("potrf", lambda: ckpt.potrf_ckpt(d, every=EVERY), 4)
    elastic.resume(ck, tmesh())
    after = ft_counter_values()
    delta = {k: after[k] - before[k] for k in after}
    assert delta["ckpt_kills"] == 1 and delta["ckpt_lost_steps"] == 1
    assert delta["ckpt_resumes"] == 1 and delta["ckpt_reshards"] == 0
    # one snapshot before the kill, one at step 6 of the resume
    assert delta["ckpt_snapshots"] == 2
    assert delta["ckpt_snapshot_bytes"] == 2 * ck.nbytes == 2 * NT * NT * NB * NB * 8
    assert delta["ckpt_resume_runtime_s"] > 0
    assert delta["detected"] == delta["corrected"] == 0


def test_resolve_checkpoint_chain(monkeypatch):
    assert ckpt.resolve_checkpoint(None) is None
    for off in (0, False, "0", "off"):
        assert ckpt.resolve_checkpoint(off) is None
    assert ckpt.resolve_checkpoint(4) == 4 and ckpt.resolve_checkpoint("2") == 2
    with pytest.raises(ValueError, match="positive"):
        ckpt.resolve_checkpoint(-1)
    monkeypatch.setenv(ckpt.CKPT_ENV, "5")
    assert ckpt.resolve_checkpoint(None) == 5 and ckpt.resolve_checkpoint(2) == 2
    monkeypatch.setenv(ckpt.CKPT_ENV, "off")
    assert ckpt.resolve_checkpoint(None) is None
    assert not ckpt.resolve_ckpt_async(None)
    monkeypatch.setenv(ckpt.CKPT_ASYNC_ENV, "on")
    assert ckpt.resolve_ckpt_async(None) and not ckpt.resolve_ckpt_async(False)


def test_checkpoint_off_calls_the_plain_driver(potrf_runs, monkeypatch):
    d, ref, _ = potrf_runs

    def no_chain(*args, **kwargs):
        raise AssertionError("the segment chain ran with Checkpoint off")

    monkeypatch.setattr(ckpt, "_run", no_chain)
    for off in (None, 0, "off"):
        assert_bitwise(ref, ckpt.potrf_ckpt(d, every=off), f"off={off!r}")
    a = torch.from_numpy(operand("spd"))
    l0, info0 = tp.potrf_mesh(a, tmesh(), NB)
    l1, info1 = tp.potrf_mesh(a, tmesh(), NB, opts={Option.Checkpoint: "off"})
    assert torch.equal(l0.tiles, l1.tiles) and int(info0) == int(info1)


def test_drivers_route_checkpoint(potrf_runs, monkeypatch):
    """potrf_mesh / posv_mesh with Option.Checkpoint run potrf_ckpt (the
    plain bits); FaultTolerance with it raises."""
    calls = []
    real = ckpt.potrf_ckpt

    def spy(*args, **kwargs):
        calls.append(kwargs["every"])
        return real(*args, **kwargs)

    monkeypatch.setattr(ckpt, "potrf_ckpt", spy)
    a = torch.from_numpy(operand("spd"))
    b = torch.from_numpy(np.random.default_rng(3).standard_normal((N, 2)))
    l0, _ = tp.potrf_mesh(a, tmesh(), NB)
    l1, info = tp.potrf_mesh(a, tmesh(), NB, opts={Option.Checkpoint: 3})
    assert torch.equal(l0.tiles, l1.tiles) and int(info) == 0 and calls == [3]
    x0, _ = tp.posv_mesh(a, b, tmesh(), NB)
    monkeypatch.setenv(ckpt.CKPT_ENV, "2")
    x1, _ = tp.posv_mesh(a, b, tmesh(), NB)
    assert torch.equal(x0, x1) and calls == [3, 2]
    with pytest.raises(ValueError, match="cannot be combined"):
        tp.posv_mesh(a, b, tmesh(), NB, opts={Option.FaultTolerance: "detect"})


def test_unported_modes_raise(potrf_runs):
    """Option.NumMonitor is ported: the monitored chain gives the plain
    bits and records the monitored driver's gauges, and a monitored
    snapshot resumes monitored, its gauges continued to the unbroken
    chain's (tests/test_torch_ckpt_num.py holds the gauges in full); a
    bf16 carry still raises."""
    from slate_tpu_torch.obs import numerics as tnum

    d, ref, _ = potrf_runs
    tp.potrf_dist(d, num_monitor="on")
    want = tnum.last_gauges("potrf")
    assert_bitwise(ref, ckpt.potrf_ckpt(d, every=EVERY, num_monitor="on"), "monitored chain")
    assert tnum.last_gauges("potrf") == want
    ck = kill("potrf", lambda: ckpt.potrf_ckpt(d, every=EVERY, num_monitor="on"), 4)
    assert ck.num_monitor and set(ck.gauges) == {"g"}
    tnum.clear_last("potrf")
    assert_bitwise(ref, elastic.resume(ck, tmesh()), "monitored resume")
    assert tnum.last_gauges("potrf") == want
    half = tp.DistMatrix(tiles=d.tiles.to(torch.bfloat16), m=N, n=N, nb=NB, mesh=d.mesh,
                         diag_pad=True)
    with pytest.raises(ValueError, match="bfloat16"):
        ckpt.potrf_ckpt(half, every=EVERY)
    with pytest.raises(ValueError, match="identity-padded"):
        ckpt.potrf_ckpt(tp.from_dense(torch.from_numpy(operand("spd")[:60, :60]), tmesh(), NB),
                        every=EVERY)


# ---------------------------------------------------------------------------
# against slate_tpu
# ---------------------------------------------------------------------------


def test_potrf_ckpt_parity_with_slate_tpu():
    from slate_tpu.ft import ckpt as jckpt

    a = operand("spd")
    scale = float(np.abs(a).max())
    with xla_panels():
        jd, td = jdist("potrf"), tdist("potrf")
        jl, jinfo = jckpt.potrf_ckpt(jd, every=EVERY, num_monitor="off")
        tl, tinfo = ckpt.potrf_ckpt(td, every=EVERY)
        assert within_class(tp.to_dense(tl).numpy(), np.asarray(jto_dense(jl)), scale) <= 1
        assert int(tinfo) == int(jinfo) == 0
        jk = jkill("potrf", lambda: jckpt.potrf_ckpt(jd, every=EVERY, num_monitor="off"), 4)
        tk = kill("potrf", lambda: ckpt.potrf_ckpt(td, every=EVERY), 4)
        assert meta(tk) == meta(jk)
        assert within_class(tk.tiles, np.asarray(jk.tiles), scale) <= 1
        jr, tr = jelastic.resume(jk, jmesh()), elastic.resume(tk, tmesh())
        assert within_class(tp.to_dense(tr[0]).numpy(), np.asarray(jto_dense(jr[0])), scale) <= 1
        assert int(tr[1]) == int(jr[1]) == 0


def test_potrf_ckpt_info_parity_on_a_non_spd_matrix():
    """A negative pivot at global index 44 (step 5, after the step-3
    snapshot): the diagonal tile's factor breaks down and both chains
    report info 41, the tile's first row + 1; so does the resume."""
    from slate_tpu.ft import ckpt as jckpt

    a = operand("spd")
    a[44, 44] = -1.0
    with xla_panels():
        jd, td = jdist("potrf", a=a), tdist("potrf", a=a)
        jinfo = int(jckpt.potrf_ckpt(jd, every=EVERY, num_monitor="off")[1])
        tinfo = int(ckpt.potrf_ckpt(td, every=EVERY)[1])
        assert jinfo == 41 and tinfo == jinfo
        tk = kill("potrf", lambda: ckpt.potrf_ckpt(td, every=EVERY), 4)
        assert int(elastic.resume(tk, tmesh())[1]) == jinfo
