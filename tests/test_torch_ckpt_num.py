"""The port's checkpointed chains under Option.NumMonitor=on
(slate_tpu_torch.ft.ckpt / elastic), against the monitored plain drivers
and against slate_tpu.

tests/test_ckpt.py's shapes (n = 64, nb = 8, a snapshot every 3 steps) on
the shared numpy operands (tests/torch_ckpt_common.py).  Within the port,
bitwise: each monitored chain's factor against the plain driver's, its
gauges against the monitored plain driver's at every interval, a
monitored kill -> resume (same grid, reshaped grid, through disk) against
the unbroken chain.  Against slate_tpu: the no-pivot chain's GrowthAbort
at the same segment boundary with the same growth (the Wilkinson matrix:
2^24 exactly), the snapshot's gauge layout, and a slate_tpu snapshot of a
monitored chain resumed in the port, whose gauges land within the f64
class of slate_tpu's unbroken chain (100 n eps64 relative; the margin of
``spd_neardiag`` exactly).
"""

import gc

import jax
import numpy as np
import pytest
import torch

from torch_ckpt_common import (  # noqa: F401 (no_ckpt_env: an autouse fixture)
    CASES,
    EVERY,
    JCKPT,
    N,
    NT,
    assert_bitwise,
    ckpt,
    elastic,
    jdist,
    jkill,
    jmesh,
    kill,
    no_ckpt_env,
    tdist,
    tmesh,
)

from slate_tpu.ft import elastic as jelastic
from slate_tpu.obs import numerics as jnum
from slate_tpu.utils.testing import generate
from slate_tpu_torch.obs import numerics as tnum

torch.set_num_threads(1)

EPS = float(np.finfo(np.float64).eps)
OPS = ("potrf", "getrf_nopiv", "getrf_pp", "geqrf", "he2hb")


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(autouse=True)
def _fresh_gauges():
    tnum.reset()
    jnum.reset()


def _plain(op, d):
    # the partial-pivot gauge samples the stack at each step's entry, before
    # a deferred update lands (slate_tpu's sampling point), so it depends
    # on the depth: the strict chain is the depth-0 driver
    la = {"lookahead": 0} if op == "getrf_pp" else {}
    return CASES[op][2](d, num_monitor="on", **la)


def _chain(op, d, every=EVERY):
    return CASES[op][3](d, every=every, num_monitor="on")


@pytest.mark.parametrize("op", OPS)
def test_monitored_chain_is_the_monitored_driver(op):
    d = tdist(op)
    ref = _plain(op, d)
    want = tnum.last_gauges(op)
    assert want
    for every in (1, EVERY, NT):
        tnum.clear_last(op)
        assert_bitwise(ref, _chain(op, d, every), f"{op} every {every}")
        assert tnum.last_gauges(op) == want, (op, every)


@pytest.mark.parametrize("op", OPS)
def test_monitored_resume_continues_the_gauges(op):
    """Kill at step 4 (snapshot at 3), resume: the factor and the gauges
    bitwise the unbroken chain's; the snapshot holds slate_tpu's gauge
    keys (g, and amax0 for the LU forms) as 0-d arrays, and a resume
    leaves it unchanged."""
    d = tdist(op)
    ref = _chain(op, d)
    want = tnum.last_gauges(op)
    ck = kill(op, lambda: _chain(op, d), 4)
    assert ck.num_monitor and ck.step == EVERY
    keys = {"g", "amax0"} if op.startswith("getrf") else {"g"}
    assert set(ck.gauges) == keys and all(v.shape == () for v in ck.gauges.values())
    before = {k: v.copy() for k, v in ck.gauges.items()}
    tnum.clear_last(op)
    assert_bitwise(ref, elastic.resume(ck, tmesh()), f"{op} resume")
    assert tnum.last_gauges(op) == want
    assert all(np.array_equal(before[k], ck.gauges[k]) for k in keys)


@pytest.mark.parametrize("op", ["potrf", "getrf_pp"])
def test_monitored_resume_on_a_reshaped_grid_and_from_disk(op, tmp_path):
    """The gauges are max / min folds, the same on any grid: a 2 x 4
    snapshot saved to disk and resumed on 4 x 2 records the unbroken
    chain's gauges."""
    d = tdist(op)
    _chain(op, d)
    want = tnum.last_gauges(op)
    ck = kill(op, lambda: _chain(op, d), 4)
    path = ck.save(str(tmp_path / f"{op}.npz"))
    back = ckpt.Checkpoint.load(path)
    assert back.num_monitor and set(back.gauges) == set(ck.gauges)
    tnum.clear_last(op)
    elastic.resume(back, tmesh(4, 2))
    assert tnum.last_gauges(op) == want


def test_growth_abort_at_slate_tpus_boundary():
    """The Wilkinson matrix through the monitored no-pivot chain: the
    running growth at step k's panel entry is 2^(k nb), so with nb = 8 and
    a snapshot every 2 steps the gauge crosses GROWTH_THRESHOLD (2^20) at
    step 3's entry and the chain raises at the boundary of that segment,
    step 4, with growth 2^24 -- in both packages.  The snapshot before it
    carries the gate; growth_abort=False and an unmonitored chain finish."""
    w = generate("wilkinson", N)
    with pytest.raises(jnum.GrowthAbort) as jei:
        JCKPT["getrf_nopiv"](jdist("getrf_nopiv", a=w), every=2, num_monitor="on")
    with pytest.raises(tnum.GrowthAbort) as tei:
        ckpt.getrf_nopiv_ckpt(tdist("getrf_nopiv", a=w), every=2, num_monitor="on")
    assert (tei.value.op, tei.value.step, tei.value.growth) == \
        (jei.value.op, jei.value.step, jei.value.growth) == ("getrf_nopiv", 4, 2.0 ** 24)
    assert tnum.num_counter_values()["growth_aborts"] == 1
    ck = kill("getrf_nopiv", lambda: ckpt.getrf_nopiv_ckpt(tdist("getrf_nopiv", a=w), every=2,
                                                           num_monitor="on"), 3)
    assert ck.growth_abort and ck.step == 2
    with pytest.raises(tnum.GrowthAbort):
        elastic.resume(ck, tmesh())
    _, info = ckpt.getrf_nopiv_ckpt(tdist("getrf_nopiv", a=w), every=2, num_monitor="on",
                                    growth_abort=False)
    assert int(info) == 0 and tnum.last_gauges("getrf_nopiv")["growth"] == 2.0 ** (N - 1)
    ckpt.getrf_nopiv_ckpt(tdist("getrf_nopiv", a=w), every=2)


def test_jax_monitored_snapshot_resumes_in_the_port():
    """slate_tpu's monitored potrf chain, killed at step 4 on its mesh:
    its snapshot (gauges and all) resumes in the port, which records
    slate_tpu's unbroken chain's gauges (the planted margin 1e-8 exactly,
    the diagonal extrema in the f64 class)."""
    a = generate("spd_neardiag", N, seed=4, cond=1e8)
    jd = jdist("potrf", a=a)
    JCKPT["potrf"](jd, every=EVERY, num_monitor="on")
    want = jnum.last_gauges("potrf")
    jck = jkill("potrf", lambda: JCKPT["potrf"](jd, every=EVERY, num_monitor="on"), 4)
    assert jck.num_monitor and set(jck.gauges) == {"g"}
    elastic.resume(jck, tmesh())
    got = tnum.last_gauges("potrf")
    assert got["margin"] == want["margin"] == 1e-8
    for k in ("diag_min", "diag_max"):
        assert abs(got[k] - want[k]) <= 100 * N * EPS * abs(want[k]), (k, got, want)
    # and the port's snapshot resumes in slate_tpu
    tck = kill("potrf", lambda: ckpt.potrf_ckpt(tdist("potrf", a=a), every=EVERY,
                                               num_monitor="on"), 4)
    jnum.clear_last("potrf")
    jelastic.resume(tck, jmesh())
    assert jnum.last_gauges("potrf")["margin"] == 1e-8
