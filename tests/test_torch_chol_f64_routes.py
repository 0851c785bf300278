"""The f64 potrf_array routes of the port (linalg.chol: ``_potrf_f64_form``
-> ``obs.memmodel.potrf_f64_form``, ``_potrf_ll_ozaki``,
``potrf_left_looking_staged``) against slate_tpu's.

- ``_potrf_ll_ozaki`` (the persistent Ozaki digit cache over
  ``ops.ozaki.split_rows`` / ``matmul_planes``) against slate_tpu's at
  n = 80, nb = 32 (three panels, the last padded), within 100 n eps64
  max|L| (measured 4e-16 at n = 96);
- ``potrf_array``'s route at n = 4096 in both packages under a forced
  Ozaki gate (each package's ``_tpu_is_default`` monkeypatched: on the
  card the port's answers False) and budgets set by SLATE_TPU_HBM_BYTES:
  the same form, decision for decision.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu.linalg import chol as jchol
from slate_tpu_torch.linalg import chol as tchol
from slate_tpu_torch.obs import memmodel

jmatmul = importlib.import_module("slate_tpu.ops.matmul")
tmatmul = importlib.import_module("slate_tpu_torch.ops.matmul")

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(memmodel.HBM_ENV, raising=False)
    jax.config.update("jax_enable_x64", True)


@pytest.mark.parametrize("n,nb", [(80, 32)])
def test_ozaki_form_matches_jax(n, nb):
    rng = np.random.default_rng(n)
    a = rng.standard_normal((n, n))
    a = a @ a.T / n + np.eye(n)
    want = np.asarray(jchol._potrf_ll_ozaki(jnp.asarray(a), nb=nb))
    got = tchol._potrf_ll_ozaki(torch.from_numpy(a), nb=nb).numpy()
    lim = 100 * n * np.finfo(np.float64).eps * np.abs(want).max()
    assert np.abs(got - want).max() <= lim
    np.testing.assert_array_equal(got, np.tril(got))


def test_potrf_array_route_under_the_forced_gate(monkeypatch):
    """potrf_array f64 at n = 4096 takes slate_tpu's route in both packages,
    each with its Ozaki gate forced on (or left off) and the budget set by
    SLATE_TPU_HBM_BYTES: ozaki with room for the digit cache, staged
    without it, fused with the gate off and room for slate_tpu's fused
    program.  The forms are stubbed (the route is the point, not the
    factor); the port's staged and fused are one loop, so its decision is
    read from _potrf_f64_form."""
    n = 4096
    a = np.eye(n) * 2.0
    jseen, tseen = [], []
    for name in ("_potrf_ll_ozaki", "potrf_left_looking_staged", "_potrf_left_looking"):
        monkeypatch.setattr(jchol, name, lambda x, *ar, _n=name, **k: (jseen.append(_n), x)[1])
    monkeypatch.setattr(tchol, "_potrf_ll_ozaki", lambda x, **k: (tseen.append("ozaki"), x)[1])
    monkeypatch.setattr(tchol, "potrf_left_looking_staged", lambda x, **k: x)
    form = tchol._potrf_f64_form
    monkeypatch.setattr(tchol, "_potrf_f64_form",
                        lambda *ar, **k: (tseen.append(form(*ar, **k)), tseen[-1])[1])
    jname = {"_potrf_ll_ozaki": "ozaki", "potrf_left_looking_staged": "staged",
             "_potrf_left_looking": "fused"}
    for gate, budget, want in ((True, 2 * 10 ** 9, "ozaki"), (True, 5 * 10 ** 8, "staged"),
                               (False, 2 * 10 ** 9, "fused"), (False, 5 * 10 ** 8, "staged")):
        monkeypatch.setattr(jmatmul, "_tpu_is_default", lambda g=gate: g)
        monkeypatch.setattr(tmatmul, "_tpu_is_default", lambda g=gate: g)
        monkeypatch.setenv(memmodel.HBM_ENV, str(budget))
        jseen.clear()
        tseen.clear()
        jchol.potrf_array(jnp.asarray(a))
        tchol.potrf_array(torch.from_numpy(a))
        assert [jname[x] for x in jseen] == [want], (gate, budget, jseen)
        assert tseen[0] == want and (tseen[1:] == ["ozaki"]) == (want == "ozaki"), tseen
