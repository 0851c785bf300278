"""The port's mixed-precision mesh ladder (slate_tpu_torch.parallel.
dist_refine) against slate_tpu.parallel.dist_refine: the resolve chains,
routing, the general solve, and the port's own invariants.

Shapes are ``tests/test_mixed_mesh.py``'s: n = 96, nb = 16, two right-hand
sides, the 2 x 4 mesh (slate_tpu on the 8 forced CPU devices, the port on a
virtual mesh).  PanelImpl is pinned ``xla`` and NumMonitor ``off`` on the
slate_tpu side (ROADMAP §3: the CPU's ``auto`` differs between the
packages), PanelImpl ``xla`` on the port's.

- ``auto`` routes an f64 gesv_mesh through the f32 factor, meets the
  refinement gate ||r|| <= ||x|| ||A|| eps sqrt(n), with ``iters`` equal to
  slate_tpu's, and is bitwise the port's own gesv_mixed_mesh;
- ``off`` and f32 run the direct path: the same twin calls (the
  CPU form of the kernel launches) and the same bits as ``_gesv_mesh_plain``;
- lower-only SPD storage, a failed factor (NaN x, iters -1), lookahead and
  broadcast-lowering invariance (bitwise), the panel lowerings, the
  prefactor memo (an in-place write misses, and so does one made past the
  version counter), UseFallbackSolver off, and
  ``mixed_smoke.run_smoke(device="cpu")``.
"""

import numpy as np
import pytest
import torch

from conftest import cpu_devices

import jax.numpy as jnp
from slate_tpu.parallel import drivers as jdrv
from slate_tpu.parallel import make_mesh as jmake_mesh
from slate_tpu.parallel.dist_refine import resolve_residual_impl as jresolve_residual_impl
from slate_tpu.types import Option as JOption
from slate_tpu_torch import parallel as tp
from slate_tpu_torch.linalg.refine import ir_counter_values
from slate_tpu_torch.ops import kernels as tk
from slate_tpu_torch.parallel import comm as tcomm
from slate_tpu_torch.parallel import dist_refine as trefine
from slate_tpu_torch.parallel import drivers as tdrv
from slate_tpu_torch.parallel import mixed_smoke
from slate_tpu_torch.types import Option
from slate_tpu_torch.utils.testing import refine_gate_ok as _gate

# the suite runs in several worker processes that share the cores: one
# intra-op thread each (torch defaults to one a core, which oversubscribes them)
torch.set_num_threads(1)

N, NB, NRHS = 96, 16, 2
J_OPTS = {JOption.PanelImpl: "xla", JOption.NumMonitor: "off"}
T_OPTS = {Option.PanelImpl: "xla"}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for env in (tk.PANEL_IMPL_ENV, tk.UPDATE_IMPL_ENV, tcomm.BCAST_IMPL_ENV, trefine.MIXED_ENV,
                trefine.RESIDUAL_ENV, "SLATE_TPU_NUM"):
        monkeypatch.delenv(env, raising=False)
    trefine.clear_prefactor_cache()
    yield
    trefine.clear_prefactor_cache()


def _t(x):
    return torch.from_numpy(np.array(x))


def _tmesh():
    return tp.make_mesh(2, 4, device="cpu")


def _well(rng):
    return rng.standard_normal((N, N)) + N * np.eye(N)


def _spd(rng):
    g = rng.standard_normal((N, N))
    return g @ g.T / N + 2 * np.eye(N)


def _cond(rng, c):
    q1, _ = np.linalg.qr(rng.standard_normal((N, N)))
    q2, _ = np.linalg.qr(rng.standard_normal((N, N)))
    return q1 @ np.diag(np.logspace(0, -np.log10(c), N)) @ q2


def _twin_calls(monkeypatch):
    """Count every plain twin the kernel wrappers run on a CPU tensor (the
    CPU form of the kernel launches)."""
    calls = {}
    for name in dir(tk):
        fn = getattr(tk, name)
        if name.endswith("_plain") and callable(fn):
            def wrap(*args, _fn=fn, _name=name, **kw):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*args, **kw)
            monkeypatch.setattr(tk, name, wrap)
    return calls


def test_resolve_chains(monkeypatch):
    assert trefine.resolve_mixed(None) == "auto"
    assert trefine.resolve_mixed({Option.MixedPrecision: "off"}) == "off"
    with trefine.use_mixed("ir"):
        assert trefine.resolve_mixed(None) == "ir"
        assert trefine.resolve_mixed({Option.MixedPrecision: "gmres"}) == "gmres"
    with pytest.raises(ValueError):
        trefine.resolve_mixed({Option.MixedPrecision: "sometimes"})
    # ResidualImpl: auto is ozaki only on a TPU, so f64 in the port and in
    # slate_tpu on the CPU
    assert trefine.resolve_residual_impl(None) == "f64" == jresolve_residual_impl(None)
    assert trefine.RESIDUAL_IMPLS == ("f64", "ozaki", "auto")
    assert trefine.resolve_residual_impl({Option.ResidualImpl: "ozaki"}) == "ozaki"
    monkeypatch.setenv(trefine.RESIDUAL_ENV, "ozaki")
    assert trefine.resolve_residual_impl(None) == "ozaki"
    with pytest.raises(ValueError, match="residual impl"):
        trefine.resolve_residual_impl({Option.ResidualImpl: "int4"})


@pytest.mark.parametrize("kind", ["gesv", "posv"])
def test_off_is_the_direct_path(kind, rng, monkeypatch):
    a = _well(rng) if kind == "gesv" else _spd(rng)
    b = rng.standard_normal((N, NRHS))
    drv = tp.gesv_mesh if kind == "gesv" else tp.posv_mesh
    plain = tdrv._gesv_mesh_plain if kind == "gesv" else tdrv._posv_mesh_plain
    off = {Option.MixedPrecision: "off"}
    calls = _twin_calls(monkeypatch)
    ir0 = ir_counter_values()
    x_off, i_off = drv(_t(a), _t(b), _tmesh(), NB, opts=off)
    routed = dict(calls)
    calls.clear()
    x_pl, i_pl = plain(_t(a), _t(b), _tmesh(), NB, opts=off)
    assert routed == calls and routed  # launch for launch
    assert torch.equal(x_off, x_pl) and int(i_off) == int(i_pl) == 0
    assert ir_counter_values() == ir0


def test_non_f64_never_routes(rng):
    ir0 = ir_counter_values()
    a, b = _spd(rng), rng.standard_normal((N, NRHS))
    x, info = tp.posv_mesh(_t(a).float(), _t(b).float(), _tmesh(), NB)
    xp, _ = tdrv._posv_mesh_plain(_t(a).float(), _t(b).float(), _tmesh(), NB)
    assert torch.equal(x, xp) and int(info) == 0
    assert ir_counter_values() == ir0


def test_auto_gesv_matches_the_reference(rng):
    a, b = _well(rng), rng.standard_normal((N, NRHS))
    jm = jmake_mesh(2, 4, devices=cpu_devices(8))
    xj, itj, infoj = jdrv.gesv_mixed_mesh(jnp.asarray(a), jnp.asarray(b), jm, NB, opts=J_OPTS)
    solves0 = ir_counter_values()["solves"]
    x, info = tp.gesv_mesh(_t(a), _t(b), _tmesh(), NB, opts=T_OPTS)  # auto: the ladder
    assert int(info) == 0 and _gate(a, x.numpy(), b)
    assert ir_counter_values()["solves"] == solves0 + 1
    x2, it, info2 = tp.gesv_mixed_mesh(_t(a), _t(b), _tmesh(), NB, opts=T_OPTS)
    assert torch.equal(x, x2) and it.dtype == torch.int32
    assert int(info2) == int(infoj) == 0 and int(it) == int(itj) >= 0
    assert _gate(a, np.asarray(xj), b)
    assert np.abs(x.numpy() - np.asarray(xj)).max() <= 1e-12 * np.abs(np.asarray(xj)).max()


@pytest.mark.parametrize("cond,max_iters", [(1e2, 4), (1e8, 30)])
def test_mixed_accuracy_at_gate(cond, max_iters, rng):
    a, b = _cond(rng, cond), rng.standard_normal((N, 3))
    x, iters, info = tp.gesv_mixed_mesh(_t(a), _t(b), _tmesh(), NB)
    assert int(info) == 0 and 0 <= int(iters) <= max_iters
    assert _gate(a, x.numpy(), b)
    xf, _ = tdrv._gesv_mesh_plain(_t(a), _t(b), _tmesh(), NB)
    assert _gate(a, xf.numpy(), b)


def test_posv_lower_only_storage_routes_correctly(rng):
    full, b = _spd(rng), rng.standard_normal((N, NRHS))
    x, info = tp.posv_mesh(_t(np.tril(full)), _t(b), _tmesh(), NB)
    assert int(info) == 0 and _gate(full, x.numpy(), b)
    xf, _ = tp.posv_mesh(_t(full), _t(b), _tmesh(), NB)
    assert torch.equal(x, xf)


def test_posv_mixed_failed_factor_is_nan(rng):
    b = rng.standard_normal((N, NRHS))
    x, iters, info = tp.posv_mixed_mesh(_t(-np.eye(N)), _t(b), _tmesh(), NB)
    assert int(info) != 0 and int(iters) == -1
    assert torch.isnan(x).all()


def test_opts_threading_is_bitwise_invariant(rng):
    a, b = _spd(rng), rng.standard_normal((N, NRHS))
    outs = []
    for la in (0, 2):
        for bi in ("psum", "ring", "doubling"):
            x, iters, info = tp.posv_mixed_mesh(_t(a), _t(b), _tmesh(), NB,
                                                opts={Option.Lookahead: la, Option.BcastImpl: bi})
            assert int(info) == 0 and int(iters) >= 0
            outs.append(x)
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_panel_lowerings_meet_the_gate(impl, rng):
    a, b = _spd(rng), rng.standard_normal((N, NRHS))
    x, iters, info = tp.posv_mixed_mesh(_t(a), _t(b), _tmesh(), NB, opts={Option.PanelImpl: impl})
    assert int(info) == 0 and int(iters) >= 0 and _gate(a, x.numpy(), b)


def test_prefactor_memo_misses_after_an_in_place_write(rng, monkeypatch):
    factors = []
    real = trefine._factor_f32
    monkeypatch.setattr(trefine, "_factor_f32", lambda *a, **k: factors.append(1) or real(*a, **k))
    a, b = _t(_well(rng)), _t(rng.standard_normal((N, NRHS)))
    mesh = _tmesh()
    x1, _ = tp.gesv_mesh(a, b, mesh, NB)
    x2, _ = tp.gesv_mesh(a, b, mesh, NB)  # the same operator: one factor
    assert len(factors) == 1 and torch.equal(x1, x2)
    a[0, 0] += 1.0  # in place: the version counter moves
    x3, _ = tp.gesv_mesh(a, b, mesh, NB)
    assert len(factors) == 2 and not torch.equal(x1, x3)
    assert _gate(a.numpy(), x3.numpy(), b.numpy())
    tp.gesv_mesh(a.numpy(), b, mesh, NB)  # numpy operands are never memoized
    tp.gesv_mesh(a.numpy(), b, mesh, NB)
    assert len(factors) == 4
    monkeypatch.setenv(trefine._PREFACTOR_MAX_BYTES_ENV, "0")  # 0 disables
    tp.gesv_mesh(a, b, mesh, NB)
    assert len(factors) == 5


def test_prefactor_memo_misses_after_a_write_past_the_version_counter(rng, monkeypatch):
    """Writes through ``.data`` and through a numpy alias leave the version
    counter (the memo key) as it was; the hit's bitwise check of A's
    distributed form misses all the same, and x solves the new system."""
    factors = []
    real = trefine._factor_f32
    monkeypatch.setattr(trefine, "_factor_f32", lambda *a, **k: factors.append(1) or real(*a, **k))
    arr = _well(rng)
    a, b = torch.from_numpy(arr), _t(rng.standard_normal((N, NRHS)))
    mesh = _tmesh()
    x1, _ = tp.gesv_mesh(a, b, mesh, NB)
    version = a._version
    for write in (lambda: a.data[1, 1].add_(1.0), lambda: arr.__setitem__((2, 3), arr[2, 3] - 1.0)):
        write()
        assert a._version == version  # the key is unchanged
        n0 = len(factors)
        x2, _ = tp.gesv_mesh(a, b, mesh, NB)
        assert len(factors) == n0 + 1 and not torch.equal(x1, x2)
        assert _gate(arr, x2.numpy(), b.numpy())
        x3, _ = tp.gesv_mesh(a, b, mesh, NB)  # and the new factor is a hit again
        assert len(factors) == n0 + 1 and torch.equal(x2, x3)
        x1 = x2
    # posv reads the lower triangle: a write above it keeps the hit
    s_arr = _spd(rng)
    s = torch.from_numpy(s_arr)
    y1, _ = tp.posv_mesh(s, b, mesh, NB)
    n0 = len(factors)
    s_arr[0, N - 1] += 1.0
    y2, _ = tp.posv_mesh(s, b, mesh, NB)
    assert len(factors) == n0 and torch.equal(y1, y2)
    s_arr[N - 1, 0] += 1.0
    tp.posv_mesh(s, b, mesh, NB)
    assert len(factors) == n0 + 1


def test_fallback_opt_out_and_num_monitor(rng):
    a, b = _cond(rng, 1e12), rng.standard_normal((N, 1))
    ir0 = ir_counter_values()
    x, info = tp.gesv_mesh(_t(a), _t(b), _tmesh(), NB,
                           opts={Option.MixedPrecision: "ir", Option.UseFallbackSolver: False,
                                 Option.MaxIterations: 2})
    ir1 = ir_counter_values()
    assert ir1["fallback"] == ir0["fallback"] and ir1["solves"] == ir0["solves"] + 1
    assert ir1["converged"] == ir0["converged"]  # IR did not converge; its x comes back
    assert x.shape == (N, 1) and int(info) == 0
    # Option.NumMonitor is ported: a healthy SPD solve takes the health
    # tier, stays on IR (no GMRES route) and returns the unmonitored bits
    from slate_tpu_torch.obs import numerics as tnum

    spd = _t(_spd(rng))
    x_off, _ = tp.posv_mesh(spd, _t(b), _tmesh(), NB)
    routed = tnum.num_counter_values()["routed_gmres"]
    x_on, info_on = tp.posv_mesh(spd, _t(b), _tmesh(), NB, opts={Option.NumMonitor: "on"})
    assert torch.equal(x_on, x_off) and int(info_on) == 0
    assert tnum.num_counter_values()["routed_gmres"] == routed
    assert {"margin", "diag_min", "diag_max"} <= set(tnum.last_gauges("potrf"))
    with pytest.raises(TypeError, match="float64"):
        tp.posv_mixed_mesh(_t(_spd(rng)).float(), _t(b), _tmesh(), NB)


def test_mixed_smoke_on_the_cpu():
    res = mixed_smoke.run_smoke(device="cpu")
    assert res["ok"], res["failures"]
    assert res["ir"]["solves"] >= 3 and res["ir"]["gmres_solves"] >= 1
    assert mixed_smoke.main(["--device", "cpu", "--n", "48", "--nb", "8"]) == 0
