"""Shared queues, operands and comparisons of the service-layer tests
(tests/test_torch_serve_{queue,controller,service}.py).

Both packages get a meshless Router (bins (16,), a 1 GiB budget, a fresh
executable cache) under a ``BatchQueue`` on its own ``ManualClock``, and the
same numpy operands.  Ticket numbers are process-wide in each package, so a
dispatch log is compared with each seq replaced by its rank among the
pair's submits: key strings, causes and the tenants in ticket order.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_serve_common import counter_deltas  # noqa: F401 (re-exported)

from slate_tpu import obs as jobs
from slate_tpu.serve import trace as jtrace
from slate_tpu.serve.cache import ExecutableCache as JCache
from slate_tpu.serve.queue import BatchQueue as JBatchQueue
from slate_tpu.serve.queue import ManualClock as JManualClock
from slate_tpu.serve.router import Router as JRouter
from slate_tpu.types import SlateError as JSlateError
from slate_tpu_torch import obs
from slate_tpu_torch.serve.cache import ExecutableCache
from slate_tpu_torch.serve.queue import BatchQueue, ManualClock
from slate_tpu_torch.serve.router import Router
from slate_tpu_torch.types import SlateError

N = 16
BIN = 16
EPS = float(np.finfo(np.float64).eps)


def spd_np(rng, n=N):
    g = rng.standard_normal((n, n))
    return g @ g.T / n + 2 * np.eye(n)


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float64))


def j(x):
    return jnp.asarray(np.array(x, dtype=np.float64))


@pytest.fixture
def live_obs():
    """Both packages' tracers on, with empty finished-trace streams (the
    queue opens a RequestTrace per submit)."""
    jobs.reset()
    jtrace.reset()
    obs.reset()
    with jobs.force_enabled(), obs.force_enabled():
        yield
    jtrace.reset()
    jobs.reset()
    obs.reset()


def routers(budget=1 << 30):
    return (JRouter(bins=(BIN,), hbm_budget=budget, cache=JCache()),
            Router(bins=(BIN,), hbm_budget=budget, cache=ExecutableCache(), device="cpu"))


class Pair:
    """One queue per package, same parameters, each on a ManualClock."""

    def __init__(self, name, **kw):
        max_batch = kw.pop("max_batch", 4)
        window_s = kw.pop("window_s", 0.005)
        jr, tr_ = routers()
        self.jclk, self.tclk = JManualClock(), ManualClock()
        self.jq = JBatchQueue(jr, max_batch=max_batch, window_s=window_s, clock=self.jclk,
                              name=name, **kw)
        self.tq = BatchQueue(tr_, max_batch=max_batch, window_s=window_s, clock=self.tclk,
                             name=name, **kw)
        self.jtk, self.ttk, self.requests = [], [], []

    def submit(self, op, a, b, tenant=None):
        """The same request to both queues: (slate_tpu's ticket, the port's)."""
        jk = self.jq.submit(op, j(a), j(b), tenant=tenant)
        tk = self.tq.submit(op, t(a), t(b), tenant=tenant)
        self.jtk.append(jk)
        self.ttk.append(tk)
        self.requests.append((op, a, b, tenant))
        return jk, tk

    def submit_raises(self, op, a, b, tenant=None, match=None):
        with pytest.raises(JSlateError, match=match):
            self.jq.submit(op, j(a), j(b), tenant=tenant)
        with pytest.raises(SlateError, match=match):
            self.tq.submit(op, t(a), t(b), tenant=tenant)

    def advance(self, dt):
        self.jclk.advance(dt)
        self.tclk.advance(dt)

    def pump(self):
        return self.jq.pump(), self.tq.pump()

    def set(self, **kw):
        for q in (self.jq, self.tq):
            for k, v in kw.items():
                setattr(q, k, v)

    def logs(self):
        """Both dispatch logs with seqs ranked among the pair's submits."""
        jrank = {tk.seq: i for i, tk in enumerate(self.jtk)}
        trank = {tk.seq: i for i, tk in enumerate(self.ttk)}

        def norm(log, rank):
            return [(e["key"], e["cause"], [(rank[s], tn) for s, tn in e["tickets"]],
                     e["pending_at_close"]) for e in log]

        return norm(self.jq.dispatch_log, jrank), norm(self.tq.dispatch_log, trank)

    def assert_same_logs(self):
        jl, tl = self.logs()
        assert tl == jl

    def close(self):
        self.jq.close()
        self.tq.close()


@contextlib.contextmanager
def pair(name, **kw):
    p = Pair(name, **kw)
    try:
        yield p
    finally:
        p.close()


def assert_answers(p):
    """Each served answer: within f64 tolerance of slate_tpu's (posv on
    g g^T / n + 2 I: cond < 10, so 1e-12 relative) and bitwise the port's
    own one-at-a-time Router.solve on a fresh router."""
    ref = Router(bins=(BIN,), hbm_budget=1 << 30, cache=ExecutableCache(), device="cpu")
    for jk, tk, (op, a, b, tenant) in zip(p.jtk, p.ttk, p.requests):
        xj, xt = np.asarray(jk.result()), tk.result()
        np.testing.assert_allclose(xt.numpy(), xj, rtol=1e-12, atol=1e-12)
        assert torch.equal(xt, ref.solve(op, t(a), t(b), tenant=tenant))


def outcomes(stream):
    return [tr.outcome for tr in stream.finished_traces()]
