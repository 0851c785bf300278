"""The port's queue smoke against slate_tpu's: both acceptance runs write
their RunReport under ``tmp_path`` (never into artifacts/), and every
deterministic value must be equal -- the headline values (windows, DRR
split, budget accepts and rejects, memo computes, controller trips, the
bitwise and packed checks) and the ``serve`` section's counters and outcome
totals.  Only the wall-clock latency quantiles and rates of the serve
section are left out.
"""

import gc
import json

import jax
import pytest
import torch

from slate_tpu import obs as jobs
from slate_tpu.serve import queue_smoke as jqueue_smoke
from slate_tpu.serve import trace as jtrace
from slate_tpu_torch import obs
from slate_tpu_torch.serve import queue_smoke

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    yield
    jax.clear_caches()
    gc.collect()


def _deterministic(section):
    return {k: v for k, v in section.items() if "latency" not in k}


def test_queue_smoke_report_matches_jax(tmp_path, capsys):
    from torch_serve_common import clear_admission_memos

    clear_admission_memos()
    try:
        assert jqueue_smoke.run_smoke(str(tmp_path / "jax")) == 0
        assert queue_smoke.run_smoke(str(tmp_path / "torch"), device="cpu") == 0
    finally:
        jobs.disable()
        obs.disable()
        jobs.reset()
        jtrace.reset()
        obs.reset()
    out = capsys.readouterr().out
    assert "serve.queue_smoke: OK" in out
    jrep = json.loads((tmp_path / "jax" / "serve_queue.report.json").read_text())
    trep = json.loads((tmp_path / "torch" / "serve_queue.report.json").read_text())
    assert trep["values"] == jrep["values"]
    assert trep["values"]["serve.queue_stream_windows"] == 8.0
    assert trep["values"]["serve.queue_stream_bitwise_ok"] == 1.0
    assert _deterministic(trep["serve"]) == _deterministic(jrep["serve"])
    assert trep["serve"]["queue_submitted"] > 0


def test_queue_smoke_cli_defaults():
    """``--out`` defaults to the port's own artifacts/serve_torch (never
    slate_tpu's artifacts/serve), the device to the card."""
    import inspect

    assert queue_smoke.OUT_DIR == "artifacts/serve_torch"
    assert inspect.signature(queue_smoke.run_smoke).parameters["device"].default is None
