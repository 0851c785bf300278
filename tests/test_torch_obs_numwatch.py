"""The port's numwatch (slate_tpu_torch.obs.numwatch): its four passes and
``--smoke`` on the CPU, the CLI, and the device rule.

The smoke is slate_tpu's acceptance run: the lu / potrf / mixed / qr
passes at n = 48, nb = 8 on the virtual 2 x 4 mesh under ring and psum,
schema-valid RunReports, the Wilkinson growth exactly 2^47 and past
GROWTH_THRESHOLD, the planted Cholesky margin 1e-8 within 1e-3 relative,
the distributed condition estimates within 1e-6 relative of the
single-chip ones, the cond-1e8 input routed to the GMRES tier, the
healthy solve's trajectory exported (and a Perfetto counter track of it),
the fused and checkpointed geqrf gauges equal, every non-runtime gauge
the same under both lowerings, and ``--check`` passing an unchanged
report while flagging a seeded 4x gauge.  The routing decision against
slate_tpu's: tests/test_torch_obs_numwatch_route.py.
"""

import json

import numpy as np
import pytest
import torch

from slate_tpu_torch.obs import numerics as tnum
from slate_tpu_torch.obs import numwatch, report

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for env in ("SLATE_TPU_OBS", tnum.NUM_ENV, "SLATE_TPU_PANEL_IMPL", "SLATE_TPU_UPDATE_IMPL",
                "SLATE_TPU_BCAST_IMPL"):
        monkeypatch.delenv(env, raising=False)
    tnum.reset()


def test_numwatch_smoke_on_the_cpu(tmp_path, capsys):
    assert numwatch.run_smoke(str(tmp_path), device="cpu") == []
    out = capsys.readouterr().out
    for op in numwatch.NUM_OPS:
        rep = json.loads((tmp_path / f"num_{op}.report.json").read_text())
        assert report.validate_report(rep) == [] and rep["num"] == {} and f"{op} ok" in out
    vals = json.loads((tmp_path / "num_lu.report.json").read_text())["values"]
    assert vals["num.lu_growth_wilkinson"] == 2.0 ** 47
    vals = json.loads((tmp_path / "num_mixed.report.json").read_text())["values"]
    assert vals["num.routed_gmres"] == 1 and vals["num.ir_history_len_well"] >= 1
    trace = json.loads((tmp_path / "num_mixed.trace.json").read_text())
    assert any(e["name"] == "num.ir_rnorm[gesv]" for e in trace["traceEvents"])


def test_numwatch_cli_and_device_rule(tmp_path):
    path = tmp_path / "lu.json"
    assert numwatch.main(["lu", "--n", "32", "--device", "cpu", "--out", str(path)]) == 0
    rep = json.loads(path.read_text())
    assert rep["config"]["device"] == "cpu" and rep["values"]["num.lu_growth_wilkinson"] == 2.0 ** 31
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            numwatch.run_numwatch("lu")
    with pytest.raises(ValueError, match="unknown numwatch op"):
        numwatch.run_numwatch("svd", device="cpu")
    assert np.isclose(rep["values"]["num.gecondest_match_rel"], 0.0, atol=numwatch.CONDEST_PARITY_RTOL)
