"""upnerf_torch.utils.profiling against upnerf.utils.profiling: `summarize`
over the same metrics.jsonl (a Trainer's, written by the port's
MetricLogger, with non-numeric values and the step / time keys left out)
equal to JAX's; `StepTimer` calls its readout once a block, records seconds
per step and gives the same mean / p50 as JAX's over the same records; `trace`
writes a Chrome trace and a kernel table on the CPU."""

import json
import os
import time

import pytest
import torch

from upnerf.utils import profiling as jprofiling
from upnerf_torch.utils import profiling
from upnerf_torch.utils.logging import MetricLogger


def test_summarize_matches_jax(tmp_path):
    log = MetricLogger(str(tmp_path))
    for step in range(1, 8):
        log.log(step, {"loss": 1.0 / step, "psnr": 10.0 + step, "lr": 5e-4 * 0.9**step})
        if step % 3 == 0:
            log.log(step, {"val/psnr": 20.0 + step})
    log.close()
    with open(tmp_path / "metrics.jsonl", "a") as f:
        f.write(json.dumps({"step": 8, "time": 0.0, "note": "text", "flag": True}) + "\n")
    path = str(tmp_path / "metrics.jsonl")
    got, want = profiling.summarize(path), jprofiling.summarize(path)
    assert got == want
    assert set(got) == {"loss", "psnr", "lr", "val/psnr", "flag"} and got["loss"]["n"] == 7
    assert got["val/psnr"]["last"] == 26.0


def test_step_timer_matches_jax():
    calls = []
    t = profiling.StepTimer(readout=lambda: calls.append(1))
    j = jprofiling.StepTimer(readout=lambda: None)
    for n in (4, 2, 1):
        with t.measure(n_steps=n):
            time.sleep(0.004 * n)
    assert calls == [1, 1, 1] and len(t.records) == 3
    assert all(0.003 < r < 0.5 for r in t.records)
    j.records = list(t.records)
    assert (t.mean, t.p50) == (j.mean, j.p50)
    empty = profiling.StepTimer(readout=lambda: None)
    assert empty.mean != empty.mean and empty.p50 != empty.p50  # nan, as JAX's


def test_step_timer_on_the_card_needs_cuda():
    timer = profiling.StepTimer(readout=lambda: None, device=torch.device("cpu"))
    assert not timer.cuda
    if not torch.cuda.is_available():
        timer = profiling.StepTimer(readout=lambda: None, device="cuda")
        with pytest.raises(Exception):
            with timer.measure():
                pass


def test_trace_writes_chrome_trace_and_table(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "prof")):
        (x @ x).sum().item()
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    assert "aten::mm" in (tmp_path / "prof" / "table.txt").read_text()
