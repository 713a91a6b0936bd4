"""portbench/stages.py on a trace made by hand and at a small size on the
CPU: kernels, device time, idle gaps and synchronising calls put down to
the innermost program span open at their launch (the backward's launches
from another thread too), a stage named more than once in a unit summed,
idle time outside the spans and after the last work kept apart, each
synchronising call named by the innermost host op on its thread; the cell's
numbers from a span log, None where a span is missing; each cell's run with
the program's spans."""

import contextlib
import io
import json

import pytest
import torch

from tiny import CELLS, TINY  # also puts the repo on the path

from portbench import stages, trace


def rng(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def launch(ts, corr, tid=1, name="cudaLaunchKernel", dur=5):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": {"correlation": corr}}


def kernel(ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": f"k{corr}", "ts": ts, "dur": dur, "args": {"correlation": corr}}


EVENTS = [
    rng(trace.SPAN, 0, 2000),
    rng("train.step", 10, 900), rng("train.batch", 10, 50), rng("train.opt", 60, 30), rng("train.forward", 100, 300),
    rng("train.backward", 400, 200), rng("train.opt", 600, 300),
    rng("Optimizer.step#Adam.step", 610, 200),  # not the program's: the launch under it stays train.opt's
    launch(30, 1), kernel(60, 20, 1, cat="gpu_memset"),  # train.batch
    launch(70, 2), kernel(90, 10, 2),  # train.opt (zero_grad)
    launch(150, 3), kernel(200, 100, 3),  # train.forward
    launch(450, 4, tid=2), kernel(450, 150, 4),  # the backward's thread, inside train.backward
    launch(650, 5), kernel(700, 50, 5),  # train.opt (the optimizers' steps)
    {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 840, "dur": 60, "tid": 1},
    {"ph": "X", "cat": "cpu_op", "name": "aten::_local_scalar_dense", "ts": 845, "dur": 50, "tid": 1},
    {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 845, "dur": 50, "tid": 2},  # another thread's
    launch(850, 0, name="cudaStreamSynchronize", dur=40),  # a sync under train.opt
    launch(950, 6), kernel(1000, 100, 6),  # after the root: no program span
    kernel(3000, 10, 7),  # after the traced span
]


def test_attribute():
    got = stages.attribute(EVENTS)
    assert got["units"] == 1
    assert got["idle_s"] == pytest.approx((60 + 10 + 100 + 150 + 100 + 250 + 900) * 1e-6)
    s = got["spans"]
    assert set(s) == {"train.opt", "train.batch", "train.forward", "train.backward", stages.NO_SPAN, stages.END}
    want = {  # kernels, device_s, idle_s, syncs, sync_s
        "train.opt": (2, 60e-6, 110e-6, 1, 40e-6), "train.batch": (0, 20e-6, 60e-6, 0, 0.0),
        "train.forward": (1, 100e-6, 100e-6, 0, 0.0), "train.backward": (1, 150e-6, 150e-6, 0, 0.0),
        stages.NO_SPAN: (1, 100e-6, 250e-6, 0, 0.0), stages.END: (0, 0.0, 900e-6, 0, 0.0)}
    for name, (k, dev, idle, n, sync) in want.items():
        assert (s[name]["kernels"], s[name]["syncs"]) == (k, n), name
        assert (s[name]["device_s"], s[name]["idle_s"], s[name]["sync_s"]) == pytest.approx((dev, idle, sync)), name
    assert s["train.opt"]["sync_ops"] == {"aten::_local_scalar_dense": 1}
    assert stages.stage_idle_share("train", got) == pytest.approx(100.0 * 420 / 1570)
    with pytest.raises(RuntimeError):
        stages.attribute(EVENTS[1:])


def test_stage_metrics():
    host = {"units": 4, "seconds": 0.2,
            "spans": {"train.step": {"count": 4, "s": 0.18}, "train.batch": {"count": 4, "s": 0.02},
                      "train.forward": {"count": 4, "s": 0.06}, "train.backward": {"count": 4, "s": 0.04},
                      "train.opt": {"count": 8, "s": 0.05}}}
    traced = {"units": 2, "idle_s": 0.0, "spans": {"train.opt": {"kernels": 700}}}
    got = stages.stage_metrics("train", host, traced)
    assert got == pytest.approx({"host_ms_per_step.train": 45.0, "host_ms_batch.train": 5.0,
                                 "host_ms_forward.train": 15.0, "host_ms_backward.train": 10.0,
                                 "host_ms_opt.train": 12.5, "launches_opt.train": 350.0})
    assert all(v is None for v in stages.stage_metrics("train", None, None).values())
    assert stages.stage_metrics("tto", host, traced) == {"host_ms_per_step.tto": None}
    frame = {"units": 2, "spans": {"serve.frame": {"count": 2, "s": 0.2}, "serve.to_host": {"count": 2, "s": 0.05}}}
    assert stages.stage_metrics("render", frame, None) == pytest.approx(
        {"host_ms_issue.render": 75.0, "host_ms_to_host.render": 25.0})
    del frame["spans"]["serve.to_host"]
    assert stages.stage_metrics("render", frame, None) == {"host_ms_issue.render": None,
                                                           "host_ms_to_host.render": None}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_cpu(cell):
    over = {k: dict(v) for k, v in TINY.items()}
    over["hparams"]["tpu.matmul_precision"] = "float32"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = stages.main(["--workload", cell, "--seed", "3000000019", "--seconds", "0.3"], device=torch.device("cpu"),
                         cfg_overrides=over)
    assert rc == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    host = res["host_span"]
    root = stages.ROOTS[{"bg_train_blend": "train", "bg_tto": "tto", "idhi_render": "render",
                         "bg_render": "render"}[cell]]
    assert 3 * res["traced_span"]["units"] == host["units"] > 0 and root in host["stages_ms_per_unit"]
    assert len(host["runs_ms_per_unit"]["on"]) == len(host["runs_ms_per_unit"]["off"]) == 3
    for name, v in res["metrics"].items():
        assert (v is None) == (name == "launches_opt.train"), name  # no kernels on the CPU
