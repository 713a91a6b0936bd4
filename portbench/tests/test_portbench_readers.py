"""The trace reader and the per-layer readers on a trace made by hand:
busy and idle time (a span with the host's ops, and one of the device
alone), attribution of device time to the host op around a
launch, idle gaps named by the op that launched the work ending them, and
readers that leave a metric out where they find nothing to read."""

import importlib.util
from pathlib import Path

import pytest

from tiny import ROOT  # noqa: F401

from portbench import trace, work

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def op(name, ts, dur, ext):
    return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur, "args": {"External id": ext}}


def launch(ts, corr, ext):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 5,
            "args": {"correlation": corr, "External id": ext}}


def kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "args": {"correlation": corr}}


EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": trace.SPAN, "ts": 0.0, "dur": 1000.0},
    op("RenderTrainRays", 100, 200, 1), launch(150, 11, 1), kernel("void wg_kernel<384>(WgParams)", 200, 100, 11),
    op("RenderTrainRaysBackward", 400, 200, 2), launch(450, 12, 2), kernel("walk_kernel", 500, 200, 12),
    op("aten::mul", 700, 10, 3), launch(705, 13, 3), kernel("elementwise_kernel", 800, 50, 13),
    kernel("outside_the_span", 2000, 50, 14),
]


def test_read_events():
    rec = trace.read_events(EVENTS)
    assert rec["window_s"] == pytest.approx(1e-3)
    assert rec["busy_s"] == pytest.approx(350e-6)
    assert rec["ops"] == pytest.approx({"RenderTrainRays": 100e-6, "RenderTrainRaysBackward": 200e-6})
    assert rec["n_kernels"] == 3
    assert rec["gaps"] == pytest.approx({"RenderTrainRays": 200e-6, "RenderTrainRaysBackward": 200e-6,
                                         "aten::mul": 100e-6, "end of span (synchronise)": 150e-6})
    b = trace.breakdown(rec)
    assert b["device_ops"][0] == ["walk_kernel", pytest.approx(200e-6)]
    assert len(b["idle_gaps"]) == 4


def sync(ts, dur):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize", "ts": ts, "dur": dur, "args": {}}


def test_read_device_span():
    """A device-only span runs from the end of its first synchronise to the
    end of its last; busy time is clipped to it. Without the synchronises,
    from the first record to the last."""
    events = [sync(0, 10), launch(20, 1, 0), kernel("a", 30, 40, 1), launch(40, 2, 0), kernel("b", 60, 20, 2),
              sync(45, 155), kernel("before", -50, 65, 3)]
    rec = trace.read_device_span(events)
    assert rec["window_s"] == pytest.approx(190e-6)
    assert rec["busy_s"] == pytest.approx(50e-6 + 5e-6)
    rec = trace.read_device_span(events[1:5])
    assert rec["window_s"] == pytest.approx(60e-6)
    assert rec["busy_s"] == pytest.approx(50e-6)


def load(name):
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def record(dims, passes, span_units=1, **trace_over):
    rec = trace.read_events(EVENTS)
    rec.update(trace_over)
    return {"dims": dims, "passes": passes, "span": {"units": span_units}, "trace": rec,
            "window": {"units": 10, "seconds": 1.0, "unit_flops": 1e12, "frame_s": [0.01 * i for i in range(1, 41)]}}


DIMS = {"D": 8, "W": 256, "skips": [4], "xyz_L": 10, "dir_L": 4, "feat_dim": 384, "appearance_dim": 48,
        "candidate_dim": 16, "transient_dim": 128, "N_samples": 128, "N_importance": 128}


def test_readers():
    rec = record(DIMS, [("fwd", 1, 2048, 128), ("bwd", 1, 2048, 128)])
    assert load("device_idle_share.train")(rec) == pytest.approx(100.0 * (1.0 - 350e-6 / 0.1))
    rec["trace"]["busy_s"] = 0.035  # 35 ms busy in a unit that took the window 100 ms
    assert load("device_idle_share.train")(rec) == pytest.approx(65.0)
    assert load("train_mfu")(rec) == pytest.approx(100.0 * 10 * 1e12 / 1.0 / work.PEAK_FLOPS_BF16)
    least = work.pass_least_seconds(DIMS, work.mode_of_phase(1), 2048, 128, "fwd")
    assert load("fwd_roofline.train")(rec) == pytest.approx(100.0 * least / 100e-6)
    assert load("fwd_roofline.render")(rec) == pytest.approx(100.0 * least / 100e-6)  # wg_kernel by name
    assert load("launches_per_step.train")(rec) == 3
    assert load("frame_ms_p95")(rec) == pytest.approx(380.0)


def test_readers_leave_out_what_they_cannot_read():
    rec = record(DIMS, [("fwd", 2, 4096, 256)], ops={"RenderTrainRays": 0.0, "RenderTrainRaysBackward": 0.0},
                 kernels={}, busy_s=0.0)
    for name in ("fwd_roofline.train", "bwd_roofline.train", "bwd_roofline.tto", "fwd_roofline.render",
                 "device_idle_share.tto"):
        assert load(name)(rec) is None
    rec["window"]["frame_s"] = [0.01] * 19
    assert load("frame_ms_p95")(rec) is None
