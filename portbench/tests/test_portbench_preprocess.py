"""The preprocessing cell on the CPU at a small size, and what it added to the
shared files:
- the reference's pieces against the program's: PIL's resamplers (the uint8
  resizes bit for bit, at the cell's own 1024 x 680 -> 448 and 384 too),
  the positional embedding's cubic resize, the transposed and strided convs;
- the run end to end: the images a second, the kept images read back from
  the files the timed path wrote, nothing left behind;
- the new readers on a trace made by hand, and the work counts by hand and
  against PERF.md's 0.236 ms bound of a 6 x 12,322 x 64 attention call;
- the readings of the steps and frames cells and their rate, as they were
  before the feature readings and the count key were added."""

import importlib.util
import json
import math
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tiny import PREPROCESS, run_cell

from portbench import check, run, trace, work
from portbench.reference import vit as ref_vit

BENCH = Path(__file__).resolve().parents[1]
DIMS = json.loads((BENCH / "configs" / "dino_vits8_dpt_large.json").read_text())["dims"]


@pytest.mark.parametrize("src_hw,dst_hw,mode", [((680, 1024), (448, 448), "bilinear"),
                                                 ((680, 1024), (384, 384), "bicubic"),
                                                 ((40, 48), (64, 64), "bicubic"), ((37, 23), (16, 50), "bilinear")])
def test_uint8_resize_is_the_programs(src_hw, dst_hw, mode):
    from upnerf_torch.features.images import resize_u8

    img = np.random.default_rng(5).integers(0, 256, src_hw + (3,), dtype=np.uint8)
    np.testing.assert_array_equal(ref_vit.resize_u8(img, *dst_hw, mode), resize_u8(img, dst_hw, mode))


def test_float_resize_and_pos_embed_are_the_programs():
    from upnerf_torch.features.images import resize_float
    from upnerf_torch.features.vit import interpolate_pos_embed

    x = torch.from_numpy(np.random.default_rng(6).standard_normal((24, 24)).astype(np.float32))
    assert torch.equal(ref_vit.resize_f32(x, 34, 51), resize_float(x, (34, 51)))
    for g0, g in ((28, 111), (24, 24), (24, 4)):
        pe = torch.from_numpy(np.random.default_rng(g).standard_normal((1, 1 + g0 * g0, 8)).astype(np.float32))
        a = torch.as_tensor(ref_vit._pos_matrix(g0, g), dtype=torch.float32)
        want = torch.einsum("ij,jkd,lk->ild", a, pe[0, 1:].reshape(g0, g0, 8), a).reshape(g * g, 8)
        # PyTorch's antialiased resize computes its weights in float32, these in float64
        torch.testing.assert_close(interpolate_pos_embed(pe, (g, g), g0)[0, 1:], want, rtol=0, atol=2e-5)


def test_convs_are_torchs():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(6, 9, 7, generator=g)
    for k, stride, pad in ((3, 1, None), (3, 2, 1), (1, 1, None)):
        p = {"w": torch.randn(5, 6, k, k, generator=g), "b": torch.randn(5, generator=g)}
        want = F.conv2d(x[None], p["w"], p["b"], stride=stride, padding=k // 2 if pad is None else pad)[0]
        torch.testing.assert_close(ref_vit.conv(x, p, "float32", stride, pad), want, rtol=1e-5, atol=1e-5)
    for s in (2, 4):
        p = {"w": torch.randn(6, 5, s, s, generator=g), "b": torch.randn(5, generator=g)}
        want = F.conv_transpose2d(x[None], p["w"], p["b"], stride=s)[0]
        torch.testing.assert_close(ref_vit.conv_transpose(x, p, "float32"), want, rtol=1e-5, atol=1e-5)


def test_the_run_counts_images_and_leaves_nothing_behind(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    rc, res = run_cell(PREPROCESS, seconds=0.3)
    assert rc == 0 and res["correct"] is True, res["check"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"preprocess_images_per_s", "peak_gib", "setup_s"}
    assert res["metrics"]["preprocess_images_per_s"]["unit"] == "images/s"
    assert set(res["check"]) == {"key_rel_rms", "depth_rel_rms", "pca_mean_gap", "pca_comp_gap"}
    assert os.listdir(tmp_path) == []


def test_the_window_keeps_its_sample_and_reads_it_back():
    from tiny import overrides

    spec = run.load_cell(PREPROCESS)
    cfg = spec["cfg"]
    for k, v in overrides(PREPROCESS).items():
        cfg[k] = {**cfg[k], **v}
    drv = run.load_module(BENCH / "drivers" / "preprocess.py").Driver(cfg, spec["traffic"], 31, torch.device("cpu"))
    win = drv.run(0.0, max_units=7)
    assert win["units"] == win["images"] == 7 and win["unit_flops"] == work.preprocess_image_flops(cfg["dims"])
    assert os.listdir(os.path.join(drv.out, "kept")) == []
    left = [f for _, _, fs in os.walk(drv.out) for f in fs]
    assert left == []  # every file written is read back or removed
    kept = drv.prog["features"]
    assert len(kept) == spec["traffic"]["check_images"]
    assert kept[0]["keys"].shape == (15, 15, 64) and kept[0]["depth"].shape == (40, 48)
    assert kept[0]["components"].shape == (3, 64) and kept[0]["mean"].shape == (64,)
    drv.run(0.0, max_units=3)  # a later run (a traced span) leaves the window's sample as it was
    assert all(np.array_equal(a["keys"], b["keys"]) for a, b in zip(kept, drv.prog["features"]))
    drv.release()
    assert not os.path.exists(drv.tmp)


def test_feature_readings_by_hand():
    keys = np.ones((2, 2, 4), np.float32)
    comps = np.eye(3, 4)
    ref = {"keys": keys, "mean": np.array([1.0, 0, 0, 0]), "components": comps, "depth": np.full((2, 3), 2.0),
           "sv": np.array([4.0, 3.0, 2.9, 1.0])}
    prog = {"keys": keys * 1.01, "mean": np.array([1.0, 0.02, 0, 0]), "components": -comps + 0.1 * np.eye(3, 4, 1),
            "depth": np.full((2, 3), 2.0) + np.array([0.0, 0.0, 0.6])}
    got = check.readings({"features": [prog]}, {"features": [ref]})
    assert got["key_rel_rms"] == pytest.approx(0.01)
    assert got["depth_rel_rms"] == pytest.approx(math.sqrt(2 * 0.36 / (6 * 4.0)))
    assert got["pca_mean_gap"] == pytest.approx(0.02)
    # each component 0.1 away, weighted by its singular value's gap to the nearer neighbour: 1/4, 0.1/3, 0.1/2.9
    assert got["pca_comp_gap"] == pytest.approx(0.1 * 0.25)
    assert check.readings({"features": []}, {"features": []})["key_rel_rms"] == math.inf


def test_steps_and_frames_read_as_before():
    frames = check.readings({"frames": [{"rgb": np.full((2, 2, 3), 0.5), "depth": np.array([1.0, 2, 3, 4])}]},
                            {"frames": [{"rgb": np.full((2, 2, 3), 0.5) + np.eye(1, 12, 5).reshape(2, 2, 3) * 0.12,
                                         "depth": np.array([1.0, 2, 3, 5])}]})
    assert frames == pytest.approx({"rgb_rmse": math.sqrt(0.12 ** 2 / 12), "depth_rel_rms": math.sqrt(1 / 39)})
    steps = check.readings(
        {"loss": [1.0, 2.0], "grad": {"a": 3.0, "b": 1.0, "c": 2.0}, "change": {"a": 1.0, "b": 0.5, "c": 0.1},
         "grad_rows": {"fine_a": [[1.0, 0.0], [0.0, 1.0]]}},
        {"loss": [1.0, 2.5], "grad": {"a": 2.0, "b": 1.0, "c": 2.0}, "change": {"a": 1.0, "b": 1.0, "c": 0.2},
         "grad_rows": {"fine_a": [[1.0, 0.0], [0.0, 2.0]]}})
    assert steps == pytest.approx({"loss_gap": 0.2, "grad_gap": 0.5, "change_gap": 0.5, "change_gap.median": 0.1,
                                   "grad_err.fine_a": 1 / math.sqrt(5)})
    for name in ("train_blend", "tto_groups", "render_all_views", "render_test"):
        traffic = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
        assert run.rate({"rays": 300, "units": 3, "seconds": 2.0}, traffic) == 150.0
    assert run.rate({"images": 6, "seconds": 2.0}, json.loads((BENCH / "traffic" / "preprocess_scene.json")
                                                                .read_text())) == 3.0


def test_attention_bound_of_the_kernel_table():
    """PERF.md's row 3: 233 GFLOP a 6 x 12,322 x 64 call, 0.236 ms at the
    bf16 peak (bound by operations; its bytes 0.023 ms)."""
    assert work.attention_flops(6, 12322, 64) == 4 * 6 * 12322 ** 2 * 64
    assert round(work.attention_least_seconds(6, 12322, 64) * 1e3, 3) == 0.236
    assert work.attention_bytes(6, 12322, 64) / work.PEAK_BYTES < 0.000023


def test_extractor_counts_by_hand():
    d, p = DIMS["dino"], DIMS["dpt"]
    n = 111 * 111 + 1
    block = 4 * n * n * 384 + 2 * n * (384 * 1152 + 384 * 384 + 2 * 384 * 1536)
    assert work.vit_block_flops(n, 384, 4) == block
    assert work.dino_image_flops(d) == 2 * 12321 * 192 * 384 + 9 * block + 2 * n * 384 * 1152
    vit_l = 2 * 576 * 768 * 1024 + 24 * work.vit_block_flops(577, 1024, 4)
    readouts = 4 * 2 * 576 * 2048 * 1024
    reassemble = 2 * 576 * 1024 * (256 + 512 + 1024 + 1024) + 2 * 576 * (256 * 256 * 16 + 512 * 512 * 4) + \
        2 * 144 * 1024 * 1024 * 9
    layer_rn = 2 * 9 * 256 * (96 ** 2 * 256 + 48 ** 2 * 512 + 24 ** 2 * 1024 + 12 ** 2 * 1024)
    conv3 = 2 * 9 * 256 * 256
    fusion = conv3 * (2 * 12 ** 2 + 4 * 24 ** 2 + 4 * 48 ** 2 + 4 * 96 ** 2) + \
        2 * 256 * 256 * (24 ** 2 + 48 ** 2 + 96 ** 2 + 192 ** 2)
    head = 2 * 192 ** 2 * 9 * 256 * 128 + 2 * 384 ** 2 * 9 * 128 * 32 + 2 * 384 ** 2 * 32
    assert work.dpt_image_flops(p) == vit_l + readouts + reassemble + layer_rn + fusion + head
    assert 2.4e12 < work.dino_image_flops(d) < 2.6e12 and 4e11 < work.dpt_image_flops(p) < 6e11


def _load(name):
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "args": {"correlation": ts}}


def test_preprocess_readers_on_a_trace_made_by_hand():
    events = [{"ph": "X", "cat": "user_annotation", "name": trace.SPAN, "ts": 0.0, "dur": 10000.0},
              _kernel("(anonymous namespace)::round_kernel(float const*, float const*)", 100, 50),
              _kernel("(anonymous namespace)::ws_kernel(CUtensorMap, CUtensorMap, CUtensorMap, float*, int)", 200,
                      450),
              _kernel("void at::native::vectorized_elementwise_kernel<4, at::native::round_kernel_cuda>", 700, 300),
              _kernel("sm90_xmma_gemm_f32f32", 1000, 2000)]
    rec = {"dims": DIMS, "attn_calls": [(6, 12322, 64)], "span": {"units": 1}, "trace": trace.read_events(events),
           "window": {"units": 4, "seconds": 2.0, "unit_flops": 3e12}}
    rec["trace"]["busy_s"] = 0.05
    assert _load("attn_roofline.preprocess")(rec) == pytest.approx(
        100.0 * work.attention_least_seconds(6, 12322, 64) / 500e-6)
    assert _load("preprocess_mfu")(rec) == pytest.approx(100.0 * 4 * 3e12 / 2.0 / work.PEAK_FLOPS_BF16)
    assert _load("device_idle_share.preprocess")(rec) == pytest.approx(90.0)
    rec["trace"]["kernels"] = {"sm90_xmma_gemm_f32f32": [1, 2e-3]}  # no attention kernel ran: nothing to read
    assert _load("attn_roofline.preprocess")(rec) is None
