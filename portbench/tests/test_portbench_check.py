"""The check's own controls, on the CPU at a small size (the chip readings
at the cells' own sizes, which set the limits, are in PERF.md):
- every fault a cell can have, planted underneath the timed path, turns
  `correct` false: a step that leaves its state unchanged, half of the
  batch left out with the mean over the rest, an answer altered where it is
  produced (one chunk of a frame);
- the control, the reference computed one precision below the
  configuration's in the program's place (float8 for the field's bf16
  products; TF32 and float8 attention for the extractors), fails a number
  that the program passes;
- the preprocessing cell's faults: block 8's keys for block 9's, a DPT hook
  read one block early, a fusion stage's skip left out."""

import json
import math
from pathlib import Path

import pytest
import torch

from tiny import CELLS, PREPROCESS, overrides, run_cell

from portbench import check, run

LIMITS = Path(__file__).resolve().parents[1] / "limits"
FAULTS = [("bg_train_blend", "unchanged"), ("bg_train_blend", "half_batch"), ("bg_tto", "unchanged"),
          ("bg_tto", "half_batch"), ("idhi_render", "altered"), ("bg_render", "altered"),
          (PREPROCESS, "keys_of_block_before"), (PREPROCESS, "hook_one_block_early"), (PREPROCESS, "skip_left_out")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_planted_fault_is_not_correct(cell, fault):
    rc, res = run_cell(cell, fault=fault)
    assert rc == 0
    assert res["correct"] is False, res["check"]


@pytest.mark.parametrize("cell", CELLS + (PREPROCESS,))
def test_the_control_fails_a_number_the_program_passes(cell):
    spec = run.load_cell(cell)
    cfg = spec["cfg"]
    for k, v in overrides(cell).items():
        cfg[k] = {**cfg[k], **v}
    traffic = spec["traffic"]
    Driver = run.load_module(run.BENCH / "drivers" / f"{traffic['driver']}.py").Driver
    drv = Driver(cfg, traffic, 977, torch.device("cpu"))
    window = traffic.get("check_frames", traffic.get("check_images"))
    if window:
        drv.run(0.0, max_units=window)
    prog = drv.prog
    drv.release()
    ref = drv.reference("float32")
    got, ctl = check.readings(prog, ref), check.readings(drv.reference(getattr(Driver, "control", "fp8")), ref)
    limits = json.loads((LIMITS / f"{cell}.json").read_text())
    assert all(math.isfinite(v) for v in got.values())
    assert any(got[k] <= lim < ctl[k] for k, lim in limits.items()), (got, ctl, limits)
