"""The work counts against counts by hand and against PERF.md's table of
kernels, whose bounds chip_smoke.py worked out at 4096 rays x 256 samples
in bf16: 1.70 ms the phase-1 forward with residuals, 3.41 the train
backward, 1.49 the serving forward and the frozen backward, 2.64 the F = 32
train backward (all bound by operations)."""

import json
from pathlib import Path

import pytest

from tiny import ROOT  # noqa: F401  (puts the repo on the path)

from portbench import work

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
BG = json.loads((CONFIGS / "brandenburg_gate.json").read_text())["dims"]
HI = json.loads((CONFIGS / "synth_identity_hires.json").read_text())["dims"]


def test_sample_macs_by_hand():
    trunk = 63 * 256 + 6 * 256 * 256 + (256 + 63) * 256  # layer 0, six plain layers, the skip layer
    assert work.trunk_macs(BG) == trunk
    base = trunk + 256 * 256 + 256 + 256 * 384  # xyz_final, sigma, feat
    assert work.sample_macs(BG, work.mode_of_phase(2)) == base + 384 * 128 + 128 * 3
    assert work.sample_macs(BG, work.mode_of_phase(0)) == base + 256 * 128 + 128 * 128 + 128 + 128 * 384
    assert work.sample_macs(BG, work.mode_of_phase(1)) == 803072


@pytest.mark.parametrize("dims,phase,kind,ms", [
    (BG, 1, "fwd", 1.70), (BG, 1, "bwd", 3.41), (BG, 2, "fwd", 1.49), (BG, 2, "bwd_frozen", 1.49),
    (HI, 1, "bwd", 2.64)])
def test_bounds_of_the_kernel_table(dims, phase, kind, ms):
    got = work.pass_least_seconds(dims, work.mode_of_phase(phase), 4096, 256, kind) * 1e3
    assert round(got, 2) == ms
    assert work.pass_flops(dims, work.mode_of_phase(phase), 4096, 256, kind) / work.PEAK_FLOPS_BF16 * 1e3 == \
        pytest.approx(got)  # bound by operations


def test_bytes_by_hand():
    m = work.mode_of_phase(2)
    R, S = 4096, 256
    ins = 6 * R + R * S + R * 128
    outs = R * S + R * (1 + 3)
    assert work.pass_bytes(BG, m, R, S, "fwd") == 4 * (ins + outs) + 2 * work.n_weights(BG, m)
    frozen = 4 * (ins + outs + (ins - R * S)) + 2 * work.n_weights(BG, m)
    assert work.pass_bytes(BG, m, R, S, "bwd_frozen") == frozen
    assert work.pass_bytes(BG, m, R, S, "bwd") == frozen + 4 * work.n_weights(BG, m)


def test_units_of_work():
    fwd1 = sum(work.sample_macs(BG, work.mode_of_phase(1)) * s + work.ray_macs(BG, work.mode_of_phase(1))
               for s in (128, 256))
    assert work.train_step_flops(BG, 1, 2048) == pytest.approx(6.0 * 2048 * (fwd1 + work.transient_macs(BG)))
    m2 = work.mode_of_phase(2)
    fwd = sum(work.sample_macs(BG, m2) * s + work.ray_macs(BG, m2) for s in (128, 256))
    bwd = work.sample_macs(BG, m2) * 256 + work.ray_macs(BG, m2)
    assert work.tto_step_flops(BG, 4096) == pytest.approx(2.0 * 4096 * (fwd + bwd))
    assert work.render_ray_flops(HI) == pytest.approx(2.0 * sum(work.sample_macs(HI, m2) * s + work.ray_macs(HI, m2)
                                                                for s in (48, 96)))
