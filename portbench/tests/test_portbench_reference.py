"""The plain reference against upnerf_torch on the CPU at a small size: with
the program in float32 every number the check compares agrees to round-off,
through the whole run (draws, gathers, rays, both passes, the sampler, the
transient net, the loss, the gradients and both Adam updates; TTO's pixel
draw and frozen model; the frames; the preprocessing pass's keys, PCA and
inverse depth, from the uint8 resizes on)."""

import pytest

from tiny import CELLS, PREPROCESS, run_cell

# float32 on both sides: the sums run in other orders (blocks, fused
# products), so the readings sit at round-off, orders below the limits.
F32_TOL = {"loss_gap": 1e-5, "grad_gap": 1e-3, "change_gap": 1e-3, "change_gap.median": 1e-3,
           "grad_err.fine_a": 1e-3, "rgb_rmse": 1e-5, "depth_rel_rms": 1e-5, "key_rel_rms": 1e-5,
           "pca_mean_gap": 1e-5, "pca_comp_gap": 1e-5}


@pytest.mark.parametrize("cell", CELLS + (PREPROCESS,))
def test_reference_agrees_with_the_port_in_float32(cell):
    rc, res = run_cell(cell, precision="float32")
    assert rc == 0
    for k, c in res["check"].items():
        assert c["value"] <= F32_TOL[k], (k, c["value"])
