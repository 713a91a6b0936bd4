"""Microbenchmarks of the port's kernels, run as modules:

    python -m upnerf_torch.scripts.bench_render_train_kernel [--device cpu]
    python -m upnerf_torch.scripts.bench_mxu_probe [--device cpu]

Counterparts of scripts/bench_render_train_kernel.py and
scripts/bench_mxu_probe.py, with the same flags and the same seeded inputs.
"""
