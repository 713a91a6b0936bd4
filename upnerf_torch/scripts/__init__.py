"""Scripts of the port, run as modules:

    python -m upnerf_torch.scripts.bench_render_train_kernel [--device cpu]
    python -m upnerf_torch.scripts.bench_mxu_probe [--device cpu]
    python -m upnerf_torch.scripts.pose_protocol --recipe pose [--device cpu]
    python -m upnerf_torch.scripts.tto_protocol [--device cpu]
    python -m upnerf_torch.scripts.quality_protocol [--device cpu]
    python -m upnerf_torch.scripts.analyze_pose_recovery RUN_DIR [--device cpu]
    python -m upnerf_torch.scripts.protocol_table

Counterparts of scripts/bench_render_train_kernel.py, bench_mxu_probe.py,
pose_protocol.py, tto_protocol.py, quality_protocol.py,
analyze_pose_recovery.py and protocol_table.py, with the same flags, seeded
inputs and recipe tables; the protocol drivers write their records to
protocols_torch/ (--out), not to benchmarks/.
"""
