#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (upnerf_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise):
  1. the card: name and power limit from nvidia-smi;
  2. build: nvcc compiles upnerf_torch/csrc/*.cu for sm_90a;
  3. kernel against its plain PyTorch version on one 4096-ray chunk at the
     brandenburg_gate width, S = 128 and 256 samples, float32 and bfloat16;
  4. the serving path: a seeded checkpoint at that width is rendered for 2
     frames at 128x128 by `upnerf_torch.cli.render_video.main`, every
     coarse and fine pass through the kernel; then rays of frame 0 rendered
     on the card are held against the same rays rendered on the CPU;
  5. timings of the kernel and the plain version per chunk and per frame.

The last two lines are one JSON object describing each kernel, and
{"ok": true, "device": {...}}. Needs torch with CUDA, nvcc and one card;
imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

# The keys the port reads, as upnerf/config/default.yaml + configs/brandenburg_gate.yaml
# resolve them (tests/test_torch_render_slice.py checks the two agree).
BRANDENBURG_GATE = {
    "nerf.D": 8,
    "nerf.W": 256,
    "nerf.skips": (4,),
    "nerf.N_emb_xyz": 10,
    "nerf.N_emb_dir": 4,
    "nerf.feat_dim": 384,
    "nerf.appearance_dim": 48,
    "nerf.candidate_dim": 16,
    "nerf.N_samples": 128,
    "nerf.N_importance": 128,
    "nerf.near": 0.1,
    "nerf.far": 5.0,
    "nerf.use_disp": False,
    "nerf.perturb": 1.0,
    "pose.c2f": (0.1, 0.5),
    "val.chunk_size": 4096,
    "tpu.matmul_precision": "bfloat16",
    "t_net.beta_min": 0.1,
    "t_net.transient_dim": 128,
    "t_net.feat_dim": 384,
}

# Kernel against plain version on the card. f32: both sum in f32 in another
# order (cuBLAS against the kernel's k-loop), ~1e-6 relative a layer. bf16:
# an activation whose f32 sum lands on the other side of a bf16 rounding
# boundary moves by one bf16 ulp (2^-8 relative), rarely.
TOL = {"float32": 1e-5, "bfloat16": 1e-3}
# A frame's rays on the card (kernel) against the CPU (plain version):
# besides the above, fine samples move with the coarse weights, and the top
# PE band (2^9 pi) turns a 1e-6 move of a sample into a ~2e-3 change of x0.
E2E_TOL = 1e-2
CHUNK = 4096
FRAME_WH = (128, 128)
FOCAL = 128.0


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean ms of fn() over `reps` runs, CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def chunk_inputs(field, S: int, seed: int, dev):
    """One 4096-ray chunk as the serving path gives it to the kernel:
    unit directions, sorted depths in [near, far], the field's ray_cond."""
    from upnerf_torch.render.render_rays import ray_conditioning

    rng = np.random.RandomState(seed)
    o = torch.tensor(rng.randn(CHUNK, 3).astype(np.float32) * 0.3, device=dev)
    d = torch.tensor(rng.randn(CHUNK, 3).astype(np.float32), device=dev)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    z = torch.tensor(rng.uniform(0.1, 5.0, (CHUNK, S)).astype(np.float32), device=dev)
    z = torch.sort(z, -1).values.contiguous()
    a_emb = torch.tensor(rng.randn(CHUNK, 48).astype(np.float32), device=dev)
    with torch.no_grad():
        cond = ray_conditioning(field, d, a_emb, 1.0)
    return o, d, z, torch.ones(10, device=dev), cond


def read_png_size(path: str):
    """(width, height) of an 8-bit RGB PNG, checking its pixel stream."""
    with open(path, "rb") as f:
        data = f.read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path} is not a PNG")
    w, h = int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24], "big")
    i, idat = 8, b""
    while i < len(data):
        n = int.from_bytes(data[i : i + 4], "big")
        if data[i + 4 : i + 8] == b"IDAT":
            idat += data[i + 8 : i + 8 + n]
        i += 12 + n
    check(len(zlib.decompress(idat)) == h * (1 + 3 * w), f"{path}: pixel stream size")
    return w, h


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a CUDA card", file=sys.stderr)
        return 2
    import upnerf_torch  # noqa: F401  (fails here when run outside the repository)
    from upnerf_torch.cli import render_video
    from upnerf_torch.evaluate.render import make_pose_renderer, render_image
    from upnerf_torch.geometry import rays as ray_utils
    from upnerf_torch.geometry import se3
    from upnerf_torch.models.nerf import NeRFConfig, NeRFField
    from upnerf_torch.ops import _build
    from upnerf_torch.ops import render_train as rt
    from upnerf_torch.render.render_rays import RenderConfig, field_weights, render_rays
    from upnerf_torch.utils.weights import init_reference_ckpt, load_reference_ckpt, render_params

    dev = torch.device("cuda:0")
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32, "TF32 is on")

    # 1. the card
    card = card_line()
    print(card, flush=True)
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}", flush=True)

    # 2. build
    info = _build.build()
    print(f"[2] nvcc {info.seconds:.1f} s -> {info.path}", flush=True)
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line:
            print("    " + line.strip(), flush=True)

    # 3. kernel against plain version, one chunk at full width
    nerf_cfg = NeRFConfig.from_hparams(BRANDENBURG_GATE)
    field = NeRFField(nerf_cfg, generator=torch.Generator().manual_seed(0)).to(dev).requires_grad_(False)
    errs, inputs = {}, {}
    for S in (128, 256):
        inputs[S] = chunk_inputs(field, S, seed=S, dev=dev)
        for prec in ("float32", "bfloat16"):
            st = rt.RTStatic(D=nerf_cfg.D, skips=nerf_cfg.skips, xyz_L=nerf_cfg.xyz_L, precision=prec)
            trunk, heads = field_weights(field)
            with torch.no_grad():
                got = rt.render_train_rays_fwd(*inputs[S], trunk, heads, st)
                want = rt.render_train_rays_plain(*inputs[S], trunk, heads, st)
            torch.cuda.synchronize()
            for k, v in got.items():
                check(bool(torch.isfinite(v).all()), f"kernel output {k} not finite (S={S}, {prec})")
            e = {
                "rgb_map": (got["rgb_map"] - want["rgb_map"]).abs().max().item(),
                "s_weights": (got["s_weights"] - want["s_weights"]).abs().max().item(),
                "s_depth_rel": ((got["s_depth"] - want["s_depth"]).abs() / want["s_depth"].abs()).max().item(),
            }
            errs[(S, prec)] = e
            print(f"[3] S={S} {prec}: max|d rgb_map| {e['rgb_map']:.3e}  max|d s_weights| {e['s_weights']:.3e}"
                  f"  max rel d s_depth {e['s_depth_rel']:.3e}  (tol {TOL[prec]:.0e})", flush=True)
            check(max(e.values()) <= TOL[prec], f"kernel disagrees with plain version at S={S} {prec}: {e}")

    # 4. the serving path through the CLI
    hp = dict(BRANDENBURG_GATE)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = init_reference_ckpt(os.path.join(tmp, "bg.ckpt"), hp, n_images=4, seed=0)
        out_dir = os.path.join(tmp, "video")
        argv = ["--ckpt", ckpt, "--out", out_dir, "--frames", "2", "--wh", str(FRAME_WH[0]), str(FRAME_WH[1]),
                "--focal", str(FOCAL), "--anchor", "1", "--device", "cuda"]
        n_chunks = FRAME_WH[0] * FRAME_WH[1] // CHUNK
        expected = 2 * n_chunks * 2
        rt.launches = 0
        t0 = time.perf_counter()
        written = render_video.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = rt.launches
        print(f"[4] render_video: 2 frames {FRAME_WH[0]}x{FRAME_WH[1]} in {cli_s:.2f} s, kernel launches {launches}"
              f" (expected 2 frames x {n_chunks} chunks x 2 passes = {expected})", flush=True)
        check(launches == expected, f"kernel launched {launches} times, expected {expected}")
        depth0 = None
        for png, npy in zip(written["frames"], written["depths"]):
            check(read_png_size(png) == FRAME_WH, f"{png} has the wrong size")
            depth = np.load(npy)
            check(depth.shape == FRAME_WH[::-1] and bool(np.isfinite(depth).all()), f"{npy}: bad depth")
            check(0.0 <= float(depth.min()) and float(depth.max()) <= 5.0 + 1e-3, f"{npy}: depth outside [0, far]")
            depth0 = depth if depth0 is None else depth0
        print(f"    frames ok: depth of frame 0 in [{depth0.min():.3f}, {depth0.max():.3f}]", flush=True)

        # rays of frame 0 on the card against the same rays on the CPU
        sd, hparams, _ = load_reference_ckpt(ckpt)
        rcfg = RenderConfig.from_hparams(hparams)._replace(perturb=0.0)
        cpu_params, se3_cpu = render_params(sd, nerf_cfg, "cpu")
        gpu_params, _ = render_params(sd, nerf_cfg, dev)
        anchor = se3.compose([se3.se3_to_SE3(se3_cpu[1]), torch.eye(3, 4)])
        pose0 = se3.get_novel_view_poses(anchor, N=2)[0]
        K = torch.tensor([[FOCAL, 0, FRAME_WH[0] / 2], [0, FOCAL, FRAME_WH[1] / 2], [0, 0, 1]])
        pix = torch.arange(0, FRAME_WH[0] * FRAME_WH[1], 256)  # 64 pixels spread over the frame
        dirs = ray_utils.pixel_directions(pix % FRAME_WH[0], pix // FRAME_WH[0], K)
        rays_o, rays_d = ray_utils.get_rays(dirs, pose0)
        rays = torch.cat([rays_o, rays_d, torch.tensor([[0.1, 5.0]]).expand(len(pix), 2)], -1)
        idx = torch.full((len(pix),), 1, dtype=torch.long)
        with torch.no_grad():
            on_cpu = render_rays(cpu_params, rcfg, rays, idx, det=True)
            on_gpu = render_rays(gpu_params, rcfg, rays.to(dev), idx.to(dev), det=True)
        d_rgb = (on_gpu["s_rgb_fine"].cpu() - on_cpu["s_rgb_fine"]).abs().max().item()
        d_dep = ((on_gpu["s_depth_fine"].cpu() - on_cpu["s_depth_fine"]).abs() / on_cpu["s_depth_fine"]).max().item()
        d_cli = float(np.abs(depth0.reshape(-1)[pix.numpy()] - on_gpu["s_depth_fine"].cpu().numpy()).max())
        print(f"    64 rays of frame 0, card vs CPU: max|d rgb| {d_rgb:.3e}  max rel d depth {d_dep:.3e}"
              f"  (tol {E2E_TOL:.0e}); CLI depth vs this render {d_cli:.3e}", flush=True)
        check(max(d_rgb, d_dep) <= E2E_TOL, "the card's render disagrees with the CPU render")
        check(d_cli <= E2E_TOL * 5.0, "the CLI's depth disagrees with a direct render")

    # 5. timings, plain and kernel in turns (plain, kernel, kernel, plain)
    times = {}
    for S in (128, 256):
        for prec in ("float32", "bfloat16"):
            st = rt.RTStatic(D=nerf_cfg.D, skips=nerf_cfg.skips, xyz_L=nerf_cfg.xyz_L, precision=prec)
            trunk, heads = field_weights(field)
            with torch.no_grad():
                plain = lambda: rt.render_train_rays_plain(*inputs[S], trunk, heads, st)  # noqa: E731
                kern = lambda: rt.render_train_rays_fwd(*inputs[S], trunk, heads, st)  # noqa: E731
                p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kern), cuda_ms(kern), cuda_ms(plain)
            times[(S, prec)] = ((k1 + k2) / 2, (p1 + p2) / 2)
            print(f"[5] S={S} {prec}: kernel {times[(S, prec)][0]:.2f} ms  plain {times[(S, prec)][1]:.2f} ms"
                  f" per {CHUNK}-ray chunk ({card})", flush=True)
    n_chunks = FRAME_WH[0] * FRAME_WH[1] // CHUNK
    for prec in ("float32", "bfloat16"):
        fk = n_chunks * (times[(128, prec)][0] + times[(256, prec)][0])
        fp = n_chunks * (times[(128, prec)][1] + times[(256, prec)][1])
        print(f"[5] frame {FRAME_WH[0]}x{FRAME_WH[1]} {prec}, coarse+fine passes only: kernel {fk:.1f} ms"
              f" ({FRAME_WH[0] * FRAME_WH[1] / fk * 1e3:.0f} rays/s), plain {fp:.1f} ms"
              f" ({FRAME_WH[0] * FRAME_WH[1] / fp * 1e3:.0f} rays/s) ({card})", flush=True)
    renderer = make_pose_renderer(rcfg, chunk=CHUNK)
    pose_np, K_np = pose0.numpy(), K.numpy()
    render_image(renderer, gpu_params, K_np, pose_np, FRAME_WH, [0.1, 5.0], 1, chunk=CHUNK, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        render_image(renderer, gpu_params, K_np, pose_np, FRAME_WH, [0.1, 5.0], 1, chunk=CHUNK, device=dev)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) / reps * 1e3
    print(f"[5] frame {FRAME_WH[0]}x{FRAME_WH[1]} end to end (render_image, bfloat16): {frame_ms:.1f} ms"
          f" ({FRAME_WH[0] * FRAME_WH[1] / frame_ms * 1e3:.0f} rays/s) ({card})", flush=True)

    serve = (256, "bfloat16")
    print(json.dumps({"kernels": [{
        "name": "render_train_fwd",
        "route": "cuda",
        "source": "upnerf_torch/csrc/render_train_fwd.cu",
        "replaces": "upnerf/ops/pallas_render_train.py:555",
        "launches": launches,
        "max_abs_err": max(max(e["rgb_map"], e["s_weights"]) for e in errs.values()),
        "ms": times[serve][0],
        "plain_ms": times[serve][1],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
