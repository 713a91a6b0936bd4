"""Microbenchmark of the fused training render from PE rows (kernel 1b:
`upnerf_torch.ops.render_train.render_train`, forward and d_x0 backward)
against its plain PyTorch version at the flagship blended-phase workload.

    python -m upnerf_torch.scripts.bench_render_train_kernel [--rays 2048] [--samples 384]
        [--precision bfloat16] [--steps 20] [--fwd_only] [--device cuda]

The counterpart of scripts/bench_render_train_kernel.py: the same inputs,
drawn from np.random.RandomState(0) in the same order (D=8, W=256, F=384,
in0=63, skip 4, the candidate branch, rgb and the feature map), the same
static configuration (save_chain off: the backward recomputes the chain) and
the same loss: value and grad of sum(feat_map^2) + sum(rgb_map^2) +
sum(s_depth) with respect to x0, the trunk and the heads through
`render_train`, then through autograd of `render_train_plain`; with
--fwd_only, the value of sum(feat_map) + sum(rgb_map) + sum(s_depth) through
`render_train_fwd` and `render_train_plain`. Prints ms/iter and k rays/s of
each (CUDA events on the card, after one warm-up call), their ratio, and how
far the two routes' loss and x0 gradient are apart. The device is the card
unless `--device cpu` is given (the plain versions on both routes, host
clock); without a card, `--device cuda` raises.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

D, W, F, HH, HC, C = 8, 256, 384, 128, 128, 16
IN0, SKIPS = 63, (4,)
HEAD_SHAPES = (("xyzf_w", (W, W), 0.3), ("xyzf_b", (W,), 0.05), ("sigma_w", (W, 1), 0.3), ("sigma_b", (1,), 0.05),
               ("feat_w", (W, F), 0.3), ("feat_b", (F,), 0.05), ("rgb1_w", (F, HH), 0.3), ("rgb2_w", (HH, 3), 0.3),
               ("rgb2_b", (3,), 0.05), ("c1x_w", (W, HC), 0.3), ("c1c_w", (C, HC), 0.3), ("c1_b", (HC,), 0.05),
               ("c2_w", (HC, HC), 0.3), ("c2_b", (HC,), 0.05), ("csig_w", (HC, 1), 0.3), ("csig_b", (1,), 0.05),
               ("cfeat_w", (HC, F), 0.3), ("cfeat_b", (F,), 0.05))


def make_inputs(R: int, S: int, seed: int = 0):
    """(x0, z, cond, cemb, trunk, heads) as numpy f32, drawn in the JAX script's order (:43-68)."""
    rng = np.random.RandomState(seed)

    def arr(*shape, scale=0.3):
        return rng.randn(*shape).astype(np.float32) * scale

    x0 = arr(R * S, IN0)
    z = np.sort(rng.rand(R, S).astype(np.float32) * 4 + 0.1, -1)
    cond = arr(R, HH)
    cemb = arr(R, C)
    trunk = [(arr(IN0 if i == 0 else (W + IN0 if i in SKIPS else W), W), arr(W, scale=0.05)) for i in range(D)]
    heads = {k: arr(*shape, scale=scale) for k, shape, scale in HEAD_SHAPES}
    return x0, z, cond, cemb, trunk, heads


def main(argv: Optional[list] = None) -> dict:
    """Run the benchmark; returns {"fused_ms", "plain_ms", "ratio", "loss", "loss_rel", "dx0_rel",
    "dx0_rms", "device"}: the plain route's loss, the routes' relative loss difference, and their x0
    gradients' max |d| over max |g| and RMS distance over RMS (None with --fwd_only)."""
    from upnerf_torch.ops import render_train as rt

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rays", type=int, default=2048)
    ap.add_argument("--samples", type=int, default=384)
    ap.add_argument("--precision", default="bfloat16")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--fwd_only", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available")

    R, S = args.rays, args.samples
    st = rt.RTStatic(D=D, skips=SKIPS, xyz_L=0, precision=args.precision, use_cand=True, use_rgb=True,
                     out_feat=True, save_chain=False)
    x0, z, cond, cemb, trunk, heads = (
        [(torch.from_numpy(w).to(dev), torch.from_numpy(b).to(dev)) for w, b in v] if i == 4
        else {k: torch.from_numpy(a).to(dev) for k, a in v.items()} if i == 5 else torch.from_numpy(v).to(dev)
        for i, v in enumerate(make_inputs(R, S)))
    leaves = [x0] + [t for wb in trunk for t in wb] + [heads[k] for k in st.head_keys]

    def loss_of(out, fwd_only):
        if fwd_only:
            return out["feat_map"].sum() + out["rgb_map"].sum() + out["s_depth"].sum()
        return (out["feat_map"] ** 2).sum() + (out["rgb_map"] ** 2).sum() + out["s_depth"].sum()

    def value_and_grad(render, forward):
        """The loss (and its gradients w.r.t. x0, the trunk and the heads) through one route."""
        if args.fwd_only:
            with torch.no_grad():
                return loss_of(forward(x0, z, cond, trunk, heads, st, c_emb=cemb), True), None
        ls = [t.detach().requires_grad_(True) for t in leaves]
        tr = [(ls[1 + 2 * i], ls[2 + 2 * i]) for i in range(D)]
        hd = dict(zip(st.head_keys, ls[1 + 2 * D:]))
        loss = loss_of(render(ls[0], z, cond, tr, hd, st, c_emb=cemb), False)
        return loss.detach(), torch.autograd.grad(loss, ls)

    def fused():
        return value_and_grad(rt.render_train, rt.render_train_fwd)

    def plain():
        return value_and_grad(rt.render_train_plain, rt.render_train_plain)

    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu, host clock"

    def run(fn, label):
        t0 = time.perf_counter()
        first = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        print(f"{label}: first call {time.perf_counter() - t0:.2f} s", flush=True)
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.steps):
                fn()
            end.record()
            torch.cuda.synchronize(dev)
            dt = start.elapsed_time(end) / 1e3 / args.steps
        else:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                fn()
            dt = (time.perf_counter() - t0) / args.steps
        print(f"{label}: {dt * 1e3:.2f} ms/iter ({R / dt / 1e3:.1f}k rays/s) ({where})", flush=True)
        return dt, first

    dt_fused, (v_f, g_f) = run(fused, "fused")
    dt_plain, (v_p, g_p) = run(plain, "plain")
    loss_rel = abs(float(v_f) - float(v_p)) / max(abs(float(v_p)), 1e-30)
    dx0_rel = dx0_rms = None
    if g_f is not None:
        diff, ref = (g_f[0] - g_p[0]).double(), g_p[0].double()
        dx0_rel = (diff.abs().max() / ref.abs().max().clamp(min=1e-30)).item()
        dx0_rms = (diff.pow(2).mean().sqrt() / ref.pow(2).mean().sqrt().clamp(min=1e-30)).item()
    print(f"speedup: {dt_plain / dt_fused:.2f}x; loss fused {float(v_f):.6g} vs plain {float(v_p):.6g} (rel"
          f" {loss_rel:.2e})" + ("" if dx0_rel is None else f"; d_x0 max |d| / max |g| {dx0_rel:.2e}, RMS"
                                                             f" {dx0_rms:.2e}"), flush=True)
    return {"fused_ms": dt_fused * 1e3, "plain_ms": dt_plain * 1e3, "ratio": dt_plain / dt_fused,
            "loss": float(v_p), "loss_rel": loss_rel, "dx0_rel": dx0_rel, "dx0_rms": dx0_rms, "device": where}


if __name__ == "__main__":
    main()
