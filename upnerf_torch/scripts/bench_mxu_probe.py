"""Matrix-unit probe at the render kernels' product shapes: a chain of L
(M, W) @ (W, W) products (`upnerf_torch.ops.mxu_probe`), in the three kinds
of the JAX probe (pure bf16; f32 accumulate with a bias + ReLU epilogue; int8
x int8 -> int32 with requantisation), repeated `grid` times over the M rows.

    python -m upnerf_torch.scripts.bench_mxu_probe [--m 2048] [--w 256] [--layers 16]
        [--grid 64] [--steps 30] [--device cuda]

The counterpart of scripts/bench_mxu_probe.py, on the same inputs
(np.random.RandomState(0), drawn and quantised in the same order). For each
chain it prints the hand-written kernel's ms (CUDA events over --steps calls
after a warm-up), its rate in TFLOP/s or TOPS (2 M W^2 L grid operations) and
its share of the card's dense peak (989 TFLOP/s bf16, 1,979 TOPS int8, the
H100 SXM's published rates), the plain version's ms (torch.matmul in f32 on
the rounded operands, the same work) and, as the library ceiling at these
shapes, the ms of the same L products by one PyTorch call each in the
chain's own type (a bf16 cuBLAS product chain; for epi with the bias added by
addmm and a ReLU; for int8 `torch._int_mm` products, int32 out, without the
requantisation). The device is the card unless `--device cpu` is given (the
plain version alone, host clock); without a card, `--device cuda` raises.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from typing import Optional

import torch

PEAK = {"pure": 989e12, "epi": 989e12, "int8": 1979e12}  # H100 SXM, dense
LABELS = {"pure": "pure bf16 chain   ", "epi": "f32 acc + epilogue", "int8": "int8 chain + requant"}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def library_chain(x, ws, b, chain: str, copies: int):
    """The chain's L products at copies x M rows by one PyTorch call each in the
    chain's type, or None where this PyTorch has no such call (the yardstick;
    the port never calls it)."""
    h = x.repeat(copies, 1)
    if chain == "int8":
        if not hasattr(torch, "_int_mm"):
            return None
        h8 = torch.clamp(h * 127.0, -127, 127).to(torch.int8)
        w8 = [w.t().contiguous().t() for w in ws]  # column-major: _int_mm's fast layout for the second operand

        def run():
            for w in w8:
                torch._int_mm(h8, w)
        return run
    hb, wb, bb = h.to(torch.bfloat16), [w.to(torch.bfloat16) for w in ws], b.to(torch.bfloat16)

    def run():
        y = hb
        for w in wb:
            y = torch.matmul(y, w) if chain == "pure" else torch.relu(torch.addmm(bb, y, w))
        return y
    return run


def main(argv: Optional[list] = None) -> dict:
    """Run the probe; returns {chain: {"ms", "rate", "share", "plain_ms", "library_ms"}} and "device"
    (on the CPU: the plain version's ms alone)."""
    from upnerf_torch.ops import mxu_probe as mp

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", type=int, default=2048)
    ap.add_argument("--w", type=int, default=256)
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available")
    M, W, L, G = args.m, args.w, args.layers, args.grid
    x, ws, b, ws_i8 = (torch.from_numpy(a).to(dev) for a in mp.probe_inputs(M, W, L, seed=0))
    ops = 2.0 * M * W * W * L * G
    card = card_line() if dev.type == "cuda" else "cpu, host clock"
    print(card, flush=True)

    def ms(fn) -> float:
        fn()
        if dev.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(args.steps):
                fn()
            return (time.perf_counter() - t0) / args.steps * 1e3
        torch.cuda.synchronize(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.steps):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / args.steps

    results = {"device": card}
    with torch.no_grad():
        for chain in mp.CHAINS:
            w = ws_i8 if chain == "int8" else ws
            unit = "TOPS" if chain == "int8" else "TFLOP/s"
            plain_ms = ms(lambda: mp.mxu_probe_plain(x, w, b, chain, G))
            if dev.type != "cuda":
                print(f"{LABELS[chain]}: plain version {plain_ms:.3f} ms (no card: the kernel is not run)", flush=True)
                results[chain] = {"plain_ms": plain_ms}
                continue
            packed = mp.pack_weights(w if chain == "int8" else w.to(torch.bfloat16))
            k_ms = ms(lambda: mp.mxu_probe(x, w, b, chain, G, packed=packed))
            lib = library_chain(x, ws if chain != "int8" else ws_i8, b, chain, G)
            lib_ms = ms(lib) if lib is not None else None
            rate = ops / (k_ms * 1e-3)
            results[chain] = {"ms": k_ms, "rate": rate, "share": rate / PEAK[chain], "plain_ms": plain_ms,
                              "library_ms": lib_ms}
            lib_txt = "none in this PyTorch" if lib_ms is None else f"{lib_ms:.3f} ms ({ops / lib_ms / 1e9:.1f} {unit})"
            print(f"{LABELS[chain]}: {k_ms:.3f} ms  {rate / 1e12:.1f} {unit} ({rate / PEAK[chain] * 100:.0f}% of the"
                  f" dense peak); plain {plain_ms:.3f} ms; library products {lib_txt} ({card})", flush=True)
    return results


if __name__ == "__main__":
    main()
