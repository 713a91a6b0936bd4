"""Build and load the package's CUDA kernels.

At first use, `nvcc` compiles each `upnerf_torch/csrc/*.cu` into its own
shared library with a plain C interface, for sm_90a (Hopper), into
`build/upnerf_torch_kernels/` at the repository root; all sources compile at
once, one nvcc process each. A library is loaded with ctypes. Its file name
carries a hash of its source, the shared headers and the flags, so an edited
source is rebuilt and a stale library is never loaded. Building takes
seconds: no source includes PyTorch's headers. `VARIANTS` are extra builds of
a source with other macros, for timing only; no path of the port loads them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, NamedTuple

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "upnerf_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
KERNELS = ("render_train_fwd", "render_train_bwd", "flash_attn_fwd", "heads_fwd", "heads_bwd", "mxu_probe",
           "dw_gemm")
# name: (source, nvcc flags). render_train_fwd with the mma.sync bfloat16 design that
# wg_kernel replaced: chip_smoke.py (phase 5b and --kernel_times) times both designs
# in turns (render_train.py:FWD_DESIGNS); render_train_bwd with the mma.sync walk that
# the Hopper walk replaced (phases 9 and 12, render_train.py:BWD_DESIGNS); heads_fwd
# with the mma.sync forward that wg_fwd_kernel replaced (phases 14 and 16,
# heads.py:HEADS_FWD_DESIGNS); mxu_probe with the mma.sync probe that wg_probe_kernel
# replaced (phase 25, mxu_probe.py:PROBE_DESIGNS).
VARIANTS = {"render_train_fwd_mma_sync": ("render_train_fwd", ("-DUPNERF_FWD_MMA_SYNC",)),
            "render_train_bwd_mma_sync": ("render_train_bwd", ("-DUPNERF_BWD_MMA_SYNC",)),
            "heads_fwd_mma_sync": ("heads_fwd", ("-DUPNERF_HEADS_FWD_MMA_SYNC",)),
            "mxu_probe_mma_sync": ("mxu_probe", ("-DUPNERF_PROBE_MMA_SYNC",))}


class BuildInfo(NamedTuple):
    path: Path
    seconds: float  # nvcc wall time; 0.0 when the library was already built
    log: str  # nvcc's output (ptxas register/spill report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels cannot be built")
    return path


def _source(name: str):
    """(source name, extra nvcc flags) of a kernel or variant."""
    return VARIANTS.get(name, (name, ()))


def _target(name: str) -> Path:
    source, flags = _source(name)
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + flags).encode())
    for src in [CSRC_DIR / f"{source}.cu"] + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def build() -> Dict[str, BuildInfo]:
    """Compile every kernel source not yet built for its hash, all at once;
    returns {name: BuildInfo}. A failed compile raises with nvcc's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, BuildInfo] = {}
    procs = {}
    t0 = time.perf_counter()
    for name in KERNELS + tuple(VARIANTS):
        target = _target(name)
        if target.is_file():
            out[name] = BuildInfo(target, 0.0, "")
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        source, flags = _source(name)
        cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp), str(CSRC_DIR / f"{source}.cu")]
        procs[name] = (target, tmp, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                          text=True))
    failed = []
    for name, (target, tmp, cmd, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, target)
        out[name] = BuildInfo(target, time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


_ARGTYPES = {
    # ins, trunk W, trunk b, D, skip mask, heads, outs, R, S, L, in0, C, F, flags, packed weights (bf16), their
    # schedule ((offset, bytes) pairs), its K-strips, stream
    "upnerf_render_train_fwd": ["pp", "pp", "pp", "i", "u", "pp", "pp", "i", "i", "i", "i", "i", "i", "i", "p", "ip",
                                "i", "p"],
    # ins, cots, res, trunk W^T, D, skip mask, weights, outs, dW operand buffers, their layout (both null but in the
    # train mode, DW_OPS), R, S, L, in0, C, F, flags, stream
    "upnerf_render_train_bwd": ["pp", "pp", "pp", "pp", "i", "u", "pp", "pp", "pp", "ip", "i", "i", "i", "i", "i",
                                "i", "i", "p"],
    # the Hopper design's stages: ins, cots, res, D, skip mask, weights, outs, dW operand buffers, their layout,
    # scratch (coefficient rows, mask words, partial sums, d h1 rows), packed weights, their schedule ((offset,
    # bytes) pairs), its K-strips, R, S, L, in0, C, F, flags, stage, stream
    "upnerf_render_train_bwd_wg": ["pp", "pp", "pp", "i", "u", "pp", "pp", "pp", "ip", "pp", "p", "ip", "i", "i", "i",
                                   "i", "i", "i", "i", "i", "i", "p"],
    # sources, their rows, their columns, jobs (11 ints each), job count, workspace, splits, out, weight floats,
    # bias rows, their count, bias floats, accumulate, f32 sources, stream
    "upnerf_dw_gemm": ["pp", "ip", "ip", "ip", "i", "p", "i", "p", "i", "p", "i", "i", "i", "i", "p"],
    # q, k, v, o, bf16 scratch q * scale, k, v (null in float32 mode), G, N, hd, scale, use_bf16, stream
    "upnerf_flash_attn_fwd": ["p", "p", "p", "p", "p", "p", "p", "i", "i", "i", "f", "i", "p"],
    # x0, c_emb, trunk W, trunk b, D, skip mask, heads (null: the trunk alone), outs, N, in0, C, F, use_bf16,
    # packed weights (bf16), their schedule ((offset, bytes) pairs), its K-strips, the input rows' scratch, stream
    "upnerf_heads_fwd": ["p", "p", "pp", "pp", "i", "u", "pp", "pp", "i", "i", "i", "i", "i", "p", "ip", "i", "p",
                         "p"],
    # x0, c_emb, cots, trunk W, trunk b, trunk W^T (the trunk's matrices null in bf16 mode), D, skip mask,
    # weights, biases, packed weights (bf16), their schedule ((offset, bytes) pairs), its K-strips, outs, dW operand
    # buffer, its layout, bias rows, N, in0, C, F, use_bf16, heads, stream
    "upnerf_heads_bwd": ["p", "p", "pp", "pp", "pp", "pp", "i", "u", "pp", "pp", "p", "ip", "i", "pp", "p", "ip", "p",
                         "i", "i", "i", "i", "i", "i", "p"],
    # x, packed weights (L layers: the build's design's layout), bias, out, M, W, L, copies, chain, stream
    "upnerf_mxu_probe": ["p", "p", "p", "p", "i", "i", "i", "i", "i", "p"],
}


# The C entry points of each source, beside upnerf_<source>.
ENTRY_POINTS = {"render_train_bwd": ("upnerf_render_train_bwd", "upnerf_render_train_bwd_wg")}


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The built library of kernel `name`, loaded once per process, with its C
    functions' argtypes and restype declared (ctypes would otherwise pass
    pointers as 32-bit ints)."""
    lib = ctypes.CDLL(str(build()[name].path))
    kinds = {"p": ctypes.c_void_p, "pp": ctypes.POINTER(ctypes.c_void_p), "i": ctypes.c_int, "u": ctypes.c_uint,
             "f": ctypes.c_float, "ip": ctypes.POINTER(ctypes.c_int)}
    source = _source(name)[0]
    for fn_name in ENTRY_POINTS.get(source, (f"upnerf_{source}",)):
        fn = getattr(lib, fn_name)
        fn.argtypes = [kinds[k] for k in _ARGTYPES[fn_name]]
        fn.restype = ctypes.c_int
    lib.upnerf_error_string.argtypes = [ctypes.c_int]
    lib.upnerf_error_string.restype = ctypes.c_char_p
    return lib
