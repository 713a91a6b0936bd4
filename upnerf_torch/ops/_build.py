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
# name: (source, nvcc flags). heads_bwd and render_train_bwd without their in-walk
# weight-gradient atomic adds (walk_common.cuh:skip_dw_add): chip_smoke.py phases 16
# and 9 time the adds' share.
VARIANTS = {"heads_bwd_no_dw_adds": ("heads_bwd", ("-DUPNERF_SKIP_DW_ADDS",)),
            "render_train_bwd_no_dw_adds": ("render_train_bwd", ("-DUPNERF_SKIP_DW_ADDS",))}


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
    # ins, trunk W, trunk b, D, skip mask, heads, outs, R, S, L, in0, C, F, flags, stream
    "upnerf_render_train_fwd": ["pp", "pp", "pp", "i", "u", "pp", "pp", "i", "i", "i", "i", "i", "i", "i", "p"],
    # ins, cots, res, trunk W^T, D, skip mask, weights, trunk W, trunk b, recompute heads (the last three null with
    # the saved chain), outs, dW trunk, db trunk, d heads, scratch, dW operand buffers, their layout (the last two
    # null but with DW_OPS), R, S, L, in0, C, F, flags, grid, stream
    "upnerf_render_train_bwd": ["pp", "pp", "pp", "pp", "i", "u", "pp", "pp", "pp", "pp", "pp", "pp", "pp", "pp", "p",
                                "pp", "ip", "i", "i", "i", "i", "i", "i", "i", "i", "p"],
    # sources, their rows, their columns, jobs (11 ints each), job count, workspace, splits, out, weight floats,
    # bias rows, their count, bias floats, accumulate, stream
    "upnerf_dw_gemm": ["pp", "ip", "ip", "ip", "i", "p", "i", "p", "i", "p", "i", "i", "i", "p"],
    # q, k, v, o, bf16 scratch q * scale, k, v (null in float32 mode), G, N, hd, scale, use_bf16, stream
    "upnerf_flash_attn_fwd": ["p", "p", "p", "p", "p", "p", "p", "i", "i", "i", "f", "i", "p"],
    # x0, c_emb, trunk W, trunk b, D, skip mask, heads (null: the trunk alone), outs, N, in0, C, F, use_bf16, stream
    "upnerf_heads_fwd": ["p", "p", "pp", "pp", "i", "u", "pp", "pp", "i", "i", "i", "i", "i", "p"],
    # x0, c_emb, cots, trunk W, trunk b, trunk W^T, D, skip mask, weights (null: the trunk alone), biases, outs,
    # dW trunk, db trunk, d heads, scratch, N, in0, C, F, use_bf16, grid, stream
    "upnerf_heads_bwd": ["p", "p", "pp", "pp", "pp", "pp", "i", "u", "pp", "pp", "pp", "pp", "pp", "pp", "p", "i", "i",
                         "i", "i", "i", "i", "p"],
    # x, packed weights (L layers), bias, out, M, W, L, copies, chain, stream
    "upnerf_mxu_probe": ["p", "p", "p", "p", "i", "i", "i", "i", "i", "p"],
}


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The built library of kernel `name`, loaded once per process, with its C
    functions' argtypes and restype declared (ctypes would otherwise pass
    pointers as 32-bit ints)."""
    lib = ctypes.CDLL(str(build()[name].path))
    kinds = {"p": ctypes.c_void_p, "pp": ctypes.POINTER(ctypes.c_void_p), "i": ctypes.c_int, "u": ctypes.c_uint,
             "f": ctypes.c_float, "ip": ctypes.POINTER(ctypes.c_int)}
    fn_name = f"upnerf_{_source(name)[0]}"
    fn = getattr(lib, fn_name)
    fn.argtypes = [kinds[k] for k in _ARGTYPES[fn_name]]
    fn.restype = ctypes.c_int
    lib.upnerf_error_string.argtypes = [ctypes.c_int]
    lib.upnerf_error_string.restype = ctypes.c_char_p
    return lib
