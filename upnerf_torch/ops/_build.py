"""Build and load the package's CUDA kernels.

At first use, `nvcc` compiles every `upnerf_torch/csrc/*.cu` into one shared
library with a plain C interface, for sm_90a (Hopper), into
`build/upnerf_torch_kernels/` at the repository root; the library is loaded
with ctypes. The file name carries a hash of the sources and flags, so an
edited source is rebuilt and a stale library is never loaded. Building takes
seconds: no source includes PyTorch's headers.
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
from typing import NamedTuple

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "upnerf_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


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


@functools.lru_cache(maxsize=None)
def build() -> BuildInfo:
    """Compile csrc/*.cu once per source hash; return the library's path."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"libupnerf_torch_kernels_{digest.hexdigest()[:16]}.so"
    if out.is_file():
        return BuildInfo(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp)] + [str(s) for s in sorted(CSRC_DIR.glob("*.cu"))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    return BuildInfo(out, seconds, log)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process, with every C
    function's argtypes and restype declared (ctypes would otherwise pass
    pointers as 32-bit ints)."""
    lib = ctypes.CDLL(str(build().path))
    vp, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    fn = lib.upnerf_render_train_fwd
    fn.argtypes = [
        vp, vp, vp, vp, vp,  # rays_o, rays_d, z_vals, pe_w, ray_cond
        ctypes.POINTER(vp), ctypes.POINTER(vp), i32, u32,  # trunk W, trunk b, D, skip mask
        vp, vp, vp, vp, vp, vp, vp, vp, vp,  # xyzf W/b, sigma W/b, feat W/b, rgb1 W, rgb2 W/b
        vp, vp, vp,  # s_weights, s_depth, rgb_map
        i32, i32, i32, i32, i32, i32, i32,  # R, S, L, W, F, HH, bf16
        vp,  # stream
    ]
    fn.restype = i32
    lib.upnerf_error_string.argtypes = [i32]
    lib.upnerf_error_string.restype = ctypes.c_char_p
    return lib
