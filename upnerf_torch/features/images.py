"""Image reading and resizing for the extractors, without PIL where it can.

- `npy_name`: image file name -> .npy artifact name
  (upnerf/data/images.py:66-70).
- `read_rgb_u8`: (H, W, 3) uint8 from a .npy array or an 8-bit
  non-interlaced RGB / RGBA PNG (decoded here with zlib; alpha is dropped,
  as PIL's convert("RGB") drops it). Any other file goes to PIL where PIL is
  installed; otherwise it raises.
- `resize_u8`: PIL's bilinear / bicubic resize of a uint8 image, by torch's
  uint8 path on the CPU (antialias=True: PIL's filters, support widened when
  shrinking, a = -0.5). It agrees with PIL within 1 LSB on under 1% of
  values; resizing as float and rounding does not (PIL clips between its two
  passes).
- `resize_float`: PIL's bicubic resize of a float ("F") image, on the
  tensor's device.
- `resize_lanczos_u8`: PIL's LANCZOS resize of a uint8 image, PIL's own
  two-pass fixed-point resampler written out in numpy (support 3, 22-bit
  integer coefficients, horizontal pass first, a clip to 0..255 between the
  passes): equal to PIL's result. The scene loader's integer downscale
  (upnerf/data/images.py:load_rgb_u8) uses it.
- `image_wh`: (width, height) of an image file from its PNG header, without
  decoding; other formats through PIL where it is installed.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def npy_name(image_name: str) -> str:
    """image file name -> .npy artifact name."""
    stem, _ = os.path.splitext(os.path.basename(image_name))
    return stem + ".npy"


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline PNG filters (0 None, 1 Sub, 2 Up, 3 Average,
    4 Paeth); returns (h, w * bpp) uint8."""
    stride = w * bpp
    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG pixel stream is {len(raw)} bytes, expected {h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:
            cur = np.cumsum(line.reshape(w, bpp).astype(np.int64), axis=0).astype(np.uint8).reshape(stride)
        elif ftype == 2:
            cur = line + prior
        elif ftype in (3, 4):
            cur_b = bytearray(line.tobytes())
            up = prior.tobytes()
            for i in range(stride):
                left = cur_b[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
                cur_b[i] = (cur_b[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur_b), np.uint8)
        else:
            raise ValueError(f"PNG filter type {ftype} is not one of 0-4")
        out[y] = cur
        prior = cur
    return out


def read_png_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 from an 8-bit non-interlaced RGB or RGBA PNG; raises
    NotImplementedError for any other PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path} is not a PNG")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in (2, 6) or interlace != 0:
        raise NotImplementedError(
            f"{path}: PNG with bit depth {depth}, color type {color}, interlace {interlace}"
            " (only 8-bit non-interlaced RGB or RGBA is decoded without PIL)"
        )
    bpp = 3 if color == 2 else 4
    pixels = _unfilter(zlib.decompress(b"".join(idat)), h, w, bpp).reshape(h, w, bpp)
    return np.ascontiguousarray(pixels[..., :3])


def write_png(path: str, rgb: np.ndarray) -> None:
    """(H, W, 3) uint8 -> 8-bit RGB PNG (filter 0 on every row)."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def _read_with_pil(path: str, why: str) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(f"cannot read {path}: {why}, and PIL is not installed") from None
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), np.uint8)


def read_rgb_u8(path: str) -> np.ndarray:
    """(H, W, 3) uint8 image from .npy, PNG, or (with PIL) any format PIL
    reads."""
    if path.lower().endswith(".npy"):
        arr = np.load(path)
        if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[-1] != 3:
            raise ValueError(f"{path}: expected an (H, W, 3) uint8 array, got {arr.dtype} {arr.shape}")
        return arr
    with open(path, "rb") as f:
        is_png = f.read(8) == PNG_SIGNATURE
    if is_png:
        try:
            return read_png_rgb(path)
        except NotImplementedError as e:
            return _read_with_pil(path, str(e))
    return _read_with_pil(path, "not a PNG or .npy file")


def resize_u8(image_u8: np.ndarray, size_hw: Tuple[int, int], mode: str) -> np.ndarray:
    """(H, W, 3) uint8 -> (h, w, 3) uint8, PIL's BILINEAR ("bilinear") or
    BICUBIC ("bicubic") resize, on the CPU."""
    x = torch.from_numpy(np.ascontiguousarray(image_u8)).permute(2, 0, 1)[None]
    y = F.interpolate(x, size=tuple(size_hw), mode=mode, antialias=True, align_corners=False)
    return y[0].permute(1, 2, 0).contiguous().numpy()


_PRECISION_BITS = 22  # PIL's 8-bit resampler: 32 - 8 - 2


def _lanczos(x: float) -> float:
    """PIL's lanczos_filter: sinc(x) sinc(x / 3) on [-3, 3)."""
    def sinc(v):
        if v == 0.0:
            return 1.0
        v = v * math.pi
        return math.sin(v) / v

    return sinc(x) * sinc(x / 3.0) if -3.0 <= x < 3.0 else 0.0


def _lanczos_coeffs(in_size: int, out_size: int):
    """PIL's precompute_coeffs + normalize_coeffs_8bpc for the whole input
    range: (xmin (out,), fixed-point weights (out, ksize) int64)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 3.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    xmins = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = sum(k)
        for x, w in enumerate(k):
            w = w / ww if ww != 0.0 else w
            kk[xx, x] = int(w * (1 << _PRECISION_BITS) + (-0.5 if w < 0 else 0.5))
        xmins[xx] = xmin
    return xmins, kk


def _lanczos_pass(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One pass of PIL's 8-bit resampler along `axis` of an (H, W, C) uint8 image."""
    in_size = img.shape[axis]
    xmins, kk = _lanczos_coeffs(in_size, out_size)
    shape = list(img.shape)
    shape[axis] = out_size
    acc = np.full(shape, 1 << (_PRECISION_BITS - 1), np.int64)
    wshape = [1, 1, 1]
    wshape[axis] = out_size
    for x in range(kk.shape[1]):  # weights past a pixel's window are 0, so the clamped index is harmless
        src = np.take(img, np.minimum(xmins + x, in_size - 1), axis=axis).astype(np.int64)
        acc += src * kk[:, x].reshape(wshape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_lanczos_u8(image_u8: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """(H, W, 3) uint8 -> (h, w, 3) uint8, equal to PIL's
    `Image.resize((w, h), Image.LANCZOS)`."""
    w, h = size_wh
    out = image_u8
    if w != out.shape[1]:
        out = _lanczos_pass(out, 1, w)
    if h != out.shape[0]:
        out = _lanczos_pass(out, 0, h)
    return np.ascontiguousarray(out)


def image_wh(path: str) -> Tuple[int, int]:
    """(width, height) of an image file: a PNG's from its IHDR chunk, a .npy
    array's from its shape, other formats through PIL."""
    if path.lower().endswith(".npy"):
        h, w = np.load(path, mmap_mode="r").shape[:2]
        return int(w), int(h)
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] == PNG_SIGNATURE and head[12:16] == b"IHDR":
        return struct.unpack(">II", head[16:24])
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(f"cannot read the size of {path}: not a PNG or .npy file, and PIL is not installed"
                           ) from None
    with Image.open(path) as img:
        return img.size


def resize_float(x: torch.Tensor, size_hw: Tuple[int, int]) -> torch.Tensor:
    """(H, W) float32 -> (h, w), PIL's BICUBIC resize of an "F" image."""
    y = F.interpolate(x[None, None], size=tuple(size_hw), mode="bicubic", antialias=True, align_corners=False)
    return y[0, 0]
