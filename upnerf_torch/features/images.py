"""Image reading and resizing for the extractors and the scene loader,
without PIL for PNG, JPEG and .npy files.

- `npy_name`: image file name -> .npy artifact name
  (upnerf/data/images.py:66-70).
- `read_rgb_u8`: (H, W, 3) uint8 from a .npy array, an 8-bit non-interlaced
  RGB / RGBA PNG (decoded here with zlib; alpha is dropped, as PIL's
  convert("RGB") drops it) or a JPEG (found by its first bytes, decoded by
  `upnerf_torch.features.jpeg` bit for bit as PIL decodes it; a variant that
  decoder refuses raises). Any other file goes to PIL where PIL is
  installed; otherwise it raises.
- `resize_u8`: PIL's BILINEAR / BICUBIC resize of a uint8 image;
  `resize_lanczos_u8` its LANCZOS resize, which the scene loader's integer
  downscale (upnerf/data/images.py:load_rgb_u8) uses. Both are PIL's own
  two-pass fixed-point resampler written out in numpy (precompute_coeffs,
  22-bit integer weights, the horizontal pass first, a clip to 0..255
  between the passes), the filter swapped: equal to PIL's result.
- `resample_f32` / `resize_float`: PIL's resize of a float ("F") image
  (float64 weights and sums, float32 stored after each pass), on the
  tensor's device: equal to PIL's result.
- `image_wh`: (width, height) of an image file from its PNG or JPEG header,
  without decoding; other formats through PIL where it is installed.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from typing import Tuple

import numpy as np
import torch

from upnerf_torch.features.jpeg import decode_jpeg, jpeg_wh

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"


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
    """(H, W, 3) uint8 image from .npy, PNG, JPEG (found by its bytes, decoded
    here), or (with PIL) any other format PIL reads."""
    if path.lower().endswith(".npy"):
        arr = np.load(path)
        if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[-1] != 3:
            raise ValueError(f"{path}: expected an (H, W, 3) uint8 array, got {arr.dtype} {arr.shape}")
        return arr
    with open(path, "rb") as f:
        head = f.read(8)
        if head[:3] == JPEG_SIGNATURE:
            return decode_jpeg(head + f.read())
    if head == PNG_SIGNATURE:
        try:
            return read_png_rgb(path)
        except NotImplementedError as e:
            return _read_with_pil(path, str(e))
    return _read_with_pil(path, "not a PNG, JPEG or .npy file")


def _bilinear(x: float) -> float:
    """PIL's bilinear_filter (support 1)."""
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def _bicubic(x: float) -> float:
    """PIL's bicubic_filter: Keys' cubic with a = -0.5 (support 2)."""
    x = abs(x)
    if x < 1.0:
        return (1.5 * x - 2.5) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * -0.5
    return 0.0


def _lanczos(x: float) -> float:
    """PIL's lanczos_filter: sinc(x) sinc(x / 3) on [-3, 3) (support 3)."""
    def sinc(v):
        if v == 0.0:
            return 1.0
        v = v * math.pi
        return math.sin(v) / v

    return sinc(x) * sinc(x / 3.0) if -3.0 <= x < 3.0 else 0.0


_FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0), "lanczos": (_lanczos, 3.0)}
_PRECISION_BITS = 22  # PIL's 8-bit resampler: 32 - 8 - 2


def _coeffs(in_size: int, out_size: int, mode: str):
    """PIL's precompute_coeffs over the whole input: (xmin (out,), weights
    (out, ksize) float64, each row normalised to sum 1, zero past its
    window). The filter's support widens by the scale when it shrinks."""
    filt, support = _FILTERS[mode]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    xmins = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [filt((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:  # in order, as C adds them (Python's sum() compensates)
            ww += w
        kk[xx, :xmax] = [w / ww if ww != 0.0 else w for w in k]
        xmins[xx] = xmin
    return xmins, kk


def _pass_u8(img: np.ndarray, axis: int, out_size: int, mode: str) -> np.ndarray:
    """One pass of PIL's 8-bit resampler along `axis` of an (H, W, C) uint8
    image: weights rounded to 22-bit integers (normalize_coeffs_8bpc), sums
    from half, shifted and clipped to 0..255."""
    in_size = img.shape[axis]
    xmins, kk = _coeffs(in_size, out_size, mode)
    scaled = kk * (1 << _PRECISION_BITS)
    kk = np.where(kk < 0, scaled - 0.5, scaled + 0.5).astype(np.int64)  # C's (int) truncates toward zero
    shape = list(img.shape)
    shape[axis] = out_size
    acc = np.full(shape, 1 << (_PRECISION_BITS - 1), np.int64)
    wshape = [1] * img.ndim
    wshape[axis] = out_size
    for x in range(kk.shape[1]):  # weights past a pixel's window are 0, so the clamped index is harmless
        src = np.take(img, np.minimum(xmins + x, in_size - 1), axis=axis).astype(np.int64)
        acc += src * kk[:, x].reshape(wshape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def _resize_u8(image_u8: np.ndarray, w: int, h: int, mode: str) -> np.ndarray:
    """PIL's two-pass 8-bit resize: the horizontal pass first, each pass
    skipped when its size does not change."""
    out = image_u8
    if w != out.shape[1]:
        out = _pass_u8(out, 1, w, mode)
    if h != out.shape[0]:
        out = _pass_u8(out, 0, h, mode)
    return np.ascontiguousarray(out)


def resize_u8(image_u8: np.ndarray, size_hw: Tuple[int, int], mode: str) -> np.ndarray:
    """(H, W, 3) uint8 -> (h, w, 3) uint8, equal to PIL's `resize((w, h),
    Image.BILINEAR)` ("bilinear") or `Image.BICUBIC` ("bicubic")."""
    return _resize_u8(image_u8, size_hw[1], size_hw[0], mode)


def resize_lanczos_u8(image_u8: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """(H, W, 3) uint8 -> (h, w, 3) uint8, equal to PIL's
    `Image.resize((w, h), Image.LANCZOS)`."""
    return _resize_u8(image_u8, size_wh[0], size_wh[1], "lanczos")


def _pass_f32(x: torch.Tensor, axis: int, out_size: int, mode: str) -> torch.Tensor:
    """One pass of PIL's 32-bit float resampler along `axis` (0 or 1) of an
    (H, W, ...) float32 tensor: products and sums in float64 in the window's
    order, the result stored as float32."""
    in_size = x.shape[axis]
    xmins, kk = _coeffs(in_size, out_size, mode)
    shape = [1] * x.dim()
    shape[axis] = out_size
    acc = None
    for t in range(kk.shape[1]):  # a zero weight past a window adds +0.0
        idx = torch.from_numpy(np.minimum(xmins + t, in_size - 1)).to(x.device)
        term = x.index_select(axis, idx).double() * torch.from_numpy(kk[:, t]).to(x.device).reshape(shape)
        acc = term if acc is None else acc + term
    return acc.float()


def resample_f32(x: torch.Tensor, size_hw: Tuple[int, int], mode: str) -> torch.Tensor:
    """(H, W, ...) float32 -> (h, w, ...), each trailing channel resized as
    PIL resizes a mode-"F" image with the `mode` filter, on the tensor's
    device: equal to PIL's result."""
    h, w = size_hw
    out = x.float()
    if w != out.shape[1]:
        out = _pass_f32(out, 1, w, mode)
    if h != out.shape[0]:
        out = _pass_f32(out, 0, h, mode)
    return out.contiguous()


def image_wh(path: str) -> Tuple[int, int]:
    """(width, height) of an image file without decoding it: a PNG's from its
    IHDR chunk, a JPEG's from its frame header, a .npy array's from its
    shape; other formats through PIL."""
    if path.lower().endswith(".npy"):
        h, w = np.load(path, mmap_mode="r").shape[:2]
        return int(w), int(h)
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] == PNG_SIGNATURE and head[12:16] == b"IHDR":
        return struct.unpack(">II", head[16:24])
    if head[:3] == JPEG_SIGNATURE:
        return jpeg_wh(path)
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(f"cannot read the size of {path}: not a PNG, JPEG or .npy file, and PIL is not"
                           " installed") from None
    with Image.open(path) as img:
        return img.size


def resize_float(x: torch.Tensor, size_hw: Tuple[int, int]) -> torch.Tensor:
    """(H, W) float32 -> (h, w), PIL's BICUBIC resize of an "F" image."""
    return resample_f32(x, size_hw, "bicubic")
