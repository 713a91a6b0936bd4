"""JPEG decoding and encoding in numpy and the standard library, bit for bit
with PIL's libjpeg-turbo.

- `decode_jpeg(data)`: (H, W, 3) uint8, equal to
  `np.asarray(Image.open(f).convert("RGB"))`. Baseline (SOF0), extended
  8-bit Huffman (SOF1) and progressive (SOF2: spectral selection, successive
  approximation, EOB runs) files of one (grey, replicated to RGB) or three
  components (YCbCr, or RGB under an Adobe APP14 marker with transform 0),
  luma sampled 1 or 2 times each way over 1 x 1 chroma, restart intervals,
  Huffman and quantisation tables (8- or 16-bit) defined anywhere. APPn and
  COM segments are skipped; EXIF orientation is not applied (PIL's `open`
  does not apply it). Arithmetic coding, lossless and hierarchical frames,
  12-bit samples, four components and any other sampling layout raise
  NotImplementedError; truncated data raise ValueError.
- `encode_jpeg(rgb, quality)` / `write_jpeg(path, rgb, quality)`: baseline
  4:2:0 with the standard Huffman tables, the bytes of
  `Image.fromarray(rgb).save(f, "JPEG", quality=quality)`.
- `jpeg_wh(path)`: (width, height) from the SOF header, without decoding.

The arithmetic is libjpeg's, as its public routines write it: the islow
inverse DCT (jidctint.c, CONST_BITS 13, PASS1_BITS 2; its output saturated
as libjpeg-turbo's SIMD routine saturates it), fancy upsampling (jdsample.c: h2v1, h2v2, h1v2, with
the image's first and last rows and columns replicated; plain replication
where the chroma is 2 samples wide or less), the YCbCr -> RGB tables
(jdcolor.c), and for the encoder the RGB -> YCbCr tables (jccolor.c), the
h2v2 downsample with its alternating bias (jcsample.c), the edge padding and
dummy blocks of a partial MCU (jcprepct.c, jccoefct.c), the islow forward
DCT (jfdctint.c), the rounded quantisation (jcdctmgr.c) and the quality
scaling (jcparam.c). Dequantisation, both DCTs, resampling and colour
conversion run over all blocks at once in numpy integers; only the entropy
coding is a Python loop (decode) or a vectorised bit packing (encode).
Files an 8-bit encoder writes never leave 16-bit intermediates; a corrupt
file whose dequantised coefficients do (16-bit quantisation tables at their
extremes) can decode otherwise than libjpeg-turbo's SIMD routine, which
computes in 16-bit lanes.
"""

from __future__ import annotations

import re
import struct
from array import array
from typing import Dict, List, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# tables

# zigzag index k -> natural (row * 8 + col) index (jutils.c: jpeg_natural_order)
NATURAL_ORDER = np.array(
    [r * 8 + (s - r) for s in range(15)
     for r in (range(max(0, s - 7), min(s, 7) + 1) if s % 2 else range(min(s, 7), max(0, s - 7) - 1, -1))],
    np.int64)

# jcparam.c: std_luminance_quant_tbl / std_chrominance_quant_tbl, natural order
_STD_QUANT = (
    np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
              14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
              18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
              49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64),
    np.array([17, 18, 24, 47] + [99] * 4 + [18, 21, 26, 66] + [99] * 4 + [24, 26, 56] + [99] * 5
             + [47, 66] + [99] * 38, np.int64),
)

# jcparam.c: the standard Huffman tables (bits[1..16] + values), DC / AC x luminance / chrominance
_STD_HUFF = {
    (0, 0): bytes.fromhex("00010501010101010100000000000000" "000102030405060708090a0b"),
    (1, 0): bytes.fromhex(
        "0002010303020403050504040000017d"
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a25262728292a3435"
        "363738393a434445464748494a535455565758595a636465666768696a737475767778797a838485868788898a92939495969798"
        "999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4"
        "f5f6f7f8f9fa"),
    (0, 1): bytes.fromhex("00030101010101010101010000000000" "000102030405060708090a0b"),
    (1, 1): bytes.fromhex(
        "00020102040403040705040400010277"
        "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f11718191a262728292a"
        "35363738393a434445464748494a535455565758595a636465666768696a737475767778797a82838485868788898a9293949596"
        "9798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4"
        "f5f6f7f8f9fa"),
}

# jidctint.c / jfdctint.c constants, CONST_BITS 13
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _ycc_tables():
    """jdcolor.c: build_ycc_rgb_table (SCALEBITS 16)."""
    x = np.arange(256, dtype=np.int64) - 128
    fix = lambda v: int(v * 65536 + 0.5)  # noqa: E731
    cr_r = (fix(1.40200) * x + 32768) >> 16
    cb_b = (fix(1.77200) * x + 32768) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + 32768
    return cr_r, cb_b, cr_g, cb_g


_YCC = _ycc_tables()

# ---------------------------------------------------------------------------
# decoding


def _huff_codes(bits: bytes) -> List[Tuple[int, int]]:
    """(code, length) of each value in order, from the 16 counts (JPEG Annex C)."""
    out, code = [], 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out.append((code, length))
            code += 1
        code <<= 1
    return out


def _lookup(bits: bytes, vals: bytes) -> list:
    """A 16-bit lookahead table: entry (value << 5) | code length for every
    16-bit window whose leading bits are a code. A window that starts no code
    reads as value 0 of length 16 (libjpeg substitutes a zero for a bad code)."""
    tab = np.full(1 << 16, 16, np.int64)
    for (code, length), v in zip(_huff_codes(bits), vals):
        lo = code << (16 - length)
        tab[lo : lo + (1 << (16 - length))] = (v << 5) | length
    return tab.tolist()


def _u16(b: bytes, i: int) -> int:
    return (b[i] << 8) | b[i + 1]


_SCAN_END = re.compile(rb"\xff[^\x00\xd0-\xd7\xff]")
_RST = re.compile(rb"\xff+[\xd0-\xd7]")
_PAD = bytes(8)


def _pieces(raw: bytes) -> List[bytes]:
    """An entropy-coded segment split at its restart markers, each piece with
    fill bytes and byte stuffing removed and zeros appended (libjpeg reads
    zeros past the end of a segment)."""
    out = []
    for piece in _RST.split(raw):
        out.append(piece.rstrip(b"\xff").replace(b"\xff\x00", b"\xff") + _PAD)
    return out


class _Comp:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.qt = None  # latched at the component's first scan, as libjpeg latches it


def _seq_scan(buf, mcus, co, pred):
    """Sequential Huffman scan over `mcus` (lists of (component, offset, DC
    table, AC table)); coefficients land in zigzag order at offset + k."""
    acc = n = p = 0
    for mcu in mcus:
        for ci, base, dct, act in mcu:
            if n < 32:
                acc = ((acc & ((1 << n) - 1)) << 48) | int.from_bytes(buf[p : p + 6], "big")
                p += 6
                n += 48
            e = dct[(acc >> (n - 16)) & 0xFFFF]
            n -= e & 31
            s = e >> 5
            if s:
                n -= s
                v = (acc >> n) & ((1 << s) - 1)
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                pred[ci] += v
            c = co[ci]
            c[base] = pred[ci]
            k = 1
            while k < 64:
                if n < 32:
                    acc = ((acc & ((1 << n) - 1)) << 48) | int.from_bytes(buf[p : p + 6], "big")
                    p += 6
                    n += 48
                e = act[(acc >> (n - 16)) & 0xFFFF]
                n -= e & 31
                rs = e >> 5
                s = rs & 15
                if s:
                    k += rs >> 4
                    n -= s
                    v = (acc >> n) & ((1 << s) - 1)
                    if v < (1 << (s - 1)):
                        v -= (1 << s) - 1
                    if k < 64:
                        c[base + k] = v
                    k += 1
                elif rs == 0xF0:
                    k += 16
                else:
                    break


def _dc_first(buf, mcus, co, pred, al):
    acc = n = p = 0
    for mcu in mcus:
        for ci, base, dct, _ in mcu:
            if n < 32:
                acc = ((acc & ((1 << n) - 1)) << 48) | int.from_bytes(buf[p : p + 6], "big")
                p += 6
                n += 48
            e = dct[(acc >> (n - 16)) & 0xFFFF]
            n -= e & 31
            s = e >> 5
            if s:
                n -= s
                v = (acc >> n) & ((1 << s) - 1)
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                pred[ci] += v
            co[ci][base] = pred[ci] << al


def _dc_refine(buf, mcus, co, al):
    acc = n = p = 0
    p1 = 1 << al
    for mcu in mcus:
        for ci, base, _, _ in mcu:
            if n < 1:
                acc = int.from_bytes(buf[p : p + 6], "big")
                p += 6
                n = 48
            n -= 1
            if (acc >> n) & 1:
                co[ci][base] |= p1


def _ac_first(buf, mcus, co, ss, se, al, eobrun):
    acc = n = p = 0
    for mcu in mcus:
        for ci, base, _, act in mcu:
            if eobrun:
                eobrun -= 1
                continue
            c = co[ci]
            k = ss
            while k <= se:
                if n < 32:
                    acc = ((acc & ((1 << n) - 1)) << 48) | int.from_bytes(buf[p : p + 6], "big")
                    p += 6
                    n += 48
                e = act[(acc >> (n - 16)) & 0xFFFF]
                n -= e & 31
                rs = e >> 5
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    n -= s
                    v = (acc >> n) & ((1 << s) - 1)
                    if v < (1 << (s - 1)):
                        v -= (1 << s) - 1
                    if k < 64:
                        c[base + k] = v * (1 << al)
                    k += 1
                elif r == 15:
                    k += 16
                else:
                    eobrun = 1 << r
                    if r:
                        n -= r
                        eobrun += (acc >> n) & ((1 << r) - 1)
                    eobrun -= 1
                    break
    return eobrun


def _ac_refine(buf, mcus, co, ss, se, al, eobrun):
    """jdphuff.c: decode_mcu_AC_refine, one block per MCU."""
    acc = n = p = 0
    p1, m1 = 1 << al, -1 << al

    def bit():
        nonlocal acc, n, p
        if n < 1:
            acc = int.from_bytes(buf[p : p + 6], "big")
            p += 6
            n = 48
        n -= 1
        return (acc >> n) & 1

    for mcu in mcus:
        for ci, base, _, act in mcu:
            c = co[ci]
            k = ss
            if not eobrun:
                while k <= se:
                    if n < 32:
                        acc = ((acc & ((1 << n) - 1)) << 48) | int.from_bytes(buf[p : p + 6], "big")
                        p += 6
                        n += 48
                    e = act[(acc >> (n - 16)) & 0xFFFF]
                    n -= e & 31
                    rs = e >> 5
                    r, s = rs >> 4, rs & 15
                    if s:
                        n -= 1
                        s = p1 if (acc >> n) & 1 else m1
                    elif r != 15:
                        eobrun = 1 << r
                        if r:
                            n -= r
                            eobrun += (acc >> n) & ((1 << r) - 1)
                        break
                    # skip r zero coefficients, appending a correction bit to each nonzero one passed
                    while k <= se:
                        cur = c[base + k]
                        if cur:
                            if bit() and not (cur & p1):
                                c[base + k] = cur + (p1 if cur >= 0 else m1)
                        else:
                            r -= 1
                            if r < 0:
                                break
                        k += 1
                    if s and k < 64:
                        c[base + k] = s
                    k += 1
            if eobrun:
                while k <= se:
                    cur = c[base + k]
                    if cur and bit() and not (cur & p1):
                        c[base + k] = cur + (p1 if cur >= 0 else m1)
                    k += 1
                eobrun -= 1
    return eobrun


def _idct_1d(d, shift: int):
    """One pass of jidctint.c's islow IDCT over the 8 frequency arrays `d`,
    descaled by `shift` (DESCALE: add half, arithmetic shift)."""
    z1 = (d[2] + d[6]) * _F0541
    tmp2 = z1 - d[6] * _F1847
    tmp3 = z1 + d[2] * _F0765
    tmp0 = (d[0] + d[4]) << 13
    tmp1 = (d[0] - d[4]) << 13
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * _F1175
    o0, o1, o2, o3 = o0 * _F0298, o1 * _F2053, o2 * _F3072, o3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    o0 += z1 + z3
    o1 += z2 + z4
    o2 += z2 + z3
    o3 += z1 + z4
    half = 1 << (shift - 1)
    outs = (t10 + o3, t11 + o2, t12 + o1, t13 + o0, t13 - o0, t12 - o1, t11 - o2, t10 - o3)
    return [(v + half) >> shift for v in outs]


def _idct_blocks(coef: np.ndarray) -> np.ndarray:
    """(N, 8, 8) dequantised coefficients (natural order, int64) -> (N, 8, 8)
    uint8 samples: columns first into the workspace, then rows, then + 128
    with the result saturated to 0..255. libjpeg's C routine indexes its
    range-limit table with `& 1023`, which clips the same way within +-512
    and wraps past it; libjpeg-turbo's x86 SIMD routine, which PIL's build
    runs, saturates, and so does this one (a stream with corrupt DC values
    reaches past 512: tests/test_torch_jpeg.py)."""
    ws = np.stack(_idct_1d([coef[:, u, :] for u in range(8)], 11), axis=1)  # pass 1: per column
    out = np.stack(_idct_1d([ws[:, :, u] for u in range(8)], 18), axis=2)  # pass 2: per row
    return (np.clip(out, -128, 127) + 128).astype(np.uint8)


def _upsample(x: np.ndarray, hr: int, vr: int) -> np.ndarray:
    """jdsample.c on one (h, w) component plane: fancy h2v1 / h2v2 when the
    plane is over 2 samples wide, fancy h1v2, plain replication otherwise."""
    x = x.astype(np.int32)
    fancy = (hr, vr) == (1, 2) or x.shape[1] > 2
    if (hr, vr) == (1, 1):
        return x
    if not fancy:
        return np.repeat(np.repeat(x, vr, axis=0), hr, axis=1)
    if vr == 2:  # vertical 3:1 triangle with the image's edge rows replicated
        up = np.concatenate([x[:1], x[:-1]])
        down = np.concatenate([x[1:], x[-1:]])
        if hr == 1:
            rows = [(3 * x + up + 1) >> 2, (3 * x + down + 2) >> 2]
            return np.stack(rows, axis=1).reshape(2 * x.shape[0], x.shape[1])
        sums = np.stack([3 * x + up, 3 * x + down], axis=1).reshape(2 * x.shape[0], x.shape[1])
        left = np.concatenate([sums[:, :1], sums[:, :-1]], axis=1)
        right = np.concatenate([sums[:, 1:], sums[:, -1:]], axis=1)
        cols = [(3 * sums + left + 8) >> 4, (3 * sums + right + 7) >> 4]
    else:  # h2v1
        left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
        right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
        cols = [(3 * x + left + 1) >> 2, (3 * x + right + 2) >> 2]
    h, w = cols[0].shape
    return np.stack(cols, axis=2).reshape(h, 2 * w)


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c: ycc_rgb_convert; green takes one shift over both terms."""
    cr_r, cb_b, cr_g, cb_g = _YCC
    y = y.astype(np.int64)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


_ARITH = {0xC9: "arithmetic-coded sequential", 0xCA: "arithmetic-coded progressive",
          0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded differential sequential",
          0xCE: "arithmetic-coded differential progressive", 0xCF: "arithmetic-coded differential lossless",
          0xCC: "arithmetic coding (DAC)", 0xC3: "lossless (SOF3)", 0xC5: "differential sequential (SOF5)",
          0xC6: "differential progressive (SOF6)", 0xC7: "differential lossless (SOF7)"}


class _Decoder:
    def __init__(self, data: bytes):
        self.data = data
        self.qt: Dict[int, np.ndarray] = {}
        self.huff: Dict[Tuple[int, int], list] = {}
        self.restart = 0
        self.comps: List[_Comp] = []
        self.jfif = False
        self.adobe = None
        self.progressive = False
        self.scans = 0

    # -- segments

    def frame(self, marker: int, seg: bytes) -> None:
        if self.comps:
            raise ValueError("JPEG: a second frame header")
        precision, height, width, nc = seg[0], _u16(seg, 1), _u16(seg, 3), seg[5]
        if precision != 8:
            raise NotImplementedError(f"JPEG with {precision}-bit samples (only 8-bit is decoded)")
        if nc not in (1, 3):
            raise NotImplementedError(f"JPEG with {nc} components (CMYK / YCCK and others are not decoded)")
        if height == 0 or width == 0:
            raise NotImplementedError("JPEG with its height defined by a DNL marker")
        self.H, self.W, self.progressive = height, width, marker == 0xC2
        for i in range(nc):
            cid, hv, tq = seg[6 + 3 * i], seg[7 + 3 * i], seg[8 + 3 * i]
            self.comps.append(_Comp(cid, hv >> 4, hv & 15, tq))
        hs, vs = [c.h for c in self.comps], [c.v for c in self.comps]
        if nc == 3 and not (hs[0] in (1, 2) and vs[0] in (1, 2) and hs[1:] == [1, 1] and vs[1:] == [1, 1]):
            raise NotImplementedError(f"JPEG sampling layout {list(zip(hs, vs))} (luma 1 or 2 each way over"
                                      " 1 x 1 chroma is decoded)")
        self.mh, self.mv = max(hs), max(vs)
        self.mcu_cols = -(-width // (8 * self.mh))
        self.mcu_rows = -(-height // (8 * self.mv))
        for c in self.comps:
            c.wd = -(-width * c.h // self.mh)  # downsampled size
            c.hd = -(-height * c.v // self.mv)
            c.bw, c.bh = -(-c.wd // 8), -(-c.hd // 8)  # blocks holding image samples
            c.gw = max(c.bw, self.mcu_cols * c.h) if nc > 1 else c.bw  # the stored grid (MCU-padded)
            c.gh = max(c.bh, self.mcu_rows * c.v) if nc > 1 else c.bh
            c.co = array("i", bytes(4 * 64 * c.gw * c.gh))

    def dqt(self, seg: bytes) -> None:
        i = 0
        while i < len(seg):
            pq, tq = seg[i] >> 4, seg[i] & 15
            if pq:
                self.qt[tq] = np.frombuffer(seg[i + 1 : i + 129], ">u2").astype(np.int64)
                i += 129
            else:
                self.qt[tq] = np.frombuffer(seg[i + 1 : i + 65], np.uint8).astype(np.int64)
                i += 65

    def dht(self, seg: bytes) -> None:
        i = 0
        while i < len(seg):
            tc, th = seg[i] >> 4, seg[i] & 15
            bits = seg[i + 1 : i + 17]
            n = sum(bits)
            self.huff[(tc, th)] = _lookup(bits, seg[i + 17 : i + 17 + n])
            i += 17 + n

    def scan(self, seg: bytes, pos: int) -> int:
        """Decode one scan whose entropy-coded data start at pos; returns the
        position of the marker that ends them."""
        if not self.comps:
            raise ValueError("JPEG: a scan before the frame header")
        ns = seg[0]
        comps = []
        for i in range(ns):
            cid, tables = seg[1 + 2 * i], seg[2 + 2 * i]
            ci = next(j for j, c in enumerate(self.comps) if c.id == cid)
            comps.append((ci, tables >> 4, tables & 15))
        ss, se, ah, al = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns] >> 4, seg[3 + 2 * ns] & 15
        end = _SCAN_END.search(self.data, pos)
        if end is None:
            raise ValueError("JPEG data are truncated (a scan runs to the end of the file)")
        end = end.start()
        for ci, _, _ in comps:
            c = self.comps[ci]
            if c.qt is None:
                if c.tq not in self.qt:
                    raise ValueError(f"JPEG: quantisation table {c.tq} is not defined")
                c.qt = self.qt[c.tq]

        sequential = not self.progressive
        if sequential and (ss, se, ah, al) != (0, 63, 0, 0):
            raise ValueError(f"JPEG: a sequential scan with Ss={ss} Se={se} Ah={ah} Al={al}")

        def table(tc: int, th: int):
            """The lookahead table of (class, id), if this scan reads it."""
            if not sequential and ((ss == 0 and tc == 1) or (ss > 0 and tc == 0) or (ss == 0 and ah)):
                return None
            if (tc, th) not in self.huff:
                raise ValueError(f"JPEG: Huffman table {('DC', 'AC')[tc]} {th} is not defined")
            return self.huff[(tc, th)]

        if ns == 1:  # non-interleaved: one block an MCU over the component's own blocks
            ci, td, ta = comps[0]
            c = self.comps[ci]
            dct, act = table(0, td), table(1, ta)
            mcus = [[(ci, (r * c.gw + x) * 64, dct, act)] for r in range(c.bh) for x in range(c.bw)]
        else:
            layout = []
            for ci, td, ta in comps:
                c = self.comps[ci]
                for y in range(c.v):
                    for x in range(c.h):
                        layout.append((ci, y, x, c, table(0, td), table(1, ta)))
            mcus = [[(ci, ((my * c.v + y) * c.gw + mx * c.h + x) * 64, dct, act) for ci, y, x, c, dct, act in layout]
                    for my in range(self.mcu_rows) for mx in range(self.mcu_cols)]
        pieces = _pieces(self.data[pos:end])
        ri = self.restart or len(mcus)
        groups = [mcus[i : i + ri] for i in range(0, len(mcus), ri)]
        pieces += [_PAD] * (len(groups) - len(pieces))
        co = [c.co for c in self.comps]
        for buf, group in zip(pieces, groups):
            pred = [0] * len(self.comps)  # the DC predictors and the EOB run restart at each marker
            if sequential:
                _seq_scan(buf, group, co, pred)
            elif ss == 0:
                if ah:
                    _dc_refine(buf, group, co, al)
                else:
                    _dc_first(buf, group, co, pred, al)
            elif ah:
                _ac_refine(buf, group, co, ss, se, al, 0)
            else:
                _ac_first(buf, group, co, ss, se, al, 0)
        self.scans += 1
        return end

    # -- output

    def planes(self) -> List[np.ndarray]:
        out = []
        for c in self.comps:
            if c.qt is None:
                raise ValueError("JPEG: a component no scan holds")
            co = np.frombuffer(c.co, np.int32).reshape(c.gh, c.gw, 64)[: c.bh, : c.bw].reshape(-1, 64)
            nat = np.zeros_like(co, dtype=np.int64)
            nat[:, NATURAL_ORDER] = co.astype(np.int64) * c.qt  # dequantise in zigzag order, then unzigzag
            blocks = _idct_blocks(nat.reshape(-1, 8, 8))
            plane = blocks.reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)
            out.append(plane[: c.hd, : c.wd])
        return out

    def rgb(self) -> np.ndarray:
        planes = self.planes()
        H, W = self.H, self.W
        if len(planes) == 1:
            return np.repeat(planes[0][:, :, None], 3, axis=2)
        full = [_upsample(p, self.mh // c.h, self.mv // c.v)[:H, :W] for p, c in zip(planes, self.comps)]
        if self.jfif:
            rgb_space = False
        elif self.adobe is not None:
            rgb_space = self.adobe == 0
        else:
            rgb_space = [c.id for c in self.comps] == [82, 71, 66]  # 'R', 'G', 'B'
        if rgb_space:
            return np.stack(full, -1).astype(np.uint8)
        return _ycc_to_rgb(*full)


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8, PIL's `Image.open(f).convert("RGB")`."""
    if data[:3] != b"\xff\xd8\xff":
        raise ValueError("not a JPEG (no SOI marker)")
    dec = _Decoder(data)
    pos, n = 2, len(data)
    while True:
        while pos < n and data[pos] != 0xFF:  # libjpeg skips extraneous bytes before a marker
            pos += 1
        while pos < n and data[pos] == 0xFF:  # fill bytes
            pos += 1
        if pos >= n:
            if dec.scans:
                break  # the last scan ended at its marker but no EOI follows
            raise ValueError("JPEG data are truncated (no scan)")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            break
        if marker in (0x01, 0xD8) or 0xD0 <= marker <= 0xD7:
            continue
        if pos + 2 > n or pos + _u16(data, pos) > n:
            raise ValueError("JPEG data are truncated (in a marker segment)")
        seg = data[pos + 2 : pos + _u16(data, pos)]
        pos += _u16(data, pos)
        if marker in _ARITH:
            raise NotImplementedError(f"JPEG: {_ARITH[marker]} is not decoded")
        if marker in (0xC0, 0xC1, 0xC2):
            dec.frame(marker, seg)
        elif marker == 0xC4:
            dec.dht(seg)
        elif marker == 0xDB:
            dec.dqt(seg)
        elif marker == 0xDD:
            dec.restart = _u16(seg, 0)
        elif marker == 0xDA:
            pos = dec.scan(seg, pos)
        elif marker == 0xE0 and seg[:5] == b"JFIF\x00" and len(seg) >= 14:
            dec.jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            dec.adobe = seg[11]
    if not dec.scans:
        raise ValueError("JPEG: no scan")
    return dec.rgb()


def jpeg_wh(path: str) -> Tuple[int, int]:
    """(width, height) of a JPEG file from its frame header."""
    with open(path, "rb") as f:
        if f.read(2) != b"\xff\xd8":
            raise ValueError(f"{path} is not a JPEG")
        while True:
            b = f.read(1)
            if not b:
                raise ValueError(f"{path}: no frame header")
            if b != b"\xff":
                continue
            m = f.read(1)
            while m == b"\xff":
                m = f.read(1)
            if not m:
                raise ValueError(f"{path}: no frame header")
            marker = m[0]
            if marker in (0x01, 0xD8) or 0xD0 <= marker <= 0xD7:
                continue
            (length,) = struct.unpack(">H", f.read(2))
            if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
                _, h, w = struct.unpack(">BHH", f.read(5))
                return w, h
            f.seek(length - 2, 1)


# ---------------------------------------------------------------------------
# encoding


def quant_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """jcparam.c: jpeg_set_quality(quality, force_baseline=TRUE); natural order."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in _STD_QUANT)


def _rgb_to_ycc(rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """jccolor.c: rgb_ycc_convert (SCALEBITS 16; Cb / Cr with 0.5 - epsilon rounding)."""
    fix = lambda v: int(v * 65536 + 0.5)  # noqa: E731
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, off = 1 << 15, 128 << 16
    y = (fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + off + half - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + off + half - 1) >> 16
    return y, cb, cr


def _pad_edge(x: np.ndarray, rows: int, cols: int) -> np.ndarray:
    return np.pad(x, ((0, rows - x.shape[0]), (0, cols - x.shape[1])), mode="edge")


def _fdct_1d(d, last: bool):
    """One pass of jfdctint.c's islow forward DCT over the 8 sample arrays
    `d`; the row pass keeps PASS1_BITS of scale, the column pass removes it."""
    t0, t7 = d[0] + d[7], d[0] - d[7]
    t1, t6 = d[1] + d[6], d[1] - d[6]
    t2, t5 = d[2] + d[5], d[2] - d[5]
    t3, t4 = d[3] + d[4], d[3] - d[4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    sh = 13 + 2 if last else 13 - 2
    ds = lambda v, s: (v + (1 << (s - 1))) >> s  # noqa: E731
    out = [None] * 8
    if last:
        out[0], out[4] = ds(t10 + t11, 2), ds(t10 - t11, 2)
    else:
        out[0], out[4] = (t10 + t11) << 2, (t10 - t11) << 2
    z1 = (t12 + t13) * _F0541
    out[2] = ds(z1 + t13 * _F0765, sh)
    out[6] = ds(z1 - t12 * _F1847, sh)
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * _F1175
    t4, t5, t6, t7 = t4 * _F0298, t5 * _F2053, t6 * _F3072, t7 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    out[7], out[5] = ds(t4 + z1 + z3, sh), ds(t5 + z2 + z4, sh)
    out[3], out[1] = ds(t6 + z2 + z3, sh), ds(t7 + z1 + z4, sh)
    return out


def _fdct_quantise(plane: np.ndarray, qtab: np.ndarray) -> np.ndarray:
    """(8 bh, 8 bw) samples -> (bh, bw, 64) quantised coefficients in zigzag
    order: the islow forward DCT of each block (rows, then columns), each
    coefficient divided by qval << 3 with rounding, half away from zero."""
    bh, bw = plane.shape[0] // 8, plane.shape[1] // 8
    blocks = plane.astype(np.int64).reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3) - 128
    rows = np.stack(_fdct_1d([blocks[..., u] for u in range(8)], False), axis=-1)  # pass 1: per row
    coef = np.stack(_fdct_1d([rows[..., u, :] for u in range(8)], True), axis=-2)  # pass 2: per column
    div = (qtab << 3).reshape(8, 8)
    q = (np.abs(coef) + (div >> 1)) // div * np.sign(coef)
    return q.reshape(bh, bw, 64)[..., NATURAL_ORDER]


def _huff_enc(bits: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """(code, length) arrays indexed by symbol value."""
    code, length = np.zeros(256, np.int64), np.zeros(256, np.int64)
    vals = bits[16:]
    for (c, l), v in zip(_huff_codes(bits[:16]), vals):
        code[v], length[v] = c, l
    return code, length


def _size_class(v: np.ndarray) -> np.ndarray:
    """Bits of |v| (JPEG's magnitude category; 0 for 0)."""
    a, s = np.abs(v), np.zeros(v.shape, np.int64)
    while np.any(a):
        s += a > 0
        a = a >> 1
    return s


def _entropy_code(blocks: np.ndarray, comp: np.ndarray, tab=None) -> bytes:
    """Huffman-code quantised blocks (N, 64, zigzag, in MCU order; `comp`
    their component, each with its own DC predictor) with the standard
    tables, luminance for component 0 and chrominance for the others unless
    `tab` (0 or 1 a block) says otherwise: the bitstream, padded with 1-bits
    and byte-stuffed (jchuff.c)."""
    n = len(blocks)
    tables = [(_huff_enc(_STD_HUFF[(0, t)]), _huff_enc(_STD_HUFF[(1, t)])) for t in (0, 1)]
    tab = np.minimum(comp, 1) if tab is None else tab
    # DC: the difference from the component's previous block
    dc = blocks[:, 0]
    diff = np.zeros(n, np.int64)
    for c in np.unique(comp):
        idx = np.nonzero(comp == c)[0]
        diff[idx] = np.diff(dc[idx], prepend=0)
    keys, vals, lens = [np.arange(n) * 512], [], []
    s = _size_class(diff)
    codes = np.where(tab == 0, tables[0][0][0][s], tables[1][0][0][s])
    clen = np.where(tab == 0, tables[0][0][1][s], tables[1][0][1][s])
    extra = (diff - (diff < 0)) & ((1 << s) - 1)
    vals.append((codes << s) | extra)
    lens.append(clen + s)
    # AC: (run, size) symbols, a ZRL for each 16 zeros before a nonzero, EOB after the last nonzero
    ac = blocks[:, 1:]
    b, k = np.nonzero(ac)
    k = k + 1
    v = ac[b, k - 1]
    first = np.ones(len(b), bool)
    first[1:] = b[1:] != b[:-1]
    prev = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev - 1
    s = _size_class(v)
    sym = ((run & 15) << 4) | s
    t = tab[b]
    codes = np.where(t == 0, tables[0][1][0][sym], tables[1][1][0][sym])
    clen = np.where(t == 0, tables[0][1][1][sym], tables[1][1][1][sym])
    keys.append(b * 512 + k * 4 + 3)
    vals.append((codes << s) | ((v - (v < 0)) & ((1 << s) - 1)))
    lens.append(clen + s)
    for z in range(3):  # run >> 4 ZRL symbols (0xF0) before the coefficient
        m = (run >> 4) > z
        tz = t[m]
        keys.append(b[m] * 512 + k[m] * 4 + z)
        vals.append(np.where(tz == 0, tables[0][1][0][0xF0], tables[1][1][0][0xF0]))
        lens.append(np.where(tz == 0, tables[0][1][1][0xF0], tables[1][1][1][0xF0]))
    last = np.zeros(n, np.int64)
    np.maximum.at(last, b, k)
    m = last < 63
    keys.append(np.nonzero(m)[0] * 512 + 511)
    vals.append(np.where(tab[m] == 0, tables[0][1][0][0], tables[1][1][0][0]))
    lens.append(np.where(tab[m] == 0, tables[0][1][1][0], tables[1][1][1][0]))
    order = np.argsort(np.concatenate(keys), kind="stable")
    vals, lens = np.concatenate(vals)[order], np.concatenate(lens)[order]
    # pack MSB first
    total = int(lens.sum())
    nbytes = -(-total // 8)
    bits = np.ones(nbytes * 8, np.uint8)  # the tail stays 1-bits: jchuff.c's padding
    start = np.repeat(np.cumsum(lens) - lens, lens)
    pos = np.arange(total) - start
    width = np.repeat(lens, lens)
    bits[:total] = (np.repeat(vals, lens) >> (width - 1 - pos)) & 1
    return np.packbits(bits).tobytes().replace(b"\xff", b"\xff\x00")


def encode_jpeg(rgb: np.ndarray, quality: int = 95) -> bytes:
    """(H, W, 3) uint8 -> the bytes of PIL's
    `Image.fromarray(rgb).save(f, "JPEG", quality=quality)`: baseline, 4:2:0,
    standard Huffman tables, a JFIF 1.01 APP0."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) uint8 image, got {rgb.dtype} {rgb.shape}")
    H, W = rgb.shape[:2]
    if not (0 < H < 65536 and 0 < W < 65536):
        raise ValueError(f"JPEG cannot hold a {W}x{H} image")
    qy, qc = quant_tables(quality)
    y, cb, cr = _rgb_to_ycc(rgb)
    mw, mh = -(-W // 16), -(-H // 16)  # MCUs a row, MCU rows
    # luma: edges replicated out to whole blocks (jcsample.c expand_right_edge, jcprepct.c expand_bottom_edge)
    bw, bh = -(-W // 8), -(-H // 8)
    luma = _fdct_quantise(_pad_edge(y, bh * 8, bw * 8), qy)
    # dummy blocks of the partial MCUs: AC zero, DC the previous block's (jccoefct.c)
    grid = np.zeros((mh * 2, mw * 2, 64), np.int64)
    grid[:bh, :bw] = luma
    if bw % 2:
        grid[:bh, bw, 0] = grid[:bh, bw - 1, 0]
    if bh % 2:
        grid[bh, :, 0] = grid[bh - 1, 1::2, 0].repeat(2)
    # chroma: 2x2 box with bias 1, 2, 1, 2 ... across a row, on the edge-replicated plane
    chroma = []
    for plane in (cb, cr):
        p = _pad_edge(plane, H + H % 2, mw * 16)
        s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
        s = (s + 1 + (np.arange(s.shape[1]) & 1)) >> 2
        chroma.append(_fdct_quantise(_pad_edge(s, mh * 8, mw * 8), qc))
    lum = grid.reshape(mh, 2, mw, 2, 64).transpose(0, 2, 1, 3, 4).reshape(mh, mw, 4, 64)
    mcus = np.concatenate([lum, chroma[0][:, :, None], chroma[1][:, :, None]], axis=2).reshape(-1, 64)
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), mh * mw)
    data = _entropy_code(mcus, comp)

    def seg(marker: int, body: bytes) -> bytes:
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body

    out = [b"\xff\xd8", seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t, q in enumerate((qy, qc)):
        out.append(seg(0xDB, bytes([t]) + q[NATURAL_ORDER].astype(np.uint8).tobytes()))
    out.append(seg(0xC0, struct.pack(">BHHB", 8, H, W, 3) + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for tc, th in ((0, 0), (1, 0), (0, 1), (1, 1)):
        out.append(seg(0xC4, bytes([tc << 4 | th]) + _STD_HUFF[(tc, th)]))
    out.append(seg(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    out += [data, b"\xff\xd9"]
    return b"".join(out)


def write_jpeg(path: str, rgb: np.ndarray, quality: int = 95) -> None:
    """encode_jpeg(rgb, quality) written to path."""
    data = encode_jpeg(rgb, quality)
    with open(path, "wb") as f:
        f.write(data)
