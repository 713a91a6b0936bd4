"""Plain DINO ViT-S/8 and DPT-Large in float32, TF32 off: the reference for
the preprocessing cell. It imports nothing of the program.

Written from the published models (facebookresearch/dino's ViT with the
dino-vit-features stride override and key facet; isl-org/DPT's DPT-Large
with the `project` readout) and PIL's resamplers, in plain PyTorch and
NumPy: no kernel, no cache, no batching. Parameters come as one nested dict
in the layouts `vit_spec` and `dpt_spec` state (the patch-embed conv and every conv
(out, in, kh, kw); the transposed convs (in, out, kh, kw); linears (in, out)
for `x @ w + b`).

What it computes, as the timed path must:
- the network inputs: PIL's 8-bit resize of the uint8 image (bilinear to
  the DINO load size, bicubic to DPT's 384), then the normalisation;
- the ViT: a patch-embedding conv at the given stride, the CLS token, the
  positional embedding resized to the token grid by Keys' cubic (a = -0.5,
  weights renormalised at the borders), pre-norm blocks (LayerNorm eps
  1e-6, softmax attention, exact GELU MLP); attention dense in blocks of
  query rows, so that 12,322 tokens fit;
- DINO: block `layer`'s keys (its ln1 and qkv after the blocks before it),
  CLS dropped; the per-image PCA of the L2-normalised keys in float64;
- DPT: the pre-norm tokens at the hooks, the `project` readout, the
  reassembly (1x1 conv, x4 / x2 transposed convs, the stride-2 conv), the
  3x3 layer_rn convs, RefineNet fusion (residual conv units, x2 bilinear
  with aligned corners), the monodepth head with its ReLUs; every conv as
  im2col and one product a block of output rows (cuDNN with TF32 off would
  want a ~16 GiB workspace for the head);
- the inverse depth back at the image's size by PIL's float bicubic.

`precision="tf32"` is the control: every float32 product (linears, convs)
with its operands rounded to TF32's 10-bit mantissa, the sums in float32,
and attention's two products with their operands in float8 e4m3 (one scale
a tensor), each one step below what the configuration states.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
COLS_BYTES = 1 << 28  # im2col columns of one block of output rows


# --- parameters --------------------------------------------------------------------------------


def vit_spec(d: Dict, prefix: str = "") -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """"a/b/c" -> (shape, init) of a ViT's parameters; init is "normal"
    (N(0, 0.02)), "zeros" or "ones", as the extractors' random init draws
    them."""
    D, P, m = d["dim"], d["patch_size"], d["dim"] * d["mlp_ratio"]
    spec = {"patch_embed/w": ((D, 3, P, P), "normal"), "patch_embed/b": ((D,), "zeros"),
            "cls_token": ((1, 1, D), "normal"), "pos_embed": ((1, 1 + d["base_grid"] ** 2, D), "normal"),
            "ln_final/scale": ((D,), "ones"), "ln_final/bias": ((D,), "zeros")}
    for i in range(d["depth"]):
        for ln in ("ln1", "ln2"):
            spec[f"blk{i}/{ln}/scale"] = ((D,), "ones")
            spec[f"blk{i}/{ln}/bias"] = ((D,), "zeros")
        for name, (a, b) in (("qkv", (D, 3 * D)), ("proj", (D, D)), ("mlp1", (D, m)), ("mlp2", (m, D))):
            spec[f"blk{i}/{name}/w"] = ((a, b), "normal")
            spec[f"blk{i}/{name}/b"] = ((b,), "zeros")
    return {prefix + k: v for k, v in spec.items()}


def dpt_spec(p: Dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """As `vit_spec`, for DPT; the head's last 1x1 conv is "abs_normal"
    (|N(0, 0.02)|): on zero biases and zero-mean weights its ReLU leaves all
    but a few pixels at zero on many seeds, where a trained monodepth head's
    inverse depth is positive almost everywhere."""
    spec = vit_spec(p, "backbone/")
    D, feat = p["dim"], p["features"]

    def conv(name, o, i, k, bias=True, transposed=False, init="normal"):
        spec[f"{name}/w"] = ((i, o, k, k) if transposed else (o, i, k, k), init)
        if bias:
            spec[f"{name}/b"] = ((o,), "zeros")

    for k, ch in enumerate(p["channels"]):
        spec[f"readout{k}/w"] = ((2 * D, D), "normal")
        spec[f"readout{k}/b"] = ((D,), "zeros")
        conv(f"reassemble{k}/proj", ch, D, 1)
        if k in (0, 1):
            conv(f"reassemble{k}/resample", ch, ch, 4 if k == 0 else 2, transposed=True)
        elif k == 3:
            conv(f"reassemble{k}/resample", ch, ch, 3)
        conv(f"layer_rn{k}", feat, ch, 3, bias=False)
    for k in range(4):
        for rcu in ("rcu1", "rcu2"):
            conv(f"refine{k}/{rcu}/conv1", feat, feat, 3)
            conv(f"refine{k}/{rcu}/conv2", feat, feat, 3)
        conv(f"refine{k}/out", feat, feat, 1)
    conv("head/conv1", feat // 2, feat, 3)
    conv("head/conv2", 32, feat // 2, 3)
    conv("head/conv3", 1, 32, 1, init="abs_normal")
    return spec


def nest(flat: Dict[str, torch.Tensor]) -> Dict:
    """{"a/b/c": t} -> {"a": {"b": {"c": t}}}."""
    tree: Dict = {}
    for k, v in flat.items():
        *parts, last = k.split("/")
        cur = tree
        for q in parts:
            cur = cur.setdefault(q, {})
        cur[last] = v
    return tree


# --- products ----------------------------------------------------------------------------------


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (to nearest, ties away),
    still float32."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    top = torch.finfo(torch.float8_e4m3fn).max
    scale = top / x.abs().max().clamp(min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b in float32 ("float32") or on TF32 operands ("tf32")."""
    if precision == "tf32":
        return _round_tf32(a) @ _round_tf32(b)
    return a @ b


def linear(x: torch.Tensor, p: Dict, precision: str) -> torch.Tensor:
    return mm(x, p["w"], precision) + p["b"]


def layer_norm(x: torch.Tensor, p: Dict, eps: float = 1e-6) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * p["scale"] + p["bias"]


def gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, precision: str, rows: int = 1024) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd)) v over (H, N, hd), dense in blocks of
    `rows` query rows."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    if precision == "tf32":
        q, k, v = _round_fp8(q), _round_fp8(k), _round_fp8(v)
    out = []
    for r0 in range(0, q.shape[1], rows):
        s = (q[:, r0 : r0 + rows] @ k.transpose(1, 2)) * scale
        p = torch.softmax(s, -1)
        out.append((_round_fp8(p) if precision == "tf32" else p) @ v)
    return torch.cat(out, 1)


# --- the ViT -----------------------------------------------------------------------------------


def keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5."""
    x = np.abs(x)
    return np.where(x < 1.0, (1.5 * x - 2.5) * x * x + 1.0,
                    np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * -0.5, 0.0))


def _pos_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of a cubic resize that samples at the output
    pixels' centres (the kernel widened by the scale where it shrinks), the
    taps outside the input dropped and each row renormalised."""
    c = (np.arange(n_out) + 0.5) * n_in / n_out - 0.5
    w = keys_cubic((c[:, None] - np.arange(n_in)[None, :]) / max(n_in / n_out, 1.0))
    return w / w.sum(1, keepdims=True)


def embed(p: Dict, d: Dict, img: torch.Tensor, stride: int, precision: str) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(H, W, 3) normalised image -> ((1 + N, D) tokens, (gh, gw))."""
    P, D = d["patch_size"], d["dim"]
    cols = F.unfold(img.permute(2, 0, 1)[None], P, stride=stride)[0]  # (3 P P, gh gw)
    gh, gw = (img.shape[0] - P) // stride + 1, (img.shape[1] - P) // stride + 1
    x = mm(p["patch_embed"]["w"].reshape(D, -1), cols, precision).t() + p["patch_embed"]["b"]
    g0 = d["base_grid"]
    pe = p["pos_embed"][0, 1:].reshape(g0, g0, D)
    dev = img.device
    ah = torch.as_tensor(_pos_matrix(g0, gh), dtype=torch.float32, device=dev)
    aw = torch.as_tensor(_pos_matrix(g0, gw), dtype=torch.float32, device=dev)
    pe = torch.einsum("ij,jkd->ikd", ah, torch.einsum("kl,jld->jkd", aw, pe)).reshape(gh * gw, D)
    tokens = torch.cat([p["cls_token"][0], x], 0)
    return tokens + torch.cat([p["pos_embed"][0, :1], pe], 0), (gh, gw)


def qkv(x: torch.Tensor, p: Dict, heads: int, precision: str) -> torch.Tensor:
    """(N, D) -> (3, heads, N, hd)."""
    n, D = x.shape
    return linear(x, p["qkv"], precision).reshape(n, 3, heads, D // heads).permute(1, 2, 0, 3)


def block(x: torch.Tensor, p: Dict, heads: int, precision: str) -> torch.Tensor:
    q, k, v = qkv(layer_norm(x, p["ln1"]), p, heads, precision)
    a = attention(q, k, v, precision).permute(1, 0, 2).reshape(x.shape)
    x = x + linear(a, p["proj"], precision)
    h = gelu(linear(layer_norm(x, p["ln2"]), p["mlp1"], precision))
    return x + linear(h, p["mlp2"], precision)


# --- the resamplers --------------------------------------------------------------------------


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (keys_cubic, 2.0)}


def pil_coeffs(n_in: int, n_out: int, mode: str) -> Tuple[np.ndarray, np.ndarray]:
    """PIL's resampling coefficients: (first input index (n_out,), weights
    (n_out, taps)), the filter widened by the scale when it shrinks, each
    row normalised by its sum taken in order."""
    filt, support = FILTERS[mode]
    scale = n_in / n_out
    fs = max(scale, 1.0)
    ss = 1.0 / fs
    support *= fs
    taps = int(math.ceil(support)) * 2 + 1
    xmin = np.zeros(n_out, np.int64)
    w = np.zeros((n_out, taps), np.float64)
    for o in range(n_out):
        c = (o + 0.5) * scale
        lo = max(int(c - support + 0.5), 0)
        hi = min(int(c + support + 0.5), n_in)
        k = filt((np.arange(lo, hi) - c + 0.5) * ss)
        total = 0.0
        for t in k:
            total += float(t)
        w[o, : hi - lo] = k / total if total != 0.0 else k
        xmin[o] = lo
    return xmin, w


def _taps(n_in: int, xmin: np.ndarray, t: int) -> np.ndarray:
    return np.minimum(xmin + t, n_in - 1)


def resize_u8(img: np.ndarray, h: int, w: int, mode: str) -> np.ndarray:
    """PIL's 8-bit resize of an (H, W, 3) uint8 image: horizontal pass then
    vertical, each skipped when its size stays; weights in 22-bit fixed
    point, sums from half, shifted and clipped."""
    bits = 22
    out = img
    for axis, n_out in ((1, w), (0, h)):
        n_in = out.shape[axis]
        if n_in == n_out:
            continue
        xmin, k = pil_coeffs(n_in, n_out, mode)
        k = np.trunc(np.where(k < 0, k * (1 << bits) - 0.5, k * (1 << bits) + 0.5)).astype(np.int64)
        shape = [1, 1, 1]
        shape[axis] = n_out
        acc = np.full(out.shape[:axis] + (n_out,) + out.shape[axis + 1 :], 1 << (bits - 1), np.int64)
        for t in range(k.shape[1]):
            acc += np.take(out, _taps(n_in, xmin, t), axis=axis).astype(np.int64) * k[:, t].reshape(shape)
        out = np.clip(acc >> bits, 0, 255).astype(np.uint8)
    return out


def resize_f32(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """PIL's float bicubic resize of an (H, W) float32 map: each pass sums
    in float64 and stores float32."""
    out = x.float()
    for axis, n_out in ((1, w), (0, h)):
        n_in = out.shape[axis]
        if n_in == n_out:
            continue
        xmin, k = pil_coeffs(n_in, n_out, "bicubic")
        kt = torch.as_tensor(k, device=x.device)
        acc = 0.0
        for t in range(k.shape[1]):
            idx = torch.as_tensor(_taps(n_in, xmin, t), device=x.device)
            wt = kt[:, t].reshape((1, n_out) if axis == 1 else (n_out, 1))
            acc = acc + out.index_select(axis, idx).double() * wt
        out = acc.float()
    return out


def normalise(img_u8: np.ndarray, mean: Sequence[float], std: Sequence[float], device) -> torch.Tensor:
    x = torch.as_tensor(img_u8, device=device).float() / 255.0
    return (x - torch.tensor(mean, device=device)) / torch.tensor(std, device=device)


# --- DINO --------------------------------------------------------------------------------------


def dino_keys(params: Dict, d: Dict, image_u8: np.ndarray, precision: str, layer: Optional[int] = None) -> torch.Tensor:
    """(gh, gw, D) keys of block `layer` (the configuration's by default)."""
    layer = d["layer"] if layer is None else layer
    img = normalise(resize_u8(image_u8, d["load_size"], d["load_size"], "bilinear"), IMAGENET_MEAN, IMAGENET_STD,
                    params["pos_embed"].device)
    x, (gh, gw) = embed(params, d, img, d["stride"], precision)
    for i in range(layer):
        x = block(x, params[f"blk{i}"], d["heads"], precision)
    p = params[f"blk{layer}"]
    k = qkv(layer_norm(x, p["ln1"]), p, d["heads"], precision)[1]  # (heads, N, hd)
    return k.permute(1, 0, 2).reshape(x.shape[0], -1)[1:].reshape(gh, gw, -1)


def pca(keys: torch.Tensor, n: int = 3) -> Dict[str, np.ndarray]:
    """The PCA of the L2-normalised descriptors in float64: the mean, the
    first n components and the first n + 1 singular values."""
    x = keys.reshape(-1, keys.shape[-1]).double()
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    mean = x.mean(0)
    _, s, vt = torch.linalg.svd(x - mean, full_matrices=False)
    return {"mean": mean.cpu().numpy(), "components": vt[:n].cpu().numpy(), "sv": s[: n + 1].cpu().numpy()}


# --- DPT ---------------------------------------------------------------------------------------


def conv(x: torch.Tensor, p: Dict, precision: str, stride: int = 1, pad: Optional[int] = None) -> torch.Tensor:
    """(C, H, W) conv with an (out, in, kh, kw) kernel, as im2col and one
    product a block of output rows. pad None is k // 2."""
    w = p["w"]
    o, c, kh, kw = w.shape
    pad = kw // 2 if pad is None else pad
    xp = F.pad(x, (pad, pad, pad, pad))
    ho, wo = (xp.shape[1] - kh) // stride + 1, (xp.shape[2] - kw) // stride + 1
    rows = max(1, COLS_BYTES // (4 * c * kh * kw * wo))
    wm = w.reshape(o, -1)
    out = []
    for r0 in range(0, ho, rows):
        r1 = min(r0 + rows, ho)
        slab = xp[:, r0 * stride : (r1 - 1) * stride + kh]
        cols = F.unfold(slab[None], (kh, kw), stride=stride)[0]
        out.append(mm(wm, cols, precision).reshape(o, r1 - r0, wo))
    y = torch.cat(out, 1)
    return y + p["b"][:, None, None] if "b" in p else y


def conv_transpose(x: torch.Tensor, p: Dict, precision: str) -> torch.Tensor:
    """(C, H, W) transposed conv whose kernel (in, out, s, s) equals its
    stride: each input pixel writes one s x s patch."""
    c, h, w = x.shape
    _, o, s, _ = p["w"].shape
    y = mm(p["w"].reshape(c, -1).t(), x.reshape(c, h * w), precision)  # (o s s, h w)
    y = y.reshape(o, s, s, h, w).permute(0, 3, 1, 4, 2).reshape(o, h * s, w * s)
    return y + p["b"][:, None, None]


def _aligned(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_out, n_in) linear interpolation with the corners aligned."""
    pos = np.arange(n_out) * (n_in - 1) / max(n_out - 1, 1)
    lo = np.minimum(np.floor(pos).astype(np.int64), n_in - 1)
    frac = pos - lo
    a = np.zeros((n_out, n_in))
    a[np.arange(n_out), lo] += 1.0 - frac
    a[np.arange(n_out), np.minimum(lo + 1, n_in - 1)] += frac
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def upsample2(x: torch.Tensor) -> torch.Tensor:
    _, h, w = x.shape
    ah, aw = _aligned(h, 2 * h, x.device), _aligned(w, 2 * w, x.device)
    return torch.einsum("ij,cjk,lk->cil", ah, x, aw)


def _rcu(x: torch.Tensor, p: Dict, precision: str) -> torch.Tensor:
    h = conv(torch.relu(x), p["conv1"], precision)
    return x + conv(torch.relu(h), p["conv2"], precision)


def _fusion(x: torch.Tensor, skip: Optional[torch.Tensor], p: Dict, precision: str) -> torch.Tensor:
    if skip is not None:
        x = x + _rcu(skip, p["rcu1"], precision)
    return conv(upsample2(_rcu(x, p["rcu2"], precision)), p["out"], precision)


def dpt_depth(params: Dict, d: Dict, image_u8: np.ndarray, precision: str) -> torch.Tensor:
    """(H, W) inverse depth of the image, at its own size."""
    dev = params["head"]["conv3"]["w"].device
    n = d["net_size"]
    img = normalise(resize_u8(image_u8, n, n, "bicubic"), (0.5,) * 3, (0.5,) * 3, dev)
    bb = params["backbone"]
    x, (gh, gw) = embed(bb, d, img, d["patch_size"], precision)
    hooks: List[int] = list(d["hooks"])
    taps = {}
    for i in range(max(hooks) + 1):
        x = block(x, bb[f"blk{i}"], d["heads"], precision)
        if i in hooks:
            taps[i] = x
    pyramid = []
    for k, hook in enumerate(hooks):
        t = taps[hook]
        cat = torch.cat([t[1:], t[:1].expand(t.shape[0] - 1, -1)], -1)
        f = gelu(linear(cat, params[f"readout{k}"], precision)).t().reshape(-1, gh, gw)
        re = params[f"reassemble{k}"]
        f = conv(f, re["proj"], precision)
        if k in (0, 1):
            f = conv_transpose(f, re["resample"], precision)
        elif k == 3:
            f = conv(f, re["resample"], precision, stride=2, pad=1)
        pyramid.append(conv(f, params[f"layer_rn{k}"], precision))
    path = _fusion(pyramid[3], None, params["refine3"], precision)
    for k in (2, 1, 0):
        path = _fusion(path, pyramid[k], params[f"refine{k}"], precision)
    head = params["head"]
    h = upsample2(conv(path, head["conv1"], precision))
    h = torch.relu(conv(h, head["conv2"], precision))
    h = torch.relu(conv(h, head["conv3"], precision))[0]
    return resize_f32(h, image_u8.shape[0], image_u8.shape[1])


def image_outputs(dino_p: Dict, dpt_p: Dict, dims: Dict, image_u8: np.ndarray, precision: str) -> Dict[str, np.ndarray]:
    """Everything the preprocessing pass writes for one image: the key map,
    its PCA (with the singular values that say which components are
    defined) and the inverse depth."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            keys = dino_keys(dino_p, dims["dino"], image_u8, precision)
            out = {"keys": keys.cpu().numpy(), **pca(keys)}
            out["depth"] = dpt_depth(dpt_p, dims["dpt"], image_u8, precision).cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return out
