"""DPT-Large monocular inverse-depth estimation (upnerf/features/dpt.py).

384x384 input, ViT-L/16 backbone with hooks at blocks (5, 11, 17, 23), the
'project' readout, reassembly to a 4-scale pyramid (channels 256 / 512 /
1024 / 1024), RefineNet fusion at 256 features, and the monodepth head with
a non-negative output. The inverse-depth map is resized back to the source
image size (bicubic) and saved as .npy.

Parameters: the npz layout's keys (upnerf/features/dpt.py:14-23) in the
port's layouts (`upnerf_torch.utils.weights.dpt_params_from_jax`): convs
(out, in, kh, kw), the two transposed convs (in, out, kh, kw) as
`F.conv_transpose2d` takes them, linears (in, out). Feature maps inside the
neck are NCHW; the public functions keep the JAX package's layouts (image
(H, W, 3), tokens (1, 1 + N, D), depth (H, W)).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from upnerf_torch.features import vit
from upnerf_torch.features.images import npy_name, read_rgb_u8, resize_float, resize_u8

DPT_HOOKS = (5, 11, 17, 23)
DPT_CHANNELS = (256, 512, 1024, 1024)
DPT_VIT = vit.ViTConfig(patch_size=16, dim=1024, depth=24, heads=16, base_grid=24)
SMALL_VIT = vit.ViTConfig(patch_size=16, dim=64, depth=4, heads=4, base_grid=24)
MIDAS_MEAN = np.array([0.5, 0.5, 0.5], np.float32)
MIDAS_STD = np.array([0.5, 0.5, 0.5], np.float32)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, stride: int = 1,
           padding: Optional[int] = None) -> torch.Tensor:
    """NCHW conv with an (out, in, kh, kw) kernel, as im2col and one float32
    matmul. padding None is XLA's "SAME" at stride 1 for an odd kernel
    (k // 2 on both sides).

    Not F.conv2d: with TF32 off, cuDNN on the H100 runs the head's 3x3
    256 -> 128 conv at 192x192 in ~200 ms with a ~16 GiB workspace, where
    this form takes under 1 ms and 360 MiB (PERF.md)."""
    o, c, kh, kw = w.shape
    n, _, h, wd = x.shape
    pad = kw // 2 if padding is None else padding
    ho, wo = (h + 2 * pad - kh) // stride + 1, (wd + 2 * pad - kw) // stride + 1
    if kh == kw == 1 and stride == 1 and pad == 0:
        cols = x.reshape(n, c, h * wd)
    else:
        cols = F.unfold(x, (kh, kw), padding=pad, stride=stride)  # (n, c kh kw, ho wo)
    y = (w.reshape(o, -1) @ cols).reshape(n, o, ho, wo)
    return y if b is None else y + b[:, None, None]


def conv2d_transpose(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                     stride: int = 2) -> torch.Tensor:
    """NCHW transposed conv with an (in, out, kh, kw) kernel. With kernel ==
    stride (the only case DPT has), XLA's "SAME" output is stride x the
    input, which is what torch gives with no padding."""
    if w.shape[-1] != stride:
        raise ValueError(f"transposed conv kernel {w.shape[-1]} != stride {stride}")
    return F.conv_transpose2d(x, w, b, stride=stride)


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear with ALIGN_CORNERS=TRUE (upnerf/features/dpt.py:60-86)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


def _residual_conv_unit(x: torch.Tensor, p: Dict) -> torch.Tensor:
    h = conv2d(torch.relu(x), p["conv1"]["w"], p["conv1"]["b"])
    h = conv2d(torch.relu(h), p["conv2"]["w"], p["conv2"]["b"])
    return x + h


def _fusion(x: torch.Tensor, skip: Optional[torch.Tensor], p: Dict) -> torch.Tensor:
    """FeatureFusionBlock: optional skip add through RCU1, RCU2, x2
    upsample, 1x1 out conv."""
    if skip is not None:
        x = x + _residual_conv_unit(skip, p["rcu1"])
    x = _upsample2(_residual_conv_unit(x, p["rcu2"]))
    return conv2d(x, p["out"]["w"], p["out"]["b"])


def dpt_forward(params: Dict, img: torch.Tensor, cfg: vit.ViTConfig = DPT_VIT, hooks=DPT_HOOKS) -> torch.Tensor:
    """(H, W, 3) normalized -> (H, W) inverse depth."""
    bb = vit.forward_features(params["backbone"], cfg, img, stride=cfg.patch_size, out_layers=hooks)
    return dpt_neck(params, bb["layers"], bb["grid"], hooks)


def dpt_neck(params: Dict, layers: Dict[int, torch.Tensor], grid, hooks=DPT_HOOKS) -> torch.Tensor:
    """Readout-project + reassemble + RefineNet fusion + monodepth head:
    everything after the ViT backbone."""
    gh, gw = grid
    pyramid = []
    for k, hook in enumerate(hooks):
        tokens = layers[hook]  # (1, 1+N, D)
        cls, patches = tokens[:, :1], tokens[:, 1:]
        cat = torch.cat([patches, cls.expand_as(patches)], -1)  # 'project' readout
        proj = F.gelu(cat @ params[f"readout{k}"]["w"] + params[f"readout{k}"]["b"], approximate="none")
        fmap = proj.transpose(1, 2).reshape(1, -1, gh, gw)
        p = params[f"reassemble{k}"]
        fmap = conv2d(fmap, p["proj"]["w"], p["proj"]["b"])  # 1x1 to ch_k
        if k == 0:  # 1/4 scale: x4 transposed conv
            fmap = conv2d_transpose(fmap, p["resample"]["w"], p["resample"]["b"], 4)
        elif k == 1:  # 1/8: x2 transposed conv
            fmap = conv2d_transpose(fmap, p["resample"]["w"], p["resample"]["b"], 2)
        elif k == 3:  # 1/32: stride-2 conv, padded (1, 1) on both sides
            fmap = conv2d(fmap, p["resample"]["w"], p["resample"]["b"], stride=2, padding=1)
        pyramid.append(conv2d(fmap, params[f"layer_rn{k}"]["w"]))  # 3x3 -> 256, no bias

    l1, l2, l3, l4 = pyramid
    path = _fusion(l4, None, params["refine3"])  # the deepest takes no lateral skip
    path = _fusion(path, l3, params["refine2"])
    path = _fusion(path, l2, params["refine1"])
    path = _fusion(path, l1, params["refine0"])  # -> 1/2 scale

    head = params["head"]
    h = _upsample2(conv2d(path, head["conv1"]["w"], head["conv1"]["b"]))  # -> full resolution
    h = torch.relu(conv2d(h, head["conv2"]["w"], head["conv2"]["b"]))
    h = torch.relu(conv2d(h, head["conv3"]["w"], head["conv3"]["b"]))  # non-negative inverse depth
    return h[0, 0]


class DPTDepth:
    """DPT on the device its parameters live on."""

    def __init__(self, params: Dict, net_size: int = 384):
        self.params = params
        self.net_size = net_size
        self.device = params["head"]["conv3"]["w"].device

    def __call__(self, image_u8: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8 -> (H, W) float32 inverse depth: bicubic to
        net_size on the host (uint8, as PIL resizes it), the network, then
        bicubic back to the source size."""
        h, w = image_u8.shape[:2]
        x = resize_u8(image_u8, (self.net_size, self.net_size), "bicubic").astype(np.float32) / 255.0
        x = torch.from_numpy((x - MIDAS_MEAN) / MIDAS_STD).to(self.device)
        with torch.no_grad():
            pred = dpt_forward(self.params, x)
            return resize_float(pred, (h, w)).cpu().numpy()


def load_dpt(weights_path: Optional[str] = None, device="cpu") -> Optional[DPTDepth]:
    weights_path = weights_path or os.environ.get("UPNERF_DPT_WEIGHTS")
    if weights_path is None or not os.path.isfile(weights_path):
        return None
    from upnerf_torch.features.dino import _unflatten
    from upnerf_torch.utils.weights import dpt_params_from_jax

    with np.load(weights_path) as flat:
        return DPTDepth(dpt_params_from_jax(_unflatten(dict(flat)), device=device))


def save_depths(model: DPTDepth, image_paths, save_dir: str, log=print) -> None:
    """Write <save_dir>/<stem>.npy inverse-depth maps."""
    os.makedirs(save_dir, exist_ok=True)
    for i, path in enumerate(image_paths):
        inv_depth = model(read_rgb_u8(path))
        stem = npy_name(path)[:-4]
        np.save(os.path.join(save_dir, stem + ".npy"), inv_depth)
        log(f"[dpt] {i + 1}/{len(image_paths)} {stem}")


def init_dpt_params(rng: np.random.Generator, small: bool = False):
    """Random parameters in the npz layout (numpy, HWIO convs), as
    upnerf.features.dpt.init_dpt_params draws them: N(0, 0.02) weights and
    zero biases. small=True shrinks the backbone and returns (params, cfg,
    hooks)."""
    cfg = SMALL_VIT if small else DPT_VIT
    hooks = (0, 1, 2, 3) if small else DPT_HOOKS
    chans = (32, 48, 64, 64) if small else DPT_CHANNELS
    feat = 32 if small else 256

    def normal(*shape):
        return (rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)).astype(np.float32)

    def conv(kh, kw, i, o, bias=True):
        p = {"w": normal(kh, kw, i, o)}
        if bias:
            p["b"] = np.zeros((o,), np.float32)
        return p

    d = cfg.dim
    params: Dict = {"backbone": vit.init_vit_params(rng, cfg)}
    for k in range(4):
        params[f"readout{k}"] = {"w": normal(2 * d, d), "b": np.zeros((d,), np.float32)}
        ch = chans[k]
        re = {"proj": conv(1, 1, d, ch)}
        if k == 0:
            re["resample"] = conv(4, 4, ch, ch)
        elif k == 1:
            re["resample"] = conv(2, 2, ch, ch)
        elif k == 3:
            re["resample"] = conv(3, 3, ch, ch)
        params[f"reassemble{k}"] = re
        params[f"layer_rn{k}"] = {"w": normal(3, 3, ch, feat)}
    for k in range(4):
        params[f"refine{k}"] = {
            "rcu1": {"conv1": conv(3, 3, feat, feat), "conv2": conv(3, 3, feat, feat)},
            "rcu2": {"conv1": conv(3, 3, feat, feat), "conv2": conv(3, 3, feat, feat)},
            "out": conv(1, 1, feat, feat),
        }
    params["head"] = {
        "conv1": conv(3, 3, feat, feat // 2),
        "conv2": conv(3, 3, feat // 2, 32),
        "conv3": conv(1, 1, 32, 1),
    }
    return (params, cfg, hooks) if small else params
