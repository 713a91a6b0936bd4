"""LPIPS with the AlexNet backbone (upnerf/evaluate/lpips.py).

The same architecture (lpips v0.1 alex) and the same npz weight asset as the
JAX package: keys conv{i}_w (out, in, kh, kw), conv{i}_b and lin{i} (C,),
written by `upnerf.evaluate.lpips.convert_from_torch` and found through
UPNERF_LPIPS_WEIGHTS (`convert_from_torch` below writes it too). Input in [-1, 1], normalised by shift / scale; AlexNet
features after each of the 5 ReLU stages (max-pool 3/2 before convs 1 and 2);
channels unit-normalised; squared difference; a 1x1 linear head per stage;
spatial mean; sum over stages. The convolutions are F.conv2d in f32 (the JAX
package uses lax.conv here, not a Pallas kernel; TF32 is off, see
upnerf_torch/__init__.py). Without weights `load_lpips` returns None and
eval reports PSNR / SSIM only.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

# AlexNet feature stages: (out_ch, kernel, stride, padding).
_ALEX = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1)]
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPS:
    """Callable LPIPS distance of two (H, W, 3) images in [0, 1]."""

    def __init__(self, weights: Dict[str, np.ndarray], device="cpu"):
        self.device = torch.device(device)
        self.w = {k: torch.from_numpy(np.asarray(v, np.float32)).to(self.device) for k, v in weights.items()}
        self.shift = torch.tensor(_SHIFT, device=self.device)
        self.scale = torch.tensor(_SCALE, device=self.device)

    def _alex_features(self, x: torch.Tensor):
        """x: (1, 3, H, W) normalised -> the 5 stage activations."""
        feats, h = [], x
        for i, (_, _, s, p) in enumerate(_ALEX):
            if i in (1, 2):
                h = F.max_pool2d(h, 3, 2)
            h = torch.relu(F.conv2d(h, self.w[f"conv{i}_w"], self.w[f"conv{i}_b"], stride=s, padding=p))
            feats.append(h)
        return feats

    @torch.no_grad()
    def distance(self, img0, img1) -> torch.Tensor:
        def prep(im):
            x = torch.as_tensor(im, dtype=torch.float32, device=self.device)
            x = (x * 2.0 - 1.0 - self.shift) / self.scale
            return x.permute(2, 0, 1)[None]

        total = torch.zeros((), device=self.device)
        for i, (a, b) in enumerate(zip(self._alex_features(prep(img0)), self._alex_features(prep(img1)))):
            a = a / torch.sqrt((a**2).sum(1, keepdim=True) + 1e-10)
            b = b / torch.sqrt((b**2).sum(1, keepdim=True) + 1e-10)
            total = total + ((a - b) ** 2 * self.w[f"lin{i}"][None, :, None, None]).sum(1).mean()
        return total

    def __call__(self, img0, img1) -> float:
        return float(self.distance(img0, img1))


def load_lpips(path: Optional[str] = None, device="cpu") -> Optional[LPIPS]:
    """LPIPS from the npz at `path` or $UPNERF_LPIPS_WEIGHTS; None without one."""
    path = path or os.environ.get("UPNERF_LPIPS_WEIGHTS")
    if path is None or not os.path.isfile(path):
        return None
    return LPIPS(dict(np.load(path)), device=device)


def convert_from_torch(out_path: str) -> None:
    """The `lpips` package's AlexNet LPIPS weights (v0.1) -> the npz asset
    above. Needs that package (it ships the weights); without it, exits with
    a message saying so."""
    try:
        import lpips as lpips_pkg  # type: ignore
    except ImportError as e:
        raise SystemExit("convert_weights lpips needs the `lpips` package, which carries the AlexNet LPIPS weights;"
                         f" it is not installed here ({e}). Install it where the weights can be fetched, convert"
                         " there and copy the npz; without weights, eval reports PSNR / SSIM only.") from e

    model = lpips_pkg.LPIPS(net="alex")
    convs = [m for s in (model.net.slice1, model.net.slice2, model.net.slice3, model.net.slice4, model.net.slice5)
             for m in s if isinstance(m, torch.nn.Conv2d)]
    out = {}
    for i, m in enumerate(convs):
        out[f"conv{i}_w"] = m.weight.detach().cpu().numpy()
        out[f"conv{i}_b"] = m.bias.detach().cpu().numpy()
    for i, lin in enumerate([model.lin0, model.lin1, model.lin2, model.lin3, model.lin4]):
        out[f"lin{i}"] = lin.model[1].weight.detach().cpu().numpy()[0, :, 0, 0]  # (1, C, 1, 1) -> (C,)
    np.savez(out_path, **out)
