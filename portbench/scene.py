"""The benchmark's inputs, made on the device from `--seed`: the scene
(intrinsics, base poses, bounds, DINO feature maps, the training views'
ray store, the held-out views' pixels), the seeded weights and the pose
tables. Both sides get these and nothing else: the program loads them into
its modules, the plain reference reads them as they are.

Every purpose draws from its own generator, seeded from (seed, purpose), so
adding a draw for one purpose leaves the others' numbers as they were.
Large tensors come from one call each on a `torch.Generator` on the card.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, NamedTuple, Optional

import torch

from portbench.reference import model as ref


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose of a run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, purpose))


class Scene(NamedTuple):
    """Views 0 .. n_train - 1 are the training views, the rest held out."""

    Ks: torch.Tensor  # (N, 3, 3)
    poses: torch.Tensor  # (N, 3, 4) base camera-to-world poses
    near_far: torch.Tensor  # (N, 2)
    wh: torch.Tensor  # (N, 2) int32 (W, H)
    feat_maps: Optional[torch.Tensor]  # (N, h, w, F) bf16


class Store(NamedTuple):
    """The training views' rays, one per pixel, in the program's compact
    record: pixel column and row, view, rgb, DPT inverse depth."""

    px: torch.Tensor  # (n,) int32
    py: torch.Tensor  # (n,) int32
    img_idx: torch.Tensor  # (n,) int64
    rgb: torch.Tensor  # (n, 3) uint8
    inv_depth: torch.Tensor  # (n,) float16


def make_scene(cfg: Dict, seed: int, device, feats: bool = True) -> Scene:
    sc = cfg["scene"]
    n = sc["n_train"] + sc["n_test"]
    W, H = sc["width"], sc["height"]
    f = sc["focal_per_width"] * W
    Ks = torch.zeros((n, 3, 3), device=device)
    Ks[:, 0, 0] = Ks[:, 1, 1] = f
    Ks[:, 0, 2], Ks[:, 1, 2], Ks[:, 2, 2] = W / 2.0, H / 2.0, 1.0
    hp = cfg["hparams"]
    near_far = torch.tensor([[hp["nerf.near"], hp["nerf.far"]]], device=device).expand(n, 2).contiguous()
    fmaps = None
    if feats:
        g = generator(seed, "feat_maps", device)
        fmaps = torch.randn((n, sc["feat_h"], sc["feat_w"], cfg["dims"]["feat_dim"]), generator=g, device=device,
                            dtype=torch.bfloat16)
    return Scene(Ks=Ks, poses=torch.eye(3, 4, device=device).expand(n, 3, 4).contiguous(), near_far=near_far,
                 wh=torch.tensor([[W, H]], device=device, dtype=torch.int32).expand(n, 2).contiguous(),
                 feat_maps=fmaps)


def make_store(cfg: Dict, seed: int, device) -> Store:
    sc = cfg["scene"]
    W, H, n_img = sc["width"], sc["height"], sc["n_train"]
    n = n_img * W * H
    g = generator(seed, "store", device)
    pix = torch.arange(W * H, device=device, dtype=torch.int32)
    lo, hi = sc["inv_depth_range"]
    return Store(
        px=(pix % W).repeat(n_img), py=(pix // W).repeat(n_img),
        img_idx=torch.arange(n_img, device=device).repeat_interleave(W * H),
        rgb=torch.randint(0, 256, (n, 3), generator=g, device=device, dtype=torch.uint8),
        inv_depth=(torch.rand(n, generator=g, device=device) * (hi - lo) + lo).to(torch.float16),
    )


def make_test_pixels(cfg: Dict, seed: int, device) -> torch.Tensor:
    """(n_test, H, W, 3) uint8 pixels of the held-out views, the images
    that TTO fits."""
    sc = cfg["scene"]
    return torch.randint(0, 256, (sc["n_test"], sc["height"], sc["width"], 3), device=device, dtype=torch.uint8,
                         generator=generator(seed, "test_pixels", device))


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded weights, by the upstream checkpoint's names: every linear
    layer U(-1/sqrt(fan_in), 1/sqrt(fan_in)) as torch.nn.Linear draws it,
    every embedding table N(0, 1); one uniform and one normal call for all."""
    spec = ref.param_spec(cfg["dims"], cfg["scene"]["n_train"] + cfg["scene"]["n_test"])
    lin = [(k, s, fan) for k, (s, fan) in spec.items() if fan]
    emb = [(k, s) for k, (s, fan) in spec.items() if not fan]
    u = torch.rand(sum(math.prod(s) for _, s, _ in lin), generator=generator(seed, "weights.linear", device),
                   device=device)
    z = torch.randn(sum(math.prod(s) for _, s in emb), generator=generator(seed, "weights.embedding", device),
                    device=device)
    out, o = {}, 0
    for k, s, fan in lin:
        b = 1.0 / math.sqrt(fan)
        out[k] = (u[o : o + math.prod(s)].reshape(s) * 2.0 - 1.0) * b
        o += math.prod(s)
    o = 0
    for k, s in emb:
        out[k] = z[o : o + math.prod(s)].reshape(s).clone()
        o += math.prod(s)
    return {k: out[k] for k in spec}


def make_pose_tables(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """se3_refine (N, 6) at U(-j, j) with j the scene's pose_jitter, and the
    depth scale / shift (N, 2) at U(-0.1, 0.1): the tables of a run part way
    through."""
    n = cfg["scene"]["n_train"] + cfg["scene"]["n_test"]
    u = torch.rand((n, 8), generator=generator(seed, "pose_tables", device), device=device) * 2.0 - 1.0
    return {"se3_refine.weight": (u[:, :6] * cfg["scene"]["pose_jitter"]).contiguous(),
            "depth_scale.weight": (u[:, 6:] * 0.1).contiguous()}


def load_into(module: torch.nn.Module, tensors: Dict[str, torch.Tensor]) -> None:
    """Copy the benchmark's tensors into a program module's trainable
    parameters, by name; every trainable parameter must be covered, and
    every tensor used."""
    params = {k: p for k, p in module.named_parameters() if p.requires_grad}
    if set(params) != set(tensors):
        raise RuntimeError(f"parameter names differ: program only {sorted(set(params) - set(tensors))[:8]}, "
                           f"benchmark only {sorted(set(tensors) - set(params))[:8]}")
    with torch.no_grad():
        for k, p in params.items():
            if p.shape != tensors[k].shape:
                raise RuntimeError(f"{k}: program {tuple(p.shape)}, benchmark {tuple(tensors[k].shape)}")
            p.copy_(tensors[k])
