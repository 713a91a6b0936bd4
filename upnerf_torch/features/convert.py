"""Torch-checkpoint -> npz weight converters for the offline extractors
(upnerf/features/convert.py).

Run these where torch and the public checkpoints are available:

  DINO ViT-S/8 (facebookresearch/dino `dino_deitsmall8_pretrain.pth`):
      convert_dino_vit("dino_deitsmall8_pretrain.pth", "dino_vits8.npz")
  DPT-Large (isl-org/DPT `dpt_large-midas-2f21e586.pt`):
      convert_dpt("dpt_large-midas-2f21e586.pt", "dpt_large.npz")

The npz files are the layout both packages read
(`upnerf_torch.features.dino.load_dino`, `dpt.load_dpt`); pass them to
`python -m upnerf_torch.cli.preprocess` with --dino_weights / --dpt_weights,
or point UPNERF_DINO_WEIGHTS / UPNERF_DPT_WEIGHTS at them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _vit_from_timm_state(sd: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """timm/DINO ViT state_dict -> our flat vit.py layout (HWIO convs,
    (in, out) linears)."""

    def g(name):
        return sd[prefix + name].detach().cpu().numpy()

    out: Dict[str, np.ndarray] = {}
    out["patch_embed/w"] = g("patch_embed.proj.weight").transpose(2, 3, 1, 0)
    out["patch_embed/b"] = g("patch_embed.proj.bias")
    out["cls_token"] = g("cls_token")
    out["pos_embed"] = g("pos_embed")
    depth = 0
    while f"{prefix}blocks.{depth}.norm1.weight" in sd:
        depth += 1
    for i in range(depth):
        b = f"blocks.{i}."
        out[f"blk{i}/ln1/scale"] = g(b + "norm1.weight")
        out[f"blk{i}/ln1/bias"] = g(b + "norm1.bias")
        out[f"blk{i}/qkv/w"] = g(b + "attn.qkv.weight").T
        out[f"blk{i}/qkv/b"] = g(b + "attn.qkv.bias")
        out[f"blk{i}/proj/w"] = g(b + "attn.proj.weight").T
        out[f"blk{i}/proj/b"] = g(b + "attn.proj.bias")
        out[f"blk{i}/ln2/scale"] = g(b + "norm2.weight")
        out[f"blk{i}/ln2/bias"] = g(b + "norm2.bias")
        out[f"blk{i}/mlp1/w"] = g(b + "mlp.fc1.weight").T
        out[f"blk{i}/mlp1/b"] = g(b + "mlp.fc1.bias")
        out[f"blk{i}/mlp2/w"] = g(b + "mlp.fc2.weight").T
        out[f"blk{i}/mlp2/b"] = g(b + "mlp.fc2.bias")
    out["ln_final/scale"] = g("norm.weight")
    out["ln_final/bias"] = g("norm.bias")
    return out


def convert_dino_vit(ckpt_path: str, out_path: str) -> None:
    import torch

    sd = torch.load(ckpt_path, map_location="cpu")
    if "teacher" in sd:
        sd = {k.replace("backbone.", ""): v for k, v in sd["teacher"].items()}
    np.savez(out_path, **_vit_from_timm_state(sd))


def convert_dpt(ckpt_path: str, out_path: str) -> None:
    """DPT-Large midas checkpoint -> the dpt.py npz layout."""
    import torch

    sd = torch.load(ckpt_path, map_location="cpu")
    if "state_dict" in sd:
        sd = sd["state_dict"]

    def g(name):
        return sd[name].detach().cpu().numpy()

    def conv(name):
        return {
            "w": g(name + ".weight").transpose(2, 3, 1, 0),
            "b": g(name + ".bias"),
        }

    def tconv(name):
        # torch ConvTranspose2d weight is (in, out, kh, kw) -> HWIO
        return {
            "w": g(name + ".weight").transpose(2, 3, 1, 0),
            "b": g(name + ".bias"),
        }

    out: Dict[str, np.ndarray] = {}
    bb = _vit_from_timm_state(sd, prefix="pretrained.model.")
    for k, v in bb.items():
        out[f"backbone/{k}"] = v

    # readout projections + reassemble (DPT act_postprocess1..4)
    for k in range(4):
        pp = f"pretrained.act_postprocess{k + 1}"
        out[f"readout{k}/w"] = g(pp + ".0.project.0.weight").T
        out[f"readout{k}/b"] = g(pp + ".0.project.0.bias")
        c = conv(pp + ".3")  # 1x1 projection conv
        out[f"reassemble{k}/proj/w"] = c["w"]
        out[f"reassemble{k}/proj/b"] = c["b"]
        if k in (0, 1):
            t = tconv(pp + ".4")
            out[f"reassemble{k}/resample/w"] = t["w"]
            out[f"reassemble{k}/resample/b"] = t["b"]
        elif k == 3:
            c2 = conv(pp + ".4")
            out[f"reassemble{k}/resample/w"] = c2["w"]
            out[f"reassemble{k}/resample/b"] = c2["b"]
        out[f"layer_rn{k}/w"] = g(
            f"scratch.layer{k + 1}_rn.weight"
        ).transpose(2, 3, 1, 0)

    # refinenets: scratch.refinenet4 is the deepest (our refine3)
    for ours, theirs in [(3, 4), (2, 3), (1, 2), (0, 1)]:
        rn = f"scratch.refinenet{theirs}"
        out[f"refine{ours}/rcu1/conv1/w"], out[f"refine{ours}/rcu1/conv1/b"] = (
            conv(rn + ".resConfUnit1.conv1")["w"],
            conv(rn + ".resConfUnit1.conv1")["b"],
        )
        out[f"refine{ours}/rcu1/conv2/w"], out[f"refine{ours}/rcu1/conv2/b"] = (
            conv(rn + ".resConfUnit1.conv2")["w"],
            conv(rn + ".resConfUnit1.conv2")["b"],
        )
        out[f"refine{ours}/rcu2/conv1/w"], out[f"refine{ours}/rcu2/conv1/b"] = (
            conv(rn + ".resConfUnit2.conv1")["w"],
            conv(rn + ".resConfUnit2.conv1")["b"],
        )
        out[f"refine{ours}/rcu2/conv2/w"], out[f"refine{ours}/rcu2/conv2/b"] = (
            conv(rn + ".resConfUnit2.conv2")["w"],
            conv(rn + ".resConfUnit2.conv2")["b"],
        )
        out[f"refine{ours}/out/w"], out[f"refine{ours}/out/b"] = (
            conv(rn + ".out_conv")["w"],
            conv(rn + ".out_conv")["b"],
        )

    out["head/conv1/w"], out["head/conv1/b"] = (
        conv("scratch.output_conv.0")["w"],
        conv("scratch.output_conv.0")["b"],
    )
    out["head/conv2/w"], out["head/conv2/b"] = (
        conv("scratch.output_conv.2")["w"],
        conv("scratch.output_conv.2")["b"],
    )
    out["head/conv3/w"], out["head/conv3/b"] = (
        conv("scratch.output_conv.4")["w"],
        conv("scratch.output_conv.4")["b"],
    )
    np.savez(out_path, **out)
