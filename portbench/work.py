"""The yardstick's arithmetic: the H100's published peaks and the work of
each pass, counted from the algorithm's shapes (never from a kernel's
design). Copied from chip_smoke.py's bound arithmetic (`PEAK_FLOPS`,
`PEAK_BYTES`, `bound`, `trunk_macs`, `render_macs`), with the bytes cut
down to what the algorithm itself must move: every input read once and
every output written once, and no saved residual or walk chain, which a
kernel design chooses.

A "pass" is one fused render call over R rays x S samples of one field in
one mode; `dims` is a configuration's `dims` (portbench/configs/*.json).
The preprocessing pass (DINO and DPT on one image) is counted at the end,
from the extractors' published shapes.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

# H100 SXM, NVIDIA's data sheet, dense: bf16 tensor cores; HBM3.
PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES = 3.35e12


class Mode(NamedTuple):
    """What a pass computes: the candidate branch, the rgb head and the
    feature map (phase 0: cand + feat; phase 1: all three; phase 2: rgb)."""

    use_cand: bool
    use_rgb: bool
    out_feat: bool


def mode_of_phase(phase: int) -> Mode:
    return Mode(use_cand=phase < 2, use_rgb=phase > 0, out_feat=phase < 2)


def in0(dims: Dict) -> int:
    """Width of a sample's PE row: xyz and its sin / cos bands."""
    return 3 + 6 * dims["xyz_L"]


def trunk_macs(dims: Dict) -> int:
    """Multiply-adds of the D-layer trunk for one sample, the skip layers
    reading [x0, h]."""
    W, x = dims["W"], in0(dims)
    return sum((x if i == 0 else W + x if i in dims["skips"] else W) * W for i in range(dims["D"]))


def sample_macs(dims: Dict, mode: Mode) -> int:
    """Multiply-adds of one sample in `mode`: trunk, xyz_final, sigma, the
    feature head (the rgb head reads it), rgb (F -> W/2 -> 3), and the
    candidate branch (W -> W/2 -> W/2, its sigma and its feature head).
    The per-ray parts (ray_cond, the candidate embedding's product) are
    counted per ray in `ray_macs`."""
    W, F = dims["W"], dims["feat_dim"]
    HH = HC = W // 2
    macs = trunk_macs(dims) + W * W + W + W * F
    if mode.use_rgb:
        macs += F * HH + HH * 3
    if mode.use_cand:
        macs += W * HC + HC * HC + HC + HC * F
    return macs


def ray_macs(dims: Dict, mode: Mode) -> int:
    """Multiply-adds of one ray's conditioning: PE(dir) and the appearance
    embedding into the rgb head's first layer, the candidate embedding into
    the candidate's first layer."""
    HH = dims["W"] // 2
    macs = 0
    if mode.use_rgb:
        macs += (3 + 6 * dims["dir_L"] + dims["appearance_dim"]) * HH
    if mode.use_cand:
        macs += dims["candidate_dim"] * HH
    return macs


def n_weights(dims: Dict, mode: Mode) -> int:
    """Weights and biases one pass reads in `mode`."""
    W, F, C = dims["W"], dims["feat_dim"], dims["candidate_dim"]
    HH = HC = W // 2
    n = trunk_macs(dims) + W * dims["D"]  # trunk matrices and biases
    n += W * W + W + W + 1 + W * F + F  # xyz_final, sigma, feat
    if mode.use_rgb:
        n += F * HH + HH * 3 + 3
    if mode.use_cand:
        n += (W + C) * HC + HC + HC * HC + HC + HC + 1 + HC * F + F
    return n


def pass_flops(dims: Dict, mode: Mode, R: int, S: int, kind: str) -> float:
    """FLOPs of a pass: "fwd" the forward; "bwd" the backward with weight
    gradients (data and weight products, twice the forward); "bwd_frozen"
    the backward of a frozen model (data products only)."""
    fwd = 2.0 * (sample_macs(dims, mode) * R * S)
    return {"fwd": fwd, "bwd": 2.0 * fwd, "bwd_frozen": fwd}[kind]


def pass_bytes(dims: Dict, mode: Mode, R: int, S: int, kind: str) -> float:
    """Device-memory bytes a pass must move: the rays (o, d), the depths,
    the per-ray conditioning and candidate embedding, and the weights in
    bf16 read once; the per-ray maps and per-sample weights written once
    (f32). The backward reads the same inputs and the outputs' cotangents,
    writes the inputs' cotangents and, with weight gradients, dW in f32."""
    HH, F = dims["W"] // 2, dims["feat_dim"]
    M = R * S
    ins = 6 * R + M + R * (HH * mode.use_rgb + dims["candidate_dim"] * mode.use_cand)
    per_ray_out = 1 + 3 * mode.use_rgb + F * mode.out_feat + 2 * mode.use_cand
    outs = M * (1 + mode.use_cand) + R * per_ray_out
    w = n_weights(dims, mode)
    if kind == "fwd":
        return 4.0 * (ins + outs) + 2.0 * w
    grads = ins - M + (w if kind == "bwd" else 0)  # no cotangent for the depths
    return 4.0 * (ins + outs + grads) + 2.0 * w


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: max(FLOPs / bf16 peak, bytes /
    HBM peak)."""
    return max(flops / PEAK_FLOPS_BF16, nbytes / PEAK_BYTES)


def pass_least_seconds(dims: Dict, mode: Mode, R: int, S: int, kind: str) -> float:
    return least_seconds(pass_flops(dims, mode, R, S, kind), pass_bytes(dims, mode, R, S, kind))


def transient_macs(dims: Dict) -> int:
    """Multiply-adds of the transient net for one ray: four 256-wide layers
    on the DINO feature, final, the transient embedding's layer and the
    alpha / beta / rgb heads."""
    F, T, H = dims["feat_dim"], dims["transient_dim"], 256
    return F * H + 3 * H * H + H * H + (H + T) * 128 + H + 128 + 128 * 3


# --- the model FLOPs of one unit of each traffic -----------------------------------------------


def passes(dims: Dict) -> tuple:
    """(coarse samples, fine samples) a ray evaluates."""
    return dims["N_samples"], dims["N_samples"] + dims["N_importance"]


def train_step_flops(dims: Dict, phase: int, batch: int) -> float:
    """One train step: forward and backward with weight gradients (3x the
    forward's products) of both passes, every sample, and of the transient
    net and the per-ray conditioning; no recomputation."""
    mode = mode_of_phase(phase)
    macs = sum(sample_macs(dims, mode) * S + ray_macs(dims, mode) for S in passes(dims))
    if phase > 0:
        macs += transient_macs(dims)
    return 3 * 2.0 * macs * batch


def tto_step_flops(dims: Dict, rays: int) -> float:
    """One TTO step (phase 2, frozen model): both passes forward; the fine
    pass backward for the data cotangents only (the loss reads the fine rgb;
    the coarse pass reaches it through detached weights alone)."""
    mode = mode_of_phase(2)
    coarse, fine = passes(dims)
    fwd = sum(sample_macs(dims, mode) * S + ray_macs(dims, mode) for S in (coarse, fine))
    bwd = sample_macs(dims, mode) * fine + ray_macs(dims, mode)
    return 2.0 * (fwd + bwd) * rays


def render_ray_flops(dims: Dict) -> float:
    """One served ray: both passes forward in phase 2."""
    mode = mode_of_phase(2)
    return 2.0 * sum(sample_macs(dims, mode) * S + ray_macs(dims, mode) for S in passes(dims))


# --- the preprocessing pass: DINO ViT-S/8 and DPT-Large on one image ---------------------------


def attention_flops(G: int, N: int, hd: int) -> float:
    """softmax(q k^T) v over G groups of N tokens: the two products."""
    return 4.0 * G * N * N * hd


def attention_bytes(G: int, N: int, hd: int) -> float:
    """q, k and v read and the output written once, in float32."""
    return 4.0 * 4 * G * N * hd


def attention_least_seconds(G: int, N: int, hd: int) -> float:
    return least_seconds(attention_flops(G, N, hd), attention_bytes(G, N, hd))


def vit_grid(size: int, patch: int, stride: int) -> int:
    """Tokens along a side of the patch-embedding conv's output."""
    return (size - patch) // stride + 1


def vit_block_flops(n: int, dim: int, mlp_ratio: int) -> float:
    """One pre-norm block over n tokens: attention's two products, and the
    qkv, projection and two MLP linears ((4 + 2 mlp_ratio) dim^2 a token)."""
    return attention_flops(1, n, dim) + 2.0 * n * (4 + 2 * mlp_ratio) * dim * dim


def conv_flops(pixels: int, cin: int, cout: int, k: int) -> float:
    """A k x k conv over `pixels` output pixels (a transposed conv whose
    kernel is its stride: over its input pixels)."""
    return 2.0 * pixels * cin * cout * k * k


def dino_image_flops(d: Dict) -> float:
    """DINO on one image: the patch embedding, the blocks before `layer`,
    and that block's qkv (the keys leave from it)."""
    g = vit_grid(d["load_size"], d["patch_size"], d["stride"])
    n, D = g * g + 1, d["dim"]
    return (conv_flops(g * g, 3, D, d["patch_size"]) + d["layer"] * vit_block_flops(n, D, d["mlp_ratio"])
            + 2.0 * n * D * 3 * D)


def dpt_image_flops(p: Dict) -> float:
    """DPT on one image: the backbone's every block, the four readouts, the
    reassembly (1x1 projections, the x4 / x2 transposed convs, the stride-2
    conv), the 3x3 layer_rn convs, the fusion stages (two convs a residual
    unit, the 1x1 after the x2 upsample; the deepest stage has no skip) and
    the head (3x3 at half scale, 3x3 and 1x1 at full scale)."""
    g = p["net_size"] // p["patch_size"]
    D, feat, ch = p["dim"], p["features"], p["channels"]
    f = conv_flops(g * g, 3, D, p["patch_size"]) + p["depth"] * vit_block_flops(g * g + 1, D, p["mlp_ratio"])
    f += 4 * 2.0 * g * g * 2 * D * D
    sizes = (4 * g, 2 * g, g, (g - 1) // 2 + 1)
    f += sum(conv_flops(g * g, D, c, 1) for c in ch)
    f += conv_flops(g * g, ch[0], ch[0], 4) + conv_flops(g * g, ch[1], ch[1], 2) + conv_flops(sizes[3] ** 2, ch[3],
                                                                                             ch[3], 3)
    f += sum(conv_flops(s * s, c, feat, 3) for s, c in zip(sizes, ch))
    for k, s in enumerate(sizes):
        f += (1 if k == 3 else 2) * 2 * conv_flops(s * s, feat, feat, 3) + conv_flops(4 * s * s, feat, feat, 1)
    half, full = 2 * sizes[0], 4 * sizes[0]
    return f + conv_flops(half * half, feat, feat // 2, 3) + conv_flops(full * full, feat // 2, 32, 3) + \
        conv_flops(full * full, 32, 1, 1)


def preprocess_image_flops(dims: Dict) -> float:
    """One image of the preprocessing pass: DINO, then DPT."""
    return dino_image_flops(dims["dino"]) + dpt_image_flops(dims["dpt"])
