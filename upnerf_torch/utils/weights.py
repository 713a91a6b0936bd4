"""Weights across frameworks, in the reference's checkpoint layout.

A reference checkpoint is a `torch.save`d dict
{"state_dict", "hyper_parameters", "global_step"} (PyTorch Lightning's
layout). The state_dict is flat, keyed by the reference NeRFSystem's
attribute names (`nerf_coarse.*`, `nerf_fine.*`, `transient_net.*`,
`embedding_{coarse,fine}_{a,c}.weight`, `se3_refine.weight`,
`depth_scale.weight`) with Linear weights in torch's (out, in) layout;
hyper_parameters is the flat dotted-key config dict.

- `state_dict_from_jax` maps the JAX package's parameter pytree onto that
  layout, key for key what upnerf/utils/ref_ckpt.py:export_state_dict
  writes.
- `load_reference_ckpt` reads such a file; `render_params` builds from it
  the frozen modules that serving, test-time optimization and eval read:
  both fields (NeRFField loads with strict=True, requires_grad off), the
  coarse and fine appearance tables, and the se3 table.
- `init_reference_ckpt` writes a freshly seeded model in that layout.
- `train_modules_from_jax` builds the train modules (UPNeRF, PoseTables)
  from the JAX parameter pytree, `optimizer_state_from_jax` their optimizer
  states from optax's; `export_reference_ckpt` writes a trained state back
  in the reference layout, which `render_video` reads.
- `convert_reference_run` / `export_run` (python -m
  upnerf_torch.cli.convert_weights model / export): a trained reference
  checkpoint into a port run directory, and back, with the checks of
  upnerf/utils/ref_ckpt.py.
- `vit_params_from_jax` / `dpt_params_from_jax` turn the extractors'
  parameter trees in the npz layout (upnerf/features/vit.py:11-17,
  dpt.py:14-23; numpy leaves, as `init_vit_params`, `init_dpt_params` or
  `_unflatten` give them) into the port's: the same keys, convs in torch's
  layouts. The npz loaders go through them.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from upnerf_torch.models.embeddings import init_embedding
from upnerf_torch.models.nerf import NeRFConfig, NeRFField
from upnerf_torch.models.transient import TransientConfig
from upnerf_torch.ops.linear import init_linear_

_EMBEDDINGS = (
    ("coarse_a", "embedding_coarse_a"),
    ("fine_a", "embedding_fine_a"),
    ("coarse_c", "embedding_coarse_c"),
    ("fine_c", "embedding_fine_c"),
)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def state_dict_from_jax(params: Dict[str, Any], pose_params: Dict[str, Any], progress: float):
    """The JAX parameter pytree (numpy arrays; Linear weights (in, out))
    -> the reference's flat state_dict of torch tensors."""
    sd = _model_state_dict_from_jax(params, progress)
    sd.update(_pose_state_dict_from_jax(pose_params))
    return sd


def _pose_state_dict_from_jax(pose_params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {"se3_refine.weight": _t(pose_params["se3"]), "depth_scale.weight": _t(pose_params["depth_scale"])}


def _model_state_dict_from_jax(params: Dict[str, Any], progress: float) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}

    def put_linear(prefix: str, p: Dict[str, Any]) -> None:
        sd[f"{prefix}.weight"] = _t(np.asarray(p["w"], np.float32).T)
        sd[f"{prefix}.bias"] = _t(p["b"])

    for typ in ("nerf_coarse", "nerf_fine"):
        p = params.get(typ)
        if p is None:
            continue
        sd[f"{typ}.progress"] = torch.tensor(float(progress))
        for i, lay in enumerate(p["trunk"]):
            put_linear(f"{typ}.xyz_encoding_{i + 1}.0", lay)
        put_linear(f"{typ}.xyz_encoding_final", p["xyz_final"])
        put_linear(f"{typ}.share_sigma.0", p["share_sigma"])
        put_linear(f"{typ}.rgb_share_layer.0", p["rgb_share"][0])
        put_linear(f"{typ}.rgb_share_layer.2", p["rgb_share"][1])
        if "feat_share" in p:
            put_linear(f"{typ}.feat_share_layer", p["feat_share"])
        if "cand_enc" in p:
            put_linear(f"{typ}.candidate_encoding.0", p["cand_enc"][0])
            put_linear(f"{typ}.candidate_encoding.2", p["cand_enc"][1])
            put_linear(f"{typ}.candidate_sigma.0", p["cand_sigma"])
            if "cand_feat" in p:
                put_linear(f"{typ}.feat_candidate_layer", p["cand_feat"])
            elif "cand_rgb" in p:
                put_linear(f"{typ}.rgb_candidate_layer", p["cand_rgb"])

    t = params.get("transient")
    if t is not None:
        sd["transient_net.embedding_t.weight"] = _t(t["t_emb"])
        for i, lay in enumerate(t["feat_encoder"]):
            put_linear(f"transient_net.feat_encoder.{2 * i}", lay)
        put_linear("transient_net.final_encoder", t["final_encoder"])
        put_linear("transient_net.t_encoder.0", t["t_encoder"])
        put_linear("transient_net.alpha_layer.0", t["alpha_layer"])
        put_linear("transient_net.beta_layer.0", t["beta_layer"])
        put_linear("transient_net.rgb_layer.0", t["rgb_layer"])

    for ours, theirs in _EMBEDDINGS:
        arr = params.get("embeddings", {}).get(ours)
        if arr is not None:
            sd[f"{theirs}.weight"] = _t(arr)
    return sd


def optimizer_state_from_jax(opt_state, module: nn.Module, mu: Optional[Dict[str, Any]],
                             nu: Optional[Dict[str, Any]], count: int) -> None:
    """Carry an optax optimizer state into a port one (train.optim.OptState
    over `module`'s trainable parameters), in place.

    mu, nu: the moments of optax's ScaleByAdamState (adam / adamw) as numpy
    trees in the JAX layout of the module's parameters: the parameter pytree
    for UPNeRF, {"se3", "depth_scale"} for PoseTables; None for sgd, which
    keeps no state. They become torch's exp_avg / exp_avg_sq (Linear weights
    transposed), `count` its per-parameter step, and the LR schedule is put
    at update `count`."""
    if mu is not None:
        if "se3" in mu:
            mu_sd, nu_sd = _pose_state_dict_from_jax(mu), _pose_state_dict_from_jax(nu)
        else:
            mu_sd, nu_sd = _model_state_dict_from_jax(mu, 0.0), _model_state_dict_from_jax(nu, 0.0)
        in_opt = {id(p) for g in opt_state.optimizer.param_groups for p in g["params"]}
        for name, p in module.named_parameters():
            if id(p) in in_opt:
                opt_state.optimizer.state[p] = {
                    "step": torch.tensor(float(count)),
                    "exp_avg": mu_sd[name].to(p.device, p.dtype),
                    "exp_avg_sq": nu_sd[name].to(p.device, p.dtype),
                }
    opt_state.seek(int(count))


def load_reference_ckpt(path: str) -> Tuple[Dict[str, torch.Tensor], Optional[Dict[str, Any]], int]:
    """(state_dict, hyper_parameters or None, global_step) of a reference
    checkpoint. The file is unpickled: load only checkpoints you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    hparams = ckpt.get("hyper_parameters")
    return sd, (dict(hparams) if hparams is not None else None), int(ckpt.get("global_step", 0))


def _sub(sd: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix) + 1 :]: v for k, v in sd.items() if k.startswith(prefix + ".")}


def render_params(sd: Dict[str, torch.Tensor], nerf_cfg: NeRFConfig, device) -> Tuple[Dict[str, Any], torch.Tensor]:
    """Serving modules from a reference state_dict: ({"nerf_coarse",
    "nerf_fine", "embeddings": {"coarse_a", "fine_a"}}, se3 table (N, 6)),
    all on `device`."""
    params: Dict[str, Any] = {}
    for typ in ("nerf_coarse", "nerf_fine"):
        field = NeRFField(nerf_cfg)
        field.load_state_dict(_sub(sd, typ), strict=True)
        params[typ] = field.requires_grad_(False).to(device).eval()
    params["embeddings"] = {
        ours: sd[f"{theirs}.weight"].float().to(device)
        for ours, theirs in _EMBEDDINGS[:2]
        if f"{theirs}.weight" in sd
    }
    return params, sd["se3_refine.weight"].float().to(device)


def _transient_state(hparams: Dict[str, Any], n_images: int, generator: torch.Generator):
    """The reference TransientNet's parameters (hidden 256), freshly seeded;
    the port renders without it but a reference checkpoint carries it."""
    hidden, t_dim, feat_dim = 256, hparams["t_net.transient_dim"], hparams["t_net.feat_dim"]
    layers = {
        "feat_encoder.0": (feat_dim, hidden),
        "feat_encoder.2": (hidden, hidden),
        "feat_encoder.4": (hidden, hidden),
        "feat_encoder.6": (hidden, hidden),
        "final_encoder": (hidden, hidden),
        "t_encoder.0": (hidden + t_dim, 128),
        "alpha_layer.0": (hidden, 1),
        "beta_layer.0": (128, 1),
        "rgb_layer.0": (128, 3),
    }
    sd = {"transient_net.embedding_t.weight": init_embedding(n_images, t_dim, generator).weight.data}
    for name, (fan_in, fan_out) in layers.items():
        lin = init_linear_(nn.Linear(fan_in, fan_out), generator)
        sd[f"transient_net.{name}.weight"] = lin.weight.data
        sd[f"transient_net.{name}.bias"] = lin.bias.data
    return sd


def init_reference_ckpt(path: str, hparams: Dict[str, Any], n_images: int, seed: int, progress: float = 1.0) -> str:
    """Write a freshly seeded model as a reference checkpoint at `path`.

    Every tensor is drawn from one torch.Generator seeded with `seed`:
    Linear layers U(+-1/sqrt(fan_in)), appearance/candidate/transient
    tables N(0, 1), se3 and depth-scale tables zero (the reference's init).
    `progress` is the BARF schedule position the checkpoint records."""
    gen = torch.Generator().manual_seed(seed)
    nerf_cfg = NeRFConfig.from_hparams(hparams)
    sd: Dict[str, torch.Tensor] = {}
    for typ in ("nerf_coarse", "nerf_fine"):
        field = NeRFField(nerf_cfg, generator=gen)
        with torch.no_grad():
            field.progress.fill_(progress)
        sd.update({f"{typ}.{k}": v for k, v in field.state_dict().items()})
    for ours, theirs in _EMBEDDINGS:
        dim = nerf_cfg.appearance_dim if ours.endswith("_a") else nerf_cfg.candidate_dim
        if dim > 0:
            sd[f"{theirs}.weight"] = init_embedding(n_images, dim, gen).weight.data
    sd.update(_transient_state(hparams, n_images, gen))
    sd["se3_refine.weight"] = torch.zeros(n_images, 6)
    sd["depth_scale.weight"] = torch.zeros(n_images, 2)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"state_dict": sd, "hyper_parameters": dict(hparams), "global_step": 0}, path)
    return path


def train_modules_from_jax(params: Dict[str, Any], pose_params: Dict[str, Any], nerf_cfg: NeRFConfig,
                           t_cfg: Optional[TransientConfig], n_images: int):
    """(UPNeRF, PoseTables) holding the JAX package's parameter pytree and
    pose tables (numpy arrays), loaded with strict=True: the candidate heads,
    transient_net.*, the appearance and candidate tables, se3 and
    depth_scale."""
    from upnerf_torch.train.state import PoseTables, UPNeRF

    sd = state_dict_from_jax(params, pose_params, 0.0)
    model = UPNeRF(nerf_cfg, t_cfg, n_images, fine="nerf_fine" in params)
    pose = PoseTables(n_images)
    pose_keys = ("se3_refine.weight", "depth_scale.weight")
    model.load_state_dict({k: v for k, v in sd.items() if k not in pose_keys}, strict=True)
    pose.load_state_dict({k: sd[k] for k in pose_keys}, strict=True)
    return model, pose


def reference_payload(model: nn.Module, pose: nn.Module, hparams: Dict[str, Any], step: int,
                      progress: float) -> Dict[str, Any]:
    """A trained state as a reference checkpoint {"state_dict",
    "hyper_parameters", "global_step"} on the CPU; `progress` goes into
    nerf_*.progress."""
    model.set_progress(progress)
    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    sd.update({k: v.detach().cpu().clone() for k, v in pose.state_dict().items()})
    return {"state_dict": sd, "hyper_parameters": dict(hparams), "global_step": int(step)}


def export_reference_ckpt(path: str, model: nn.Module, pose: nn.Module, hparams: Dict[str, Any], step: int,
                          progress: float, **extra) -> str:
    """Write a trained state as a reference checkpoint (reference_payload),
    with `extra` top-level keys."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(dict(reference_payload(model, pose, hparams, step, progress), **extra), path)
    return path


def train_modules_from_state_dict(sd: Dict[str, torch.Tensor], hparams: Dict[str, Any]):
    """(UPNeRF, PoseTables) of the configuration `hparams` holding a reference
    state_dict, loaded with strict=True; a checkpoint whose tensors are not
    the configuration's model raises SystemExit saying which differ."""
    from upnerf_torch.train.state import PoseTables, UPNeRF

    n_images = int(sd["se3_refine.weight"].shape[0])
    model = UPNeRF(NeRFConfig.from_hparams(hparams), TransientConfig.from_hparams(hparams), n_images,
                   fine=hparams["nerf.N_importance"] > 0)
    pose = PoseTables(n_images)
    want = {**model.state_dict(), **pose.state_dict()}
    missing, extra = sorted(set(want) - set(sd)), sorted(set(sd) - set(want))
    shapes = sorted(k for k in set(want) & set(sd) if tuple(want[k].shape) != tuple(sd[k].shape))
    if missing or extra or shapes:
        raise SystemExit("the checkpoint's tensors do not match the config's model structure: missing"
                         f" {missing[:8]}, unexpected {extra[:8]}, other shapes {shapes[:8]}")
    pose_keys = set(pose.state_dict())
    model.load_state_dict({k: v.float() for k, v in sd.items() if k not in pose_keys}, strict=True)
    pose.load_state_dict({k: sd[k].float() for k in pose_keys}, strict=True)
    return model, pose


def _check_scene_image_count(hparams: Dict[str, Any], n_images: int, log) -> None:
    """Fail early, readably, when the checkpoint's per-image tables do not
    match the train images of the scene the config names (else tto / eval
    fail later on a shape); a scene not readable here is skipped, noted."""
    from upnerf_torch.data import load_scene_meta

    try:
        meta = load_scene_meta(hparams)
    except Exception as e:  # the scene may live on another host
        log(f"note: scene not loadable here ({e!r}); skipping the image-count cross-check (tables cover"
            f" {n_images} images)")
        return
    if meta.N_images_train != n_images:
        raise SystemExit(f"checkpoint tables cover {n_images} images but the scene at {hparams.get('root_dir')!r} has"
                         f" {meta.N_images_train} train images — the checkpoint was trained on a different scene/split"
                         " (tto/eval would fail to restore it)")


def convert_reference_run(ckpt_path: str, result_dir: str, config_path: Optional[str] = None, log=print) -> str:
    """A trained reference checkpoint -> a run directory of the port
    (`config.yaml`, `ckpts/<step>.ckpt`) that cli.render_video --result_dir
    reads, and whose checkpoint cli.tto / cli.eval take. The port's
    checkpoints are reference checkpoints already, so the tensors are copied
    as they are, after the JAX converter's checks: the hyper_parameters (or
    --config), the scene's image count, the model structure. The reference's
    global_step counts both optimizers' steps under pose optimization;
    `step` counts batches. Returns the checkpoint's path."""
    from upnerf_torch.config import get_from_path, save_yaml
    from upnerf_torch.utils.ckpt import CheckpointManager

    sd, ckpt_hparams, global_step = load_reference_ckpt(ckpt_path)
    if config_path is not None:
        hparams = get_from_path(config_path)
    elif ckpt_hparams is not None:
        hparams = ckpt_hparams
    else:
        raise SystemExit("checkpoint has no hyper_parameters; pass --config <yaml>")
    n_images = int(sd["se3_refine.weight"].shape[0])
    _check_scene_image_count(hparams, n_images, log)
    model, pose = train_modules_from_state_dict(sd, hparams)
    step = global_step // 2 if hparams.get("pose.optimize", True) else global_step
    progress = float(sd["nerf_coarse.progress"]) if "nerf_coarse.progress" in sd else None
    if progress and hparams.get("max_steps"):
        from_progress = progress * float(hparams["max_steps"])
        if abs(from_progress - step) > max(1.0, 0.01 * step):
            log(f"note: checkpoint progress={progress:.4f} implies step ~{from_progress:.0f} but global_step maps to"
                f" {step}; keeping the global_step mapping (schedules resume from `step`, so a mismatch shifts the"
                " anneal)")
    os.makedirs(result_dir, exist_ok=True)
    save_yaml(hparams, os.path.join(result_dir, "config.yaml"))
    if progress is None:
        progress = min(float(step) / float(hparams["max_steps"]), 1.0)
    path = CheckpointManager(os.path.join(result_dir, "ckpts")).save(
        step, reference_payload(model, pose, hparams, step, progress))
    log(f"converted step-{step} checkpoint ({n_images} images, progress={progress}) -> {result_dir}")
    return path


def export_run(result_dir: str, out_path: str, ckpt: str = "last", log=print) -> str:
    """A run directory of the port -> a reference Lightning checkpoint
    (state_dict, hyper_parameters, global_step) through
    export_reference_ckpt: the `last` or `best` checkpoint's tensors, the BARF
    progress min(step / max_steps, 1), and global_step doubled under pose
    optimization, as Lightning counts both optimizers' steps. Optimizer
    states are not carried over."""
    from upnerf_torch.config import get_from_path
    from upnerf_torch.utils.ckpt import CheckpointManager

    hparams = get_from_path(os.path.join(result_dir, "config.yaml"))
    mngr = CheckpointManager(os.path.join(result_dir, "ckpts"))
    step = mngr.best_step() if ckpt == "best" else mngr.latest_step()
    if step is None:
        raise SystemExit(f"no checkpoint under {result_dir}/ckpts")
    model, pose = train_modules_from_state_dict(mngr.load(step)["state_dict"], hparams)
    progress = min(float(step) / float(hparams["max_steps"]), 1.0)
    global_step = int(step) * (2 if hparams.get("pose.optimize", True) else 1)
    export_reference_ckpt(out_path, model, pose, hparams, global_step, progress, epoch=0,
                          **{"pytorch-lightning_version": "1.9.0"})
    log(f"exported step-{step} state (progress={progress:.4f}, global_step {global_step}) -> {out_path}")
    return out_path


# XLA conv_transpose kernels of the DPT neck (upnerf/features/dpt.py:150-152).
_TRANSPOSED_CONVS = ("reassemble0/resample/w", "reassemble1/resample/w")


def _extractor_params(tree: Dict[str, Any], device, prefix: str = "") -> Dict[str, Any]:
    """npz-layout tree -> torch tree on `device`. Every 4-D leaf is a conv
    kernel in HWIO: to (out, in, kh, kw), or for XLA's conv_transpose (no
    kernel transpose) to F.conv_transpose2d's (in, out, kh, kw), spatially
    flipped. Everything else is copied as float32."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        path = prefix + k
        if isinstance(v, dict):
            out[k] = _extractor_params(v, device, path + "/")
            continue
        a = np.asarray(v, np.float32)
        if a.ndim == 4:
            a = a[::-1, ::-1].transpose(2, 3, 0, 1) if path in _TRANSPOSED_CONVS else a.transpose(3, 2, 0, 1)
        out[k] = _t(a).to(device)
    return out


def vit_params_from_jax(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """ViT parameters, npz layout -> the port's (upnerf_torch/features/vit.py):
    the patch-embed conv HWIO -> (D, 3, P, P); linears stay (in, out)."""
    return _extractor_params(tree, device)


def dpt_params_from_jax(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """DPT parameters, npz layout -> the port's (upnerf_torch/features/dpt.py):
    convs HWIO -> (out, in, kh, kw), the transposed convs of reassemble0/1 ->
    (in, out, kh, kw) flipped, linears stay (in, out)."""
    return _extractor_params(tree, device)
