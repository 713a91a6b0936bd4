"""`python -m upnerf_torch.cli.convert_weights` against the JAX package's CLI
(upnerf.cli.convert_weights), on the CPU:
- `model`: a JAX run directory (written by upnerf.utils.ref_ckpt from a
  seeded init with a non-zero se3 table) exported by the JAX CLI, then
  converted by the port's: the step maps back, the tensors are the JAX
  run's, and the port's render of the run (cli.render_video's loader,
  deterministic rays in phase 2) equals JAX's render of its params, 1e-5;
  cli.render_video renders the run directory, and the port's Trainer resumes
  it (fresh optimizers, as JAX's converted runs);
- `export`: a run of the port's train CLI exported by the port's CLI, then
  converted by the JAX CLI's `model`: the parameters and tables of the JAX
  run directory equal the port's checkpoint bit for bit;
- `dino` / `dpt` from seeded torch state dicts at the published widths (DINO
  ViT-S/8 whole; DPT-Large with its backbone cut to 2 of 24 blocks, every
  tensor at its published shape) write the JAX converters' npz bit for bit;
- `lpips` through a stub `lpips` module equal to the JAX converter's npz, and
  without the package a SystemExit that says what is missing;
- a checkpoint whose tables do not cover the scene's train images, one whose
  tensors are not the config's model, one without hyper_parameters, and a
  wrong argument count: SystemExit.
"""

import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from upnerf.cli import convert_weights as jcli
from upnerf_torch.cli import convert_weights as cli
from upnerf_torch.utils import weights

MODEL = {"nerf.D": 2, "nerf.W": 32, "nerf.skips": (1,), "nerf.N_samples": 8, "nerf.N_importance": 4,
         "nerf.N_emb_xyz": 4, "nerf.N_emb_dir": 2, "nerf.appearance_dim": 8, "nerf.candidate_dim": 4,
         "nerf.feat_dim": 8, "t_net.feat_dim": 8, "t_net.transient_dim": 8, "tpu.matmul_precision": "float32"}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from upnerf.data import synthetic

    root = str(tmp_path_factory.mktemp("cw") / "scene")
    synthetic.generate_scene(root, n_train=3, n_test=1, H=20, W=24, feat_hw=6, feat_dim=8)
    return root


def scene_hp(default, root, **over):
    hp = default()
    hp.update({"dataset_name": "custom", "scene_name": "toy", "root_dir": root,
               "feat_dir": os.path.join(root, "DINO"), "depth_dir": os.path.join(root, "DPT"),
               "phototourism.img_downscale": 1, "phototourism.use_cache": False, "max_steps": 40, **MODEL})
    hp.update(over)
    return hp


def rays_of(n=16, seed=3):
    rng = np.random.RandomState(seed)
    o = (rng.randn(n, 3) * 0.1).astype(np.float32)
    d = np.concatenate([rng.randn(n, 2) * 0.2, -np.ones((n, 1))], -1)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return np.concatenate([o, d, np.tile([[0.1, 5.0]], (n, 1))], -1).astype(np.float32)


def test_model_of_a_jax_export_renders_as_jax(scene, tmp_path):
    from upnerf.config import default as jdefault
    from upnerf.models import NeRFConfig as JNeRFConfig
    from upnerf.render import RenderConfig as JRenderConfig
    from upnerf.render import render_rays as jrender_rays
    from upnerf.train import init_params as jinit_params
    from upnerf.utils.ref_ckpt import write_framework_ckpt
    from upnerf_torch.models.nerf import NeRFConfig
    from upnerf_torch.render.render_rays import RenderConfig, render_rays

    hp = scene_hp(jdefault, scene, max_steps=40)
    jcfg = JNeRFConfig.from_hparams(hp)
    from upnerf.models import TransientConfig as JTransientConfig

    params = jinit_params(jax.random.PRNGKey(7), jcfg, JTransientConfig.from_hparams(hp), 3)
    pose = {"se3": jnp.asarray(np.random.RandomState(8).randn(3, 6).astype(np.float32) * 0.05),
            "depth_scale": jnp.zeros((3, 2), jnp.float32)}
    jrun, ref, prun = str(tmp_path / "jax_run"), str(tmp_path / "ref.ckpt"), str(tmp_path / "out" / "toy" / "conv")
    write_framework_ckpt(jrun, hp, params, pose, 3, 10)
    jcli.main(["export", jrun, ref])
    cli.main(["model", ref, prun])

    ckpt = os.path.join(prun, "ckpts", "10.ckpt")
    assert os.path.isfile(os.path.join(prun, "config.yaml")) and os.path.isfile(ckpt)
    sd, hparams, gstep = weights.load_reference_ckpt(ckpt)
    assert gstep == 10 and hparams["nerf.W"] == 32
    np.testing.assert_array_equal(sd["se3_refine.weight"].numpy(), np.asarray(pose["se3"]))
    want_sd = weights.state_dict_from_jax(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, pose), 0.25)
    assert set(sd) == set(want_sd)
    for k in want_sd:
        assert torch.equal(sd[k], want_sd[k]), k

    rays = rays_of()
    idx = np.array([0, 1, 2, 1] * 4, np.int32)
    jrc = JRenderConfig(N_samples=8, N_importance=4, perturb=0.0, encode_feat=True, precision="float32")
    rp = {"nerf_coarse": params["nerf_coarse"], "nerf_fine": params["nerf_fine"], "embeddings": params["embeddings"]}
    want = jrender_rays(rp, jrc, jcfg, jnp.asarray(rays), jnp.asarray(idx), key=None, phase=2, det=True,
                        sched_mult=jnp.asarray(1.0), progress=jnp.asarray(0.25, jnp.float32))
    tparams, _ = weights.render_params(sd, NeRFConfig.from_hparams(hparams), "cpu")
    with torch.no_grad():
        got = render_rays(tparams, RenderConfig.from_hparams(hparams)._replace(perturb=0.0), torch.from_numpy(rays),
                          torch.from_numpy(idx).long(), phase=2, det=True, progress=0.25)
    for k in ("s_rgb_fine", "s_depth_fine", "s_rgb_coarse"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5, err_msg=k)

    from upnerf_torch.cli import render_video
    from upnerf_torch.config import get_from_path
    from upnerf_torch.train.loop import Trainer

    out = render_video.main(["--result_dir", prun, "--frames", "1", "--out", str(tmp_path / "video"), "--device",
                             "cpu"])
    assert np.isfinite(np.load(out["depths"][0])).all()

    trainer = Trainer(dict(get_from_path(os.path.join(prun, "config.yaml")), out_dir=str(tmp_path / "out"),
                           exp_name="conv", debug=True, **{"train.batch_size": 64, "val.chunk_size": 128}),
                      device="cpu")
    assert trainer.save_dir == prun
    assert trainer.fit(log_every=2, max_steps=12).step == 12

    with open(os.path.join(prun, "metrics.jsonl")) as f:  # it resumed at step 10: one log point, at 12
        assert [r["step"] for r in map(json.loads, f) if "loss" in r] == [12]
    moved = trainer.state.pose_params.se3_refine.weight.detach().numpy()
    assert not np.array_equal(moved, np.asarray(pose["se3"])) and np.abs(moved - np.asarray(pose["se3"])).max() < 0.1


def test_export_of_a_port_run_converts_in_jax(scene, tmp_path):
    from upnerf.utils.ckpt import CheckpointManager as JCheckpointManager
    from upnerf_torch.cli import train as train_cli

    argv = ["--config", os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs", "custom.yaml"),
            "--device", "cpu"]
    over = scene_hp(dict, scene, out_dir=str(tmp_path / "out"), exp_name="cw", max_steps=4, debug=True,
                    **{"train.batch_size": 64, "val.log_interval": 4, "val.chunk_size": 128})
    for k, v in over.items():
        argv += [k, str(list(v) if isinstance(v, tuple) else v)]
    trainer = train_cli.main(argv)
    ref, jrun = str(tmp_path / "exported.ckpt"), str(tmp_path / "jax_run")
    cli.main(["export", trainer.save_dir, ref, "--ckpt", "best"])
    out = torch.load(ref, map_location="cpu", weights_only=False)
    assert out["global_step"] == 8 and out["epoch"] == 0 and out["hyper_parameters"]["max_steps"] == 4
    assert float(out["state_dict"]["nerf_coarse.progress"]) == 1.0
    jcli.main(["model", ref, jrun])

    mngr = JCheckpointManager(os.path.join(jrun, "ckpts"))
    assert mngr.latest_step() == 4
    raw = mngr.restore_raw(4)
    mngr.close()
    got = weights.state_dict_from_jax(jax.tree.map(np.asarray, raw["params"]),
                                      jax.tree.map(np.asarray, raw["pose_params"]), 1.0)
    want = trainer.ckpt.load(4)["state_dict"]
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k].float()), k


def test_mismatches_exit(scene, tmp_path):
    from upnerf_torch.config import default, save_yaml

    hp = scene_hp(default, scene)
    good = weights.init_reference_ckpt(str(tmp_path / "good.ckpt"), hp, n_images=3, seed=0)
    cli.main(["model", good, str(tmp_path / "ok")])
    ck = torch.load(good, weights_only=False)

    few = dict(ck, state_dict=dict(ck["state_dict"], **{"se3_refine.weight": torch.zeros(4, 6)}))
    torch.save(few, tmp_path / "few.ckpt")
    with pytest.raises(SystemExit, match="cover 4 images but the scene"):
        cli.main(["model", str(tmp_path / "few.ckpt"), str(tmp_path / "a")])
    save_yaml(dict(hp, **{"nerf.W": 64}), str(tmp_path / "wide.yaml"))
    with pytest.raises(SystemExit, match="model structure"):
        cli.main(["model", good, str(tmp_path / "b"), "--config", str(tmp_path / "wide.yaml")])
    torch.save({"state_dict": ck["state_dict"], "global_step": 0}, tmp_path / "bare.ckpt")
    with pytest.raises(SystemExit, match="no hyper_parameters"):
        cli.main(["model", str(tmp_path / "bare.ckpt"), str(tmp_path / "c")])
    with pytest.raises(SystemExit):
        cli.main(["model", good])
    with pytest.raises(SystemExit, match="no checkpoint"):
        os.makedirs(tmp_path / "empty", exist_ok=True)
        save_yaml(hp, str(tmp_path / "empty" / "config.yaml"))
        cli.main(["export", str(tmp_path / "empty"), str(tmp_path / "x.ckpt")])


def _vit_state(prefix, dim, depth, patch, grid, g):
    def r(*shape):
        return torch.randn(*shape, generator=g) * 0.02

    sd = {prefix + "patch_embed.proj.weight": r(dim, 3, patch, patch), prefix + "patch_embed.proj.bias": r(dim),
          prefix + "cls_token": r(1, 1, dim), prefix + "pos_embed": r(1, 1 + grid**2, dim),
          prefix + "norm.weight": 1 + r(dim), prefix + "norm.bias": r(dim)}
    for i in range(depth):
        b = f"{prefix}blocks.{i}."
        for name, shape in (("norm1.weight", (dim,)), ("norm1.bias", (dim,)), ("attn.qkv.weight", (3 * dim, dim)),
                            ("attn.qkv.bias", (3 * dim,)), ("attn.proj.weight", (dim, dim)), ("attn.proj.bias", (dim,)),
                            ("norm2.weight", (dim,)), ("norm2.bias", (dim,)), ("mlp.fc1.weight", (4 * dim, dim)),
                            ("mlp.fc1.bias", (4 * dim,)), ("mlp.fc2.weight", (dim, 4 * dim)), ("mlp.fc2.bias", (dim,))):
            sd[b + name] = r(*shape)
    return sd


def _dpt_state(g, dim=1024, depth=2, grid=24, chans=(256, 512, 1024, 1024), feat=256, h1=128, h2=32):
    """DPT-Large's midas state dict at its published tensor shapes (the
    backbone cut to `depth` blocks)."""
    def r(*shape):
        return torch.randn(*shape, generator=g) * 0.02

    sd = _vit_state("pretrained.model.", dim, depth, 16, grid, g)
    for k, ch in enumerate(chans):
        pp = f"pretrained.act_postprocess{k + 1}"
        sd.update({pp + ".0.project.0.weight": r(dim, 2 * dim), pp + ".0.project.0.bias": r(dim),
                   pp + ".3.weight": r(ch, dim, 1, 1), pp + ".3.bias": r(ch)})
        if k < 2 or k == 3:
            ks = {0: 4, 1: 2, 3: 3}[k]
            sd.update({pp + ".4.weight": r(ch, ch, ks, ks), pp + ".4.bias": r(ch)})
        sd[f"scratch.layer{k + 1}_rn.weight"] = r(feat, ch, 3, 3)
    for n in range(1, 5):
        rn = f"scratch.refinenet{n}"
        for unit in (1, 2):
            for c in (1, 2):
                sd[f"{rn}.resConfUnit{unit}.conv{c}.weight"] = r(feat, feat, 3, 3)
                sd[f"{rn}.resConfUnit{unit}.conv{c}.bias"] = r(feat)
        sd[rn + ".out_conv.weight"], sd[rn + ".out_conv.bias"] = r(feat, feat, 1, 1), r(feat)
    sd.update({"scratch.output_conv.0.weight": r(h1, feat, 3, 3), "scratch.output_conv.0.bias": r(h1),
               "scratch.output_conv.2.weight": r(h2, h1, 3, 3), "scratch.output_conv.2.bias": r(h2),
               "scratch.output_conv.4.weight": r(1, h2, 1, 1), "scratch.output_conv.4.bias": r(1)})
    return sd


@pytest.mark.parametrize("kind", ["dino", "dpt"])
def test_extractor_converters_match_jax(kind, tmp_path):
    g = torch.Generator().manual_seed(11)
    src = str(tmp_path / f"{kind}.pt")
    if kind == "dino":  # ViT-S/8: dim 384, 12 blocks, 224 / 8 = 28 patches a side
        torch.save({"teacher": {"backbone." + k: v for k, v in _vit_state("", 384, 12, 8, 28, g).items()}}, src)
    else:
        torch.save({"state_dict": _dpt_state(g)}, src)
    jcli.main([kind, src, str(tmp_path / "jax.npz")])
    cli.main([kind, src, str(tmp_path / "port.npz")])
    with np.load(tmp_path / "jax.npz") as want, np.load(tmp_path / "port.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


class _StubLPIPS:
    """The attributes of lpips.LPIPS(net="alex") the converters read, seeded."""

    def __init__(self, net="alex"):
        assert net == "alex"
        torch.manual_seed(0)
        self.net = types.SimpleNamespace(
            slice1=nn.Sequential(nn.Conv2d(3, 64, 11, 4, 2), nn.ReLU()),
            slice2=nn.Sequential(nn.MaxPool2d(3, 2), nn.Conv2d(64, 192, 5, padding=2), nn.ReLU()),
            slice3=nn.Sequential(nn.MaxPool2d(3, 2), nn.Conv2d(192, 384, 3, padding=1), nn.ReLU()),
            slice4=nn.Sequential(nn.Conv2d(384, 256, 3, padding=1), nn.ReLU()),
            slice5=nn.Sequential(nn.Conv2d(256, 256, 3, padding=1), nn.ReLU()))
        for i, c in enumerate((64, 192, 384, 256, 256)):
            setattr(self, f"lin{i}", types.SimpleNamespace(model=nn.Sequential(nn.Dropout(),
                                                                                  nn.Conv2d(c, 1, 1, bias=False))))


def test_lpips_converter(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "lpips", types.SimpleNamespace(LPIPS=_StubLPIPS))
    jcli.main(["lpips", str(tmp_path / "jax.npz")])
    cli.main(["lpips", str(tmp_path / "port.npz")])
    with np.load(tmp_path / "jax.npz") as want, np.load(tmp_path / "port.npz") as got:
        assert sorted(got.files) == sorted(want.files) and len(got.files) == 15
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    monkeypatch.setitem(sys.modules, "lpips", None)  # import lpips -> ImportError
    with pytest.raises(SystemExit, match="needs the `lpips` package"):
        cli.main(["lpips", str(tmp_path / "none.npz")])
