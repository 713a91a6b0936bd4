"""Test-time optimization of upnerf_torch against the JAX package, and the
fused backward's frozen-model mode it runs.

- `render_train_rays_bwd_plain` with param_grads=False against the Pallas
  kernel's VJP in the interpreter with param_grads=False (save_chain), every
  mode of tests/test_render_train_kernel.py: the data cotangents within 1e-4
  of each leaf's max, equal bit for bit to the plain train mode's, and no
  weight gradient; `RenderTrainRays` returns None for every weight and
  refuses a weight that requires grad;
- `align_test_poses` (both gauge estimators): 1e-5;
- one teacher-forced TTO step in phase A (pose + embedding, two Adams) and in
  phase B (embedding, AdamW with optax's weight decay), with the same pixels
  and render uniforms on both sides: the loss (1e-5 relative) and the
  gradients (1e-4 of each leaf's max) against `jax.value_and_grad` of the JAX
  `_render_group_rays`, the updated parameters against optax (1e-6);
- `make_tto_eval` on the same group: 1e-4 on rgb;
- the tto and eval CLIs end to end on a tiny checkpoint and scene, sharded
  and merged.
At D=4, W=32 (the tiny model of tests/test_torch_render_slice.py), float32;
the JAX package runs its XLA path on the CPU.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from upnerf.data.synthetic import generate_scene
from upnerf.evaluate import tto as jtto
from upnerf.models import NeRFConfig as JNeRFConfig
from upnerf.ops import pallas_render_train as jrt
from upnerf.render import RenderConfig as JRenderConfig
from upnerf.utils.ref_ckpt import convert_state_dict
from upnerf_torch.cli import eval as eval_cli
from upnerf_torch.cli import tto as tto_cli
from upnerf_torch.data import load_scene_meta
from upnerf_torch.evaluate import tto
from upnerf_torch.geometry import se3
from upnerf_torch.models.nerf import NeRFConfig
from upnerf_torch.ops import render_train as rt
from upnerf_torch.render.render_rays import RenderConfig
from upnerf_torch.utils import weights

from test_torch_train_kernel import COMBOS, IDS, cotangents, jax_vjp, make_inputs, statics, to_torch

HP = {
    "nerf.D": 4, "nerf.W": 32, "nerf.skips": (2,), "nerf.N_emb_xyz": 4, "nerf.N_emb_dir": 2,
    "nerf.feat_dim": 16, "nerf.appearance_dim": 8, "nerf.candidate_dim": 4, "pose.c2f": (0.1, 0.5),
    "nerf.N_samples": 8, "nerf.N_importance": 8, "nerf.near": 0.1, "nerf.far": 5.0,
    "nerf.use_disp": False, "nerf.perturb": 1.0, "val.chunk_size": 64, "tpu.matmul_precision": "float32",
    "t_net.transient_dim": 8, "t_net.feat_dim": 16, "t_net.beta_min": 0.1,
}
G, B, IMG_WH = 2, 24, (12, 10)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_leaf_close(got, want, rel, name):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32).reshape(want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=rel, err_msg=name)


# ---------------------------------------------------------------------------
# the frozen-model backward


@pytest.mark.parametrize("combo", COMBOS, ids=IDS)
def test_frozen_plain_backward_matches_pallas_vjp(combo, monkeypatch):
    monkeypatch.setattr(jrt, "INTERPRET", True)
    st, jst = statics(*combo)
    frozen, jfrozen = st._replace(param_grads=False), jst._replace(param_grads=False)
    inputs = make_inputs(st, seed=4)
    cots = cotangents(st)
    o, d, z, pe_w, cond, cemb, trunk, heads = to_torch(inputs)
    _, res = rt.render_train_rays_plain(o, d, z, pe_w, cond, trunk, heads, st, c_emb=cemb, save_res=True)
    tcots = {k: torch.from_numpy(v) for k, v in cots.items()}
    got = rt.render_train_rays_bwd_plain(o, d, z, pe_w, cond, trunk, heads, frozen, cemb, res, tcots)
    train = rt.render_train_rays_bwd_plain(o, d, z, pe_w, cond, trunk, heads, st, cemb, res, tcots)
    want = jax_vjp(inputs, jfrozen, cots)
    assert got[4] is None and got[5] is None
    for i, name in enumerate(["rays_o", "rays_d", "ray_cond", "c_emb"]):
        if want[i] is None:
            assert got[i] is None
            continue
        assert_leaf_close(got[i], want[i], 1e-4, name)
        assert torch.equal(got[i], train[i]), name  # the data path does not depend on the mode
    for leaf in jax.tree.leaves((want[4], want[5])):  # the JAX kernel hands back zeros
        assert not np.any(np.asarray(leaf))


def test_frozen_render_function_returns_no_weight_gradients():
    st, _ = statics(False, True, False)
    frozen = st._replace(param_grads=False)
    o, d, z, pe_w, cond, cemb, trunk, heads = to_torch(make_inputs(st, seed=5))
    o.requires_grad_(True)
    cond.requires_grad_(True)
    out = rt.render_train_rays(o, d, z, pe_w, cond, trunk, heads, frozen)
    out["rgb_map"].sum().backward()
    want = rt.render_train_rays_bwd_plain(
        o, d, z, pe_w, cond, trunk, heads, frozen, None,
        rt.render_train_rays_plain(o, d, z, pe_w, cond, trunk, heads, st, save_res=True)[1],
        {"rgb_map": torch.ones(o.shape[0], 3)})
    assert torch.equal(o.grad, want[0]) and torch.equal(cond.grad, want[2])
    assert all(t.grad is None for wb in trunk for t in wb) and all(v.grad is None for v in heads.values())
    trunk[0][0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="param_grads=False"):
        rt.render_train_rays(o, d, z, pe_w, cond, trunk, heads, frozen)


# ---------------------------------------------------------------------------
# TTO


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(port frozen params, JAX frozen params) of one seeded tiny model."""
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.ckpt")
    weights.init_reference_ckpt(path, HP, n_images=3, seed=7)
    sd, _, _ = weights.load_reference_ckpt(path)
    params, _ = weights.render_params(sd, NeRFConfig.from_hparams(HP), "cpu")
    jparams, _, _ = convert_state_dict(sd)
    jparams = jax.tree.map(jnp.asarray, {k: jparams[k] for k in ("nerf_coarse", "nerf_fine", "embeddings")})
    return params, jparams


def configs():
    cfg = tto.TTOConfig(nerf=NeRFConfig.from_hparams(HP),
                        render=RenderConfig.from_hparams(HP)._replace(perturb=1.0, param_grads=False), batch_size=B)
    jcfg = jtto.TTOConfig(nerf=JNeRFConfig.from_hparams(HP), render=JRenderConfig.from_hparams(HP)._replace(
        perturb=1.0), batch_size=B)
    return cfg, jcfg


def group_np(seed=0):
    """A group of G images of IMG_WH (the second one narrower) with cameras
    near (0, 0, 3) looking at the origin."""
    rng = np.random.RandomState(seed)
    w, h = IMG_WH
    Ks = np.tile(np.array([[10.0, 0, w / 2], [0, 10.0, h / 2], [0, 0, 1]], np.float32), (G, 1, 1))
    poses = np.asarray(jtto.se3.se3_to_SE3(jnp.asarray(rng.randn(G, 6).astype(np.float32) * 0.05)))
    poses = np.array(poses)
    poses[:, 2, 3] += 3.0
    rgbs = rng.randint(0, 256, (G, h, w, 3)).astype(np.uint8)
    wh = np.array([[w, h], [w - 3, h - 2]], np.int32)
    near_far = np.tile([[0.1, 5.0]], (G, 1)).astype(np.float32)
    return Ks, poses.astype(np.float32), rgbs, wh, near_far


def groups(seed=0):
    arrs = group_np(seed)
    return tto.TTOGroup(*[torch.from_numpy(a) for a in arrs]), jtto.TTOGroup(*[jnp.asarray(a) for a in arrs])


def draws(seed, x_frac):
    """Pixels inside each image's region and the render's uniforms."""
    rng = np.random.RandomState(seed)
    _, _, _, wh, _ = group_np()
    lo = np.floor(wh[:, 0] * x_frac[0])
    hi = np.where(x_frac[1] < 1.0, np.floor(wh[:, 0] * x_frac[1]), wh[:, 0])
    px = np.floor(lo[:, None] + rng.rand(G, B) * (hi - lo)[:, None]).astype(np.float32)
    py = np.floor(rng.rand(G, B) * wh[:, 1:2]).astype(np.float32)
    noise = {"coarse": rng.rand(G, B, HP["nerf.N_samples"]).astype(np.float32),
             "fine": rng.rand(G, B, HP["nerf.N_importance"]).astype(np.float32)}
    return px, py, noise


@pytest.mark.parametrize("phase", ["A", "B"])
def test_tto_step_matches_jax(model, phase):
    params, jparams = model
    cfg, jcfg = configs()
    group, jgroup = groups()
    pose = phase == "A"
    x_frac = (0.0, 1.0) if pose else (0.0, 0.5)
    px, py, noise = draws(11, x_frac)
    rng = np.random.RandomState(12)
    init = {"fine_a": rng.randn(G, HP["nerf.appearance_dim"]).astype(np.float32)}
    if pose:
        init["se3"] = (rng.randn(G, 6) * 0.01).astype(np.float32)

    # JAX: value_and_grad of the group render's MSE, then the optimizer's update
    jrunner = jtto.TTORunner(jparams, jcfg, HP["nerf.appearance_dim"], (16, 16), (16, 16))
    jopt = jrunner.opt_A if pose else jrunner.opt_B
    jtrain = {k: jnp.asarray(v) for k, v in init.items()}
    flat = {k: jnp.asarray(v.reshape(-1, v.shape[-1])) for k, v in noise.items()}

    def loss_fn(tr):
        se3_delta = tr["se3"] if pose else jnp.zeros((G, 6))
        pred, gt = jtto._render_group_rays(jparams, tr["fine_a"], se3_delta, jcfg, jgroup, jnp.asarray(px),
                                           jnp.asarray(py), None, det=False, noise=flat)
        return ((pred - gt) ** 2).mean()

    jloss, jgrads = jax.value_and_grad(loss_fn)(jtrain)
    updates, _ = jopt.update(jgrads, jopt.init(jtrain), jtrain)
    jnew = optax.apply_updates(jtrain, updates)

    # the port: one step with the same pixels and uniforms
    runner = tto.TTORunner(params, cfg, HP["nerf.appearance_dim"], (16, 16), (16, 16))
    trainables = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in init.items()}
    opt = runner.opt_A(trainables) if pose else runner.opt_B(trainables)
    step = runner.step_A if pose else runner.step_B
    before = (rt.launches, rt.frozen_bwd_launches)
    loss = step(trainables, opt, group, px=torch.from_numpy(px), py=torch.from_numpy(py),
                noise={k: torch.from_numpy(v) for k, v in noise.items()})
    assert (rt.launches, rt.frozen_bwd_launches) == before  # the CPU runs the plain versions
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in init:
        assert_leaf_close(trainables[k].grad.numpy(), jgrads[k], 1e-4, k)
        np.testing.assert_allclose(trainables[k].detach().numpy(), np.asarray(jnew[k]), rtol=0, atol=1e-6,
                                   err_msg=k)
    assert not np.allclose(trainables["fine_a"].detach().numpy(), init["fine_a"])


def test_tto_eval_matches_jax(model):
    params, jparams = model
    cfg, jcfg = configs()
    group, jgroup = groups(seed=1)
    rng = np.random.RandomState(13)
    init = {"fine_a": rng.randn(G, HP["nerf.appearance_dim"]).astype(np.float32),
            "se3": (rng.randn(G, 6) * 0.01).astype(np.float32)}
    for x_frac in ((0.0, 1.0), (0.5, 1.0)):
        Hm, Wm = tto.tto_region_size(group.wh.numpy(), x_frac, bucket=8)
        assert (Hm, Wm) == jtto.tto_region_size(np.asarray(jgroup.wh), x_frac, bucket=8)
        jpred, jgt = jtto.make_tto_eval(jparams, jcfg, x_frac=x_frac, chunk=64)(
            {k: jnp.asarray(v) for k, v in init.items()}, jgroup, Hm, Wm)
        pred, gt = tto.make_tto_eval(params, cfg, x_frac=x_frac, chunk=64)(
            {k: torch.from_numpy(v) for k, v in init.items()}, group, Hm, Wm)
        np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=0, atol=1e-4)
        np.testing.assert_allclose(gt.numpy(), np.asarray(jgt), rtol=0, atol=1e-7)  # u8 / 255, last bit
        np.testing.assert_allclose(tto._masked_psnr(pred, gt, group.wh.numpy(), x_frac),
                                   jtto._masked_psnr(jpred, jgt, np.asarray(jgroup.wh), x_frac), rtol=1e-4)


def test_sample_pixels_keeps_the_halves_apart_at_odd_widths():
    wh = torch.tensor([[13, 7], [9, 5]], dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    left, _ = tto._sample_pixels(gen, wh, (0.0, 0.5), 4000)
    right, py = tto._sample_pixels(gen, wh, (0.5, 1.0), 4000)
    for g, w in enumerate((13, 9)):
        assert set(left[g].long().tolist()) == set(range(w // 2))
        assert set(right[g].long().tolist()) == set(range(w // 2, w))
        assert py[g].max() < wh[g, 1]


@pytest.mark.parametrize("rot_from", ["orientations", "centers"])
def test_align_test_poses_matches_jax(rot_from):
    rng = np.random.RandomState(3)
    gt = np.asarray(jtto.se3.se3_to_SE3(jnp.asarray(rng.randn(8, 6).astype(np.float32) * 0.8)))
    se3_table = (rng.randn(6, 6) * 0.3).astype(np.float32)
    base = np.asarray(jtto.se3.se3_to_SE3(jnp.asarray(rng.randn(6, 6).astype(np.float32) * 0.1)))
    for b in (None, base):
        got = tto.align_test_poses(se3_table, gt[:6], gt[6:], base_train_poses=b, rot_from=rot_from)
        want = jtto.align_test_poses(se3_table, gt[:6], gt[6:], base_train_poses=b, rot_from=rot_from)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def test_tto_and_eval_clis_end_to_end(tmp_path, capsys):
    """A tiny checkpoint whose se3 table holds the GT train poses, on a
    Phototourism-layout scene: tto writes a_optimize/ in the JAX CLI's layout
    (two shards), eval merges the shards and prints train pose errors of ~0."""
    root = str(tmp_path / "scene")
    generate_scene(root, n_train=3, n_test=2, H=20, W=24, focal=20.0, seed=0, phototourism_layout=True)
    hp = dict(HP, dataset_name="phototourism", root_dir=root, scene_name="scene", seed=0,
              **{"phototourism.img_downscale": 2, "pose.noise": -1})
    ckpt = weights.init_reference_ckpt(str(tmp_path / "m.ckpt"), hp, n_images=3, seed=1)
    meta = load_scene_meta(hp)
    saved = torch.load(ckpt, weights_only=False)
    gt = torch.tensor(np.stack([meta.GT_poses_dict[i] for i in meta.img_ids_train]))
    saved["state_dict"]["se3_refine.weight"] = se3.SE3_to_se3(gt)
    torch.save(saved, ckpt)
    result = str(tmp_path / "result")
    paths = [tto_cli.main(["--ckpt", ckpt, "--result_dir", result, "--device", "cpu", "--batch_size", "16",
                           "--pose_epochs", "2", "--appearance_epochs", "1", "--group_size", "1", "--shard", f"{i}/2"])
             for i in range(2)]
    assert [os.path.basename(p) for p in paths] == ["metrics.shard0of2.json", "metrics.shard1of2.json"]
    save_root = os.path.join(result, "a_optimize")
    for i in range(2):
        with open(paths[i]) as f:
            m = json.load(f)
        assert list(m) == [str(i)] and set(m[str(i)]) == {"psnr", "ssim", "lpips"}
        assert np.isfinite(m[str(i)]["psnr"]) and np.isfinite(m[str(i)]["ssim"]) and m[str(i)]["lpips"] is None
        pose = np.load(os.path.join(save_root, "optimized_pose", f"best_pose_{i:02d}.npy"))
        emb = np.load(os.path.join(save_root, "optimized_emb_a", f"best_emb_{i:02d}.npy"))
        assert pose.shape == (3, 4) and emb.shape == (HP["nerf.appearance_dim"],) and np.isfinite(pose).all()
    capsys.readouterr()
    out = eval_cli.main(["--ckpt", ckpt, "--result_dir", result, "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "merged 2 metrics file(s)" in printed and "PSNR:" in printed and "SSIM:" in printed
    assert set(out) == {"train/pose_R", "train/pose_t", "train/pose_R_rel", "train/pose_t_rel", "PSNR", "SSIM"}
    assert all(np.isfinite(v) for v in out.values())
    assert out["train/pose_R_rel"] < 0.1 and out["train/pose_t_rel"] < 1e-4
