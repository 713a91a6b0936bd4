"""The ported synthetic scene generator (upnerf_torch.data.synthetic) against
the JAX package's (upnerf.data.synthetic), and the render_video CLI's
anchor on a scene whose base poses are not the identity.

- generate_scene with the same arguments: metadata (poses, focal, split)
  equal; the analytic renders before encoding (rgb, inverse depth, hit
  points, directions) within 1e-6; the DPT maps within 1e-6; the port's
  8-bit bilinear resize of each render within 1 LSB of PIL's BILINEAR; with
  PIL's resize in its place, the DINO maps and PCA infos within 1e-6; the
  Phototourism layout read back by the port's loader gives the same poses
  and intrinsics as the JAX loader on the JAX scene; load_custom reads the
  ported scene (PNGs) unchanged;
- render_video's anchor exp(se3[anchor]) o meta.poses_dict[id] and K =
  meta.Ks[id] (w, h = 2 cx, 2 cy) against the JAX CLI's composition
  (upnerf/cli/render_video.py:55-64) with upnerf.geometry.se3, then the orbit
  of get_novel_view_poses: 1e-5; the CLI on a run directory (--result_dir,
  --ckpt last) renders frames of the scene's size at those poses.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from upnerf.data import load_scene_meta as jload_scene_meta
from upnerf.data import synthetic as jsyn
from upnerf.geometry import se3 as jse3
from upnerf_torch.cli import render_video
from upnerf_torch.data import load_custom, load_scene_meta
from upnerf_torch.data import synthetic as tsyn
from upnerf_torch.evaluate.render import make_pose_renderer, render_image
from upnerf_torch.features.images import read_rgb_u8, resize_u8
from upnerf_torch.geometry import se3 as tse3
from upnerf_torch.models.nerf import NeRFConfig
from upnerf_torch.render.render_rays import RenderConfig
from upnerf_torch.utils import weights

GEN = dict(n_train=3, n_test=2, H=20, W=24, feat_hw=6, feat_dim=8, focal=20.0, phototourism_layout=True)
HP = {
    "nerf.D": 2, "nerf.W": 32, "nerf.skips": (1,), "nerf.N_emb_xyz": 4, "nerf.N_emb_dir": 2,
    "nerf.feat_dim": 8, "nerf.appearance_dim": 8, "nerf.candidate_dim": 4, "pose.c2f": (0.1, 0.5),
    "nerf.N_samples": 8, "nerf.N_importance": 4, "nerf.near": 0.1, "nerf.far": 5.0,
    "nerf.use_disp": False, "nerf.perturb": 1.0, "val.chunk_size": 64, "tpu.matmul_precision": "float32",
    "t_net.transient_dim": 8, "t_net.feat_dim": 8, "t_net.beta_min": 0.1,
}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pil_bilinear(rgb, size_hw, mode):
    assert mode == "bilinear"
    return np.asarray(Image.fromarray(rgb).resize(size_hw[::-1], Image.BILINEAR))


@pytest.mark.parametrize("feature_mode,interleave", [("color", False), ("world", True)])
def test_generator_matches_jax(tmp_path, monkeypatch, feature_mode, interleave):
    kw = dict(GEN, feature_mode=feature_mode, interleave_test=interleave, seed=3)
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    jmeta = jsyn.generate_scene(jroot, **kw)
    tmeta = tsyn.generate_scene(troot, **kw)
    assert list(tmeta) == list(jmeta)
    for k in jmeta:
        assert tmeta[k]["name"] == jmeta[k]["name"].replace(".jpg", ".png")
        assert (tmeta[k]["c2w"], tmeta[k]["focal"], tmeta[k]["split"]) == (jmeta[k]["c2w"], jmeta[k]["focal"],
                                                                           jmeta[k]["split"])
    poses = jsyn._camera_ring(5, arc=0.2)
    K = np.array([[20.0, 0, 12], [0, 20.0, 10], [0, 0, 1]], np.float32)
    for i, pose in enumerate(poses):
        got, want = tsyn._render_image(pose, K, 20, 24), jsyn._render_image(pose, K, 20, 24)
        np.testing.assert_array_equal(got[0], want[0])
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        # the port's 8-bit bilinear against PIL's
        small = resize_u8(got[0], (6, 6), "bilinear").astype(np.int16)
        assert np.abs(small - pil_bilinear(got[0], (6, 6), "bilinear").astype(np.int16)).max() <= 1
        # the PNG holds the render exactly
        np.testing.assert_array_equal(read_rgb_u8(os.path.join(troot, tmeta[str(i)]["name"])), got[0])
    for f in sorted(os.listdir(os.path.join(jroot, "DPT"))):
        np.testing.assert_allclose(np.load(os.path.join(troot, "DPT", f)), np.load(os.path.join(jroot, "DPT", f)),
                                   rtol=0, atol=1e-6)
    # with PIL's resize in place of the port's, the feature maps and PCA infos are the JAX generator's
    monkeypatch.setattr(tsyn, "resize_u8", pil_bilinear)
    proot = str(tmp_path / "port_pil")
    tsyn.generate_scene(proot, **kw)
    for sub in ("DINO/feature_maps", "DINO/pca_infos"):
        names = sorted(os.listdir(os.path.join(jroot, sub)))
        assert names == sorted(os.listdir(os.path.join(proot, sub)))
        for f in names:
            np.testing.assert_allclose(np.load(os.path.join(proot, sub, f)), np.load(os.path.join(jroot, sub, f)),
                                       rtol=0, atol=1e-6, err_msg=f)
    # the Phototourism layout: the same poses and intrinsics through both loaders
    hp = {"dataset_name": "phototourism", "root_dir": troot, "scene_name": "port", "phototourism.img_downscale": 1,
          "pose.noise": None}
    tm = load_scene_meta(hp)
    jm = jload_scene_meta(dict(hp, root_dir=jroot, scene_name="jax"))
    assert tm.img_ids_train == jm.img_ids_train and tm.img_ids_test == jm.img_ids_test
    for i in tm.img_ids:
        np.testing.assert_allclose(tm.poses_dict[i], jm.poses_dict[i], rtol=0, atol=1e-5)
        np.testing.assert_allclose(tm.Ks[i], jm.Ks[i], rtol=0, atol=1e-6)
    custom = load_custom(troot, 1, camera_noise=None)
    assert custom.N_images_train == 3 and custom.N_images_test == 2


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synthetic") / "scene")
    tsyn.generate_scene(root, **dict(GEN, seed=5, arc=0.3))
    hp = dict(HP, dataset_name="phototourism", root_dir=root, scene_name="scene", seed=0,
              **{"phototourism.img_downscale": 1, "pose.noise": None})
    return hp, load_scene_meta(hp)


def test_render_video_anchor_matches_jax_cli(scene):
    hp, meta = scene
    jm = jload_scene_meta(hp)
    se3_table = (np.random.RandomState(7).randn(meta.N_images_train, 6) * 0.05).astype(np.float32)
    for anchor in range(meta.N_images_train):
        pose, K, wh = render_video.anchor_view(meta, torch.from_numpy(se3_table), anchor)
        anchor_id = jm.img_ids_train[anchor]
        base = np.asarray(jm.poses_dict[anchor_id], np.float32)
        assert np.abs(base - np.eye(3, 4)).max() > 0.1  # not the identity
        want = jse3.compose([jse3.se3_to_SE3(jnp.asarray(se3_table[anchor])), jnp.asarray(base)])
        np.testing.assert_allclose(pose.numpy(), np.asarray(want), rtol=0, atol=1e-5)
        jK = jm.Ks[anchor_id]
        np.testing.assert_allclose(K, jK, rtol=0, atol=1e-6)
        assert wh == (int(round(jK[0, 2] * 2)), int(round(jK[1, 2] * 2))) == (24, 20)
        np.testing.assert_allclose(tse3.get_novel_view_poses(pose, N=4).numpy(),
                                   np.asarray(jse3.get_novel_view_poses(want, N=4)), rtol=0, atol=1e-5)


def test_render_video_cli_on_a_run_directory(scene, tmp_path):
    """--result_dir RUN --ckpt last on a checkpoint whose hyper_parameters name
    the scene: frames of the scene's size (2 cx, 2 cy), at the orbit around
    exp(se3[anchor]) o base with the scene's K."""
    hp, meta = scene
    run = str(tmp_path / "run")
    ckpt = weights.init_reference_ckpt(os.path.join(run, "ckpts", "7.ckpt"), hp, n_images=meta.N_images_train, seed=2)
    saved = torch.load(ckpt, weights_only=False)
    table = torch.from_numpy((np.random.RandomState(8).randn(meta.N_images_train, 6) * 0.05).astype(np.float32))
    saved["state_dict"]["se3_refine.weight"] = table
    torch.save(saved, ckpt)
    out = render_video.main(["--result_dir", run, "--frames", "2", "--anchor", "1", "--device", "cpu"])
    assert [os.path.dirname(p) for p in out["frames"]] == [os.path.join(run, "video")] * 2
    depth = np.load(out["depths"][1])
    assert depth.shape == (20, 24) and np.isfinite(depth).all()
    # frame 1 equals a direct render at the JAX CLI's orbit pose
    anchor_id = meta.img_ids_train[1]
    base = torch.from_numpy(np.asarray(meta.poses_dict[anchor_id], np.float32))
    pose = tse3.get_novel_view_poses(tse3.compose([tse3.se3_to_SE3(table[1]), base]), N=2)[1]
    sd, _, _ = weights.load_reference_ckpt(ckpt)
    params, _ = weights.render_params(sd, NeRFConfig.from_hparams(hp), "cpu")
    renderer = make_pose_renderer(RenderConfig.from_hparams(hp)._replace(perturb=0.0), chunk=64)
    _, want = render_image(renderer, params, meta.Ks[anchor_id], pose.numpy(), (24, 20), [0.1, 5.0], 1, chunk=64,
                           device="cpu")
    np.testing.assert_allclose(depth, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="--result_dir"):
        render_video.main(["--ckpt", "best", "--device", "cpu"])
