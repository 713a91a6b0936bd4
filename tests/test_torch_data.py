"""The data layer of upnerf_torch against the JAX package: COLMAP models,
scene metadata, the LANCZOS integer downscale and the tsv reader.

- COLMAP binary and text models: each package reads what the other writes,
  record for record; qvec2rotmat / rotmat2qvec agree to 1e-12 (float64);
- `load_phototourism` / `load_custom` metadata on a scene written by
  `upnerf.data.synthetic.generate_scene(..., phototourism_layout=True)`: the
  same ids, splits, image paths, Ks, poses, GT poses and near/far, in the
  noise modes -1 (identity), > 0 (persisted se(3) noise; each package on its
  own copy of the scene, so each draws and stores its own noise file) and
  None: 1e-6 absolute on float32 poses (the noise composition is f32 matrix
  products in another order), exact elsewhere;
- the LANCZOS downscale against PIL, and `load_rgb_u8` against the JAX
  package's: equal, byte for byte.
"""

import os
import shutil

import numpy as np
import pytest
from PIL import Image

from upnerf.data import colmap as jcolmap
from upnerf.data import images as jimages
from upnerf.data import load_scene_meta as jload_scene_meta
from upnerf.data import scene as jscene
from upnerf.data.synthetic import generate_scene
from upnerf_torch.cli.render_video import write_png
from upnerf_torch.data import colmap as tcolmap
from upnerf_torch.data import images as timages
from upnerf_torch.data import load_scene_meta
from upnerf_torch.data import scene as tscene
from upnerf_torch.features.images import image_wh, resize_lanczos_u8


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scenes") / "toy")
    generate_scene(root, n_train=4, n_test=2, H=24, W=30, focal=28.0, seed=1, phototourism_layout=True)
    return root


def copy_of(scene_dir, tmp_path, name):
    dst = str(tmp_path / name)
    shutil.copytree(scene_dir, dst)
    return dst


def colmap_model(seed=0):
    rng = np.random.RandomState(seed)
    cams = {i: tcolmap.Camera(id=i, model=m, width=40 + i, height=30 + i, params=rng.randn(n))
            for i, (m, n) in enumerate([("PINHOLE", 4), ("SIMPLE_RADIAL", 4), ("OPENCV", 8)], start=1)}
    imgs = {i: tcolmap.Image(id=i, qvec=tcolmap.rotmat2qvec(np.linalg.qr(rng.randn(3, 3))[0] * [1, 1, 1]),
                             tvec=rng.randn(3), camera_id=1 + i % 3, name=f"img_{i}.jpg", xys=rng.randn(i, 2),
                             point3D_ids=rng.randint(-1, 50, i).astype(np.int64))
            for i in range(1, 5)}
    pts = {i: tcolmap.Point3D(id=i, xyz=rng.randn(3), rgb=rng.randint(0, 256, 3), error=np.array(rng.rand()),
                              image_ids=rng.randint(1, 5, i % 4).astype(np.int32),
                              point2D_idxs=rng.randint(0, 9, i % 4).astype(np.int32))
           for i in range(1, 7)}
    return cams, imgs, pts


def assert_records_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        for fa, fb in zip(a[k], b[k]):
            if isinstance(fa, np.ndarray) or isinstance(fb, np.ndarray):
                np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))
            else:
                assert fa == fb


@pytest.mark.parametrize("kind", ["cameras", "images", "points3d"])
@pytest.mark.parametrize("fmt", ["binary", "text"])
def test_colmap_models_round_trip_between_packages(kind, fmt, tmp_path):
    cams, imgs, pts = colmap_model()
    records = {"cameras": cams, "images": imgs, "points3d": pts}[kind]
    if kind == "images" and fmt == "text":  # text stores the point ids as printed integers
        records = {k: v._replace(xys=np.round(v.xys, 6)) for k, v in records.items()}
    path = str(tmp_path / f"{kind}.{'bin' if fmt == 'binary' else 'txt'}")
    getattr(tcolmap, f"write_{kind}_{fmt}")(records, path)
    assert_records_equal(getattr(jcolmap, f"read_{kind}_{fmt}")(path), getattr(tcolmap, f"read_{kind}_{fmt}")(path))
    path2 = str(tmp_path / f"j_{kind}")
    getattr(jcolmap, f"write_{kind}_{fmt}")(records, path2)
    assert_records_equal(getattr(tcolmap, f"read_{kind}_{fmt}")(path2), getattr(jcolmap, f"read_{kind}_{fmt}")(path2))
    if kind == "points3d" and fmt == "binary":
        np.testing.assert_array_equal(tcolmap.read_points3d_xyz(path), jcolmap.read_points3d_xyz(path))


def test_quaternions_match_jax():
    rng = np.random.RandomState(2)
    for _ in range(5):
        R = np.linalg.qr(rng.randn(3, 3))[0]
        R *= np.sign(np.linalg.det(R))
        q = tcolmap.rotmat2qvec(R)
        np.testing.assert_allclose(q, jcolmap.rotmat2qvec(R), atol=1e-12)
        np.testing.assert_allclose(tcolmap.qvec2rotmat(q), jcolmap.qvec2rotmat(q), atol=1e-12)
        np.testing.assert_allclose(tcolmap.qvec2rotmat(q), R, atol=1e-10)


def assert_meta_equal(got, want):
    assert got.img_ids == want.img_ids
    assert got.img_ids_train == want.img_ids_train and got.img_ids_test == want.img_ids_test
    assert got.image_paths == want.image_paths and got.scale == want.scale
    assert got.camera_noise == want.camera_noise
    assert (got.GT_poses_dict is None) == (want.GT_poses_dict is None)
    for i in want.img_ids:
        np.testing.assert_array_equal(got.Ks[i], want.Ks[i])
        np.testing.assert_allclose(got.poses_dict[i], want.poses_dict[i], rtol=0, atol=1e-6)
        if want.GT_poses_dict is not None:
            np.testing.assert_allclose(got.GT_poses_dict[i], want.GT_poses_dict[i], rtol=0, atol=1e-6)
    assert got.nears.keys() == want.nears.keys()
    for i in want.nears:
        assert got.nears[i] == pytest.approx(want.nears[i], rel=1e-12)
        assert got.fars[i] == pytest.approx(want.fars[i], rel=1e-12)
    np.testing.assert_allclose(got.xyz_world, want.xyz_world, rtol=1e-12)


@pytest.mark.parametrize("noise", [-1, 0.1, None], ids=["identity", "noise", "colmap"])
def test_load_phototourism_matches_jax(scene_dir, tmp_path, noise):
    ours, theirs = copy_of(scene_dir, tmp_path, "toy"), copy_of(scene_dir, tmp_path / "j", "toy")
    got = tscene.load_phototourism(ours, "toy", img_downscale=2, camera_noise=noise)
    want = jscene.load_phototourism(theirs, "toy", img_downscale=2, camera_noise=noise)
    assert_meta_equal(got, want)
    assert got.N_images_train == 4 and got.N_images_test == 2
    if noise == 0.1:  # each package drew and stored its own noise file, and they agree
        name = os.path.join("noises", "4_0.1.npy")
        np.testing.assert_allclose(np.load(os.path.join(ours, name)), np.load(os.path.join(theirs, name)), atol=1e-6)


@pytest.mark.parametrize("noise", [-1, 0.2], ids=["identity", "noise"])
def test_load_custom_matches_jax(scene_dir, tmp_path, noise):
    ours, theirs = copy_of(scene_dir, tmp_path, "a"), copy_of(scene_dir, tmp_path, "b")
    assert_meta_equal(tscene.load_custom(ours, img_downscale=2, camera_noise=noise),
                      jscene.load_custom(theirs, img_downscale=2, camera_noise=noise))


def test_load_scene_meta_dispatch(scene_dir, tmp_path):
    root = copy_of(scene_dir, tmp_path, "toy")
    hp = {"dataset_name": "phototourism", "root_dir": root, "scene_name": "toy", "phototourism.img_downscale": 1,
          "pose.noise": -1}
    assert_meta_equal(load_scene_meta(hp), jload_scene_meta(hp))
    custom = dict(hp, dataset_name="custom")
    assert_meta_equal(load_scene_meta(custom), jload_scene_meta(custom))
    with pytest.raises(KeyError):
        load_scene_meta(dict(hp, dataset_name="llff"))


def test_read_tsv_drops_rows_without_id(tmp_path):
    path = tmp_path / "s.tsv"
    path.write_text("filename\tid\tsplit\tdataset\na.jpg\t1\ttrain\ts\nb.jpg\t\ttrain\ts\nc.jpg\tnan\ttest\ts\n"
                    "d.jpg\t4\ttest\ts\n")
    assert [r["filename"] for r in tscene.read_tsv(str(path))] == ["a.jpg", "d.jpg"]


@pytest.mark.parametrize("hw,factor", [((40, 48), 2), ((75, 101), 2), ((33, 17), 3), ((64, 64), 4), ((9, 11), 1)])
def test_lanczos_downscale_equals_pil(hw, factor):
    rng = np.random.RandomState(hw[0])
    yy, xx = np.mgrid[0 : hw[0], 0 : hw[1]]
    smooth = np.stack([xx / hw[1], yy / hw[0], (xx + yy) / sum(hw)], -1) * 200
    img = np.clip(smooth + rng.randint(0, 56, (*hw, 3)), 0, 255).astype(np.uint8)
    size = (hw[1] // factor, hw[0] // factor)
    want = np.asarray(Image.fromarray(img).resize(size, Image.LANCZOS))
    np.testing.assert_array_equal(resize_lanczos_u8(img, size), want)


def test_load_rgb_u8_matches_jax(scene_dir, tmp_path):
    img = np.asarray(Image.open(os.path.join(scene_dir, "dense/images/000.jpg")).convert("RGB"))
    png = str(tmp_path / "000.png")
    write_png(png, img)
    assert image_wh(png) == (img.shape[1], img.shape[0])
    for factor in (1, 2, 3):
        np.testing.assert_array_equal(timages.load_rgb_u8(png, factor), jimages.load_rgb_u8(png, factor))
    jpg = os.path.join(scene_dir, "dense/images/001.jpg")  # through PIL where it is installed
    np.testing.assert_array_equal(timages.load_rgb_u8(jpg, 2), jimages.load_rgb_u8(jpg, 2))
    assert image_wh(jpg) == Image.open(jpg).size
