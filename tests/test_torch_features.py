"""The port's offline extractors (upnerf_torch.features, cli.preprocess)
against the JAX package on the CPU, at small sizes.

Inputs come from numpy seeds; JAX parameter trees go through the port's
weight bridge (`vit_params_from_jax`, `dpt_params_from_jax`). Each
tolerance is stated beside its assert.
"""

import csv
import functools
import os
import struct
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from upnerf.cli import preprocess as jpreprocess
from upnerf.data.images import npy_name as j_npy_name
from upnerf.features import dino as jdino
from upnerf.features import dpt as jdpt
from upnerf.features import vit as jvit
from upnerf_torch.cli import preprocess
from upnerf_torch.features import dino, dpt, images, vit
from upnerf_torch.utils.weights import dpt_params_from_jax, vit_params_from_jax

SMALL_VIT = dict(patch_size=8, dim=96, depth=2, heads=6, base_grid=4)


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def to_np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def rel(got, want):
    """max |got - want| over max |want|."""
    got, want = to_np(got), to_np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# --------------------------------------------------------------------------
# traps 1-2: the resizes


@pytest.mark.parametrize("base,out", [(28, 111), (24, 24), (24, 4), (4, 7)])
def test_pos_embed_resize_matches_jax(base, out):
    """jax.image.resize bicubic (Keys a = -0.5, borders renormalised) is
    torch's antialias bicubic: 28 -> 111 is the DINO grid, 24 -> 24 DPT's
    (identity). 2e-5 absolute on unit-normal values (float32 sums of 4-8
    weighted taps per axis)."""
    pe = np.random.RandomState(base + out).randn(1, 1 + base * base, 32).astype(np.float32)
    want = np.asarray(jvit.interpolate_pos_embed(jnp.asarray(pe), (out, out), base))
    got = vit.interpolate_pos_embed(torch.from_numpy(pe), (out, out), base)
    assert got.shape == want.shape == (1, 1 + out * out, 32)
    np.testing.assert_allclose(to_np(got), want, rtol=0, atol=2e-5)
    if base == out:
        np.testing.assert_array_equal(to_np(got), pe)


@pytest.mark.parametrize("mode,size", [("bilinear", 448), ("bicubic", 384), ("bicubic", 64), ("bilinear", 7),
                                       ("bicubic", 611)])
def test_resize_u8_matches_pil(mode, size):
    """The uint8 resize of the DINO (bilinear 448) and DPT (bicubic 384)
    inputs against PIL, shrinking, growing and at odd sizes: equal (PIL's
    fixed-point resampler, the filter swapped)."""
    img = np.random.RandomState(size).randint(0, 256, (375, 500, 3), np.uint8)
    pil = {"bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC}[mode]
    want = np.asarray(Image.fromarray(img).resize((size, size), pil))
    got = images.resize_u8(img, (size, size), mode)
    assert got.dtype == np.uint8 and got.shape == (size, size, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("wh", [(500, 375), (640, 480), (100, 80), (37, 29)])
def test_resize_float_matches_pil(wh):
    """DPT's resize back to the source size, against PIL's "F" bicubic:
    equal (float64 weights and sums in PIL's order, float32 after each
    pass)."""
    pred = (np.random.RandomState(wh[0]).rand(384, 384) * 3).astype(np.float32)
    want = np.asarray(Image.fromarray(pred, mode="F").resize(wh, Image.BICUBIC))
    got = images.resize_float(torch.from_numpy(pred), wh[::-1])
    assert got.shape == want.shape == wh[::-1]
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# trap 3: reading images


def encode_png(rgb: np.ndarray, filt: int) -> bytes:
    """An 8-bit RGB / RGBA PNG with filter `filt` on every row."""
    h, w, c = rgb.shape
    bpp, raw, prior = c, b"", np.zeros(w * c, np.int32)
    for y in range(h):
        line = rgb[y].reshape(-1).astype(np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), line[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        if filt == 0:
            pred = np.zeros_like(line)
        elif filt == 1:
            pred = left
        elif filt == 2:
            pred = prior
        elif filt == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        raw += bytes([filt]) + ((line - pred) % 256).astype(np.uint8).tobytes()
        prior = line

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    color = 2 if c == 3 else 6
    return (images.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4])
def test_png_reader_matches_pil(tmp_path, filt, channels):
    """Every filter type, RGB and RGBA: exactly PIL's convert("RGB")."""
    img = np.random.RandomState(filt).randint(0, 256, (13, 17, channels), np.uint8)
    img[3:6] = 200  # flat runs as well as noise
    path = tmp_path / "a.png"
    path.write_bytes(encode_png(img, filt))
    want = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(images.read_rgb_u8(str(path)), want)


def test_png_reader_reads_pil_files(tmp_path):
    """PNGs as PIL writes them (its own filter choice), RGB and RGBA."""
    rng = np.random.RandomState(0)
    for mode, c in (("RGB", 3), ("RGBA", 4)):
        arr = rng.randint(0, 256, (40, 31, c), np.uint8)
        arr[:, :10] = 17
        path = str(tmp_path / f"{mode}.png")
        Image.fromarray(arr, mode).save(path)
        np.testing.assert_array_equal(images.read_rgb_u8(path), np.asarray(Image.open(path).convert("RGB")))


def test_read_npy_and_other_formats(tmp_path, monkeypatch):
    arr = np.random.RandomState(1).randint(0, 256, (9, 7, 3), np.uint8)
    np.save(tmp_path / "a.npy", arr)
    np.testing.assert_array_equal(images.read_rgb_u8(str(tmp_path / "a.npy")), arr)
    Image.fromarray(arr).save(tmp_path / "b.bmp")  # not a PNG: read through PIL where installed
    np.testing.assert_array_equal(images.read_rgb_u8(str(tmp_path / "b.bmp")), arr)
    Image.fromarray(arr[..., 0]).save(tmp_path / "gray.png")  # a PNG the zlib reader does not take
    np.testing.assert_array_equal(images.read_rgb_u8(str(tmp_path / "gray.png")),
                                  np.asarray(Image.open(tmp_path / "gray.png").convert("RGB")))
    monkeypatch.setitem(sys.modules, "PIL", None)  # as on a host without PIL
    with pytest.raises(RuntimeError, match=r"b\.bmp.*PIL is not installed"):
        images.read_rgb_u8(str(tmp_path / "b.bmp"))
    with pytest.raises(RuntimeError, match=r"gray\.png.*PIL is not installed"):
        images.read_rgb_u8(str(tmp_path / "gray.png"))


def test_npy_name():
    for name in ("a/b/84113133_8624314215.jpg", "x.png", "noext", "dir.v2/img.tar.gz"):
        assert images.npy_name(name) == j_npy_name(name)


# --------------------------------------------------------------------------
# ViT and DINO


def small_vit(seed=0):
    cfg_j = jvit.ViTConfig(**SMALL_VIT)
    jp = np_tree(jvit.init_vit_params(jax.random.PRNGKey(seed), cfg_j))
    return cfg_j, vit.ViTConfig(**SMALL_VIT), jp, vit_params_from_jax(jp)


def test_forward_features_matches_jax():
    """dim 96, 2 blocks, 6 heads, stride 4 on a 32x32 image (7x7 grid, pos
    embed 4 -> 7), dense attention: tokens, the key facet of block 1 and the
    hooked block outputs, 1e-5 of each tensor's max (float32 throughout)."""
    cfg_j, cfg_t, jp, tp = small_vit()
    img = np.random.RandomState(1).randn(32, 32, 3).astype(np.float32)
    want = jvit.forward_features(jax.tree.map(jnp.asarray, jp), cfg_j, jnp.asarray(img), 4, key_layer=1,
                                 out_layers=(0, 1))
    got = vit.forward_features(tp, cfg_t, torch.from_numpy(img), 4, key_layer=1, out_layers=(0, 1))
    assert got["grid"] == want["grid"] == (7, 7)
    for name in ("tokens", "keys"):
        assert got[name].shape == want[name].shape
        assert rel(got[name], want[name]) < 1e-5, name
    for i in (0, 1):
        assert rel(got["layers"][i], want["layers"][i]) < 1e-5


def test_init_vit_params_layout():
    """The port's random init has the JAX init's tree, shapes and dtypes."""
    cfg = vit.ViTConfig(**SMALL_VIT)
    ours = vit.init_vit_params(np.random.default_rng(0), cfg)
    theirs = np_tree(jvit.init_vit_params(jax.random.PRNGKey(0), jvit.ViTConfig(**SMALL_VIT)))
    shapes = jax.tree.map(lambda a: (a.shape, a.dtype), ours)
    assert shapes == jax.tree.map(lambda a: (a.shape, a.dtype), theirs)


def test_dino_extract_matches_jax():
    """The port's extractor stops after block `layer`'s ln1 and qkv; the JAX
    one runs the whole ViT. Same keys: 1e-5 of their max."""
    cfg_j, cfg_t, jp, tp = small_vit(seed=2)
    img = np.random.RandomState(3).randn(32, 32, 3).astype(np.float32)
    jex = jdino.DinoExtractor(jp, cfg_j, stride=4, layer=1, load_size=32)
    tex = dino.DinoExtractor(tp, cfg_t, stride=4, layer=1, load_size=32)
    want = np.asarray(jex._extract(jex.params, jnp.asarray(img)))
    got = tex._extract(tp, torch.from_numpy(img))
    assert got.shape == want.shape == (7, 7, 96)
    assert rel(got, want) < 1e-5


def test_dino_extract_runs_layer_attention_calls(monkeypatch):
    """Block `layer`'s attention and the later blocks are not run: with
    impl "flash" on the CPU, the wrapper is called once per block before
    `layer`."""
    _, cfg_t, _, tp = small_vit(seed=2)
    calls = []
    from upnerf_torch.ops import attention

    orig = attention.flash_attention

    def counting(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(vit, "flash_attention", counting)
    ex = dino.DinoExtractor(tp, cfg_t._replace(attn_impl="flash"), stride=4, layer=1, load_size=32)
    ex._extract(tp, torch.zeros(32, 32, 3))
    assert len(calls) == 1


def test_dino_call_matches_jax():
    """uint8 image -> descriptor map end to end, the resize included. The
    uint8 resize is PIL's exactly, so only float32 sums in another order
    remain (~3e-7 of the keys' max); 1e-5 bounds them."""
    cfg_j, cfg_t, jp, tp = small_vit(seed=4)
    img = np.random.RandomState(5).randint(0, 256, (50, 60, 3), np.uint8)
    want = jdino.DinoExtractor(jp, cfg_j, stride=4, layer=1, load_size=32)(img)
    got = dino.DinoExtractor(tp, cfg_t, stride=4, layer=1, load_size=32)(img)
    assert got.shape == want.shape == (7, 7, 96) and got.dtype == np.float32
    assert rel(got, want) < 1e-5


def test_pca_info_matches_jax():
    """float64 numpy on both sides: mean 1e-6, components 1e-5 up to sign."""
    feat = np.random.RandomState(0).randn(7, 9, 24).astype(np.float32)
    m_j, c_j = jdino.pca_info(feat)
    m_t, c_t = dino.pca_info(feat)
    assert m_t.shape == (24,) and c_t.shape == (3, 24) and c_t.dtype == np.float32
    np.testing.assert_allclose(m_t, m_j, rtol=0, atol=1e-6)
    sign = np.sign((c_t * c_j).sum(-1, keepdims=True))
    np.testing.assert_allclose(c_t * sign, c_j, rtol=0, atol=1e-5)


# --------------------------------------------------------------------------
# DPT


@pytest.fixture(scope="module")
def small_dpt():
    params, cfg, hooks = jdpt.init_dpt_params(jax.random.PRNGKey(0), small=True)
    jp = np_tree(params)
    return jp, cfg, hooks, dpt_params_from_jax(jp)


@pytest.mark.parametrize("stride", [4, 2])
def test_conv2d_transpose_matches_jax(stride):
    """The transposed-conv kernels through the weight bridge (HWIO, no
    kernel transpose -> torch's (in, out, kh, kw), flipped): 1e-5."""
    rng = np.random.RandomState(stride)
    x = rng.randn(1, 5, 6, 3).astype(np.float32)
    w = rng.randn(stride, stride, 3, 7).astype(np.float32)
    b = rng.randn(7).astype(np.float32)
    want = np.asarray(jdpt.conv2d_transpose(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride))
    tp = dpt_params_from_jax({"reassemble0": {"resample": {"w": w, "b": b}}})["reassemble0"]["resample"]
    got = dpt.conv2d_transpose(torch.from_numpy(x).permute(0, 3, 1, 2), tp["w"], tp["b"], stride)
    np.testing.assert_allclose(to_np(got.permute(0, 2, 3, 1)), want, rtol=0, atol=1e-5)


def test_upsample2_matches_jax():
    """align-corners bilinear x2 (1e-6), including a 1-pixel side."""
    for shape in ((1, 5, 7, 3), (1, 1, 4, 2)):
        x = np.random.RandomState(0).randn(*shape).astype(np.float32)
        want = np.asarray(jdpt._upsample2(jnp.asarray(x)))
        got = dpt._upsample2(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(to_np(got), want, rtol=0, atol=1e-6)


def test_dpt_neck_matches_jax(small_dpt):
    """Random hook tokens through readout, reassemble (both transposed
    convs, the stride-2 conv), fusion and head: 1e-4 of the map's max
    (float32 convs summed in another order over ~10 layers)."""
    jp, cfg, hooks, tp = small_dpt
    rng = np.random.RandomState(3)
    grid = (4, 4)
    layers = {k: rng.randn(1, 17, cfg.dim).astype(np.float32) * 0.5 for k in hooks}
    want = np.asarray(jdpt.dpt_neck(jax.tree.map(jnp.asarray, jp), {k: jnp.asarray(v) for k, v in layers.items()},
                                    grid, hooks))
    got = dpt.dpt_neck(tp, {k: torch.from_numpy(v) for k, v in layers.items()}, grid, hooks)
    assert got.shape == want.shape == (64, 64)
    assert np.abs(want).max() > 0
    assert rel(got, want) < 1e-4


def test_dpt_forward_matches_jax(small_dpt):
    """Backbone (pos embed 24 -> 4) + neck on a 64x64 image: 1e-4 of the
    map's max."""
    jp, cfg, hooks, tp = small_dpt
    img = np.random.RandomState(7).randn(64, 64, 3).astype(np.float32)
    want = np.asarray(jdpt.dpt_forward(jax.tree.map(jnp.asarray, jp), jnp.asarray(img), cfg=cfg, hooks=hooks))
    got = dpt.dpt_forward(tp, torch.from_numpy(img), cfg=dpt.SMALL_VIT, hooks=hooks)
    assert got.shape == want.shape == (64, 64)
    assert bool((got >= 0).all())
    assert rel(got, want) < 1e-4


def test_init_dpt_params_layout():
    ours, cfg, hooks = dpt.init_dpt_params(np.random.default_rng(0), small=True)
    theirs, jcfg, jhooks = jdpt.init_dpt_params(jax.random.PRNGKey(0), small=True)
    assert tuple(cfg) == tuple(jcfg) and hooks == jhooks
    assert jax.tree.map(lambda a: a.shape, ours) == jax.tree.map(lambda a: a.shape, np_tree(theirs))


# --------------------------------------------------------------------------
# the CLI


def test_collect_images_matches_jax(tmp_path):
    for n in ("b.png", "a.jpg", "c.npy"):
        (tmp_path / n).write_bytes(b"")
    assert preprocess.collect_images(str(tmp_path)) == jpreprocess.collect_images(str(tmp_path))
    tsv = tmp_path / "scene.tsv"
    with open(tsv, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t")
        w.writerow(["filename", "id", "split", "dataset"])
        w.writerows([["b.png", "12.0", "train", "s"], ["a.jpg", "", "test", "s"], ["c.npy", "7.0", "test", "s"],
                     ["d.png", "nan", "train", "s"]])
    got = preprocess.collect_images(str(tmp_path), str(tsv))
    assert got == jpreprocess.collect_images(str(tmp_path), str(tsv))
    assert [os.path.basename(p) for p in got] == ["b.png", "c.npy"]


def test_collect_images_on_a_repo_tsv():
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "tsv", "brandenburg_gate.tsv")
    assert preprocess.collect_images("d", path) == jpreprocess.collect_images("d", path)


TINY_DINO = dict(patch_size=8, dim=32, depth=3, heads=4, base_grid=4)


def test_preprocess_cli_matches_jax(tmp_path, monkeypatch):
    """Both CLIs on the same two small PNGs and the same npz files, with the
    extractors shrunk the same way on both sides (DINO: dim 32, 3 blocks,
    key layer 1, 32x32 input, stride 4; DPT: the small config at 64x64).
    Same files, names, shapes and dtypes. Values: DINO maps, PCA means and
    DPT maps within 1e-5 of their max (the resizes are PIL's exactly; float32
    sums in another order move them by up to ~8e-7)."""
    rng = np.random.RandomState(0)
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    for name, hw in (("first.png", (37, 50)), ("second.png", (48, 40))):
        Image.fromarray(rng.randint(0, 256, hw + (3,), np.uint8)).save(img_dir / name)

    cfg = jvit.ViTConfig(**TINY_DINO)
    flat = {}

    def flatten(tree, prefix, out):
        for k, v in tree.items():
            if isinstance(v, dict):
                flatten(v, f"{prefix}{k}/", out)
            else:
                out[prefix + k] = np.asarray(v)

    flatten(jvit.init_vit_params(jax.random.PRNGKey(1), cfg), "", flat)
    np.savez(tmp_path / "dino.npz", **flat)
    dparams, dcfg, dhooks = jdpt.init_dpt_params(jax.random.PRNGKey(2), small=True)
    flat = {}
    flatten(dparams, "", flat)
    np.savez(tmp_path / "dpt.npz", **flat)

    monkeypatch.setattr(jdino, "DinoExtractor", functools.partial(jdino.DinoExtractor, cfg=cfg, layer=1,
                                                                  load_size=32))
    monkeypatch.setattr(jdpt, "DPTDepth", functools.partial(jdpt.DPTDepth, net_size=64))
    monkeypatch.setattr(jdpt, "dpt_forward", functools.partial(jdpt.dpt_forward, cfg=dcfg, hooks=dhooks))
    monkeypatch.setattr(dino, "DinoExtractor", functools.partial(dino.DinoExtractor, cfg=vit.ViTConfig(**TINY_DINO),
                                                                 layer=1, load_size=32))
    monkeypatch.setattr(dpt, "DPTDepth", functools.partial(dpt.DPTDepth, net_size=64))
    monkeypatch.setattr(dpt, "dpt_forward", functools.partial(dpt.dpt_forward, cfg=dpt.SMALL_VIT, hooks=dhooks))

    common = ["--image_dir", str(img_dir), "--what", "dino", "dpt", "--dino_weights", str(tmp_path / "dino.npz"),
              "--dpt_weights", str(tmp_path / "dpt.npz")]
    jpreprocess.main(jpreprocess_args(common + ["--save_dir", str(tmp_path / "jax")]))
    preprocess.main(common + ["--save_dir", str(tmp_path / "port"), "--device", "cpu"])

    def listing(root):
        return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)

    files = listing(tmp_path / "jax")
    assert files == listing(tmp_path / "port")
    assert files == sorted([
        "DINO/feature_maps/first.npy", "DINO/feature_maps/second.npy", "DINO/pca_infos/first_mean.npy",
        "DINO/pca_infos/first_components.npy", "DINO/pca_infos/second_mean.npy",
        "DINO/pca_infos/second_components.npy", "DPT/first.npy", "DPT/second.npy",
    ])
    for f in files:
        want, got = np.load(tmp_path / "jax" / f), np.load(tmp_path / "port" / f)
        assert got.shape == want.shape and got.dtype == want.dtype == np.float32, f
        assert np.isfinite(got).all()
    for stem, hw in (("first", (37, 50)), ("second", (48, 40))):
        feat = np.load(tmp_path / "port" / "DINO" / "feature_maps" / f"{stem}.npy")
        assert feat.shape == (7, 7, 32)
        assert rel(feat, np.load(tmp_path / "jax" / "DINO" / "feature_maps" / f"{stem}.npy")) < 1e-5
        mean = f"DINO/pca_infos/{stem}_mean.npy"
        assert rel(np.load(tmp_path / "port" / mean), np.load(tmp_path / "jax" / mean)) < 1e-5
        depth = np.load(tmp_path / "port" / "DPT" / f"{stem}.npy")
        assert depth.shape == hw
        assert rel(depth, np.load(tmp_path / "jax" / "DPT" / f"{stem}.npy")) < 1e-5


def jpreprocess_args(argv):
    """The JAX CLI's main takes parsed arguments."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--image_dir", required=True)
    p.add_argument("--save_dir", required=True)
    p.add_argument("--tsv_path", default=None)
    p.add_argument("--what", nargs="+", default=["dino", "dpt"])
    p.add_argument("--dino_weights", default=None)
    p.add_argument("--dpt_weights", default=None)
    return p.parse_args(argv)


def test_load_returns_none_without_weights(monkeypatch):
    monkeypatch.delenv("UPNERF_DINO_WEIGHTS", raising=False)
    monkeypatch.delenv("UPNERF_DPT_WEIGHTS", raising=False)
    assert dino.load_dino() is None and dpt.load_dpt() is None


@pytest.mark.parametrize("k,stride,cin,cout", [(3, 1, 5, 7), (1, 1, 6, 4), (3, 2, 4, 6)])
def test_conv2d_matches_jax(k, stride, cin, cout):
    """The im2col conv through the weight bridge (HWIO -> OIHW) against the
    JAX package's XLA conv: "SAME" at stride 1, and the stride-2 conv with
    (1, 1) pads on both sides (reassemble3). 1e-5 absolute (float32 sums of
    at most 54 products)."""
    rng = np.random.RandomState(k + stride)
    x = rng.randn(1, 9, 8, cin).astype(np.float32)
    w = rng.randn(k, k, cin, cout).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    pad = ((1, 1), (1, 1)) if stride == 2 else "SAME"
    want = np.asarray(jdpt.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride, padding=pad))
    tp = dpt_params_from_jax({"c": {"w": w, "b": b}})["c"]
    got = dpt.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), tp["w"], tp["b"], stride=stride,
                     padding=1 if stride == 2 else None)
    assert tuple(got.shape) == (1, cout) + want.shape[1:3]
    np.testing.assert_allclose(to_np(got.permute(0, 2, 3, 1)), want, rtol=0, atol=1e-5)


def test_converters_match_jax(tmp_path):
    """Both packages' converters on the same torch checkpoints (a timm DINO
    ViT state and a midas DPT state, small, from the JAX package's converter
    tests) write the same npz files, bit for bit."""
    from test_convert_parity import make_torch_state
    from test_dpt_torch_twin import make_state_dict

    from upnerf.features import convert as jconvert
    from upnerf_torch.features import convert

    torch.save({"teacher": {"backbone." + k: v for k, v in make_torch_state(seed=1).items()}}, tmp_path / "dino.pth")
    torch.save({"state_dict": make_state_dict(seed=2)}, tmp_path / "dpt.pt")
    for name, jfn, fn in (("dino.pth", jconvert.convert_dino_vit, convert.convert_dino_vit),
                          ("dpt.pt", jconvert.convert_dpt, convert.convert_dpt)):
        jfn(str(tmp_path / name), str(tmp_path / "jax.npz"))
        fn(str(tmp_path / name), str(tmp_path / "port.npz"))
        with np.load(tmp_path / "jax.npz") as want, np.load(tmp_path / "port.npz") as got:
            assert sorted(got.files) == sorted(want.files) and len(got.files) > 10
            for k in want.files:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
