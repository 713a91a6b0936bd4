"""The port's JPEG codec (upnerf_torch.features.jpeg) against PIL, and the
JPEG scene path against the JAX package, on the CPU at small sizes.

- `decode_jpeg` against `Image.open(f).convert("RGB")`, equal: baseline
  4:4:4 / 4:2:2 / 4:2:0 at qualities 1-100 and sizes 1x1 to 129x97;
  progressive (spectral selection, successive approximation, EOB runs),
  restart intervals, grey, optimized Huffman tables, quality-100 noise;
  files built here with layouts PIL does not write: 4:4:0 (h1v2 fancy
  upsampling), Adobe RGB and YCbCr, 16-bit quantisation tables, tables after
  the frame header, COM / APP1 segments (EXIF orientation is not applied);
  samples driven out of range by corrupt DC values, saturated as PIL's;
- `encode_jpeg` against `Image.fromarray(a).save(f, "JPEG", quality=q)`:
  the same bytes for every quality 1-100 and every size tested;
- the refused variants raise NotImplementedError (arithmetic coding, 12-bit
  samples, lossless, CMYK, other sampling layouts); truncated data raise;
- the fixtures in tests/torch_jpeg_fixtures/ (which chip_smoke.py decodes
  and encodes on a host without PIL) are what PIL writes and decodes here;
- `upnerf_torch.data.synthetic.generate_scene` writes the JAX generator's
  scene file for file; `load_rgb_u8` (downscale 1 and 2) and `image_wh` on
  JPEGs equal the JAX package's;
- with PIL unimportable the port still reads and writes a JPEG, generates a
  Phototourism-layout scene, runs `load_training_data` and the preprocess
  CLI (extractors shrunk) on it.
"""

import functools
import io
import os
import struct
import sys

import jax  # noqa: F401  (tests/conftest.py keeps it on the CPU)
import numpy as np
import pytest
from PIL import Image

from upnerf.data import images as jimages
from upnerf.data import synthetic as jsyn
from upnerf_torch.cli import preprocess
from upnerf_torch.config import default
from upnerf_torch.data import images as timages
from upnerf_torch.data import load_training_data
from upnerf_torch.data import synthetic as tsyn
from upnerf_torch.features import dino, dpt, jpeg, vit
from upnerf_torch.features.images import image_wh, read_rgb_u8

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_jpeg_fixtures")
SIZES = [(1, 1), (7, 5), (16, 16), (17, 33), (129, 97)]  # (W, H)
QUALITIES = [1, 5, 50, 75, 95, 100]
SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}


def render_like(w: int, h: int, seed: int) -> np.ndarray:
    """Smooth content plus seeded noise, as a render."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([xx / max(w - 1, 1), yy / max(h - 1, 1), (xx + yy) / max(w + h - 2, 1)], -1) * 220
    return np.clip(smooth + rng.randint(-24, 25, (h, w, 3)), 0, 255).astype(np.uint8)


def pil_bytes(img: np.ndarray, **kw) -> bytes:
    f = io.BytesIO()
    Image.fromarray(img).save(f, "JPEG", **kw)
    return f.getvalue()


def pil_pixels(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


# --------------------------------------------------------------------------
# decoding against PIL


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sub", SUBSAMPLING)
def test_decode_baseline_matches_pil(sub, size, quality):
    img = render_like(*size, seed=quality)
    data = pil_bytes(img, quality=quality, subsampling=SUBSAMPLING[sub])
    got = jpeg.decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == (size[1], size[0], 3)
    np.testing.assert_array_equal(got, pil_pixels(data))


VARIANTS = {
    "progressive-420": dict(progressive=True),
    "progressive-444": dict(progressive=True, subsampling=0),
    "progressive-restart": dict(progressive=True, restart_marker_blocks=3),
    "restart-blocks": dict(restart_marker_blocks=1),
    "restart-rows-422": dict(restart_marker_rows=1, subsampling=1),
    "optimize": dict(optimize=True),
    "optimize-progressive": dict(optimize=True, progressive=True, subsampling=0),
    "q100-noise": dict(quality=100),
    "q100-noise-progressive": dict(quality=100, progressive=True),
}


@pytest.mark.parametrize("size", [(7, 5), (17, 33), (129, 97)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("variant", VARIANTS)
def test_decode_variants_match_pil(variant, size):
    kw = dict(VARIANTS[variant])
    if variant.startswith("q100"):
        img = np.random.RandomState(size[0]).randint(0, 256, (size[1], size[0], 3)).astype(np.uint8)
    else:
        img = render_like(*size, seed=7)
        kw.setdefault("quality", 85)
    data = pil_bytes(img, **kw)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), pil_pixels(data))


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("size", [(1, 1), (17, 33), (129, 97)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_decode_grey_matches_pil(size, progressive):
    """One component: grey replicated to RGB, as convert("RGB") does."""
    grey = render_like(*size, seed=3)[..., 1]
    data = pil_bytes(grey, quality=90, progressive=progressive)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), pil_pixels(data))


def segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def build_jpeg(rgb: np.ndarray, luma_hv=(2, 2), ids=(1, 2, 3), colour="ycc", jfif=True, adobe=None, qt16=False,
               extra=b"", tables_after_frame=False, quality=90) -> bytes:
    """A baseline JPEG in layouts PIL does not write, from the codec's own
    pieces: luma sampled luma_hv = (h, v) over 1 x 1 chroma (2 x 2 box
    means), or three 1 x 1 RGB planes (colour="rgb"); optional JFIF / Adobe
    markers, 16-bit DQT, extra segments, tables after SOF."""
    h, v = luma_hv if colour == "ycc" else (1, 1)
    H, W = rgb.shape[:2]
    cols, rows = -(-W // (8 * h)), -(-H // (8 * v))
    planes = jpeg._rgb_to_ycc(rgb) if colour == "ycc" else [rgb[..., i].astype(np.int64) for i in range(3)]
    padded = [np.pad(p, ((0, rows * 8 * v - H), (0, cols * 8 * h - W)), mode="edge") for p in planes]
    chroma = [p.reshape(rows * 8, v, cols * 8, h).mean(axis=(1, 3)).round().astype(np.int64) for p in padded[1:]]
    qy, qc = jpeg.quant_tables(quality)
    if colour == "rgb":
        qc = qy
    luma = jpeg._fdct_quantise(padded[0], qy).reshape(rows, v, cols, h, 64).transpose(0, 2, 1, 3, 4)
    cb, cr = (jpeg._fdct_quantise(c, qc)[:, :, None] for c in chroma)
    blocks = np.concatenate([luma.reshape(rows, cols, h * v, 64), cb, cr], axis=2).reshape(-1, 64)
    comp = np.tile(np.array([0] * (h * v) + [1, 2]), rows * cols)
    tab = [0, 0, 0] if colour == "rgb" else [0, 1, 1]  # RGB: every plane through the luminance tables
    data = jpeg._entropy_code(blocks, comp, np.array(tab)[comp])
    dqt = b"".join(segment(0xDB, bytes([(16 if qt16 else 0) | t]) + (q[jpeg.NATURAL_ORDER].astype(">u2").tobytes()
                                                                    if qt16 else q[jpeg.NATURAL_ORDER].astype(np.uint8)
                                                                    .tobytes()))
                   for t, q in enumerate((qy, qc)))
    sof = segment(0xC0, struct.pack(">BHHB", 8, H, W, 3)
                  + b"".join(bytes([ids[i], (h << 4 | v) if i == 0 else 0x11, tab[i]]) for i in range(3)))
    dht = b"".join(segment(0xC4, bytes([tc << 4 | th]) + jpeg._STD_HUFF[(tc, th)]) for tc in (0, 1) for th in (0, 1))
    sos = segment(0xDA, bytes([3] + [x for i in range(3) for x in (ids[i], tab[i] * 0x11)] + [0, 63, 0]))
    head = b"\xff\xd8"
    if jfif:
        head += segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        head += segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([adobe]))
    tables = dqt + dht
    body = (sof + extra + tables) if tables_after_frame else (tables + extra + sof)
    return head + body + sos + data + b"\xff\xd9"


EXIF_ROTATE = segment(0xE1, b"Exif\x00\x00MM\x00\x2a\x00\x00\x00\x08\x00\x01\x01\x12\x00\x03\x00\x00\x00\x01\x00\x06"
                      b"\x00\x00\x00\x00\x00\x00")
HAND_BUILT = {
    "4:4:0": dict(luma_hv=(1, 2)),
    "4:2:2": dict(luma_hv=(2, 1)),
    "4:2:0-qt16-tables-after-sof": dict(qt16=True, tables_after_frame=True),
    "4:4:4-com-exif": dict(luma_hv=(1, 1), extra=segment(0xFE, b"a comment") + EXIF_ROTATE),
    "adobe-rgb": dict(colour="rgb", jfif=False, adobe=0),
    "rgb-by-ids": dict(colour="rgb", jfif=False, ids=(82, 71, 66)),
    "adobe-ycc": dict(luma_hv=(2, 2), jfif=False, adobe=1),
}


@pytest.mark.parametrize("size", [(1, 1), (2, 3), (7, 5), (17, 33), (129, 97)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("layout", HAND_BUILT)
def test_decode_hand_built_layouts_match_pil(layout, size):
    img = render_like(*size, seed=11)
    data = build_jpeg(img, **HAND_BUILT[layout])
    want = pil_pixels(data)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), want)
    if layout.startswith("4:4:4"):  # EXIF orientation 6 is not applied, as PIL's open does not apply it
        assert want.shape == (size[1], size[0], 3)


def test_decode_out_of_range_samples_saturate_as_pil(monkeypatch):
    """A stream whose three components share one DC predictor (a corrupt
    encoder's) drives some blocks' samples past +-512 around 128: PIL's
    libjpeg-turbo (its SIMD IDCT) saturates them, and so does the port."""
    img = render_like(17, 33, seed=11)
    orig = jpeg._entropy_code
    monkeypatch.setattr(jpeg, "_entropy_code", lambda blocks, comp, tab=None: orig(blocks, comp * 0, tab))
    data = build_jpeg(img, colour="rgb", jfif=False, adobe=0)
    monkeypatch.undo()
    want = pil_pixels(data)
    assert np.abs(want.astype(int) - img).max() == 255  # the corrupt DC pins samples at the range's ends
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), want)


def patch(data: bytes, marker: bytes, offset: int, value: bytes) -> bytes:
    i = data.index(marker)
    return data[: i + offset] + value + data[i + offset + len(value) :]


def test_refused_variants_raise():
    base = pil_bytes(render_like(17, 9, seed=1), quality=80)
    sof = b"\xff\xc0"
    cases = {
        "arithmetic": patch(base, sof, 1, b"\xc9"),
        "arithmetic-progressive": patch(base, sof, 1, b"\xca"),
        "lossless": patch(base, sof, 1, b"\xc3"),
        "12-bit": patch(base, sof, 4, b"\x0c"),
        "chroma 2x2": patch(base, sof, 14, b"\x22"),
        "luma 4x1": patch(base, sof, 11, b"\x41"),
    }
    f = io.BytesIO()
    Image.new("CMYK", (9, 7), (10, 20, 30, 40)).save(f, "JPEG")
    cases["CMYK"] = f.getvalue()
    words = {"arithmetic": "arithmetic", "arithmetic-progressive": "arithmetic", "lossless": "lossless",
             "12-bit": "12-bit", "chroma 2x2": "sampling", "luma 4x1": "sampling", "CMYK": "4 components"}
    for name, data in cases.items():
        with pytest.raises(NotImplementedError, match=words[name]):
            jpeg.decode_jpeg(data)
    with pytest.raises(NotImplementedError, match="arithmetic"):  # a DAC segment before the frame
        jpeg.decode_jpeg(base[:2] + segment(0xCC, b"\x00\x10") + base[2:])


@pytest.mark.parametrize("cut", [0.2, 0.5, 0.97])
@pytest.mark.parametrize("progressive", [False, True])
def test_truncated_data_raise(cut, progressive):
    """Cut in the headers or the entropy-coded data: PIL raises, so does the
    port."""
    data = pil_bytes(render_like(64, 48, seed=2), quality=95, progressive=progressive)
    short = data[: int(len(data) * cut)]
    with pytest.raises(OSError):
        Image.open(io.BytesIO(short)).convert("RGB")
    with pytest.raises(ValueError, match="truncated"):
        jpeg.decode_jpeg(short)


# --------------------------------------------------------------------------
# encoding against PIL


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_encode_matches_pil(size, quality):
    img = render_like(*size, seed=quality + 1)
    assert jpeg.encode_jpeg(img, quality) == pil_bytes(img, quality=quality)


@pytest.mark.parametrize("size", [(9, 7), (33, 17)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_encode_every_quality_matches_pil(size):
    img = np.random.RandomState(size[0]).randint(0, 256, (size[1], size[0], 3)).astype(np.uint8)
    for q in range(1, 101):
        assert jpeg.encode_jpeg(img, q) == pil_bytes(img, quality=q), q


def test_write_jpeg_and_jpeg_wh(tmp_path):
    img = render_like(37, 21, seed=5)
    path = str(tmp_path / "a.jpg")
    jpeg.write_jpeg(path, img)
    with open(path, "rb") as f:
        assert f.read() == pil_bytes(img, quality=95)
    assert jpeg.jpeg_wh(path) == image_wh(path) == Image.open(path).size == (37, 21)
    prog = str(tmp_path / "p.jpg")
    Image.fromarray(img).save(prog, quality=70, progressive=True, exif=EXIF_ROTATE[4:])
    assert jpeg.jpeg_wh(prog) == image_wh(prog) == (37, 21)
    np.testing.assert_array_equal(read_rgb_u8(prog), np.asarray(Image.open(prog).convert("RGB")))


# --------------------------------------------------------------------------
# the fixtures that chip_smoke.py checks on a host without PIL

FIXTURE_DECODES = {
    "baseline-444": dict(quality=90, subsampling=0),
    "baseline-422": dict(quality=90, subsampling=1),
    "baseline-420": dict(quality=90, subsampling=2),
    "progressive": dict(quality=85, progressive=True),
    "restart": dict(quality=85, restart_marker_blocks=2),
    "grey": dict(quality=90),
    "optimize": dict(quality=85, optimize=True),
    "q100-noise": dict(quality=100),
}


def write_fixtures(out_dir: str) -> None:
    """decode_<name>.jpg with PIL's decoded pixels as decode_<name>.npy (odd
    sizes, one file per variant), and encode_q95.npy with the bytes PIL
    writes for it at quality 95 as encode_q95.jpg."""
    os.makedirs(out_dir, exist_ok=True)
    for i, (name, kw) in enumerate(FIXTURE_DECODES.items()):
        if name == "q100-noise":
            img = np.random.RandomState(i).randint(0, 256, (29, 37, 3)).astype(np.uint8)
        else:
            img = render_like(37, 29, seed=i)
        if name == "grey":
            img = img[..., 0]
        data = pil_bytes(img, **kw)
        with open(os.path.join(out_dir, f"decode_{name}.jpg"), "wb") as f:
            f.write(data)
        np.save(os.path.join(out_dir, f"decode_{name}.npy"), pil_pixels(data))
    img = render_like(61, 45, seed=95)
    np.save(os.path.join(out_dir, "encode_q95.npy"), img)
    with open(os.path.join(out_dir, "encode_q95.jpg"), "wb") as f:
        f.write(pil_bytes(img, quality=95))


def test_fixtures_are_what_pil_writes(tmp_path):
    write_fixtures(str(tmp_path))
    names = sorted(os.listdir(tmp_path))
    assert names == sorted(os.listdir(FIXTURES))
    for name in names:
        with open(tmp_path / name, "rb") as a, open(os.path.join(FIXTURES, name), "rb") as b:
            assert a.read() == b.read(), name
    assert sum(os.path.getsize(os.path.join(FIXTURES, n)) for n in names) < 200_000


@pytest.mark.parametrize("name", FIXTURE_DECODES)
def test_fixture_decodes_to_its_pixels(name):
    with open(os.path.join(FIXTURES, f"decode_{name}.jpg"), "rb") as f:
        got = jpeg.decode_jpeg(f.read())
    np.testing.assert_array_equal(got, np.load(os.path.join(FIXTURES, f"decode_{name}.npy")))


def test_fixture_encodes_to_pil_bytes():
    with open(os.path.join(FIXTURES, "encode_q95.jpg"), "rb") as f:
        assert jpeg.encode_jpeg(np.load(os.path.join(FIXTURES, "encode_q95.npy")), 95) == f.read()


# --------------------------------------------------------------------------
# the JPEG scene path against the JAX package


@pytest.mark.parametrize("layout", [False, True], ids=["custom", "phototourism"])
def test_generator_writes_the_jax_scene(tmp_path, layout):
    """Same arguments, same files: the JPEGs' bytes, metadata.json, the
    feature maps, PCA infos and DPT arrays (and the tsv / COLMAP binaries)."""
    kw = dict(n_train=4, n_test=2, H=33, W=47, feat_hw=7, feat_dim=12, focal=40.0, seed=9, arc=0.4,
              phototourism_layout=layout, feature_mode="world" if layout else "color", interleave_test=layout)
    jroot, troot = str(tmp_path / "jax" / "scene"), str(tmp_path / "port" / "scene")
    jmeta, tmeta = jsyn.generate_scene(jroot, **kw), tsyn.generate_scene(troot, **kw)
    assert tmeta == jmeta

    def listing(root):
        return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)

    files = listing(jroot)
    assert files == listing(troot)
    assert sum(f.endswith(".jpg") for f in files) == 6
    for f in files:
        with open(os.path.join(jroot, f), "rb") as a, open(os.path.join(troot, f), "rb") as b:
            assert a.read() == b.read(), f


def test_load_rgb_u8_and_image_wh_match_jax_on_jpegs(tmp_path):
    root = str(tmp_path / "scene")
    jsyn.generate_scene(root, n_train=2, n_test=1, H=37, W=53, feat_hw=5, feat_dim=8, seed=4)
    paths = [os.path.join(root, "dense", "images", f"{i:03d}.jpg") for i in range(3)]
    img = render_like(45, 31, seed=6)
    for kw in (dict(quality=75, subsampling=0), dict(quality=60, progressive=True), dict(quality=90, subsampling=1)):
        paths.append(str(tmp_path / f"extra{len(paths)}.jpg"))
        Image.fromarray(img).save(paths[-1], **kw)
    for p in paths:
        for factor in (1, 2):
            np.testing.assert_array_equal(timages.load_rgb_u8(p, factor), jimages.load_rgb_u8(p, factor))
        assert image_wh(p) == Image.open(p).size


def test_jpeg_scene_without_pil(tmp_path, monkeypatch):
    """As on the card's host: PIL cannot be imported."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError):
        from PIL import Image as _  # noqa: F401
    img = render_like(23, 19, seed=8)
    path = str(tmp_path / "x.jpg")
    jpeg.write_jpeg(path, img, quality=90)
    with open(path, "rb") as f:
        np.testing.assert_array_equal(read_rgb_u8(path), jpeg.decode_jpeg(f.read()))
    root = str(tmp_path / "scene")
    meta = tsyn.generate_scene(root, n_train=3, n_test=1, H=20, W=24, feat_hw=6, feat_dim=8, seed=2,
                               phototourism_layout=True)
    assert all(v["name"].endswith(".jpg") for v in meta.values())
    hp = default()
    hp.update({"dataset_name": "phototourism", "scene_name": "scene", "root_dir": root,
               "feat_dir": os.path.join(root, "DINO"), "depth_dir": os.path.join(root, "DPT"),
               "phototourism.img_downscale": 2, "phototourism.use_cache": False})
    scene_np, store_np, tmeta = load_training_data(hp)
    assert tmeta.N_images_train == 3
    assert store_np["rgb"].shape == (3 * 10 * 12, 3) and scene_np["feat_maps"].shape == (3, 6, 6, 8)
    first = timages.load_rgb_u8(os.path.join(root, "dense", "images", "000.jpg"), 2)
    np.testing.assert_array_equal(store_np["rgb"][: 10 * 12], first.reshape(-1, 3))
    # the extractors' path: preprocess on the scene's JPEGs (DINO and DPT shrunk, as in test_torch_features.py)
    cfg = vit.ViTConfig(patch_size=8, dim=32, depth=3, heads=4, base_grid=4)

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
        return out

    np.savez(tmp_path / "dino.npz", **flat(vit.init_vit_params(np.random.default_rng(1), cfg)))
    dparams, dcfg, dhooks = dpt.init_dpt_params(np.random.default_rng(2), small=True)
    np.savez(tmp_path / "dpt.npz", **flat(dparams))
    monkeypatch.setattr(dino, "DinoExtractor", functools.partial(dino.DinoExtractor, cfg=cfg, layer=1,
                                                                 load_size=32))
    monkeypatch.setattr(dpt, "DPTDepth", functools.partial(dpt.DPTDepth, net_size=64))
    monkeypatch.setattr(dpt, "dpt_forward", functools.partial(dpt.dpt_forward, cfg=dcfg, hooks=dhooks))
    out = tmp_path / "features"
    preprocess.main(["--image_dir", os.path.join(root, "dense", "images"), "--save_dir", str(out), "--what", "dino",
                     "dpt", "--dino_weights", str(tmp_path / "dino.npz"), "--dpt_weights", str(tmp_path / "dpt.npz"),
                     "--device", "cpu"])
    assert np.load(out / "DINO" / "feature_maps" / "003.npy").shape == (7, 7, 32)
    assert np.load(out / "DPT" / "003.npy").shape == (20, 24)
