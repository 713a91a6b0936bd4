"""The port's config layer (upnerf_torch.config, read and written without
PyYAML) against the JAX package's (upnerf.config, on PyYAML), exactly:

- every YAML file of the repository (configs/, configs/validation/, the
  default and the best_pose preset): the raw document equals
  `yaml.safe_load`'s and the flattened, coerced config equals `upnerf.config`'s;
- scalar spellings where PyYAML's rules bite (`1e-3` is a string that
  `_coerce` makes a float, `5.` a float, `none` a string, `None` -> None);
- `parse_cli` with --preset and `key value` overrides, `tpu.fused_train false`
  among them;
- `save_yaml` both ways: each package reads the file the other writes;
- the render flags the config sets (an omitted tpu.fused_* is on;
  `tpu.save_chain false` raises) and the warp config (mitigations raise).
"""

import argparse
import glob
import math
import os

import pytest
import yaml

from upnerf.config import config as jconfig
from upnerf_torch.config import config as tconfig
from upnerf_torch.config import yaml_subset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML_FILES = sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True)
    + glob.glob(os.path.join(REPO, "upnerf", "config", "**", "*.yaml"), recursive=True)
)


def same(a, b):
    """Equality that takes NaN as equal to NaN."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


def test_every_yaml_file_is_covered():
    assert len(YAML_FILES) >= 16 and "upnerf/config/presets/best_pose.yaml" in YAML_FILES


@pytest.mark.parametrize("path", YAML_FILES)
def test_yaml_files_load_as_in_jax(path):
    full = os.path.join(REPO, path)
    with open(full) as f:
        text = f.read()
    assert same(yaml_subset.safe_load(text), yaml.safe_load(text))
    assert same(tconfig.load(full), jconfig.load(full))


def test_packaged_copies_equal_the_jax_package_files():
    assert same(tconfig.default(), jconfig.default())
    with open(os.path.join(REPO, "upnerf/config/presets/best_pose.yaml")) as f, \
            open(os.path.join(os.path.dirname(tconfig.__file__), "presets", "best_pose.yaml")) as g:
        assert f.read() == g.read()


SNIPPETS = [
    "a: 1e-3\nb: 5.\nc: none\nd: None\ne: null\nf: ~\ng:\n",
    "a: [0.1, 0.5]\nb: ['rgb_fine','c_depth_fine', \"x y\"]\nc: []\nd: {}\n",
    "a: yes\nb: Off\nc: TRUE\nd: 0x1f\ne: 017\nf: -3_000\ng: .inf\nh: -.Inf\ni: 1.5e+3\nj: 1.0e-05\nk: +7\n",
    "a: 'it''s'  # comment\nb: \"tab\\there\"\nc: plain text # with comment\nd: a#b\n",
    "top:\n  list:\n  - 1\n  - '2'\n  - x\n  nested:\n    deep: 3\n  other:\n    - 4\n    - 5\n",
    "--- \nk: v\n",
]


@pytest.mark.parametrize("text", SNIPPETS)
def test_scalar_rules_match_pyyaml(text):
    assert same(yaml_subset.safe_load(text), yaml.safe_load(text))
    assert same(tconfig.flatten(yaml_subset.safe_load(text)), jconfig.flatten(yaml.safe_load(text)))


def parser():
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--preset", action="append", default=None)
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p


@pytest.mark.parametrize("argv", [
    ["--config", "configs/brandenburg_gate.yaml"],
    ["--config", "configs/brandenburg_gate.yaml", "--preset", "best_pose", "tpu.fused_train", "false",
     "max_steps", "12", "optimizer.lr", "1e-3", "val.img_idx", "[0, 2]", "resume_ckpt", "None"],
    ["--config", "configs/validation/synth_small.yaml", "tpu.fused_trunk", "False", "exp_name", "run 1"],
])
def test_parse_cli_matches_jax(argv):
    argv = [os.path.join(REPO, a) if a.endswith(".yaml") else a for a in argv]
    got, want = tconfig.parse_cli(parser(), argv), jconfig.parse_cli(parser(), argv)
    assert same(got, want)
    if "tpu.fused_train" in argv:
        assert got["tpu.fused_train"] is False


def test_save_yaml_round_trips_both_ways(tmp_path):
    cfg = jconfig.parse_cli(parser(), ["--config", os.path.join(REPO, "configs/brandenburg_gate.yaml"),
                                       "--preset", "best_pose", "tpu.fused_train", "false", "debug", "True"])
    cfg.update({"x.strs": ("a", "12", "None", "it's"), "x.mixed": (1, 2.5e-05, None, True), "x.empty": (),
                "x.inf": float("inf"), "x.small": 1e-12, "x.neg": -3})
    jpath, tpath = str(tmp_path / "jax.yaml"), str(tmp_path / "port.yaml")
    jconfig.save_yaml(cfg, jpath)
    tconfig.save_yaml(cfg, tpath)
    want = jconfig.load(jpath)
    assert same(tconfig.load(jpath), want)  # the port reads JAX's file
    assert same(jconfig.load(tpath), want)  # JAX reads the port's file
    assert same(tconfig.load(tpath), want)
    with open(tpath) as f:
        assert same(yaml_subset.safe_load(f.read()), yaml.safe_load(open(tpath)))


def test_render_and_field_flags_from_config():
    from upnerf_torch.models.nerf import NeRFConfig
    from upnerf_torch.render.render_rays import RenderConfig
    from upnerf_torch.train.warp import WarpConfig

    hp = tconfig.default()
    rc, nc = RenderConfig.from_hparams(hp), NeRFConfig.from_hparams(hp)
    assert rc.fused_train and rc.fused_render and rc.save_chain and not rc.remat and nc.fused_trunk
    tconfig.merge_from_list(hp, ["tpu.fused_train", "false", "tpu.fused_trunk", "false", "tpu.remat", "true"])
    rc, nc = RenderConfig.from_hparams(hp), NeRFConfig.from_hparams(hp)
    assert not rc.fused_train and rc.fused_render and rc.remat and not nc.fused_trunk
    assert not RenderConfig.from_hparams(dict(hp, **{"tpu.save_chain": False})).save_chain  # unfused: unused
    with pytest.raises(NotImplementedError, match="save_chain"):
        RenderConfig.from_hparams(dict(hp, **{"tpu.fused_train": True, "tpu.save_chain": False}))
    assert WarpConfig.from_hparams(hp).mitigate == "none"
    with pytest.raises(NotImplementedError, match="multistart"):
        WarpConfig.from_hparams(dict(hp, **{"pose.warp.mitigate": "multistart"}))
