"""The weight bridge and the NeRF field of upnerf_torch against the JAX
package: state_dict_from_jax equals upnerf.utils.ref_ckpt.export_state_dict
key for key and value for value, NeRFField loads it with strict=True, and
the field's phase-2 forward matches upnerf.models.nerf.apply_nerf (float32,
1e-5 absolute). Also: the port imports neither jax nor upnerf."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upnerf.models import NeRFConfig as JNeRFConfig
from upnerf.models import TransientConfig, apply_nerf
from upnerf.train.state import init_params, init_pose_params
from upnerf.utils import ref_ckpt
from upnerf_torch.models.nerf import NeRFConfig, NeRFField
from upnerf_torch.utils import weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(D=4, W=32, skips=(2,), feat_dim=16, xyz_L=4, dir_L=2, appearance_dim=8, candidate_dim=4, c2f=(0.1, 0.5))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_model(seed=0, n_images=3):
    jcfg = JNeRFConfig(**TINY, fused_trunk=False)
    tcfg = TransientConfig(transient_dim=8, feat_dim=16)
    params = init_params(jax.random.PRNGKey(seed), jcfg, tcfg, n_images)
    pose = init_pose_params(n_images)
    rng = np.random.RandomState(seed)
    pose = {k: jnp.asarray(rng.randn(*v.shape).astype(np.float32) * 0.1) for k, v in pose.items()}
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return jcfg, to_np(params), to_np(pose)


def test_state_dict_from_jax_equals_export_state_dict():
    _, params, pose = jax_model()
    got = weights.state_dict_from_jax(params, pose, 0.37)
    want = ref_ckpt.export_state_dict(params, pose, 0.37)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_field_loads_strict_and_matches_apply_nerf():
    jcfg, params, pose = jax_model(seed=1)
    sd = weights.state_dict_from_jax(params, pose, 1.0)
    field = NeRFField(NeRFConfig(**TINY))
    field.load_state_dict({k[len("nerf_fine.") :]: v for k, v in sd.items() if k.startswith("nerf_fine.")}, strict=True)

    rng = np.random.RandomState(2)
    xyz = rng.randn(3, 5, 3).astype(np.float32)
    dirs = rng.randn(3, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    a = rng.randn(3, 8).astype(np.float32)
    for progress in (1.0, 0.3):
        with torch.no_grad():
            got = field(torch.from_numpy(xyz), torch.from_numpy(dirs), torch.from_numpy(a), progress=progress)
        want = apply_nerf(
            jax.tree.map(jnp.asarray, params["nerf_fine"]), jcfg,
            {"input_xyz": jnp.asarray(xyz), "input_dir": jnp.asarray(dirs), "input_a": jnp.asarray(a)},
            phase=2, sched_mult=jnp.asarray(1.0), progress=jnp.asarray(progress), encode_candidate=False,
            precision="float32",
        )
        for k in ("s_sigma", "s_feat", "s_rgb"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5, err_msg=k)


def test_render_params_and_reference_ckpt_roundtrip(tmp_path):
    hp = {
        "nerf.D": 4, "nerf.W": 32, "nerf.skips": (2,), "nerf.N_emb_xyz": 4, "nerf.N_emb_dir": 2,
        "nerf.feat_dim": 16, "nerf.appearance_dim": 8, "nerf.candidate_dim": 4, "pose.c2f": (0.1, 0.5),
        "t_net.transient_dim": 8, "t_net.feat_dim": 16, "t_net.beta_min": 0.1,
    }
    path = weights.init_reference_ckpt(str(tmp_path / "m.ckpt"), hp, n_images=3, seed=7)
    sd, hparams, step = weights.load_reference_ckpt(path)
    assert hparams == hp and step == 0
    # the same seed gives the same weights
    sd2, _, _ = weights.load_reference_ckpt(weights.init_reference_ckpt(str(tmp_path / "m2.ckpt"), hp, 3, seed=7))
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)
    # the JAX package reads it, and maps it back to the same state_dict
    params, pose, meta = ref_ckpt.convert_state_dict(sd)
    assert meta["n_images"] == 3 and meta["progress"] == 1.0
    back = weights.state_dict_from_jax(params, pose, 1.0)
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    # serving modules
    served, se3 = weights.render_params(sd, NeRFConfig.from_hparams(hp), "cpu")
    assert set(served) == {"nerf_coarse", "nerf_fine", "embeddings"}
    assert set(served["embeddings"]) == {"coarse_a", "fine_a"}
    assert torch.equal(se3, torch.zeros(3, 6))
    assert torch.equal(served["nerf_fine"].xyz_encoding_1[0].weight, sd["nerf_fine.xyz_encoding_1.0.weight"])


def test_port_imports_neither_jax_nor_upnerf():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['upnerf'] = None\n"
        "import upnerf_torch, upnerf_torch.geometry, upnerf_torch.ops, upnerf_torch.ops._build\n"
        "import upnerf_torch.models, upnerf_torch.render, upnerf_torch.evaluate, upnerf_torch.utils\n"
        "import upnerf_torch.cli.render_video, upnerf_torch.train, upnerf_torch.train.step\n"
        "bad = [m for m, v in sys.modules.items() if v is not None\n"
        "       and (m in ('jax', 'upnerf') or m.startswith(('jax.', 'jaxlib', 'upnerf.')))]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
