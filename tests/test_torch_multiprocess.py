"""The port's multi-process training through `upnerf_torch.cli.train`, on the
CPU over gloo: real process boundaries, modelled on tests/test_multiprocess.py.

- two OS processes, each one host of `dist.num_processes 2` with one rank
  (`dist.coordinator`, `dist.process_id`), train 12 steps on the
  device-resident store: their parameters are equal bit for bit, and match
  a one-process run of the same config within rtol 2e-4 / atol 1e-5 (the
  same global batches; the gradient sums reordered); rank 0 alone wrote
  metrics.jsonl (one record a log point), config.yaml and ckpts/;
- a second launch of the two processes resumes from the step-12 checkpoint
  and runs to 18 in the host-streaming mode (`tpu.store_on_device false`:
  rank r draws batch_size / 2 rows with seed + r): equal bits across the
  processes, finite loss, rank 0's records continued (one launch covers
  both, as each launch costs seconds of process start);
- one launch of `tpu.n_devices 2 --device cpu`: two spawned ranks; its
  checkpoint matches the one-process run (the same tolerance);
- `cli.tto` on a checkpoint of `tpu.n_devices 2`: two CPU ranks, whose
  metrics (1e-4 relative) and refined poses (1e-5) are one rank's;
- a multistart warp event under `tpu.n_devices 2`: the ranks stay equal.
The worker is this file run as a script: it trains through the CLI and writes
a digest of its final state.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 12
TINY = {
    "dataset_name": "custom", "scene_name": "toy", "exp_name": "mp", "debug": True, "seed": 3,
    "phototourism.img_downscale": 1, "phototourism.use_cache": False, "nerf.D": 2, "nerf.W": 32, "nerf.skips": [1],
    "nerf.N_samples": 8, "nerf.N_importance": 4, "nerf.N_emb_xyz": 4, "nerf.N_emb_dir": 2, "nerf.appearance_dim": 8,
    "nerf.candidate_dim": 4, "nerf.feat_dim": 8, "t_net.feat_dim": 8, "t_net.transient_dim": 8,
    "train.batch_size": 64, "train.ckpt_interval": 100, "train.log_pose_interval": 0, "val.log_interval": 6,
    "val.chunk_size": 128, "tpu.matmul_precision": "float32",
}


def argv_of(scene_dir: str, out_dir: str, **over) -> list:
    """cli.train's arguments for the tiny run on the scene."""
    keys = dict(TINY, root_dir=scene_dir, feat_dir=os.path.join(scene_dir, "DINO"),
                depth_dir=os.path.join(scene_dir, "DPT"), out_dir=out_dir, max_steps=STEPS)
    keys.update(over)
    argv = ["--config", os.path.join(REPO, "configs", "custom.yaml"), "--device", "cpu"]
    for k, v in keys.items():
        argv += [k, str(v)]
    return argv


def state_digest(params: dict) -> dict:
    """Per-leaf float64 sums (in name order) and a hash of every byte."""
    h = hashlib.sha256()
    sums = []
    for k in sorted(params):
        v = params[k].detach().float().contiguous()
        h.update(v.numpy().tobytes())
        sums.append(float(v.double().sum()))
    return {"sums": sums, "sha": h.hexdigest()}


def trainer_params(trainer) -> dict:
    out = dict(trainer.state.params.named_parameters())
    out.update(trainer.state.pose_params.named_parameters())
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_cluster(tmp_path, scene_dir, out_dir, nproc=2, **over):
    """nproc worker processes of one run; their digests."""
    port = _free_port()
    procs, logs = [], []
    for pid in range(nproc):
        log = open(tmp_path / f"worker{pid}.log", "w")
        args = [sys.executable, os.path.abspath(__file__), str(pid), str(nproc), str(port), str(out_dir), "--"]
        args += argv_of(scene_dir, str(out_dir), **over)
        procs.append(subprocess.Popen(args, cwd=REPO, stdout=log, stderr=subprocess.STDOUT))
        logs.append(log)
    try:
        for p in procs:
            p.wait(timeout=600)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for log in logs:
            log.close()
    for pid, p in enumerate(procs):
        if p.returncode != 0:
            tail = (tmp_path / f"worker{pid}.log").read_text()
            raise AssertionError(f"worker {pid} rc={p.returncode}\n--- log tail ---\n{tail[-4000:]}")
    digests = []
    for pid in range(nproc):
        with open(os.path.join(out_dir, f"digest_{pid}.json")) as f:
            digests.append(json.load(f))
    return digests


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    from upnerf_torch.data import synthetic

    d = str(tmp_path_factory.mktemp("mp") / "scene")
    synthetic.generate_scene(d, n_train=3, n_test=1, H=20, W=24, feat_hw=6, feat_dim=8)
    return d


@pytest.fixture(scope="module")
def single(scene_dir, tmp_path_factory):
    """The one-process run of the same config, in this process."""
    from upnerf_torch.cli import train

    torch.set_num_threads(1)
    trainer = train.main(argv_of(scene_dir, str(tmp_path_factory.mktemp("single"))))
    assert trainer.state.step == STEPS and trainer.mesh.size == 1
    params = trainer_params(trainer)
    return dict(state_digest(params), names=sorted(params))


def run_records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def cluster(scene_dir, tmp_path_factory):
    """Two processes of `dist.num_processes 2`, STEPS steps: (output dir,
    digests, the run's metric records and checkpoints when they ended)."""
    logs = tmp_path_factory.mktemp("cluster")
    out = logs / "out"
    digests = launch_cluster(logs, scene_dir, out)
    run_dir = os.path.join(out, "toy", "mp")
    return out, digests, run_records(run_dir), sorted(os.listdir(os.path.join(run_dir, "ckpts")))


@pytest.fixture(scope="module")
def resumed(cluster, scene_dir, tmp_path_factory):
    """The same two processes launched again to STEPS + 6 in the streaming
    mode: (digests, the workers' logs)."""
    logs = tmp_path_factory.mktemp("resumed")
    digests = launch_cluster(logs, scene_dir, cluster[0], max_steps=STEPS + 6, **{"tpu.store_on_device": False})
    return digests, [(logs / f"worker{pid}.log").read_text() for pid in range(2)]


def test_two_process_training_matches_single_process_and_resumes(cluster, resumed, single):
    out, digests, recs, ckpts = cluster
    assert [d["step"] for d in digests] == [STEPS, STEPS]
    assert [d["world"] for d in digests] == [2, 2] and [d["rank"] for d in digests] == [0, 1]
    assert digests[0]["sha"] == digests[1]["sha"]  # the replicated state, bit for bit
    assert np.isfinite(digests[0]["sums"]).all()
    np.testing.assert_allclose(digests[0]["sums"], single["sums"], rtol=2e-4, atol=1e-5)

    run_dir = os.path.join(out, "toy", "mp")
    assert os.path.isfile(os.path.join(run_dir, "config.yaml"))
    assert ckpts == ["12.ckpt", "6.ckpt", "ckpt_metrics.json"]
    val = [r["step"] for r in recs if "val/psnr" in r]
    assert val == [6, 12]  # one writer: one record a log point
    assert all(np.isfinite(r["loss"]) for r in recs if "loss" in r)

    digests, logs = resumed
    assert [d["step"] for d in digests] == [STEPS + 6] * 2
    assert "resumed from step 12" in logs[0]
    assert "resumed from step 12" not in logs[1]  # rank 0 prints
    assert [r["step"] for r in run_records(run_dir) if "val/psnr" in r] == [6, 12, 18]
    assert os.path.isfile(os.path.join(run_dir, "ckpts", "18.ckpt"))


def test_two_process_streaming_consistency(resumed):
    """Each rank's prefetcher feeds its own rows of the global batch (the
    resumed launch's six steps): the ranks' states stay equal bit for bit."""
    digests, _ = resumed
    assert [d["step"] for d in digests] == [STEPS + 6, STEPS + 6]
    assert digests[0]["sha"] == digests[1]["sha"]
    assert np.isfinite(digests[0]["sums"]).all()


def test_n_devices_launch_matches_single_process(tmp_path, scene_dir, single):
    from upnerf_torch.cli import train
    from upnerf_torch.utils.ckpt import CheckpointManager

    steps = train.main(argv_of(scene_dir, str(tmp_path), exp_name="ranks", **{"tpu.n_devices": 2}))
    assert steps == [STEPS, STEPS]  # the ranks' final steps; fit held their parameters equal
    sd = CheckpointManager(os.path.join(tmp_path, "toy", "ranks", "ckpts")).load(STEPS)["state_dict"]
    got = state_digest({k: sd[k] for k in single["names"]})
    np.testing.assert_allclose(got["sums"], single["sums"], rtol=2e-4, atol=1e-5)


def test_warp_mitigation_keeps_the_ranks_equal(tmp_path, scene_dir):
    """A hair-trigger detector with multistart under `tpu.n_devices 2`: both
    ranks score the same candidates on their replicated state and adopt the
    same rows, so `fit`'s closing check finds their parameters equal; rank 0
    logs the event."""
    from upnerf_torch.cli import train

    hair = {"pose.warp.detect": True, "pose.warp.ratio": 1.0001, "pose.warp.patience": 1, "pose.warp.decay": 0.0,
            "pose.warp.min_progress": 0.0, "pose.warp.max_progress": 1.0, "pose.warp.mitigate": "multistart",
            "pose.warp.kicks": 2, "pose.warp.score_rays": 64, "pose.warp.max_events": 1, "pose.warp.cooldown": 1}
    steps = train.main(argv_of(scene_dir, str(tmp_path), exp_name="warp", **{"tpu.n_devices": 2}, **hair))
    assert steps == [STEPS, STEPS]
    recs = run_records(os.path.join(tmp_path, "toy", "warp"))
    events = [r for r in recs if "train/warp_event" in r]
    assert len(events) == 1 and events[0]["step"] == STEPS and events[0]["train/warp_event"] >= 1


TTO_HP = {
    "nerf.D": 4, "nerf.W": 32, "nerf.skips": (2,), "nerf.N_emb_xyz": 4, "nerf.N_emb_dir": 2,
    "nerf.feat_dim": 16, "nerf.appearance_dim": 8, "nerf.candidate_dim": 4, "pose.c2f": (0.1, 0.5),
    "nerf.N_samples": 8, "nerf.N_importance": 8, "nerf.near": 0.1, "nerf.far": 5.0,
    "nerf.use_disp": False, "nerf.perturb": 1.0, "val.chunk_size": 64, "tpu.matmul_precision": "float32",
    "t_net.transient_dim": 8, "t_net.feat_dim": 16, "t_net.beta_min": 0.1,
}


def test_tto_cli_on_the_runs_n_devices_matches_one_rank(tmp_path):
    """cli.tto starts the checkpoint's `tpu.n_devices 2` as two CPU ranks; its
    metrics and refined poses are the one-rank run's (the gradient sums
    reordered), and rank 0 wrote them."""
    from upnerf_torch.cli import tto as tto_cli
    from upnerf_torch.data import load_scene_meta, synthetic
    from upnerf_torch.geometry import se3
    from upnerf_torch.utils import weights

    torch.set_num_threads(1)
    root = str(tmp_path / "scene")
    synthetic.generate_scene(root, n_train=3, n_test=2, H=20, W=24, focal=20.0, seed=0, phototourism_layout=True)
    hp = dict(TTO_HP, dataset_name="phototourism", root_dir=root, scene_name="scene", seed=0,
              **{"phototourism.img_downscale": 2, "pose.noise": -1})
    meta = load_scene_meta(hp)
    gt = torch.tensor(np.stack([meta.GT_poses_dict[i] for i in meta.img_ids_train]))
    runs = {}
    for n in (0, 2):
        ckpt = weights.init_reference_ckpt(str(tmp_path / f"m{n}.ckpt"), dict(hp, **{"tpu.n_devices": n}),
                                           n_images=3, seed=1)
        saved = torch.load(ckpt, weights_only=False)
        saved["state_dict"]["se3_refine.weight"] = se3.SE3_to_se3(gt)
        torch.save(saved, ckpt)
        result = str(tmp_path / f"result{n}")
        path = tto_cli.main(["--ckpt", ckpt, "--result_dir", result, "--device", "cpu", "--batch_size", "16",
                             "--pose_epochs", "2", "--appearance_epochs", "1", "--group_size", "2"])
        with open(path) as f:
            poses = [np.load(os.path.join(result, "a_optimize", "optimized_pose", f"best_pose_{i:02d}.npy"))
                     for i in range(2)]
            runs[n] = (json.load(f), poses)
    (m1, p1), (m2, p2) = runs[0], runs[2]
    assert sorted(m2) == ["0", "1"]
    for k in m1:
        for key in ("psnr", "ssim"):
            np.testing.assert_allclose(m2[k][key], m1[k][key], rtol=1e-4, err_msg=f"{k} {key}")
    np.testing.assert_allclose(np.stack(p2), np.stack(p1), rtol=0, atol=1e-5)


def main():
    """One worker process: host `pid` of `nproc`, one rank, through cli.train."""
    pid, nproc, port, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    argv = sys.argv[sys.argv.index("--") + 1:]
    sys.path.insert(0, REPO)
    torch.set_num_threads(1)
    from upnerf_torch.cli import train

    argv += ["dist.coordinator", f"127.0.0.1:{port}", "dist.num_processes", str(nproc), "dist.process_id", str(pid),
             "dist.init_timeout", "300"]
    trainer = train.main(argv)
    digest = state_digest(trainer_params(trainer))
    digest.update(step=trainer.state.step, world=trainer.mesh.size, rank=trainer.mesh.rank)
    with open(os.path.join(out_dir, f"digest_{pid}.json"), "w") as f:
        json.dump(digest, f)


if __name__ == "__main__":
    main()
