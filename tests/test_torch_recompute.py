"""The memory-saving training configuration of upnerf_torch against the JAX
package: the fused render's recompute mode (RTStatic.save_chain = False, the
JAX trainer's `tpu.save_chain false`) and the host prefetcher
(`tpu.store_on_device false`).

At the shapes of tests/test_torch_train_kernel.py (D=4, skip 2, W=32, F=16,
HH=HC=16, C=4, R=8, S=16, L=4), inputs from a numpy seed:
- the plain forward with save_chain off against the Pallas kernel's
  `_fwd_impl` in the interpreter, outputs and every residual (sig_s, sig_c,
  feat, c_feat, rgb), in each mode of tests/test_render_train_kernel.py
  COMBOS: float32 1e-5 absolute (2e-5 relative on depths); bfloat16 2e-3 of
  each tensor's max (an f32 sum on the other side of a bf16 rounding
  boundary moves a later operand by one bf16 ulp, 2^-8 relative, and the
  trunk carries it);
- the plain recompute backward against the Pallas VJP with save_chain off,
  train and frozen mode (param_grads), at the saved-chain tests'
  tolerances: float32 1e-4 of each leaf's max |g|, bfloat16 1e-3;
- the plain recompute backward against the plain saved-chain backward on
  the same inputs: 1e-6 of each leaf's max |g| (f32 rounding: the two walk
  the same values);
- one teacher-forced phase-1 train step with save_chain off against
  upnerf.train.step through its fused kernels (interpreter), as
  tests/test_torch_train_step.py holds the default configuration: loss
  terms 1e-5 relative, every gradient 1e-4 of its leaf's max |g| (1e-3 for
  share_sigma.0.bias);
- upnerf_torch.data.prefetch.BatchPrefetcher against
  upnerf.data.prefetch.BatchPrefetcher: the same seed gives the same
  batches, key by key, exactly;
- a CPU Trainer with `tpu.store_on_device false tpu.save_chain false`:
  it trains, checkpoints, and resumes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upnerf.data.prefetch import BatchPrefetcher as JBatchPrefetcher
from upnerf.ops import pallas_render_train as jrt
from upnerf_torch.data.prefetch import BatchPrefetcher
from upnerf_torch.ops import render_train as rt

import test_torch_train_kernel as tk
import test_torch_train_step as ts
from test_torch_train_step import world  # noqa: F401  (the teacher-forcing fixture)
from test_torch_trainer import hp, records, trainer_of  # noqa: F401  (hp: the trainer's tiny scene)

COMBOS, IDS = tk.COMBOS, tk.IDS


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def statics(combo, precision="float32", store_f32=True, param_grads=True):
    st, jst = tk.statics(*combo, precision=precision)
    st = st._replace(save_chain=False, store_f32=store_f32, param_grads=param_grads)
    jst = jst._replace(save_chain=False, store_f32=store_f32, param_grads=param_grads)
    return st, jst


def assert_close(got, want, precision, name):
    g, w = np.asarray(got.float() if torch.is_tensor(got) else got, np.float32), np.asarray(want, np.float32)
    g = g.reshape(w.shape)
    if precision == "bfloat16":
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(g / scale, w / scale, rtol=0, atol=2e-3, err_msg=name)
    elif "depth" in name:
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=1e-6, err_msg=name)
    else:
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("precision,store_f32", [("float32", True), ("bfloat16", True), ("bfloat16", False)],
                         ids=["f32", "bf16", "bf16-store-bf16"])
@pytest.mark.parametrize("combo", COMBOS, ids=IDS)
def test_plain_forward_without_chain_matches_pallas_interpret(combo, precision, store_f32, monkeypatch):
    monkeypatch.setattr(jrt, "INTERPRET", True)
    st, jst = statics(combo, precision, store_f32)
    inputs = tk.make_inputs(st, seed=2)
    o, d, z, pe_w, cond, cemb, trunk, heads = tk.to_jax(inputs)
    want, want_res = jrt._fwd_impl({"o": o, "d": d, "pe_w": pe_w}, z, cond, cemb, trunk, heads, jst, save_res=True)
    out, res = tk.plain_fwd(inputs, st, save_res=True)
    assert tuple(res) == st.res_keys == jst.res_keys and "chain" not in res
    for k in st.out_keys:
        assert_close(out[k], want[k], precision, k)
    sdt = torch.bfloat16 if precision == "bfloat16" and not store_f32 else torch.float32
    for k, w in zip(jst.res_keys, want_res):
        if k in ("feat", "cfeat"):
            assert res[k].dtype == sdt and tuple(res[k].shape) == (tk.R * tk.S, tk.F), k
        assert_close(res[k], np.asarray(w, np.float32), precision, k)


def compare_data_cots(got, want, rel):
    """rays_o, rays_d, and ray_cond / c_emb where the mode has them."""
    for name, g, w in zip(["rays_o", "rays_d", "ray_cond", "c_emb"], got[:4], want[:4]):
        if g is not None:
            tk.assert_leaf_close(g, w, rel, name)


@pytest.mark.parametrize("param_grads", [True, False], ids=["train", "frozen"])
@pytest.mark.parametrize("combo", COMBOS, ids=IDS)
def test_plain_recompute_backward_matches_pallas_vjp(combo, param_grads, monkeypatch):
    monkeypatch.setattr(jrt, "INTERPRET", True)
    st, jst = statics(combo, param_grads=param_grads)
    inputs = tk.make_inputs(st, seed=4)
    cots = tk.cotangents(st)
    got = tk.plain_bwd(inputs, st, cots)
    want = tk.jax_vjp(inputs, jst, cots)
    if param_grads:
        tk.compare_grads(got, want, st, 1e-4)
    else:
        assert got[4] is None and got[5] is None
        compare_data_cots(got, want, 1e-4)


@pytest.mark.parametrize("param_grads", [True, False], ids=["train", "frozen"])
@pytest.mark.parametrize("combo", [COMBOS[0], COMBOS[2]], ids=["phase1", "phase2"])
def test_plain_bf16_recompute_backward_matches_pallas_vjp(combo, param_grads, monkeypatch):
    monkeypatch.setattr(jrt, "INTERPRET", True)
    st, jst = statics(combo, "bfloat16", param_grads=param_grads)
    inputs = tk.make_inputs(st, seed=6)
    cots = tk.cotangents(st, seed=10)
    got, want = tk.plain_bwd(inputs, st, cots), tk.jax_vjp(inputs, jst, cots)
    if param_grads:
        tk.compare_grads(got, want, st, 1e-3)
    else:
        compare_data_cots(got, want, 1e-3)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("combo", COMBOS, ids=IDS)
def test_plain_recompute_matches_saved_chain(combo, precision):
    """The two residual modes walk the same values: the saved chain's bf16
    rounding is the rounding every product applies to its operands, and it
    keeps the ReLU masks' signs."""
    st, _ = statics(combo, precision)
    inputs = tk.make_inputs(st, seed=3)
    cots = tk.cotangents(st, seed=11)
    rec = tk.plain_bwd(inputs, st, cots)
    saved = tk.plain_bwd(inputs, st._replace(save_chain=True), cots)
    tk.compare_grads(rec, saved, st, 1e-6)


def test_render_train_rays_function_saves_the_recompute_residuals():
    """RenderTrainRays in the recompute mode on the CPU: it saves feat and
    c_feat, no chain, and its gradients are the plain recompute backward's."""
    st, _ = statics(COMBOS[0])
    inputs = tk.make_inputs(st, seed=5)
    cots = tk.cotangents(st, seed=9)
    o, d, z, pe_w, cond, cemb, trunk, heads = tk.to_torch(inputs, grad=True)
    out = rt.render_train_rays(o, d, z, pe_w, cond, trunk, heads, st, c_emb=cemb)
    node = out["s_weights"].grad_fn
    assert node.res_keys == ("sig_s", "sig_c", "feat", "cfeat", "rgb")
    sum((out[k] * torch.from_numpy(v)).sum() for k, v in cots.items()).backward()
    want = tk.plain_bwd(inputs, st, cots)
    assert torch.equal(o.grad, want[0]) and torch.equal(d.grad, want[1]) and torch.equal(cemb.grad, want[3])
    for (w, b), (gw, gb) in zip(trunk, want[4]):
        assert torch.equal(w.grad, gw) and torch.equal(b.grad, gb)


def test_phase1_step_without_chain_matches_jax(world, monkeypatch):  # noqa: F811
    """A teacher-forced phase-1 step with tpu.save_chain false against the JAX
    step through its fused kernels in that mode (interpreter)."""
    from upnerf.train.schedules import schedule_mult as jsched
    from upnerf.train.step import _loss_and_metrics as jloss_and_metrics
    from upnerf_torch.train import pe_progress, schedule_mult
    from upnerf_torch.train import step as tstep
    from upnerf_torch.utils import weights

    monkeypatch.setattr(jrt, "INTERPRET", True)
    phase = 1
    jcfg = ts.jax_cfg()
    jcfg = jcfg._replace(render=jcfg.render._replace(fused_train=True, save_chain=False))
    progress = jnp.asarray(ts.STEP_OF_PHASE[phase], jnp.int32).astype(jnp.float32) / ts.MAX_STEPS
    noise = {k: jnp.asarray(v) for k, v in world["noise"].items()}

    def f(p, pp):
        return jloss_and_metrics(p, pp, jcfg, world["scene"], world["jbatch"], noise, phase,
                                 jsched(progress, jcfg.candidate_schedule), progress)

    (_, jm), (g, pg) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(world["params"], world["pose"])
    jg = weights.state_dict_from_jax(jax.tree.map(np.asarray, g), jax.tree.map(np.asarray, pg), 0.0)

    state, _, _ = ts.port_state(world)
    cfg = ts.torch_cfg()
    cfg = cfg._replace(render=cfg.render._replace(save_chain=False))
    tprog = pe_progress(ts.STEP_OF_PHASE[phase], ts.MAX_STEPS)
    loss, tm = tstep._loss_and_metrics(state.params, state.pose_params, cfg, world["tscene"], world["tbatch"],
                                       {k: torch.from_numpy(v) for k, v in world["noise"].items()}, phase,
                                       schedule_mult(tprog, cfg.candidate_schedule), tprog)
    loss.backward()
    tg = {k: p.grad for k, p in state.params.named_parameters() if p.requires_grad}
    tg.update({k: p.grad for k, p in state.pose_params.named_parameters()})
    ts.check_losses(tm, jm)
    ts.check_grads(tg, jg)


@pytest.mark.parametrize("batch,n_rays", [(64, 1000), (7, 50)])
def test_prefetcher_matches_jax(batch, n_rays):
    rng = np.random.RandomState(0)
    store = {"px": rng.randint(0, 500, n_rays).astype(np.uint16), "py": rng.randint(0, 400, n_rays).astype(np.uint16),
             "img_idx": rng.randint(0, 9, n_rays).astype(np.int32),
             "rgb": rng.randint(0, 256, (n_rays, 3)).astype(np.uint8),
             "inv_depth": rng.rand(n_rays).astype(np.float16)}
    want = JBatchPrefetcher(store, batch, device_put=lambda b: b, seed=7)
    got = BatchPrefetcher(store, batch, "cpu", seed=7)
    try:
        for _ in range(5):
            w, g = next(want), next(got)
            assert set(g) == set(w)
            for k in w:
                gv = g[k].numpy()
                assert gv.dtype == (np.int64 if k == "img_idx" else np.float32), k
                np.testing.assert_array_equal(gv, w[k], err_msg=k)
    finally:
        want.close()
        got.close()


def test_streaming_recompute_trainer_checkpoints_and_resumes(hp):  # noqa: F811
    """Trainer with the host store and the recompute mode, on the CPU: every
    step draws its batch from the prefetcher, which fit() closes; it writes a
    checkpoint, and a second Trainer resumes from it."""
    over = {"exp_name": "stream", "tpu.store_on_device": False, "tpu.save_chain": False}
    tr = trainer_of(hp, **over)
    assert tr.store is None and tr.prefetcher is not None and not tr.cfg.render.save_chain

    class Counting:
        def __init__(self, inner):
            self.inner, self.sizes = inner, []

        def __next__(self):
            batch = next(self.inner)
            self.sizes.append(batch["px"].shape[0])
            return batch

        def close(self):
            self.inner.close()

    tr.prefetcher = counting = Counting(tr.prefetcher)
    state = tr.fit(log_every=5, max_steps=10)
    assert state.step == 10 and counting.sizes == [tr.cfg.batch_size] * 10 and tr.prefetcher is None
    assert tr.ckpt.latest_step() == 10
    losses = [r["loss"] for r in records(tr) if "loss" in r]
    assert len(losses) == 2 and np.isfinite(losses).all()
    tr2 = trainer_of(hp, **over)
    assert tr2.fit(log_every=5, max_steps=14).step == 14
    assert tr2.ckpt.latest_step() == 14
