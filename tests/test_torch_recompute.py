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

import test_torch_bwd_dw as bd
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


# ---------------------------------------------------------------------------
# The recompute backward as its CUDA route runs it (render_train_bwd_rec_plain):
# per slab of rays, the chain rebuilt by the forward with save_chain on, the walk
# on it with the stored feat / c_feat, then the operand stores and the dW sums.

ROUTE_TOL = 1e-6
FEATS = (32, 384)


def rec_route_case(combo, precision, param_grads, F, frontend, seed):
    """(st, jst, numpy inputs, the plain backward's args (x0 or rays first), c_emb, residuals, cotangents) at
    the small sizes with feature width F; frontend "x0": seeded PE rows of width 40 and a trunk that reads them."""
    st, jst = statics(combo, precision, param_grads=param_grads)
    inputs = bd.with_feat(tk.make_inputs(st, seed=seed), F, seed)
    o, d, z, pe_w, cond, cemb, trunk, heads = tk.to_torch(inputs)
    rng = np.random.RandomState(seed + 1)
    shapes = {"s_weights": (tk.R, tk.S), "s_depth": (tk.R,), "rgb_map": (tk.R, 3), "feat_map": (tk.R, F),
              "j_weights": (tk.R, tk.S), "c_depth": (tk.R,), "t_weight": (tk.R,)}
    cots = {k: torch.from_numpy(rng.randn(*shapes[k]).astype(np.float32)) for k in st.out_keys}
    if frontend == "x0":
        in0 = 40
        x0 = torch.from_numpy((rng.randn(tk.R * tk.S, in0) * 0.5).astype(np.float32))
        fans = [in0] + [in0 + tk.W if i in tk.SKIPS else tk.W for i in range(1, tk.D)]
        trunk = [(torch.from_numpy((rng.randn(fan, tk.W) * 0.2).astype(np.float32)), b)
                 for fan, (_, b) in zip(fans, trunk)]
        _, res = rt.render_train_plain(x0, z, cond, trunk, heads, st, c_emb=cemb, save_res=True)
        return st, jst, inputs, (x0, z, cond, trunk, heads), cemb, res, cots
    _, res = rt.render_train_rays_plain(o, d, z, pe_w, cond, trunk, heads, st, c_emb=cemb, save_res=True)
    return st, jst, inputs, (o, d, z, pe_w, cond, trunk, heads), cemb, res, cots


def rec_route(args, st, cemb, res, cots, slab):
    fn = rt.render_train_bwd_rec_plain if len(args) == 5 else rt.render_train_rays_bwd_rec_plain
    return fn(*args, st, cemb, res, cots, slab_rays=slab)


def plain_rec(args, st, cemb, res, cots):
    fn = rt.render_train_bwd_plain if len(args) == 5 else rt.render_train_rays_bwd_plain
    return fn(*args, st, cemb, res, cots)


def assert_rec_route_close(got, want, args, st, cemb, res, cots):
    """Data cotangents within ROUTE_TOL of each leaf's max; weight gradients
    too, biases within ROUTE_TOL of the sum of |terms| of their largest
    column (test_torch_bwd_dw.py's measure); None where want has None."""
    n_data = len(got) - 2
    for i in range(n_data):
        if want[i] is None:
            assert got[i] is None, i
        else:
            tk.assert_leaf_close(got[i].numpy(), want[i].numpy(), ROUTE_TOL, f"data cotangent {i}")
    if want[-1] is None:
        assert got[-2] is None and got[-1] is None
        return
    x0, z, cond, trunk, heads = args if len(args) == 5 else (rt._pe(*args[:4], st.xyz_L)[0], args[2], *args[4:])
    scales = bd.bias_scales(x0, z, cond, trunk, heads, st, cemb, res, cots)
    for i, ((gw, gb), (ww, wb)) in enumerate(zip(got[-2], want[-2])):
        tk.assert_leaf_close(gw.numpy(), ww.numpy(), ROUTE_TOL, f"trunk{i}.w")
        scale = scales[f"trunk{i}_b"]
        np.testing.assert_allclose(gb.numpy() / scale, wb.numpy() / scale, rtol=0, atol=ROUTE_TOL,
                                   err_msg=f"trunk{i}.b")
    assert set(got[-1]) == set(st.head_keys)
    for k in st.head_keys:
        g, w = got[-1][k].reshape(want[-1][k].shape).numpy(), want[-1][k].numpy()
        if k in scales:
            np.testing.assert_allclose(g / scales[k], w / scales[k], rtol=0, atol=ROUTE_TOL, err_msg=k)
        else:
            tk.assert_leaf_close(g, w, ROUTE_TOL, k)


@pytest.mark.parametrize("F", FEATS)
@pytest.mark.parametrize("frontend", ["rays", "x0"])
@pytest.mark.parametrize("param_grads", [True, False], ids=["train", "frozen"])
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("combo", COMBOS, ids=IDS)
def test_rec_route_matches_plain_recompute(combo, precision, param_grads, frontend, F):
    """The route in slabs of 3 rays (R = 8: a ragged last slab of 2) against
    the plain recompute backward, which rebuilds the whole chain at once."""
    st, _, _, args, cemb, res, cots = rec_route_case(combo, precision, param_grads, F, frontend, seed=31)
    got = rec_route(args, st, cemb, res, cots, 3)
    assert_rec_route_close(got, plain_rec(args, st, cemb, res, cots), args, st, cemb, res, cots)


@pytest.mark.parametrize("slab", [1, 2, 3])
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_rec_route_slabs_match_one_slab(precision, slab):
    """Phase 1 at F = 384: slabs of 1, 2 and 3 rays against one slab of all 8."""
    st, _, _, args, cemb, res, cots = rec_route_case(COMBOS[0], precision, True, 384, "rays", seed=33)
    one = rec_route(args, st, cemb, res, cots, None)
    assert_rec_route_close(rec_route(args, st, cemb, res, cots, slab), one, args, st, cemb, res, cots)


@pytest.mark.parametrize("combo,precision", [(c, "float32") for c in COMBOS] + [(COMBOS[0], "bfloat16"),
                                                                                (COMBOS[2], "bfloat16")],
                         ids=[f"{i}-float32" for i in IDS] + ["phase1-bfloat16", "phase2-bfloat16"])
@pytest.mark.parametrize("param_grads", [True, False], ids=["train", "frozen"])
def test_rec_route_matches_pallas_vjp(combo, precision, param_grads, monkeypatch):
    """The route in slabs of 5 rays against jax.vjp of the Pallas kernel with
    save_chain=False in the interpreter, at
    test_plain_recompute_backward_matches_pallas_vjp's tolerances (1e-4 of
    each leaf's max in f32, 1e-3 in bf16)."""
    monkeypatch.setattr(jrt, "INTERPRET", True)
    st, jst, inputs, args, cemb, res, cots = rec_route_case(combo, precision, param_grads, tk.F, "rays", seed=35)
    got = rec_route(args, st, cemb, res, cots, 5)
    want = tk.jax_vjp(inputs, jst, {k: v.numpy() for k, v in cots.items()})
    tol = 1e-4 if precision == "float32" else 1e-3
    if param_grads:
        tk.compare_grads(got, want, st, tol)
    else:
        assert got[4] is None and got[5] is None
        compare_data_cots(got, want, tol)


def test_rec_route_refuses_the_saved_chain():
    st, _, _, args, cemb, res, cots = rec_route_case(COMBOS[0], "float32", True, tk.F, "rays", seed=37)
    with pytest.raises(ValueError, match="save_chain"):
        rec_route(args, st._replace(save_chain=True), cemb, res, cots, 3)
