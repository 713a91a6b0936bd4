"""upnerf_torch.train.optim against upnerf.train.optim (optax), every
optimizer kind with every LR schedule.

20 updates from the same seeded gradients (one leaf gets no gradient at
some steps: the port gives it a zero one, as optax sees it), max_steps 12, so
the schedules run past their end:
- the LR of every update: 1e-6 relative (optax computes it in float32);
- the parameters after every update: 1e-6 relative, plus, for adam and
  adamw, 1e-5 of the sum of the LRs so far. The second term is optax's
  rounding: it takes Adam's bias correction 1 - b2^t in float32 from b2 =
  0.999 rounded to float32 (1.3e-5 from the exact value while t << 1000), but
  accumulates nu with 1 - b2 rounded from the exact 0.001, so each of its
  updates is 6.6e-6 of the LR away from the exact one, which torch computes
  in double;
- the checkpointed optimizer and scheduler states resume a run exactly: 10
  updates, a state-dict round trip into fresh objects, 10 more, equal bit
  for bit to 20 uninterrupted ones;
- `learning_rate_at` against optax at every step, and cosine held at
  alpha lr past max_steps (torch's recursive CosineAnnealingLR rises again).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from upnerf.train import optim as joptim
from upnerf_torch.train import optim

KINDS = ("adam", "adamw", "sgd")
SCHEDULES = ("ExponentialLR", "cosine", "CosineAnnealingLR", "constant")
LR, LR_END, MAX_STEPS, N_UPDATES = 5e-2, 5e-3, 12, 20
SHAPES = {"w": (5, 3), "b": (3,), "table": (4, 6)}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def init_params():
    rng = np.random.RandomState(0)
    return {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def grads_at(t: int):
    """Seeded gradients of update t; the table gets none at every third."""
    rng = np.random.RandomState(100 + t)
    g = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    if t % 3 == 2:
        g["table"] = None
    return g


def run_optax(kind, sched):
    opt = joptim.make_optimizer(kind, LR, LR_END, MAX_STEPS, sched)
    params = {k: jnp.asarray(v) for k, v in init_params().items()}
    state = opt.init(params)
    out = []
    for t in range(N_UPDATES):
        g = {k: jnp.zeros(SHAPES[k], jnp.float32) if v is None else jnp.asarray(v) for k, v in grads_at(t).items()}
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
        out.append({k: np.asarray(v) for k, v in params.items()})
    return out


def port_params():
    return {k: torch.nn.Parameter(torch.from_numpy(v)) for k, v in init_params().items()}


def port_update(st, params, t):
    st.zero_grad()
    for k, v in grads_at(t).items():
        if v is not None:
            params[k].grad = torch.from_numpy(v)
    st.step()


@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("kind", KINDS)
def test_updates_and_lr_match_optax(kind, sched):
    want = run_optax(kind, sched)
    jsched = joptim.lr_schedule(LR, LR_END, MAX_STEPS, sched)
    params = port_params()
    st = optim.make_optimizer(kind, LR, LR_END, MAX_STEPS, sched).init(params.values())
    lr_sum = 0.0
    for t in range(N_UPDATES):
        want_lr = float(jsched(t)) if callable(jsched) else float(jsched)
        assert st.optimizer.param_groups[0]["lr"] == pytest.approx(want_lr, rel=1e-6), t
        assert optim.learning_rate_at(t, LR, LR_END, MAX_STEPS, sched) == pytest.approx(want_lr, rel=1e-6), t
        lr_sum += want_lr
        port_update(st, params, t)
        for k, p in params.items():
            atol = 1e-7 + (1e-5 * lr_sum if kind != "sgd" else 0.0)
            np.testing.assert_allclose(p.detach().numpy(), want[t][k], rtol=1e-6, atol=atol, err_msg=f"{k} at {t}")


@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("kind", KINDS)
def test_state_dict_round_trip_resumes_exactly(kind, sched):
    spec = optim.make_optimizer(kind, LR, LR_END, MAX_STEPS, sched)
    whole = port_params()
    st = spec.init(whole.values())
    for t in range(N_UPDATES):
        port_update(st, whole, t)

    first = port_params()
    st = spec.init(first.values())
    for t in range(N_UPDATES // 2):
        port_update(st, first, t)
    saved = (st.optimizer.state_dict(), st.scheduler.state_dict())
    resumed = {k: torch.nn.Parameter(p.detach().clone()) for k, p in first.items()}
    st = spec.init(resumed.values())
    st.optimizer.load_state_dict(saved[0])
    st.scheduler.load_state_dict(saved[1])
    for t in range(N_UPDATES // 2, N_UPDATES):
        assert st.optimizer.param_groups[0]["lr"] == optim.learning_rate_at(t, LR, LR_END, MAX_STEPS, sched)
        port_update(st, resumed, t)
    for k in whole:
        assert torch.equal(resumed[k], whole[k]), k


@pytest.mark.parametrize("name", [None, "", "constant", "none", "None"])
def test_constant_schedule_names(name):
    st = optim.make_optimizer("sgd", LR, None, MAX_STEPS, name).init([torch.nn.Parameter(torch.zeros(2))])
    for _ in range(3):
        assert st.scheduler.get_last_lr() == [LR]
        st.step()


def test_cosine_holds_past_max_steps():
    alpha = 1e-8 / LR
    want = optax.cosine_decay_schedule(LR, MAX_STEPS, alpha)
    for t in (MAX_STEPS - 1, MAX_STEPS, MAX_STEPS + 1, 5 * MAX_STEPS):
        got = optim.learning_rate_at(t, LR, None, MAX_STEPS, "cosine")
        assert got == pytest.approx(float(want(t)), rel=1e-6)
    assert optim.learning_rate_at(5 * MAX_STEPS, LR, None, MAX_STEPS, "cosine") == pytest.approx(1e-8, rel=1e-9)


def test_seek_puts_the_schedule_at_a_step():
    st = optim.make_optimizer("adam", LR, LR_END, MAX_STEPS, "ExponentialLR").init([torch.nn.Parameter(torch.zeros(2))])
    st.seek(7)
    assert st.optimizer.param_groups[0]["lr"] == optim.learning_rate_at(7, LR, LR_END, MAX_STEPS)
    st.step()
    assert st.scheduler.get_last_lr()[0] == pytest.approx(optim.learning_rate_at(8, LR, LR_END, MAX_STEPS), rel=1e-12)


def test_unknown_kinds_raise():
    with pytest.raises(ValueError):
        optim.make_optimizer("rmsprop", LR, LR_END, MAX_STEPS)
    with pytest.raises(ValueError):
        optim.make_optimizer("adam", LR, LR_END, MAX_STEPS, "StepLR")
