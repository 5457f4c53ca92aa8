"""The port's value math (``rl_tpu_torch.ops.value``) and estimators
(``rl_tpu_torch.objectives.value``) against ``rl_tpu``, on the CPU,
float32, inputs from numpy seeds (T = 32 steps of 64 envs, as the PPO
path's T; dones at ~6%, half of them terminations).

Tolerance. The reference solves each recurrence with
``lax.associative_scan``, the port with a log-depth Hillis-Steele scan:
both sum the same terms in different orders, so they differ by the
rounding of the largest partial sums, not of each output. Measured: at
most 1.5e-7 of the output's largest magnitude (GAE at gamma * lambda =
0.9405: 2.3e-5 on values up to 149). Each output is held to the
reference within ``1e-6 * max|reference|`` absolute plus rtol 1e-6, and
to a float64 loop within the same bound. The estimators run a ported
critic (MLP 32x32, weights carried from flax): values within rtol 1e-5,
atol 1e-5 (products summed in another order), the estimates within the
recurrence bound on top.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_tpu.data import ArrayDict as JaxArrayDict
from rl_tpu.modules import MLP as JaxMLP
from rl_tpu.modules import Categorical as JaxCategorical
from rl_tpu.modules import ProbabilisticActor as JaxActor
from rl_tpu.modules import TDModule as JaxTDModule
from rl_tpu.modules import ValueOperator as JaxValueOperator
from rl_tpu.objectives import ClipPPOLoss as JaxClipPPOLoss
from rl_tpu.objectives import value as JV
from rl_tpu.ops import value as J
from rl_tpu_torch.data import ArrayDict
from rl_tpu_torch.modules import (MLP, Categorical, ProbabilisticActor, TDModule, ValueOperator,
                                  params_from_flax)
from rl_tpu_torch.objectives import ClipPPOLoss, ValueEstimators, make_value_estimator
from rl_tpu_torch.objectives import value as PV
from rl_tpu_torch.ops import value as P

torch.set_num_threads(1)
T, N = 32, 64
GAMMA, LMBDA = 0.99, 0.95
SCALE_TOL = 1e-6  # of max|reference|
RTOL = 1e-6


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def inputs(seed=0, trailing=()):
    rng = np.random.default_rng(seed)
    shape = (T, N) + trailing
    done = rng.random(shape) < 0.06
    return dict(
        reward=rng.standard_normal(shape).astype(np.float32),
        value=(rng.standard_normal(shape) * 10).astype(np.float32),
        next_value=(rng.standard_normal(shape) * 10).astype(np.float32),
        done=done, terminated=done & (rng.random(shape) < 0.5),
        log_rhos=(rng.standard_normal(shape) * 0.3).astype(np.float32),
        a=(0.95 * rng.random(shape)).astype(np.float32))


def assert_scaled_close(port, ref, what):
    ref = torch.as_tensor(np.array(ref))
    atol = SCALE_TOL * ref.abs().max().item()
    torch.testing.assert_close(port, ref, rtol=RTOL, atol=atol, msg=lambda m: f"{what}: {m}")


def _both(name, x):
    """(reference outputs, port outputs) of function ``name`` on ``x``."""
    g, lam = GAMMA, LMBDA
    d, tm, r, v, nv, lr, a = (x[k] for k in ("done", "terminated", "reward", "value",
                                             "next_value", "log_rhos", "a"))
    calls = {
        "linear_recurrence_reverse": ((a, r), {}),
        "linear_recurrence_forward": ((a, r), {}),
        "generalized_advantage_estimate": ((g, lam, v, nv, r, d, tm), {}),
        "td0_return_estimate": ((g, nv, r, tm), {}),
        "td0_advantage_estimate": ((g, v, nv, r, tm), {}),
        "td1_return_estimate": ((g, nv, r, d, tm), {}),
        "td_lambda_return_estimate": ((g, lam, nv, r, d, tm), {}),
        "vtrace_advantage_estimate": ((g, lr, v, nv, r, d, tm),
                                      dict(rho_clip=1.0, c_clip=0.9)),
        "reward2go": ((r, d), dict(gamma=g)),
    }
    args, kw = calls[name]
    fn = name
    ref = getattr(J, fn)(*[jnp.asarray(z) if isinstance(z, np.ndarray) else z for z in args],
                         **kw)
    port = getattr(P, fn)(*[t(z) if isinstance(z, np.ndarray) else z for z in args], **kw)
    if not isinstance(ref, tuple):
        ref, port = (ref,), (port,)
    return ref, port


FUNCTIONS = ["linear_recurrence_reverse", "linear_recurrence_forward",
             "generalized_advantage_estimate",
             "td0_return_estimate", "td0_advantage_estimate", "td1_return_estimate",
             "td_lambda_return_estimate", "vtrace_advantage_estimate", "reward2go"]


@pytest.mark.parametrize("name", FUNCTIONS)
def test_function_matches_reference(name):
    x = inputs(seed=FUNCTIONS.index(name))
    ref, port = _both(name, x)
    assert len(ref) == len(port)
    for i, (a, b) in enumerate(zip(port, ref)):
        assert a.dtype == torch.float32 and tuple(a.shape) == tuple(b.shape)
        assert_scaled_close(a, b, f"{name}[{i}]")


def _loop_reverse(a, b):
    y, out = np.zeros(b.shape[1:]), np.zeros(b.shape)
    for s in range(b.shape[0] - 1, -1, -1):
        y = b[s] + a[s] * y
        out[s] = y
    return out


def test_scan_against_float64_loop():
    """The scan at T = 32, T = 1 and T = 33 (not a power of two), with and
    without trailing feature dims, against a float64 step-by-step loop."""
    for trailing, T_ in [((), 32), ((3,), 32), ((), 1), ((), 33)]:
        rng = np.random.default_rng(T_)
        shape = (T_, 8) + trailing
        a = (0.99 * 0.95 * (rng.random(shape) > 0.05)).astype(np.float32)
        b = (rng.standard_normal(shape) * 5).astype(np.float32)
        exact = _loop_reverse(a.astype(np.float64), b.astype(np.float64))
        assert_scaled_close(P.linear_recurrence_reverse(t(a), t(b)).double(), exact,
                            f"reverse {shape}")
        exact_fwd = _loop_reverse(a[::-1].astype(np.float64), b[::-1].astype(np.float64))[::-1]
        assert_scaled_close(P.linear_recurrence_forward(t(a), t(b)).double(), exact_fwd,
                            f"forward {shape}")


def test_window_end_bootstraps_and_cuts():
    """TD(1) and TD(lambda) bootstrap V' at the window's last step and at
    a truncation; a termination gives no bootstrap; GAE's trace stops at
    a done, and without ``terminated`` every done is a termination."""
    r = np.ones((4, 1), np.float32)
    nv = np.full((4, 1), 10.0, np.float32)
    done = np.array([[False], [True], [False], [False]])
    term = np.array([[False], [False], [False], [False]])
    g = 0.5
    td1 = P.td1_return_estimate(g, t(nv), t(r), t(done), t(term))[:, 0].tolist()
    # step 3: 1 + 0.5 * 10; step 1 (truncated): 1 + 0.5 * 10; step 0: 1 + 0.5 * G_1
    assert td1 == [1 + g * 6.0, 6.0, 1 + g * 6.0, 6.0]
    term[1] = True
    td1 = P.td1_return_estimate(g, t(nv), t(r), t(done), t(term))[:, 0].tolist()
    assert td1[1] == 1.0 and td1[0] == 1.0 + g * 1.0
    adv, _ = P.generalized_advantage_estimate(g, 1.0, t(np.zeros_like(r)), t(nv), t(r),
                                              t(done), t(term))
    assert adv[1, 0].item() == 1.0  # terminated: no bootstrap, and the trace stops
    ref = J.td_lambda_return_estimate(g, 0.9, jnp.asarray(nv), jnp.asarray(r),
                                      jnp.asarray(done), jnp.asarray(term))
    assert_scaled_close(P.td_lambda_return_estimate(g, 0.9, t(nv), t(r), t(done), t(term)),
                        ref, "td_lambda")
    x = inputs(seed=11)
    ref = J.generalized_advantage_estimate(g, 0.9, *(jnp.asarray(x[k]) for k in (
        "value", "next_value", "reward", "done")))
    port = P.generalized_advantage_estimate(g, 0.9, *(t(x[k]) for k in (
        "value", "next_value", "reward", "done")))
    for a, b in zip(port, ref):
        assert_scaled_close(a, b, "gae without terminated")


# -- estimators -------------------------------------------------------------------


CELLS = (32, 32)


def both_losses(seed=0):
    """The reference's ClipPPOLoss with ``init_params`` and the port's with
    the same weights carried across (``params_from_flax``)."""
    jactor = JaxActor(JaxTDModule(JaxMLP(out_features=2, num_cells=CELLS), ["observation"],
                                  ["logits"]), JaxCategorical, dist_keys=("logits",))
    jloss = JaxClipPPOLoss(jactor, JaxValueOperator(JaxMLP(out_features=1, num_cells=CELLS)))
    actor = ProbabilisticActor(TDModule(MLP(out_features=2, num_cells=CELLS), ["observation"],
                                        ["logits"]), Categorical, dist_keys=("logits",))
    loss = ClipPPOLoss(actor, ValueOperator(MLP(out_features=1, num_cells=CELLS)))
    obs = np.random.default_rng(seed).uniform(-1, 1, (4, 4)).astype(np.float32)
    params = jloss.init_params(jax.random.key(seed), JaxArrayDict(observation=jnp.asarray(obs)))
    loss.init_params(ArrayDict(observation=t(obs)))
    params_from_flax(loss, jax.tree.map(np.asarray, params))
    return jloss, params, loss


def rollout_batch(seed, T_=16, N_=8):
    rng = np.random.default_rng(seed)
    done = rng.random((T_, N_)) < 0.1
    nxt = dict(observation=rng.uniform(-0.3, 0.3, (T_, N_, 4)).astype(np.float32),
               reward=np.ones((T_, N_), np.float32), done=done,
               terminated=done & (rng.random((T_, N_)) < 0.5))
    return dict(observation=rng.uniform(-0.3, 0.3, (T_, N_, 4)).astype(np.float32),
                action=rng.integers(0, 2, (T_, N_)).astype(np.int32),
                sample_log_prob=np.log(rng.uniform(0.3, 0.7, (T_, N_))).astype(np.float32),
                next=nxt)


def as_jax(d):
    return JaxArrayDict({k: as_jax(v) if isinstance(v, dict) else jnp.asarray(v)
                         for k, v in d.items()})


def as_port(d):
    return ArrayDict({k: as_port(v) if isinstance(v, dict) else t(v) for k, v in d.items()})


ESTIMATORS = {
    "gae": (dict(gamma=GAMMA, lmbda=LMBDA), ValueEstimators.GAE),
    "gae_average": (dict(gamma=GAMMA, lmbda=LMBDA, average_gae=True), ValueEstimators.GAE),
    "td0": (dict(gamma=GAMMA), ValueEstimators.TD0),
    "td1": (dict(gamma=GAMMA), ValueEstimators.TD1),
    "td_lambda": (dict(gamma=GAMMA, lmbda=LMBDA), ValueEstimators.TDLambda),
    "vtrace": (dict(gamma=GAMMA, rho_clip=1.0, c_clip=1.0), ValueEstimators.VTrace),
}


@pytest.mark.parametrize("name", sorted(ESTIMATORS))
def test_estimator_on_a_batch_with_ported_critic(name):
    kw, kind = ESTIMATORS[name]
    jloss, params, loss = both_losses(seed=1)
    raw = rollout_batch(seed=2)
    jkind = JV.ValueEstimators(kind.value)
    if kind == ValueEstimators.VTrace:
        jest = JV.make_value_estimator(jkind, lambda p, td: jloss.critic(p, td),
                                       actor_log_prob=jloss.actor.log_prob, **kw)
        ref = jest(params["critic"], as_jax(raw), actor_params=params["actor"])
        est = make_value_estimator(kind, loss.critic, actor_log_prob=loss.actor.log_prob, **kw)
    else:
        jest = JV.make_value_estimator(jkind, lambda p, td: jloss.critic(p, td), **kw)
        ref = jest(params["critic"], as_jax(raw))
        est = make_value_estimator(kind, loss.critic, **kw)
    with torch.enable_grad():
        out = est(as_port(raw))
    torch.testing.assert_close(out["state_value"], t(ref["state_value"]), rtol=1e-5, atol=1e-5)
    for k in ("advantage", "value_target"):
        assert not out[k].requires_grad  # the critic ran under no_grad
        r = t(ref[k])
        torch.testing.assert_close(out[k], r, rtol=1e-5,
                                   atol=1e-5 + SCALE_TOL * r.abs().max().item())


def test_loss_fills_advantage_with_its_estimator():
    """``_ensure_advantage`` computes GAE once, and keeps a given one."""
    _, _, loss = both_losses()
    batch = as_port(rollout_batch(seed=3))
    assert loss.value_estimator is None
    out = loss._ensure_advantage(batch)
    assert isinstance(loss.value_estimator, PV.GAE)
    assert loss.value_estimator.gamma == 0.99 and loss.value_estimator.lmbda == 0.95
    given = batch.set("advantage", torch.zeros(16, 8))
    assert loss._ensure_advantage(given)["advantage"] is given["advantage"]
    assert out["advantage"].shape == (16, 8) and "value_target" in out
