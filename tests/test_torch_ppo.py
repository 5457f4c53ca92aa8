"""The Categorical distribution, ``masked_mean``, ``_masked_ess`` and the
PPO family (``ClipPPOLoss``, ``PPOLoss``, ``KLPENPPOLoss``, ``A2CLoss``,
``ReinforceLoss``) against ``rl_tpu``, on the CPU, float32, the same
flax weights carried into the port (``params_from_flax``) and the same
numpy batch.

Tolerances: distribution values within rtol 1e-6, atol 1e-6 (one
log-softmax); a fed-noise sample equal to ``jax.random.categorical`` on
the same key; each loss and its metrics within rtol 1e-5, atol 1e-6, and
every parameter gradient within rtol 1e-4, atol 1e-6 of
``jax.value_and_grad`` of the reference's loss (MLP products and the
masked means summed in another order).
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
from rl_tpu.objectives import ppo as jppo
from rl_tpu.objectives.common import masked_mean as jax_masked_mean
from rl_tpu_torch.data import ArrayDict
from rl_tpu_torch.envs import ExplorationType, set_exploration_type
from rl_tpu_torch.modules import (MLP, Categorical, ProbabilisticActor, TDModule, ValueOperator,
                                  params_from_flax)
from rl_tpu_torch.modules.weights import flax_paths, to_port_layout
from rl_tpu_torch.objectives import ppo
from rl_tpu_torch.objectives.common import masked_mean

torch.set_num_threads(1)
CELLS = (32, 32)
DIST_TOL = dict(rtol=1e-6, atol=1e-6)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def logits_input(seed=0, shape=(64, 5)):
    return (np.random.default_rng(seed).standard_normal(shape) * 2).astype(np.float32)


# -- Categorical ------------------------------------------------------------------


def test_categorical_values_match_reference():
    x = logits_input()
    d, jd = Categorical(logits=t(x)), JaxCategorical(logits=jnp.asarray(x))
    a = np.random.default_rng(1).integers(0, 5, 64).astype(np.int32)
    torch.testing.assert_close(d.log_prob(t(a)), t(jd.log_prob(jnp.asarray(a))), **DIST_TOL)
    torch.testing.assert_close(d.entropy(), t(jd.entropy()), **DIST_TOL)
    torch.testing.assert_close(d.mean, t(jd.mean), **DIST_TOL)
    torch.testing.assert_close(d.probs, t(jd.probs), **DIST_TOL)
    assert d.mode.dtype == torch.int32 and torch.equal(d.mode, t(jd.mode))
    assert torch.equal(d.deterministic_sample, d.mode)
    # log_prob takes int64 actions too (torch's own index dtype)
    torch.testing.assert_close(d.log_prob(t(a).long()), d.log_prob(t(a)), rtol=0, atol=0)


def test_categorical_sample_with_fed_gumbel_noise_equals_jax_categorical():
    """``jax.random.categorical(key, logits)`` is the argmax of logits plus
    ``jax.random.gumbel(key, logits.shape)``; fed that noise the port
    draws the same classes, and its own draws follow the probabilities."""
    x = logits_input(2, (4096, 3))
    key = jax.random.key(7)
    ref = np.asarray(jax.random.categorical(key, jnp.asarray(x)))
    noise = np.asarray(jax.random.gumbel(key, x.shape, jnp.float32))
    d = Categorical(logits=t(x))
    got = d.sample(None, (), t(noise))
    assert got.dtype == torch.int32 and torch.equal(got, t(ref).to(torch.int32))
    # sample_shape and the generator's own Gumbel draws
    big = Categorical(logits=torch.tensor([0.0, 1.0, 2.0])).sample(
        torch.Generator().manual_seed(0), (20000,))
    freq = torch.bincount(big.long(), minlength=3).float() / 20000
    torch.testing.assert_close(freq, torch.softmax(torch.tensor([0.0, 1.0, 2.0]), 0),
                               rtol=0, atol=0.015)


def test_actor_passes_fed_noise_to_the_distribution():
    jactor, params, actor = both_actors(seed=3)
    obs = np.random.default_rng(3).uniform(-1, 1, (32, 4)).astype(np.float32)
    key = jax.random.key(3)
    ref = jactor(params["actor"], JaxArrayDict(observation=jnp.asarray(obs)), key)
    noise = np.asarray(jax.random.gumbel(key, (32, 2), jnp.float32))
    out = actor(ArrayDict(observation=t(obs)), noise=t(noise))
    assert torch.equal(out["action"], t(ref["action"]))
    torch.testing.assert_close(out["sample_log_prob"], t(ref["sample_log_prob"]), **LOSS_TOL)
    with set_exploration_type(ExplorationType.MODE):
        mode = actor(ArrayDict(observation=t(obs)))["action"]
    assert torch.equal(mode, out["logits"].argmax(-1).to(torch.int32))


# -- losses -------------------------------------------------------------------------


def jax_parts():
    jactor = JaxActor(JaxTDModule(JaxMLP(out_features=2, num_cells=CELLS), ["observation"],
                                  ["logits"]), JaxCategorical, dist_keys=("logits",))
    return jactor, JaxValueOperator(JaxMLP(out_features=1, num_cells=CELLS))


def port_parts():
    actor = ProbabilisticActor(TDModule(MLP(out_features=2, num_cells=CELLS), ["observation"],
                                        ["logits"]), Categorical, dist_keys=("logits",))
    return actor, ValueOperator(MLP(out_features=1, num_cells=CELLS))


def both_losses(name, kw, seed=0):
    jcls, cls = getattr(jppo, name), getattr(ppo, name)
    jloss, loss = jcls(*jax_parts(), **kw), cls(*port_parts(), **kw)
    obs = np.random.default_rng(seed).uniform(-1, 1, (4, 4)).astype(np.float32)
    params = jloss.init_params(jax.random.key(seed), JaxArrayDict(observation=jnp.asarray(obs)))
    loss.init_params(ArrayDict(observation=t(obs)))
    params_from_flax(loss, jax.tree.map(np.asarray, params))
    return jloss, params, loss


def both_actors(seed):
    jloss, params, loss = both_losses("ClipPPOLoss", {}, seed)
    return jloss.actor, params, loss.actor


def minibatch(seed, B=64, time_major=False):
    """A batch as the update sees it: flat rows with advantage and value
    target, or (``time_major``) a [T, N] rollout the loss fills itself."""
    rng = np.random.default_rng(seed)
    shape = (8, 8) if time_major else (B,)
    d = dict(observation=rng.uniform(-1, 1, shape + (4,)).astype(np.float32),
             action=rng.integers(0, 2, shape).astype(np.int32),
             sample_log_prob=np.log(rng.uniform(0.2, 0.8, shape)).astype(np.float32))
    if time_major:
        done = rng.random(shape) < 0.15
        d["next"] = dict(observation=rng.uniform(-1, 1, shape + (4,)).astype(np.float32),
                         reward=np.ones(shape, np.float32), done=done,
                         terminated=done & (rng.random(shape) < 0.5))
    else:
        d.update(advantage=(rng.standard_normal(shape) * 3 + 0.5).astype(np.float32),
                 value_target=(rng.standard_normal(shape) * 2).astype(np.float32),
                 state_value=(rng.standard_normal(shape) * 2).astype(np.float32))
    return d


def as_jax(d):
    return JaxArrayDict({k: as_jax(v) if isinstance(v, dict) else jnp.asarray(v)
                         for k, v in d.items()})


def as_port(d):
    return ArrayDict({k: as_port(v) if isinstance(v, dict) else t(v) for k, v in d.items()})


def assert_loss_and_grads_match(jloss, params, loss, raw, call_kw=None):
    call_kw = call_kw or {}
    jbatch = as_jax(raw)

    def f(p):
        return jloss(p, jbatch, **call_kw)

    (jval, jmetrics), jgrads = jax.value_and_grad(f, has_aux=True)(params)
    val, metrics = loss(as_port(raw), **call_kw)
    names = [n for n, _ in loss.trainable_parameters()]
    grads = torch.autograd.grad(val, [p for _, p in loss.trainable_parameters()])
    torch.testing.assert_close(val.detach(), t(jval), **LOSS_TOL)
    assert sorted(metrics.keys()) == sorted(jmetrics.keys())
    for k in jmetrics.keys():
        assert not metrics[k].requires_grad, k
        torch.testing.assert_close(metrics[k], t(jmetrics[k]), **LOSS_TOL, msg=k)
    paths = flax_paths(loss)
    assert len(names) == 12  # both MLPs: three layers of weight and bias each
    for n, g in zip(names, grads):
        path, transposed = paths[n]
        ref = jgrads
        for k in path:
            ref = ref[k]
        torch.testing.assert_close(g, to_port_layout(np.asarray(ref), transposed), **GRAD_TOL,
                                   msg=lambda m, n=n: f"{n}: {m}")


CLIP_CASES = {
    "default": ({}, {}),
    "normalize_advantage": (dict(normalize_advantage=True), {}),
    "mask": (dict(normalize_advantage=True), {"mask": True}),
    "collected_mask": ({}, {"collected_mask": True}),
    "clip_value_l2": (dict(clip_value=0.3, loss_critic_type="l2", entropy_coeff=0.05), {}),
    "estimator_fills_advantage": (dict(normalize_advantage=True), {"time_major": True}),
}


@pytest.mark.parametrize("case", sorted(CLIP_CASES))
def test_clip_ppo_loss_value_metrics_and_grads(case):
    kw, opts = CLIP_CASES[case]
    jloss, params, loss = both_losses("ClipPPOLoss", kw, seed=1)
    raw = minibatch(seed=2, time_major=opts.get("time_major", False))
    rng = np.random.default_rng(4)
    if opts.get("mask"):
        raw["mask"] = rng.random(64) < 0.7
    if opts.get("collected_mask"):
        raw["collected_mask"] = np.arange(64) < 48  # a padded tail
    if opts.get("time_major"):
        jloss.make_value_estimator(gamma=0.99, lmbda=0.95)
        loss.make_value_estimator(gamma=0.99, lmbda=0.95)
    assert_loss_and_grads_match(jloss, params, loss, raw)


OTHER_LOSSES = {
    "PPOLoss": (dict(normalize_advantage=True), {}),
    "KLPENPPOLoss": (dict(dtarg=0.005), {"beta": 0.7}),
    "A2CLoss": ({}, {}),
    "ReinforceLoss": ({}, {}),
}


@pytest.mark.parametrize("name", sorted(OTHER_LOSSES))
def test_other_losses_value_metrics_and_grads(name):
    kw, call_kw = OTHER_LOSSES[name]
    jloss, params, loss = both_losses(name, kw, seed=5)
    raw = minibatch(seed=6)
    raw["mask"] = np.random.default_rng(6).random(64) < 0.8
    assert_loss_and_grads_match(jloss, params, loss, raw, call_kw)


def test_masked_mean_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 5, 3)).astype(np.float32)
    masks = [None, rng.random((6, 5)) < 0.5, (rng.random((6, 5)) < 0.5).astype(np.float32),
             rng.random((6,)) < 0.5, np.zeros((6, 5), bool)]
    for m in masks:
        ref = jax_masked_mean(jnp.asarray(x), None if m is None else jnp.asarray(m))
        got = masked_mean(t(x), None if m is None else t(m))
        torch.testing.assert_close(got, t(ref), **LOSS_TOL)
    assert masked_mean(t(x), t(np.zeros((6, 5), bool))).item() == 0.0  # no valid element


def test_masked_ess_matches_reference():
    rng = np.random.default_rng(1)
    lw = (rng.standard_normal(128) * 0.4).astype(np.float32)
    for m in (None, rng.random(128) < 0.6, np.zeros(128, bool)):
        ref = jppo._masked_ess(jnp.asarray(lw), None if m is None else jnp.asarray(m))
        got = ppo._masked_ess(t(lw), None if m is None else t(m))
        torch.testing.assert_close(got, t(ref), **LOSS_TOL, equal_nan=True)
    assert ppo._masked_ess(torch.zeros(16), None).item() == pytest.approx(1.0)
