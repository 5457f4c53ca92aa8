"""CartPole, the discrete specs, the transform core with RewardSum and
``rollout`` of the port against ``rl_tpu``, on the CPU, float32, inputs
from numpy seeds.

CartPole's dynamics are chaotic in float32, and XLA's and torch's
``sin``/``cos`` may differ in the last bit, so nothing here compares a
long free-running trajectory. ``_step`` is held to the reference from the
same state at many random states (physics within rtol 1e-6, atol 1e-6,
several ulp of values of order 1), and a rollout with fed actions is
held step by step, each step re-seeded from the reference's state.
Termination flags must be equal except where |x| or |theta| lies within
1e-5 of its threshold (a last-bit difference may flip the comparison
there). Resets are fed: the port's reset draw is replaced by the
reference's reset physics, so the reset rows compare too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_tpu.data import ArrayDict as JaxArrayDict
from rl_tpu.data import Categorical as JaxCategoricalSpec
from rl_tpu.data import OneHot as JaxOneHot
from rl_tpu.envs import CartPoleEnv as JaxCartPole
from rl_tpu.envs import RewardSum as JaxRewardSum
from rl_tpu.envs import StepCounter as JaxStepCounter
from rl_tpu.envs import TransformedEnv as JaxTransformedEnv
from rl_tpu.envs import VmapEnv as JaxVmapEnv
from rl_tpu.envs import rollout as jax_rollout
from rl_tpu_torch.data import ArrayDict, Binary, Bounded, Categorical, OneHot
from rl_tpu_torch.envs import (CartPoleEnv, Compose, RewardSum, StepCounter, TransformedEnv,
                               VmapEnv, rollout)

torch.set_num_threads(1)
STEP_TOL = dict(rtol=1e-6, atol=1e-6)
EDGE = 1e-5  # a flag may differ only this close to its threshold


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def to_port(jad, drop=("rng",)) -> ArrayDict:
    """A reference ArrayDict as the port's (PRNG keys left out)."""
    out = ArrayDict()
    for path, leaf in jad.items(nested=True, leaves_only=True):
        if path[-1] not in drop:
            out = out.set(path, t(leaf))
    return out


def random_physics(rng, n, near_edge=False):
    """States over the whole episode range; with ``near_edge`` half of
    them sit just inside a termination threshold."""
    p = np.stack([rng.uniform(-2.4, 2.4, n), rng.uniform(-3, 3, n),
                  rng.uniform(-0.2094, 0.2094, n), rng.uniform(-3, 3, n)], -1)
    if near_edge:
        h = n // 2
        p[:h, 0] = np.sign(p[:h, 0]) * rng.uniform(2.35, 2.4, h)
        p[:h, 2] = np.sign(p[:h, 2]) * rng.uniform(0.20, 0.2094, h)
    return p.astype(np.float32)


def flags_agree(port_flag, ref_flag, physics):
    """Equal flags, except where the state is within EDGE of a threshold."""
    x, th = physics[..., 0].abs(), physics[..., 2].abs()
    edge = ((x - CartPoleEnv.x_threshold).abs() < EDGE) | (
        (th - CartPoleEnv.theta_threshold).abs() < EDGE)
    return bool(((port_flag == ref_flag) | edge).all())


def jax_step(physics, count, action, max_steps=500):
    env = JaxCartPole(max_episode_steps=max_steps)

    def one(p, c, a):
        st = JaxArrayDict(physics=p, step_count=c)
        return env._step(st, a, None)

    return jax.vmap(one)(jnp.asarray(physics), jnp.asarray(count), jnp.asarray(action))


# -- CartPole -------------------------------------------------------------------


@pytest.mark.parametrize("near_edge", [False, True])
def test_step_matches_reference_at_random_states(near_edge):
    rng = np.random.default_rng(1 + near_edge)
    n = 4096
    physics = random_physics(rng, n, near_edge)
    count = rng.integers(0, 500, n).astype(np.int32)
    action = rng.integers(0, 2, n).astype(np.int32)
    jstate, jobs, jrew, jterm, jtrunc = jax_step(physics, count, action)
    state, obs, rew, term, trunc = CartPoleEnv()._step(
        ArrayDict(physics=t(physics), step_count=t(count)), t(action))
    torch.testing.assert_close(state["physics"], t(jstate["physics"]), **STEP_TOL)
    torch.testing.assert_close(obs["observation"], state["physics"], rtol=0, atol=0)
    assert state["step_count"].dtype == torch.int32
    assert torch.equal(state["step_count"], t(jstate["step_count"]))
    assert rew.shape == (n,) and rew.dtype == torch.float32 and bool((rew == 1.0).all())
    assert flags_agree(term, t(jterm), state["physics"])
    assert torch.equal(trunc, t(jtrunc))
    if near_edge:  # the edge states do terminate
        assert 0.05 < term.float().mean().item() < 0.95


def test_reset_layout_and_range():
    n = 512
    jstate, jtd = JaxVmapEnv(JaxCartPole(), n).reset(jax.random.key(0))
    gen = torch.Generator().manual_seed(0)
    state, td = VmapEnv(CartPoleEnv(), n).reset(gen)
    ref_state, ref_td = to_port(jstate), to_port(jtd)
    for ours, ref in ((state, ref_state), (td, ref_td)):
        assert sorted(ours.keys(True, True)) == sorted(ref.keys(True, True))
        for k in ref.keys(True, True):
            assert ours[k].shape == ref[k].shape and ours[k].dtype == ref[k].dtype, k
    p = state["physics"]
    assert bool((p.abs() <= 0.05).all()) and p.std().item() > 0.02  # U(-0.05, 0.05)
    assert torch.equal(td["observation"], p) and not td["done"].any()
    assert bool((state["step_count"] == 0).all())


def test_fed_action_rollout_held_step_by_step():
    """150 steps of 16 envs with numpy actions; each step starts from the
    reference's state, so rounding does not compound."""
    rng = np.random.default_rng(3)
    n = 16
    jenv = JaxVmapEnv(JaxCartPole(max_episode_steps=40), n)
    env = VmapEnv(CartPoleEnv(max_episode_steps=40), n)
    jstate, _ = jenv.reset(jax.random.key(3))
    dones = 0
    for _ in range(150):
        action = rng.integers(0, 2, n).astype(np.int32)
        state = to_port(jstate)
        jstate, jfull = jenv.step(jstate, JaxArrayDict(action=jnp.asarray(action)))
        new_state, full = env.step(state, ArrayDict(action=t(action)))
        ref = to_port(jfull)
        torch.testing.assert_close(full["next", "observation"], ref["next", "observation"],
                                   **STEP_TOL)
        phys = full["next", "observation"]
        for flag in ("terminated", "done"):
            assert flags_agree(full["next", flag], ref["next", flag], phys), flag
        assert torch.equal(full["next", "truncated"], ref["next", "truncated"])
        dones += int(ref["next", "done"].sum())
        # continue from the reference, resetting the ended episodes (fed)
        jrs, _ = jenv.reset(jax.random.key(int(rng.integers(1 << 30))))
        done = jfull["next", "done"]
        jstate = jax.tree.map(
            lambda a, b: jnp.where(done.reshape(done.shape + (1,) * (a.ndim - 1)), a, b),
            jrs.exclude("rng"), jstate.exclude("rng")).set("rng", jstate["rng"])
    assert dones > 10  # episodes ended along the way


# -- specs ----------------------------------------------------------------------


def test_cartpole_specs_match_reference():
    env, jenv = CartPoleEnv(), JaxCartPole()
    obs, jobs = env.observation_spec["observation"], jenv.observation_spec["observation"]
    assert isinstance(obs, Bounded) and obs.shape == (4,)
    np.testing.assert_array_equal(np.array(obs.low, np.float32), np.asarray(jobs.low))
    np.testing.assert_array_equal(np.array(obs.high, np.float32), np.asarray(jobs.high))
    assert isinstance(env.action_spec, Categorical) and env.action_spec.n == jenv.action_spec.n
    assert env.action_spec.dtype == torch.int32 and env.action_spec.shape == ()
    assert isinstance(env.done_spec["done"], Binary) and env.reward_spec.shape == ()
    venv = TransformedEnv(VmapEnv(env, 4), RewardSum())
    assert "episode_reward" in venv.observation_spec
    assert venv.reward_spec == env.reward_spec and venv.done_spec.keys() == env.done_spec.keys()


@pytest.mark.parametrize("n,shape", [(2, ()), (5, (3,)), (-1, ())])
def test_categorical_spec_against_reference(n, shape):
    spec, jspec = Categorical(shape=shape, n=n), JaxCategoricalSpec(shape=shape, n=n)
    gen = torch.Generator().manual_seed(n + 7)
    x = spec.rand((1000,), gen)
    assert x.shape == (1000,) + shape and x.dtype == torch.int32
    assert spec.is_in(x) and bool(x.min() >= 0) and bool(x.max() < max(n, 1))
    if n > 1:
        assert set(x.unique().tolist()) == set(range(n))  # every class drawn
    vals = np.array([-3, 0, 1, 7], np.int32).reshape((4,) + (1,) * len(shape))
    vals = np.broadcast_to(vals, (4,) + shape)
    np.testing.assert_array_equal(spec.project(t(vals)).numpy(),
                                  np.asarray(jspec.project(jnp.asarray(vals))))
    assert spec.is_in(t(vals)) == jspec.is_in(jnp.asarray(vals))
    assert not spec.is_in(t(vals).to(torch.int64))  # the dtype is part of the spec


def test_onehot_spec_against_reference():
    spec, jspec = OneHot(n=4), JaxOneHot(n=4)
    assert spec.shape == jspec.shape == (4,)
    x = spec.rand((300,), torch.Generator().manual_seed(0))
    assert x.shape == (300, 4) and spec.is_in(x) and bool((x.sum(-1) == 1).all())
    raw = np.random.default_rng(0).standard_normal((6, 4)).astype(np.float32)
    np.testing.assert_array_equal(spec.project(t(raw)).numpy(),
                                  np.asarray(jspec.project(jnp.asarray(raw))))
    idx = np.array([0, 3, 1], np.int32)
    np.testing.assert_array_equal(spec.encode(t(idx)).numpy(),
                                  np.asarray(jspec.encode(jnp.asarray(idx))))
    assert spec.to_categorical_spec() == Categorical(shape=(), n=4)
    assert not spec.is_in(t(raw))
    with pytest.raises(ValueError):
        OneHot(shape=(3,), n=4)


# -- transforms -----------------------------------------------------------------


class FedCartPole(CartPoleEnv):
    """CartPole whose reset physics are fed (the whole batch's)."""

    fed = None

    def _reset(self, generator, batch_shape):
        state, obs = super()._reset(generator, batch_shape)
        if self.fed is None:
            return state, obs
        return state.set("physics", self.fed), ArrayDict(observation=self.fed)


@pytest.mark.parametrize("transforms", ["reward_sum", "compose_step_counter"])
def test_step_and_reset_with_fed_resets(transforms):
    """``TransformedEnv`` + ``RewardSum`` (alone, or composed with a
    truncating ``StepCounter``) through ``step_and_reset`` from the
    reference's state, the reference's resets fed to the port: the
    transition, the carried observation and the carried state agree; the
    terminal observation stays in "next" and the episode reward restarts
    at 0 where done."""
    n, rng = 64, np.random.default_rng(5)
    if transforms == "reward_sum":
        jt, pt = JaxRewardSum(), RewardSum()
    else:
        jt = [JaxRewardSum(), JaxStepCounter(max_steps=7)]
        pt = Compose(RewardSum(), StepCounter(max_steps=7))
    jenv = JaxTransformedEnv(JaxVmapEnv(JaxCartPole(max_episode_steps=9), n), jt)
    base = FedCartPole(max_episode_steps=9)
    env = TransformedEnv(VmapEnv(base, n), pt)
    jstate, jtd = jenv.reset(jax.random.key(5))
    # start half the envs near a threshold so episodes terminate too
    phys = np.array(jstate["env", "physics"])
    phys[: n // 2] = random_physics(rng, n // 2, near_edge=True)
    jstate = jstate.set(("env", "physics"), jnp.asarray(phys))
    jtd = jtd.set("observation", jnp.asarray(phys))
    ended, gen = 0, torch.Generator().manual_seed(0)
    for _ in range(20):
        action = rng.integers(0, 2, n).astype(np.int32)
        state, td = to_port(jstate), to_port(jtd)
        jstate, jfull, jtd = jenv.step_and_reset(jstate, jtd.set("action", jnp.asarray(action)))
        base.fed = t(jstate["env", "physics"])  # the reference's resets, where done
        new_state, full, carry = env.step_and_reset(state, td.set("action", t(action)), gen)
        ref_full, ref_carry, ref_state = to_port(jfull), to_port(jtd), to_port(jstate)
        done = ref_full["next", "done"]
        for a, b in ((full, ref_full), (carry, ref_carry), (new_state, ref_state)):
            assert sorted(a.keys(True, True)) == sorted(b.keys(True, True))
        phys_next = ref_full["next", "observation"]
        assert flags_agree(full["next", "done"], done, phys_next)
        for k in ref_full.keys(True, True):
            if full[k].is_floating_point():
                torch.testing.assert_close(full[k], ref_full[k], **STEP_TOL)
        if not torch.equal(full["next", "done"], done):
            continue  # a flag flipped at a threshold: the carry legitimately differs
        for a, b in ((carry, ref_carry), (new_state, ref_state)):
            for k in b.keys(True, True):
                torch.testing.assert_close(a[k], b[k], **STEP_TOL, check_dtype=True)
        if done.any():
            ended += int(done.sum())
            er = full["next", "episode_reward"]
            assert bool((carry["episode_reward"][done] == 0).all())
            assert bool((er[done] >= 1).all())  # the return of the ended episode
            # the terminal observation is in "next"; the carry is the reset
            assert torch.equal(carry["observation"][done], base.fed[done])
    assert ended > 0


def test_rollout_layout_without_break():
    n, steps = 8, 12
    jenv = JaxTransformedEnv(JaxVmapEnv(JaxCartPole(max_episode_steps=5), n), JaxRewardSum())
    env = TransformedEnv(VmapEnv(CartPoleEnv(max_episode_steps=5), n), RewardSum())
    ref = to_port(jax_rollout(jenv, jax.random.key(0), max_steps=steps))
    out = rollout(env, torch.Generator().manual_seed(0), max_steps=steps)
    assert out.batch_shape == ref.batch_shape == (steps, n)
    assert sorted(out.keys(True, True)) == sorted(ref.keys(True, True))
    for k in ref.keys(True, True):
        assert out[k].shape == ref[k].shape and out[k].dtype == ref[k].dtype, k
    assert "mask" not in out
    # truncation at 5: every env's episode ends at steps 5 and 10
    assert bool(out["next", "truncated"][4].all()) and bool(out["next", "truncated"][9].all())
    assert torch.equal(out["next", "episode_reward"][4], torch.full((n,), 5.0))
    assert env.rollout(torch.Generator().manual_seed(0), max_steps=steps).keys() == out.keys()


def test_rollout_break_when_any_done_and_policy_state():
    n, steps = 4, 10
    env = VmapEnv(CartPoleEnv(max_episode_steps=3), n)
    jenv = JaxVmapEnv(JaxCartPole(max_episode_steps=3), n)
    seen = []

    def policy(td, generator):
        seen.append(td["exploration", "eps"].clone())
        td = td.set(("exploration", "eps"), td["exploration", "eps"] * 0.5)
        return env.rand_action(td, generator)

    def jpolicy(td, key):
        td = td.set(("exploration", "eps"), td["exploration", "eps"] * 0.5)
        return jenv.rand_action(td, key)

    out = rollout(env, torch.Generator().manual_seed(1), policy, max_steps=steps,
                  break_when_any_done=True,
                  policy_state=ArrayDict(eps=torch.ones(n)))
    ref = to_port(jax_rollout(jenv, jax.random.key(1), jpolicy, max_steps=steps,
                              break_when_any_done=True,
                              policy_state=JaxArrayDict(eps=jnp.ones(n))))
    assert sorted(out.keys(True, True)) == sorted(ref.keys(True, True))
    assert "exploration" not in out and out["mask"].shape == (steps,)
    # the mask holds up to and including the first step on which any env is done
    assert out["mask"].tolist() == ref["mask"].tolist() == [True] * 3 + [False] * 7
    assert [float(s[0]) for s in seen[:3]] == [1.0, 0.5, 0.25]  # the carry is carried
