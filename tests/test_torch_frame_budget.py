"""The collector's frame budget against the JAX package, on the CPU:
``Collector(total_frames=)``, ``frames_collected``, ``done`` and the
batches ``iterate`` yields, with budgets that are and are not a multiple
of ``frames_per_batch``; an exploration state riding beside the budget;
and ``make_dqn_trainer``'s collector counting the random prefill's frames
as the reference's does. Counts are compared exactly (they are host
integers on both sides)."""

import jax
import numpy as np
import pytest
import torch

from rl_tpu.collectors import Collector as JaxCollector
from rl_tpu.envs import CartPoleEnv as JaxCartPole
from rl_tpu.envs import PendulumEnv as JaxPendulum
from rl_tpu.envs import RewardSum as JaxRewardSum
from rl_tpu.envs import TransformedEnv as JaxTransformedEnv
from rl_tpu.envs import VmapEnv as JaxVmapEnv
from rl_tpu.modules import EGreedyModule as JaxEGreedy
from rl_tpu.trainers import OffPolicyConfig as JaxOffPolicyConfig
from rl_tpu.trainers import make_dqn_trainer as jax_make_dqn_trainer
from rl_tpu_torch.collectors import Collector
from rl_tpu_torch.envs import CartPoleEnv, PendulumEnv, RewardSum, TransformedEnv, VmapEnv
from rl_tpu_torch.modules import EGreedyModule
from rl_tpu_torch.trainers import OffPolicyConfig, make_dqn_trainer

torch.set_num_threads(1)

N_ENVS, T = 4, 8
FRAMES = N_ENVS * T


def budget_trace(collector, cstate, collect, limit=10):
    """``(frames_collected, done)`` before each collect until done (at
    most ``limit`` collects), as ``iterate`` steps through them."""
    trace = []
    for _ in range(limit):
        trace.append((collector.frames_collected(cstate), collector.done(cstate)))
        if trace[-1][1]:
            break
        _, cstate = collect(cstate)
    return trace


@pytest.mark.parametrize("total", [FRAMES, 2 * FRAMES, 2 * FRAMES + 5, 1, None],
                         ids=["one_batch", "two_batches", "not_a_multiple", "one_frame", "none"])
def test_frame_budget_matches_reference(total):
    ours = Collector(VmapEnv(PendulumEnv(), N_ENVS), frames_per_batch=FRAMES, total_frames=total)
    ref = JaxCollector(JaxVmapEnv(JaxPendulum(), N_ENVS), frames_per_batch=FRAMES,
                       total_frames=total)
    assert ours.total_frames == ref.total_frames == total
    mine = budget_trace(ours, ours.init(torch.Generator().manual_seed(0)), ours.collect)
    theirs = budget_trace(ref, ref.init(jax.random.key(0)), lambda c: ref.collect(None, c),
                          limit=len(mine))
    assert mine == theirs
    if total is None:
        assert not any(done for _, done in mine)
        return
    batches = list(ours.iterate(torch.Generator().manual_seed(0)))
    assert len(batches) == len(list(ref.iterate(None, jax.random.key(0), jit=False)))
    assert len(batches) == -(-total // FRAMES)
    assert all(b.batch_shape == (T, N_ENVS) for b in batches)


def test_exploration_state_rides_beside_the_budget():
    """A collector with an e-greedy state and a budget (the DQN
    collector's layout): the same count of batches as the reference's, the
    state's step advanced by every frame, and no batch carrying it."""
    env = TransformedEnv(VmapEnv(CartPoleEnv(), N_ENVS), RewardSum())
    eg = EGreedyModule(env.action_spec, 1.0, 0.05, 100)
    ours = Collector(env, lambda td, g: eg(env.rand_action(td, g), g), frames_per_batch=FRAMES,
                     total_frames=3 * FRAMES, policy_state=eg.init_state())
    jenv = JaxTransformedEnv(JaxVmapEnv(JaxCartPole(), N_ENVS), JaxRewardSum())
    jeg = JaxEGreedy(jenv.action_spec, 1.0, 0.05, 100)

    def jpolicy(params, td, key):
        k1, k2 = jax.random.split(key)
        return jeg(jenv.rand_action(td, k1), k2)

    ref = JaxCollector(jenv, jpolicy, frames_per_batch=FRAMES, total_frames=3 * FRAMES,
                       policy_state=jeg.init_state())
    cstate = ours.init(torch.Generator().manual_seed(1))
    batches = []
    while not ours.done(cstate):
        batch, cstate = ours.collect(cstate)
        batches.append(batch)
    jstate, n_ref = ref.init(jax.random.key(1)), 0
    while not ref.done(jstate):
        _, jstate = ref.collect(None, jstate)
        n_ref += 1
    assert len(batches) == n_ref == 3
    assert ours.frames_collected(cstate) == ref.frames_collected(jstate) == 3 * FRAMES
    assert all("exploration" not in b for b in batches)
    np.testing.assert_array_equal(np.asarray(cstate["carry"]["exploration"]["eg_step"]),
                                  np.asarray(jstate["carry"]["exploration"]["eg_step"]))


def test_dqn_trainer_counts_the_prefill_and_the_steps_as_the_reference():
    kw = dict(total_steps=2, frames_per_batch=FRAMES, buffer_capacity=512)
    ours = make_dqn_trainer(TransformedEnv(VmapEnv(CartPoleEnv(), N_ENVS), RewardSum()),
                            config=OffPolicyConfig(batch_size=16, init_random_frames=70),
                            device="cpu", **kw)
    ref = jax_make_dqn_trainer(
        JaxTransformedEnv(JaxVmapEnv(JaxCartPole(), N_ENVS), JaxRewardSum()),
        config=JaxOffPolicyConfig(batch_size=16, init_random_frames=70), **kw)
    jts = ref.program.prefill(ref.program.init(jax.random.key(0)))
    pts = ours.program.prefill(ours.program.init(0))
    coll = ours.program.collector
    assert coll.frames_collected(pts["collector"]) == ref.program.collector.frames_collected(
        jts["collector"]) == 3 * FRAMES  # 70 random frames, rounded up to whole batches
    ts = ours.train(ts=pts)
    assert coll.frames_collected(ts["collector"]) == 5 * FRAMES
    assert not coll.done(ts["collector"])  # no budget: the trainer's total_steps stops it
