"""Per-algorithm trainer factories (counterpart of
:mod:`rl_tpu.trainers.algorithms`; ``make_ppo_trainer``,
``make_a2c_trainer``, ``make_dqn_trainer``, ``make_sac_trainer``,
``make_td3_trainer``, ``make_ddpg_trainer``, ``make_redq_trainer``,
``make_crossq_trainer`` and the two ``default_*_actor`` factories are
ported).

Each factory assembles the collector, the loss, the program and a
:class:`Trainer` with the standard hooks from plain arguments. The
collector's policy is the actor module itself (its parameters live in
it). ``device`` (default: the card; no card raises) is the trainer's:
the generator, and so the envs and the parameters, live there.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .._stubs import not_ported
from ..collectors.single import Collector
from ..data import DeviceStorage, MultiStep, PrioritizedSampler, RandomSampler, ReplayBuffer
from ..data.arraydict import ArrayDict
from ..data.specs import Categorical as CategoricalSpec
from ..envs.base import EnvBase
from ..modules import (MLP, AdditiveGaussianModule, Categorical, ConcatMLP, EGreedyModule,
                       NormalParamExtractor, ProbabilisticActor, TanhNormal, TanhPolicy,
                       TDModule, TDSequential, ValueOperator)
from ..objectives.crossq import CrossQLoss
from ..objectives.ddpg import DDPGLoss, TD3Loss
from ..objectives.dqn import DQNLoss
from ..objectives.ppo import A2CLoss, ClipPPOLoss
from ..objectives.redq import REDQLoss
from ..objectives.sac import SACLoss
from ..record.loggers import Logger
from .off_policy import OffPolicyConfig, OffPolicyProgram
from .on_policy import OnPolicyConfig, OnPolicyProgram
from .trainer import CountFramesLog, LogScalar, Trainer

__all__ = ["make_ppo_trainer", "make_a2c_trainer", "make_dqn_trainer", "make_sac_trainer",
           "make_td3_trainer", "make_ddpg_trainer", "make_redq_trainer", "make_crossq_trainer",
           "default_continuous_actor", "default_discrete_actor"]


def _action_dims(env: EnvBase) -> int:
    spec = env.action_spec
    return math.prod(spec.shape) if spec.shape else 1


def default_continuous_actor(env: EnvBase, num_cells=(256, 256)) -> ProbabilisticActor:
    """MLP -> (loc, scale) -> TanhNormal over the action spec's bounds."""
    act_dim = _action_dims(env)
    spec = env.action_spec
    net = TDSequential(
        TDModule(MLP(out_features=2 * act_dim, num_cells=num_cells), ["observation"], ["raw"]),
        TDModule(NormalParamExtractor(), ["raw"], ["loc", "scale"]))
    low = min(getattr(spec, "low", (-1.0,)))
    high = max(getattr(spec, "high", (1.0,)))
    return ProbabilisticActor(net, TanhNormal, dist_kwargs={"low": low, "high": high})


def default_discrete_actor(env: EnvBase, num_cells=(256, 256)) -> ProbabilisticActor:
    """MLP -> logits -> Categorical over the action spec's ``n``."""
    return ProbabilisticActor(
        TDModule(MLP(out_features=env.action_spec.n, num_cells=num_cells), ["observation"],
                 ["logits"]),
        Categorical, dist_keys=("logits",))


def _std_hooks(trainer: Trainer, log_interval: int) -> Trainer:
    trainer.register_op("post_step", LogScalar(interval=log_interval))
    trainer.register_op("post_step", CountFramesLog(interval=log_interval))
    return trainer


def _default_actor(env: EnvBase) -> ProbabilisticActor:
    if isinstance(env.action_spec, CategoricalSpec):
        return default_discrete_actor(env)
    return default_continuous_actor(env)


def make_ppo_trainer(env: EnvBase, total_steps: int, actor: ProbabilisticActor | None = None,
                     critic: ValueOperator | None = None, frames_per_batch: int = 2048,
                     config: OnPolicyConfig | None = None, gamma: float = 0.99,
                     lmbda: float = 0.95, logger: Logger | None = None, log_interval: int = 10,
                     device=None, **loss_kwargs) -> Trainer:
    """PPO (clipped, advantages normalised) on any batched env: 256x256
    actor and critic by default, minibatch ``min(256, frames_per_batch)``."""
    actor = actor or _default_actor(env)
    critic = critic or ValueOperator(MLP(out_features=1, num_cells=(256, 256)))
    loss = ClipPPOLoss(actor, critic, normalize_advantage=True, **loss_kwargs)
    loss.make_value_estimator(gamma=gamma, lmbda=lmbda)
    coll = Collector(env, actor, frames_per_batch=frames_per_batch)
    if config is None:
        config = OnPolicyConfig(minibatch_size=min(256, frames_per_batch))
    program = OnPolicyProgram(coll, loss, config)
    return _std_hooks(Trainer(program, total_steps, logger=logger, device=device), log_interval)


def make_a2c_trainer(env: EnvBase, total_steps: int, frames_per_batch: int = 1024,
                     gamma: float = 0.99, lmbda: float = 0.95, learning_rate: float = 7e-4,
                     logger: Logger | None = None, log_interval: int = 10, device=None,
                     **loss_kwargs) -> Trainer:
    """A2C: one epoch, the whole batch as one update."""
    actor = _default_actor(env)
    critic = ValueOperator(MLP(out_features=1, num_cells=(256, 256)))
    loss = A2CLoss(actor, critic, **loss_kwargs)
    loss.make_value_estimator(gamma=gamma, lmbda=lmbda)
    coll = Collector(env, actor, frames_per_batch=frames_per_batch)
    program = OnPolicyProgram(coll, loss, OnPolicyConfig(
        num_epochs=1, minibatch_size=frames_per_batch, learning_rate=learning_rate))
    return _std_hooks(Trainer(program, total_steps, logger=logger, device=device), log_interval)


class _EGreedyQPolicy(nn.Module):
    """The collector's DQN policy: q-net, argmax (in the action spec's
    dtype), then epsilon-greedy (the reference's ``policy(params, td,
    key)``)."""

    def __init__(self, qnet: TDModule, egreedy: EGreedyModule):
        super().__init__()
        self.qnet = qnet
        self.egreedy = egreedy

    def forward(self, td: ArrayDict, generator: torch.Generator | None = None) -> ArrayDict:
        q = self.qnet(td)["action_value"]
        td = td.set("action", torch.argmax(q, dim=-1).to(self.egreedy.spec.dtype))
        return self.egreedy(td, generator)


def make_dqn_trainer(env: EnvBase, total_steps: int, qnet: TDModule | None = None,
                     buffer_capacity: int = 1_000_000, frames_per_batch: int = 512,
                     config: OffPolicyConfig | None = None, prioritized: bool = True,
                     n_step: int | None = 3, gamma: float = 0.99, eps_init: float = 1.0,
                     eps_end: float = 0.05, annealing_num_steps: int = 100_000,
                     logger: Logger | None = None, log_interval: int = 10, device=None,
                     **loss_kwargs) -> Trainer:
    """Double DQN with n-step returns and device PER: a 256x256 q-net,
    ``MultiStep(gamma, n_step)``, epsilon-greedy from ``eps_init`` to
    ``eps_end`` over ``annealing_num_steps`` env steps, a
    ``DeviceStorage(buffer_capacity)`` ring sampled by
    ``PrioritizedSampler()`` with ``"td_error"`` written back (uniform
    without ``prioritized``), ``OffPolicyConfig(init_random_frames=2000,
    tau=0.01)`` by default."""
    qnet = qnet or TDModule(MLP(out_features=env.action_spec.n, num_cells=(256, 256)),
                            ["observation"], ["action_value"])
    loss = DQNLoss(qnet, gamma=gamma, **loss_kwargs)
    eg = EGreedyModule(env.action_spec, eps_init, eps_end, annealing_num_steps)
    coll = Collector(env, _EGreedyQPolicy(qnet, eg), frames_per_batch=frames_per_batch,
                     postproc=MultiStep(gamma=gamma, n_steps=n_step) if n_step else None,
                     policy_state=eg.init_state())
    buffer = ReplayBuffer(DeviceStorage(buffer_capacity),
                          PrioritizedSampler() if prioritized else RandomSampler())
    program = OffPolicyProgram(coll, loss, buffer,
                               config or OffPolicyConfig(init_random_frames=2000, tau=0.01),
                               priority_key="td_error" if prioritized else None, device=device)
    return _std_hooks(Trainer(program, total_steps, logger=logger, device=device), log_interval)


def make_sac_trainer(env: EnvBase, total_steps: int, actor: ProbabilisticActor | None = None,
                     buffer_capacity: int = 1_000_000, frames_per_batch: int = 1024,
                     config: OffPolicyConfig | None = None, prioritized: bool = False,
                     n_step: int | None = None, gamma: float = 0.99,
                     logger: Logger | None = None, log_interval: int = 10, device=None,
                     **loss_kwargs) -> Trainer:
    """SAC with device replay: the default continuous actor (256x256), a
    256x256 ``ConcatMLP`` critic ensemble, an optional
    ``MultiStep(gamma, n_step)``, a ``DeviceStorage(buffer_capacity)`` ring
    sampled uniformly or, with ``prioritized``, by ``PrioritizedSampler()``
    with ``"td_error"`` written back; ``OffPolicyConfig(init_random_frames=
    5000)`` by default."""
    actor = actor or default_continuous_actor(env)
    loss = SACLoss(actor, ConcatMLP(out_features=1, num_cells=(256, 256)), gamma=gamma,
                   **loss_kwargs)
    coll = Collector(env, actor, frames_per_batch=frames_per_batch,
                     postproc=MultiStep(gamma=gamma, n_steps=n_step) if n_step else None)
    buffer = ReplayBuffer(DeviceStorage(buffer_capacity),
                          PrioritizedSampler() if prioritized else RandomSampler())
    program = OffPolicyProgram(coll, loss, buffer,
                               config or OffPolicyConfig(init_random_frames=5000),
                               priority_key="td_error" if prioritized else None, device=device)
    return _std_hooks(Trainer(program, total_steps, logger=logger, device=device), log_interval)


class _NoisyActor(nn.Module):
    """The collector's DDPG/TD3 policy: the deterministic actor, then the
    exploration noise (the reference's ``policy(params, td, key)``)."""

    def __init__(self, actor: TDModule, noise: AdditiveGaussianModule):
        super().__init__()
        self.actor = actor
        self.noise = noise

    def forward(self, td: ArrayDict, generator: torch.Generator | None = None) -> ArrayDict:
        return self.noise(self.actor(td), generator)


def _tanh_actor(env: EnvBase) -> tuple[TDModule, float, float]:
    """A 256x256 ``TanhPolicy`` over the action spec's widest bounds."""
    spec = env.action_spec
    low, high = float(min(spec.low)), float(max(spec.high))
    actor = TDModule(TanhPolicy(action_dim=_action_dims(env), low=low, high=high),
                     ["observation"], ["action"])
    return actor, low, high


def _deterministic_program(env, actor, loss, buffer_capacity, frames_per_batch,
                           exploration_sigma, config, device) -> OffPolicyProgram:
    """Additive Gaussian exploration of a constant ``exploration_sigma``
    around ``actor``, a uniformly sampled ``DeviceStorage`` ring."""
    noise = AdditiveGaussianModule(env.action_spec, sigma_init=exploration_sigma,
                                   sigma_end=exploration_sigma)
    coll = Collector(env, _NoisyActor(actor, noise), frames_per_batch=frames_per_batch,
                     policy_state=noise.init_state())
    return OffPolicyProgram(coll, loss, ReplayBuffer(DeviceStorage(buffer_capacity)), config,
                            device=device)


def make_td3_trainer(env: EnvBase, total_steps: int, buffer_capacity: int = 1_000_000,
                     frames_per_batch: int = 1024, config: OffPolicyConfig | None = None,
                     gamma: float = 0.99, exploration_sigma: float = 0.1,
                     logger: Logger | None = None, log_interval: int = 10, device=None,
                     **loss_kwargs) -> Trainer:
    """TD3: a 256x256 ``TanhPolicy`` over the action spec's bounds, twin
    256x256 ``ConcatMLP`` critics, additive Gaussian exploration of
    ``exploration_sigma``, a ``DeviceStorage(buffer_capacity)`` ring
    sampled uniformly, ``OffPolicyConfig(init_random_frames=5000,
    policy_delay=2)`` by default."""
    actor, low, high = _tanh_actor(env)
    loss = TD3Loss(actor, ConcatMLP(out_features=1, num_cells=(256, 256)), action_low=low,
                   action_high=high, gamma=gamma, **loss_kwargs)
    program = _deterministic_program(
        env, actor, loss, buffer_capacity, frames_per_batch, exploration_sigma,
        config or OffPolicyConfig(init_random_frames=5000, policy_delay=2), device)
    return _std_hooks(Trainer(program, total_steps, logger=logger, device=device), log_interval)


def make_ddpg_trainer(env: EnvBase, total_steps: int, buffer_capacity: int = 1_000_000,
                      frames_per_batch: int = 1024, config: OffPolicyConfig | None = None,
                      gamma: float = 0.99, exploration_sigma: float = 0.1,
                      logger: Logger | None = None, log_interval: int = 10, device=None,
                      **loss_kwargs) -> Trainer:
    """DDPG: TD3's actor, exploration and buffer with one 256x256
    ``ConcatMLP`` critic, ``OffPolicyConfig(init_random_frames=5000)`` by
    default."""
    actor, _, _ = _tanh_actor(env)
    loss = DDPGLoss(actor, ConcatMLP(out_features=1, num_cells=(256, 256)), gamma=gamma,
                    **loss_kwargs)
    program = _deterministic_program(
        env, actor, loss, buffer_capacity, frames_per_batch, exploration_sigma,
        config or OffPolicyConfig(init_random_frames=5000), device)
    return _std_hooks(Trainer(program, total_steps, logger=logger, device=device), log_interval)


def make_redq_trainer(env: EnvBase, total_steps: int, buffer_capacity: int = 1_000_000,
                      frames_per_batch: int = 1024, config: OffPolicyConfig | None = None,
                      num_qvalue_nets: int = 10, sub_sample_len: int = 2, gamma: float = 0.99,
                      logger: Logger | None = None, log_interval: int = 10, device=None,
                      **loss_kwargs) -> Trainer:
    """REDQ: the default continuous actor, ``num_qvalue_nets`` 256x256
    ``ConcatMLP`` critics with targets from ``sub_sample_len`` of them, a
    ``DeviceStorage(buffer_capacity)`` ring sampled uniformly,
    ``OffPolicyConfig(init_random_frames=5000, utd_ratio=8)`` by default."""
    actor = default_continuous_actor(env)
    loss = REDQLoss(actor, ConcatMLP(out_features=1, num_cells=(256, 256)),
                    num_qvalue_nets=num_qvalue_nets, sub_sample_len=sub_sample_len, gamma=gamma,
                    **loss_kwargs)
    coll = Collector(env, actor, frames_per_batch=frames_per_batch)
    program = OffPolicyProgram(coll, loss, ReplayBuffer(DeviceStorage(buffer_capacity)),
                               config or OffPolicyConfig(init_random_frames=5000, utd_ratio=8),
                               device=device)
    return _std_hooks(Trainer(program, total_steps, logger=logger, device=device), log_interval)


def make_crossq_trainer(env: EnvBase, total_steps: int, buffer_capacity: int = 1_000_000,
                        frames_per_batch: int = 1024, config: OffPolicyConfig | None = None,
                        gamma: float = 0.99, logger: Logger | None = None, log_interval: int = 10,
                        device=None, **loss_kwargs) -> Trainer:
    """CrossQ: the default continuous actor, two 256x256 batch-normalised
    critics and no target networks, a ``DeviceStorage(buffer_capacity)``
    ring sampled uniformly, ``OffPolicyConfig(init_random_frames=5000)``
    by default. The program writes the critics' running statistics back
    after every finite update."""
    actor = default_continuous_actor(env)
    loss = CrossQLoss(actor, gamma=gamma, **loss_kwargs)
    coll = Collector(env, actor, frames_per_batch=frames_per_batch)
    program = OffPolicyProgram(coll, loss, ReplayBuffer(DeviceStorage(buffer_capacity)),
                               config or OffPolicyConfig(init_random_frames=5000), device=device)
    return _std_hooks(Trainer(program, total_steps, logger=logger, device=device), log_interval)


make_impala_trainer = not_ported("make_impala_trainer", __name__, "A7: IMPALA")
make_mappo_trainer = not_ported("make_mappo_trainer", __name__, "A7: multi-agent")
make_qmix_trainer = not_ported("make_qmix_trainer", __name__, "A7: multi-agent")
train_iql = not_ported("train_iql", __name__, "A7: offline losses")
train_cql = not_ported("train_cql", __name__, "A7: offline losses")
