"""On-policy training program (PPO, A2C): collect -> advantages ->
epochs x minibatches of clipped Adam (counterpart of
:mod:`rl_tpu.trainers.on_policy`; ``OnPolicyConfig`` and
``OnPolicyProgram`` are ported).

The reference compiles a train step into one XLA program (collect, the
advantage, then a ``lax.scan`` over epochs and minibatches). Here the same
step runs eagerly on the generator's device and updates the loss's
parameters in place, as :class:`~rl_tpu_torch.trainers.OffPolicyProgram`
does:

- the optimizer is optax's ``chain(clip_by_global_norm(max_grad_norm),
  adam(lr))``: :func:`clip_by_global_norm` then :class:`Adam`, with no
  finite guard (the reference's on-policy program has none);
- ``anneal_lr_to`` is optax's ``linear_schedule(lr, anneal_lr_to,
  total_steps)`` over optimizer updates (minibatches), not train steps.
  The host counts the updates, so the rate is a Python float and nothing
  is read from the device;
- each epoch draws a permutation of the flattened ``[T * N]`` batch from
  the train state's generator (the reference's ``jax.random.permutation``);
  :meth:`OnPolicyProgram.update_from_batch` takes explicit
  ``permutations`` so a test can feed the reference's draws.

:meth:`OnPolicyProgram.jit_update_from_batch` registers the learner half
as a program (``on_policy.update``): one CUDA graph per batch layout on
the card, with the epochs' permutations as its inputs.
:meth:`OnPolicyProgram.jit_train_step` is the whole step through programs:
the collector's ``collector.collect`` graph, the epochs' permutations
drawn eagerly from the train state's generator, then the update's graph,
so that the draws come in the eager step's order and a replayed step
equals the eager one bit for bit.

``train_step`` returns its metrics as 0-dim device tensors: the mean over
every update of the loss's metrics and ``"loss"``, then
``"episode_reward_mean"`` (NaN where no episode ended in the batch) and
``"reward_mean"``. Nothing is read on the host inside it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..collectors.single import Collector
from ..compile import get_program_registry
from ..data.arraydict import ArrayDict
from ..objectives.common import LossModule
from .grpo import Adam
from .off_policy import _episode_reward, clip_by_global_norm

__all__ = ["OnPolicyConfig", "OnPolicyProgram", "linear_schedule"]


@dataclasses.dataclass
class OnPolicyConfig:
    num_epochs: int = 4
    minibatch_size: int = 256
    max_grad_norm: float = 0.5
    learning_rate: float = 3e-4
    anneal_lr_to: float | None = None  # the final rate of a linear anneal
    total_steps: int | None = None  # optimizer updates the anneal spans


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Callable:
    """optax's ``linear_schedule``: ``init`` at count 0, ``end`` from
    ``transition_steps`` on, linear between."""

    def schedule(count: int) -> float:
        count = min(max(count, 0), transition_steps)
        return (init_value - end_value) * (1.0 - count / transition_steps) + end_value

    return schedule


class OnPolicyProgram:
    """Collector + loss + clipped Adam as one train step.

    Usage::

        program = OnPolicyProgram(collector, loss, config)
        gen = torch.Generator(device="cuda"); gen.manual_seed(0)
        ts = program.init(gen)
        for _ in range(n):
            ts, metrics = program.train_step(ts)

    ``advantage`` (``batch -> batch`` with "advantage" and
    "value_target") defaults to the loss's value estimator;
    ``recompute_advantage`` recomputes it at every epoch (V-trace).
    """

    def __init__(self, collector: Collector, loss: LossModule,
                 config: OnPolicyConfig = OnPolicyConfig(),
                 advantage: Callable[[ArrayDict], ArrayDict] | None = None,
                 recompute_advantage: bool = False):
        self.collector = collector
        self.loss = loss
        self.config = config
        if advantage is None:
            if loss.value_estimator is None:
                loss.make_value_estimator()
            advantage = loss._ensure_advantage
        self.advantage = advantage
        self.recompute_advantage = recompute_advantage
        frames = collector.frames_per_batch
        if frames % config.minibatch_size:
            raise ValueError(f"frames_per_batch={frames} not divisible by "
                             f"minibatch_size={config.minibatch_size}")
        self.num_minibatches = frames // config.minibatch_size
        if config.anneal_lr_to is not None and config.total_steps:
            self.schedule = linear_schedule(config.learning_rate, config.anneal_lr_to,
                                            config.total_steps)
        else:
            self.schedule = lambda count: config.learning_rate

    # -- state ----------------------------------------------------------------

    def init(self, generator: torch.Generator, example_td: ArrayDict | None = None) -> dict:
        """Reset the envs and build the loss's parameters (from the
        carried observation, or ``example_td``) and the optimizer, on the
        generator's device. The train state holds the collector state, the
        optimizer, the generator and the count of optimizer updates."""
        cstate = self.collector.init(generator)
        td = example_td if example_td is not None else cstate["carry"]
        self.loss.init_params(td, generator)
        params = [p for _, p in self.loss.trainable_parameters()]
        optimizer = Adam(params, self.config.learning_rate)
        return {"collector": cstate, "optimizer": optimizer, "generator": generator,
                "update_count": 0}

    # -- the step -------------------------------------------------------------

    def train_step(self, ts: dict) -> tuple[dict, ArrayDict]:
        batch, cstate = self.collector.collect(ts["collector"])
        return self.update_from_batch({**ts, "collector": cstate}, batch)

    def update_from_batch(self, ts: dict, batch: ArrayDict, permutations=None
                          ) -> tuple[dict, ArrayDict]:
        """The learner half of the step: the advantage, then ``num_epochs``
        passes over the flattened batch in minibatches, one clipped Adam
        update each. ``permutations`` (one index tensor of ``T * N`` per
        epoch) replaces the generator's draws."""
        cfg = self.config
        if permutations is not None and len(permutations) != cfg.num_epochs:
            raise ValueError(f"{len(permutations)} permutations for {cfg.num_epochs} epochs")
        if not self.recompute_advantage:
            batch = self.advantage(batch)
        optimizer, gen = ts["optimizer"], ts["generator"]
        ok = torch.ones((), dtype=torch.bool, device=optimizer.count.device)
        count = ts["update_count"]
        per_update = []
        for epoch in range(cfg.num_epochs):
            flat = (self.advantage(batch) if self.recompute_advantage else batch).flatten_batch()
            n = flat.batch_shape[0]
            perm = (permutations[epoch].to(optimizer.count.device) if permutations is not None
                    else torch.randperm(n, generator=gen, device=gen.device))
            for idx in perm.reshape(self.num_minibatches, cfg.minibatch_size):
                loss_val, grads, metrics = self.loss.grad(flat[idx])
                grads = clip_by_global_norm(grads, cfg.max_grad_norm)
                optimizer.lr = self.schedule(count)
                optimizer.step(grads, ok)
                count += 1
                per_update.append(metrics.set("loss", loss_val))
        mean = ArrayDict({k: torch.stack([m[k] for m in per_update]).mean()
                          for k in per_update[0].keys()})
        mean = mean.set("episode_reward_mean", _episode_reward(batch))
        mean = mean.set("reward_mean", torch.mean(batch["next", "reward"]))
        return {**ts, "update_count": count}, mean

    def jit_update_from_batch(self, registry=None):
        """:meth:`update_from_batch` as a registered program
        (``on_policy.update``): ``update(ts, batch, permutations=None) ->
        (ts, metrics)``. On the card each batch layout is captured once as
        a CUDA graph and replayed; on the CPU it runs eagerly. The epochs'
        permutations are the graph's inputs: without ``permutations`` they
        are drawn first from the train state's generator, the draws the
        eager update makes. A graph fixes the learning rate, so a program
        with ``anneal_lr_to`` is refused."""
        if self.config.anneal_lr_to is not None and self.config.total_steps:
            raise ValueError("jit_update_from_batch: a graph fixes the learning rate; "
                             "anneal_lr_to needs the eager update_from_batch")
        return _GraphedUpdate(self, registry or get_program_registry())

    def jit_train_step(self, registry=None) -> "_GraphedTrainStep":
        """:meth:`train_step` through registered programs: ``step(ts) ->
        (ts, metrics)`` runs the collect program
        (:meth:`Collector.jit_collect`), draws the epochs' permutations
        from ``ts["generator"]`` as the eager update does, and runs the
        update program (:meth:`jit_update_from_batch`). No host loop over
        env steps; refused with ``anneal_lr_to`` as the update is."""
        registry = registry or get_program_registry()
        return _GraphedTrainStep(self.jit_update_from_batch(registry),
                                 self.collector.jit_collect(registry))


class _GraphedTrainStep:
    """:meth:`OnPolicyProgram.jit_train_step`'s callable: ``collect`` and
    ``update`` are its two programs' callables."""

    def __init__(self, update: "_GraphedUpdate", collect):
        self.update, self.collect = update, collect

    def __call__(self, ts: dict) -> tuple[dict, ArrayDict]:
        batch, cstate = self.collect(ts["collector"])
        return self.update({**ts, "collector": cstate}, batch)


class _GraphedUpdate:
    """:meth:`OnPolicyProgram.jit_update_from_batch`'s callable."""

    def __init__(self, program: OnPolicyProgram, registry):
        self._p = program
        self._opt = None
        self.program = registry.register("on_policy.update", self._body, state=self._state)

    def _state(self) -> list:
        # what the update changes in place: the loss's parameters, Adam's moments
        opt = self._opt
        return [*self._p.loss.parameters(), *self._p.loss.buffers(), *opt.mu, *opt.nu,
                opt.count]

    def _body(self, ts: dict, batch: ArrayDict, permutations: list):
        return self._p.update_from_batch(ts, batch, permutations=permutations)

    def __call__(self, ts: dict, batch: ArrayDict, permutations=None):
        p, gen = self._p, ts["generator"]
        if permutations is None:
            n = math.prod(batch.batch_shape)
            permutations = [torch.randperm(n, generator=gen, device=gen.device)
                            for _ in range(p.config.num_epochs)]
        self._opt = ts["optimizer"]
        inner = {"optimizer": ts["optimizer"], "generator": gen, "update_count": 0}
        _, metrics = self.program(inner, batch, list(permutations))
        n_updates = p.config.num_epochs * p.num_minibatches
        return {**ts, "update_count": ts["update_count"] + n_updates}, metrics
