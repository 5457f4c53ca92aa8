"""Off-policy training program: collect -> extend the device replay ->
``utd_ratio`` x (sample -> gradient step -> polyak -> priority write-back)
(counterpart of :mod:`rl_tpu.trainers.off_policy`; ``OffPolicyConfig``,
``default_device_metrics`` and ``OffPolicyProgram`` are ported).

The reference compiles a train step into one XLA program over a pure
state; here the same step runs eagerly on the card, and the parameters,
Adam moments, targets, replay rings and PER tree are updated in place.
The reference's finite guard keeps the *old* state after a non-finite
update (``tree_where(ok, new, old)``); with nothing old left after an
in-place write, each write is gated on the device instead, without a host
sync:

- Adam selects new parameters and moments with ``torch.where(ok, ...)``;
- the polyak update writes ``where(ok, new_target, target)``;
- the priority write-back zeroes its deltas where ``ok`` is false (kernel
  B7 adds ``+0.0``, which leaves a non-negative leaf bit for bit) and
  selects ``max_priority``;
- the sampler's step counter still advances, as in the reference.

``train_step`` returns its metrics as 0-dim device tensors: reading them
is the caller's choice of sync.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import resolve_device
from .._stubs import not_ported
from ..collectors.single import Collector
from ..data.arraydict import ArrayDict
from ..data.replay.buffer import ReplayBuffer
from ..objectives.common import LossModule, SoftUpdate
from ..obs.device import DeviceMetrics
from .grpo import Adam

__all__ = ["OffPolicyConfig", "OffPolicyProgram", "default_device_metrics",
           "clip_by_global_norm", "global_norm"]


def default_device_metrics() -> DeviceMetrics:
    """The reference's on-device schema for off-policy programs: update
    count, loss/grad-norm/param-norm gauges, |TD-error| and staleness
    histograms. ``bad_steps`` counts updates skipped by the finite guard."""
    return DeviceMetrics(
        counters=("updates", "bad_steps"),
        gauges=("loss", "grad_norm", "param_norm"),
        histograms={
            "td_error": (0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0, 100.0),
            "staleness": (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0),
        },
    )


def _resolve_dm(device_metrics) -> DeviceMetrics | None:
    if device_metrics is True:
        return default_device_metrics()
    if device_metrics is False:
        return None
    return device_metrics


def global_norm(tensors) -> torch.Tensor:
    """``sqrt(sum of squares)`` over a list of tensors (optax's)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


def clip_by_global_norm(grads, max_norm: float) -> list[torch.Tensor]:
    """optax's ``clip_by_global_norm``: unchanged below ``max_norm``, else
    ``(g / norm) * max_norm``."""
    g_norm = global_norm(grads)
    trigger = g_norm < max_norm
    return [torch.where(trigger, g, (g / g_norm) * max_norm) for g in grads]


@dataclasses.dataclass
class OffPolicyConfig:
    batch_size: int = 256
    utd_ratio: int = 1  # gradient updates per collected batch
    learning_rate: float = 3e-4
    max_grad_norm: float | None = None
    tau: float = 0.005  # polyak factor of the target nets
    init_random_frames: int = 0
    # TD3-style delayed policy updates: the policy moves only every k-th
    # update (its Adam moments still decay on the others, as in the reference)
    policy_delay: int = 1
    policy_key: str = "actor"  # the loss child the delay applies to


class OffPolicyProgram:
    """Collector + replay buffer + loss + Adam as one train step.

    Usage::

        program = OffPolicyProgram(collector, loss, buffer, config, device="cuda")
        ts = program.init(seed=0)
        ts = program.prefill(ts)                   # init_random_frames
        for _ in range(n):
            ts, metrics = program.train_step(ts)

    ``device`` defaults to the card (none: raises); ``"cpu"`` runs every
    kernel's plain version. ``priority_key`` (e.g. ``"td_error"``) names
    the per-sample loss metric written back to a prioritized sampler.
    ``device_metrics``: True for :func:`default_device_metrics`, a
    :class:`DeviceMetrics` for a custom schema, None/False for none.
    """

    def __init__(self, collector: Collector, loss: LossModule, buffer: ReplayBuffer,
                 config: OffPolicyConfig = OffPolicyConfig(), priority_key: str | None = None,
                 device_metrics: DeviceMetrics | bool | None = None, device=None):
        self.device = resolve_device(device)
        self.collector = collector
        self.loss = loss
        self.buffer = buffer
        self.config = config
        self.priority_key = priority_key
        self.device_metrics = _resolve_dm(device_metrics)
        self.target_update = SoftUpdate(loss, tau=config.tau)
        self.optimizer: Adam | None = None
        self._frozen: tuple[int, ...] = ()

    # -- state ----------------------------------------------------------------

    def init(self, seed: int = 0) -> dict:
        """Reset the envs, initialise the loss's parameters and Adam, and
        lay out the replay buffer from one collected transition, all on the
        program's device. The train state holds the one
        ``torch.Generator`` every draw of the program comes from."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        cstate = self.collector.init(gen)
        self.loss.init_params(cstate["carry"], gen)
        self.optimizer = Adam([p for _, p in self.loss.trainable_parameters()],
                              self.config.learning_rate)
        self._frozen = tuple(
            i for i, (n, _) in enumerate(self.loss.trainable_parameters())
            if n.split(".")[0] == self.config.policy_key)
        # the layout of one item: a step on a copy of the generator, so
        # laying out the buffer draws nothing from the program's stream
        probe = torch.Generator(device=self.device)
        probe.set_state(gen.get_state())
        with torch.no_grad():
            *_, full_td = self.collector.step(cstate["env"], cstate["carry"],
                                              cstate["traj_ids"], cstate["traj_count"], probe)
        nb = len(self.collector.env.batch_shape)
        example = full_td.apply(lambda x: x.reshape((-1,) + tuple(x.shape[nb:]))[0])
        ts = {"collector": cstate, "buffer": self.buffer.init(example), "generator": gen,
              "update_count": 0}
        if self.device_metrics is not None:
            ts["obs"] = self.device_metrics.init(self.device)
        return ts

    def shard_state(self, ts, mesh, *, min_size_mb: float = 4.0):
        raise NotImplementedError(
            "OffPolicyProgram.shard_state is not ported yet (ROADMAP A7: parallel/)")

    def jit_train_step(self, steps_per_call: int = 1, donate: bool = True):
        raise NotImplementedError(
            "OffPolicyProgram.jit_train_step has no counterpart yet: the port runs eagerly "
            "and updates in place (ROADMAP A7: a CUDA graph of the step)")

    def _flatten(self, batch: ArrayDict) -> ArrayDict:
        """``[T, *env_batch, ...] -> [T * prod(env_batch), ...]``,
        env-major: each env's T steps stay contiguous."""
        nb = 1 + len(self.collector.env.batch_shape)

        def flat(x):
            if nb > 1:
                x = torch.movedim(x, 0, nb - 1)  # time innermost
            return x.reshape((-1,) + tuple(x.shape[nb:]))

        return batch.apply(flat)

    # -- phases ---------------------------------------------------------------

    def prefill(self, ts: dict) -> dict:
        """Fill the buffer with ``init_random_frames`` (rounded up to whole
        batches) of random-policy frames. The real policy still runs, so
        the batch keeps its layout; its action is replaced by a uniform
        draw from the action spec."""
        if self.config.init_random_frames <= 0:
            return ts
        env = self.collector.env
        policy = self.collector.policy

        def rand_policy(td, generator):
            if policy is not None:
                td = policy(td, generator)
            return td.set("action", env.action_spec.rand(env.batch_shape, generator))

        rand_coll = Collector(env, policy=rand_policy,
                              frames_per_batch=self.collector.frames_per_batch,
                              postproc=self.collector.postproc)
        cstate, bstate = ts["collector"], ts["buffer"]
        for _ in range(-(-self.config.init_random_frames // self.collector.frames_per_batch)):
            batch, cstate = rand_coll.collect(cstate)
            bstate = self.buffer.extend(bstate, self._flatten(batch),
                                        n=rand_coll.frames_per_batch)
        return {**ts, "collector": cstate, "buffer": bstate}

    def train_step(self, ts: dict) -> tuple[dict, ArrayDict]:
        """Collect one batch, store it, and take ``utd_ratio`` gradient
        updates. Metrics are means over the updates, plus ``reward_mean``
        of the collected batch."""
        batch, cstate = self.collector.collect(ts["collector"])
        bstate = self.buffer.extend(ts["buffer"], self._flatten(batch),
                                    n=self.collector.frames_per_batch)
        ts, metrics = self.updates({**ts, "collector": cstate, "buffer": bstate})
        return ts, metrics.set("reward_mean", batch["next", "reward"].mean())

    def updates(self, ts: dict, draws=None) -> tuple[dict, ArrayDict]:
        """``utd_ratio`` gradient updates on the buffer. ``draws`` (one
        ``(u, eps_next, eps_pi)`` per update: the sampler's uniforms and
        the loss's two standard-normal draws) replaces the generator's
        draws, so a test can feed the reference's."""
        k = self.config.utd_ratio
        if draws is not None and len(draws) != k:
            raise ValueError(f"updates: {len(draws)} draws for utd_ratio {k}")
        bstate, dm = ts["buffer"], ts.get("obs")
        per_update = []
        for i in range(k):
            u, noise = (None, None) if draws is None else (draws[i][0], tuple(draws[i][1:]))
            bstate, dm, metrics = self._update(bstate, dm, ts["generator"],
                                               ts["update_count"] + i, u, noise)
            per_update.append(metrics)
        mean = ArrayDict({n: torch.stack([m[n] for m in per_update]).mean()
                          for n in per_update[0].keys()})
        new_ts = {**ts, "buffer": bstate, "update_count": ts["update_count"] + k}
        if dm is not None:
            new_ts["obs"] = dm
        return new_ts, mean

    def _update(self, bstate, dm, generator, upd_idx: int, u=None, noise=None):
        """sample -> guarded gradient step -> polyak -> gated priority
        write-back. Returns ``(bstate, dm, scalar metrics)``."""
        mb, bstate = self.buffer.sample(bstate, generator, self.config.batch_size, u=u)
        dm, metrics, loss_val, ok = self._grad_step(mb, generator, noise, upd_idx, dm)
        if self.priority_key is not None and self.priority_key in metrics:
            bstate = self.buffer.update_priority(bstate, mb["index"],
                                                 metrics[self.priority_key], ok=ok)
        scalars = ArrayDict({n: v for n, v in metrics.items() if v.dim() == 0})
        return bstate, dm, scalars.set("loss", loss_val)

    def _grad_step(self, mb: ArrayDict, generator, noise, upd_idx: int, dm):
        """One guarded gradient step on a minibatch: ``(dm, metrics,
        loss, ok)``; the per-sample metrics go back to the caller."""
        trainable = [p for _, p in self.loss.trainable_parameters()]
        param_norm = global_norm(p.detach() for p in trainable) if dm is not None else None
        loss_val, grads, metrics = self.loss.grad(mb, generator=generator, noise=noise)
        g_norm = global_norm(grads)
        ok = torch.isfinite(loss_val) & torch.isfinite(g_norm)
        if dm is not None:
            dm = self._record_update_metrics(dm, loss_val, g_norm, param_norm, metrics, mb, ok)
        frozen = ()
        if self.config.policy_delay > 1 and upd_idx % self.config.policy_delay:
            frozen = self._frozen
            for i in frozen:
                grads[i] = torch.zeros_like(grads[i])
        if self.config.max_grad_norm is not None:
            grads = clip_by_global_norm(grads, self.config.max_grad_norm)
        self.optimizer.step(grads, ok, frozen)
        self.target_update(ok)
        return dm, metrics, loss_val, ok

    def _record_update_metrics(self, dm, loss_val, g_norm, param_norm, metrics, mb, ok):
        """A bad step counts in ``bad_steps``, not ``updates``, and zeroes
        the loss and grad-norm gauges rather than publishing NaN."""
        spec = self.device_metrics
        okf = ok.to(torch.float32)
        dm = spec.inc(dm, "updates", okf)
        if "bad_steps" in spec.counters:
            dm = spec.inc(dm, "bad_steps", 1.0 - okf)
        dm = spec.set_gauge(dm, "loss", torch.where(ok, loss_val, 0.0))
        dm = spec.set_gauge(dm, "grad_norm", torch.where(ok, g_norm, 0.0))
        dm = spec.set_gauge(dm, "param_norm", param_norm)
        if "td_error" in spec.histograms and "td_error" in metrics:
            td = metrics["td_error"].abs()
            dm = spec.observe(dm, "td_error", torch.where(torch.isfinite(td), td, 0.0))
        if "staleness" in spec.histograms and "staleness" in mb:
            dm = spec.observe(dm, "staleness", mb["staleness"])
        return dm

    def publish_device_metrics(self, ts: dict, registry=None) -> dict | None:
        """Drain the on-device metrics (one explicit copy) and return the
        flat snapshot. Publishing into a host metrics registry is not
        ported yet."""
        if registry is not None:
            raise NotImplementedError(
                "publish_device_metrics(registry=...): the host metrics registry is not "
                "ported yet (ROADMAP A7: obs/)")
        if self.device_metrics is None or "obs" not in ts:
            return None
        return self.device_metrics.to_flat(
            DeviceMetrics.drain(DeviceMetrics.drain_async(ts["obs"])))


AsyncOffPolicyTrainer = not_ported("AsyncOffPolicyTrainer", __name__,
                                   "A6: the overlapped host-env trainer")
