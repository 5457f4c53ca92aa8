"""Off-policy training program: collect -> extend the device replay ->
``utd_ratio`` x (sample -> gradient step -> polyak -> priority write-back)
(counterpart of :mod:`rl_tpu.trainers.off_policy`; ``OffPolicyConfig``,
``default_device_metrics``, ``OffPolicyProgram`` and the overlapped
host-env ``AsyncOffPolicyTrainer`` are ported).

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
- the sampler's step counter still advances, as in the reference;
- a loss's running state (CrossQ's batch-norm statistics) is written
  back where ``ok`` holds (``LossModule.commit_state``). The reference
  drops it, so its statistics never move; the port keeps them.

``train_step`` returns its metrics as 0-dim device tensors: reading them
is the caller's choice of sync.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from .. import resolve_device
from ..checkpoint import restore_into
from ..collectors.single import Collector
from ..compile import get_program_registry
from ..data.arraydict import ArrayDict
from ..data.replay.buffer import ReplayBuffer
from ..objectives.common import LossModule, SoftUpdate
from ..obs.device import DeviceMetrics
from ..obs.registry import get_registry
from ..resilience.faults import fault_point, get_injector
from .grpo import Adam

__all__ = ["OffPolicyConfig", "OffPolicyProgram", "AsyncOffPolicyTrainer",
           "default_device_metrics", "clip_by_global_norm", "global_norm"]


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


def _episode_reward(batch: ArrayDict) -> torch.Tensor:
    """The mean return of the episodes that ended in ``batch`` (from
    RewardSum's "episode_reward"), NaN when none ended: a 0 would read as
    a real return. Without RewardSum, the mean reward."""
    if ("next", "episode_reward") not in batch:
        return torch.mean(batch["next", "reward"])
    er, done = batch["next", "episode_reward"], batch["next", "done"]
    total = torch.sum(torch.where(done, er, 0.0))
    count = torch.sum(done.to(torch.float32))
    return torch.where(count > 0, total / torch.clamp(count, min=1.0), float("nan"))


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


class _GradUpdateMixin:
    """The gradient-update body shared by :class:`OffPolicyProgram` and
    :class:`AsyncOffPolicyTrainer`: sample -> guarded gradient step ->
    polyak -> gated priority write-back, ``utd_ratio`` times. Needs
    ``loss``, ``buffer``, ``config``, ``optimizer``, ``target_update``,
    ``priority_key``, ``device_metrics`` and ``_frozen``."""

    device_metrics: DeviceMetrics | None = None

    def _hidden_state(self) -> list:
        """What a step updates in place beside its train state: every
        parameter and buffer of the loss (targets, CrossQ's running
        statistics) and the Adam moments."""
        opt = self.optimizer
        return [*self.loss.parameters(), *self.loss.buffers(), *opt.mu, *opt.nu, opt.count]

    def updates(self, ts: dict, draws=None, poison=None) -> tuple[dict, ArrayDict]:
        """``utd_ratio`` gradient updates on the buffer. ``draws`` (one
        ``(u, eps_next, eps_pi)`` per update: the sampler's uniforms and
        the loss's two standard-normal draws) replaces the generator's
        draws, so a test can feed the reference's. ``poison`` (a 0-dim
        float32 device tensor: NaN or 0) is the chaos site's scalar, added
        to the first update's loss and gradients and a zero to the others',
        as the reference's chaos K-update adds its per-update vector."""
        k = self.config.utd_ratio
        if draws is not None and len(draws) != k:
            raise ValueError(f"updates: {len(draws)} draws for utd_ratio {k}")
        bstate, dm = ts["buffer"], ts.get("obs")
        per_update = []
        for i in range(k):
            u, noise = (None, None) if draws is None else (draws[i][0], tuple(draws[i][1:]))
            p = poison if poison is None or i == 0 else torch.zeros_like(poison)
            bstate, dm, metrics = self._update(bstate, dm, ts["generator"],
                                               ts["update_count"] + i, u, noise, p)
            per_update.append(metrics)
        mean = ArrayDict({n: torch.stack([m[n] for m in per_update]).mean()
                          for n in per_update[0].keys()})
        new_ts = {**ts, "buffer": bstate, "update_count": ts["update_count"] + k}
        if dm is not None:
            new_ts["obs"] = dm
        return new_ts, mean

    def _update(self, bstate, dm, generator, upd_idx: int, u=None, noise=None, poison=None):
        """sample -> guarded gradient step -> polyak -> gated priority
        write-back. Returns ``(bstate, dm, scalar metrics)``."""
        mb, bstate = self.buffer.sample(bstate, generator, self.config.batch_size, u=u)
        dm, metrics, loss_val, ok = self._grad_step(mb, generator, noise, upd_idx, dm, poison)
        if self.priority_key is not None and self.priority_key in metrics:
            bstate = self.buffer.update_priority(bstate, mb["index"],
                                                 metrics[self.priority_key], ok=ok)
        scalars = ArrayDict({n: v for n, v in metrics.items() if v.dim() == 0})
        return bstate, dm, scalars.set("loss", loss_val)

    def _grad_step(self, mb: ArrayDict, generator, noise, upd_idx: int, dm, poison=None):
        """One guarded gradient step on a minibatch: ``(dm, metrics,
        loss, ok)``; the per-sample metrics go back to the caller."""
        trainable = [p for _, p in self.loss.trainable_parameters()]
        param_norm = global_norm(p.detach() for p in trainable) if dm is not None else None
        loss_val, grads, metrics = self.loss.grad(mb, generator=generator, noise=noise)
        if poison is not None:  # the chaos site: NaN makes the finite guard skip the update
            loss_val = loss_val + poison
            grads = [g + poison for g in grads]
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
        metrics = self.loss.commit_state(metrics, ok)
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
        flat snapshot; with ``registry`` (a
        :class:`~rl_tpu_torch.obs.MetricsRegistry`) also publish it there
        under ``rl_tpu_device_*``."""
        if self.device_metrics is None or "obs" not in ts:
            return None
        snap = DeviceMetrics.drain(DeviceMetrics.drain_async(ts["obs"]))
        if registry is not None:
            self.device_metrics.publish(snap, registry)
        return self.device_metrics.to_flat(snap)


class OffPolicyProgram(_GradUpdateMixin):
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

    def init(self, seed: int | torch.Generator = 0) -> dict:
        """Reset the envs, initialise the loss's parameters and Adam, and
        lay out the replay buffer from one collected batch, all on the
        program's device. The train state holds the one
        ``torch.Generator`` every draw of the program comes from: ``seed``
        itself when it is one (a :class:`Trainer` passes its own), else a
        new one seeded with it."""
        if isinstance(seed, torch.Generator):
            gen = seed
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
        cstate = self.collector.init(gen)
        self.loss.init_params(cstate["carry"], gen)
        self.optimizer = Adam([p for _, p in self.loss.trainable_parameters()],
                              self.config.learning_rate)
        self._frozen = tuple(
            i for i, (n, _) in enumerate(self.loss.trainable_parameters())
            if n.split(".")[0] == self.config.policy_key)
        # the layout of one item, as the reference takes it from the
        # collect's output shape: a batch collected and post-processed
        # (MultiStep adds leaves) on a copy of the generator, so laying
        # out the buffer draws nothing from the program's stream
        probe = torch.Generator(device=gen.device)
        probe.set_state(gen.get_state())
        batch, _ = self.collector.collect({**cstate, "generator": probe})
        example = self._flatten(batch)[0]
        ts = {"collector": cstate, "buffer": self.buffer.init(example), "generator": gen,
              "update_count": 0}
        if self.device_metrics is not None:
            ts["obs"] = self.device_metrics.init(self.device)
        return ts

    def shard_state(self, ts, mesh, *, min_size_mb: float = 4.0):
        raise NotImplementedError(
            "OffPolicyProgram.shard_state is not ported yet (ROADMAP A7: parallel/)")

    def jit_train_step(self, steps_per_call: int = 1, donate: bool = True, registry=None):
        """:meth:`train_step` as one registered program
        (``off_policy.train_step``), ``steps_per_call`` steps a call with
        their metrics averaged (``nanmean``: ``episode_reward_mean`` is NaN
        where no episode ended). On the card each state layout is captured
        once as a CUDA graph (collect, extend, the updates with the PER
        write-back around B7), replayed by every later call; on the CPU it
        runs eagerly. The host's counters (``update_count``, the
        collector's ``step_count``) stay outside the graph;
        ``update_count % policy_delay``, which picks the updates that hold
        the policy, is part of the signature. The returned callable takes
        and returns the train state; its ``aot_warmup(ts)`` captures
        before the first call. The state is updated in place, as the
        reference's donated state is: ``donate=False`` is refused."""
        if not donate:
            raise ValueError("jit_train_step(donate=False): the port updates the train state "
                             "in place; keeping the input state would copy all of it")
        return _GraphedTrainStep(self, steps_per_call, registry or get_program_registry())

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
        of the collected batch and, where the env has ``RewardSum``,
        ``episode_reward_mean`` (NaN when no episode ended in it)."""
        batch, cstate = self.collector.collect(ts["collector"])
        bstate = self.buffer.extend(ts["buffer"], self._flatten(batch),
                                    n=self.collector.frames_per_batch)
        ts, metrics = self.updates({**ts, "collector": cstate, "buffer": bstate})
        metrics = metrics.set("reward_mean", batch["next", "reward"].mean())
        if ("next", "episode_reward") in batch:
            metrics = metrics.set("episode_reward_mean", _episode_reward(batch))
        return ts, metrics


class _GraphedTrainStep:
    """:meth:`OffPolicyProgram.jit_train_step`'s callable."""

    def __init__(self, program: OffPolicyProgram, steps: int, registry):
        if steps < 1:
            raise ValueError(f"steps_per_call must be >= 1, got {steps}")
        self._p, self.steps = program, steps
        self._period = max(1, program.config.policy_delay)
        self.program = registry.register("off_policy.train_step", self._body,
                                         fingerprint=repr(steps),
                                         state=program._hidden_state)

    def _body(self, ts: dict) -> tuple[dict, ArrayDict]:
        per_step = []
        for _ in range(self.steps):
            ts, metrics = self._p.train_step(ts)
            per_step.append(metrics)
        if self.steps == 1:
            return ts, per_step[0]
        return ts, ArrayDict({k: torch.nanmean(torch.stack([m[k] for m in per_step]))
                              for k in per_step[0].keys()})

    def _inner(self, ts: dict) -> dict:
        """``ts`` with its host counters replaced by what the graph may fix."""
        return {**ts, "update_count": ts["update_count"] % self._period,
                "collector": {**ts["collector"], "step_count": 0}}

    def __call__(self, ts: dict) -> tuple[dict, ArrayDict]:
        out, metrics = self.program(self._inner(ts))
        frames = self._p.collector.frames_per_batch * self.steps
        out = {**out, "update_count": ts["update_count"] + self._p.config.utd_ratio * self.steps,
               "collector": {**out["collector"],
                             "step_count": ts["collector"]["step_count"] + frames}}
        return out, metrics

    def aot_warmup(self, ts: dict, *, background: bool = False):
        """Capture the step for ``ts``'s layout (its values are left as they
        were); the registry's report, or a handle with ``background``."""
        self.program.add_signature(self._inner(ts))
        return self.program._registry.aot_warmup(programs=[self.program],
                                                 background=background)


class AsyncOffPolicyTrainer(_GradUpdateMixin):
    """Overlapped off-policy trainer: host envs feed a device replay while
    the card runs the K-update program (the Sebulba split,
    arXiv:2104.06272).

    - the :class:`~rl_tpu_torch.collectors.AsyncHostCollector` actor thread
      steps the env pool and queues flat transition batches;
    - this thread writes each batch into the replay (``replay.extend``,
      :meth:`ReplayBuffer.make_extend`) and dispatches one K-update
      (``offpolicy.k_updates``: ``utd_ratio`` x sample, guarded step,
      polyak, PER write-back through kernel B7), each a CUDA graph on the
      card that reads nothing on the host;
    - the card's queue overlaps the two: while it runs the K-update, the
      host loop pops and writes the next batch and the envs keep stepping.

    After each dispatch the collector gets a snapshot of the policy's new
    weights (taken on this thread's stream, behind the dispatch) and bumps
    ``policy_version``, the per-item stamp ``StalenessAwareSampler`` reads.
    The device metrics are drained one dispatch late and published to the
    metrics registry. Parameters, Adam's moments, targets and the replay
    are updated in place, as in :class:`OffPolicyProgram`; the train state
    holds the replay, the generator, the host's ``update_count`` and the
    device metrics. ``host_split`` keeps each batch's host seconds
    (``wait``, ``extend``, ``dispatch``, ``publish``).

    Resilience, as in the reference: ``train(preemption=, emergency=,
    guard=)``, :meth:`emergency_save` / :meth:`emergency_restore`, the
    chaos site ``trainer.preempt`` at each batch boundary and
    ``offpolicy.update``, whose NaN poisons the first update of a
    dispatch. The poisoned dispatch runs its own program,
    ``offpolicy.k_updates_chaos`` (its own graph on the card), taken only
    while an injector is installed, so the plain K-update stays what it is
    bit for bit (a zero added to a gradient would turn its ``-0.0`` into
    ``+0.0``).
    """

    def __init__(self, collector, loss: LossModule, buffer: ReplayBuffer,
                 config: OffPolicyConfig = OffPolicyConfig(), priority_key: str | None = None,
                 device_metrics: DeviceMetrics | bool | None = None, metrics_registry=None,
                 device=None, registry=None):
        if not isinstance(buffer, ReplayBuffer):
            raise NotImplementedError(
                "AsyncOffPolicyTrainer with a host-source replay (not a ReplayBuffer) is not "
                "ported to rl_tpu_torch yet (ROADMAP A7: sharded and remote replay)")
        self.device = resolve_device(device)
        self.collector = collector
        self.loss = loss
        self.buffer = buffer
        self.config = config
        self.priority_key = priority_key
        self.device_metrics = _resolve_dm(device_metrics)
        self.metrics_registry = metrics_registry
        self.target_update = SoftUpdate(loss, tau=config.tau)
        self.optimizer: Adam | None = None
        self._frozen: tuple[int, ...] = ()
        self._period = max(1, config.policy_delay)
        registry = registry or get_program_registry()
        self.extend = buffer.make_extend(collector.frames_per_batch, registry=registry)
        fingerprint = repr((type(loss).__name__, config, priority_key,
                            type(buffer.storage).__name__))
        self.k_program = registry.register("offpolicy.k_updates", self.updates,
                                           fingerprint=fingerprint, state=self._hidden_state)
        self.k_chaos_program = registry.register(
            "offpolicy.k_updates_chaos", lambda inner, poison: self.updates(inner, poison=poison),
            fingerprint=fingerprint, state=self._hidden_state)
        self.host_split: list[dict] = []

    # -- state ----------------------------------------------------------------

    def example_item(self) -> ArrayDict:
        """One zero transition in the collector's batch layout, from the env
        pool's specs, on the trainer's device: it fixes the buffer's
        schema before any env has stepped."""
        pool, dev = self.collector.pool, self.device
        obs = pool.observation_spec.zero((), dev)
        flag = lambda: torch.zeros((), dtype=torch.bool, device=dev)  # noqa: E731
        stamp = lambda: torch.zeros((), dtype=torch.int32, device=dev)  # noqa: E731
        next_td = obs.update(ArrayDict(reward=torch.zeros((), device=dev), terminated=flag(),
                                       truncated=flag(), done=flag()))
        stamps = ArrayDict(policy_version=stamp(), env_ids=stamp(), step=stamp())
        return (obs.set("action", pool.action_spec.zero((), dev)).set("next", next_td)
                .set("collector", stamps))

    def init(self, seed: int | torch.Generator = 0) -> dict:
        """Initialise the loss's parameters (from :meth:`example_item`) and
        Adam, and lay out the replay buffer; the train state."""
        if isinstance(seed, torch.Generator):
            gen = seed
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
        example = self.example_item()
        self.loss.init_params(example.unsqueeze(0), gen)
        self.optimizer = Adam([p for _, p in self.loss.trainable_parameters()],
                              self.config.learning_rate)
        self._frozen = tuple(
            i for i, (n, _) in enumerate(self.loss.trainable_parameters())
            if n.split(".")[0] == self.config.policy_key)
        ts = {"buffer": self.buffer.init(example), "generator": gen, "update_count": 0}
        if self.device_metrics is not None:
            ts["obs"] = self.device_metrics.init(self.device)
        return ts

    def _inner(self, ts: dict) -> dict:
        """What the K-update program takes: ``update_count`` reduced to the
        phase of the policy delay (a host int fixed per graph)."""
        inner = {k: ts[k] for k in ("buffer", "generator", "obs") if k in ts}
        return {**inner, "update_count": ts["update_count"] % self._period}

    def aot_warmup(self, ts: dict, *, background: bool = False):
        """Capture the K-update and the chunk write for ``ts``'s layout
        (its values are left as they were) before :meth:`train` starts the
        actor thread, and with an injector installed the chaos K-update
        too, which ``train`` then dispatches instead; the registry's
        report, or a handle with ``background``."""
        self.k_program.add_signature(self._inner(ts))
        self.extend.program.add_signature(ts["buffer"], self.extend.chunk(ts["buffer"]))
        programs = [self.k_program, self.extend.program]
        if get_injector() is not None:
            zero = torch.zeros((), dtype=torch.float32, device=self.device)
            self.k_chaos_program.add_signature(self._inner(ts), zero)
            programs.append(self.k_chaos_program)
        return self.k_program._registry.aot_warmup(programs=programs, background=background)

    # -- device side ------------------------------------------------------------

    def k_updates(self, ts: dict, poison=None) -> tuple[dict, ArrayDict]:
        """One dispatch of ``offpolicy.k_updates``: ``utd_ratio`` updates on
        the replay, their scalar metrics averaged (0-dim device tensors).
        With ``poison`` (a 0-dim float32 tensor on the trainer's device),
        ``offpolicy.k_updates_chaos``: the same updates with the poison
        added to the first one's loss and gradients."""
        if poison is None:
            out, metrics = self.k_program(self._inner(ts))
        else:
            out, metrics = self.k_chaos_program(self._inner(ts), poison)
        new = {**ts, "buffer": out["buffer"],
               "update_count": ts["update_count"] + self.config.utd_ratio}
        if "obs" in out:
            new["obs"] = out["obs"]
        return new, metrics

    # -- host loop --------------------------------------------------------------

    def _poison_scalar(self) -> torch.Tensor | None:
        """The ``offpolicy.update`` chaos site: None without an injector,
        else a new device scalar (a fill, no upload), NaN on a poisoned
        dispatch and 0 otherwise. A new one each call: the chaos graph
        copies it into its own input, and a tensor kept here would become
        that input at the capture."""
        inj = get_injector()
        if inj is None:
            return None
        return torch.full((), inj.poison("offpolicy.update"), dtype=torch.float32,
                          device=self.device)

    def _guarded(self) -> tuple[dict, dict]:
        """What a :class:`~rl_tpu_torch.resilience.LastGoodState` keeps:
        the loss's live parameters and buffers (targets included), and
        Adam's live moments and count."""
        opt = self.optimizer
        return ({**dict(self.loss.named_parameters()), **dict(self.loss.named_buffers())},
                {"mu": opt.mu, "nu": opt.nu, "count": opt.count})

    def train(self, ts: dict, total_frames: int, min_frames_before_update: int | None = None,
              preemption=None, emergency=None, guard=None,
              batch_timeout: float | None = None):
        """Generator over the overlapped loop, yielding ``(ts, metrics)`` a
        consumed batch (``metrics`` None until ``min_frames_before_update``
        frames, by default ``max(init_random_frames, batch_size)``, are
        in). Starts and stops the collector; the caller owns the env pool.
        ``batch_timeout`` bounds each wait for a batch (the loop ends on a
        timeout, as when the actor thread ends).

        Resilience hooks (all optional): ``preemption`` (a
        :class:`~rl_tpu_torch.trainers.resilience.PreemptionHandler`) stops
        the loop at the next batch boundary and, with ``emergency`` (an
        :class:`~rl_tpu_torch.resilience.EmergencyCheckpointer`), writes
        the whole train state after the in-flight dispatch (parameters,
        targets, Adam, the replay, the generator, counters), so
        :meth:`emergency_restore` resumes exactly. ``guard`` (a
        :class:`~rl_tpu_torch.resilience.LastGoodState`) is fed the lagged
        ``bad_steps`` total from the metrics drain; a rollback copies the
        last good snapshot into the live parameters and Adam before the
        weights are published to the actor."""
        coll = self.collector
        fpb = coll.frames_per_batch
        min_frames = (min_frames_before_update if min_frames_before_update is not None
                      else max(self.config.init_random_frames, self.config.batch_size))
        registry = self.metrics_registry
        if registry is None and self.device_metrics is not None:
            registry = get_registry()
        coll.start()
        frames, pending = 0, None  # pending: the previous dispatch's metrics copy
        step_i = 0
        try:
            while frames < total_frames:
                fault_point("trainer.preempt")  # chaos site (synthetic preemption)
                if preemption is not None and preemption.preempted:
                    if emergency is not None:
                        self.emergency_save(emergency, ts, frames)
                    break
                t0 = time.perf_counter()
                batch = coll.get_batch(batch_timeout)
                if batch is None:
                    break
                t1 = time.perf_counter()
                ts = {**ts, "buffer": self.extend(ts["buffer"], batch)}
                frames += fpb
                t2 = t3 = time.perf_counter()
                metrics = None
                if frames >= min_frames:
                    ts, metrics = self.k_updates(ts, poison=self._poison_scalar())
                    t3 = time.perf_counter()
                    if self.device_metrics is not None:
                        # start this dispatch's copy, publish the previous one's
                        landing = DeviceMetrics.drain_async(ts["obs"])
                        if pending is not None:
                            snap = DeviceMetrics.drain(pending)
                            self.device_metrics.publish(snap, registry)
                            if guard is not None:
                                bad = self.device_metrics.to_flat(snap).get("bad_steps", 0.0)
                                restored = guard.observe(step_i, bad, *self._guarded())
                                if restored is not None:
                                    live_params, live_opt = self._guarded()
                                    restore_into(live_params, restored[0])
                                    restore_into(live_opt, restored[1])
                        pending = landing
                    coll.update_params()
                self.host_split.append({"wait": t1 - t0, "extend": t2 - t1, "dispatch": t3 - t2,
                                        "publish": time.perf_counter() - t3})
                step_i += 1
                yield ts, metrics
            if pending is not None:
                self.device_metrics.publish(DeviceMetrics.drain(pending), registry)
        finally:
            coll.stop()

    # -- emergency checkpoints ----------------------------------------------------

    def _arrays(self, ts: dict) -> dict:
        params, opt = self._guarded()
        return {"ts": ts, "loss": params, "opt": opt}

    def emergency_save(self, emergency, ts: dict, frames: int) -> str:
        """Wait for the in-flight dispatch (the actor only reads its own
        snapshot of the weights) and write the whole train state, the
        replay included, for an exact resume."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return emergency.save(int(frames), self._arrays(ts), {"frames": int(frames)})

    def emergency_restore(self, emergency, ts_template: dict, step=None):
        """Load ``(ts, frames)`` from the latest (or given) emergency
        checkpoint. ``ts_template`` is a train state from :meth:`init` with
        the same config: the saved state is written into its tensors and
        generator and into the loss and Adam, in place, so graphs captured
        over them (:meth:`aot_warmup`, before or after) stay valid."""
        arrays, meta, step = emergency.restore(self._arrays(ts_template), step)
        params, opt = self._guarded()
        restore_into(params, arrays["loss"])
        restore_into(opt, arrays["opt"])
        ts = restore_into(ts_template, arrays["ts"])
        return ts, int(meta.get("frames", step))
