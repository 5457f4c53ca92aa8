"""Decoupled host collection, Sebulba style (counterpart of
:mod:`rl_tpu.collectors.async_host`; arXiv:2104.06272).

:class:`~rl_tpu_torch.collectors.host.HostCollector` serialises the
pipeline: every env finishes its step before the batched policy call, and
the trainer cannot use the card while the host waits on the slowest
simulator. Here a background actor thread steps the env pool and batches
transitions while the caller's thread keeps the card busy with updates:

- **first-come batching**: envs are harvested as their steps complete
  (``pool.step_ready``), not in lockstep;
- **straggler cutoff**: a harvest fires once ``min_ready_fraction`` of the
  envs in flight are done, or after ``straggler_wait_s``; slow envs join
  a later batch;
- **bounded queue**: batches go through ``queue.Queue(max_pending_batches)``;
  a full queue parks the actor thread (backpressure);
- **per-item stamps**: every transition records the ``policy_version`` it
  was acted with, its env id and a global step counter under
  ``("collector", ...)``, which ``StalenessAwareSampler`` reads on write.

Three things the reference gets from JAX's immutable arrays are explicit
here. The trainer updates the policy's weights in place, so
:meth:`AsyncHostCollector.update_params` hands the actor thread a
*snapshot*: a copy made on the caller's stream with a CUDA event recorded
after it; the actor takes the snapshot and its version together under a
lock and waits on the event on its own stream. The actor's policy call
runs on its own ``torch.cuda.Stream``, so reading its actions back waits
for the policy call and not for the trainer's queued work. And it draws
only from its own ``torch.Generator``, never the default CUDA one, which
a graph capture registers.
"""

from __future__ import annotations

import contextlib
import copy
import math
import queue
import threading
import time
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..data.arraydict import ArrayDict
from ..obs.registry import get_registry
from ..obs.trace import carry_context, get_tracer
from .host import seed_generator, stack_obs

__all__ = ["AsyncHostCollector"]


class AsyncHostCollector:
    """Background-thread collector over a host env pool.

    ``policy``: ``(td, generator) -> td`` over the batched observations,
    on ``device`` (default: the card); ``None`` takes uniform actions from
    the action spec. An ``nn.Module`` policy runs as the actor thread's
    own copy (made at :meth:`start`), loaded from snapshots of the
    module's parameters and buffers (:meth:`update_params`); any other
    callable runs as it is and must not read weights that a trainer
    updates in place. Batches are
    flat ``[frames_per_batch]`` ArrayDicts on the host in the ``{...,
    "next": ...}`` layout, with the ``("collector", "policy_version" |
    "env_ids" | "step")`` stamps (int32)::

        collector = AsyncHostCollector(pool, actor, frames_per_batch=256)
        collector.start()
        for batch in collector.batches(total_frames=10_000):
            bstate = write(bstate, batch)      # ReplayBuffer.make_extend
            ts, _ = k_updates(ts)              # the card runs; envs step
            collector.update_params()          # a new snapshot and version
        collector.stop()
    """

    def __init__(self, pool: Any, policy: Callable | None = None, frames_per_batch: int = 256,
                 seed: int = 0, max_pending_batches: int = 2, min_ready_fraction: float = 0.5,
                 straggler_wait_s: float = 0.01, poll_interval_s: float = 2e-4,
                 registry: Any = None, supervisor: Any = None, device=None):
        if supervisor is not None:
            raise NotImplementedError(
                "AsyncHostCollector(supervisor=...) is not ported to rl_tpu_torch yet "
                "(ROADMAP A5: resilience)")
        self.device = resolve_device(device)
        self.pool = pool
        self.policy = policy
        self.frames_per_batch = frames_per_batch
        self.max_pending_batches = max_pending_batches
        self.min_ready_fraction = min_ready_fraction
        self.straggler_wait_s = straggler_wait_s
        self.poll_interval_s = poll_interval_s
        self._seed = seed
        self._queue: queue.Queue = queue.Queue(maxsize=max_pending_batches)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        # the weights handoff: (snapshot, event) and its version, together
        # under the lock; the actor takes both at each send phase
        self._lock = threading.Lock()
        self._params: tuple | None = None
        self._version = 0
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self._stream = None
        self._actor_policy: nn.Module | None = None
        self._loaded: tuple | None = None  # the snapshot the actor's module holds
        # stats (written by the actor thread; readers tolerate slight races)
        self._env_steps = 0
        self._batches_emitted = 0
        self._harvests = 0
        self._straggler_cutoffs = 0
        self._max_queue_depth = 0
        self._tracer = get_tracer()
        self.registry = registry if registry is not None else get_registry()
        p, reg = "rl_tpu_collector", self.registry
        self._m_env_steps = reg.counter(f"{p}_env_steps_total", "env transitions harvested")
        self._m_batches = reg.counter(f"{p}_batches_total", "batches emitted to the trainer")
        self._m_harvests = reg.counter(f"{p}_harvests_total", "harvest sweeps")
        self._m_cutoffs = reg.counter(f"{p}_straggler_cutoffs_total",
                                      "harvests fired before every in-flight env finished")
        self._m_queue = reg.gauge(f"{p}_queue_depth", "completed batches awaiting the trainer")
        self._m_version = reg.gauge(f"{p}_policy_version", "latest published policy version")
        self._m_staleness = reg.histogram(
            f"{p}_staleness", "policy-version lag of emitted transitions",
            buckets=(0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0))
        self._m_harvest_s = reg.histogram(
            f"{p}_harvest_seconds", "time between consecutive harvest sweeps",
            buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0))

    # -- lifecycle ------------------------------------------------------------

    def start(self, params=None, generator: torch.Generator | None = None
              ) -> "AsyncHostCollector":
        """Start the actor thread on a snapshot of ``params`` (see
        :meth:`update_params`); ``generator`` replaces the collector's own
        (seeded with ``seed``) for the policy's draws."""
        if self._thread is not None:
            raise RuntimeError("AsyncHostCollector already started")
        if isinstance(self.policy, nn.Module):  # the actor thread's own module
            self._actor_policy = copy.deepcopy(self.policy).requires_grad_(False)
            self._loaded = None
        self._params = self._snapshot(params)  # its event also covers the copy above
        if generator is not None:
            self._generator = generator
        if self.device.type == "cuda" and self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        self._error = None
        self._stop.clear()
        self._thread = threading.Thread(target=carry_context(self._run),
                                        name="rl-tpu-async-collector", daemon=True)
        self._thread.start()
        return self

    def _alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def stop(self) -> None:
        """Stop the actor thread (joined for 10 s at most) and drop the
        batches it left in the queue."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break

    def __enter__(self):
        if self._thread is None:
            self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- trainer-facing API ---------------------------------------------------

    def _snapshot(self, params) -> tuple | None:
        """A device copy of ``params`` (a mapping of the policy module's
        parameter and buffer names; default: the module's own, live) on
        the current stream, and a CUDA event recorded after it."""
        if not isinstance(self.policy, nn.Module):
            return None
        if params is None:
            params = {**dict(self.policy.named_parameters()),
                      **dict(self.policy.named_buffers())}
        with torch.no_grad():
            snap = {k: v.detach().clone() for k, v in dict(params).items()}
        event = None
        if any(v.is_cuda for v in snap.values()):
            event = torch.cuda.Event()
            event.record()
        return snap, event

    def update_params(self, params=None, version: int | None = None) -> None:
        """Publish new policy weights: a snapshot of ``params`` (default:
        the policy module's current parameters and buffers), taken on the
        caller's stream. Transitions acted on it carry the bumped
        ``policy_version`` (or ``version``)."""
        snap = self._snapshot(params)
        with self._lock:
            self._params = snap
            self._version = self._version + 1 if version is None else int(version)

    @property
    def policy_version(self) -> int:
        return self._version

    def get_batch(self, timeout: float | None = None) -> ArrayDict | None:
        """The next completed batch (first-come order), or None on
        ``timeout`` or when the actor thread has ended. Re-raises a
        failure of the actor thread."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._error is not None:
                raise RuntimeError("AsyncHostCollector actor thread failed") from self._error
            try:
                return self._queue.get(timeout=0.05)
            except queue.Empty:
                if not self._alive():
                    if self._error is not None:
                        continue
                    return None
                if deadline is not None and time.monotonic() >= deadline:
                    return None

    def batches(self, total_frames: int):
        """Batches until ``total_frames`` transitions were delivered."""
        delivered = 0
        while delivered < total_frames:
            b = self.get_batch()
            if b is None:
                return
            delivered += self.frames_per_batch
            yield b

    def stats(self) -> dict:
        return {"env_steps": self._env_steps, "batches_emitted": self._batches_emitted,
                "harvests": self._harvests, "straggler_cutoffs": self._straggler_cutoffs,
                "policy_version": self._version, "queue_depth": self._queue.qsize(),
                "max_queue_depth": self._max_queue_depth}

    # -- actor thread ---------------------------------------------------------

    def _actions_for(self, obs: list[dict]) -> tuple[np.ndarray, int]:
        """One batched policy call over every env's current observation (a
        fixed ``[n]`` shape); rows of envs still stepping are dropped by
        the caller."""
        n = self.pool.num_envs
        with self._lock:
            params, version = self._params, self._version
        stream = (torch.cuda.stream(self._stream) if self._stream is not None
                  else contextlib.nullcontext())
        with stream, torch.no_grad():
            if self.policy is None:
                return self.pool.action_spec.rand((n,), self._generator).cpu().numpy(), version
            td = stack_obs(obs, self.device)
            if params is None:
                out = self.policy(td, self._generator)
            else:
                if params is not self._loaded:  # a new snapshot: load it on this stream
                    weights, event = params
                    if event is not None:
                        self._stream.wait_event(event)
                    own = {**dict(self._actor_policy.named_parameters()),
                           **dict(self._actor_policy.named_buffers())}
                    for name, t in weights.items():
                        own[name].copy_(t)
                        if t.is_cuda:
                            t.record_stream(self._stream)
                    self._loaded = params
                out = self._actor_policy(td, self._generator)
            actions = out["action"].cpu().numpy()
        return actions, version

    def _run(self) -> None:
        self._pending: list[bool] = []
        try:
            self._collect_loop()
        except BaseException as e:  # surfaced to the trainer by get_batch
            self._error = e
        finally:  # no env is left stepping, so a restart's reset races nothing
            for i, busy in enumerate(self._pending):
                if busy:
                    self.pool.async_step_recv(i)

    def _collect_loop(self) -> None:
        pool = self.pool
        n = pool.num_envs
        min_ready = max(1, math.ceil(self.min_ready_fraction * n))
        obs = pool.reset(seed=self._seed)
        self._pending = pending = [False] * n
        sent_action = [None] * n
        sent_obs: list[dict | None] = [None] * n
        sent_version = [0] * n
        needs_send = list(range(n))
        records: list[tuple] = []
        last_harvest = time.monotonic()

        while not self._stop.is_set():
            # send: an action to every env holding a fresh observation
            if needs_send:
                actions, version = self._actions_for(obs)
                for i in needs_send:
                    sent_action[i], sent_obs[i], sent_version[i] = actions[i], obs[i], version
                    pool.async_step_send(i, actions[i])
                    pending[i] = True
                needs_send = []

            # harvest: first-come, with the straggler cutoff
            ready = [i for i in range(n) if pending[i] and pool.step_ready(i)]
            in_flight = sum(pending)
            now = time.monotonic()
            if not ready or (len(ready) < min(min_ready, in_flight)
                             and now - last_harvest < self.straggler_wait_s):
                time.sleep(self.poll_interval_s)
                continue
            if len(ready) < in_flight:
                self._straggler_cutoffs += 1
                self._m_cutoffs.inc()
                self._tracer.instant("straggler_cutoff",
                                     {"ready": len(ready), "in_flight": in_flight})
            self._harvests += 1
            self._m_harvest_s.observe(now - last_harvest)
            last_harvest = now

            for i in ready:
                next_obs, reward, term, trunc = pool.async_step_recv(i)[:4]
                pending[i] = False
                records.append((sent_obs[i], sent_action[i], next_obs, np.float32(reward),
                                bool(term), bool(trunc), sent_version[i], i, self._env_steps))
                self._env_steps += 1
                if term or trunc:
                    self._seed = seed_generator(self._seed)
                    obs[i] = pool.reset_one(i, self._seed)
                else:
                    obs[i] = next_obs
                needs_send.append(i)

            # emit: full batches through the bounded queue
            while len(records) >= self.frames_per_batch:
                with self._tracer.span("collector/emit_batch"):
                    batch = self._build_batch(records[: self.frames_per_batch])
                records = records[self.frames_per_batch:]
                if not self._put(batch):
                    return

    def _put(self, batch: ArrayDict) -> bool:
        """Blocking put that gives way to ``stop``: the backpressure point."""
        while not self._stop.is_set():
            try:
                self._queue.put(batch, timeout=0.05)
                depth = self._queue.qsize()
                self._max_queue_depth = max(self._max_queue_depth, depth)
                self._m_queue.set(depth)
                return True
            except queue.Full:
                continue
        return False

    def _build_batch(self, recs: list[tuple]) -> ArrayDict:
        def col(j, dtype=None):
            return torch.from_numpy(np.asarray([r[j] for r in recs], dtype))

        td = stack_obs([r[0] for r in recs]).set(
            "action", torch.from_numpy(np.stack([r[1] for r in recs])))
        term, trunc = col(4, bool), col(5, bool)
        next_td = stack_obs([r[2] for r in recs]).update(ArrayDict(
            reward=col(3, np.float32), terminated=term, truncated=trunc, done=term | trunc))
        versions = np.asarray([r[6] for r in recs], np.int32)
        stamps = ArrayDict(policy_version=torch.from_numpy(versions), env_ids=col(7, np.int32),
                           step=col(8, np.int32))
        self._batches_emitted += 1
        self._m_staleness.observe_many(self._version - versions)
        self._m_env_steps.set_total(self._env_steps)
        self._m_batches.set_total(self._batches_emitted)
        self._m_harvests.set_total(self._harvests)
        self._m_version.set(self._version)
        return td.set("next", next_td).set("collector", stamps)
