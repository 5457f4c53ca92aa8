"""Host-env collection: env pools stepped on the host, one batched policy
call on the device (counterpart of :mod:`rl_tpu.collectors.host`).

For simulators that cannot run as tensor programs: N host envs step in a
thread pool (or in worker processes), their observations are stacked into
ONE policy call on the device (the inference-server pattern), and the
actions go back to the envs. A host env has ``reset(seed=) -> {name:
array}``, ``step(action) -> (obs, reward, terminated, truncated, ...)``,
``observation_spec`` (a :class:`~rl_tpu_torch.data.specs.Composite`),
``action_spec`` and ``close()``.

:class:`HostCollector` produces time-major ``[T, N, ...]`` batches in the
``{..., "next": ...}`` layout on its device, so the losses and estimators
are those of the device collector. ``policy`` is ``(td, generator) ->
td`` writing "action", as in :mod:`rl_tpu_torch.collectors.single`.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

import numpy as np
import torch

from .. import resolve_device
from ..data.arraydict import ArrayDict

__all__ = ["ThreadedEnvPool", "ProcessEnvPool", "HostCollector", "compact_collected"]

_WORKER_WAIT_S = 60.0  # the longest wait for a worker process's first answer


def seed_generator(seed: int) -> int:
    """Hash-chain successor of an integer seed (the reference's
    ``rl_tpu.utils.seeding.seed_generator``): each env of a pool, and
    each auto-reset, takes the next seed of the chain."""
    max_seed_val = (2**32) - 1
    rng = np.random.default_rng(seed % max_seed_val)
    return int(rng.integers(0, max_seed_val, dtype=np.uint32))


def _process_env_worker(env_fn, conn):
    """One env per process, driven by commands over the pipe."""
    env = env_fn()
    try:
        while True:
            cmd, arg = conn.recv()
            if cmd == "reset":
                conn.send(env.reset(seed=arg))
            elif cmd == "step":
                conn.send(env.step(arg))
            elif cmd == "specs":
                conn.send((env.observation_spec, env.action_spec))
            elif cmd == "close":
                try:
                    env.close()
                finally:
                    conn.send(None)
                break
    except (EOFError, KeyboardInterrupt):
        pass


class ProcessEnvPool:
    """N host envs in worker processes, for Python-heavy simulators that
    hold the GIL (:class:`ThreadedEnvPool` covers those that release it).
    Same surface as :class:`ThreadedEnvPool`.

    The workers step numpy envs only. With ``ctx="fork"`` (the default) a
    worker is a copy of this process: one forked after CUDA was
    initialised here must never touch ``torch.cuda`` (nor build a tensor
    on the card), which fails or hangs in a forked child. Use
    ``ctx="spawn"`` with picklable top-level ``env_fns`` for envs that
    need more."""

    def __init__(self, env_fns, ctx: str = "fork"):
        import multiprocessing as mp

        mctx = mp.get_context(ctx)
        self.num_envs = len(env_fns)
        self._conns = []
        self._procs = []
        for fn in env_fns:
            parent, child = mctx.Pipe()
            p = mctx.Process(target=_process_env_worker, args=(fn, child), daemon=True)
            p.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(p)
        self._conns[0].send(("specs", None))
        if not self._conns[0].poll(_WORKER_WAIT_S):
            self.close()
            raise RuntimeError(f"ProcessEnvPool: no worker answered in {_WORKER_WAIT_S} s")
        self.observation_spec, self.action_spec = self._conns[0].recv()

    def reset(self, seed: int = 0) -> list[dict]:
        s = seed
        for c in self._conns:
            c.send(("reset", s))
            s = seed_generator(s)
        return [c.recv() for c in self._conns]

    def async_step_send(self, i: int, action) -> None:
        self._conns[i].send(("step", action))

    def async_step_recv(self, i: int):
        return self._conns[i].recv()

    def step_ready(self, i: int) -> bool:
        """Non-blocking: has worker ``i``'s step finished? (first-come
        harvests leave stragglers cooking)."""
        return self._conns[i].poll()

    def step_wait(self, actions) -> list[tuple]:
        for i in range(self.num_envs):
            self.async_step_send(i, actions[i])
        return [self.async_step_recv(i) for i in range(self.num_envs)]

    def reset_one(self, i: int, seed: int) -> dict:
        self._conns[i].send(("reset", seed))
        return self._conns[i].recv()

    def alive(self) -> list[bool]:
        return [p.is_alive() for p in self._procs]

    def close(self) -> None:
        for c in self._conns:
            try:
                c.send(("close", None))
                if c.poll(5):
                    c.recv()
            except (BrokenPipeError, EOFError, OSError):
                pass
            c.close()
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)


class ThreadedEnvPool:
    """N host envs stepped concurrently in a thread pool (envs whose
    physics releases the GIL overlap; others still overlap with the
    device). ``async_step_send``/``async_step_recv``/``step_ready`` are
    the out-of-sync protocol; ``step_wait`` the barrier form."""

    def __init__(self, env_fns: list[Callable[[], Any]], num_threads: int | None = None):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self._pool = ThreadPoolExecutor(max_workers=num_threads or self.num_envs)
        self._futures: list = [None] * self.num_envs

    @property
    def observation_spec(self):
        return self.envs[0].observation_spec

    @property
    def action_spec(self):
        return self.envs[0].action_spec

    def reset(self, seed: int = 0) -> list[dict]:
        seeds, s = [], seed
        for _ in range(self.num_envs):
            seeds.append(s)
            s = seed_generator(s)
        return list(self._pool.map(lambda ev_s: ev_s[0].reset(seed=ev_s[1]),
                                   zip(self.envs, seeds)))

    def async_step_send(self, i: int, action) -> None:
        self._futures[i] = self._pool.submit(self.envs[i].step, action)

    def async_step_recv(self, i: int):
        out = self._futures[i].result()
        self._futures[i] = None
        return out

    def step_ready(self, i: int) -> bool:
        fut = self._futures[i]
        return fut is not None and fut.done()

    def step_wait(self, actions) -> list[tuple]:
        for i in range(self.num_envs):
            self.async_step_send(i, actions[i])
        return [self.async_step_recv(i) for i in range(self.num_envs)]

    def reset_one(self, i: int, seed: int) -> dict:
        return self.envs[i].reset(seed=seed)

    def close(self) -> None:
        for e in self.envs:
            e.close()
        self._pool.shutdown(wait=True, cancel_futures=True)


def stack_obs(obs_list: list[dict], device=None) -> ArrayDict:
    """Host observations (dicts of arrays) stacked into one ArrayDict."""
    return ArrayDict({k: torch.from_numpy(np.stack([o[k] for o in obs_list])).to(device)
                      for k in obs_list[0].keys()})


class HostCollector:
    """Batches from a host env pool, the policy called once a step over
    every env's observation on ``device`` (default: the card). ``policy``
    is ``(td, generator) -> td``; ``None`` takes uniform actions from the
    pool's action spec. Finished envs are reset on the host (the seed
    chain of :func:`seed_generator` from ``seed``): "next" holds the
    terminal step, the carry restarts. With an ``interruptor``
    (``start_collection()``, ``collection_stopped()``) a batch cut short is
    padded to its full ``[T, N]`` by repeating its last step, the cut
    marked truncated and done, and ``"collected_mask"`` marks the real
    rows; every batch then carries the mask."""

    def __init__(self, pool, policy: Callable | None = None, frames_per_batch: int = 1024,
                 seed: int = 0, interruptor: Any = None, device=None):
        self.device = resolve_device(device)
        self.pool = pool
        self.interruptor = interruptor
        self.policy = policy
        n = pool.num_envs
        if frames_per_batch % n:
            raise ValueError(f"frames_per_batch={frames_per_batch} not divisible by {n} envs")
        self.scan_length = frames_per_batch // n
        self.frames_per_batch = frames_per_batch
        self._seed = seed
        self._obs: list[dict] | None = None
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    @torch.no_grad()
    def collect(self, generator: torch.Generator | None = None) -> ArrayDict:
        """One ``[T, N]`` batch; the policy's draws come from ``generator``
        (default: the collector's own, seeded with ``seed``)."""
        gen = generator if generator is not None else self.generator
        n = self.pool.num_envs
        if self._obs is None:
            self._obs = self.pool.reset(seed=self._seed)
        if self.interruptor is not None:
            self.interruptor.start_collection()  # re-armed a batch: it cuts one short
        steps = []
        for _ in range(self.scan_length):
            if steps and self.interruptor is not None and self.interruptor.collection_stopped():
                break
            td = stack_obs(self._obs, self.device)
            if self.policy is None:
                td = td.set("action", self.pool.action_spec.rand((n,), gen))
            else:
                td = self.policy(td, gen)
            results = self.pool.step_wait(td["action"].cpu().numpy())
            next_obs = [r[0] for r in results]
            term = np.asarray([r[2] for r in results], bool)
            trunc = np.asarray([r[3] for r in results], bool)
            flags = {"reward": np.asarray([r[1] for r in results], np.float32),
                     "terminated": term, "truncated": trunc, "done": term | trunc}
            next_td = stack_obs(next_obs, self.device).update(ArrayDict(
                {k: torch.from_numpy(v).to(self.device) for k, v in flags.items()}))
            steps.append(td.set("next", next_td))
            carry = list(next_obs)  # host auto-reset: the carry restarts
            for i in np.flatnonzero(flags["done"]):
                self._seed = seed_generator(self._seed)
                carry[i] = self.pool.reset_one(int(i), self._seed)
            self._obs = carry
        if self.interruptor is None:
            return ArrayDict.stack(steps, 0)
        mask = torch.zeros((self.scan_length, n), dtype=torch.bool, device=self.device)
        mask[: len(steps)] = True
        if len(steps) < self.scan_length:
            # the cut is truncated and done, so a value estimate stops there
            # and the padded rows cannot bootstrap into the real ones
            cut = torch.ones(n, dtype=torch.bool, device=self.device)
            steps[-1] = steps[-1].set(("next", "truncated"), cut).set(("next", "done"), cut)
            steps += [steps[-1]] * (self.scan_length - len(steps))
        return ArrayDict.stack(steps, 0).set("collected_mask", mask)

    def iterate(self, total_frames: int, generator: torch.Generator | None = None):
        """Batches until ``total_frames`` frames were collected."""
        collected = 0
        while collected < total_frames:
            yield self.collect(generator)
            collected += self.frames_per_batch


def compact_collected(batch: ArrayDict) -> ArrayDict:
    """Drop the padded rows of an interrupted ``[T, N]``
    :class:`HostCollector` batch (and the mask), keeping whole time rows,
    so padding never enters a replay buffer; a full batch only loses the
    mask. On the host: the result's shape depends on the mask."""
    if "collected_mask" not in batch:
        return batch
    mask = batch["collected_mask"]
    rest = batch.exclude("collected_mask")
    if bool(mask.all()):
        return rest
    rows = torch.nonzero(mask.any(dim=1))[:, 0]
    return rest.apply(lambda x: x[rows])
