"""The graphs of the overlapped host-env trainer: the five other samplers'
``sample`` and ``on_write``, ``AsyncOffPolicyTrainer``'s
``offpolicy.k_updates`` and the chunk write ``replay.extend``.

On the CPU each body runs under ``test_torch_registry.py``'s dispatch
mode that fails on a read of a tensor's value on the host (these cases
extend ``test_torch_graph_programs.py``'s host-read guard; they live in a
file of their own so that the test files' sizes, and with them xdist's
``loadfile`` queue, stay as they were). The ``cuda`` case captures both
programs on the card with ``aot_warmup`` and holds three rounds of
replays to an eager copy bit for bit; it skips here. No JAX."""

import numpy as np
import pytest
import torch
from test_torch_registry import _assert_trees_equal, _NoHostReads

from rl_tpu_torch.collectors import AsyncHostCollector, ThreadedEnvPool
from rl_tpu_torch.compile import ExecutableStore, ProgramRegistry
from rl_tpu_torch.data import (ArrayDict, DeviceStorage, PrioritizedSampler,
                               PrioritizedSliceSampler, ReplayBuffer, SamplerWithoutReplacement,
                               SliceSampler, SliceSamplerWithoutReplacement, StalenessAwareSampler)
from rl_tpu_torch.data.replay import samplers as samplers_mod
from rl_tpu_torch.data.specs import Bounded, Composite, Unbounded
from rl_tpu_torch.modules import (MLP, ConcatMLP, NormalParamExtractor, ProbabilisticActor,
                                  TanhNormal, TDModule, TDSequential)
from rl_tpu_torch.objectives import SACLoss
from rl_tpu_torch.obs import MetricsRegistry
from rl_tpu_torch.trainers import AsyncOffPolicyTrainer, OffPolicyConfig

torch.set_num_threads(1)


class _NoiseEnv:
    """A host env of 3-d noise observations and a 1-d action in [-2, 2]."""

    def __init__(self, seed=0):
        self._rng = np.random.default_rng(seed)

    observation_spec = Composite(observation=Unbounded((3,)))
    action_spec = Bounded(shape=(1,), low=-2.0, high=2.0)

    def reset(self, seed=0):
        self._rng = np.random.default_rng(seed)
        return {"observation": self._rng.normal(size=3).astype(np.float32)}

    def step(self, action):
        obs = {"observation": self._rng.normal(size=3).astype(np.float32)}
        return obs, float(-np.square(action).sum()), False, False

    def close(self):
        pass


def _async_sac(device, sampler=None, utd_ratio=2, registry=None):
    """``AsyncOffPolicyTrainer`` with SAC (MLPs of 32), batch 16, a
    256-slot replay sampled by ``sampler`` (default PER with "td_error"),
    chunks of 32, its device metrics on; and a replay state holding 3
    chunks of fixed items (random numbers from a seed)."""
    actor = ProbabilisticActor(
        TDSequential(TDModule(MLP(out_features=2, num_cells=(32, 32)), ["observation"], ["raw"]),
                     TDModule(NormalParamExtractor(), ["raw"], ["loc", "scale"])),
        TanhNormal, dist_kwargs={"low": -2.0, "high": 2.0})
    loss = SACLoss(actor, ConcatMLP(out_features=1, num_cells=(32, 32)))
    sampler = sampler or PrioritizedSampler()
    coll = AsyncHostCollector(ThreadedEnvPool([_NoiseEnv]), loss.actor, frames_per_batch=32,
                              registry=MetricsRegistry(), device=device)
    tr = AsyncOffPolicyTrainer(
        coll, loss, ReplayBuffer(DeviceStorage(256), sampler),
        OffPolicyConfig(batch_size=16, utd_ratio=utd_ratio), device_metrics=True,
        priority_key="td_error" if isinstance(sampler, PrioritizedSampler) else None,
        device=device, registry=registry or ProgramRegistry(ExecutableStore()))
    ts = tr.init(seed=0)
    gen = torch.Generator().manual_seed(5)
    for c in range(3):
        items = tr.example_item().unsqueeze(0).apply(
            lambda x: torch.zeros((32,) + tuple(x.shape[1:]), dtype=x.dtype).to(device))
        items = items.named_apply(lambda path, x: (
            torch.randn(x.shape, generator=gen).to(x.device) if x.is_floating_point()
            else x.fill_(c)))
        ts = {**ts, "buffer": tr.extend._write(ts["buffer"], items)}
    return tr, ts


def _slice_items(n, c):
    return ArrayDict(x=torch.arange(n, dtype=torch.float32) + c,
                     collector=ArrayDict(traj_ids=(torch.arange(n) + c * n) // 7,
                                         policy_version=torch.full((n,), c)))


@pytest.mark.parametrize("body", ["samplers", "k_updates", "extend_chunk"])
def test_async_bodies_read_nothing_on_the_host(body, monkeypatch):
    """Each sampler's ``on_write`` (with and without stamps and ids) and
    ``sample`` (from its generator and on fed draws); the K-update and the
    chunk write of trainers whose replay is sampled by PER, the staleness
    sampler and a slice sampler."""
    if body == "samplers":
        size, gen, ok = torch.tensor(40), torch.Generator().manual_seed(0), torch.tensor(True)
        fed = {"without_replacement": torch.randperm(64),
               "slice_without_replacement": torch.randperm(64),
               "staleness": (torch.rand(16), torch.rand(16)),
               "slice": torch.randint(0, 37, (4, 8)), "prioritized_slice": torch.rand(4)}
        for name, s in (("without_replacement", SamplerWithoutReplacement()),
                        ("staleness", StalenessAwareSampler(max_staleness=2)),
                        ("slice", SliceSampler(4)),
                        ("slice_without_replacement", SliceSamplerWithoutReplacement(4)),
                        ("prioritized_slice", PrioritizedSliceSampler(4))):
            st = s.init(64)
            with _NoHostReads():
                for c in range(2):
                    st = s.on_write(st, torch.arange(c * 20, c * 20 + 20), _slice_items(20, c))
                st = s.on_write(st, torch.arange(40, 44), ArrayDict())  # no stamps, no ids
                for u in (None, fed[name]):
                    idx, info, st = s.sample(st, gen, 16, size, 64, u=u)
                st = s.update_priority(st, idx, idx.float(), ok=ok)
        return

    # B7's plain version reads on the host (the card launches the kernel)
    def scatter_adds(priorities, esum, idx, delta, *, fanout):
        priorities.index_add_(0, idx, delta)
        esum.index_add_(0, idx // fanout, delta)
        return priorities, esum

    monkeypatch.setattr(samplers_mod, "sumtree_update", scatter_adds)
    for sampler in (None, StalenessAwareSampler(), SliceSamplerWithoutReplacement(4)):
        tr, ts = _async_sac("cpu", sampler)
        try:
            if body == "k_updates":
                with _NoHostReads():
                    tr.k_program.fn(tr._inner(ts))
            else:
                items = ts["buffer"]["storage", "data"][torch.arange(32)]
                with _NoHostReads():
                    tr.extend.program.fn(ts["buffer"], items)
        finally:
            tr.collector.pool.close()


@pytest.mark.cuda
def test_async_k_updates_replay_equal_to_eager_on_the_card():
    """Two trainers built alike on the card: one writes host chunks through
    ``replay.extend`` (pinned, ``non_blocking``) and dispatches
    ``offpolicy.k_updates`` (PER through B7) as graphs captured once by
    ``aot_warmup``, the other runs both bodies eagerly; state, metrics,
    parameters, targets and Adam equal bit for bit over three rounds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    registry = ProgramRegistry(ExecutableStore())
    (eager, ts_e), (graphed, ts_g) = _async_sac(dev), _async_sac(dev, registry=registry)
    try:
        graphed.aot_warmup(ts_g)
        gen = torch.Generator().manual_seed(9)
        for _ in range(3):
            items = ts_e["buffer"]["storage", "data"][torch.arange(32, device=dev)].apply(
                lambda x: (x + torch.randn(x.shape, generator=gen).to(dev)).to(x.dtype).cpu())
            ts_e = {**ts_e, "buffer": eager.extend._write(ts_e["buffer"], items.to(dev))}
            ts_g = {**ts_g, "buffer": graphed.extend(ts_g["buffer"], items)}
            inner, m_e = eager.updates(eager._inner(ts_e))
            ts_e = {**ts_e, **inner, "update_count": ts_e["update_count"] + 2}
            ts_g, m_g = graphed.k_updates(ts_g)
            _assert_trees_equal((m_g, ts_g), (m_e, ts_e))
            for a, b in zip(eager._hidden_state(), graphed._hidden_state()):
                assert torch.equal(a, b)
        stats = registry.stats()
        for name in ("offpolicy.k_updates", "replay.extend"):
            assert stats[name]["compiles"] == stats[name]["executables"] == 1
            assert stats[name]["replays"] == 3
    finally:
        for tr in (eager, graphed):
            tr.collector.pool.close()
