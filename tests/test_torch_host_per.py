"""The port's ``HostPrioritizedSampler`` (host segment trees serving a
device learner) against the reference's.

The reference sampler runs on its own numpy trees
(``rl_tpu.csrc._NumpySumTree`` and ``_NumpyMinTree``, patched into
``rl_tpu.data.replay.host_per``): its C++ tree is never built here
(``tests/test_csrc.py`` holds that tree to the same numpy bodies). The
port gets the reference's uniform draws fed, and must return the same
indices and weights within 1e-6 relative. Then the device-vs-host
distribution parity of ``tests/test_async_offpolicy.py`` between the
port's two samplers, and the host sampler inside ``OffPolicyProgram``
(DQN on CartPole, SAC on Pendulum) on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import rl_tpu.data.replay.host_per as ref_host_per
import torch
from rl_tpu.csrc import _NumpyMinTree, _NumpySumTree
from test_torch_off_policy_parts import port_sac

from rl_tpu_torch.collectors import Collector
from rl_tpu_torch.data import (ArrayDict, DeviceStorage, HostPrioritizedSampler,
                               PrioritizedSampler, ReplayBuffer)
from rl_tpu_torch.envs import CartPoleEnv, PendulumEnv, VmapEnv
from rl_tpu_torch.envs.transforms import RewardSum, TransformedEnv
from rl_tpu_torch.trainers import OffPolicyConfig, OffPolicyProgram, make_dqn_trainer

KEY = jax.random.key(0)


@pytest.fixture
def ref_sampler(monkeypatch):
    monkeypatch.setattr(ref_host_per, "SumSegmentTree", _NumpySumTree)
    monkeypatch.setattr(ref_host_per, "MinSegmentTree", _NumpyMinTree)
    return ref_host_per.HostPrioritizedSampler


@pytest.mark.parametrize("alpha,beta,cap,size", [(0.6, 0.4, 64, 64), (1.0, 1.0, 100, 37),
                                                 (0.7, 0.5, 4096, 3000)])
def test_indices_and_weights_match_the_reference(ref_sampler, alpha, beta, cap, size):
    rng = np.random.default_rng(cap)
    ref, ours = ref_sampler(alpha=alpha, beta=beta), HostPrioritizedSampler(alpha=alpha, beta=beta)
    rs, ps = ref.init(cap), ours.init(cap, "cpu")
    rs = ref.on_write(rs, np.arange(size), None)
    ps = ours.on_write(ps, torch.arange(size), None)
    for step in range(6):
        idx = rng.integers(0, size, 50)  # duplicates: the last write wins
        prio = rng.normal(0.0, 2.0, 50).astype(np.float32)
        rs = ref.update_priority(rs, idx, prio)
        ps = ours.update_priority(ps, torch.from_numpy(idx), torch.from_numpy(prio))
        if step % 2:
            new = rng.integers(0, cap, 8)
            rs = ref.on_write(rs, new, None)
            ps = ours.on_write(ps, torch.from_numpy(new), None)
        key = jax.random.fold_in(KEY, step)
        u = np.array(jax.random.uniform(key, (256,)))
        ridx, rinfo, _ = ref.sample(rs, key, 256, jnp.asarray(size), cap)
        pidx, pinfo, _ = ours.sample(ps, None, 256, torch.tensor(size), cap,
                                     u=torch.from_numpy(u))
        assert pidx.dtype == torch.int64 and pinfo["_weight"].dtype == torch.float32
        np.testing.assert_array_equal(pidx.numpy(), np.asarray(ridx))
        np.testing.assert_array_equal(pinfo["index"].numpy(), np.asarray(rinfo["index"]))
        np.testing.assert_allclose(pinfo["_weight"].numpy(), np.asarray(rinfo["_weight"]),
                                   rtol=1e-6)
    assert ours._max_priority == ref._max_priority


def test_trees_match_the_reference_after_writes(ref_sampler):
    ref, ours = ref_sampler(), HostPrioritizedSampler()
    ref.init(32), ours.init(32)
    ref.on_write(None, np.arange(20), None)
    ours.on_write(None, torch.arange(20), None)
    ref.update_priority(None, np.array([3, 5, 3]), np.array([0.5, -4.0, 2.0]))
    ours.update_priority(None, torch.tensor([3, 5, 3]), torch.tensor([0.5, -4.0, 2.0]))
    for a, b in ((ours._sum, ref._sum), (ours._min, ref._min)):
        np.testing.assert_allclose(a[np.arange(32)], b[np.arange(32)], rtol=1e-12)
        np.testing.assert_allclose(a.reduce(0, 20), b.reduce(0, 20), rtol=1e-12)


def test_a_false_ok_leaves_the_trees_alone():
    s = HostPrioritizedSampler()
    s.init(8)
    s.on_write(None, torch.arange(8), None)
    before = s._sum[np.arange(8)].copy()
    s.update_priority(None, torch.arange(4), torch.full((4,), 50.0), ok=torch.tensor(False))
    np.testing.assert_array_equal(s._sum[np.arange(8)], before)
    assert s._max_priority == 1.0
    s.update_priority(None, torch.arange(4), torch.full((4,), 50.0), ok=torch.tensor(True))
    assert s._max_priority > 50.0 and s._sum[0] > before[0]


def test_draws_come_from_the_generator():
    s = HostPrioritizedSampler()
    s.init(64)
    s.on_write(None, torch.arange(64), None)
    s.update_priority(None, torch.arange(64), torch.linspace(0.1, 3.0, 64))
    g = torch.Generator().manual_seed(5)
    copy = torch.Generator().manual_seed(5)
    idx, info, _ = s.sample(None, g, 32, torch.tensor(64), 64)
    u = torch.rand(32, generator=copy)
    fed, finfo, _ = s.sample(None, None, 32, torch.tensor(64), 64, u=u)
    torch.testing.assert_close(idx, fed, rtol=0, atol=0)
    torch.testing.assert_close(info["_weight"], finfo["_weight"], rtol=0, atol=0)
    again, _, _ = s.sample(None, g, 32, torch.tensor(64), 64)
    assert not torch.equal(idx, again)


def test_device_and_host_samplers_draw_the_same_distribution():
    """``tests/test_async_offpolicy.py``'s parity between the port's two
    samplers: each within 0.06 (L1) of the exact PER distribution over
    131072 draws in 256 cells."""
    cap, alpha, beta = 256, 0.7, 0.5
    prios = np.random.default_rng(3).uniform(0.1, 5.0, cap).astype(np.float32)
    pa = (np.abs(prios) + 1e-8) ** alpha
    exact = pa / pa.sum()

    dev = PrioritizedSampler(alpha=alpha, beta=beta)
    dstate = dev.init(cap, "cpu")
    dstate = dev.on_write(dstate, torch.arange(cap), None)
    dstate = dev.update_priority(dstate, torch.arange(cap), torch.from_numpy(prios),
                                 indices_sorted=True)
    host = HostPrioritizedSampler(alpha=alpha, beta=beta)
    host.init(cap, "cpu")
    host.on_write(None, torch.arange(cap), None)
    host.update_priority(None, torch.arange(cap), torch.from_numpy(prios))

    draws, B = 128, 1024
    gd, gh = torch.Generator().manual_seed(0), torch.Generator().manual_seed(10_000)
    counts_d, counts_h = np.zeros(cap), np.zeros(cap)
    size = torch.tensor(cap)
    for _ in range(draws):
        idx, _, dstate = dev.sample(dstate, gd, B, size, cap)
        counts_d += np.bincount(idx.numpy(), minlength=cap)
        hidx, _, _ = host.sample(None, gh, B, size, cap)
        counts_h += np.bincount(hidx.numpy(), minlength=cap)
    emp_d, emp_h = counts_d / counts_d.sum(), counts_h / counts_h.sum()
    assert np.abs(emp_d - exact).sum() < 0.06, np.abs(emp_d - exact).sum()
    assert np.abs(emp_h - exact).sum() < 0.06, np.abs(emp_h - exact).sum()


def test_heavy_priorities_dominate_the_samples():
    """``tests/test_csrc.py``'s buffer case on the port's device storage:
    overwhelming priority on indices below 10."""
    rb = ReplayBuffer(DeviceStorage(32), HostPrioritizedSampler(), batch_size=256)
    state = rb.init(ArrayDict(x=torch.zeros(2)))
    state = rb.extend(state, ArrayDict(x=torch.arange(20.0)[:, None] * torch.ones(1, 2)))
    state = rb.update_priority(state, torch.arange(10), torch.full((10,), 100.0))
    batch, state = rb.sample(state, torch.Generator().manual_seed(0))
    assert (batch["index"] < 10).float().mean() > 0.8
    torch.testing.assert_close(batch["x"][:, 0], batch["index"].to(torch.float32))


def test_dqn_on_cartpole_trains_with_the_host_sampler():
    """The host tree serving the DQN learner: indices go to the learner,
    td-errors come back, and the tree moves."""
    env = TransformedEnv(VmapEnv(CartPoleEnv(), 4), RewardSum())
    tr = make_dqn_trainer(env, total_steps=3, frames_per_batch=64, buffer_capacity=1024,
                          config=OffPolicyConfig(batch_size=32, init_random_frames=64,
                                                 utd_ratio=2), device="cpu")
    sampler = tr.program.buffer.sampler = HostPrioritizedSampler()
    seen = []
    tr.register_op("post_step", lambda trainer, m: seen.append(m))
    ts = tr.train(0)
    assert len(seen) == 3 and all(np.isfinite(m["loss"].item()) for m in seen)
    size = int(ts["buffer"]["storage", "size"])
    assert size == 256
    leaves = sampler._sum[np.arange(size)]
    assert sampler._max_priority > 1.0 and len(np.unique(leaves)) > 10
    np.testing.assert_allclose(sampler._sum.reduce(), leaves.sum(), rtol=1e-9)
    np.testing.assert_array_equal(sampler._sum[np.arange(size, 1024)], 0.0)


def test_sac_on_pendulum_trains_with_the_host_sampler():
    loss = port_sac()
    coll = Collector(VmapEnv(PendulumEnv(), 4), lambda td, g: loss.actor(td, g),
                     frames_per_batch=16)
    prog = OffPolicyProgram(coll, loss, ReplayBuffer(DeviceStorage(128), HostPrioritizedSampler()),
                            OffPolicyConfig(batch_size=8, utd_ratio=2, init_random_frames=32),
                            priority_key="td_error", device_metrics=True, device="cpu")
    ts = prog.prefill(prog.init(seed=0))
    for _ in range(3):
        ts, metrics = prog.train_step(ts)
        assert np.isfinite(metrics["loss"].item())
    flat = prog.publish_device_metrics(ts)
    assert flat["updates"] == 6.0 and flat["bad_steps"] == 0.0
    assert prog.buffer.sampler._max_priority > 1.0


def test_a_second_init_resets_the_largest_priority(ref_sampler):
    """The port's ``init`` starts a new buffer's largest priority at 1, so
    items written after it get priority 1 whatever the old buffer saw. The
    reference's ``init`` keeps the old largest priority (a fault the port
    does not copy): its new items get the old buffer's maximum."""
    ref, ours = ref_sampler(alpha=0.6), HostPrioritizedSampler(alpha=0.6)
    for s in (ref, ours):
        s.init(16)
        s.on_write(None, np.arange(8), None)
        s.update_priority(None, np.array([2, 5]), np.array([50.0, -3.0]))
    assert ours._max_priority == ref._max_priority == pytest.approx(50.0)
    for s in (ref, ours):
        s.init(16)
        s.on_write(None, np.arange(4), None)
    assert ours._max_priority == 1.0
    np.testing.assert_array_equal(ours._sum[np.arange(4)], np.ones(4))
    np.testing.assert_array_equal(ours._min[np.arange(4)], np.ones(4))
    assert ours._sum.reduce(0, 16) == 4.0
    assert ref._max_priority == pytest.approx(50.0)  # the reference's fault
    np.testing.assert_allclose(ref._sum[np.arange(4)], np.full(4, (50.0 + 1e-8) ** 0.6))
