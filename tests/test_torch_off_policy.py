"""The off-policy slice as a whole against ``rl_tpu``: SAC with a device
replay buffer sampled by ``PrioritizedSampler`` (4 Pendulum envs, 16
frames a batch, MLPs of (32, 32), batch 8, ``utd_ratio`` 2, capacity 64,
fanout 4), float32, on the CPU.

The updates are held to the reference's: its ``OffPolicyProgram.init``
params carried across by ``params_from_flax`` and its buffer after
``prefill`` copied in; the port is fed the draws the reference makes from
its update keys (the sampler's uniforms, the loss's two normals).
Tolerances, after two updates (the largest measured gap is 0.27 of its
tolerance, Adam's first moments; the rest stay under 0.02):
sampled indices equal; parameters, targets and ``log_alpha`` within atol
1e-6 + rtol 1e-5 (Adam's first steps move each weight by about the
learning rate whatever the gradient's last bits); Adam's first moments
within atol 1e-7 + rtol 1e-4 and second moments within atol 1e-9 + rtol
2e-4 (the gradients' own tolerance, squared for the second); priorities,
block sums and ``max_priority`` within rtol 1e-4 (written from the
td-errors of parameters that agree to rtol 1e-5, through ``pow``).
"""

from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_tpu.collectors import Collector as JaxCollector
from rl_tpu.data.replay import DeviceStorage as JaxDeviceStorage
from rl_tpu.data.replay import PrioritizedSampler as JaxPER
from rl_tpu.data.replay import ReplayBuffer as JaxReplayBuffer
from rl_tpu.envs import PendulumEnv as JaxPendulum
from rl_tpu.envs import VmapEnv as JaxVmapEnv
from rl_tpu.kernels import registry
from rl_tpu.trainers import OffPolicyConfig as JaxOffPolicyConfig
from rl_tpu.trainers import OffPolicyProgram as JaxOffPolicyProgram
from rl_tpu_torch.collectors import Collector
from rl_tpu_torch.data import ArrayDict, DeviceStorage, PrioritizedSampler, ReplayBuffer
from rl_tpu_torch.envs import PendulumEnv, VmapEnv
from rl_tpu_torch.modules import params_from_flax
from rl_tpu_torch.modules.weights import flax_paths, to_port_layout
from rl_tpu_torch.trainers import OffPolicyConfig, OffPolicyProgram
from test_torch_off_policy_parts import jax_sac, port_sac

torch.set_num_threads(1)
N_ENVS, FRAMES, BATCH, UTD, CAP, FANOUT = 4, 16, 8, 2, 64, 4


@pytest.fixture(autouse=True)
def stock_arm(monkeypatch):
    monkeypatch.delenv(registry.ENV_INTERPRET, raising=False)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def to_port(tree) -> ArrayDict:
    return ArrayDict({k: (to_port(v) if isinstance(v, Mapping) else t(v))
                      for k, v in tree.items()})


def leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def programs(policy_delay=1, capacity=CAP):
    jloss = jax_sac()
    jcoll = JaxCollector(JaxVmapEnv(JaxPendulum(), N_ENVS),
                         lambda p, td, k: jloss.actor(p["actor"], td, k), frames_per_batch=FRAMES)
    jprog = JaxOffPolicyProgram(
        jcoll, jloss, JaxReplayBuffer(JaxDeviceStorage(capacity), JaxPER(fanout=FANOUT)),
        JaxOffPolicyConfig(batch_size=BATCH, utd_ratio=UTD, init_random_frames=32,
                           policy_delay=policy_delay),
        priority_key="td_error", device_metrics=True)
    ploss = port_sac()
    pcoll = Collector(VmapEnv(PendulumEnv(), N_ENVS), lambda td, g: ploss.actor(td, g),
                      frames_per_batch=FRAMES)
    pprog = OffPolicyProgram(
        pcoll, ploss, ReplayBuffer(DeviceStorage(capacity), PrioritizedSampler(fanout=FANOUT)),
        OffPolicyConfig(batch_size=BATCH, utd_ratio=UTD, init_random_frames=32,
                        policy_delay=policy_delay),
        priority_key="td_error", device_metrics=True, device="cpu")
    return jprog, pprog


def carried(policy_delay=1):
    """Both programs after the reference's ``init`` and ``prefill``, the
    port holding the reference's params and buffer."""
    jprog, pprog = programs(policy_delay)
    jts = jprog.prefill(jprog.init(jax.random.key(0)))
    pts = pprog.init(seed=0)
    params_from_flax(pprog.loss, jax.tree.map(np.asarray, jts["params"]))
    pts["buffer"] = to_port(jts["buffer"])
    return jprog, jts, pprog, pts


def reference_updates(jprog, jts):
    """The reference's ``utd_ratio`` updates (its scan body, in a loop),
    the port's draws from the same update keys, and the indices each
    update sampled."""
    seen = []
    sample = jprog.buffer.sample

    def recording(*args, **kw):
        batch, st = sample(*args, **kw)
        seen.append(np.asarray(batch["index"]))
        return batch, st

    jprog.buffer.sample = recording
    _, *upd_keys = jax.random.split(jts["rng"], UTD + 1)
    carry = (jts["params"], jts["opt"], jts["buffer"], jts["obs"])
    draws, metrics = [], []
    for i, key in enumerate(upd_keys):
        carry, m = jprog._update_body(carry, (key, jnp.asarray(i, jnp.int32)))
        metrics.append(m)
        k_sample, k_loss = jax.random.split(key)
        k_next, k_pi = jax.random.split(k_loss)
        draws.append((t(jax.random.uniform(k_sample, (BATCH,))),
                      t(jax.random.normal(k_next, (BATCH, 1))),
                      t(jax.random.normal(k_pi, (BATCH, 1)))))
    return carry, draws, metrics, seen


def port_updates(pprog, pts, draws):
    seen = []
    sample = pprog.buffer.sample

    def recording(*args, **kw):
        batch, st = sample(*args, **kw)
        seen.append(batch["index"].numpy().copy())
        return batch, st

    pprog.buffer.sample = recording
    pts, metrics = pprog.updates(pts, draws)
    return pts, metrics, seen


def adam_state(jopt):
    return jopt[0][0]  # chain(adam) -> (adam = (scale_by_adam, lr),)


def port_params(pprog) -> dict:
    return {n: v.detach().clone() for n, v in pprog.loss.state_dict().items()}


def assert_params_match(pprog, jparams):
    for name, (path, transposed) in flax_paths(pprog.loss).items():
        ref = to_port_layout(leaf(jparams, path), transposed).numpy()
        np.testing.assert_allclose(pprog.loss.state_dict()[name].numpy(), ref, rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("policy_delay", [1, 2])
def test_updates_match_reference(policy_delay):
    jprog, jts, pprog, pts = carried(policy_delay)
    (jparams, jopt, jbuf, jdm), draws, jmetrics, jseen = reference_updates(jprog, jts)
    actor0 = {n: v.clone() for n, v in pprog.loss.actor.state_dict().items()}
    pts, pmetrics, pseen = port_updates(pprog, pts, draws)
    assert len(pseen) == len(jseen) == UTD
    for a, b in zip(pseen, jseen):
        np.testing.assert_array_equal(a, b)
    assert_params_match(pprog, jparams)
    if policy_delay == 2:  # update 1 of 2 keeps the policy; update 0 moved it
        assert any(not torch.equal(actor0[n], v)
                   for n, v in pprog.loss.actor.state_dict().items())
    # Adam: moments of every trainable parameter, and the count
    adam = adam_state(jopt)
    paths = flax_paths(pprog.loss)
    names = [n for n, _ in pprog.loss.trainable_parameters()]
    for name, mu, nu in zip(names, pprog.optimizer.mu, pprog.optimizer.nu):
        path, tr = paths[name]
        np.testing.assert_allclose(mu.numpy(), to_port_layout(leaf(adam.mu, path), tr).numpy(),
                                   rtol=1e-4, atol=1e-7, err_msg=name)
        np.testing.assert_allclose(nu.numpy(), to_port_layout(leaf(adam.nu, path), tr).numpy(),
                                   rtol=2e-4, atol=1e-9, err_msg=name)
    assert int(pprog.optimizer.count) == int(adam.count) == UTD
    # the PER tree and the sampler's counters
    ps, js = pts["buffer"]["sampler"], jbuf["sampler"]
    for k in ("priorities", "esum", "max_priority"):
        np.testing.assert_allclose(ps[k].numpy(), np.asarray(js[k]), rtol=1e-4, atol=0,
                                   err_msg=k)
    assert not np.array_equal(ps["priorities"].numpy(), t(jts["buffer"]["sampler", "priorities"]))
    assert int(ps["step"]) == int(js["step"]) == UTD
    # per-update scalar metrics, averaged
    for k in ("loss", "loss_qvalue", "loss_actor", "loss_alpha", "alpha", "entropy"):
        ref = np.mean([float(m[k]) for m in jmetrics])
        np.testing.assert_allclose(pmetrics[k].item(), ref, rtol=1e-4, atol=1e-7, err_msg=k)
    flat = pprog.publish_device_metrics(pts)
    assert flat["updates"] == UTD and flat["bad_steps"] == 0
    assert sum(flat["td_error"]["counts"]) == UTD * BATCH


def test_guard_keeps_everything_but_the_sampler_step():
    """A NaN reward in every stored transition makes both updates
    non-finite: in both packages parameters, targets, Adam's state, the
    leaves, the block sums and max_priority stay as they were, bit for
    bit, while the sampler's step counter advances."""
    jprog, jts, pprog, pts = carried()
    nan_path = ("storage", "data", "next", "reward")
    jts = {**jts, "buffer": jts["buffer"].set(
        nan_path, jnp.full_like(jts["buffer"][nan_path], jnp.nan))}
    pts["buffer"][nan_path].fill_(float("nan"))
    before = port_params(pprog)
    opt_before = [m.clone() for m in pprog.optimizer.mu + pprog.optimizer.nu]
    tree_before = {k: pts["buffer"]["sampler", k].clone()
                   for k in ("priorities", "esum", "max_priority")}
    (jparams, jopt, jbuf, jdm), draws, _, _ = reference_updates(jprog, jts)
    pts, metrics, _ = port_updates(pprog, pts, draws)
    assert not np.isfinite(metrics["loss"].item())
    for n, v in pprog.loss.state_dict().items():
        assert torch.equal(v, before[n]), n
    for a, b in zip(pprog.optimizer.mu + pprog.optimizer.nu, opt_before):
        assert torch.equal(a, b)
    assert int(pprog.optimizer.count) == 0
    for k, v in tree_before.items():
        assert torch.equal(pts["buffer"]["sampler", k], v), k
    assert int(pts["buffer"]["sampler", "step"]) == UTD
    flat = pprog.publish_device_metrics(pts)
    assert flat["bad_steps"] == UTD and flat["updates"] == 0 and flat["loss"] == 0.0
    # the reference behaves the same
    jax.tree.map(np.testing.assert_array_equal, jparams, jts["params"])
    for k in tree_before:
        np.testing.assert_array_equal(np.asarray(jbuf["sampler", k]),
                                      np.asarray(jts["buffer"]["sampler", k]))
    assert int(jbuf["sampler", "step"]) == UTD
    assert int(adam_state(jopt).count) == 0


@pytest.mark.parametrize("policy_delay", [1, 2])
def test_prefill_and_train_steps_on_cpu(policy_delay):
    _, pprog = programs(policy_delay, capacity=40)
    ts = pprog.prefill(pprog.init(seed=3))
    assert int(ts["buffer"]["storage", "size"]) == 32  # ceil(32 / 16) batches of 16
    for _ in range(2):
        ts, metrics = pprog.train_step(ts)
        assert all(np.isfinite(v.item()) for v in metrics.values()), metrics
    storage = ts["buffer"]["storage"]
    assert int(storage["size"]) == 40 and int(storage["cursor"]) == (32 + 2 * FRAMES) % 40
    assert ts["update_count"] == 2 * UTD
    flat = pprog.publish_device_metrics(ts)
    assert flat["updates"] == 2 * UTD and flat["bad_steps"] == 0
    leaves = ts["buffer"]["sampler", "priorities"]
    assert bool((leaves[:40] > 0).all()) and bool((leaves[40:] == 0).all())


def test_chunk_lapping_the_ring_keeps_its_last_items():
    """A write of more items than the ring holds keeps the last
    ``capacity`` (the reference drops the rest through an out-of-bounds
    index)."""
    buf = ReplayBuffer(DeviceStorage(4), PrioritizedSampler(fanout=2))
    state = buf.init(ArrayDict(x=torch.zeros(())))
    state = buf.extend(state, ArrayDict(x=torch.arange(6.0)), n=6)
    assert state["storage", "data", "x"].tolist() == [4.0, 5.0, 2.0, 3.0]
    assert int(state["storage", "cursor"]) == 2 and int(state["storage", "size"]) == 4


def test_random_sampler_is_uniform_over_the_filled_slots():
    """The buffer's default sampler: ``floor(u * size)``, never past the
    filled slots, and the draws are the generator's unless given."""
    buf = ReplayBuffer(DeviceStorage(16), batch_size=4000)
    state = buf.init(ArrayDict(x=torch.zeros(())))
    state = buf.extend(state, ArrayDict(x=torch.arange(5.0)))
    batch, _ = buf.sample(state, torch.Generator().manual_seed(0))
    counts = torch.bincount(batch["index"], minlength=16)
    assert counts[5:].sum() == 0 and bool((counts[:5] > 700).all())
    assert torch.equal(batch["x"], batch["index"].float())
    u = torch.tensor([0.0, 0.199, 0.2, 0.9999])
    batch, _ = buf.sample(state, None, 4, u=u)
    assert batch["index"].tolist() == [0, 0, 1, 4]


def test_program_without_device_and_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pprog = programs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OffPolicyProgram(pprog.collector, pprog.loss, pprog.buffer, pprog.config)
