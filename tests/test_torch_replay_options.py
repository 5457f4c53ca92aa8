"""The replay options and the SAC factory against the JAX package, on the
CPU.

- ``PrioritizedSampler(beta_annealing_steps=)``: the importance weights at
  sampler step 0, mid-way and past the end of the anneal equal the
  reference's, fed the reference's uniforms, within 1e-6 relative (the
  tolerance of the unannealed sampler's parity test: the block prefix
  sums run in another order); beta itself bit for bit.
- ``ReplayBuffer(transform=)`` sees the sampled batch with its "index" and
  the sampler's info set, and ``add`` inserts one unsqueezed item: both
  equal the reference's.
- ``make_sac_trainer``: the parts it builds (the actor's and the critic
  ensemble's parameter shapes, the buffer's capacity, the sampler, the
  config, the priority key, ``MultiStep``, the steps and frames) match the
  reference's ``make_sac_trainer``; a tiny instance trains a few steps
  with finite losses.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_tpu.data import ArrayDict as JaxArrayDict
from rl_tpu.data.replay import DeviceStorage as JaxDeviceStorage
from rl_tpu.data.replay import ReplayBuffer as JaxReplayBuffer
from rl_tpu.data.replay.samplers import PrioritizedSampler as JaxPER
from rl_tpu.envs import PendulumEnv as JaxPendulum
from rl_tpu.envs import VmapEnv as JaxVmapEnv
from rl_tpu.kernels import registry as jax_kernel_registry
from rl_tpu.trainers.algorithms import make_sac_trainer as jax_make_sac_trainer
from rl_tpu_torch.data import ArrayDict, DeviceStorage, PrioritizedSampler, ReplayBuffer
from rl_tpu_torch.envs import PendulumEnv, VmapEnv
from rl_tpu_torch.trainers import OffPolicyConfig, default_device_metrics, make_sac_trainer

torch.set_num_threads(1)

CAP, FANOUT, BATCH, ANNEAL = 64, 4, 8, 10


@pytest.fixture(autouse=True)
def stock_arm(monkeypatch):
    """The reference's stock scatter-adds (no interpret kernel)."""
    monkeypatch.delenv(jax_kernel_registry.ENV_INTERPRET, raising=False)


def port_state(jstate) -> ArrayDict:
    return ArrayDict({k: torch.from_numpy(np.array(v)) for k, v in jstate.items()})


@pytest.mark.parametrize("step", [0, ANNEAL // 2, 3 * ANNEAL], ids=["start", "mid", "past"])
def test_annealed_weights_match_reference(step):
    js = JaxPER(fanout=FANOUT, beta_annealing_steps=ANNEAL)
    ts = PrioritizedSampler(fanout=FANOUT, beta_annealing_steps=ANNEAL)
    rng = np.random.default_rng(step)
    jst = js.on_write(js.init(CAP), jnp.arange(40), None)
    jst = js.update_priority(jst, jnp.asarray(rng.integers(0, 40, 24)),
                             jnp.asarray(rng.random(24).astype(np.float32) * 4.0))
    jst = jst.set("step", jnp.asarray(step, jnp.int32))
    key = jax.random.key(step + 1)
    j_idx, j_info, j_new = js.sample(jst, key, BATCH, jnp.asarray(40, jnp.int32), CAP)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (BATCH,))))
    p_idx, p_info, p_new = ts.sample(port_state(jst), None, BATCH, torch.tensor(40), CAP, u=u)
    beta = ts._beta(torch.tensor(step, dtype=torch.int32))
    assert beta.numpy().tobytes() == np.asarray(js._beta(jnp.asarray(step))).tobytes()
    assert float(beta) == pytest.approx(min(1.0, 0.4 + 0.6 * step / ANNEAL))
    np.testing.assert_array_equal(p_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(p_info["_weight"].numpy(), np.asarray(j_info["_weight"]),
                               rtol=1e-6, atol=0)
    assert int(p_new["step"]) == int(j_new["step"]) == step + 1
    if step:  # the annealed exponent is not the initial one
        fixed = PrioritizedSampler(fanout=FANOUT).sample(port_state(jst), None, BATCH,
                                                         torch.tensor(40), CAP, u=u)[1]
        assert not torch.allclose(fixed["_weight"], p_info["_weight"], rtol=1e-3)


def _buffers(transform_t, transform_j):
    """Both packages' PER buffers over 16 slots, written with items 0-9
    one ``add`` at a time, then three by ``extend``."""
    ours = ReplayBuffer(DeviceStorage(16), PrioritizedSampler(fanout=FANOUT),
                        transform=transform_t)
    ref = JaxReplayBuffer(JaxDeviceStorage(16), JaxPER(fanout=FANOUT), transform=transform_j)
    pst = ours.init(ArrayDict(x=torch.zeros(3), y=torch.zeros((), dtype=torch.int32)))
    jst = ref.init(JaxArrayDict(x=jnp.zeros(3), y=jnp.zeros((), jnp.int32)))
    for i in range(10):
        x = np.full(3, i * 0.5, np.float32)
        pst = ours.add(pst, ArrayDict(x=torch.from_numpy(x), y=torch.tensor(i, dtype=torch.int32)))
        jst = ref.add(jst, JaxArrayDict(x=jnp.asarray(x), y=jnp.asarray(i, jnp.int32)))
    xs = np.arange(9, dtype=np.float32).reshape(3, 3)
    ys = np.array([20, 21, 22], np.int32)
    pst = ours.extend(pst, ArrayDict(x=torch.from_numpy(xs), y=torch.from_numpy(ys)))
    jst = ref.extend(jst, JaxArrayDict(x=jnp.asarray(xs), y=jnp.asarray(ys)))
    return ours, ref, pst, jst


def test_add_matches_reference():
    _, _, pst, jst = _buffers(None, None)
    for k in ("x", "y"):
        np.testing.assert_array_equal(pst["storage", "data", k].numpy(),
                                      np.asarray(jst["storage", "data", k]))
    for k in ("cursor", "size"):
        assert int(pst["storage", k]) == int(jst["storage", k]) == 13
    np.testing.assert_array_equal(pst["sampler", "priorities"].numpy(),
                                  np.asarray(jst["sampler", "priorities"]))


def test_transform_sees_the_index_and_the_weights_as_the_reference():
    def transform_t(b):
        return b.set("z", b["x"].sum(-1) * b["_weight"] + b["index"].to(torch.float32))

    def transform_j(b):
        return b.set("z", b["x"].sum(-1) * b["_weight"] + b["index"].astype(jnp.float32))

    ours, ref, pst, jst = _buffers(transform_t, transform_j)
    key = jax.random.key(3)
    jb, _ = ref.sample(jst, key, 6)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (6,))))
    pb, _ = ours.sample(pst, None, 6, u=u)
    assert set(pb.keys()) == set(jb.keys()) == {"x", "y", "index", "_weight", "z"}
    np.testing.assert_array_equal(pb["index"].numpy(), np.asarray(jb["index"]))
    np.testing.assert_allclose(pb["z"].numpy(), np.asarray(jb["z"]), rtol=1e-6, atol=0)


def _shapes(named) -> dict:
    """Per top-level group, the multiset of each parameter's sorted dims
    (the port keeps ``[out, in]`` weights where flax keeps ``[in, out]``)."""
    out = collections.defaultdict(collections.Counter)
    for name, shape in named:
        out[name.split(".")[0]][tuple(sorted(shape))] += 1
    return dict(out)


@pytest.mark.parametrize("prioritized,n_step", [(True, None), (False, 3)],
                         ids=["per", "uniform_nstep"])
def test_sac_factory_matches_reference(prioritized, n_step):
    kw = dict(total_steps=5, frames_per_batch=16, buffer_capacity=256, prioritized=prioritized,
              n_step=n_step)
    ours = make_sac_trainer(VmapEnv(PendulumEnv(), 4), device="cpu", **kw)
    ref = jax_make_sac_trainer(JaxVmapEnv(JaxPendulum(), 4), **kw)
    p, r = ours.program, ref.program
    jts = r.init(jax.random.key(0))
    p.init(0)
    flat = jax.tree_util.tree_flatten_with_path(jts["params"])[0]
    ref_shapes = _shapes((".".join(str(getattr(k, "key", k)) for k in path), leaf.shape)
                         for path, leaf in flat)
    assert _shapes((n, tuple(t.shape)) for n, t in p.loss.named_parameters()) == ref_shapes
    assert ref_shapes["qvalue"][(2, 256, 256)] == 1 and ref_shapes["actor"][(256, 256)] == 1
    assert p.loss.actor.dist_kwargs == r.loss.actor.dist_kwargs == {"low": -2.0, "high": 2.0}
    assert p.loss.gamma == r.loss.gamma and p.loss.num_qvalue_nets == r.loss.num_qvalue_nets
    assert p.buffer.capacity == r.buffer.capacity == 256
    assert type(p.buffer.sampler).__name__ == type(r.buffer.sampler).__name__
    assert dataclasses.asdict(p.config) == dataclasses.asdict(r.config)
    assert p.config.init_random_frames == 5000
    assert p.priority_key == r.priority_key == ("td_error" if prioritized else None)
    assert (p.collector.postproc is None) == (r.collector.postproc is None) == (n_step is None)
    assert ours.total_steps == ref.total_steps and p.collector.frames_per_batch == 16


def test_sac_factory_trains_a_tiny_instance_on_cpu():
    trainer = make_sac_trainer(
        VmapEnv(PendulumEnv(), 4), 4, frames_per_batch=16, buffer_capacity=512,
        prioritized=True, config=OffPolicyConfig(batch_size=16, utd_ratio=2,
                                                 init_random_frames=48), device="cpu")
    trainer.program.device_metrics = default_device_metrics()
    losses = []
    trainer.register_op("post_step", lambda tr, m: losses.append(float(m["loss"])))
    ts = trainer.train(0)
    assert len(losses) == 4 and all(np.isfinite(losses))
    flat = trainer.program.publish_device_metrics(ts)
    assert flat["updates"] == 8 and flat["bad_steps"] == 0
    assert int(ts["buffer"]["storage", "size"]) == 48 + 4 * 16
    leaves = ts["buffer"]["sampler", "priorities"][:112]
    assert bool((leaves != leaves[0]).any())  # the td-errors were written back
