"""The overlapped host-env off-policy path against ``rl_tpu``, on the CPU:
``ReplayBuffer.make_extend``, the host env pools, ``HostCollector``,
``AsyncHostCollector``, the metrics registry and
``AsyncOffPolicyTrainer``.

The host env is the reference test's ``_HostEnv``
(``tests/test_async_offpolicy.py``), copied, with each package's specs.
Collected batches are held to the reference's transition for transition,
exactly (the policies are exact in float32: ``clip(0.5 x)``). The
K-update is held to the reference's ``_k_updates`` from the same state
(the reference's params carried by ``params_from_flax``, the replay
written by both packages' chunk writers) on the draws the reference makes
from its keys, at ``tests/test_torch_off_policy.py``'s tolerances.

Every thread and process a test starts is stopped in ``finally``, and
every wait has its own timeout.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_off_policy import assert_params_match, stock_arm, t  # noqa: F401
from test_torch_off_policy_parts import jax_sac, port_sac

from rl_tpu.collectors import AsyncHostCollector as JaxAsyncHostCollector
from rl_tpu.collectors import HostCollector as JaxHostCollector
from rl_tpu.collectors import ThreadedEnvPool as JaxThreadedEnvPool
from rl_tpu.data import ArrayDict as JaxArrayDict
from rl_tpu.data.replay import DeviceStorage as JaxDeviceStorage
from rl_tpu.data.replay import PrioritizedSampler as JaxPER
from rl_tpu.data.replay import ReplayBuffer as JaxReplayBuffer
from rl_tpu.data.replay import StalenessAwareSampler as JaxStaleness
from rl_tpu.data.specs import Bounded as JaxBounded
from rl_tpu.data.specs import Composite as JaxComposite
from rl_tpu.data.specs import Unbounded as JaxUnbounded
from rl_tpu.obs import MetricsRegistry as JaxMetricsRegistry
from rl_tpu.obs import set_registry as jax_set_registry
from rl_tpu.trainers import AsyncOffPolicyTrainer as JaxAsyncOffPolicyTrainer
from rl_tpu.trainers import OffPolicyConfig as JaxOffPolicyConfig
from rl_tpu_torch.collectors import (AsyncHostCollector, HostCollector, ProcessEnvPool,
                                     ThreadedEnvPool, compact_collected)
from rl_tpu_torch.data import (ArrayDict, DeviceStorage, PrioritizedSampler, ReplayBuffer,
                               StalenessAwareSampler)
from rl_tpu_torch.data.specs import Bounded, Composite, Unbounded
from rl_tpu_torch.obs import MetricsRegistry, set_registry
from rl_tpu_torch.trainers import (AsyncOffPolicyTrainer, OffPolicyConfig, OffPolicyProgram,
                                   default_device_metrics)

torch.set_num_threads(1)
TIMEOUT = 30.0


class _HostEnv:
    """Tiny host env: 2-d noise obs, reward peaks at action 0.3, optional
    per-step delay (straggler stand-in)."""

    def __init__(self, delay=0.0, horizon=64, seed=0):
        self.delay = delay
        self.horizon = horizon
        self._rng = np.random.default_rng(seed)
        self.t = 0

    @property
    def observation_spec(self):
        return Composite(observation=Unbounded((2,)))

    @property
    def action_spec(self):
        return Bounded(shape=(1,), low=-1.0, high=1.0)

    def _obs(self):
        return {"observation": self._rng.normal(size=2).astype(np.float32)}

    def reset(self, seed=0):
        self._rng = np.random.default_rng(seed)
        self.t = 0
        return self._obs()

    def step(self, action):
        if self.delay:
            time.sleep(self.delay)
        self.t += 1
        a = float(np.asarray(action).ravel()[0])
        r = 1.0 - (a - 0.3) ** 2
        return self._obs(), r, False, self.t >= self.horizon

    def close(self):
        pass


class _JaxHostEnv(_HostEnv):
    @property
    def observation_spec(self):
        return JaxComposite(observation=JaxUnbounded((2,)))

    @property
    def action_spec(self):
        return JaxBounded(shape=(1,), low=-1.0, high=1.0)


def _short_env():
    return _HostEnv(horizon=5)


def jax_policy(params, td, key):
    return td.set("action", jnp.clip(td["observation"][..., :1] * 0.5, -1.0, 1.0))


def port_policy(td, generator):
    return td.set("action", torch.clamp(td["observation"][..., :1] * 0.5, -1.0, 1.0))


def assert_batches_equal(pb, jb):
    keys = [k for k in jb.keys(nested=True, leaves_only=True)]
    assert sorted(pb.keys(nested=True, leaves_only=True)) == sorted(keys)
    for k in keys:
        np.testing.assert_array_equal(pb[k].numpy(), np.asarray(jb[k]), err_msg=str(k))


def flat_items(rng, n, version=0):
    """A flat transition chunk in the async collector's layout."""
    obs = rng.normal(size=(n, 2)).astype(np.float32)
    nxt = rng.normal(size=(n, 2)).astype(np.float32)
    cols = dict(observation=obs, action=rng.uniform(-1, 1, (n, 1)).astype(np.float32),
                next=dict(observation=nxt, reward=rng.normal(size=n).astype(np.float32),
                          terminated=rng.random(n) < 0.1, truncated=np.zeros(n, bool)),
                collector=dict(policy_version=np.full(n, version, np.int32),
                               env_ids=np.arange(n, dtype=np.int32) % 2,
                               step=np.arange(n, dtype=np.int32)))
    cols["next"]["done"] = cols["next"]["terminated"] | cols["next"]["truncated"]

    def build(d, leaf, cls):
        return cls({k: build(v, leaf, cls) if isinstance(v, dict) else leaf(v)
                    for k, v in d.items()})

    return build(cols, jnp.asarray, JaxArrayDict), build(cols, torch.from_numpy, ArrayDict)


@pytest.fixture
def fresh_registries():
    """Each package's process metrics registry replaced by a fresh one."""
    port_reg, jax_reg = MetricsRegistry(), JaxMetricsRegistry()
    prev, jprev = set_registry(port_reg), jax_set_registry(jax_reg)
    try:
        yield port_reg, jax_reg
    finally:
        set_registry(prev)
        jax_set_registry(jprev)


def test_make_extend_matches_reference(fresh_registries):
    """Three chunks of 24 into a 64-slot ring (the third laps it), through
    PER and through the staleness sampler's per-item stamps: storage,
    cursor, size and sampler state equal the reference's, and both count
    the writes into their registries."""
    port_reg, jax_reg = fresh_registries
    rng = np.random.default_rng(0)
    for jsamp, psamp in ((JaxPER(fanout=4), PrioritizedSampler(fanout=4)),
                         (JaxStaleness(), StalenessAwareSampler())):
        jbuf, pbuf = JaxReplayBuffer(JaxDeviceStorage(64), jsamp), ReplayBuffer(
            DeviceStorage(64), psamp)
        jitems, pitems = flat_items(rng, 24)
        jst = jbuf.init(jitems[0])
        pst = pbuf.init(pitems[0])
        jw, pw = jbuf.make_extend(24), pbuf.make_extend(24)
        for c in range(3):
            jitems, pitems = flat_items(rng, 24, version=c)
            jst, pst = jw(jst, jitems), pw(pst, pitems)
        for k in jst.keys(nested=True, leaves_only=True):
            np.testing.assert_array_equal(pst[k].numpy(), np.asarray(jst[k]), err_msg=str(k))
        assert pw.program.name == "replay.extend" and pw.program.stats["eager_calls"] == 3
    for reg in (port_reg, jax_reg):
        assert reg.counter("rl_tpu_replay_extends_total").value() == 6
        assert reg.counter("rl_tpu_replay_items_written_total").value() == 6 * 24
    with pytest.raises(ValueError, match="in place"):
        pbuf.make_extend(24, donate=False)


@pytest.mark.parametrize("interrupt", [False, True])
def test_host_collector_matches_reference(interrupt):
    """Two batches of 2 envs x 8 steps (episodes of 5: host auto-resets on
    the seed chain), transition for transition; with an interruptor that
    cuts the second batch after 3 steps, the padded rows, the cut marked
    truncated and done, the mask, and ``compact_collected``."""

    class CutAfter:
        def __init__(self, steps):
            self.steps, self.calls, self.batch = steps, 0, 0

        def start_collection(self):
            self.calls, self.batch = 0, self.batch + 1

        def collection_stopped(self):
            self.calls += 1
            return self.batch == 2 and self.calls >= self.steps

    jpool = JaxThreadedEnvPool([lambda i=i: _JaxHostEnv(horizon=5, seed=i) for i in range(2)])
    ppool = ThreadedEnvPool([lambda i=i: _HostEnv(horizon=5, seed=i) for i in range(2)])
    try:
        jc = JaxHostCollector(jpool, jax_policy, frames_per_batch=16, seed=3,
                              interruptor=CutAfter(3) if interrupt else None)
        pc = HostCollector(ppool, port_policy, frames_per_batch=16, seed=3,
                           interruptor=CutAfter(3) if interrupt else None, device="cpu")
        for i in range(2):
            jb = jc.collect(None, jax.random.key(i))
            pb = pc.collect()
            assert pb.batch_shape == (8, 2)
            assert_batches_equal(pb, jb)
        assert bool(pb["next", "truncated"].any())  # episodes ended inside the batches
        compact = compact_collected(pb)
        assert "collected_mask" not in compact
        if interrupt:
            assert pb["collected_mask"][:, 0].tolist() == [True] * 3 + [False] * 5
            assert compact.batch_shape == (3, 2)
            assert bool(compact["next", "done"][-1].all())
        else:
            assert compact.batch_shape == (8, 2)
    finally:
        jpool.close()
        ppool.close()


def test_process_pool_steps_as_the_threaded_pool():
    """Forked workers step numpy envs: the same observations, rewards and
    flags as the threaded pool, resets through the pipe, random actions
    from the spec inside the bounds."""
    ppool = ProcessEnvPool([_short_env for _ in range(2)])
    tpool = ThreadedEnvPool([_short_env for _ in range(2)])
    try:
        assert all(ppool.alive()) and ppool.action_spec.shape == (1,)
        batches = [HostCollector(p, port_policy, frames_per_batch=12, device="cpu").collect()
                   for p in (ppool, tpool)]
        assert_batches_equal(batches[0], batches[1])
        assert int(batches[0]["next", "truncated"].sum()) == 2
        rand = HostCollector(ppool, None, frames_per_batch=12, device="cpu").collect()
        assert bool((rand["action"].abs() <= 1.0).all())
    finally:
        ppool.close()
        tpool.close()
    assert not any(ppool.alive())


def test_async_collector_schema_stamps_and_stats():
    pool = ThreadedEnvPool([lambda: _HostEnv() for _ in range(2)])
    coll = AsyncHostCollector(pool, None, frames_per_batch=32, seed=0,
                              registry=MetricsRegistry(), device="cpu")
    try:
        coll.start()
        b1 = coll.get_batch(timeout=TIMEOUT)
        b2 = coll.get_batch(timeout=TIMEOUT)
    finally:
        coll.stop()
        pool.close()
    assert b1 is not None and b2 is not None and b1.batch_shape == (32,)
    assert b1["next", "reward"].dtype == torch.float32
    assert b1["next", "done"].dtype == torch.bool
    for k in ("policy_version", "env_ids", "step"):
        assert b1["collector", k].dtype == torch.int32
    assert set(b1["collector", "env_ids"].tolist()) <= {0, 1}
    s1, s2 = b1["collector", "step"], b2["collector", "step"]
    assert bool((s1.diff() > 0).all()) and int(s2.min()) > int(s1.max())
    stats = coll.stats()
    assert stats["env_steps"] >= 64 and stats["batches_emitted"] >= 2


def test_async_collector_straggler_cutoff_first_come():
    """One slow env among three fast ones: harvests fire without the
    straggler, so the fast envs bring more transitions per batch."""
    pool = ThreadedEnvPool([lambda: _HostEnv(delay=0.05)] + [lambda: _HostEnv() for _ in range(3)])
    coll = AsyncHostCollector(pool, None, frames_per_batch=64, min_ready_fraction=0.5,
                              straggler_wait_s=0.005, registry=MetricsRegistry(), device="cpu")
    try:
        coll.start()
        b = coll.get_batch(timeout=TIMEOUT)
    finally:
        coll.stop()
        pool.close()
    ids = b["collector", "env_ids"]
    assert int((ids == 1).sum()) > int((ids == 0).sum())
    assert coll.stats()["straggler_cutoffs"] > 0


def test_async_collector_first_batches_match_reference():
    """One env, so harvest order cannot depend on timing: the first two
    batches (an auto-reset inside) equal the reference's, stamps too."""
    jpool = JaxThreadedEnvPool([lambda: _JaxHostEnv(horizon=7, seed=1)])
    ppool = ThreadedEnvPool([lambda: _HostEnv(horizon=7, seed=1)])
    jc = JaxAsyncHostCollector(jpool, jax_policy, frames_per_batch=10, seed=5,
                               registry=JaxMetricsRegistry())
    pc = AsyncHostCollector(ppool, port_policy, frames_per_batch=10, seed=5,
                            registry=MetricsRegistry(), device="cpu")
    try:
        jc.start({})
        pc.start()
        for _ in range(2):
            jb, pb = jc.get_batch(timeout=TIMEOUT), pc.get_batch(timeout=TIMEOUT)
            assert jb is not None and pb is not None
            assert_batches_equal(pb, jb)
    finally:
        jc.stop()
        pc.stop()
        jpool.close()
        ppool.close()
    assert bool(pb["next", "truncated"].any())


def k_update_pair(utd=2, batch=8):
    """The reference's and the port's trainers after ``init`` and two
    chunk writes of the same items, the port holding the reference's
    params."""
    jpool = JaxThreadedEnvPool([lambda: _JaxHostEnv()])
    ppool = ThreadedEnvPool([lambda: _HostEnv()])
    cfg = dict(batch_size=batch, utd_ratio=utd, init_random_frames=0)
    jtr = JaxAsyncOffPolicyTrainer(
        JaxAsyncHostCollector(jpool, None, frames_per_batch=24, registry=JaxMetricsRegistry()),
        jax_sac(), JaxReplayBuffer(JaxDeviceStorage(64), JaxPER(fanout=4)),
        JaxOffPolicyConfig(**cfg), priority_key="td_error", device_metrics=True)
    ptr = AsyncOffPolicyTrainer(
        AsyncHostCollector(ppool, None, frames_per_batch=24, registry=MetricsRegistry(),
                           device="cpu"),
        port_sac(), ReplayBuffer(DeviceStorage(64), PrioritizedSampler(fanout=4)),
        OffPolicyConfig(**cfg), priority_key="td_error", device_metrics=True, device="cpu")
    jts, pts = jtr.init(jax.random.key(0)), ptr.init(seed=0)
    from rl_tpu_torch.modules import params_from_flax

    params_from_flax(ptr.loss, jax.tree.map(np.asarray, jts["params"]))
    rng = np.random.default_rng(4)
    for c in range(2):
        jitems, pitems = flat_items(rng, 24, version=c)
        jts = {**jts, "buffer": jtr._extend(jts["buffer"], jitems)}
        pts = {**pts, "buffer": ptr.extend(pts["buffer"], pitems)}
    return jtr, jts, ptr, pts


def reference_draws(rng, utd, batch):
    """The port's draws from the reference's K-update keys."""
    _, *upd_keys = jax.random.split(rng, utd + 1)
    draws = []
    for key in upd_keys:
        k_sample, k_loss = jax.random.split(key)
        k_next, k_pi = jax.random.split(k_loss)
        draws.append((t(jax.random.uniform(k_sample, (batch,))),
                      t(jax.random.normal(k_next, (batch, 1))),
                      t(jax.random.normal(k_pi, (batch, 1)))))
    return draws


def test_k_updates_match_reference():
    """One dispatch of ``offpolicy.k_updates`` (2 updates) from the same
    state: parameters, targets, ``log_alpha``, the PER tree and the
    averaged metrics within ``test_torch_off_policy.py``'s tolerances;
    the update count and the device metrics as the reference's."""
    jtr, jts, ptr, pts = k_update_pair()
    for k in jts["buffer"].keys(nested=True, leaves_only=True):  # the same replay
        np.testing.assert_array_equal(pts["buffer"][k].numpy(), np.asarray(jts["buffer"][k]))
    out, jm = jtr._k_updates(jts["params"], jts["opt"], jts["buffer"], jts["rng"],
                             jts["update_count"], jts["obs"])
    jparams, _, jbuf, _, juc, jdm = out
    draws = reference_draws(jts["rng"], 2, 8)
    new, pm = ptr.k_program(ptr._inner(pts), draws)
    assert_params_match(ptr, jparams)
    for k in ("priorities", "esum", "max_priority"):
        np.testing.assert_allclose(new["buffer"]["sampler", k].numpy(),
                                   np.asarray(jbuf["sampler", k]), rtol=1e-4, atol=0, err_msg=k)
    assert int(new["buffer"]["sampler", "step"]) == int(jbuf["sampler", "step"]) == 2
    for k in ("loss", "loss_qvalue", "loss_actor", "loss_alpha", "alpha", "entropy"):
        np.testing.assert_allclose(pm[k].item(), float(jm[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    assert new["update_count"] == int(juc) == 2
    flat = ptr.publish_device_metrics(new)
    jflat = jtr.device_metrics.to_flat(jdm)
    assert flat["updates"] == jflat["updates"] == 2
    assert flat["td_error"]["counts"] == list(jflat["td_error"]["counts"])


def _trainer(pool, sampler, registry, utd=2, fpb=16):
    loss = port_sac()
    coll = AsyncHostCollector(pool, loss.actor, frames_per_batch=fpb, seed=0,
                              registry=registry, device="cpu")
    cfg = OffPolicyConfig(batch_size=16, utd_ratio=utd, learning_rate=3e-3,
                          init_random_frames=16)
    return AsyncOffPolicyTrainer(coll, loss, ReplayBuffer(DeviceStorage(256), sampler), cfg,
                                 priority_key="td_error" if isinstance(
                                     sampler, PrioritizedSampler) else None,
                                 device_metrics=True, metrics_registry=registry, device="cpu")


def test_train_counts_updates_versions_and_staleness():
    """6 batches of 16 on 2 envs through the staleness sampler: one
    dispatch a batch, each bumping the policy version; the stored stamps
    never run ahead of the version, never go back per env, and the
    sampler's version is the freshest stamp; the staleness histogram saw
    every sampled item."""
    pool = ThreadedEnvPool([lambda i=i: _HostEnv(seed=i) for i in range(2)])
    reg = MetricsRegistry()
    tr = _trainer(pool, StalenessAwareSampler(), reg)
    ts = tr.init(seed=1)
    actor0 = [p.clone() for p in tr.loss.actor.parameters()]
    seen = []
    try:
        for ts, m in tr.train(ts, total_frames=96, batch_timeout=TIMEOUT):
            assert m is not None and np.isfinite(m["loss"].item())
            seen.append(tr.collector.policy_version)
    finally:
        pool.close()
    assert seen == [1, 2, 3, 4, 5, 6] and ts["update_count"] == 12
    assert len(tr.host_split) == 6 and set(tr.host_split[0]) == {"wait", "extend", "dispatch",
                                                                  "publish"}
    assert any(not torch.equal(a, b) for a, b in zip(actor0, tr.loss.actor.parameters()))
    data = ts["buffer"]["storage", "data"]
    v, env, step = (data["collector", k][:96] for k in ("policy_version", "env_ids", "step"))
    assert int(v.max()) <= 6 and int(ts["buffer"]["sampler", "version"]) == int(v.max())
    for e in (0, 1):
        mine = v[env == e][torch.argsort(step[env == e])]
        assert bool((mine.diff() >= 0).all())
    flat = tr.publish_device_metrics(ts)
    assert flat["updates"] == 12 and sum(flat["staleness"]["counts"]) == 12 * 16


def test_device_metrics_and_collector_series_reach_the_registry():
    """After a PER run: ``train`` published the drained device metrics
    (the last one after the loop) and the collector its series;
    ``publish_device_metrics(registry=)`` of both programs publishes."""
    pool = ThreadedEnvPool([lambda i=i: _HostEnv(seed=i) for i in range(2)])
    reg = MetricsRegistry()
    tr = _trainer(pool, PrioritizedSampler(), reg, utd=1)
    ts = tr.init(seed=2)
    try:
        for ts, _ in tr.train(ts, total_frames=64, batch_timeout=TIMEOUT):
            pass
    finally:
        pool.close()
    assert reg.counter("rl_tpu_device_updates_total").value() == 4
    assert reg.counter("rl_tpu_device_bad_steps_total").value() == 0
    assert reg.histogram("rl_tpu_device_td_error").snapshot()[""]["count"] == 4 * 16
    stats = tr.collector.stats()
    assert reg.counter("rl_tpu_collector_batches_total").value() == stats["batches_emitted"]
    assert reg.counter("rl_tpu_collector_env_steps_total").value() >= 64
    assert reg.gauge("rl_tpu_collector_policy_version").value() <= 4
    assert reg.histogram("rl_tpu_collector_staleness").snapshot()[""]["count"] >= 64
    text = reg.render()
    assert "rl_tpu_collector_harvest_seconds_bucket" in text
    assert 'rl_tpu_device_td_error_bucket{le="+Inf"} 64' in text
    other = MetricsRegistry()
    flat = tr.publish_device_metrics(ts, registry=other)
    assert other.counter("rl_tpu_device_updates_total").value() == flat["updates"] == 4
    prog = OffPolicyProgram(tr.collector, tr.loss, tr.buffer, tr.config,
                            device_metrics=default_device_metrics(), device="cpu")
    prog.publish_device_metrics({"obs": ts["obs"]}, registry=other)
    assert other.gauge("rl_tpu_device_loss").value() == flat["loss"]


REFUSED = {
    "host_source_replay": (lambda tr, ts: AsyncOffPolicyTrainer(
        tr.collector, tr.loss, object(), device="cpu"), "A7"),
    "preemption": (lambda tr, ts: next(tr.train(ts, 16, preemption=object())), "A5"),
    "emergency": (lambda tr, ts: next(tr.train(ts, 16, emergency=object())), "A5"),
    "guard": (lambda tr, ts: next(tr.train(ts, 16, guard=object())), "A5"),
    "emergency_save": (lambda tr, ts: tr.emergency_save(object(), ts, 0), "A5"),
    "emergency_restore": (lambda tr, ts: tr.emergency_restore(object(), ts), "A5"),
    "chaos_poison": (lambda tr, ts: tr.k_updates(ts, poison=torch.zeros(())), "A5"),
    "supervisor": (lambda tr, ts: AsyncHostCollector(tr.collector.pool, supervisor=object(),
                                                     device="cpu"), "A5"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_options_off_the_path_raise_naming_their_item(case):
    pool = ThreadedEnvPool([lambda: _HostEnv()])
    try:
        tr = _trainer(pool, PrioritizedSampler(), MetricsRegistry())
        ts = tr.init(seed=0)
        fn, item = REFUSED[case]
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            fn(tr, ts)
        assert tr.collector._thread is None  # nothing was started
    finally:
        pool.close()
