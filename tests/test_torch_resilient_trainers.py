"""Checkpoints and resilience through the port's trainers, on the CPU:
``Trainer`` (PPO), ``GRPOTrainer`` (and the pipelined one) and
``AsyncOffPolicyTrainer``.

- **Resume equals the uninterrupted run, bit for bit.** A run preempted
  after step 2 (the handler's flag, or the injector's ``trainer.preempt``),
  saved, restored into a fresh object built alike and resumed, against
  the same run never interrupted: parameters, Adam's moments and count,
  generators (torch and the host's numpy streams), collector and replay
  states, device metrics and the metrics history. The async trainer's
  actor thread and env pool are not in a checkpoint (nor in the
  reference's), so its run is held at the device: the same host chunks
  through ``replay.extend`` and ``offpolicy.k_updates``.
- **Against the reference.** A PPO update and a K-update after a restore
  follow the reference's, restored through its own checkpoint (orbax),
  at the tolerances of ``test_update_from_batch_matches_reference`` and
  ``test_k_updates_match_reference``; a poisoned GRPO update leaves the
  master weights, Adam and the metrics as the reference's poisoned
  ``_update_impl`` does, with ``bad_steps`` counted.
- **Guard and supervisor.** ``LastGoodState`` rolls the GRPO trainer back
  after two bad steps; a supervised rollout producer crashed by the
  injector is restarted and the pipelined run goes on.

The resilience files' autouse fixture checks each test for leaked
injectors, signal handlers, global generator moves and threads; every
path is under ``tmp_path`` and every metric goes to a fresh registry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_async_offpolicy import (_HostEnv, _trainer, flat_items,  # noqa: F401
                                        fresh_registries, k_update_pair, reference_draws)
from test_torch_grpo import numpy_batch, to_torch
from test_torch_off_policy import assert_params_match
from test_torch_on_policy import (N_ENVS, T_STEPS, assert_params_close, jax_program,
                                  port_program, t, to_port)
from test_torch_registry import _assert_trees_equal
from test_torch_resilience import no_process_state  # noqa: F401

from rl_tpu.checkpoint import Checkpoint as JaxCheckpoint
from rl_tpu.envs.llm import arithmetic_dataset as jax_arithmetic_dataset
from rl_tpu.models import TransformerConfig as JaxConfig
from rl_tpu.models import TransformerLM as JaxLM
from rl_tpu.obs import MetricsRegistry as JaxMetricsRegistry
from rl_tpu.obs import TraceRecorder as JaxTraceRecorder
from rl_tpu.resilience import EmergencyCheckpointer as JaxEmergency
from rl_tpu.trainers import GRPOTrainer as JaxGRPOTrainer
from rl_tpu_torch.checkpoint import Checkpoint, restore_into
from rl_tpu_torch.collectors import ThreadedEnvPool
from rl_tpu_torch.data import PrioritizedSampler
from rl_tpu_torch.envs import CartPoleEnv, RewardSum, TransformedEnv, VmapEnv
from rl_tpu_torch.envs.llm import arithmetic_dataset
from rl_tpu_torch.models import TransformerConfig, params_from_flax
from rl_tpu_torch.modules import params_from_flax as loss_params_from_flax
from rl_tpu_torch.obs import MetricsRegistry, TraceRecorder
from rl_tpu_torch.resilience import (EmergencyCheckpointer, Fault, FaultInjector, LastGoodState,
                                     Supervisor, injection)
from rl_tpu_torch.trainers import GRPOTrainer, PipelinedGRPOTrainer, Trainer, make_ppo_trainer
from rl_tpu_torch.trainers.resilience import PreemptionHandler

torch.set_num_threads(1)
SMALL = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64, max_seq_len=24)
P, N = 12, 8  # prompt and response tokens
TIMEOUT = 30.0


def _registries():
    return dict(registry=MetricsRegistry(), tracer=TraceRecorder())


def _ppo_trainer(total, **kw):
    env = TransformedEnv(VmapEnv(CartPoleEnv(), 8), RewardSum())
    program = make_ppo_trainer(env, total_steps=total, frames_per_batch=64,
                               device="cpu").program
    return Trainer(program, total, device="cpu", **kw)


def _metrics_log(trainer):
    seen = []
    trainer.register_op("post_step", lambda tr, m: seen.append(
        {k: v.clone() for k, v in m.items(nested=True, leaves_only=True)}))
    return seen


def test_ppo_trainer_resume_equals_the_uninterrupted_run(tmp_path):
    """5 PPO steps against 2, a preemption (its checkpoint) and a fresh
    trainer's ``auto_resume`` for the other 3: the last 3 steps' metrics,
    the parameters, Adam, the generator, the collector state and the
    counters bit for bit."""
    whole = _ppo_trainer(5)
    seen_whole = _metrics_log(whole)
    whole.train(0)
    root = str(tmp_path / "ck")
    first = _ppo_trainer(50, checkpoint=Checkpoint(root, capture_rng=False))
    handler = PreemptionHandler(**_registries())
    first.register_op("post_step", lambda tr, m: handler.preempt() if tr.step_count == 2
                      else None)
    first.register_op("post_step", handler)
    first.train(0)
    assert first.step_count == 2 and Checkpoint(root).latest_step() == 2
    resumed = _ppo_trainer(5, checkpoint=Checkpoint(root, capture_rng=False), auto_resume=True)
    seen_resumed = _metrics_log(resumed)
    resumed.train(7)  # the seed is overwritten by the restore
    assert resumed.step_count == 5 and resumed.collected_frames == whole.collected_frames
    for a, b in zip(seen_whole[2:], seen_resumed):
        _assert_trees_equal(a, b)
    _assert_trees_equal(resumed.ts["collector"], whole.ts["collector"])
    assert resumed.ts["update_count"] == whole.ts["update_count"]
    assert torch.equal(resumed.ts["generator"].get_state(), whole.ts["generator"].get_state())
    opt_w, opt_r = whole.ts["optimizer"], resumed.ts["optimizer"]
    for a, b in zip(opt_w.params + opt_w.mu + opt_w.nu + [opt_w.count],
                    opt_r.params + opt_r.mu + opt_r.nu + [opt_r.count]):
        assert torch.equal(a, b)


def test_ppo_update_after_a_restore_follows_the_reference(tmp_path):
    """The reference updates once, saves through its own ``Checkpoint``
    (orbax), restores into a fresh state and updates again on its next
    batch; the port does the same from the reference's parameters, batches
    and permutations through its own checkpoint: parameters within the
    whole-update tolerance (rtol 1e-5, atol 2e-6) after each update. The
    second update's Adam bias correction reads the restored count."""
    cfg = dict(num_epochs=2, minibatch_size=256)
    jprog = jax_program(cfg)
    jts = jprog.init(jax.random.key(0))
    update = jax.jit(jprog.update_from_batch)
    collect = jax.jit(jprog.collector.collect)
    prog = port_program(cfg)
    ts = prog.init(torch.Generator().manual_seed(0))
    loss_params_from_flax(prog.loss, jax.tree.map(np.asarray, jts["params"]))
    n = N_ENVS * T_STEPS
    jholder = {"ts": None}
    jckpt = JaxCheckpoint(str(tmp_path / "ref"), capture_rng=False)
    jckpt.register("ts", lambda: jholder["ts"], lambda v: jholder.update(ts=v),
                   template=lambda: jholder["ts"])
    ckpt = Checkpoint(str(tmp_path / "port"), capture_rng=False)
    box = {}
    ckpt.register("state", lambda: box["live"],
                  lambda v: box.update(live=restore_into(box["live"], v)),
                  template=lambda: box["live"])
    for step in range(2):
        batch, cstate = collect(jts["params"], jts["collector"])
        keys = jax.random.split(jts["rng"], cfg["num_epochs"] + 1)[1:]
        perms = [t(jax.random.permutation(k, n)) for k in keys]
        params, opt, rng, _ = update(jts["params"], jts["opt"], jts["rng"], batch)
        jts = {**jts, "params": params, "opt": opt, "rng": rng, "collector": cstate}
        ts, _ = prog.update_from_batch(ts, to_port(batch), permutations=perms)
        assert_params_close(prog, jts["params"], 1e-5, 2e-6)
        if step == 0:  # both round-trip through their checkpoints into fresh states
            jholder["ts"] = jts
            jckpt.save(1)
            jholder["ts"] = jprog.init(jax.random.key(9))
            jckpt.load(1)
            jts = jholder["ts"]
            box["live"] = {"ts": ts, "loss": prog.loss.state_dict(keep_vars=True)}
            ckpt.save(1)
            prog = port_program(cfg)
            box["live"] = {"ts": prog.init(torch.Generator().manual_seed(9)),
                           "loss": prog.loss.state_dict(keep_vars=True)}
            ckpt.load(1)
            ts = box["live"]["ts"]
    assert ts["optimizer"].count.item() == 2 * cfg["num_epochs"] * n // 256


def _grpo(cls=GRPOTrainer, **kw):
    cfg = TransformerConfig(**SMALL, dtype=torch.float32)
    return cls(arithmetic_dataset(32, max_operand=4), model_config=cfg, num_prompts=2,
               group_repeats=2, max_prompt_len=P, max_new_tokens=N, learning_rate=1e-2,
               device="cpu", **kw)


def _grpo_state(tr):
    return {"params": [p.detach().clone() for p in tr.policy.parameters()],
            "opt": [x.clone() for x in tr.opt.mu + tr.opt.nu + [tr.opt.count]],
            "dm": {k: {n: v.clone() for n, v in d.items()} for k, d in tr._dm.items()},
            "history": {k: list(v) for k, v in tr.history.items()},
            "env_rng": tr.env._rng.bit_generator.state,
            "seeds": tr._seeds.bit_generator.state, "version": tr.policy_version.version}


def test_grpo_resume_equals_the_uninterrupted_run(tmp_path):
    """4 GRPO steps against 2, a preemption through the injector's
    ``trainer.preempt`` (the emergency checkpoint at step 2) and a fresh
    trainer's ``emergency_restore`` for the other 2: master weights, Adam,
    device metrics, the lagged history, the chat env's and the seeds'
    streams and the policy version bit for bit."""
    whole = _grpo()
    whole.train(4)
    first = _grpo()
    handler = PreemptionHandler(**_registries())
    emergency = EmergencyCheckpointer(str(tmp_path / "em"), **_registries())
    inj = FaultInjector({"trainer.preempt": Fault("preempt", at=(3,), target=handler)},
                        **_registries())
    with injection(inj):
        first.train(4, preemption=handler, emergency=emergency)
    assert len(first.history["loss"]) == 2 and emergency.latest_step() == 2
    resumed = _grpo()  # built alike (the frozen reference model is the seed's init) ...
    with torch.no_grad():  # ... then moved away from the checkpoint in every saved part
        for p in resumed.policy.parameters():
            p.add_(0.5)
    resumed._seeds.integers(9, size=3)
    resumed.env._rng.random(3)
    resumed.train(1)
    start = resumed.emergency_restore(emergency)
    assert start == 2
    resumed.train(2, start_step=start)
    a, b = _grpo_state(whole), _grpo_state(resumed)
    for x, y in zip(a["params"] + a["opt"], b["params"] + b["opt"]):
        assert torch.equal(x, y)
    _assert_trees_equal(a["dm"], b["dm"])
    assert a["history"] == b["history"] and len(a["history"]["loss"]) == 4
    assert (a["env_rng"], a["seeds"], a["version"]) == (b["env_rng"], b["seeds"], b["version"])


def test_grpo_poisoned_update_leaves_the_state_as_the_reference(tmp_path):
    """The ``grpo.update`` NaN poison: the reference's ``_update_impl`` and
    the port's update body (eager, and through the ``grpo.update``
    program) on the same weights and batch keep the master weights and
    Adam unchanged and count one bad step and no update, with the same
    reward and token gauges."""
    jtr = JaxGRPOTrainer(jax_arithmetic_dataset(32, max_operand=4),
                         model_config=JaxConfig(**SMALL, dtype=jnp.float32), num_prompts=2,
                         group_repeats=2, max_prompt_len=P, max_new_tokens=N)
    jm = JaxLM(JaxConfig(**SMALL, dtype=jnp.float32))
    batch = numpy_batch(jm, jtr.params, seed=4)
    batch["group_id"] = np.array([0, 0, 1, 1], np.int32)
    batch["policy_version"] = np.zeros(4, np.int32)
    jparams, _, jdm = jtr._update_impl(jtr.params, jtr.opt_state, batch, jtr._dm,
                                       jnp.float32(np.nan))
    jflat = jtr._dm_spec.to_flat(jtr._dm_spec.drain(jdm))
    for warmup in (False, True):
        tr = _grpo(warmup=warmup)
        tr.policy.load_state_dict(params_from_flax(jax.tree.map(np.asarray, jparams),
                                                   tr.policy.cfg))
        before = [p.detach().clone() for p in tr.policy.parameters()]
        inj = FaultInjector({"grpo.update": Fault("nan", at=(1,))}, **_registries())
        with injection(inj):
            tr._update(to_torch(batch))
        assert inj.fired == [("grpo.update", "nan", 1)]
        assert all(torch.equal(a, b) for a, b in zip(before, tr.policy.parameters()))
        assert tr.opt.count.item() == 0.0 and all(not m.any() for m in tr.opt.mu)
        flat = tr._dm_spec.to_flat(tr._dm_spec.drain(tr._dm_spec.drain_async(tr._dm)))
        for k in ("updates", "bad_steps", "loss", "kl_approx", "tokens"):
            assert flat[k] == jflat[k], k
        assert flat["bad_steps"] == 1 and flat["updates"] == 0
        np.testing.assert_allclose(flat["reward"], jflat["reward"], rtol=1e-6)


def test_grpo_guard_rolls_back_after_two_bad_steps():
    """Steps 2 and 3 (from 0) poisoned: the lagged ``bad_steps`` reach the
    guard at steps 3 and 4, which rolls the master weights and Adam back
    to the snapshot taken at step 2 (the weights after steps 0 and 1, as
    the poisoned step 2 left them) and re-publishes them to the serving
    copy."""
    tr = _grpo()
    guard = LastGoodState(rollback_after=2, snapshot_interval=1, **_registries())
    tr.train(2, guard=guard)
    after_two = [p.detach().clone() for p in tr.policy.parameters()]
    inj = FaultInjector({"grpo.update": Fault("nan", at=(1, 2))}, **_registries())
    with injection(inj):
        tr.train(2, guard=guard, start_step=2)
    tr.train(1, guard=guard, start_step=4)
    assert guard.rollbacks == 1 and guard.snapshot_version == 2
    assert all(torch.equal(a, b) for a, b in zip(after_two, tr.policy.parameters()))
    serving = dict(tr.gen_model.named_parameters())
    assert all(torch.equal(serving[n], p) for n, p in tr.policy.named_parameters())


def test_pipelined_producer_crash_is_restarted_and_the_run_checkpoints(tmp_path):
    """A ``grpo.rollout`` crash in the pipelined trainer's producer: the
    supervisor re-enters the loop once, the run keeps its staleness bound,
    and an emergency save first stops the producer (no thread left)."""
    sup = Supervisor(backoff_base_s=0.0, jitter=0.0, **_registries())
    tr = _grpo(PipelinedGRPOTrainer, supervisor=sup, continuous_batching=False)
    try:
        inj = FaultInjector({"grpo.rollout": Fault("crash", at=(2,))}, **_registries())
        with injection(inj):
            tr.train(3)
        assert sup.restarts("grpo-rollout") == 1 and inj.fired[0][:2] == ("grpo.rollout", "crash")
        assert max(tr.staleness_history) <= 1 and len(tr.history["loss"]) == 3
        emergency = EmergencyCheckpointer(str(tmp_path / "em"), **_registries())
        tr.emergency_save(emergency, 3)
        assert tr._pipeline is None and emergency.latest_step() == 3
    finally:
        tr.close()
        sup.stop(timeout=TIMEOUT)
    assert not any(c.is_alive() for c in sup.children())


def _dispatch(tr, ts, chunks):
    for items in chunks:
        ts = {**ts, "buffer": tr.extend(ts["buffer"], items)}
        ts, _ = tr.k_updates(ts)
    return ts


def test_async_trainer_resume_equals_the_uninterrupted_dispatches(tmp_path, fresh_registries):
    """4 chunk writes and K-updates against 2, an emergency save, a fresh
    trainer's ``emergency_restore`` and the other 2: parameters, targets,
    Adam, the replay (storage and PER tree), the generator, the device
    metrics and the update count bit for bit."""
    rng = np.random.default_rng(8)
    chunks = [flat_items(rng, 16, version=c)[1] for c in range(4)]
    pool = ThreadedEnvPool([lambda: _HostEnv()])
    try:
        whole = _trainer(pool, PrioritizedSampler(), MetricsRegistry())
        ts_w = _dispatch(whole, whole.init(seed=1), chunks)
        first = _trainer(pool, PrioritizedSampler(), MetricsRegistry())
        ts_f = _dispatch(first, first.init(seed=1), chunks[:2])
        emergency = EmergencyCheckpointer(str(tmp_path / "em"), **_registries())
        first.emergency_save(emergency, ts_f, 32)
        resumed = _trainer(pool, PrioritizedSampler(), MetricsRegistry())
        ts_r, frames = resumed.emergency_restore(emergency, resumed.init(seed=6))
        assert frames == 32
        ts_r = _dispatch(resumed, ts_r, chunks[2:])
    finally:
        pool.close()
    _assert_trees_equal(ts_r, ts_w)
    assert torch.equal(ts_r["generator"].get_state(), ts_w["generator"].get_state())
    for a, b in zip(whole._hidden_state(), resumed._hidden_state()):
        assert torch.equal(a, b)


def test_async_k_update_after_a_restore_follows_the_reference(tmp_path):
    """The reference dispatches a K-update, saves its train state with its
    ``EmergencyCheckpointer`` (orbax), restores it into a fresh state and
    dispatches again; the port does the same from the reference's state
    and draws through its own: parameters, targets and ``log_alpha``
    within ``test_k_updates_match_reference``'s tolerances after each."""
    jtr, jts, ptr, pts = k_update_pair()
    jem = JaxEmergency(str(tmp_path / "ref"), registry=JaxMetricsRegistry(),
                       tracer=JaxTraceRecorder())
    em = EmergencyCheckpointer(str(tmp_path / "port"), **_registries())
    for step in range(2):
        out, _ = jtr._k_updates(jts["params"], jts["opt"], jts["buffer"], jts["rng"],
                                jts["update_count"], jts["obs"])
        draws = reference_draws(jts["rng"], 2, 8)
        jts = dict(zip(("params", "opt", "buffer", "rng", "update_count", "obs"), out))
        pts, _ = ptr.k_program(ptr._inner(pts), draws)
        pts = {**pts, "update_count": int(jts["update_count"])}
        assert_params_match(ptr, jts["params"])
        if step == 0:
            jem.save(1, jts, {"frames": 48})
            jts, _, _ = jem.restore(jax.tree.map(lambda x: x, jts))
            ptr.emergency_save(em, pts, 48)
            _, _, other, template = k_update_pair()
            pts, frames = other.emergency_restore(em, template)
            ptr = other
            assert frames == 48
    assert ptr.publish_device_metrics(pts)["updates"] == 4
