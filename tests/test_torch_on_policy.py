"""The on-policy program (``OnPolicyProgram``), the hook-driven ``Trainer``,
the loggers and the PPO/A2C trainer factories of the port against ``rl_tpu``, on
the CPU, float32.

``update_from_batch`` is held to the reference's from the same state: the
reference's params carried in (``params_from_flax``), Adam's moments at
zero in both, the reference's own collected batch and its epoch
permutations (``jax.random.permutation`` of the keys it splits) fed to
the port. 32 envs x 32 steps, MLPs of 32x32, minibatch 128.

Tolerances. One clipped Adam update (1 epoch, the whole batch): every
parameter within rtol 1e-6, atol 1e-7, the loss and metrics within rtol
1e-5, atol 1e-6. The whole update (4 epochs x 8 minibatches, 32 updates):
parameters within rtol 1e-5, atol 2e-6; metrics within rtol 1e-5, atol
1e-6. Measured on these inputs: at most 6e-8 on any weight after 32
updates. The bound is wider than that because Adam divides by the root of
the second moment: where a gradient sits near 0 its sign can flip between
two summation orders, and the weight then moves by up to lr (3e-4) the
other way; 2e-6 leaves room for a few such ulp-level moves, not one flip.
"""

import math

import jax
import numpy as np
import optax
import pytest
import torch

from rl_tpu.collectors import Collector as JaxCollector
from rl_tpu.data import ArrayDict as JaxArrayDict
from rl_tpu.envs import CartPoleEnv as JaxCartPole
from rl_tpu.envs import RewardSum as JaxRewardSum
from rl_tpu.envs import TransformedEnv as JaxTransformedEnv
from rl_tpu.envs import VmapEnv as JaxVmapEnv
from rl_tpu.modules import MLP as JaxMLP
from rl_tpu.modules import Categorical as JaxCategorical
from rl_tpu.modules import ProbabilisticActor as JaxActor
from rl_tpu.modules import TDModule as JaxTDModule
from rl_tpu.modules import ValueOperator as JaxValueOperator
from rl_tpu.objectives import ClipPPOLoss as JaxClipPPOLoss
from rl_tpu.trainers import OnPolicyConfig as JaxOnPolicyConfig
from rl_tpu.trainers import OnPolicyProgram as JaxOnPolicyProgram
from rl_tpu.trainers.on_policy import _episode_reward as jax_episode_reward
from rl_tpu_torch.collectors import Collector
from rl_tpu_torch.data import ArrayDict
from rl_tpu_torch.envs import CartPoleEnv, RewardSum, TransformedEnv, VmapEnv
from rl_tpu_torch.modules import (MLP, Categorical, ProbabilisticActor, TDModule, ValueOperator,
                                  params_from_flax)
from rl_tpu_torch.modules.weights import flax_paths, to_port_layout
from rl_tpu_torch.objectives import ClipPPOLoss
from rl_tpu_torch.record import CSVLogger
from rl_tpu_torch.trainers import (OnPolicyConfig, OnPolicyProgram, Trainer, make_a2c_trainer,
                                   make_ppo_trainer)
from rl_tpu_torch.trainers.on_policy import _episode_reward, linear_schedule

torch.set_num_threads(1)
N_ENVS, T_STEPS, CELLS = 32, 32, (32, 32)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def to_port(jad) -> ArrayDict:
    out = ArrayDict()
    for path, leaf in jad.items(nested=True, leaves_only=True):
        out = out.set(path, t(leaf))
    return out


def jax_program(cfg, n_envs=N_ENVS, frames=N_ENVS * T_STEPS, cells=CELLS, max_steps=500):
    env = JaxTransformedEnv(JaxVmapEnv(JaxCartPole(max_episode_steps=max_steps), n_envs),
                            JaxRewardSum())
    actor = JaxActor(JaxTDModule(JaxMLP(out_features=2, num_cells=cells), ["observation"],
                                 ["logits"]), JaxCategorical, dist_keys=("logits",))
    loss = JaxClipPPOLoss(actor, JaxValueOperator(JaxMLP(out_features=1, num_cells=cells)),
                          normalize_advantage=True)
    loss.make_value_estimator(gamma=0.99, lmbda=0.95)
    coll = JaxCollector(env, lambda p, td, k: actor(p["actor"], td, k), frames_per_batch=frames)
    return JaxOnPolicyProgram(coll, loss, JaxOnPolicyConfig(**cfg))


def port_program(cfg, n_envs=N_ENVS, frames=N_ENVS * T_STEPS, cells=CELLS, max_steps=500,
                 entropy_coeff=0.01):
    env = TransformedEnv(VmapEnv(CartPoleEnv(max_episode_steps=max_steps), n_envs), RewardSum())
    actor = ProbabilisticActor(TDModule(MLP(out_features=2, num_cells=cells), ["observation"],
                                        ["logits"]), Categorical, dist_keys=("logits",))
    loss = ClipPPOLoss(actor, ValueOperator(MLP(out_features=1, num_cells=cells)),
                       normalize_advantage=True, entropy_coeff=entropy_coeff)
    loss.make_value_estimator(gamma=0.99, lmbda=0.95)
    coll = Collector(env, actor, frames_per_batch=frames)
    return OnPolicyProgram(coll, loss, OnPolicyConfig(**cfg))


def updates_from_one_state(cfg):
    """The reference's update from its initial state on its own collected
    batch, and the port's from the same params, batch and permutations."""
    jprog = jax_program(cfg)
    jts = jprog.init(jax.random.key(0))
    batch, _ = jax.jit(jprog.collector.collect)(jts["params"], jts["collector"])
    params, _, _, jmetrics = jax.jit(jprog.update_from_batch)(jts["params"], jts["opt"],
                                                              jts["rng"], batch)
    keys = jax.random.split(jts["rng"], cfg["num_epochs"] + 1)[1:]
    n = N_ENVS * T_STEPS
    perms = [t(jax.random.permutation(k, n)) for k in keys]
    prog = port_program(cfg)
    ts = prog.init(torch.Generator().manual_seed(0))
    params_from_flax(prog.loss, jax.tree.map(np.asarray, jts["params"]))
    ts, metrics = prog.update_from_batch(ts, to_port(batch), permutations=perms)
    return params, jmetrics, prog, ts, metrics


def assert_params_close(prog, params, rtol, atol):
    sd = prog.loss.state_dict()
    for name, (path, transposed) in flax_paths(prog.loss).items():
        ref = params
        for k in path:
            ref = ref[k]
        torch.testing.assert_close(sd[name], to_port_layout(np.asarray(ref), transposed),
                                   rtol=rtol, atol=atol, msg=lambda m, n=name: f"{n}: {m}")


@pytest.mark.parametrize("what,cfg,param_tol", [
    ("one_update", dict(num_epochs=1, minibatch_size=N_ENVS * T_STEPS), (1e-6, 1e-7)),
    ("whole_update", dict(num_epochs=4, minibatch_size=128), (1e-5, 2e-6)),
])
def test_update_from_batch_matches_reference(what, cfg, param_tol):
    params, jmetrics, prog, ts, metrics = updates_from_one_state(cfg)
    assert ts["update_count"] == cfg["num_epochs"] * (N_ENVS * T_STEPS // cfg["minibatch_size"])
    assert_params_close(prog, params, *param_tol)
    assert sorted(metrics.keys()) == sorted(jmetrics.keys())
    for k in jmetrics.keys():
        torch.testing.assert_close(metrics[k], t(jmetrics[k]), rtol=1e-5, atol=1e-6, msg=k)


def test_train_step_metric_names_and_nan_rule():
    """The reference's metric names; ``episode_reward_mean`` is NaN when no
    episode ended in the batch and the mean return of those that did."""
    jprog = jax_program(dict(num_epochs=1, minibatch_size=32), n_envs=8, frames=32)
    _, jm = jax.jit(jprog.train_step)(jprog.init(jax.random.key(0)))
    prog = port_program(dict(num_epochs=1, minibatch_size=32), n_envs=8, frames=32)
    ts = prog.init(torch.Generator().manual_seed(0))
    ts, m = prog.train_step(ts)  # 4 steps from a reset: no episode can end
    assert sorted(m.keys()) == sorted(jm.keys())
    assert all(v.dim() == 0 for v in m.values())
    assert math.isnan(m["episode_reward_mean"].item())
    assert math.isnan(float(jm["episode_reward_mean"]))
    # and on a batch where episodes end: the reference's own reduction
    rng = np.random.default_rng(0)
    done = rng.random((6, 5)) < 0.3
    er = rng.uniform(1, 50, (6, 5)).astype(np.float32)
    batch = ArrayDict(next=ArrayDict(episode_reward=t(er), done=t(done),
                                     reward=torch.ones(6, 5)))
    jb = JaxArrayDict({"next": {k: np.asarray(v) for k, v in batch["next"].items()}})
    torch.testing.assert_close(_episode_reward(batch), t(jax_episode_reward(jb)), rtol=1e-6,
                               atol=0)
    assert _episode_reward(ArrayDict(next=ArrayDict(reward=torch.full((3,), 2.0)))).item() == 2.0


def test_anneal_lr_schedule_counts_updates():
    """``anneal_lr_to`` is optax's linear schedule over optimizer updates
    (minibatches); the rate of each update is the schedule at the count
    before it."""
    ref = optax.linear_schedule(1e-3, 1e-4, 10)
    ours = linear_schedule(1e-3, 1e-4, 10)
    for c in (0, 1, 5, 9, 10, 25):
        assert ours(c) == pytest.approx(float(ref(c)), rel=1e-6)
    prog = port_program(dict(num_epochs=2, minibatch_size=64, learning_rate=1e-3,
                             anneal_lr_to=1e-4, total_steps=10), n_envs=8, frames=128)
    ts = prog.init(torch.Generator().manual_seed(0))
    seen = []
    step = ts["optimizer"].step

    def recording(grads, ok, frozen=()):
        seen.append(ts["optimizer"].lr)
        return step(grads, ok, frozen)

    ts["optimizer"].step = recording
    for _ in range(3):  # 4 updates a step: counts 0..11, past the anneal's end
        ts, _ = prog.train_step(ts)
    assert ts["update_count"] == 12
    assert seen == pytest.approx([float(ref(c)) for c in range(12)], rel=1e-6)
    fixed = port_program(dict(num_epochs=1, minibatch_size=64, learning_rate=5e-4),
                         n_envs=8, frames=64)
    assert fixed.schedule(0) == fixed.schedule(1000) == 5e-4


def test_ppo_trainer_hooks_frames_and_logger(tmp_path):
    env = TransformedEnv(VmapEnv(CartPoleEnv(), 8), RewardSum())
    logger = CSVLogger("ppo", log_dir=str(tmp_path))
    trainer = make_ppo_trainer(env, total_steps=3, frames_per_batch=64, logger=logger,
                               log_interval=1, device="cpu")
    assert trainer.program.config.minibatch_size == 64  # min(256, frames_per_batch)
    assert trainer.program.loss.actor.inner.module.num_cells == (256, 256)
    calls = []
    trainer.register_op("pre_step", lambda tr: calls.append(("pre", tr.step_count)))
    trainer.register_op("post_step", lambda tr, m: calls.append(("post", tr.collected_frames)))
    with pytest.raises(ValueError):
        trainer.register_op("mid_step", lambda tr: None)
    ts = trainer.train(0)
    assert trainer.step_count == 3 and trainer.collected_frames == 192
    assert calls == [("pre", 0), ("post", 64), ("pre", 1), ("post", 128), ("pre", 2),
                     ("post", 192)]
    logger.close()
    rows = (tmp_path / "ppo" / "train_loss.csv").read_text().splitlines()
    assert [r.split(",")[0] for r in rows] == ["64", "128", "192"]
    # a later train() continues from the kept state; a hook can stop it
    trainer.total_steps = 10
    trainer.register_op("post_step", lambda tr, m: tr.request_stop())
    assert trainer.train(0, ts=ts) is trainer.ts and trainer.step_count == 4


def test_a2c_trainer_takes_one_full_batch_update():
    env = TransformedEnv(VmapEnv(CartPoleEnv(), 4), RewardSum())
    trainer = make_a2c_trainer(env, total_steps=2, frames_per_batch=32, device="cpu")
    cfg = trainer.program.config
    assert (cfg.num_epochs, cfg.minibatch_size, cfg.learning_rate) == (1, 32, 7e-4)
    trainer.train(1)
    assert trainer.ts["update_count"] == 2
    assert trainer.program.loss.value_estimator.lmbda == 0.95


def test_cartpole_ppo_improves():
    """The reference's learning check at its size
    (``tests/test_collector_ppo.py``): 16 envs, CartPole truncated at 200,
    1024 frames a step, 4 epochs of minibatch 256, 30 steps; the mean
    episode reward of the last 5 steps beats the first 5 by more than 20."""
    prog = port_program(dict(num_epochs=4, minibatch_size=256, learning_rate=3e-4),
                        n_envs=16, frames=1024, cells=(64, 64), max_steps=200)
    ts = prog.init(torch.Generator().manual_seed(0))
    rewards = []
    for _ in range(30):
        ts, metrics = prog.train_step(ts)
        rewards.append(metrics["episode_reward_mean"].item())
    early, late = np.mean(rewards[:5]), np.mean(rewards[-5:])
    assert late > early + 20, f"PPO failed to learn: early={early:.1f} late={late:.1f}"


def test_no_card_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = TransformedEnv(VmapEnv(CartPoleEnv(), 4), RewardSum())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_ppo_trainer(env, total_steps=1, frames_per_batch=32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_a2c_trainer(env, total_steps=1, frames_per_batch=32, device="cuda")
    with pytest.raises(RuntimeError):
        Trainer(port_program(dict(minibatch_size=32), n_envs=4, frames=32), total_steps=1)


def _refused():
    from rl_tpu_torch.envs.transforms import common
    from rl_tpu_torch.objectives import value
    from rl_tpu_torch.record import loggers
    from rl_tpu_torch.trainers import algorithms, trainer

    prog = port_program(dict(minibatch_size=32), n_envs=4, frames=32)
    env = VmapEnv(CartPoleEnv(), 4)
    return {
        "trainer_checkpoint": ("A5", lambda: Trainer(prog, 1, checkpoint=object(),
                                                     device="cpu")),
        "trainer_auto_resume": ("A5", lambda: Trainer(prog, 1, auto_resume=True,
                                                      device="cpu")),
        "make_impala_trainer": ("A7", lambda: algorithms.make_impala_trainer(env, 1)),
        "early_stopping": ("A7", lambda: trainer.EarlyStopping()),
        "tensorboard_and_multi_agent_gae": (
            "A7", lambda: (loggers.TensorboardLogger("x"), value.MultiAgentGAE(None))),
        "reward_scaling": ("A7", lambda: common.RewardScaling()),
    }


@pytest.mark.parametrize("case", ["trainer_checkpoint", "trainer_auto_resume",
                                  "make_impala_trainer", "early_stopping",
                                  "tensorboard_and_multi_agent_gae", "reward_scaling"])
def test_refused_options_raise_naming_their_item(case):
    item, call = _refused()[case]
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        call()


@pytest.mark.cuda
def test_update_on_the_card_matches_the_cpu():
    """One whole ``update_from_batch`` on the card against the same on the
    CPU, from the same weights, batch and permutations (skipped without a
    card; ``chip_smoke.py``'s ``ppo_check`` runs it at a larger size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dict(num_epochs=4, minibatch_size=128)
    perms = [torch.randperm(N_ENVS * T_STEPS, generator=torch.Generator().manual_seed(e))
             for e in range(4)]
    cpu = port_program(cfg)
    ts = cpu.init(torch.Generator().manual_seed(0))
    batch, _ = cpu.collector.collect(ts["collector"])
    start = {k: v.clone() for k, v in cpu.loss.state_dict().items()}
    _, m_cpu = cpu.update_from_batch(ts, batch, permutations=perms)
    card = port_program(cfg)
    tsc = card.init(torch.Generator(device="cuda").manual_seed(0))
    card.loss.load_state_dict({k: v.cuda() for k, v in start.items()})
    _, m_card = card.update_from_batch(tsc, batch.to("cuda"), permutations=perms)
    for n, v in cpu.loss.state_dict().items():
        torch.testing.assert_close(card.loss.state_dict()[n].cpu(), v, rtol=1e-4, atol=1e-5,
                                   msg=n)
    for k, v in m_cpu.items():
        torch.testing.assert_close(m_card[k].cpu(), v, rtol=1e-4, atol=1e-5, msg=k,
                                   equal_nan=True)
