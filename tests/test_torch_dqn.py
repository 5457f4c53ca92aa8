"""DQN on CartPole with device PER, the port against ``rl_tpu``, on the CPU.

The same numpy inputs and the reference's flax parameters go through both
packages; the two draw different random streams, so the port is fed the
reference's draws (epsilon-greedy's uniforms and random actions, the
sampler's uniforms). Tolerances:

- ``QValueModule``/``QValueActor`` actions and ``EGreedyModule`` actions
  and ``eg_step``: equal; the q-values within 1e-6 of their largest
  magnitude (the MLP's float32 sums in another order);
- ``MultiStep``: the same keys, integers and flags equal, floats within
  1e-6;
- ``DQNLoss``: value, metrics and every gradient within 1e-6 of the
  largest magnitude of each;
- ``HardUpdate``: exact;
- one and four whole ``OffPolicyProgram`` updates made by
  ``make_dqn_trainer``, from the reference's params and prefilled PER
  buffer: sampled indices equal; parameters and targets within atol 1e-6
  + rtol 1e-5, Adam's moments within the SAC slice's limits
  (``tests/test_torch_off_policy.py``), the PER tree within rtol 1e-4.
"""

from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_tpu.collectors import Collector as JaxCollector
from rl_tpu.data import ArrayDict as JaxArrayDict
from rl_tpu.data import Categorical as JaxCategoricalSpec
from rl_tpu.data import MultiStep as JaxMultiStep
from rl_tpu.data import OneHot as JaxOneHot
from rl_tpu.envs import CartPoleEnv as JaxCartPole
from rl_tpu.envs import RewardSum as JaxRewardSum
from rl_tpu.envs import TransformedEnv as JaxTransformedEnv
from rl_tpu.envs import VmapEnv as JaxVmapEnv
from rl_tpu.envs.utils import ExplorationType as JaxExplorationType
from rl_tpu.envs.utils import set_exploration_type as jax_set_exploration_type
from rl_tpu.kernels import registry
from rl_tpu.modules import MLP as JaxMLP
from rl_tpu.modules import EGreedyModule as JaxEGreedy
from rl_tpu.modules import QValueActor as JaxQValueActor
from rl_tpu.modules import TDModule as JaxTDModule
from rl_tpu.modules.exploration import _anneal as jax_anneal
from rl_tpu.objectives import DQNLoss as JaxDQNLoss
from rl_tpu.objectives import HardUpdate as JaxHardUpdate
from rl_tpu.trainers import OffPolicyConfig as JaxOffPolicyConfig
from rl_tpu.trainers.algorithms import make_dqn_trainer as jax_make_dqn_trainer
from rl_tpu_torch.collectors import Collector
from rl_tpu_torch.data import ArrayDict, MultiStep, OneHot
from rl_tpu_torch.data import Categorical as CategoricalSpec
from rl_tpu_torch.envs import CartPoleEnv, RewardSum, TransformedEnv, VmapEnv
from rl_tpu_torch.envs.utils import ExplorationType, set_exploration_type
from rl_tpu_torch.modules import MLP, EGreedyModule, QValueActor, TDModule, params_from_flax
from rl_tpu_torch.modules.exploration import _anneal
from rl_tpu_torch.modules.weights import _module_paths, flax_paths, to_port_layout
from rl_tpu_torch.objectives import DQNLoss, HardUpdate
from rl_tpu_torch.trainers import OffPolicyConfig, make_dqn_trainer

torch.set_num_threads(1)
CELLS = (16, 16)


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


def close_to_scale(a, ref, rel=1e-6, err_msg=""):
    """``|a - ref| <= rel * max|ref|``."""
    ref = np.asarray(ref, np.float64)
    atol = rel * max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(a, np.float64), ref, rtol=0, atol=atol,
                               err_msg=err_msg)


def load(module, flax_tree):
    """Carry flax params into a port module that is not a loss."""
    sd = module.state_dict()
    for name, (path, tr) in _module_paths(module, "", ()).items():
        sd[name].copy_(to_port_layout(leaf(flax_tree, path), tr))


@pytest.mark.parametrize("one_hot", [False, True])
def test_qvalue_actor_matches_reference(one_hot):
    obs = np.random.default_rng(0).uniform(-1, 1, (6, 4)).astype(np.float32)
    jactor = JaxQValueActor(JaxMLP(out_features=3, num_cells=CELLS), one_hot=one_hot)
    jtd = JaxArrayDict(observation=jnp.asarray(obs))
    params = jactor.init(jax.random.key(0), jtd)
    ref = jactor(params, jtd)
    actor = QValueActor(MLP(out_features=3, num_cells=CELLS), one_hot=one_hot)
    actor.init(ArrayDict(observation=t(obs)))
    load(actor, params)
    out = actor(ArrayDict(observation=t(obs)))
    close_to_scale(out["action_value"].detach().numpy(), ref["action_value"])
    assert out["action"].dtype == (torch.float32 if one_hot else torch.int32)
    np.testing.assert_array_equal(out["action"].numpy(), np.asarray(ref["action"]))
    close_to_scale(out["chosen_action_value"].detach().numpy(), ref["chosen_action_value"])


def test_egreedy_with_fed_draws_matches_reference():
    """Actions and ``eg_step`` over 6 calls annealing over 4 (past the end),
    categorical and one-hot; every mode but RANDOM passes through."""
    B = 6
    for jspec, spec in ((JaxCategoricalSpec(n=3), CategoricalSpec(n=3)),
                        (JaxOneHot(n=3), OneHot(n=3))):
        kw = dict(eps_init=1.0, eps_end=0.1, annealing_num_steps=4)
        jeg, eg = JaxEGreedy(jspec, **kw), EGreedyModule(spec, **kw)
        q = np.random.default_rng(1).standard_normal((B, 3)).astype(np.float32)
        greedy = np.argmax(q, -1).astype(np.int32)
        if spec.shape:
            greedy = np.eye(3, dtype=np.float32)[greedy]
        jtd, td = JaxArrayDict(action=jnp.asarray(greedy)), ArrayDict(action=t(greedy))
        for step in range(6):
            key = jax.random.key(step)
            k1, k2 = jax.random.split(key)
            draws = (t(jax.random.uniform(k1, (B,))), t(jspec.rand(k2, (B,))))
            jtd, td = jeg(jtd, key), eg(td, draws=draws)
            np.testing.assert_array_equal(td["action"].numpy(), np.asarray(jtd["action"]))
            assert int(td["exploration", "eg_step"]) == int(jtd["exploration", "eg_step"])
            jtd, td = jtd.set("action", jnp.asarray(greedy)), td.set("action", t(greedy))
        assert int(td["exploration", "eg_step"]) == 6
        with set_exploration_type(ExplorationType.MODE):
            assert eg(td) is td
        with jax_set_exploration_type(JaxExplorationType.MODE):
            assert jeg(jtd, jax.random.key(0)) is jtd
    for step in range(7):
        np.testing.assert_array_equal(
            _anneal(1.0, 0.05, 4, torch.tensor(step, dtype=torch.int32)).numpy(),
            np.asarray(jax_anneal(1.0, 0.05, 4, jnp.asarray(step, jnp.int32))))


def multistep_batch(case):
    rng = np.random.default_rng(3)
    if case == "dones_inside_and_at_the_end":
        T, B = 7, 3
        done = np.zeros((T, B), bool)
        done[2, 0] = done[6, 1] = done[4, 2] = done[5, 2] = True
        return {"observation": rng.standard_normal((T, B, 2)).astype(np.float32),
                "action": rng.integers(0, 2, (T, B)).astype(np.int32),
                "next": {"observation": rng.standard_normal((T, B, 2)).astype(np.float32),
                         "reward": rng.standard_normal((T, B)).astype(np.float32),
                         "done": done, "terminated": done & (rng.random((T, B)) < 0.5)}}
    T = 6 if case == "three_step_fold" else 5
    done = (np.zeros(T, bool) if case == "three_step_fold"
            else np.array([False, True, False, False, False]))
    return {"obs": np.arange(T, dtype=np.float32),
            "next": {"obs": np.arange(1, T + 1, dtype=np.float32),
                     "reward": np.ones(T, np.float32), "done": done, "terminated": done}}


@pytest.mark.parametrize("case", ["dones_inside_and_at_the_end", "three_step_fold",
                                  "stops_at_done"])
def test_multistep_matches_reference(case):
    """Random batches with dones inside the window and at its end, and the
    two cases of ``tests/test_replay.py::TestMultiStep``."""
    arrays = multistep_batch(case)
    gamma = {"three_step_fold": 0.5, "stops_at_done": 1.0}.get(case, 0.9)
    ref = JaxMultiStep(gamma=gamma, n_steps=3)(JaxArrayDict(jax.tree.map(jnp.asarray, arrays)))
    out = MultiStep(gamma=gamma, n_steps=3)(to_port(arrays))
    assert sorted(out.keys(nested=True, leaves_only=True)) == sorted(
        ref.keys(nested=True, leaves_only=True))
    for key in ref.keys(nested=True, leaves_only=True):
        a, b = out[key].numpy(), np.asarray(ref[key])
        assert a.dtype == b.dtype, key
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=str(key))
        else:
            np.testing.assert_array_equal(a, b, err_msg=str(key))
    if case == "three_step_fold":
        np.testing.assert_allclose(out["next", "reward"][:3].numpy(), 1.75)
        assert out["next", "obs"][0] == 3.0 and out["steps_to_next_obs"][:3].tolist() == [3] * 3
    if case == "stops_at_done":
        assert out["next", "reward"].tolist() == [2.0, 1.0, 3.0, 2.0, 1.0]


def dqn_pair(double_dqn=True, loss_function="l2", seed=0, B=32):
    """The reference's DQNLoss with its init params (the target moved off
    the online net) and a batch, and the port's loss holding the same."""
    rng = np.random.default_rng(seed)
    obs = rng.uniform(-1, 1, (B, 4)).astype(np.float32)
    jloss = JaxDQNLoss(JaxTDModule(JaxMLP(out_features=3, num_cells=CELLS), ["observation"],
                                   ["action_value"]),
                       gamma=0.9, double_dqn=double_dqn, loss_function=loss_function)
    params = jloss.init_params(jax.random.key(seed), JaxArrayDict(observation=jnp.asarray(obs)))
    params["target_qvalue"] = jax.tree.map(
        lambda x: x + 0.1 * jnp.asarray(rng.standard_normal(x.shape), x.dtype),
        params["target_qvalue"])
    done = rng.random(B) < 0.3
    arrays = {"observation": obs, "action": rng.integers(0, 3, B).astype(np.int32),
              "next": {"observation": rng.uniform(-1, 1, (B, 4)).astype(np.float32),
                       "reward": (3.0 * rng.standard_normal(B)).astype(np.float32),
                       "done": done, "terminated": done & (rng.random(B) < 0.5)}}
    if double_dqn:  # n-step folded, PER-weighted transitions
        arrays["steps_to_next_obs"] = rng.integers(1, 4, B).astype(np.int32)
        arrays["_weight"] = rng.uniform(0.2, 1.0, B).astype(np.float32)
    ploss = DQNLoss(TDModule(MLP(out_features=3, num_cells=CELLS), ["observation"],
                             ["action_value"]),
                    gamma=0.9, double_dqn=double_dqn, loss_function=loss_function)
    ploss.init_params(ArrayDict(observation=t(obs)))
    params_from_flax(ploss, jax.tree.map(np.asarray, params))
    return jloss, params, arrays, ploss


@pytest.mark.parametrize("double_dqn", [True, False])
@pytest.mark.parametrize("loss_function", ["l2", "smooth_l1"])
def test_dqn_loss_value_metrics_and_gradients_match(double_dqn, loss_function):
    jloss, params, arrays, ploss = dqn_pair(double_dqn, loss_function)
    jbatch = JaxArrayDict(jax.tree.map(jnp.asarray, arrays))

    def f(q):
        return jloss({**params, "qvalue": q}, jbatch)

    (jval, jmetrics), jgrads = jax.value_and_grad(f, has_aux=True)(params["qvalue"])
    val, grads, metrics = ploss.grad(to_port(arrays))
    close_to_scale(val.numpy(), jval)
    for k in ("loss_qvalue", "td_error", "q_mean"):
        close_to_scale(metrics[k].numpy(), jmetrics[k], err_msg=k)
    if loss_function == "smooth_l1":  # both branches of the Huber loss ran
        td = np.asarray(jmetrics["td_error"])
        assert (td < 1.0).any() and (td > 1.0).any()
    paths = flax_paths(ploss)
    names = [n for n, _ in ploss.trainable_parameters()]
    assert len(names) == len(grads) == 6
    for name, g in zip(names, grads):
        path, tr = paths[name]
        close_to_scale(g.numpy(), to_port_layout(leaf({"qvalue": jgrads}, path), tr).numpy(),
                       err_msg=name)


def test_hard_update_copies_exactly_on_its_period():
    jloss, params, _, ploss = dqn_pair()
    jhard, hard = JaxHardUpdate(jloss, 3), HardUpdate(ploss, 3)
    paths = flax_paths(ploss)

    def same_as(jparams):
        for name, v in ploss.state_dict().items():
            path, tr = paths[name]
            np.testing.assert_array_equal(v.numpy(), to_port_layout(leaf(jparams, path),
                                                                    tr).numpy(), err_msg=name)

    before = {k: v.clone() for k, v in ploss.target_qvalue.state_dict().items()}
    out = jhard(params, jnp.asarray(4))
    hard(4)
    same_as(out)
    hard(torch.tensor(6), ok=torch.tensor(False))  # a rejected step copies nothing
    for k, v in ploss.target_qvalue.state_dict().items():
        assert torch.equal(v, before[k]), k
    out = jhard(params, jnp.asarray(6))
    hard(torch.tensor(6))
    same_as(out)
    assert all(torch.equal(a, b) for a, b in zip(ploss.qvalue.parameters(),
                                                   ploss.target_qvalue.parameters()))


def test_collector_carries_the_exploration_state():
    """``Collector(policy_state=...)`` carries ``eg_step`` from step to step
    and batch to batch, out of the recorded batch, as the reference's."""
    jenv = JaxVmapEnv(JaxCartPole(), 4)
    jeg = JaxEGreedy(jenv.action_spec, annealing_num_steps=10)
    jcoll = JaxCollector(jenv, lambda p, td, k: jeg(td.set("action", jnp.zeros(4, jnp.int32)),
                                                    k),
                         frames_per_batch=8, policy_state=jeg.init_state())
    env = VmapEnv(CartPoleEnv(), 4)
    eg = EGreedyModule(env.action_spec, annealing_num_steps=10)
    coll = Collector(env, lambda td, g: eg(td.set("action", torch.zeros(4, dtype=torch.int32)),
                                           g),
                     frames_per_batch=8, policy_state=eg.init_state())
    jcs, cs = jcoll.init(jax.random.key(0)), coll.init(torch.Generator().manual_seed(0))
    for _ in range(3):
        jbatch, jcs = jcoll.collect(None, jcs)
        batch, cs = coll.collect(cs)
        assert "exploration" not in batch and "exploration" not in jbatch
        assert int(cs["carry"]["exploration", "eg_step"]) == int(
            jcs["carry"]["exploration", "eg_step"])
    assert int(cs["carry"]["exploration", "eg_step"]) == 6
    assert batch["action"].dtype == torch.int32


N_ENVS, FRAMES, BATCH, CAP = 4, 16, 8, 64


def dqn_programs(utd):
    """The reference's and the port's ``make_dqn_trainer`` programs at a
    small size, the port holding the reference's params and prefilled PER
    buffer."""
    cfg = dict(batch_size=BATCH, utd_ratio=utd, init_random_frames=32, tau=0.01)
    jtr = jax_make_dqn_trainer(
        JaxTransformedEnv(JaxVmapEnv(JaxCartPole(), N_ENVS), JaxRewardSum()), 1,
        qnet=JaxTDModule(JaxMLP(out_features=2, num_cells=CELLS), ["observation"],
                         ["action_value"]),
        buffer_capacity=CAP, frames_per_batch=FRAMES, config=JaxOffPolicyConfig(**cfg))
    ptr = make_dqn_trainer(
        TransformedEnv(VmapEnv(CartPoleEnv(), N_ENVS), RewardSum()), 1,
        qnet=TDModule(MLP(out_features=2, num_cells=CELLS), ["observation"], ["action_value"]),
        buffer_capacity=CAP, frames_per_batch=FRAMES, config=OffPolicyConfig(**cfg),
        device="cpu")
    jprog, pprog = jtr.program, ptr.program
    jts = jprog.prefill(jprog.init(jax.random.key(0)))
    pts = pprog.init(seed=0)
    params_from_flax(pprog.loss, jax.tree.map(np.asarray, jts["params"]))
    pts["buffer"] = to_port(jts["buffer"])
    return jprog, jts, pprog, pts


@pytest.mark.parametrize("utd", [1, 4])
def test_dqn_program_updates_match_reference(utd):
    jprog, jts, pprog, pts = dqn_programs(utd)
    seen = []
    sample = jprog.buffer.sample

    def recording(*args, **kw):
        batch, st = sample(*args, **kw)
        seen.append(np.asarray(batch["index"]))
        return batch, st

    jprog.buffer.sample = recording
    _, *upd_keys = jax.random.split(jts["rng"], utd + 1)
    carry = (jts["params"], jts["opt"], jts["buffer"], None)
    draws = []
    for i, key in enumerate(upd_keys):
        carry, _ = jprog._update_body(carry, (key, jnp.asarray(i, jnp.int32)))
        draws.append((t(jax.random.uniform(jax.random.split(key)[0], (BATCH,))),))
    jparams, jopt, jbuf, _ = carry

    pseen = []
    psample = pprog.buffer.sample

    def precording(*args, **kw):
        batch, st = psample(*args, **kw)
        pseen.append(batch["index"].numpy().copy())
        return batch, st

    pprog.buffer.sample = precording
    pts, metrics = pprog.updates(pts, draws)
    assert len(pseen) == len(seen) == utd
    for a, b in zip(pseen, seen):
        np.testing.assert_array_equal(a, b)
    paths = flax_paths(pprog.loss)
    for name, (path, tr) in paths.items():
        np.testing.assert_allclose(pprog.loss.state_dict()[name].numpy(),
                                   to_port_layout(leaf(jparams, path), tr).numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    adam = jopt[0][0]
    names = [n for n, _ in pprog.loss.trainable_parameters()]
    for name, mu, nu in zip(names, pprog.optimizer.mu, pprog.optimizer.nu):
        path, tr = paths[name]
        np.testing.assert_allclose(mu.numpy(), to_port_layout(leaf(adam.mu, path), tr).numpy(),
                                   rtol=1e-4, atol=1e-7, err_msg=name)
        np.testing.assert_allclose(nu.numpy(), to_port_layout(leaf(adam.nu, path), tr).numpy(),
                                   rtol=2e-4, atol=1e-9, err_msg=name)
    assert int(pprog.optimizer.count) == int(adam.count) == utd
    ps, js = pts["buffer"]["sampler"], jbuf["sampler"]
    for k in ("priorities", "esum", "max_priority"):
        np.testing.assert_allclose(ps[k].numpy(), np.asarray(js[k]), rtol=1e-4, atol=0,
                                   err_msg=k)
    assert not np.array_equal(ps["priorities"].numpy(),
                              np.asarray(jts["buffer"]["sampler", "priorities"]))
    assert int(ps["step"]) == int(js["step"]) == utd
    assert np.isfinite(metrics["loss"].item())


def test_make_dqn_trainer_trains_on_cpu():
    """The reference's factory check (``tests/test_algorithms_comm.py``) on
    the port: two steps of ``make_dqn_trainer`` over 4 CartPole envs."""
    env = TransformedEnv(VmapEnv(CartPoleEnv(), 4), RewardSum())
    tr = make_dqn_trainer(env, total_steps=2, frames_per_batch=64, buffer_capacity=1024,
                          config=OffPolicyConfig(batch_size=32, init_random_frames=64),
                          device="cpu")
    seen = []
    tr.register_op("post_step", lambda trainer, m: seen.append(m))
    ts = tr.train(0)
    assert tr.step_count == 2 and tr.collected_frames == 128
    for m in seen:
        assert all(np.isfinite(m[k].item()) for k in ("loss", "loss_qvalue", "q_mean",
                                                      "reward_mean")), m
    assert int(ts["buffer"]["storage", "size"]) == 192
    assert int(ts["collector"]["carry"]["exploration", "eg_step"]) == 48  # 16 + 2 x 16 steps
    data = ts["buffer"]["storage", "data"]
    assert data["action"].dtype == torch.int32 and "steps_to_next_obs" in data
    assert ts["update_count"] == 2


@pytest.mark.parametrize("case", ["distributional_dqn", "densify_and_random_policy"])
def test_remaining_stubs_raise_naming_their_item(case):
    from rl_tpu_torch.data import postprocs
    from rl_tpu_torch.modules import exploration
    from rl_tpu_torch.objectives import dqn

    item, calls = {
        "distributional_dqn": ("A7", [lambda: dqn.DistributionalDQNLoss(None, None)]),
        "densify_and_random_policy": ("A7", [lambda: postprocs.DensifyReward(),
                                             lambda: exploration.RandomPolicy(None)]),
    }[case]
    for call in calls:
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            call()
