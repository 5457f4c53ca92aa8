"""The DDPG/TD3 slice of the port against ``rl_tpu``, on the CPU, at a small
size (Pendulum's 3-wide observation and 1-wide action in [-2, 2], MLPs of
(32, 32), batch 8), float32: ``TanhPolicy``, the additive Gaussian and
Ornstein-Uhlenbeck noise modules, ``DDPGLoss``, ``TD3Loss`` and
``TD3BCLoss``, TD3 through ``OffPolicyProgram`` with ``policy_delay=2``,
and the ``make_td3_trainer`` and ``make_ddpg_trainer`` factories.

Same flax weights (``params_from_flax``; the targets moved off the online
nets so that their use shows), same numpy inputs, and the reference's
own normal draws fed to the port (the exploration noise, TD3's smoothing
noise). Tolerances, as ``test_torch_off_policy_parts.py`` states them:
the policy's action within rtol 1e-5 / atol 1e-6 (its MLP's products
summed in another order, as the critic ensemble's); the noise modules'
outputs within rtol 1e-6 / atol 1e-6 (the same float32 formulas); each
loss and its
metrics within rtol 1e-5 and every gradient within rtol 1e-4 / atol
1e-6 of ``jax.value_and_grad``; after the program's updates, parameters
and targets within rtol 1e-5 / atol 1e-6 and Adam's moments within rtol
1e-4 / atol 1e-7 (first) and rtol 2e-4 / atol 1e-9 (second), as
``test_torch_off_policy.py`` holds SAC's.
"""

import collections
import dataclasses
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_tpu.collectors import Collector as JaxCollector
from rl_tpu.data import ArrayDict as JaxArrayDict
from rl_tpu.data import Bounded as JaxBounded
from rl_tpu.data.replay import DeviceStorage as JaxDeviceStorage
from rl_tpu.data.replay import ReplayBuffer as JaxReplayBuffer
from rl_tpu.envs import PendulumEnv as JaxPendulum
from rl_tpu.envs import VmapEnv as JaxVmapEnv
from rl_tpu.modules import AdditiveGaussianModule as JaxAG
from rl_tpu.modules import ConcatMLP as JaxConcatMLP
from rl_tpu.modules import OrnsteinUhlenbeckModule as JaxOU
from rl_tpu.modules import TanhPolicy as JaxTanhPolicy
from rl_tpu.modules import TDModule as JaxTDModule
from rl_tpu.objectives import DDPGLoss as JaxDDPGLoss
from rl_tpu.objectives import TD3BCLoss as JaxTD3BCLoss
from rl_tpu.objectives import TD3Loss as JaxTD3Loss
from rl_tpu.trainers import OffPolicyConfig as JaxOffPolicyConfig
from rl_tpu.trainers import OffPolicyProgram as JaxOffPolicyProgram
from rl_tpu.trainers.algorithms import make_ddpg_trainer as jax_make_ddpg_trainer
from rl_tpu.trainers.algorithms import make_td3_trainer as jax_make_td3_trainer
from rl_tpu_torch.collectors import Collector
from rl_tpu_torch.data import ArrayDict, Bounded, DeviceStorage, ReplayBuffer
from rl_tpu_torch.envs import PendulumEnv, RewardSum, TransformedEnv, VmapEnv
from rl_tpu_torch.modules import (AdditiveGaussianModule, ConcatMLP, OrnsteinUhlenbeckModule,
                                  TanhPolicy, TDModule, params_from_flax)
from rl_tpu_torch.modules.weights import flax_paths, to_port_layout
from rl_tpu_torch.objectives import DDPGLoss, TD3BCLoss, TD3Loss
from rl_tpu_torch.trainers import (OffPolicyConfig, OffPolicyProgram, make_ddpg_trainer,
                                   make_td3_trainer)

torch.set_num_threads(1)
CELLS = (32, 32)
B = 8


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def to_port(tree) -> ArrayDict:
    return ArrayDict({k: (to_port(v) if isinstance(v, Mapping) else t(v))
                      for k, v in tree.items()})


def leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def jax_actor():
    return JaxTDModule(JaxTanhPolicy(action_dim=1, num_cells=CELLS, low=-2.0, high=2.0),
                       ["observation"], ["action"])


def port_actor():
    return TDModule(TanhPolicy(action_dim=1, num_cells=CELLS, low=-2.0, high=2.0),
                    ["observation"], ["action"])


LOSSES = {
    "ddpg_l2": (lambda a, q: JaxDDPGLoss(a, q, gamma=0.9),
                lambda a, q: DDPGLoss(a, q, gamma=0.9)),
    "ddpg_smooth_l1": (lambda a, q: JaxDDPGLoss(a, q, gamma=0.9, loss_function="smooth_l1"),
                       lambda a, q: DDPGLoss(a, q, gamma=0.9, loss_function="smooth_l1")),
    # policy_noise 1.0: the noise clip and the action bounds both bite
    "td3": (lambda a, q: JaxTD3Loss(a, q, -2.0, 2.0, policy_noise=1.0),
            lambda a, q: TD3Loss(a, q, -2.0, 2.0, policy_noise=1.0)),
    "td3bc": (lambda a, q: JaxTD3BCLoss(a, q, -2.0, 2.0, policy_noise=1.0, alpha=2.0),
              lambda a, q: TD3BCLoss(a, q, -2.0, 2.0, policy_noise=1.0, alpha=2.0)),
}


def loss_pair(kind, seed=0):
    """The reference's loss with its ``init_params`` (targets moved by
    noise) and the port's holding the same, and a batch of both."""
    make_j, make_p = LOSSES[kind]
    rng = np.random.default_rng(seed)
    obs = rng.uniform(-1, 1, (B, 3)).astype(np.float32)
    jloss = make_j(jax_actor(), JaxConcatMLP(out_features=1, num_cells=CELLS))
    params = jloss.init_params(jax.random.key(seed), JaxArrayDict(observation=jnp.asarray(obs)))
    for k in ("target_actor", "target_qvalue"):
        params[k] = jax.tree.map(
            lambda x: x + 0.1 * jnp.asarray(rng.standard_normal(x.shape), x.dtype), params[k])
    ploss = make_p(port_actor(), ConcatMLP(out_features=1, num_cells=CELLS))
    ploss.init_params(ArrayDict(observation=t(obs)))
    params_from_flax(ploss, jax.tree.map(np.asarray, params))
    term = rng.random(B) < 0.3
    raw = dict(observation=obs, action=rng.uniform(-1.99, 1.99, (B, 1)).astype(np.float32),
               steps_to_next_obs=rng.integers(1, 4, B).astype(np.int32),
               next=dict(observation=rng.uniform(-1, 1, (B, 3)).astype(np.float32),
                         reward=(3.0 * rng.standard_normal(B)).astype(np.float32),
                         terminated=term))
    return (jloss, params, JaxArrayDict(jax.tree.map(jnp.asarray, raw)), ploss,
            ArrayDict(jax.tree.map(t, raw)))


def assert_grads_match(ploss, grads, jgrads):
    paths = flax_paths(ploss)
    names = [n for n, _ in ploss.trainable_parameters()]
    assert len(names) == len(jax.tree.leaves(jgrads)) == len(grads)
    for name, g in zip(names, grads):
        path, transposed = paths[name]
        ref = to_port_layout(leaf(jgrads, path), transposed)
        np.testing.assert_allclose(g.numpy(), ref.numpy(), rtol=1e-4, atol=1e-6, err_msg=name)


# -- modules ----------------------------------------------------------------------


def test_tanh_policy_matches_reference():
    """The actor's action (inside [-2, 2], tanh saturating for large inputs)
    and the flax layout of its weights."""
    obs = np.random.default_rng(0).uniform(-30, 30, (64, 3)).astype(np.float32)
    jactor = jax_actor()
    params = jactor.init(jax.random.key(1), JaxArrayDict(observation=jnp.asarray(obs)))
    assert set(params) == {"MLP_0"}
    actor = port_actor()
    actor.init(ArrayDict(observation=t(obs)))
    loss = torch.nn.Module()
    loss.actor = actor
    params_from_flax(loss, {"actor": jax.tree.map(np.asarray, params)})
    ref = np.asarray(jactor(params, JaxArrayDict(observation=jnp.asarray(obs)))["action"])
    out = actor(ArrayDict(observation=t(obs)))["action"].detach().numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    assert np.abs(out).max() <= 2.0 and np.abs(out).max() > 1.5


def test_additive_gaussian_anneals_and_projects_as_the_reference():
    """Five calls over a 3-step anneal (sigma 1.5 -> 0.5, then flat), the
    reference's normal draws fed: actions projected into the spec, the step
    carried in the td."""
    rng = np.random.default_rng(2)
    kw = dict(sigma_init=1.5, sigma_end=0.5, annealing_num_steps=3, mean=0.1)
    jag = JaxAG(JaxBounded(shape=(1,), low=-2.0, high=2.0), **kw)
    ag = AdditiveGaussianModule(Bounded(shape=(1,), low=-2.0, high=2.0), **kw)
    jtd = JaxArrayDict(exploration=jag.init_state())
    td = ArrayDict(exploration=ag.init_state())
    clipped = 0
    for step in range(5):
        act = rng.uniform(-2, 2, (16, 1)).astype(np.float32)
        key = jax.random.key(step)
        jtd = jag(jtd.set("action", jnp.asarray(act)), key)
        td = ag(td.set("action", t(act)), draws=t(jax.random.normal(key, (16, 1))))
        np.testing.assert_allclose(td["action"].numpy(), np.asarray(jtd["action"]), rtol=1e-6,
                                   atol=1e-6)
        assert int(td["exploration", "ag_step"]) == int(jtd["exploration", "ag_step"]) == step + 1
        clipped += int((td["action"].abs() == 2.0).sum())
    assert clipped > 0
    with pytest.raises(ValueError, match="Generator"):
        ag(td)
    assert ag(td, torch.Generator().manual_seed(0))["action"].shape == (16, 1)


def test_ou_noise_resets_where_is_init_as_the_reference():
    """Six calls of the OU process with an annealed sigma; rows 0-3 start
    again (``is_init``) at the fourth call; the noise state and the
    projected actions follow the reference's, and the reset changed the
    restarted rows only."""
    kw = dict(theta=0.3, mu=0.2, sigma=0.5, dt=0.05, sigma_init=2.0, sigma_end=0.5,
              annealing_num_steps=4)
    jou = JaxOU(JaxBounded(shape=(2,), low=-1.0, high=1.0), **kw)
    ou = OrnsteinUhlenbeckModule(Bounded(shape=(2,), low=-1.0, high=1.0), **kw)
    rng = np.random.default_rng(3)
    jtd = JaxArrayDict(exploration=jou.init_state((8, 2)))
    td = ArrayDict(exploration=ou.init_state((8, 2)))
    for step in range(6):
        act = rng.uniform(-1, 1, (8, 2)).astype(np.float32)
        is_init = np.arange(8) < 4 if step == 3 else np.zeros(8, bool)
        key = jax.random.key(10 + step)
        eps = t(jax.random.normal(key, (8, 2)))
        jtd = jou(jtd.set("action", jnp.asarray(act)).set("is_init", jnp.asarray(is_init)), key)
        kept = ou(td.set("action", t(act)).set("is_init", t(np.zeros(8, bool))), draws=eps)
        td = ou(td.set("action", t(act)).set("is_init", t(is_init)), draws=eps)
        np.testing.assert_allclose(td["exploration", "ou_noise"].numpy(),
                                   np.asarray(jtd["exploration", "ou_noise"]), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(td["action"].numpy(), np.asarray(jtd["action"]), rtol=1e-6,
                                   atol=1e-6)
        assert int(td["exploration", "ou_step"]) == int(jtd["exploration", "ou_step"]) == step + 1
        differs = (td["exploration", "ou_noise"] != kept["exploration", "ou_noise"]).any(-1)
        assert differs.tolist() == is_init.tolist()


# -- losses -----------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(LOSSES))
def test_loss_value_metrics_and_gradients_match(kind):
    jloss, params, jb, ploss, pb = loss_pair(kind, seed=1)
    key = jax.random.key(7)
    (jval, jmet), jgrads = jax.value_and_grad(
        lambda tr: jloss(jloss.merge(tr, params), jb, key), has_aux=True)(
        jloss.trainable(params))
    noise = (t(jax.random.normal(key, (B, 1))),)
    val, grads, met = ploss.grad(pb, noise=noise)
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
    assert set(met.keys()) == set(jmet.keys())
    for name in met.keys():
        np.testing.assert_allclose(met[name].numpy(), np.asarray(jmet[name]), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    assert_grads_match(ploss, grads, jgrads)


def test_td3_draws_from_the_generator_or_refuses():
    """A call with neither a generator nor noise raises, as the reference's
    call without a key does; a generator's draw is the fed noise of the
    same draw."""
    jloss, params, jb, ploss, pb = loss_pair("td3")
    with pytest.raises(ValueError, match="key"):
        jloss(params, jb)
    with pytest.raises(ValueError, match="Generator"):
        ploss(pb)
    val, _ = ploss(pb, generator=torch.Generator().manual_seed(5))
    eps = torch.randn((B, 1), generator=torch.Generator().manual_seed(5))
    fed, _ = ploss(pb, noise=(eps,))
    assert torch.equal(val, fed)


# -- the program ------------------------------------------------------------------

N_ENVS, FRAMES, CAP = 4, 16, 64


def td3_programs():
    """TD3 programs of both packages (4 Pendulum envs, additive Gaussian
    exploration, uniform device replay, batch 8, ``policy_delay=2``), the
    port holding the reference's params and prefilled buffer."""
    cfg = dict(batch_size=B, utd_ratio=1, init_random_frames=32, policy_delay=2)
    jloss = JaxTD3Loss(jax_actor(), JaxConcatMLP(out_features=1, num_cells=CELLS), -2.0, 2.0)
    jnoise = JaxAG(JaxPendulum().action_spec, sigma_init=0.1, sigma_end=0.1)
    jcoll = JaxCollector(JaxVmapEnv(JaxPendulum(), N_ENVS),
                         lambda p, td, k: jnoise(jloss.actor(p["actor"], td), k),
                         frames_per_batch=FRAMES, policy_state=jnoise.init_state())
    jprog = JaxOffPolicyProgram(jcoll, jloss, JaxReplayBuffer(JaxDeviceStorage(CAP)),
                                JaxOffPolicyConfig(**cfg))
    ploss = TD3Loss(port_actor(), ConcatMLP(out_features=1, num_cells=CELLS), -2.0, 2.0)
    env = VmapEnv(PendulumEnv(), N_ENVS)
    noise = AdditiveGaussianModule(env.action_spec, sigma_init=0.1, sigma_end=0.1)
    pcoll = Collector(env, lambda td, g: noise(ploss.actor(td), g), frames_per_batch=FRAMES,
                      policy_state=noise.init_state())
    pprog = OffPolicyProgram(pcoll, ploss, ReplayBuffer(DeviceStorage(CAP)),
                             OffPolicyConfig(**cfg), device="cpu")
    jts = jprog.prefill(jprog.init(jax.random.key(0)))
    pts = pprog.init(seed=0)
    params_from_flax(pprog.loss, jax.tree.map(np.asarray, jts["params"]))
    pts["buffer"] = to_port(jts["buffer"])
    return jprog, jts, pprog, pts


def test_td3_program_with_policy_delay_matches_reference_over_3_updates():
    """Updates 0 and 2 move the policy, update 1 holds it (its Adam moments
    still decay, its target still moves toward it), in both packages: after
    each update the port's parameters, targets and Adam state equal the
    reference's; the sampled indices are the reference's (fed)."""
    jprog, jts, pprog, pts = td3_programs()
    seen = []
    sample = jprog.buffer.sample

    def recording(*args, **kw):
        batch, st = sample(*args, **kw)
        seen.append(np.asarray(batch["index"]))
        return batch, st

    jprog.buffer.sample = recording
    carry = (jts["params"], jts["opt"], jts["buffer"], None)
    size = int(jts["buffer"]["storage", "size"])
    paths = flax_paths(pprog.loss)
    names = [n for n, _ in pprog.loss.trainable_parameters()]
    for i, key in enumerate(jax.random.split(jax.random.key(42), 3)):
        actor_before = {n: v.clone() for n, v in pprog.loss.actor.state_dict().items()}
        carry, jm = jprog._update_body(carry, (key, jnp.asarray(i, jnp.int32)))
        k_sample, k_loss = jax.random.split(key)
        u = (t(seen[-1]).to(torch.float32) + 0.5) / size  # floor(u * size) is the index
        pts, pm = pprog.updates(pts, [(u, t(jax.random.normal(k_loss, (B, 1))))])
        jparams, jopt = carry[0], carry[1]
        for name, (path, tr) in paths.items():
            np.testing.assert_allclose(pprog.loss.state_dict()[name].numpy(),
                                       to_port_layout(leaf(jparams, path), tr).numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=f"update {i}: {name}")
        adam = jopt[0][0]
        for name, mu, nu in zip(names, pprog.optimizer.mu, pprog.optimizer.nu):
            path, tr = paths[name]
            np.testing.assert_allclose(mu.numpy(), to_port_layout(leaf(adam.mu, path), tr),
                                       rtol=1e-4, atol=1e-7, err_msg=f"update {i}: {name}")
            np.testing.assert_allclose(nu.numpy(), to_port_layout(leaf(adam.nu, path), tr),
                                       rtol=2e-4, atol=1e-9, err_msg=f"update {i}: {name}")
        moved = any(not torch.equal(actor_before[n], v)
                    for n, v in pprog.loss.actor.state_dict().items())
        assert moved == (i % 2 == 0), f"update {i}"
        for k in ("loss", "loss_qvalue", "loss_actor"):
            np.testing.assert_allclose(pm[k].item(), float(jm[k]), rtol=1e-5, atol=1e-6)
    assert int(pprog.optimizer.count) == int(carry[1][0][0].count) == 3
    assert pts["update_count"] == 3


# -- the factories ----------------------------------------------------------------


def _shapes(named) -> dict:
    """Per top-level group, the multiset of each parameter's sorted dims."""
    out = collections.defaultdict(collections.Counter)
    for name, shape in named:
        out[name.split(".")[0]][tuple(sorted(shape))] += 1
    return dict(out)


FACTORIES = {"td3": (make_td3_trainer, jax_make_td3_trainer),
             "ddpg": (make_ddpg_trainer, jax_make_ddpg_trainer)}


@pytest.mark.parametrize("algo", sorted(FACTORIES))
def test_factory_defaults_match_reference(algo):
    """The parts the factory builds: the parameter shapes (256x256 tanh
    actor, its critics, the targets), the loss's settings, the config, the
    buffer and its sampler, the exploration state, steps and frames."""
    ours_f, ref_f = FACTORIES[algo]
    kw = dict(total_steps=5, frames_per_batch=16, buffer_capacity=256)
    ours = ours_f(VmapEnv(PendulumEnv(), 4), device="cpu", **kw)
    ref = ref_f(JaxVmapEnv(JaxPendulum(), 4), **kw)
    p, r = ours.program, ref.program
    jts = r.init(jax.random.key(0))
    pts = p.init(0)
    flat = jax.tree_util.tree_flatten_with_path(jts["params"])[0]
    ref_shapes = _shapes((".".join(str(getattr(k, "key", k)) for k in path), leaf_.shape)
                         for path, leaf_ in flat)
    assert _shapes((n, tuple(v.shape)) for n, v in p.loss.named_parameters()) == ref_shapes
    n_q = 2 if algo == "td3" else 1
    assert ref_shapes["target_qvalue"][(n_q, 256, 256)] == 1
    assert ref_shapes["target_actor"][(256, 256)] == 1
    assert dataclasses.asdict(p.config) == dataclasses.asdict(r.config)
    assert p.config.init_random_frames == 5000
    assert p.config.policy_delay == (2 if algo == "td3" else 1)
    assert p.loss.gamma == r.loss.gamma == 0.99
    if algo == "td3":
        assert (p.loss.policy_noise, p.loss.noise_clip, p.loss.num_qvalue_nets) == (
            r.loss.policy_noise, r.loss.noise_clip, r.loss.num_qvalue_nets)
        assert (p.loss.action_low, p.loss.action_high) == (
            float(r.loss.action_low), float(r.loss.action_high)) == (-2.0, 2.0)
    else:
        assert p.loss.loss_function == r.loss.loss_function
    assert p.buffer.capacity == r.buffer.capacity == 256
    assert type(p.buffer.sampler).__name__ == type(r.buffer.sampler).__name__ == "RandomSampler"
    assert p.priority_key is r.priority_key is None
    noise = p.collector.policy.noise
    assert (noise.sigma_init, noise.sigma_end) == (0.1, 0.1)
    assert set(pts["collector"]["carry"]["exploration"].keys()) == set(
        jts["collector"]["carry"]["exploration"].keys()) == {"ag_step"}
    assert ours.total_steps == ref.total_steps and p.collector.frames_per_batch == 16


@pytest.mark.parametrize("algo", sorted(FACTORIES))
def test_factory_trains_two_steps_on_cpu(algo):
    """The reference's factory check (``tests/test_algorithms_comm.py``) on
    the port: two steps over 4 Pendulum envs, finite losses, the
    exploration step carried across the random prefill and the steps."""
    env = TransformedEnv(VmapEnv(PendulumEnv(), 4), RewardSum())
    tr = FACTORIES[algo][0](env, total_steps=2, frames_per_batch=64, buffer_capacity=1024,
                            config=OffPolicyConfig(batch_size=32, init_random_frames=64,
                                                   policy_delay=2), device="cpu")
    seen = []
    tr.register_op("post_step", lambda trainer, m: seen.append(m))
    ts = tr.train(0)
    assert tr.step_count == 2 and tr.collected_frames == 128
    assert all(np.isfinite(m["loss"].item()) for m in seen)
    assert int(ts["buffer"]["storage", "size"]) == 192
    assert int(ts["collector"]["carry"]["exploration", "ag_step"]) == 48  # 16 + 2 x 16 steps
    assert ts["update_count"] == 2
