"""REDQ, CrossQ and discrete SAC in the port against ``rl_tpu``, on the CPU,
at a small size (Pendulum's widths, MLPs of (32, 32), batch 8; discrete
SAC on CartPole's 4-wide observation and 3 actions), float32.

Same flax weights (``params_from_flax``), same numpy inputs, and the
reference's own draws fed to the port: the two normals of the SAC-style
actor and REDQ's M-of-N subset (``jax.random.choice`` without
replacement). CrossQ's ``BatchNormMLP`` is held to flax's ``BatchNorm``
in train and eval mode, and its running statistics after a step threaded
by hand, as the reference's own test threads them. One reference fault is
pinned: the reference's ``OffPolicyProgram`` drops the statistics that
``CrossQLoss`` returns, so they never move there; the port's program
writes them back behind the finite guard.

Tolerances, as ``test_torch_off_policy_parts.py`` states them: each loss
and its metrics within rtol 1e-5 (atol 1e-6 for metrics near 0) and every
gradient within rtol 1e-4 / atol 1e-6 of ``jax.value_and_grad``; the
batch-norm forward within rtol 1e-5 / atol 1e-6 and the running
statistics within rtol 1e-5 / atol 1e-7 (batch means summed in another
order); after a program step, parameters within rtol 1e-5 / atol 1e-6.
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
from rl_tpu.data.replay import DeviceStorage as JaxDeviceStorage
from rl_tpu.data.replay import ReplayBuffer as JaxReplayBuffer
from rl_tpu.envs import PendulumEnv as JaxPendulum
from rl_tpu.envs import VmapEnv as JaxVmapEnv
from rl_tpu.modules import MLP as JaxMLP
from rl_tpu.modules import Categorical as JaxCategorical
from rl_tpu.modules import ConcatMLP as JaxConcatMLP
from rl_tpu.modules import NormalParamExtractor as JaxNPE
from rl_tpu.modules import ProbabilisticActor as JaxActor
from rl_tpu.modules import TDModule as JaxTDModule
from rl_tpu.modules import TDSequential as JaxTDSequential
from rl_tpu.modules import TanhNormal as JaxTanhNormal
from rl_tpu.objectives import CrossQLoss as JaxCrossQLoss
from rl_tpu.objectives import DiscreteSACLoss as JaxDiscreteSACLoss
from rl_tpu.objectives import REDQLoss as JaxREDQLoss
from rl_tpu.trainers import OffPolicyConfig as JaxOffPolicyConfig
from rl_tpu.trainers import OffPolicyProgram as JaxOffPolicyProgram
from rl_tpu.trainers.algorithms import make_crossq_trainer as jax_make_crossq_trainer
from rl_tpu.trainers.algorithms import make_redq_trainer as jax_make_redq_trainer
from rl_tpu_torch.collectors import Collector
from rl_tpu_torch.data import ArrayDict, DeviceStorage, ReplayBuffer
from rl_tpu_torch.envs import CartPoleEnv, PendulumEnv, RewardSum, TransformedEnv, VmapEnv
from rl_tpu_torch.modules import (MLP, Categorical, ConcatMLP, NormalParamExtractor,
                                  ProbabilisticActor, TanhNormal, TDModule, TDSequential,
                                  params_from_flax)
from rl_tpu_torch.modules.weights import flax_paths, to_port_layout
from rl_tpu_torch.objectives import CrossQLoss, DiscreteSACLoss, REDQLoss
from rl_tpu_torch.trainers import (OffPolicyConfig, OffPolicyProgram, make_crossq_trainer,
                                   make_redq_trainer)

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
    return JaxActor(
        JaxTDSequential(JaxTDModule(JaxMLP(out_features=2, num_cells=CELLS), ["observation"],
                                    ["raw"]),
                        JaxTDModule(JaxNPE(), ["raw"], ["loc", "scale"])),
        JaxTanhNormal, dist_kwargs={"low": -2.0, "high": 2.0})


def port_actor():
    return ProbabilisticActor(
        TDSequential(TDModule(MLP(out_features=2, num_cells=CELLS), ["observation"], ["raw"]),
                     TDModule(NormalParamExtractor(), ["raw"], ["loc", "scale"])),
        TanhNormal, dist_kwargs={"low": -2.0, "high": 2.0})


def batch(seed):
    rng = np.random.default_rng(seed)
    term = rng.random(B) < 0.3
    raw = dict(observation=rng.uniform(-1, 1, (B, 3)).astype(np.float32),
               action=rng.uniform(-1.99, 1.99, (B, 1)).astype(np.float32),
               steps_to_next_obs=rng.integers(1, 4, B).astype(np.int32),
               next=dict(observation=rng.uniform(-1, 1, (B, 3)).astype(np.float32),
                         reward=(3.0 * rng.standard_normal(B)).astype(np.float32),
                         terminated=term))
    return JaxArrayDict(jax.tree.map(jnp.asarray, raw)), ArrayDict(jax.tree.map(t, raw))


def carried(jloss, ploss, seed, moved=()):
    """The reference's ``init_params`` (the entries in ``moved`` shifted by
    noise, variances kept positive) carried into the port's loss."""
    rng = np.random.default_rng(seed)
    obs = rng.uniform(-1, 1, (B, 3)).astype(np.float32)
    params = jloss.init_params(jax.random.key(seed), JaxArrayDict(observation=jnp.asarray(obs)))
    for k in moved:
        params[k] = jax.tree_util.tree_map_with_path(
            lambda path, x: (x + 0.1 * jnp.asarray(rng.standard_normal(x.shape), x.dtype)
                             if not path or getattr(path[-1], "key", None) != "var"
                             else x * jnp.asarray(rng.uniform(0.5, 2.0, x.shape), x.dtype)),
            params[k])
    ploss.init_params(ArrayDict(observation=t(obs)))
    params_from_flax(ploss, jax.tree.map(np.asarray, params))
    return params


def assert_grads_match(ploss, grads, jgrads):
    paths = flax_paths(ploss)
    names = [n for n, _ in ploss.trainable_parameters()]
    assert len(names) == len(jax.tree.leaves(jgrads)) == len(grads)
    for name, g in zip(names, grads):
        path, transposed = paths[name]
        ref = to_port_layout(leaf(jgrads, path), transposed)
        np.testing.assert_allclose(g.numpy(), ref.numpy(), rtol=1e-4, atol=1e-6, err_msg=name)


def assert_metrics_match(met, jmet, skip=()):
    assert set(met.keys()) == set(jmet.keys())
    for name in met.keys():
        if name not in skip:
            np.testing.assert_allclose(met[name].numpy(), np.asarray(jmet[name]), rtol=1e-5,
                                       atol=1e-6, err_msg=name)


def assert_stats_match(stats, jstats):
    for path, v in stats.items(nested=True, leaves_only=True):
        np.testing.assert_allclose(v.numpy(), leaf(jstats, path), rtol=1e-5, atol=1e-7,
                                   err_msg="/".join(path))


# -- REDQ -------------------------------------------------------------------------


def redq_pair(seed=0):
    jloss = JaxREDQLoss(jax_actor(), JaxConcatMLP(out_features=1, num_cells=CELLS),
                        num_qvalue_nets=5, sub_sample_len=2, gamma=0.9)
    ploss = REDQLoss(port_actor(), ConcatMLP(out_features=1, num_cells=CELLS),
                     num_qvalue_nets=5, sub_sample_len=2, gamma=0.9)
    params = carried(jloss, ploss, seed, moved=("target_qvalue", "log_alpha"))
    return jloss, params, ploss


def redq_noise(key):
    """The reference's three draws from its loss key, in the port's order."""
    k_sub, k_next, k_pi = jax.random.split(key, 3)
    subset = jax.random.choice(k_sub, 5, (2,), replace=False)
    return (t(jax.random.normal(k_next, (B, 1))), t(jax.random.normal(k_pi, (B, 1))),
            t(subset).to(torch.int64))


@pytest.mark.parametrize("seed", [1, 2])
def test_redq_loss_value_metrics_and_gradients_match(seed):
    """Two keys, two subsets of 2 of the 5 target critics."""
    jloss, params, ploss = redq_pair(seed)
    jb, pb = batch(seed + 10)
    key = jax.random.key(seed + 20)
    (jval, jmet), jgrads = jax.value_and_grad(
        lambda tr: jloss(jloss.merge(tr, params), jb, key), has_aux=True)(
        jloss.trainable(params))
    val, grads, met = ploss.grad(pb, noise=redq_noise(key))
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
    assert_metrics_match(met, jmet)
    assert_grads_match(ploss, grads, jgrads)


def test_redq_subset_from_the_generator_is_m_distinct_critics():
    """Drawn on the device from uniform keys (argsort, no host read): 2
    distinct members of 5, every member drawn over many calls, and the loss
    equal to the fed call with the same three draws."""
    _, _, ploss = redq_pair()
    _, pb = batch(3)
    seen = collections.Counter()
    for s in range(200):
        g = torch.Generator().manual_seed(s)
        subset = torch.argsort(torch.rand(5, generator=g))[:2]
        assert len(set(subset.tolist())) == 2
        seen.update(subset.tolist())
    assert set(seen) == set(range(5)) and min(seen.values()) > 40
    g = torch.Generator().manual_seed(7)
    val, _ = ploss(pb, generator=g)
    g = torch.Generator().manual_seed(7)
    subset = torch.argsort(torch.rand(5, generator=g))[:2]
    eps = (torch.randn((B, 1), generator=g), torch.randn((B, 1), generator=g))
    fed, _ = ploss(pb, noise=(*eps, subset))
    assert torch.equal(val, fed)
    with pytest.raises(ValueError, match="Generator"):
        ploss(pb)


# -- CrossQ -----------------------------------------------------------------------


def crossq_pair(seed=0):
    jloss = JaxCrossQLoss(jax_actor(), num_qvalue_nets=2, num_cells=CELLS, gamma=0.9)
    ploss = CrossQLoss(port_actor(), num_qvalue_nets=2, num_cells=CELLS, gamma=0.9)
    params = carried(jloss, ploss, seed, moved=("qvalue", "batch_stats", "log_alpha"))
    return jloss, params, ploss


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batchnorm_critic_forward_matches_flax(train):
    """The joint forward over ``[current; next]`` (the reference's
    ``_q_joint``): both halves' Q values, and in train mode the updated
    running statistics of every BatchNorm of both members (scales, biases
    and statistics moved off their initial values)."""
    jloss, params, ploss = crossq_pair(4)
    jb, pb = batch(5)
    next_a = np.random.default_rng(6).uniform(-2, 2, (B, 1)).astype(np.float32)
    q_cur, q_next, jstats = jloss._q_joint(params["qvalue"], params["batch_stats"],
                                           jb["observation"], jb["action"],
                                           jb["next", "observation"], jnp.asarray(next_a), train)
    q, stats = ploss.qvalue(torch.cat([pb["observation"], pb["next", "observation"]]),
                            torch.cat([pb["action"], t(next_a)]), train=train)
    np.testing.assert_allclose(q[:, :B, 0].detach().numpy(), np.asarray(q_cur), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(q[:, B:, 0].detach().numpy(), np.asarray(q_next), rtol=1e-5,
                               atol=1e-6)
    if train:
        assert len(stats) == 3 and stats[0][0].shape == (2, 4)
        port = ArrayDict({f"BatchNorm_{i}": ArrayDict(mean=m, var=v)
                          for i, (m, v) in enumerate(stats)})
        assert_stats_match(port, jstats)
    else:
        assert stats is None


def test_crossq_loss_and_its_stats_threaded_by_hand_match():
    """Two steps threaded by hand, as the reference's CrossQ test threads
    them: each step's loss, metrics, gradients and updated statistics
    equal the reference's, the second step running on the statistics the
    first returned (written into the port's buffers by
    ``commit_state``)."""
    jloss, params, ploss = crossq_pair(7)
    for step in range(2):
        jb, pb = batch(8 + step)
        key = jax.random.key(9 + step)
        (jval, jmet), jgrads = jax.value_and_grad(
            lambda tr: jloss(jloss.merge(tr, params), jb, key), has_aux=True)(
            jloss.trainable(params))
        k_next, k_pi = jax.random.split(key)
        noise = (t(jax.random.normal(k_next, (B, 1))), t(jax.random.normal(k_pi, (B, 1))))
        val, grads, met = ploss.grad(pb, noise=noise)
        np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
        assert_metrics_match(met, jmet, skip=("batch_stats",))
        assert_stats_match(met["batch_stats"], jmet["batch_stats"])
        assert_grads_match(ploss, grads, jgrads)
        before = [b.clone() for b in ploss.buffers()]
        assert "batch_stats" not in ploss.commit_state(met)
        assert all(not torch.equal(a, b) for a, b in zip(before, ploss.buffers()))
        params = {**params, "batch_stats": jmet["batch_stats"].to_dict()}
        for name, (path, _) in flax_paths(ploss).items():
            if path[0] == "batch_stats":
                np.testing.assert_array_equal(ploss.state_dict()[name].numpy(),
                                              met["batch_stats"][path[1:]].numpy())


N_ENVS, FRAMES, CAP = 4, 16, 64


def crossq_programs():
    """CrossQ programs of both packages (uniform device replay, batch 8),
    the port holding the reference's params, statistics and buffer."""
    cfg = dict(batch_size=B, utd_ratio=1, init_random_frames=32)
    jloss = JaxCrossQLoss(jax_actor(), num_cells=CELLS)
    jcoll = JaxCollector(JaxVmapEnv(JaxPendulum(), N_ENVS),
                         lambda p, td, k: jloss.actor(p["actor"], td, k), frames_per_batch=FRAMES)
    jprog = JaxOffPolicyProgram(jcoll, jloss, JaxReplayBuffer(JaxDeviceStorage(CAP)),
                                JaxOffPolicyConfig(**cfg))
    ploss = CrossQLoss(port_actor(), num_cells=CELLS)
    pcoll = Collector(VmapEnv(PendulumEnv(), N_ENVS), lambda td, g: ploss.actor(td, g),
                      frames_per_batch=FRAMES)
    pprog = OffPolicyProgram(pcoll, ploss, ReplayBuffer(DeviceStorage(CAP)),
                             OffPolicyConfig(**cfg), device="cpu")
    jts = jprog.prefill(jprog.init(jax.random.key(0)))
    pts = pprog.init(seed=0)
    params_from_flax(pprog.loss, jax.tree.map(np.asarray, jts["params"]))
    pts["buffer"] = to_port(jts["buffer"])
    return jprog, jts, pprog, pts


def program_step(jprog, jts, pprog, pts, key):
    """One update of each program from ``key``: the reference's scan body,
    the port fed its indices and normals. Returns the reference's params
    after it, the minibatch it sampled, and the port's state."""
    seen = []
    sample = jprog.buffer.sample

    def recording(*args, **kw):
        mb, st = sample(*args, **kw)
        seen.append(mb)
        return mb, st

    jprog.buffer.sample = recording
    carry, _ = jprog._update_body((jts["params"], jts["opt"], jts["buffer"], None),
                                  (key, jnp.asarray(0, jnp.int32)))
    k_next, k_pi = jax.random.split(jax.random.split(key)[1])
    size = int(jts["buffer"]["storage", "size"])
    u = (t(seen[0]["index"]).to(torch.float32) + 0.5) / size  # floor(u * size): its index
    pts, metrics = pprog.updates(pts, [(u, t(jax.random.normal(k_next, (B, 1))),
                                        t(jax.random.normal(k_pi, (B, 1))))])
    return carry[0], seen[0], pts, metrics


def test_crossq_program_step_moves_the_stats_where_the_reference_drops_them():
    """The reference's fault, pinned: after one ``OffPolicyProgram`` update
    its running statistics are still their initial values (its
    ``_grad_step`` keeps only the trainable params and the scalar
    metrics), though its loss returned new ones. The port's step writes
    those new ones (the reference loss's own, on the same minibatch and
    draws) into the critics' buffers, and its parameters match the
    reference's update (but for the three biases whose gradient is
    rounding alone, below)."""
    jprog, jts, pprog, pts = crossq_programs()
    key = jax.random.key(3)
    jparams, jmb, pts, metrics = program_step(jprog, jts, pprog, pts, key)
    jax.tree.map(np.testing.assert_array_equal, jparams["batch_stats"],
                 jts["params"]["batch_stats"])
    _, jmet = jprog.loss(jts["params"], jmb, jax.random.split(key)[1])
    paths = flax_paths(pprog.loss)
    lr = pprog.config.learning_rate
    for name, (path, tr) in paths.items():
        ours = pprog.loss.state_dict()[name].numpy()
        if path[0] == "batch_stats":
            ref = leaf(jmet["batch_stats"], path[1:])
        else:
            ref = to_port_layout(leaf(jparams, path), tr).numpy()
        if name in ("qvalue.biases.0", "qvalue.biases.1", "qvalue.bn_biases.0"):
            # these reach a train-mode BatchNorm through affine maps only,
            # and it subtracts them again: their gradient is 0 but for
            # rounding, whose sign Adam's first step turns into a move of
            # up to lr, in both packages
            init = to_port_layout(leaf(jts["params"], path), tr).numpy()
            assert np.abs(ours - init).max() <= lr * (1 + 1e-3)
            assert np.abs(ref - init).max() <= lr * (1 + 1e-3)
            continue
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6, err_msg=name)
    assert "batch_stats" not in metrics and np.isfinite(metrics["loss"].item())
    assert not np.allclose(pprog.loss.qvalue.mean_0.numpy(),
                           leaf(jts["params"], ("batch_stats", "BatchNorm_0", "mean")))


def test_crossq_bad_step_keeps_the_running_stats():
    """A NaN reward in every stored transition: the update is skipped, and
    the statistics, parameters and Adam's count stay as they were, bit for
    bit."""
    _, _, pprog, pts = crossq_programs()
    pts["buffer"]["storage", "data", "next", "reward"].fill_(float("nan"))
    before = {n: v.clone() for n, v in pprog.loss.state_dict().items()}
    pts, metrics = pprog.updates(pts)
    assert not np.isfinite(metrics["loss"].item())
    for n, v in pprog.loss.state_dict().items():
        assert torch.equal(v, before[n]), n
    assert int(pprog.optimizer.count) == 0


# -- discrete SAC -----------------------------------------------------------------

A = 3


def discrete_pair(seed=0):
    jloss = JaxDiscreteSACLoss(
        JaxActor(JaxTDModule(JaxMLP(out_features=A, num_cells=CELLS), ["observation"],
                             ["logits"]), JaxCategorical, dist_keys=("logits",)),
        JaxMLP(out_features=A, num_cells=CELLS), num_actions=A, gamma=0.9)
    ploss = DiscreteSACLoss(
        ProbabilisticActor(TDModule(MLP(out_features=A, num_cells=CELLS), ["observation"],
                                    ["logits"]), Categorical, dist_keys=("logits",)),
        MLP(out_features=A, num_cells=CELLS), num_actions=A, gamma=0.9)
    rng = np.random.default_rng(seed)
    obs = rng.uniform(-1, 1, (B, 4)).astype(np.float32)
    params = jloss.init_params(jax.random.key(seed), JaxArrayDict(observation=jnp.asarray(obs)))
    params["target_qvalue"] = jax.tree.map(
        lambda x: x + 0.1 * jnp.asarray(rng.standard_normal(x.shape), x.dtype),
        params["target_qvalue"])
    params["log_alpha"] = jnp.asarray(-0.7, jnp.float32)
    ploss.init_params(ArrayDict(observation=t(obs)))
    params_from_flax(ploss, jax.tree.map(np.asarray, params))
    return jloss, params, ploss, rng


@pytest.mark.parametrize("one_hot", [False, True], ids=["index", "one_hot"])
def test_discrete_sac_loss_value_metrics_and_gradients_match(one_hot):
    jloss, params, ploss, rng = discrete_pair(11)
    assert ploss.target_entropy == jloss.target_entropy
    act = rng.integers(0, A, B)
    term = rng.random(B) < 0.3
    raw = dict(observation=rng.uniform(-1, 1, (B, 4)).astype(np.float32),
               action=(np.eye(A, dtype=np.float32)[act] if one_hot else act.astype(np.int32)),
               _weight=rng.uniform(0.2, 1.0, B).astype(np.float32),
               next=dict(observation=rng.uniform(-1, 1, (B, 4)).astype(np.float32),
                         reward=rng.standard_normal(B).astype(np.float32), terminated=term))
    jb = JaxArrayDict(jax.tree.map(jnp.asarray, raw))
    (jval, jmet), jgrads = jax.value_and_grad(
        lambda tr: jloss(jloss.merge(tr, params), jb), has_aux=True)(jloss.trainable(params))
    val, grads, met = ploss.grad(ArrayDict(jax.tree.map(t, raw)))
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
    assert_metrics_match(met, jmet)
    assert_grads_match(ploss, grads, jgrads)


def test_discrete_sac_trains_through_the_program_on_cpu():
    """Discrete SAC through ``OffPolicyProgram`` on 4 CartPole envs (no
    factory in either package): a random prefill, two steps of two
    updates, finite losses, the targets moved."""
    env = TransformedEnv(VmapEnv(CartPoleEnv(), 4), RewardSum())
    actor = ProbabilisticActor(TDModule(MLP(out_features=2, num_cells=CELLS), ["observation"],
                                        ["logits"]), Categorical, dist_keys=("logits",))
    loss = DiscreteSACLoss(actor, MLP(out_features=2, num_cells=CELLS), num_actions=2)
    prog = OffPolicyProgram(Collector(env, actor, frames_per_batch=32), loss,
                            ReplayBuffer(DeviceStorage(256)),
                            OffPolicyConfig(batch_size=16, utd_ratio=2, init_random_frames=64),
                            device="cpu")
    ts = prog.prefill(prog.init(seed=0))
    target0 = [p.clone() for p in loss.target_qvalue.parameters()]
    for _ in range(2):
        ts, metrics = prog.train_step(ts)
        assert all(np.isfinite(metrics[k].item())
                   for k in ("loss", "loss_qvalue", "loss_actor", "loss_alpha", "entropy"))
    assert ts["update_count"] == 4 and int(ts["buffer"]["storage", "size"]) == 128
    assert all(not torch.equal(a, b) for a, b in zip(target0, loss.target_qvalue.parameters()))


# -- the factories ----------------------------------------------------------------


def _shapes(named) -> dict:
    """Per top-level group, the multiset of each tensor's sorted dims."""
    out = collections.defaultdict(collections.Counter)
    for name, shape in named:
        out[name.split(".")[0]][tuple(sorted(shape))] += 1
    return dict(out)


FACTORIES = {"redq": (make_redq_trainer, jax_make_redq_trainer),
             "crossq": (make_crossq_trainer, jax_make_crossq_trainer)}


@pytest.mark.parametrize("algo", sorted(FACTORIES))
def test_factory_defaults_match_reference(algo):
    """The parts the factory builds: parameter and statistics shapes (the
    256x256 actor; REDQ's 10 critics and their targets; CrossQ's two
    batch-normalised critics, no target), the loss's settings, the config
    (REDQ: UTD 8), the uniform 1M-style buffer, steps and frames."""
    ours_f, ref_f = FACTORIES[algo]
    kw = dict(total_steps=5, frames_per_batch=16, buffer_capacity=256)
    ours = ours_f(VmapEnv(PendulumEnv(), 4), device="cpu", **kw)
    ref = ref_f(JaxVmapEnv(JaxPendulum(), 4), **kw)
    p, r = ours.program, ref.program
    jts = r.init(jax.random.key(0))
    p.init(0)
    flat = jax.tree_util.tree_flatten_with_path(jts["params"])[0]
    ref_shapes = _shapes((".".join(str(getattr(k, "key", k)) for k in path), x.shape)
                         for path, x in flat)
    named = [(n, tuple(v.shape)) for n, v in p.loss.named_parameters()]
    if algo == "crossq":  # the running statistics: buffers here, "batch_stats" there
        named += [("batch_stats", tuple(v.shape)) for v in p.loss.buffers()]
        assert r.loss.target_keys == p.loss.target_keys == ()
        assert ref_shapes["qvalue"][(2, 256, 256)] == 1
    else:
        assert ref_shapes["target_qvalue"][(10, 256, 256)] == 1
        assert p.loss.sub_sample_len == r.loss.sub_sample_len == 2
    assert _shapes(named) == ref_shapes
    assert p.loss.num_qvalue_nets == r.loss.num_qvalue_nets == (2 if algo == "crossq" else 10)
    assert p.loss.gamma == r.loss.gamma == 0.99
    assert dataclasses.asdict(p.config) == dataclasses.asdict(r.config)
    assert p.config.init_random_frames == 5000
    assert p.config.utd_ratio == (8 if algo == "redq" else 1)
    assert p.buffer.capacity == r.buffer.capacity == 256
    assert type(p.buffer.sampler).__name__ == type(r.buffer.sampler).__name__ == "RandomSampler"
    assert p.loss.actor.dist_kwargs == r.loss.actor.dist_kwargs == {"low": -2.0, "high": 2.0}
    assert ours.total_steps == ref.total_steps and p.collector.frames_per_batch == 16


@pytest.mark.parametrize("algo", sorted(FACTORIES))
def test_factory_trains_two_steps_on_cpu(algo):
    """The reference's factory check (``tests/test_algorithms_comm.py``) on
    the port: two steps over 4 Pendulum envs with finite losses; CrossQ's
    running statistics moved."""
    env = TransformedEnv(VmapEnv(PendulumEnv(), 4), RewardSum())
    tr = FACTORIES[algo][0](env, total_steps=2, frames_per_batch=64, buffer_capacity=1024,
                            config=OffPolicyConfig(batch_size=32, init_random_frames=64,
                                                   utd_ratio=2), device="cpu")
    seen = []
    tr.register_op("post_step", lambda trainer, m: seen.append(m))
    ts = tr.train(0)
    assert tr.step_count == 2 and tr.collected_frames == 128
    assert all(np.isfinite(m["loss"].item()) for m in seen)
    assert int(ts["buffer"]["storage", "size"]) == 192 and ts["update_count"] == 4
    if algo == "crossq":  # BatchNorm_0's statistics (of the raw input) left 0 and 1
        q = tr.program.loss.qvalue
        assert len(list(tr.program.loss.buffers())) == 6
        assert bool((q.mean_0 != 0).all()) and bool((q.var_0 != 1).all())
