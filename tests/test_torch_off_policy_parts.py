"""The modules of the off-policy slice against ``rl_tpu``, on the CPU, at a
small size (4 envs, MLPs of (32, 32), batch 8), float32, inputs from
numpy seeds and the reference's own PRNG draws fed to the port.

Tolerances: env dynamics, rewards and a deterministic collect within
1e-6 absolute (same formulas; tanh/sin/cos differ in the last bits
between XLA and torch); distributions and the critic ensemble within
rtol 1e-5 (products summed in another order); the SAC loss within rtol
1e-5 and every gradient within rtol 1e-4 / atol 1e-6 of
``jax.value_and_grad`` of the reference's loss fed the same noise;
polyak, clipping and histograms within rtol 1e-6 of optax and the
reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rl_tpu.collectors import Collector as JaxCollector
from rl_tpu.data import ArrayDict as JaxArrayDict
from rl_tpu.envs import PendulumEnv as JaxPendulum
from rl_tpu.envs import VmapEnv as JaxVmapEnv
from rl_tpu.envs.utils import ExplorationType as JaxExploration
from rl_tpu.envs.utils import set_exploration_type as jax_set_exploration
from rl_tpu.modules import MLP as JaxMLP
from rl_tpu.modules import ConcatMLP as JaxConcatMLP
from rl_tpu.modules import NormalParamExtractor as JaxNPE
from rl_tpu.modules import ProbabilisticActor as JaxActor
from rl_tpu.modules import TDModule as JaxTDModule
from rl_tpu.modules import TDSequential as JaxTDSequential
from rl_tpu.modules import TanhNormal as JaxTanhNormal
from rl_tpu.modules.networks import apply_ensemble as jax_apply_ensemble
from rl_tpu.modules.networks import init_ensemble as jax_init_ensemble
from rl_tpu.objectives import SACLoss as JaxSACLoss
from rl_tpu.obs.device import DeviceMetrics as JaxDeviceMetrics
from rl_tpu.ops.math import safetanh as jax_safetanh
from rl_tpu_torch.collectors import Collector
from rl_tpu_torch.data import ArrayDict, Bounded, Composite, Unbounded
from rl_tpu_torch.envs import ExplorationType, PendulumEnv, VmapEnv, set_exploration_type
from rl_tpu_torch.modules import (MLP, ConcatMLP, NormalParamExtractor, ProbabilisticActor,
                                  TanhNormal, TDModule, TDSequential, apply_ensemble,
                                  init_ensemble, params_from_flax)
from rl_tpu_torch.modules.weights import flax_paths, to_port_layout
from rl_tpu_torch.objectives import SACLoss, SoftUpdate
from rl_tpu_torch.obs.device import DeviceMetrics
from rl_tpu_torch.ops.math import safetanh
from rl_tpu_torch.trainers.off_policy import clip_by_global_norm

torch.set_num_threads(1)
CELLS = (32, 32)
N_ENVS = 4


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def jax_sac():
    actor = JaxActor(
        JaxTDSequential(JaxTDModule(JaxMLP(out_features=2, num_cells=CELLS), ["observation"],
                                    ["raw"]),
                        JaxTDModule(JaxNPE(), ["raw"], ["loc", "scale"])),
        JaxTanhNormal, dist_kwargs={"low": -2.0, "high": 2.0})
    return JaxSACLoss(actor, JaxConcatMLP(out_features=1, num_cells=CELLS))


def port_sac():
    actor = ProbabilisticActor(
        TDSequential(TDModule(MLP(out_features=2, num_cells=CELLS), ["observation"], ["raw"]),
                     TDModule(NormalParamExtractor(), ["raw"], ["loc", "scale"])),
        TanhNormal, dist_kwargs={"low": -2.0, "high": 2.0})
    return SACLoss(actor, ConcatMLP(out_features=1, num_cells=CELLS))


def both_sacs(seed=0, B=8):
    """The reference's SACLoss with params from ``init_params`` and the
    port's with the same params carried across."""
    jloss = jax_sac()
    obs = np.random.default_rng(seed).uniform(-1, 1, (B, 3)).astype(np.float32)
    params = jloss.init_params(jax.random.key(seed), JaxArrayDict(observation=jnp.asarray(obs)))
    ploss = port_sac().init_params(ArrayDict(observation=t(obs)))
    params_from_flax(ploss, jax.tree.map(np.asarray, params))
    return jloss, params, ploss


def flax_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


# -- data model and specs -------------------------------------------------------


class TestArrayDict:
    def test_paths_set_and_batch_shape(self):
        td = ArrayDict(obs=torch.zeros(4, 3), next={"reward": torch.ones(4)})
        assert td.batch_shape == (4,)
        assert ("next", "reward") in td and "missing" not in td
        td2 = td.set(("next", "done"), torch.zeros(4, dtype=torch.bool))
        assert ("next", "done") in td2 and ("next", "done") not in td  # new object
        assert td2["obs"] is td["obs"]  # tensors shared, not copied

    def test_update_delete_exclude_replace(self):
        td = ArrayDict(a=torch.zeros(2), next={"x": torch.zeros(2), "y": torch.ones(2)})
        up = td.update({"next": {"x": torch.full((2,), 5.0)}})
        assert float(up["next", "x"][0]) == 5.0 and ("next", "y") in up  # recursive merge
        assert "a" not in td.delete("a") and ("next", "x") not in td.exclude(("next", "x"))
        assert td.exclude("nope").keys() == td.keys()  # a missing key is no error
        assert float(td.replace(a=torch.ones(2))["a"][0]) == 1.0
        with pytest.raises(KeyError):
            td.delete(("a", "b"))

    def test_index_apply_unsqueeze_stack(self):
        td = ArrayDict(x=torch.arange(6.0).reshape(3, 2), n={"y": torch.arange(3)})
        sel = td[torch.tensor([2, 0])]
        assert sel.batch_shape == (2,) and sel["n", "y"].tolist() == [2, 0]
        assert td.unsqueeze(0).batch_shape == (1, 3)
        st = ArrayDict.stack([td, td], 0)
        assert st.batch_shape == (2, 3) and st["n", "y"].shape == (2, 3)
        assert td.apply(lambda v: v * 2)["x"][1, 1].item() == 6.0
        assert [k for k, _ in td.items(nested=True, leaves_only=True)] == [("n", "y"), ("x",)]

    def test_specs(self):
        gen = torch.Generator().manual_seed(0)
        b = Bounded(shape=(3,), low=[-1.0, -1.0, -8.0], high=[1.0, 1.0, 8.0])
        x = b.rand((500,), gen)
        assert x.shape == (500, 3) and bool((x >= -8).all() and (x <= 8).all())
        assert bool((x[:, :2].abs() <= 1).all()) and x[:, 2].abs().max() > 1
        scalar = Bounded(shape=(1,), low=-2.0, high=2.0)
        assert scalar.rand((4,), gen).shape == (4, 1)
        assert scalar.project(torch.tensor([[5.0]])).item() == 2.0
        c = Composite(obs=b, n=Unbounded(shape=(), dtype=torch.int32))
        z = c.zero((2,))
        assert z["obs"].shape == (2, 3) and z["n"].dtype == torch.int32


# -- env ------------------------------------------------------------------------


def jax_env_state(seed, n):
    env = JaxVmapEnv(JaxPendulum(max_episode_steps=5), n)
    state, td = env.reset(jax.random.key(seed))
    return env, state, td


def port_env_state(jstate, jtd) -> tuple[ArrayDict, ArrayDict]:
    state = ArrayDict(theta=t(jstate["theta"]), theta_dot=t(jstate["theta_dot"]),
                      step_count=t(jstate["step_count"]))
    td = ArrayDict({k: t(jtd[k]) for k in ("observation", "done", "terminated", "truncated")})
    return state, td


def test_pendulum_step_matches_reference():
    jenv, jstate, jtd = jax_env_state(0, 16)
    env = VmapEnv(PendulumEnv(max_episode_steps=5), 16)
    state, td = port_env_state(jstate, jtd)
    act = np.random.default_rng(1).uniform(-3, 3, (16, 1)).astype(np.float32)  # clipped
    for _ in range(6):
        jstate, jout = jenv.step(jstate, jtd.set("action", jnp.asarray(act)))
        state, out = env.step(state, td.set("action", t(act)))
        for k in ("observation", "reward", "done", "terminated", "truncated"):
            np.testing.assert_allclose(out["next", k].numpy(), np.asarray(jout["next", k]),
                                       atol=1e-6, rtol=0)
        np.testing.assert_allclose(state["theta"].numpy(), np.asarray(jstate["theta"]),
                                   atol=1e-6)
        jtd = jout["next"].exclude("reward")
        td = out["next"].exclude("reward")


def test_step_and_reset_matches_reference_where_not_done():
    jenv, jstate, jtd = jax_env_state(2, 8)
    env = VmapEnv(PendulumEnv(max_episode_steps=5), 8)
    state, td = port_env_state(jstate, jtd)
    gen = torch.Generator().manual_seed(0)
    act = np.random.default_rng(3).uniform(-2, 2, (8, 1)).astype(np.float32)
    for step in range(6):
        jstate, jfull, jcarry = jenv.step_and_reset(jstate, jtd.set("action", jnp.asarray(act)))
        state, full, carry = env.step_and_reset(state, td.set("action", t(act)), gen)
        done = full["next", "done"].numpy()
        assert done.tolist() == np.asarray(jfull["next", "done"]).tolist()
        assert done.all() == (step == 4)  # truncation at 5 steps
        np.testing.assert_allclose(full["next", "observation"].numpy(),
                                   np.asarray(jfull["next", "observation"]), atol=1e-6)
        keep = ~done
        np.testing.assert_allclose(carry["observation"].numpy()[keep],
                                   np.asarray(jcarry["observation"])[keep], atol=1e-6)
        # a reset row is a fresh episode: in the observation spec's reset range
        reset = carry["observation"].numpy()[done]
        assert np.all(np.abs(reset) <= 1.0 + 1e-6)
        assert not carry["done"].numpy().any()
        if done.any():  # the port's own reset draws replace the reference's state there
            jstate = jstate.replace(
                theta=jnp.asarray(state["theta"].numpy()),
                theta_dot=jnp.asarray(state["theta_dot"].numpy()),
                step_count=jnp.asarray(state["step_count"].numpy()))
            jcarry = jcarry.set("observation", jnp.asarray(carry["observation"].numpy()))
        jtd, td = jcarry, carry


def test_collect_under_mode_matches_reference():
    """A deterministic (MODE) collect of 8 steps x 4 envs from the same env
    state: every row up to each env's first done (5 steps) equal within
    1e-6; the trajectory ids equal everywhere; reset rows in range."""
    jloss, params, ploss = both_sacs()
    jenv = JaxVmapEnv(JaxPendulum(max_episode_steps=5), N_ENVS)
    jcoll = JaxCollector(jenv, lambda p, td, k: jloss.actor(p, td, k), frames_per_batch=32)
    jc = jcoll.init(jax.random.key(4))
    coll = Collector(VmapEnv(PendulumEnv(max_episode_steps=5), N_ENVS),
                     lambda td, g: ploss.actor(td, g), frames_per_batch=32)
    gen = torch.Generator().manual_seed(9)
    cstate = coll.init(gen)
    state, td = port_env_state(jc["env"], jc["carry"])
    cstate.update(env=state, carry=td, traj_ids=t(jc["traj_ids"]).long(),
                  traj_count=t(jc["traj_count"]).long())
    with jax_set_exploration(JaxExploration.MODE):
        jbatch, _ = jcoll.collect(params["actor"], jc)
    with set_exploration_type(ExplorationType.MODE):
        batch, new_state = coll.collect(cstate)
    assert batch.batch_shape == (8, N_ENVS)
    first_done = 4
    assert batch["next", "done"].numpy()[first_done].all()
    for path, leaf in batch.items(nested=True, leaves_only=True):
        ref = np.asarray(jbatch[path])
        assert leaf.shape == ref.shape, path
        if path == ("collector", "traj_ids"):
            np.testing.assert_array_equal(leaf.numpy(), ref)
            continue
        np.testing.assert_allclose(leaf.numpy()[: first_done + 1].astype(np.float64),
                                   ref[: first_done + 1].astype(np.float64), atol=1e-6,
                                   err_msg=str(path))
    after = batch["observation"].numpy()[first_done + 1]
    assert np.all(np.abs(after[:, :2]) <= 1.0) and np.all(np.abs(after[:, 2]) <= 8.0)
    assert new_state["traj_count"].item() == 2 * N_ENVS
    assert new_state["step_count"] == 32


# -- distributions, networks ----------------------------------------------------


def test_tanh_normal_log_prob_and_rsample():
    rng = np.random.default_rng(5)
    # away from saturation: near |t| = 1 atanh turns a last-bit difference
    # of tanh into any amount (the gradient at saturation is held below)
    loc = rng.standard_normal((16, 2)).astype(np.float32)
    scale = rng.uniform(0.05, 0.7, (16, 2)).astype(np.float32)
    eps = rng.standard_normal((16, 2)).astype(np.float32)
    jd = JaxTanhNormal(jnp.asarray(loc), jnp.asarray(scale), -2.0, 2.0)
    pd = TanhNormal(t(loc), t(scale), -2.0, 2.0)
    jx = jd._squash(jd._bounded_loc + jd.scale * jnp.asarray(eps))
    px = pd.rsample(eps=t(eps))
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pd.log_prob(t(jx)).numpy(), np.asarray(jd.log_prob(jx)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pd.mode.numpy(), np.asarray(jd.mode), rtol=1e-5, atol=1e-6)


def test_safetanh_gradient_at_saturation_is_unclamped_tanh():
    x = np.array([-30.0, -8.0, -0.3, 0.0, 0.7, 9.0, 25.0], np.float32)
    jg = jax.grad(lambda v: jnp.sum(jax_safetanh(v) * jnp.arange(1.0, 8.0)))(jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    (safetanh(xt) * torch.arange(1.0, 8.0)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=0)
    assert xt.grad[0].item() > 0.0  # a plain clamp would give 0 there


def test_critic_ensemble_matches_vmapped_apply():
    rng = np.random.default_rng(6)
    obs = rng.standard_normal((8, 3)).astype(np.float32)
    act = rng.uniform(-2, 2, (8, 1)).astype(np.float32)
    mod = JaxConcatMLP(out_features=1, num_cells=CELLS)
    stacked = jax_init_ensemble(mod, jax.random.key(1), 3, jnp.asarray(obs), jnp.asarray(act))
    ens = init_ensemble(ConcatMLP(out_features=1, num_cells=CELLS), 3, t(obs), t(act))
    with torch.no_grad():
        for j in range(3):
            p = stacked["MLP_0"][f"Dense_{j}"]
            ens.weights[j].copy_(to_port_layout(np.asarray(p["kernel"]), True))
            ens.biases[j].copy_(t(p["bias"]))
    ref = jax_apply_ensemble(mod, stacked, jnp.asarray(obs), jnp.asarray(act))
    out = apply_ensemble(ens, t(obs), t(act))
    assert out.shape == (3, 8, 1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_lecun_normal_init_distribution():
    """flax's lecun-normal: truncated at 2 std, variance 1/fan_in; zero bias."""
    m = MLP(out_features=4, num_cells=(512,)).build(256, torch.Generator().manual_seed(0))
    w = m.layers[0].weight.detach()
    assert abs(w.var().item() * 256 - 1.0) < 0.02
    assert w.abs().max().item() <= 2.0 / 16 / 0.87962566103423978 + 1e-6
    assert m.layers[0].bias.abs().max().item() == 0.0


# -- the SAC loss ---------------------------------------------------------------


def sac_batch(seed, B=8):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    term = np.zeros(B, bool)
    term[1] = True
    raw = dict(observation=f(B, 3), action=rng.uniform(-1.99, 1.99, (B, 1)).astype(np.float32),
               _weight=rng.uniform(0.2, 1.0, B).astype(np.float32),
               next=dict(observation=f(B, 3), reward=f(B), terminated=term))
    return JaxArrayDict(jax.tree.map(jnp.asarray, raw)), ArrayDict(jax.tree.map(t, raw))


def test_sac_loss_value_and_every_gradient_match_reference():
    jloss, params, ploss = both_sacs(seed=1)
    jb, pb = sac_batch(2)
    key = jax.random.key(7)
    (jval, jmet), jgrads = jax.value_and_grad(
        lambda tr: jloss(jloss.merge(tr, params), jb, key), has_aux=True)(
        jloss.trainable(params))
    k_next, k_pi = jax.random.split(key)
    noise = (t(jax.random.normal(k_next, (8, 1))), t(jax.random.normal(k_pi, (8, 1))))
    val, grads, met = ploss.grad(pb, noise=noise)
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
    for name in ("loss_qvalue", "loss_actor", "loss_alpha", "alpha", "entropy"):
        np.testing.assert_allclose(met[name].item(), float(jmet[name]), rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    np.testing.assert_allclose(met["td_error"].numpy(), np.asarray(jmet["td_error"]),
                               rtol=1e-5, atol=1e-6)
    paths = flax_paths(ploss)
    names = [n for n, _ in ploss.trainable_parameters()]
    assert len(names) == len(jax.tree.leaves(jgrads)) == 13
    for name, g in zip(names, grads):
        path, transposed = paths[name]
        ref = to_port_layout(flax_leaf(jgrads, path), transposed)
        np.testing.assert_allclose(g.numpy(), ref.numpy(), rtol=1e-4, atol=1e-6, err_msg=name)


def test_soft_update_and_clip_match_optax():
    _, params, ploss = both_sacs(seed=3)
    with torch.no_grad():  # move the sources away from the targets
        for p in ploss.qvalue.parameters():
            p.add_(torch.linspace(-1, 1, p.numel()).reshape(p.shape))
    src = {n: p.detach().clone() for n, p in ploss.qvalue.named_parameters()}
    tgt = {n: p.detach().clone() for n, p in ploss.target_qvalue.named_parameters()}
    SoftUpdate(ploss, tau=0.005)()
    for n, p in ploss.target_qvalue.named_parameters():
        ref = optax.incremental_update(jnp.asarray(src[n].numpy()), jnp.asarray(tgt[n].numpy()),
                                       0.005)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
    gates = SoftUpdate(ploss, tau=0.5)
    before = [p.clone() for p in ploss.target_qvalue.parameters()]
    gates(ok=torch.tensor(False))
    assert all(torch.equal(a, b) for a, b in zip(before, ploss.target_qvalue.parameters()))

    rng = np.random.default_rng(4)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,), ())]
    for max_norm in (1.0, 100.0):  # clipped, and left alone
        ref, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
        out = clip_by_global_norm([t(g) for g in grads], max_norm)
        for a, b in zip(out, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_device_metrics_histograms_match_reference():
    spec = DeviceMetrics(counters=("n",), gauges=("g",),
                         histograms={"td": (0.01, 0.1, 1.0, 10.0)})
    jspec = JaxDeviceMetrics(counters=("n",), gauges=("g",),
                             histograms={"td": (0.01, 0.1, 1.0, 10.0)})
    st, jst = spec.init("cpu"), jspec.init()
    rng = np.random.default_rng(8)
    for _ in range(3):
        v = np.abs(rng.standard_normal(37).astype(np.float32)) * 3.0
        v[:3] = [0.01, 0.1, 10.0]  # on the edges: bins are left-closed searchsorted
        st, jst = spec.observe(st, "td", t(v)), jspec.observe(jst, "td", jnp.asarray(v))
        st, jst = spec.inc(st, "n", 2.0), jspec.inc(jst, "n", 2.0)
    st, jst = spec.set_gauge(st, "g", 1.5), jspec.set_gauge(jst, "g", 1.5)
    flat = spec.to_flat(DeviceMetrics.drain(DeviceMetrics.drain_async(st)))
    jflat = jspec.to_flat(JaxDeviceMetrics.drain(jst))
    assert flat["n"] == jflat["n"] and flat["g"] == jflat["g"]
    assert flat["td"]["counts"] == jflat["td"]["counts"] and flat["td"]["edges"] == jflat["td"]["edges"]
    np.testing.assert_allclose(flat["td"]["sum"], jflat["td"]["sum"], rtol=1e-6)
