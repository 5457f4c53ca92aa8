"""The port's GRPO training slice against the JAX package, on the CPU.

Same flax-initialized weights (``params_from_flax``) and the same numpy
batch in both packages, float32:

- ``GRPOLoss``/``DAPOLoss``/``CISPOLoss`` values and metrics and
  ``mc_advantage``: atol 1e-5;
- the trainer's 2-microbatch accumulated gradient against a JAX
  ``value_and_grad`` of the same loss over the whole batch: rtol 1e-4,
  atol 1e-6 (microbatching reorders float sums);
- Adam against ``optax.adam``: rtol 1e-6, atol 1e-8, two steps (bias
  correction), and a rejected step changes nothing;
- the copied tokenizer, chat env, scorers and KL shaping: identical tokens,
  masks, group ids and rewards;
- two CPU trainer steps on both rollout paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rl_tpu.data import ArrayDict
from rl_tpu.data.llm.tokenizer import SimpleTokenizer as JaxTokenizer
from rl_tpu.envs.llm import DatasetChatEnv as JaxChatEnv
from rl_tpu.envs.llm import ExactMatchScorer as JaxExact
from rl_tpu.envs.llm import KLRewardTransform as JaxKL
from rl_tpu.envs.llm import SumScorer as JaxSum
from rl_tpu.envs.llm import arithmetic_dataset as jax_arithmetic
from rl_tpu.envs.llm import combine_scorers as jax_combine
from rl_tpu.models import TransformerConfig as JaxConfig
from rl_tpu.models import TransformerLM as JaxLM
from rl_tpu.models import token_log_probs as jax_token_log_probs
from rl_tpu.objectives.llm import CISPOLoss as JaxCISPO
from rl_tpu.objectives.llm import DAPOLoss as JaxDAPO
from rl_tpu.objectives.llm import GRPOLoss as JaxGRPO
from rl_tpu.objectives.llm import mc_advantage as jax_mc_advantage
from rl_tpu_torch.data.llm import SimpleTokenizer
from rl_tpu_torch.envs.llm import (
    DatasetChatEnv,
    ExactMatchScorer,
    KLRewardTransform,
    PolicyVersion,
    SumScorer,
    arithmetic_dataset,
    combine_scorers,
)
from rl_tpu_torch.models import TransformerConfig, TransformerLM, params_from_flax, token_log_probs
from rl_tpu_torch.objectives import CISPOLoss, DAPOLoss, GRPOLoss, mc_advantage
from rl_tpu_torch.obs import DeviceMetrics
from rl_tpu_torch.trainers import Adam, GRPOTrainer
from rl_tpu_torch.weight_update import DevicePutScheme

torch.set_num_threads(1)

SMALL = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64, max_seq_len=24)
B, T, P = 4, 20, 12  # rows, tokens, prompt length


def model_pair(impl="local"):
    jm = JaxLM(JaxConfig(**SMALL, dtype=jnp.float32))
    params = jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = TransformerConfig(**SMALL, dtype=torch.float32, attention_impl=impl)
    tm = TransformerLM(cfg, device="cpu", param_dtype=torch.float32)
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params), cfg))
    return jm, params, tm


def numpy_batch(jm, params, seed=0):
    """A left-padded GRPO batch whose behavior log-probs sit near the
    policy's (ratios near 1, some clipped)."""
    rng = np.random.default_rng(seed)
    pads = np.array([0, 3, 7, 11])
    pos = np.arange(T)[None, :]
    attn = pos >= pads[:, None]
    toks = np.where(attn, rng.integers(3, SMALL["vocab_size"], (B, T)), 0).astype(np.int32)
    amask = attn & (pos >= P) & (rng.random((B, T)) < 0.9)
    lp = np.asarray(jax_token_log_probs(jm, params, jnp.asarray(toks),
                                        jnp.asarray(attn, jnp.float32)))
    return {
        "tokens": toks,
        "attention_mask": attn.astype(np.float32),
        "assistant_mask": amask,
        "sample_log_prob": (lp + rng.normal(0, 0.3, (B, T))).astype(np.float32) * amask,
        "ref_log_prob": (lp + rng.normal(0, 0.2, (B, T))).astype(np.float32) * amask,
        "advantage": rng.standard_normal(B).astype(np.float32),
        "reward": rng.random(B).astype(np.float32),
    }


def jax_loss(cls, jm, **kw):
    return cls(lambda p, b: jax_token_log_probs(jm, p, b["tokens"], b["attention_mask"]), **kw)


def port_loss(cls, **kw):
    return cls(lambda m, b: token_log_probs(m, b["tokens"], b["attention_mask"]), **kw)


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("classes,kw", [
    ((JaxGRPO, GRPOLoss), dict(kl_coeff=0.1, entropy_coeff=0.01)),
    ((JaxGRPO, GRPOLoss), dict(per_seq_norm=True, clip_epsilon=0.1)),
    ((JaxDAPO, DAPOLoss), {}),
    ((JaxCISPO, CISPOLoss), {}),
])
def test_losses_match(classes, kw):
    jm, params, tm = model_pair()
    batch = numpy_batch(jm, params)
    jcls, tcls = classes
    jl, jmet = jax_loss(jcls, jm, aux_coeff=0.0, **kw)(params, ArrayDict(batch))
    with torch.no_grad():
        tl, tmet = port_loss(tcls, **kw)(tm, to_torch(batch))
    np.testing.assert_allclose(tl.item(), float(jl), atol=1e-5)
    assert set(tmet) == set(jmet.keys())
    for k, v in tmet.items():
        assert v.dim() == 0
        np.testing.assert_allclose(v.item(), float(jmet[k]), atol=1e-5, err_msg=k)


@pytest.mark.parametrize("std_normalize", [True, False])
def test_mc_advantage_matches(std_normalize):
    rng = np.random.default_rng(1)
    r = rng.random(12).astype(np.float32)
    gid = np.repeat(np.arange(3), 4).astype(np.int32)
    gid[5] = 2
    ref = jax_mc_advantage(jnp.asarray(r), jnp.asarray(gid), 3, std_normalize=std_normalize)
    out = mc_advantage(torch.from_numpy(r), torch.from_numpy(gid), 3, std_normalize=std_normalize)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def small_trainer(**kw):
    cfg = TransformerConfig(**SMALL, dtype=torch.float32, attention_impl=kw.pop("impl", "local"))
    return GRPOTrainer(arithmetic_dataset(32, max_operand=4), model_config=cfg,
                       num_prompts=2, group_repeats=2, max_prompt_len=P, max_new_tokens=T - P,
                       device="cpu", **kw)


@pytest.mark.parametrize("impl", ["local", "flash"])
def test_accumulated_gradient_matches_full_batch_value_and_grad(impl):
    jm, params, _ = model_pair()
    batch = numpy_batch(jm, params, seed=2)
    tr = small_trainer(impl=impl, microbatch_size=2)
    tr.policy.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params), tr.policy.cfg))
    grads, loss, _ = tr._accumulate(to_torch(batch))
    loss_fn = jax_loss(JaxGRPO, jm, clip_epsilon=0.2, aux_coeff=0.0)
    (jl, _), jg = jax.value_and_grad(lambda p: loss_fn(p, ArrayDict(batch)), has_aux=True)(params)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-4, atol=1e-6)
    ref = params_from_flax(jax.tree.map(np.asarray, jg), tr.policy.cfg)
    for (name, _), g in zip(tr.policy.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_adam_matches_optax_and_guard_rejects():
    rng = np.random.default_rng(3)
    ps = [rng.standard_normal(s).astype(np.float32) for s in [(5, 3), (7,)]]
    opt = optax.adam(1e-2)
    jp = [jnp.asarray(p) for p in ps]
    state = opt.init(jp)
    tp = [torch.tensor(p) for p in ps]
    adam = Adam(tp, 1e-2)
    for step in range(2):
        gs = [rng.standard_normal(p.shape).astype(np.float32) for p in ps]
        upd, state = opt.update([jnp.asarray(g) for g in gs], state)
        jp = optax.apply_updates(jp, upd)
        adam.step([torch.tensor(g) for g in gs], torch.tensor(True))
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-8)
    before = [p.clone() for p in tp] + [m.clone() for m in adam.mu] + [adam.count.clone()]
    adam.step([torch.full(p.shape, float("nan")) for p in tp], torch.tensor(False))
    after = tp + adam.mu + [adam.count]
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_copied_tokenizer_env_and_scorers_match():
    jds, ds = jax_arithmetic(24, max_operand=6, seed=4), arithmetic_dataset(24, max_operand=6, seed=4)
    assert jds.items == ds.items
    jtok, tok = JaxTokenizer(jds.corpus()), SimpleTokenizer(ds.corpus())
    assert jtok._itos == tok._itos and tok.encode("3+5= 8!") == jtok.encode("3+5= 8!")
    jscore = jax_combine(JaxExact(jds.answers), JaxSum(jds.answers), weights=[1.0, 0.5])
    score = combine_scorers(ExactMatchScorer(ds.answers), SumScorer(ds.answers),
                            weights=[1.0, 0.5])
    jenv = JaxChatEnv(jds.prompts, jtok, reward_fn=jscore, group_repeats=3, max_prompt_len=16,
                      seed=5)
    env = DatasetChatEnv(ds.prompts, tok, reward_fn=score, group_repeats=3, max_prompt_len=16,
                         seed=5)
    (js, jg), (s, g) = jenv.sample_batch(2), env.sample_batch(2)
    np.testing.assert_array_equal(g, jg)
    for k in ("tokens", "attention_mask", "assistant_mask"):
        np.testing.assert_array_equal(s[k], js[k])
    # responses: the gold answer, a near miss, and garbage
    rng = np.random.default_rng(6)
    resp = rng.integers(0, tok.vocab_size, (6, 5))
    rmask = np.ones_like(resp, bool)
    answers = [ds.answers[h.messages[-1].content] for h in s["histories"]]
    gold = tok.encode(answers[0])
    resp[0, : len(gold)] = gold
    rmask[0, len(gold) :] = False
    near = tok.encode(str(int(answers[1]) + 1))
    resp[1, : len(near)] = near
    rmask[1, len(near) :] = False
    _, jr, _ = jenv.step(js, resp, rmask)
    _, r, _ = env.step(s, resp, rmask)
    np.testing.assert_array_equal(r, jr)
    assert r[0] == 1.5 and r[1] == 0.25  # exact match + 0.5 sum credit; 0.5 * 1/(1+1)
    np.testing.assert_array_equal(env.score_rows(s, resp, rmask, [1, 4]), jr[[1, 4]])


def test_kl_reward_transform_and_policy_version_match():
    rng = np.random.default_rng(7)
    arrays = {"sample_log_prob": rng.normal(-3, 1, (4, 6)).astype(np.float32),
              "ref_log_prob": rng.normal(-3, 1, (4, 6)).astype(np.float32),
              "assistant_mask": rng.random((4, 6)) < 0.7,
              "tokens": np.zeros((4, 6), np.int32)}
    arrays["sample_log_prob"][0, 0] = 40.0  # past the clip
    rewards = rng.random(4).astype(np.float32)
    ref = JaxKL(coeff=0.3, clip=5.0)(rewards, arrays)
    tb = to_torch(arrays)
    out = KLRewardTransform(coeff=0.3, clip=5.0)(rewards, tb)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    pv = PolicyVersion()
    pv.bump()
    pv.bump()
    assert pv(out, tb) is out and tb["policy_version"].tolist() == [2] * 4


def test_device_metrics_and_scheme():
    spec = DeviceMetrics(counters=("n",), gauges=("loss",))
    st = spec.init("cpu")
    st = spec.set_gauge(spec.inc(spec.inc(st, "n", torch.tensor(2.0)), "n"), "loss", 0.5)
    assert spec.to_flat(DeviceMetrics.drain(DeviceMetrics.drain_async(st))) == {
        "n": 3.0, "loss": 0.5}
    cfg = TransformerConfig(**SMALL, dtype=torch.bfloat16)
    master = TransformerLM(cfg, device="cpu", seed=1, param_dtype=torch.float32)
    serving = TransformerLM(cfg, device="cpu", seed=2)
    scheme = DevicePutScheme(serving)
    with pytest.raises(RuntimeError):
        scheme.pull()
    scheme.push(master)
    model, version = scheme.pull_versioned()
    assert model is serving and version == 1
    for (n, p), q in zip(master.named_parameters(), serving.parameters()):
        assert torch.equal(p.to(q.dtype), q), n


@pytest.mark.parametrize("continuous_batching", [False, True])
def test_two_trainer_steps(continuous_batching):
    tr = small_trainer(impl="flash", microbatch_size=2, continuous_batching=continuous_batching,
                       learning_rate=1e-2)
    master0 = [p.detach().clone() for p in tr.policy.parameters()]
    outs = [tr.step() for _ in range(2)]
    last = tr.metrics_snapshot()
    assert all(np.isfinite(o["loss"]) for o in outs) and np.isfinite(last["loss"])
    assert last["bad_steps"] == 0 and last["updates"] == 2
    assert tr.policy_version.version == 2 and tr.scheme.version == 3
    assert any(not torch.equal(a, b) for a, b in zip(master0, tr.policy.parameters()))
    for (n, p), q in zip(tr.policy.named_parameters(), tr.gen_model.parameters()):
        assert torch.equal(p.to(q.dtype), q), n
    batch = tr.collect()
    assert batch["tokens"].shape == (4, T) and batch["policy_version"].tolist() == [2] * 4
    assert {"ref_log_prob", "advantage", "reward", "group_id"} <= set(batch)
    assert 0.0 <= tr.evaluate(4) <= 1.0


def test_engine_collect_scores_groups_as_the_env_does():
    tr = small_trainer(continuous_batching=True)
    state, gids = tr.env.sample_batch(2)
    toks = np.asarray(state["tokens"])
    pmask = np.asarray(state["attention_mask"], np.float32)
    out, rewards = tr.collector._engine_collect(tr.gen_model, toks, pmask, 0, state, gids)
    _, ref, _ = tr.env.step(state, out.response_tokens.numpy(), out.response_mask.numpy())
    np.testing.assert_array_equal(rewards, ref)
    assert out.tokens.shape == (4, T) and bool(out.response_mask[:, 0].all())


@pytest.mark.parametrize("kw", [dict(mesh=object()), dict(warmup=True)])
def test_unported_trainer_options_raise(kw):
    with pytest.raises(NotImplementedError):
        small_trainer(**kw)
