"""The port's teacher-forced scoring, dense-cache generation and training
forward against the JAX package, on the CPU.

Same flax-initialized weights in both packages (``params_from_flax``),
same numpy tokens, float32. ``token_log_probs`` over a left-padded batch
(positions ``cumsum(mask) - 1``), through "local" and "flash" attention,
to atol 1e-4 on every position whose token and predecessor are real (a
pad row's logits are don't-care). Greedy ``generate``: identical tokens
and masks, log-probs to atol 1e-4. Remat and the float32-master layout
are checked against the plain forward of the port itself.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_tpu.models import TransformerConfig as JaxConfig
from rl_tpu.models import TransformerLM as JaxLM
from rl_tpu.models import generate as jax_generate
from rl_tpu.models import token_log_probs as jax_token_log_probs
from rl_tpu.models.generate import generate_flops as jax_generate_flops
from rl_tpu.models.generate import train_step_flops as jax_train_step_flops
from rl_tpu_torch.models import (
    TransformerConfig,
    TransformerLM,
    generate,
    generate_flops,
    params_from_flax,
    token_log_probs,
    train_step_flops,
)

torch.set_num_threads(1)

SMALL = dict(vocab_size=96, d_model=32, n_layers=2, n_heads=4, d_ff=64, max_seq_len=40)


def pair(n_kv_heads=None, impl="local", seed=0):
    jcfg = JaxConfig(**SMALL, n_kv_heads=n_kv_heads, dtype=jnp.float32)
    jm = JaxLM(jcfg)
    params = jm.init(jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    tcfg = TransformerConfig(**SMALL, n_kv_heads=n_kv_heads, dtype=torch.float32,
                             attention_impl=impl)
    tm = TransformerLM(tcfg, device="cpu", param_dtype=torch.float32)
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params), tcfg))
    return jm, params, tm


def left_padded(seed, B=3, T=24, pads=(0, 5, 11)):
    rng = np.random.default_rng(seed)
    toks = rng.integers(3, SMALL["vocab_size"], (B, T)).astype(np.int32)
    mask = np.arange(T)[None, :] >= np.asarray(pads)[:, None]
    return np.where(mask, toks, 0).astype(np.int32), mask


@pytest.mark.parametrize("n_kv_heads", [None, 2])
@pytest.mark.parametrize("impl", ["local", "flash"])
def test_token_log_probs_left_padded_match(impl, n_kv_heads):
    jm, params, tm = pair(n_kv_heads, impl)
    toks, mask = left_padded(1)
    ref = np.asarray(jax_token_log_probs(jm, params, jnp.asarray(toks),
                                         jnp.asarray(mask, jnp.float32)))
    with torch.no_grad():
        out = token_log_probs(tm, torch.from_numpy(toks), torch.from_numpy(mask.astype(np.float32)))
    both = mask.copy()
    both[:, 1:] &= mask[:, :-1]
    np.testing.assert_allclose(out.numpy()[both], ref[both], atol=1e-4, rtol=0)


def test_token_log_probs_match_jax_flash_interpret():
    jm, params, tm = pair(2, "flash")
    jflash = JaxLM(dataclasses.replace(jm.cfg, attention_impl="flash", flash_interpret=True))
    toks, mask = left_padded(2)
    ref = np.asarray(jax_token_log_probs(jflash, params, jnp.asarray(toks),
                                         jnp.asarray(mask, jnp.float32)))
    with torch.no_grad():
        out = token_log_probs(tm, torch.from_numpy(toks), torch.from_numpy(mask.astype(np.float32)))
    both = mask.copy()
    both[:, 1:] &= mask[:, :-1]
    np.testing.assert_allclose(out.numpy()[both], ref[both], atol=1e-4, rtol=0)


def test_forward_takes_positions():
    """Left-padded rows are scored at their own positions, not arange(T)."""
    jm, params, tm = pair()
    toks, mask = left_padded(3)
    pos = np.clip(np.cumsum(mask, axis=1) - 1, 0, None).astype(np.int32)
    ref = jm.apply({"params": params}, jnp.asarray(toks), attention_mask=jnp.asarray(mask),
                   positions=jnp.asarray(pos))
    with torch.no_grad():
        out = tm(torch.from_numpy(toks), attention_mask=torch.from_numpy(mask),
                 positions=torch.from_numpy(pos).long())
        default = tm(torch.from_numpy(toks), attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy()[mask], np.asarray(ref)[mask], atol=1e-4, rtol=0)
    assert not np.allclose(default.numpy()[2, 11:], out.numpy()[2, 11:], atol=1e-3)


@pytest.mark.parametrize("n_kv_heads", [None, 2])
def test_greedy_generate_matches(n_kv_heads):
    jm, params, tm = pair(n_kv_heads)
    toks, mask = left_padded(4, T=12, pads=(0, 3, 7))
    eos = 5
    ref = jax_generate(jm, params, jnp.asarray(toks), jnp.asarray(mask, jnp.float32),
                       jax.random.key(0), max_new_tokens=10, eos_id=eos, greedy=True)
    out = generate(tm, torch.from_numpy(toks), torch.from_numpy(mask.astype(np.float32)),
                   None, max_new_tokens=10, eos_id=eos, greedy=True)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.response_mask.numpy(), np.asarray(ref.response_mask))
    np.testing.assert_array_equal(out.full_mask.numpy(), np.asarray(ref.full_mask))
    np.testing.assert_allclose(out.response_log_probs.numpy(),
                               np.asarray(ref.response_log_probs), atol=1e-4, rtol=0)


def test_sampled_generate_is_seeded_and_masks_after_eos():
    _, _, tm = pair()
    toks, mask = left_padded(5, T=12, pads=(0, 3, 7))
    args = (tm, torch.from_numpy(toks), torch.from_numpy(mask.astype(np.float32)))

    def run(seed):
        return generate(*args, torch.Generator().manual_seed(seed), max_new_tokens=12,
                        temperature=1.3, eos_id=7)

    a, b = run(3), run(3)
    assert torch.equal(a.tokens, b.tokens) and torch.equal(a.response_log_probs,
                                                           b.response_log_probs)
    assert bool((a.response_log_probs <= 0).all())
    for row, m in zip(a.response_tokens, a.response_mask):
        hit = (row == 7).nonzero()
        if len(hit):  # eos itself is real, everything after it is pad
            e = int(hit[0])
            assert m[: e + 1].all() and not m[e + 1 :].any() and (row[e + 1 :] == 0).all()


def test_flops_helpers_match():
    cfg, jcfg = TransformerConfig(**SMALL), JaxConfig(**SMALL)
    assert train_step_flops(cfg, 12345, 4, 32) == jax_train_step_flops(jcfg, 12345, 4, 32)
    assert generate_flops(cfg, 999, 2, 16, 7.5) == jax_generate_flops(jcfg, 999, 2, 16, 7.5)


@pytest.mark.parametrize("impl", ["local", "flash"])
@pytest.mark.parametrize("policy", ["none", "dots"])
def test_remat_gradients_equal_plain(impl, policy):
    base = TransformerConfig(**SMALL, dtype=torch.float32, attention_impl=impl)
    toks, mask = left_padded(6)
    grads = []
    for cfg in (base, dataclasses.replace(base, remat=True, remat_policy=policy)):
        m = TransformerLM(cfg, device="cpu", seed=1, param_dtype=torch.float32)
        lp = token_log_probs(m, torch.from_numpy(toks), torch.from_numpy(mask.astype(np.float32)))
        (lp * torch.from_numpy(mask)).sum().backward()
        grads.append([p.grad.clone() for p in m.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_float32_master_casts_at_use():
    """param_dtype=float32 holds float32 weights and computes in cfg.dtype:
    the same seed gives the serving layout's values, and the same bf16
    forward, bit for bit."""
    cfg = TransformerConfig(**SMALL, dtype=torch.bfloat16)
    master = TransformerLM(cfg, device="cpu", seed=4, param_dtype=torch.float32)
    serving = TransformerLM(cfg, device="cpu", seed=4)
    assert master.wte.weight.dtype == torch.float32 and serving.wte.weight.dtype == torch.bfloat16
    assert serving.ln_f.weight.dtype == torch.float32  # LayerNorm stays float32
    for (n, p), q in zip(master.named_parameters(), serving.parameters()):
        assert torch.equal(p.to(q.dtype), q), n
    toks, mask = left_padded(7)
    with torch.no_grad():
        a = master(torch.from_numpy(toks), attention_mask=torch.from_numpy(mask))
        b = serving(torch.from_numpy(toks), attention_mask=torch.from_numpy(mask))
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
