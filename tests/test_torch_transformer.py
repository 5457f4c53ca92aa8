"""The port's TransformerLM against the flax reference, on the CPU.

Same flax-initialized weights in both (``params_from_flax``), same numpy
tokens. Float32: no-cache logits and the paged path (a ragged bucketed
prefill, then three decode steps through ``paged_flash_decode``) to atol
1e-4, lengths exactly. bfloat16: the no-cache logits to 0.1 absolute,
the scale of a few bf16 roundings (eps 2^-8) of logits of order 1
through two layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_tpu.models import TransformerConfig as JaxConfig
from rl_tpu.models import TransformerLM as JaxLM
from rl_tpu_torch.models import TransformerConfig, TransformerLM, params_from_flax

torch.set_num_threads(1)

SMALL = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq_len=64)


def pair(n_kv_heads=None, dtype="float32", seed=0):
    jcfg = JaxConfig(**SMALL, n_kv_heads=n_kv_heads, dtype=getattr(jnp, dtype))
    jm = JaxLM(jcfg)
    params = jm.init(jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    tcfg = TransformerConfig(**SMALL, n_kv_heads=n_kv_heads, dtype=getattr(torch, dtype))
    tm = TransformerLM(tcfg, device="cpu")
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params), tcfg))
    return jm, params, tm


def tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, SMALL["vocab_size"], shape).astype(np.int32)


@pytest.mark.parametrize("n_kv_heads", [None, 2])
def test_params_from_flax_covers_the_module(n_kv_heads):
    _, params, tm = pair(n_kv_heads)
    sd = params_from_flax(jax.tree.map(np.asarray, params), tm.cfg)
    own = tm.state_dict()
    assert sorted(sd) == sorted(own)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(own[k].shape), k
    # dense kernels are transposed: [in, out] -> nn.Linear's [out, in]
    name = "qkv" if n_kv_heads is None else "wkv"
    k = np.asarray(params["h1"]["attn"][name]["kernel"])
    np.testing.assert_array_equal(own[f"h.1.attn.{name}.weight"].numpy(), k.T)


@pytest.mark.parametrize("n_kv_heads", [None, 2])
@pytest.mark.parametrize("masked", [False, True])
def test_no_cache_logits_match(n_kv_heads, masked):
    jm, params, tm = pair(n_kv_heads)
    toks = tokens(1, (3, 12))
    mask = None
    if masked:
        mask = np.arange(12)[None, :] < np.array([[12], [7], [3]])
    ref = jm.apply({"params": params}, jnp.asarray(toks),
                   attention_mask=None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        out = tm(torch.from_numpy(toks),
                 attention_mask=None if mask is None else torch.from_numpy(mask))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_bf16_no_cache_logits_track_the_reference():
    """bf16 semantics: bf16 logits from the tied head (flax promotes the
    'fp32 head' to the module dtype), f32 LayerNorm statistics."""
    jm, params, tm = pair(dtype="bfloat16")
    toks = tokens(2, (2, 10))
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(toks)).astype(jnp.float32))
    with torch.no_grad():
        out = tm(torch.from_numpy(toks))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=0.1, rtol=0)


@pytest.mark.parametrize("n_kv_heads", [None, 2])
def test_paged_prefill_then_decode_matches(n_kv_heads):
    jm, params, tm = pair(n_kv_heads)
    S, block, nb, maxb = 3, 4, 16, 8
    table = np.full((S, maxb), -1, np.int32)
    for s in range(S):
        table[s, :4] = 1 + s * 4 + np.arange(4)
    lens = np.array([5, 9, 12])
    toks = tokens(3, (S, 12))
    active = np.arange(12)[None, :] < lens[:, None]  # ragged bucketed prefill

    jcache = jm.init_paged_cache(S, nb, block, maxb)
    tcache = tm.init_paged_cache(S, nb, block, maxb)
    for jl, tl in zip(jcache, tcache):
        jl["block_table"], tl["block_table"] = jnp.asarray(table), torch.from_numpy(table)
        jl["active"], tl["active"] = jnp.asarray(active), torch.from_numpy(active)
    jlog, jcache = jm.apply({"params": params}, jnp.asarray(toks), cache=jcache)
    with torch.no_grad():
        tlog, tcache = tm(torch.from_numpy(toks), cache=tcache)
    rows = np.arange(S)
    np.testing.assert_allclose(
        tlog.numpy()[rows, lens - 1], np.asarray(jlog)[rows, lens - 1], atol=1e-4, rtol=0
    )
    np.testing.assert_array_equal(tcache[0]["len"].numpy(), np.asarray(jcache[0]["len"]))

    step_active = np.array([True, False, True])  # slot 1 sits the steps out
    nxt = tokens(4, (S, 3))
    for t in range(3):
        for jl, tl in zip(jcache, tcache):
            jl["active"], tl["active"] = jnp.asarray(step_active), torch.from_numpy(step_active)
        jlog, jcache = jm.apply({"params": params}, jnp.asarray(nxt[:, t : t + 1]), cache=jcache)
        with torch.no_grad():
            tlog, tcache = tm(torch.from_numpy(nxt[:, t : t + 1]), cache=tcache)
        np.testing.assert_allclose(
            tlog.numpy()[step_active], np.asarray(jlog)[step_active], atol=1e-4, rtol=0
        )
        np.testing.assert_array_equal(tcache[0]["len"].numpy(), np.asarray(jcache[0]["len"]))
        for jl, tl in zip(jcache, tcache):  # the written pools agree too
            np.testing.assert_allclose(tl["pool_k"].numpy(), np.asarray(jl["pool_k"]),
                                       atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tcache[0]["len"].numpy(), lens + 3 * step_active)


@pytest.mark.parametrize(
    "kw", [dict(moe_experts=4), dict(kv_int8=True),
           dict(remat=True, remat_policy="dots_no_batch"),
           dict(attention_impl="ring"), dict(flash_decode=True)],
)
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError):
        TransformerConfig(**SMALL, **kw)
