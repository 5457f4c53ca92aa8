"""The port's dense-cache decode (B3) against the JAX package, on the CPU.

On CPU tensors ``flash_decode`` runs ``flash_decode_ref``, the plain
version; it is held to the reference's Pallas ``flash_decode`` in
interpret mode (float32, same numpy inputs, atol 1e-5: the two sum in a
different order) over MHA, GQA and MQA, caches walked in several key
blocks, fill levels at block edges, and left-padded ``kv_mask`` rows that
keep a real key. A row with no visible key is 0 in the port (the
reference leaves the mean of V there; ROADMAP queue C). ``generate``
with ``flash_decode=True`` is held to the reference's with
``flash_decode=True, flash_interpret=True``: identical greedy tokens and
masks, log-probs within 1e-4. The CUDA kernel itself is held to the plain
version on the card by ``chip_smoke.py`` and the ``cuda``-marked test.
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
from rl_tpu.ops.attention import flash_decode as jax_flash_decode
from rl_tpu_torch.models import TransformerConfig, TransformerLM, generate, params_from_flax
from rl_tpu_torch.ops.attention import flash_decode, flash_decode_ref

torch.set_num_threads(1)


def decode_inputs(seed, B, S, H, Hk, D, pads=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hk, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hk, D)).astype(np.float32)
    mask = None
    if pads is not None:
        mask = np.arange(S)[None, :] >= np.asarray(pads)[:, None]
    return q, k, v, mask


def port(q, k, v, cache_len, mask):
    t = [torch.from_numpy(a) for a in (q, k, v)]
    m = None if mask is None else torch.from_numpy(mask)
    out = flash_decode(*t, cache_len, kv_mask=m)
    ref = flash_decode_ref(*t, cache_len, kv_mask=m)
    assert torch.equal(out, ref)  # the CPU wrapper is the plain version
    return out.numpy()


# block_k 16 below S, so several key blocks are walked; fill levels at a
# block edge (16, 32), one past it (17, 33), mid-block and the whole cache
CASES = {
    "mha": dict(B=2, S=64, H=4, Hk=4, D=16, lens=(16, 17, 37, 64)),
    "gqa": dict(B=3, S=48, H=6, Hk=2, D=16, lens=(1, 32, 33, 48)),
    "mqa": dict(B=2, S=32, H=4, Hk=1, D=32, lens=(5, 16, 32)),
    "gqa_leftpad": dict(B=3, S=64, H=4, Hk=2, D=16, lens=(20, 48, 64), pads=(0, 5, 19)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_pallas_flash_decode_interpret(case):
    kw = dict(CASES[case])
    lens, pads = kw.pop("lens"), kw.pop("pads", None)
    q, k, v, mask = decode_inputs(0, pads=pads, **kw)
    for n in lens:
        out = port(q, k, v, n, mask)
        ref = jax_flash_decode(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(n, jnp.int32),
            kv_mask=None if mask is None else jnp.asarray(mask), block_k=16, interpret=True,
        )
        np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5, rtol=0, err_msg=f"len {n}")


def test_row_with_no_visible_key_is_zero():
    """Row 1's pads cover every filled position; row 0 keeps real keys
    and matches the reference."""
    q, k, v, mask = decode_inputs(1, B=2, S=32, H=2, Hk=1, D=16, pads=(0, 20))
    out = port(q, k, v, 12, mask)
    assert np.all(out[1] == 0) and np.any(out[0] != 0)
    ref = jax_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(12, jnp.int32), kv_mask=jnp.asarray(mask),
                           block_k=16, interpret=True)
    np.testing.assert_allclose(out[0], np.asarray(ref)[0], atol=1e-5, rtol=0)


def test_empty_cache_gives_zeros():
    q, k, v, _ = decode_inputs(2, B=2, S=16, H=2, Hk=2, D=8)
    assert np.all(port(q, k, v, 0, None) == 0)


def test_non_cpu_tensor_raises_instead_of_falling_back():
    q = torch.empty((2, 1, 4, 32), device="meta")
    k = torch.empty((2, 64, 4, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode(q, k, k, 10)


SMALL = dict(vocab_size=96, d_model=32, n_layers=2, n_heads=4, d_ff=64, max_seq_len=40)


def pair(n_kv_heads):
    jcfg = JaxConfig(**SMALL, n_kv_heads=n_kv_heads, dtype=jnp.float32, flash_decode=True,
                     flash_interpret=True)
    jm = JaxLM(jcfg)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    tcfg = TransformerConfig(**SMALL, n_kv_heads=n_kv_heads, dtype=torch.float32,
                             flash_decode=True)
    tm = TransformerLM(tcfg, device="cpu")
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params), tcfg))
    return jm, params, tm


@pytest.mark.parametrize("n_kv_heads", [None, 2])
def test_flash_decode_generate_matches(n_kv_heads):
    """12 prompt + 12 new tokens: S = 24 takes the kernel (24 % 24 == 0)
    in both packages on every decode step."""
    jm, params, tm = pair(n_kv_heads)
    rng = np.random.default_rng(4)
    pads = np.array([0, 3, 7])
    mask = np.arange(12)[None, :] >= pads[:, None]
    toks = np.where(mask, rng.integers(3, SMALL["vocab_size"], (3, 12)), 0).astype(np.int32)
    ref = jax_generate(jm, params, jnp.asarray(toks), jnp.asarray(mask, jnp.float32),
                       jax.random.key(0), max_new_tokens=12, eos_id=5, greedy=True)
    out = generate(tm, torch.from_numpy(toks), torch.from_numpy(mask.astype(np.float32)),
                   None, max_new_tokens=12, eos_id=5, greedy=True)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.response_mask.numpy(), np.asarray(ref.response_mask))
    np.testing.assert_allclose(out.response_log_probs.numpy(),
                               np.asarray(ref.response_log_probs), atol=1e-4, rtol=0)


def test_flash_decode_generate_equals_dense_read(monkeypatch):
    """The dispatch rule: with flash_decode the T=1 steps call the kernel's
    wrapper (counted here on the CPU), and give the dense read's tokens."""
    from rl_tpu_torch.models import transformer

    _, _, tm = pair(2)
    dense = TransformerLM(dataclasses.replace(tm.cfg, flash_decode=False), device="cpu")
    dense.load_state_dict(tm.state_dict())
    calls = []

    def counted(*a, **kw):
        calls.append(a[3])
        return flash_decode(*a, **kw)

    monkeypatch.setattr(transformer, "flash_decode", counted)
    toks = torch.from_numpy(np.random.default_rng(5).integers(3, 96, (2, 8)))
    mask = torch.ones((2, 8))
    a = generate(tm, toks, mask, None, max_new_tokens=8, greedy=True)
    b = generate(dense, toks, mask, None, max_new_tokens=8, greedy=True)
    assert torch.equal(a.tokens, b.tokens)
    torch.testing.assert_close(a.response_log_probs, b.response_log_probs, atol=1e-5, rtol=0)
    # 8 decode steps x 2 layers, cache lengths 9 .. 16
    assert len(calls) == 16 and sorted(set(calls)) == list(range(9, 17))


@pytest.mark.cuda
class TestOnCard:
    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card and nvcc")

    @pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
    def test_flash_decode_kernel(self, dtype, tol):
        for case in CASES.values():
            kw = dict(case)
            lens, pads = kw.pop("lens"), kw.pop("pads", None)
            kw["D"] = 32
            q, k, v, mask = decode_inputs(3, pads=pads, **kw)
            t = [torch.from_numpy(a).cuda().to(dtype) for a in (q, k, v)]
            m = None if mask is None else torch.from_numpy(mask).cuda()
            for n in lens:
                out = flash_decode(*t, n, kv_mask=m)
                ref = flash_decode_ref(*t, n, kv_mask=m)
                assert (out.float() - ref.float()).abs().max().item() <= tol
