"""The port's int8 paged KV cache (B6 and ``quantize_block_write``)
against the JAX package, on the CPU.

- ``quantize_block_write`` against the reference's, bit for bit on pools
  and scales, over a sequence of writes: duplicate blocks in one write,
  a scale that grows and requantizes the block's earlier tokens, blocks
  left untouched, inactive rows sent to scratch block 0, and both of the
  port's branches (per-block requantize for small writes, whole-pool for
  large ones). Scratch block 0's payload is left out: rows that collide
  there are written in an order neither package defines, and nothing
  reads block 0.
- ``paged_flash_decode_int8_ref`` (the CPU wrapper) against the Pallas
  ``paged_flash_decode_int8`` in interpret mode: float32, atol 1e-5
  (summation order).
- A small float32 ``kv_int8=True`` engine against ``rl_tpu``'s: identical
  greedy tokens, log-probs within 1e-4; and the reference's own accuracy
  gate against the float engine (agreement >= 0.75, mean |dlp| < 0.1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_tpu.kernels import kvcache as jax_kvcache
from rl_tpu.kernels import registry as jax_registry
from rl_tpu.kernels.paged_attention import paged_flash_decode_int8 as jax_decode_int8
from rl_tpu.models import ContinuousBatchingEngine as JaxEngine
from rl_tpu.models import TransformerConfig as JaxConfig
from rl_tpu.models import TransformerLM as JaxLM
from rl_tpu_torch.kernels import kvcache
from rl_tpu_torch.kernels.paged_attention import (
    paged_flash_decode_int8,
    paged_flash_decode_int8_ref,
)
from rl_tpu_torch.models import (
    ContinuousBatchingEngine,
    TransformerConfig,
    TransformerLM,
    params_from_flax,
)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _reference_xla_read(monkeypatch):
    """The reference's stock read path on the CPU, whatever the ambient
    kernel switches say."""
    monkeypatch.delenv(jax_registry.ENV_INTERPRET, raising=False)
    monkeypatch.delenv(jax_registry.ENV_NO_KERNELS, raising=False)


def write_sequence(N, M_big):
    """(flat_blk, flat_off, vals) writes over a pool of N blocks, Hk=2,
    block 4, D=8: a first fill, a growth write into a filled block, a
    write with duplicate blocks and inactive rows at scratch 0, and one
    write with more rows than the pool has blocks (``M_big``)."""
    rng = np.random.default_rng(0)
    Hk, D = 2, 8

    def vals(m, scale):
        return (rng.standard_normal((m, Hk, D)) * scale).astype(np.float32)

    writes = [
        (np.array([1, 1, 1, 2]), np.array([0, 1, 2, 0]), vals(4, 0.5)),
        (np.array([1, 3]), np.array([3, 0]), vals(2, 4.0)),  # block 1 grows: requantize
        (np.array([2, 0, 0, 2, 0]), np.array([1, 2, 2, 2, 3]), vals(5, 2.0)),  # 0 = scratch
        (rng.integers(0, N, M_big), rng.integers(0, 4, M_big), vals(M_big, 1.5)),
    ]
    # block 1, kv head 0 gets amax 127, so scale 1.0 and exact ties at .5:
    # both packages round half to even
    writes[0][2][0, 0, :4] = [127.0, 0.5, -1.5, 2.5]
    return writes


@pytest.mark.parametrize("M_big", [3, 40])
def test_quantize_block_write_is_bit_exact(M_big):
    N, Hk, block, D = 6, 2, 4, 8
    pool = torch.zeros((N, Hk, block, D), dtype=torch.int8)
    scale = kvcache.init_scales(N, Hk)
    jpool = jnp.zeros((N, Hk, block, D), jnp.int8)
    jscale = jax_kvcache.init_scales(N, Hk)
    for i, (blk, off, v) in enumerate(write_sequence(N, M_big)):
        untouched = sorted(set(range(1, N)) - set(blk.tolist()))
        before = pool[untouched].clone()
        out = kvcache.quantize_block_write(pool, scale, torch.from_numpy(blk),
                                           torch.from_numpy(off), torch.from_numpy(v))
        assert out[0] is pool and out[1] is scale  # in place
        jpool, jscale = jax_kvcache.quantize_block_write(
            jpool, jscale, jnp.asarray(blk, jnp.int32), jnp.asarray(off, jnp.int32),
            jnp.asarray(v))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale), err_msg=f"write {i}")
        np.testing.assert_array_equal(pool.numpy()[1:], np.asarray(jpool)[1:],
                                      err_msg=f"write {i}")
        assert torch.equal(pool[untouched], before)
    assert scale[1].min() > 0 and scale[3].min() > 0


def test_dequantize_and_capacity_match():
    rng = np.random.default_rng(1)
    q = rng.integers(-127, 128, (3, 2, 4, 8)).astype(np.int8)
    s = rng.random((3, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        kvcache.dequantize(torch.from_numpy(q), torch.from_numpy(s)).numpy(),
        np.asarray(jax_kvcache.dequantize(jnp.asarray(q), jnp.asarray(s))))
    for args in [(16, 2, 4), (16, 12, 64), (16, 8, 128)]:
        assert kvcache.effective_blocks_ratio(*args) == jax_kvcache.effective_blocks_ratio(*args)
        for int8 in (False, True):
            assert (kvcache.kv_block_bytes(*args, int8=int8)
                    == jax_kvcache.kv_block_bytes(*args, int8=int8))


def int8_inputs(seed, S, H, Hk, D, block, max_blocks, N, lens, holes=False):
    """Pools filled by a real quantize_block_write of random K/V (scales
    from the data), a table of distinct blocks covering each slot's
    length, optionally a -1 and a 0 inside the longest range."""
    rng = np.random.default_rng(seed)
    pool_k = torch.zeros((N, Hk, block, D), dtype=torch.int8)
    pool_v = torch.zeros_like(pool_k)
    sk, sv = kvcache.init_scales(N, Hk), kvcache.init_scales(N, Hk)
    blk = torch.from_numpy(np.repeat(np.arange(1, N), block))
    off = torch.from_numpy(np.tile(np.arange(block), N - 1))
    for pool, sc in ((pool_k, sk), (pool_v, sv)):
        v = torch.from_numpy(rng.standard_normal((len(blk), Hk, D)).astype(np.float32))
        kvcache.quantize_block_write(pool, sc, blk, off, v * 2.0)
    q = rng.standard_normal((S, 1, H, D)).astype(np.float32)
    table = np.full((S, max_blocks), -1, np.int32)
    perm = rng.permutation(np.arange(1, N))
    used = 0
    for s, L in enumerate(lens):
        nb = -(-L // block)
        table[s, :nb] = perm[used : used + nb]
        used += nb
    if holes:
        s = int(np.argmax(lens))
        table[s, 0], table[s, 2] = -1, 0
    return (q, pool_k.numpy(), pool_v.numpy(), sk.numpy(), sv.numpy(), table,
            np.asarray(lens, np.int32))


INT8_CASES = {
    "mha": dict(S=4, H=4, Hk=4, D=16, block=8, max_blocks=4, N=20, lens=[8, 9, 16, 31]),
    "gqa_holes": dict(S=3, H=6, Hk=2, D=16, block=8, max_blocks=4, N=16, lens=[5, 16, 30],
                      holes=True),
    "mqa": dict(S=3, H=4, Hk=1, D=32, block=4, max_blocks=8, N=24, lens=[1, 4, 29]),
}


@pytest.mark.parametrize("case", sorted(INT8_CASES))
def test_paged_int8_matches_pallas_interpret(case):
    args = int8_inputs(0, **INT8_CASES[case])
    t = [torch.from_numpy(a) for a in args]
    out = paged_flash_decode_int8(*t)
    assert torch.equal(out, paged_flash_decode_int8_ref(*t))  # CPU wrapper == plain version
    ref = jax_decode_int8(*(jnp.asarray(a) for a in args), interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_non_cpu_tensor_raises_instead_of_falling_back():
    args = [torch.empty((2, 1, 4, 32), device="meta"),
            torch.empty((4, 4, 8, 32), dtype=torch.int8, device="meta"),
            torch.empty((4, 4, 8, 32), dtype=torch.int8, device="meta"),
            torch.empty((4, 4), device="meta"), torch.empty((4, 4), device="meta"),
            torch.empty((2, 4), dtype=torch.int32, device="meta"),
            torch.empty((2,), dtype=torch.int32, device="meta")]
    with pytest.raises(ValueError, match="CUDA"):
        paged_flash_decode_int8(*args)


SMALL = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq_len=64)
ENGINE = dict(n_slots=4, block_size=4, n_blocks=48, prompt_buckets=(8, 16))
LENGTHS = [3, 8, 12, 16, 5, 9]
BUDGETS = [9, 6, 12, 4, 10, 7]


@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig(**SMALL, dtype=jnp.float32, kv_int8=True)
    jm = JaxLM(jcfg)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    tcfg = TransformerConfig(**SMALL, dtype=torch.float32, kv_int8=True)
    tm = TransformerLM(tcfg, device="cpu")
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params), tcfg))
    return jm, params, tm


def serve(engine):
    """Serve the six requests. A JAX engine settles a finished decode
    chunk before it admits only when the chunk's result is already there,
    so its schedule depends on timing; with int8 pools the schedule shows
    in the numbers, because scales only grow and a reused block keeps its
    scale. So the JAX engine is synced after every step, which gives it
    the schedule the port has on the CPU (where a chunk is always done)."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, SMALL["vocab_size"], n).astype(np.int32) for n in LENGTHS]
    rids = [engine.submit(p, b) for p, b in zip(prompts, BUDGETS)]
    while engine.step():
        if isinstance(engine, JaxEngine):
            jax.block_until_ready(engine.dev_lens)
    out = {f.rid: f for f in engine.finished}
    return [out[r] for r in rids]


def test_paged_cache_layout():
    tm = TransformerLM(TransformerConfig(**SMALL, dtype=torch.float32, kv_int8=True),
                       device="cpu")
    layer = tm.init_paged_cache(4, 10, 4, 16)[0]
    assert layer["pool_k"].dtype == torch.int8 and layer["pool_k"].shape == (10, 4, 4, 16)
    assert layer["scale_k"].shape == (10, 4) and layer["scale_v"].dtype == torch.float32
    eng = ContinuousBatchingEngine(tm, device="cpu", **ENGINE)
    assert all(len(bufs) == 4 for bufs in eng.pools)


@pytest.mark.parametrize("decode_chunk", [1, 4])
def test_int8_engine_matches_jax_engine(models, decode_chunk):
    jm, params, tm = models
    kw = dict(ENGINE, greedy=True, decode_chunk=decode_chunk)
    ref = serve(JaxEngine(jm, params, **kw))
    out = serve(ContinuousBatchingEngine(tm, device="cpu", **kw))
    for f, r in zip(out, ref):
        np.testing.assert_array_equal(f.tokens, r.tokens)
        np.testing.assert_allclose(f.log_probs, r.log_probs, atol=1e-4, rtol=0)


def test_int8_engine_accuracy_against_float_engine(models):
    """The reference's accuracy gate (tests/test_kernels.py), on the port."""
    _, _, tm = models
    fm = TransformerLM(dataclasses.replace(tm.cfg, kv_int8=False), device="cpu")
    fm.load_state_dict(tm.state_dict())
    kw = dict(ENGINE, greedy=True, decode_chunk=2, device="cpu")
    ref = serve(ContinuousBatchingEngine(fm, **kw))
    got = serve(ContinuousBatchingEngine(tm, **kw))
    same = [a == b for r, g in zip(ref, got) for a, b in zip(r.tokens, g.tokens)]
    deltas = [abs(a - b) for r, g in zip(ref, got) for a, b in zip(r.log_probs, g.log_probs)]
    assert np.mean(same) >= 0.75, same
    assert float(np.mean(deltas)) < 0.1, deltas


@pytest.mark.cuda
class TestOnCard:
    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card and nvcc")

    @pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
    def test_paged_int8_kernel(self, dtype, tol):
        for case in INT8_CASES.values():
            args = [torch.from_numpy(a).cuda() for a in int8_inputs(3, **dict(case, D=32))]
            args[0] = args[0].to(dtype)
            out = paged_flash_decode_int8(*args)
            ref = paged_flash_decode_int8_ref(*args)
            assert (out.float() - ref.float()).abs().max().item() <= tol
