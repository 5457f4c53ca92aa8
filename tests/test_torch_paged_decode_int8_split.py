"""The int8 paged decode's split and combine (kernel B6,
``kernels/csrc/paged_decode_int8.cu``) as a plain model, against the JAX
package on the CPU.

On a CUDA tensor ``paged_flash_decode_int8`` cuts each slot's sequence
into chunks of ``PAGED_SPLIT_CHUNK`` positions, one block per (chunk, kv
head, slot), as the paged decode over float pools does. A block widens
each int8 K/V row to float32 where it uses it and applies the row's
(block, kv head) scales there: scale_k to the row's dot product with q
(taken in float64, so that the score less the running max, not the score,
rounds to float32), scale_v to its softmax weight p. Each block writes its online-softmax
state (m, l and the unnormalised acc) to a float32 scratch shaped by
``paged_decode_plan``, and the combine rescales the live chunks' states to
their common max and sums them. ``split_model_int8`` below does the same
arithmetic in plain PyTorch on the plan's own shapes, with the scratch
started as NaN, so a combine that read a chunk no block wrote would show.
It is held to the reference ``rl_tpu.kernels.paged_attention.
paged_flash_decode_int8`` (the Pallas kernel in interpret mode, as
``tests/test_torch_kv_int8.py`` runs it) in float32 to 1e-5, the tolerance
``chip_smoke.py`` holds the CUDA kernel to. The int8 pools are written by
the port's ``quantize_block_write`` from seeded NumPy values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_tpu.kernels import registry as jax_registry
from rl_tpu.kernels.paged_attention import paged_flash_decode_int8 as jax_decode_int8
from rl_tpu_torch.kernels import kvcache
from rl_tpu_torch.kernels import paged_attention as P
from rl_tpu_torch.ops import attention as A

torch.set_num_threads(1)

CHUNK = A.PAGED_SPLIT_CHUNK


@pytest.fixture(autouse=True)
def _reference_kernel(monkeypatch):
    """The reference's kernel in interpret mode is called directly; keep
    the ambient kernel switches out of it."""
    monkeypatch.delenv(jax_registry.ENV_INTERPRET, raising=False)
    monkeypatch.delenv(jax_registry.ENV_NO_KERNELS, raising=False)


def split_model_int8(q, pool_k, pool_v, scale_k, scale_v, table, lens, scale=None):
    """Split and combine as the kernel does them, float32, with the int8
    rows widened and the scales applied at use. Returns ``(out [S, 1, H,
    D], acc, ml)`` with the scratch as the split blocks left it (NaN where
    no block wrote)."""
    S, _, H, D = q.shape
    _, Hk, block, _ = pool_k.shape
    max_blocks = table.shape[1]
    G = H // Hk
    n_split, acc_shape, ml_shape = A.paged_decode_plan(S, H, D, block, max_blocks)
    acc = torch.full(acc_shape, float("nan"))
    ml = torch.full(ml_shape, float("nan"))
    scale = scale if scale is not None else D**-0.5
    qf = (q * scale)[:, 0].float().reshape(S, Hk, G, D)
    out = torch.zeros((S, H, D))
    for s in range(S):
        L = min(int(lens[s]), max_blocks * block)
        for i in range(n_split):
            p0 = i * CHUNK
            if p0 >= L:  # the block exits at once
                continue
            pos = torch.arange(p0, min(p0 + CHUNK, L))
            entry = table[s, pos // block].long()
            valid = entry > 0  # per position: a chunk crosses several entries
            blk = entry.clamp(min=0)
            k = pool_k[blk, :, pos % block].float()  # [n, Hk, D], int8 widened
            v = pool_v[blk, :, pos % block].float()
            sk = torch.where(valid[:, None], scale_k[blk], 0.0)  # [n, Hk]
            sv = torch.where(valid[:, None], scale_v[blk], 0.0)
            # the scores in float64, the max rounded to float32: s - m rounds
            sc = torch.einsum("hgd,nhd->hgn", qf[s].double(), k.double()) * sk.T[:, None, :]
            sc = torch.where(valid, sc, float("-inf"))
            m = sc.amax(dim=-1).float()  # -inf for a chunk of holes
            m0 = torch.where(m.isfinite(), m, 0.0).double()[..., None]
            p = torch.where(valid, torch.exp((sc - m0).float()), 0.0)
            acc[s, :, i] = torch.einsum("hgn,nhd->hgd", p * sv.T[:, None, :], v).reshape(H, D)
            ml[s, :, i, 0] = m.reshape(H)
            ml[s, :, i, 1] = p.sum(dim=-1).reshape(H)
        live = -(-L // CHUNK) if L > 0 else 0
        if live == 0:  # nothing to combine: zeros
            continue
        m, l, a = ml[s, :, :live, 0], ml[s, :, :live, 1], acc[s, :, :live]
        has = l > 0
        M = torch.where(has, m, float("-inf")).amax(dim=-1, keepdim=True)
        w = torch.where(has, torch.exp(m - torch.where(M.isfinite(), M, 0.0)), 0.0)
        num = (w[..., None] * torch.where(has[..., None], a, 0.0)).sum(dim=1)
        den = (w * torch.where(has, l, 0.0)).sum(dim=1)
        out[s] = torch.where(den[:, None] > 0, num / torch.where(den > 0, den, 1.0)[:, None], 0.0)
    return out[:, None].to(q.dtype), acc, ml


def int8_inputs(seed, S, H, Hk, D, block, max_blocks, N, lens, holes=(), unwritten=()):
    """Pools filled by ``quantize_block_write`` of seeded K/V (one block
    written again 4x larger, so its scale grows and its rows requantize),
    q, and a table of distinct blocks covering each slot's length (the
    rest -1). ``holes``: (slot, entry, value) overrides; ``unwritten``:
    (slot, entry) pointed at block N - 1, which no write touches (scale 0,
    payload 0)."""
    rng = np.random.default_rng(seed)
    pools = []
    blk = torch.from_numpy(np.repeat(np.arange(1, N - 1), block))
    off = torch.from_numpy(np.tile(np.arange(block), N - 2))
    for _ in range(2):
        pool = torch.zeros((N, Hk, block, D), dtype=torch.int8)
        sc = kvcache.init_scales(N, Hk)
        vals = rng.standard_normal((len(blk), Hk, D)).astype(np.float32)
        kvcache.quantize_block_write(pool, sc, blk, off, torch.from_numpy(vals))
        grow = rng.standard_normal((1, Hk, D)).astype(np.float32) * 4.0
        kvcache.quantize_block_write(pool, sc, torch.ones(1, dtype=torch.long),
                                     torch.zeros(1, dtype=torch.long), torch.from_numpy(grow))
        pools += [pool.numpy(), sc.numpy()]
    q = rng.standard_normal((S, 1, H, D)).astype(np.float32)
    table = np.full((S, max_blocks), -1, np.int32)
    perm = rng.permutation(np.arange(2, N - 1))
    used = 0
    for s, L in enumerate(lens):
        nb = min(-(-L // block), max_blocks)
        table[s, :nb] = perm[used : used + nb]
        used += nb
    table[int(np.argmax(lens)), 0] = 1  # the grown block
    for s, j, val in holes:
        table[s, j] = val
    for s, j in unwritten:
        table[s, j] = N - 1
    pk, sk, pv, sv = pools
    return q, pk, pv, sk, sv, table, np.asarray(lens, np.int32)


# every case has several chunks per slot; lengths end inside, at and past
# chunk edges (and past max_blocks * block, clamped)
CASES = {
    # MHA, block 16: lengths at the chunk edges; slot 0 attends nothing
    "mha_b16_chunk_edges": dict(S=6, H=2, Hk=2, D=32, block=16, max_blocks=10, N=48,
                                lens=[0, 63, 64, 65, 128, 129]),
    # GQA 2, block 8: -1 and 0 entries inside chunks, a whole chunk of holes
    "gqa_b8_holes_mid_chunk": dict(S=3, H=4, Hk=2, D=32, block=8, max_blocks=24, N=64,
                                   lens=[40, 150, 192],
                                   holes=[(0, 2, -1), (0, 3, 0), (2, 17, 0)]
                                   + [(1, j, -1 if j % 2 else 0) for j in range(8, 16)]),
    # GQA 3, block 16, a length past max_blocks * block
    "gqa3_b16_clamped": dict(S=2, H=6, Hk=2, D=32, block=16, max_blocks=6, N=24,
                             lens=[17, 130]),
    # MQA, block 64: one entry per chunk
    "mqa_b64": dict(S=2, H=4, Hk=1, D=32, block=64, max_blocks=4, N=10, lens=[65, 256]),
    # a row with no visible key (every entry a hole) beside a live one
    "row_without_keys": dict(S=2, H=2, Hk=2, D=32, block=8, max_blocks=12, N=32, lens=[90, 70],
                             holes=[(1, j, -1) for j in range(9)]),
    # entries at a block no write touched: scale 0 and payload 0, harmless
    "unwritten_block": dict(S=2, H=2, Hk=1, D=32, block=16, max_blocks=8, N=20, lens=[100, 40],
                            unwritten=[(0, 2), (1, 1)]),
}


def run_jax(*args):
    return np.asarray(jax_decode_int8(*(jnp.asarray(a) for a in args), interpret=True))


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_model_matches_pallas_kernel_interpret(case):
    args = int8_inputs(0, **CASES[case])
    out, _, _ = split_model_int8(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(out.numpy(), run_jax(*args), atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_model_matches_the_plain_version(case):
    args = [torch.from_numpy(a) for a in int8_inputs(1, **CASES[case])]
    out, _, _ = split_model_int8(*args)
    torch.testing.assert_close(out, P.paged_flash_decode_int8_ref(*args), atol=1e-5, rtol=0)


def test_chunks_past_the_length_are_never_written_and_holes_give_zeros():
    kw = CASES["row_without_keys"]
    args = [torch.from_numpy(a) for a in int8_inputs(2, **kw)]
    out, acc, ml = split_model_int8(*args)
    for s, L in enumerate(kw["lens"]):
        live = -(-L // CHUNK)
        assert torch.isnan(ml[s, :, live:]).all() and torch.isnan(acc[s, :, live:]).all()
        assert not torch.isnan(ml[s, :, :live]).any()
    # slot 1's chunks hold only holes: m = -inf, l = 0, acc = 0, out = 0
    assert (ml[1, :, :2, 0] == float("-inf")).all() and (ml[1, :, :2, 1] == 0).all()
    assert (acc[1, :, :2] == 0).all() and (out[1] == 0).all()
    assert torch.isfinite(out).all() and (out[0] != 0).any()


def test_shared_memory_of_a_split_block():
    # two 32-row int8 K and V stages, float32 queries and the warps'
    # (acc, m, l) for 1 or up to 4 heads: 2 warps at D = 32, else 4
    assert P._paged_decode_int8_smem(64, 1) == 2 * 2 * 32 * 64 + 4 * (64 + 4 * 66)
    assert P._paged_decode_int8_smem(32, 3) == 2 * 2 * 32 * 32 + 4 * (4 * 32 + 2 * 4 * 34)
    assert P._paged_decode_int8_smem(128, 12) == P._paged_decode_int8_smem(128, 2) == 26752
    assert P._paged_decode_int8_smem(128, 12) <= 48 * 1024  # no opt-in needed


@pytest.mark.cuda
def test_kernel_matches_split_model_on_card():
    """The CUDA kernel against the model (skipped without a card;
    ``chip_smoke.py`` holds it to the plain version at full size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    for case in sorted(CASES):
        args = [torch.from_numpy(a) for a in int8_inputs(4, **dict(CASES[case], D=64))]
        out = P.paged_flash_decode_int8(*(a.cuda() for a in args))
        model, _, _ = split_model_int8(*args)
        torch.testing.assert_close(out.cpu(), model, atol=1e-5, rtol=0)
