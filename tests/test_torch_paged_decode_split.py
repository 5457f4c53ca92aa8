"""The paged decode's split plan, and a plain model of its split and
combine, against the JAX package on the CPU.

On a CUDA tensor ``paged_flash_decode`` cuts each slot's sequence into
chunks of ``PAGED_SPLIT_CHUNK`` positions, one block per (chunk, kv head,
slot); each block writes its online-softmax state (m, l and the
unnormalised acc) to a float32 scratch shaped by ``paged_decode_plan``,
and a second kernel rescales the live chunks' states to their common max
and sums them. ``split_model`` below does the same arithmetic in plain
PyTorch on the plan's own shapes. The scratch starts as NaN, so a combine
that read a chunk no block wrote would show. It is held to the reference
``rl_tpu.ops.attention.paged_flash_decode`` (the Pallas kernel in
interpret mode, as ``tests/test_torch_kernels.py`` runs it) in float32 to
1e-5, the tolerance ``chip_smoke.py`` holds the CUDA kernel to.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_tpu.ops.attention import paged_flash_decode as jax_paged_flash_decode
from rl_tpu_torch.ops import attention as A

torch.set_num_threads(1)

CHUNK = A.PAGED_SPLIT_CHUNK


def split_model(q, pool_k, pool_v, table, lens, scale=None):
    """Split and combine as the kernel does them, float32. Returns
    ``(out [S, 1, H, D], acc, ml)`` with the scratch as the split blocks
    left it (NaN where no block wrote)."""
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
            valid = entry > 0
            blk = entry.clamp(min=0)
            k = pool_k[blk, :, pos % block].float()  # [n, Hk, D]
            v = pool_v[blk, :, pos % block].float()
            sc = torch.einsum("hgd,nhd->hgn", qf[s], k)
            sc = torch.where(valid, sc, float("-inf"))
            m = sc.amax(dim=-1)  # -inf for a chunk of holes
            p = torch.where(valid, torch.exp(sc - torch.where(m.isfinite(), m, 0.0)[..., None]),
                            0.0)
            acc[s, :, i] = torch.einsum("hgn,nhd->hgd", p, v).reshape(H, D)
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


def paged_inputs(seed, S, H, Hk, D, block, max_blocks, N, lens, holes=()):
    """Seeded pools, q and a table of distinct blocks covering each slot's
    length (the rest -1). ``holes``: (slot, entry, value) overrides."""
    rng = np.random.default_rng(seed)
    pool_k = rng.standard_normal((N, Hk, block, D)).astype(np.float32)
    pool_v = rng.standard_normal((N, Hk, block, D)).astype(np.float32)
    q = rng.standard_normal((S, 1, H, D)).astype(np.float32)
    table = np.full((S, max_blocks), -1, np.int32)
    perm = rng.permutation(np.arange(1, N))
    used = 0
    for s, L in enumerate(lens):
        nb = min(-(-L // block), max_blocks)
        table[s, :nb] = perm[used : used + nb]
        used += nb
    for s, j, val in holes:
        table[s, j] = val
    return q, pool_k, pool_v, table, np.asarray(lens, np.int32)


# every case has several chunks per slot; lengths end inside, at and past
# chunk edges, and past max_blocks * block (clamped)
CASES = {
    # slot 0 attends nothing; chunks past each length are never written
    "mha_past_len": dict(S=4, H=2, Hk=2, D=32, block=8, max_blocks=24, N=80,
                         lens=[0, 5, 64, 130]),
    # slot 1's second chunk (entries 8..15) holds only holes: -1 and 0
    "gqa_hole_chunk": dict(S=3, H=4, Hk=2, D=32, block=8, max_blocks=24, N=80,
                           lens=[40, 150, 192],
                           holes=[(1, j, -1 if j % 2 else 0) for j in range(8, 16)]),
    # GQA 3, block 16; a hole inside the last chunk of slot 2
    "gqa3_b16": dict(S=3, H=6, Hk=2, D=32, block=16, max_blocks=12, N=40,
                     lens=[17, 128, 190], holes=[(2, 9, -1)]),
    # MQA, block 32, a length past max_blocks * block
    "mqa_b32_clamped": dict(S=2, H=4, Hk=1, D=32, block=32, max_blocks=6, N=16,
                            lens=[63, 400]),
    # block 64: one entry per chunk
    "mha_b64": dict(S=2, H=2, Hk=2, D=32, block=64, max_blocks=4, N=10, lens=[65, 256]),
}


def run_jax(q, pk, pv, table, lens):
    return np.asarray(jax_paged_flash_decode(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(table),
        jnp.asarray(lens), interpret=True,
    ))


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_and_combine_match_pallas_kernel_interpret(case):
    q, pk, pv, table, lens = paged_inputs(0, **CASES[case])
    out, _, _ = split_model(*(torch.from_numpy(a) for a in (q, pk, pv, table, lens)))
    np.testing.assert_allclose(out.numpy(), run_jax(q, pk, pv, table, lens), atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_model_matches_the_plain_version(case):
    args = [torch.from_numpy(a) for a in paged_inputs(1, **CASES[case])]
    out, _, _ = split_model(*args)
    torch.testing.assert_close(out, A.paged_flash_decode_ref(*args), atol=1e-5, rtol=0)


def test_chunks_past_the_length_are_never_written_or_read():
    kw = CASES["mha_past_len"]
    q, pk, pv, table, lens = (torch.from_numpy(a) for a in paged_inputs(2, **kw))
    out, acc, ml = split_model(q, pk, pv, table, lens)
    for s, L in enumerate(kw["lens"]):
        live = -(-L // CHUNK)
        assert torch.isnan(ml[s, :, live:]).all() and torch.isnan(acc[s, :, live:]).all()
        assert not torch.isnan(ml[s, :, :live]).any()
    assert torch.isfinite(out).all() and (out[0] == 0).all()


def test_chunk_of_holes_contributes_nothing():
    kw = CASES["gqa_hole_chunk"]
    q, pk, pv, table, lens = (torch.from_numpy(a) for a in paged_inputs(3, **kw))
    out, acc, ml = split_model(q, pk, pv, table, lens)
    assert (ml[1, :, 1, 0] == float("-inf")).all() and (ml[1, :, 1, 1] == 0).all()
    assert (acc[1, :, 1] == 0).all()
    assert torch.isfinite(out).all()
    # a slot whose every chunk is holes, or whose length is 0, gives zeros
    table[0] = -1
    lens[2] = 0
    out, _, _ = split_model(q, pk, pv, table, lens)
    assert (out[0] == 0).all() and (out[2] == 0).all() and (out[1] != 0).any()


def test_split_plan_covers_the_table_from_the_shapes_alone():
    # the serve and collect path: 64 entries of 16 rows
    n_split, acc_shape, ml_shape = A.paged_decode_plan(8, 12, 64, 16, 64)
    assert (n_split, acc_shape, ml_shape) == (16, (8, 12, 16, 64), (8, 12, 16, 2))
    for block in (8, 16, 32, 64):
        for max_blocks in (1, 3, 4, 64, 65):
            n, acc, ml = A.paged_decode_plan(2, 4, 32, block, max_blocks)
            L = block * max_blocks
            assert (n - 1) * CHUNK < L <= n * CHUNK
            assert acc == (2, 4, n, 32) and ml == (2, 4, n, 2)
    # the scratch the wrapper allocates holds both
    assert math.prod(acc_shape) + math.prod(ml_shape) == 8 * 12 * 16 * 66


def test_shared_memory_of_a_split_block():
    # two stages of 32 K and 32 V rows in the pools' type, float32 queries
    # and four warps' (acc, m, l) for 1, 4 or 8 heads
    assert A._paged_decode_smem(2, 64, 1) == 2 * 4 * 32 * 64 + 4 * (64 + 4 * 66)
    assert A._paged_decode_smem(4, 128, 3) == 4 * 4 * 32 * 128 + 4 * (4 * 128 + 16 * 130)
    assert A._paged_decode_smem(4, 128, 12) == A._paged_decode_smem(4, 128, 8)
    assert A._paged_decode_smem(4, 128, 8) <= A._SMEM_LIMIT


@pytest.mark.cuda
def test_kernel_matches_split_model_on_card():
    """The CUDA kernel against the model (skipped without a card;
    ``chip_smoke.py`` holds it to the plain version at full size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    for case in sorted(CASES):
        args = [torch.from_numpy(a) for a in paged_inputs(4, **CASES[case])]
        out = A.paged_flash_decode(*(a.cuda() for a in args))
        model, _, _ = split_model(*args)
        torch.testing.assert_close(out.cpu(), model, atol=1e-5, rtol=0)
