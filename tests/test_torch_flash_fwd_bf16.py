"""The bf16 flash forward's rounding points and key-tile skip rule, on the
CPU, against the JAX package.

``flash_fwd.cu`` computes the bf16 forward on tensor cores: Q and K enter
as bf16, S = Q K^T accumulates in float32 and is scaled there, the online
softmax runs in float32 over 64-key tiles, and P enters the PV product as
bf16 with a float32 accumulator. ``fwd_model`` does the same arithmetic in
plain PyTorch. With P split into two bf16 parts (hi = bf16(P), lo =
bf16(P - hi), both multiplied by V), as the kernel does, the model stays
within the unchanged gate ``chip_smoke.py`` holds the kernel to
(``TOL_FLASH_BF16``: one bf16 step of |o| plus 1e-3 rms(o), per element)
against ``rl_tpu.ops.attention.flash_attention`` in bf16, run in interpret
mode as ``tests/test_pallas_attention.py`` runs it. One bf16 rounding of P
does not: its ~1e-3 relative error per term lands near o = 0, where the
gate allows 1e-3 rms(o).

Before its loop a kernel block classifies its key tiles from the segment
ids (``tile_classes`` restates the rule): class 0 tiles and tiles above
the causal diagonal are skipped. Held against ``_attend_mask``: a skipped
tile holds no attending pair, and a class-2 tile off the diagonal holds
only attending pairs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from rl_tpu.ops.attention import flash_attention as jax_flash
from rl_tpu_torch.ops import attention as A

torch.set_num_threads(1)

TILE = 64  # query rows and keys per tile (kBM, kBN in flash_fwd.cu)

CASES = {
    # row 1: query tiles 0 and 1 hold only pad rows (no key at all)
    "leftpad_causal": dict(B=2, T=192, H=2, Hk=1, D=64, causal=True, pad=[0, 150]),
    "leftpad_full": dict(B=2, T=128, H=2, Hk=2, D=32, causal=False, pad=[7, 100]),
    "packed_causal_ragged": dict(B=1, T=200, H=2, Hk=2, D=32, causal=True, packed=True),
    "gqa_causal_ragged": dict(B=1, T=136, H=4, Hk=2, D=64, causal=True),
    "mqa_leftpad_d128": dict(B=1, T=130, H=2, Hk=1, D=128, causal=True, pad=[70]),
}


def inputs(seed, B, T, H, Hk, D, causal, pad=None, packed=False):
    """float32 numpy q, k, v (bf16-exact), kv_mask and segment ids."""
    rng = np.random.default_rng(seed)

    def rnd(*shape):  # values bf16 holds exactly, for both frameworks
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return x.bfloat16().float().numpy()

    q, k, v = rnd(B, T, H, D), rnd(B, T, Hk, D), rnd(B, T, Hk, D)
    kv_mask = seg = None
    if pad is not None:
        kv_mask = np.arange(T)[None, :] >= np.asarray(pad)[:, None]
    if packed:
        seg = np.repeat((np.arange(T) * 3 // T)[None], B, axis=0).astype(np.int32)
    return q, k, v, kv_mask, seg


def tile_classes(qseg, kseg, B, T, causal):
    """The kernel's class of every (b, query tile, key tile): -1 above the
    causal diagonal (never visited), 0 skipped (no key's id within the
    query tile's [min, max] ids), 2 every key inside T with the query
    tile's one id, 1 otherwise (masked per element)."""
    n = -(-T // TILE)
    cls = np.full((B, n, n), -1)
    for b in range(B):
        for qt in range(n):
            rows = slice(qt * TILE, min(qt * TILE + TILE, T))
            if qseg is not None:
                qmin, qmax = int(qseg[b, rows].min()), int(qseg[b, rows].max())
            for kt in range(min(n, qt + 1) if causal else n):
                u = np.arange(kt * TILE, kt * TILE + TILE)
                inside = u < T
                if qseg is None:
                    hit = full = inside
                else:
                    ks = np.where(inside, kseg[b, np.minimum(u, T - 1)], 0)
                    hit = inside & (ks >= qmin) & (ks <= qmax)
                    full = inside & (qmin == qmax) & (ks == qmin)
                cls[b, qt, kt] = 0 if not hit.any() else 2 if full.all() else 1
    return cls


def fwd_model(q, k, v, qseg, kseg, causal, p_parts=2, skip=True):
    """The kernel's arithmetic on bf16 ``q, k, v`` [B, T, H(k), D]: float32
    S, online softmax over 64-key tiles, P as ``p_parts`` bf16 parts into a
    float32 PV. ``skip`` leaves out the tiles the kernel skips. Returns
    ``(o bf16, lse float32 [B, H, T])``."""
    B, T, H, D = q.shape
    G = H // k.shape[2]
    scale = D**-0.5
    qf, kf, vf = A._heads_first(q), A._heads_first(k, G), A._heads_first(v, G)
    valid = A._attend_mask(B, T, causal, qseg, kseg, "cpu").expand(B, 1, T, T)
    n = -(-T // TILE)
    cls = tile_classes(None if qseg is None else qseg.numpy(),
                       None if kseg is None else kseg.numpy(), B, T, causal)
    visit = torch.from_numpy(np.repeat(cls > 0 if skip else cls >= 0, TILE, axis=1)[:, :T])
    m = torch.full((B, H, T), -1e30)
    l = torch.zeros((B, H, T))
    acc = torch.zeros((B, H, T, D))
    for kt in range(n):
        keys = slice(kt * TILE, min(kt * TILE + TILE, T))
        s = qf @ kf[:, :, keys].transpose(-1, -2) * scale
        vis = valid[:, :, :, keys] & visit[:, None, :, kt, None]
        s = torch.where(vis, s, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        hi = p.bfloat16().float()
        pv = hi @ vf[:, :, keys]
        if p_parts == 2:
            pv = pv + (p - hi).bfloat16().float() @ vf[:, :, keys]
        acc = acc * corr[..., None] + pv
        m = m_new
    den = torch.where(l > 0, l, 1.0)
    o = (acc / den[..., None]).permute(0, 2, 1, 3).bfloat16()
    return o, m + torch.log(den)


def run_both(seed, p_parts, **kw):
    q, k, v, kv_mask, seg = inputs(seed, **kw)
    o_j = jax_flash(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)), causal=kw["causal"],
        block_q=16, block_k=16, interpret=True,
        kv_mask=None if kv_mask is None else jnp.asarray(kv_mask),
        segment_ids=None if seg is None else jnp.asarray(seg),
    )
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    qseg, kseg = A._seg_from_args(None if kv_mask is None else torch.from_numpy(kv_mask),
                                  None if seg is None else torch.from_numpy(seg),
                                  kw["B"], kw["T"], "cpu")
    o_m, lse_m = fwd_model(tq, tk, tv, qseg, kseg, kw["causal"], p_parts)
    o_j = torch.from_numpy(np.array(o_j.astype(jnp.float32))).bfloat16()
    # rows with a key; the reference leaves a don't-care value in the others
    B, T = kw["B"], kw["T"]
    real = A._attend_mask(B, T, kw["causal"], qseg, kseg, "cpu").any(-1)[:, 0].expand(B, T)
    return (o_m, lse_m), o_j, real, (tq, tk, tv, qseg, kseg)


@pytest.mark.parametrize("case", sorted(CASES))
def test_p_in_two_bf16_parts_fits_the_gate(case):
    kw = CASES[case]
    (o_m, lse_m), o_j, real, (q, k, v, qseg, kseg) = run_both(0, 2, **kw)
    _, excess = chip_smoke.flash_excess(o_m[real], o_j[real])
    assert excess <= 0.0, f"model vs reference: {excess} over TOL_FLASH_BF16"
    # ... and against the plain version chip_smoke.py holds the kernel to,
    # rows with no key included: exactly (0, -1e30) there
    o_r, lse_r = A.flash_attention_ref(q, k, v, kw["causal"], None, qseg, kseg)
    for a, b in [(o_m, o_r), (lse_m, lse_r)]:
        _, excess = chip_smoke.flash_excess(a, b)
        assert excess <= 0.0
    dead = ~real
    assert (o_m[dead] == 0).all() and (lse_m.transpose(1, 2)[dead] == -1e30).all()
    if case == "leftpad_causal":  # whole query tiles of pad rows
        assert dead[1, :128].all()


def test_one_bf16_rounding_of_p_breaks_the_gate():
    """Why the kernel splits P: rounded once, P's relative error (~1e-3
    per term) passes into o, and near o = 0 that exceeds 1e-3 rms(o)."""
    kw = dict(B=2, T=256, H=2, Hk=2, D=64, causal=True, pad=[0, 100])
    (o_one, _), o_j, real, _ = run_both(1, 1, **kw)
    (o_two, _), _, _, _ = run_both(1, 2, **kw)
    assert chip_smoke.flash_excess(o_one[real], o_j[real])[1] > 0.0
    assert chip_smoke.flash_excess(o_two[real], o_j[real])[1] <= 0.0


@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_classes_drop_only_tiles_where_no_pair_attends(case):
    kw = CASES[case]
    B, T, causal = kw["B"], kw["T"], kw["causal"]
    _, _, _, kv_mask, seg = inputs(0, **kw)
    qseg, kseg = A._seg_from_args(None if kv_mask is None else torch.from_numpy(kv_mask),
                                  None if seg is None else torch.from_numpy(seg), B, T, "cpu")
    valid = A._attend_mask(B, T, causal, qseg, kseg, "cpu").expand(B, 1, T, T)[:, 0].numpy()
    cls = tile_classes(None if qseg is None else qseg.numpy(),
                       None if kseg is None else kseg.numpy(), B, T, causal)
    n = cls.shape[1]
    for b in range(B):
        for qt in range(n):
            for kt in range(n):
                pairs = valid[b, qt * TILE:qt * TILE + TILE, kt * TILE:kt * TILE + TILE]
                if cls[b, qt, kt] <= 0:
                    assert not pairs.any(), (b, qt, kt)
                elif cls[b, qt, kt] == 2 and not (causal and kt == qt):
                    assert pairs.all(), (b, qt, kt)
    if kv_mask is not None:  # the rule finds the pad tiles
        assert (cls == 0).any()


def test_skipped_tiles_leave_the_model_bitwise_unchanged():
    kw = CASES["leftpad_causal"]
    q, k, v, kv_mask, _ = inputs(2, **kw)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    qseg, kseg = A._seg_from_args(torch.from_numpy(kv_mask), None, kw["B"], kw["T"], "cpu")
    o_skip, lse_skip = fwd_model(tq, tk, tv, qseg, kseg, True, skip=True)
    o_all, lse_all = fwd_model(tq, tk, tv, qseg, kseg, True, skip=False)
    assert torch.equal(o_skip, o_all) and torch.equal(lse_skip, lse_all)
