"""The bf16 flash backward's rounding points and tile skip rules, on the
CPU, against the JAX package; and the alignment copy of the bf16 flash
wrappers.

``flash_bwd.cu`` computes the bf16 backward on tensor cores from bf16 q,
k, v and do: S = Q K^T and dP = dO V^T accumulate in float32 per 64 x
64 tile, P is rebuilt from the saved lse (masked by a select), dS = P
(dP - delta) in float32, and P and dS enter their products (dV += P^T
dO; dK += dS^T Q; dQ += dS K) as bf16 with float32 accumulators; dQ and
dK are multiplied by the softmax scale once, at the end; dK and dV sum
the GQA group in float32 before their one bf16 rounding.
``bwd_model`` does the same arithmetic in plain PyTorch. With P and dS
each split into two bf16 parts (hi = bf16(x), lo = bf16(x - hi), both
multiplied into the same accumulator), as the kernels do, the model stays
within the unchanged gate ``chip_smoke.py`` holds the kernels to
(``TOL_FLASH_BF16``: one bf16 step of |x| plus 1e-3 rms(x), per
element). One bf16 rounding of P breaks it in dV, one of dS in dQ and
dK: its ~1e-3 relative error per term lands on outputs near 0, where the
gate allows 1e-3 rms.

The JAX package's gradients are taken two ways. Through ``jax.vjp`` of
``rl_tpu.ops.attention.flash_attention`` on bf16 inputs in Pallas
interpret mode, as ``tests/test_torch_flash_attention.py`` runs it: dQ
always, dK and dV only without GQA, since the reference rounds each
query head's dK and dV to bf16 before it sums the group (the plain
version misses the gate against those too). And through the reference's
backward ``_flash_bwd_bhtd`` itself, in float32 on the same bf16 values
and the same o and lse, its per-head dK and dV summed in float32 and
every output rounded to bf16 once.

Skipped tiles. dQ walks a query tile's key tiles with the forward's
rule (``tests/test_torch_flash_fwd_bf16.py``'s ``tile_classes``): a key
tile none of whose ids lies in the query tile's [min, max] is neither
loaded nor computed, so a query tile of pad rows under a left-padded
kv_mask writes zeros. dK/dV walks a key tile's query tiles with the
mirror rule (``key_tile_classes``): no query id of the tile in the key
tile's [min, max]; a left-pad key tile so does no work and writes zeros.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from rl_tpu.ops.attention import _flash_bwd_bhtd
from rl_tpu.ops.attention import flash_attention as jax_flash
from rl_tpu_torch.ops import attention as A
from tests.test_torch_flash_fwd_bf16 import CASES, TILE, inputs, tile_classes

torch.set_num_threads(1)


def key_tile_classes(qseg, kseg, B, T, causal):
    """The dK/dV kernel's class of every (b, key tile, query tile): -1
    above the causal diagonal (never visited), 0 skipped (no query's id
    within the key tile's [min, max] ids), 2 every query inside T with
    the key tile's one id, 1 otherwise (masked per element)."""
    n = -(-T // TILE)
    cls = np.full((B, n, n), -1)
    for b in range(B):
        for kt in range(n):
            keys = slice(kt * TILE, min(kt * TILE + TILE, T))
            if qseg is not None:
                kmin, kmax = int(kseg[b, keys].min()), int(kseg[b, keys].max())
            for it in range(kt, n) if causal else range(n):
                t = np.arange(it * TILE, it * TILE + TILE)
                inside = t < T
                if qseg is None:
                    hit = full = inside
                else:
                    qs = np.where(inside, qseg[b, np.minimum(t, T - 1)], 0)
                    hit = inside & (qs >= kmin) & (qs <= kmax)
                    full = inside & (kmin == kmax) & (qs == kmin)
                cls[b, kt, it] = 0 if not hit.any() else 2 if full.all() else 1
    return cls


def bf16_parts(x, n):
    """``x`` as the bf16 parts a product takes: hi, then lo = x - hi."""
    hi = x.bfloat16().float()
    return [hi] if n == 1 else [hi, (x - hi).bfloat16().float()]


def bwd_model(q, k, v, o, lse, do, qseg, kseg, causal, p_parts=2, ds_parts=2, skip=True):
    """The kernels' arithmetic on bf16 ``q, k, v, o, do`` [B, T, H(k), D]
    and float32 ``lse`` [B, H, T]: float32 S, dP and dS (unscaled) per 64
    x 64 tile, P and dS as ``p_parts`` / ``ds_parts`` bf16 parts into
    float32 accumulators, dQ over key tiles, dK and dV over (group member,
    query tile), dQ and dK scaled at the end, each output rounded to bf16
    once. ``skip`` leaves out the tiles the kernels skip. Returns ``(dq,
    dk, dv)`` bf16."""
    B, T, H, D = q.shape
    Hk = k.shape[2]
    G = H // Hk
    scale = D**-0.5
    qf, kf, vf, dof = A._heads_first(q), A._heads_first(k, G), A._heads_first(v, G), \
        A._heads_first(do)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1)
    valid = A._attend_mask(B, T, causal, qseg, kseg, "cpu").expand(B, 1, T, T)
    n = -(-T // TILE)
    ids = [None if s is None else s.numpy() for s in (qseg, kseg)]
    q_cls = torch.from_numpy(tile_classes(*ids, B, T, causal))
    k_cls = torch.from_numpy(key_tile_classes(*ids, B, T, causal))
    least = 0 if skip else -1  # visited: class above this

    def rows(i):
        return slice(i * TILE, min(i * TILE + TILE, T))

    def p_ds(it, kt):
        r, c = rows(it), rows(kt)
        s = qf[:, :, r] @ kf[:, :, c].transpose(-1, -2) * scale
        p = torch.where(valid[:, :, r, c], torch.exp(s - lse[:, :, r, None]), 0.0)
        dp = dof[:, :, r] @ vf[:, :, c].transpose(-1, -2)
        return p, p * (dp - delta[:, :, r, None])

    dq = torch.zeros(B, H, T, D)
    for it in range(n):
        for kt in range(n):
            live = (q_cls[:, it, kt] > least)[:, None, None, None]
            _, ds = p_ds(it, kt)
            add = sum(x @ kf[:, :, rows(kt)] for x in bf16_parts(ds, ds_parts))
            dq[:, :, rows(it)] += torch.where(live, add, 0.0)
    dk, dv = torch.zeros(B, Hk, T, D), torch.zeros(B, Hk, T, D)
    for kt in range(n):
        for g in range(G):
            heads = torch.arange(Hk) * G + g  # query head g of each kv head's group
            for it in range(n):
                live = (k_cls[:, kt, it] > least)[:, None, None, None]
                p, ds = (x[:, heads] for x in p_ds(it, kt))
                r = rows(it)
                add_v = sum(x.transpose(-1, -2) @ dof[:, heads, r]
                            for x in bf16_parts(p, p_parts))
                add_k = sum(x.transpose(-1, -2) @ qf[:, heads, r]
                            for x in bf16_parts(ds, ds_parts))
                dv[:, :, rows(kt)] += torch.where(live, add_v, 0.0)
                dk[:, :, rows(kt)] += torch.where(live, add_k, 0.0)
    return tuple(x.permute(0, 2, 1, 3).bfloat16() for x in (dq * scale, dk * scale, dv))


def setup(seed, B, T, H, Hk, D, causal, pad=None, packed=False):
    """bf16 q, k, v, a cotangent that is 0 on rows with no key (the loss
    mask's contract), segment ids, and the plain forward's o and lse."""
    q, k, v, kv_mask, seg = inputs(seed, B, T, H, Hk, D, causal, pad, packed)
    g = inputs(seed + 100, B, T, H, H, D, causal)[0]  # bf16-exact, [B, T, H, D]
    qseg, kseg = A._seg_from_args(None if kv_mask is None else torch.from_numpy(kv_mask),
                                  None if seg is None else torch.from_numpy(seg), B, T, "cpu")
    real = A._attend_mask(B, T, causal, qseg, kseg, "cpu").any(-1)[:, 0].expand(B, T)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    do = (torch.from_numpy(g) * real[:, :, None, None]).bfloat16()
    o, lse = A.flash_attention_ref(tq, tk, tv, causal, None, qseg, kseg)
    return dict(q=tq, k=tk, v=tv, o=o, lse=lse, do=do, qseg=qseg, kseg=kseg, causal=causal,
                kv_mask=kv_mask, seg=seg)


def jax_vjp_bf16(s):
    """dq, dk, dv of the reference's ``flash_attention`` by ``jax.vjp``,
    bf16 in and out, Pallas in interpret mode with 16 x 16 blocks."""
    f = lambda q, k, v: jax_flash(  # noqa: E731
        q, k, v, causal=s["causal"], block_q=16, block_k=16, interpret=True,
        kv_mask=None if s["kv_mask"] is None else jnp.asarray(s["kv_mask"]),
        segment_ids=None if s["seg"] is None else jnp.asarray(s["seg"]))
    bf = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)  # noqa: E731
    _, vjp = jax.vjp(f, bf(s["q"]), bf(s["k"]), bf(s["v"]))
    return [torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
            for x in vjp(bf(s["do"]))]


def jax_bwd_float32(s):
    """The reference's backward ``_flash_bwd_bhtd`` in float32 on the same
    bf16 values, o and lse; per-head dK and dV summed over the group in
    float32; each output rounded to bf16 once."""
    q, k, v, o, do = (s[n].float() for n in ("q", "k", "v", "o", "do"))
    B, T, H, D = q.shape
    Hk = k.shape[2]
    G = H // Hk

    def bh(x):  # [B, T, X, D] -> [B * X, T, D]
        return jnp.asarray(x.permute(0, 2, 1, 3).reshape(-1, T, D).numpy())

    seg = [None if x is None else jnp.asarray(x.numpy()) for x in (s["qseg"], s["kseg"])]
    dq, dk, dv = _flash_bwd_bhtd(
        bh(q), bh(k), bh(v), bh(o), jnp.asarray(s["lse"].reshape(B * H, T).numpy()), bh(do),
        *seg, group=G, causal=s["causal"], scale=D**-0.5, block_q=16, block_k=16,
        interpret=True)

    def back(x, heads, sum_group):
        x = torch.from_numpy(np.array(x)).reshape(B, heads, T, D)
        if sum_group:
            x = x.reshape(B, Hk, G, T, D).sum(2)
        return x.permute(0, 2, 1, 3).bfloat16()

    return back(dq, H, False), back(dk, H, True), back(dv, H, True)


def model_of(s, **kw):
    return bwd_model(s["q"], s["k"], s["v"], s["o"], s["lse"], s["do"], s["qseg"], s["kseg"],
                     s["causal"], **kw)


def excess(a, b):
    return chip_smoke.flash_excess(a, b)[1]


@pytest.mark.parametrize("case", sorted(CASES))
def test_p_and_ds_in_two_bf16_parts_fit_the_gate(case):
    kw = CASES[case]
    s = setup(0, **kw)
    model = model_of(s)
    plain = A.flash_attention_bwd_ref(s["q"], s["k"], s["v"], s["o"], s["lse"], s["do"],
                                      s["causal"], None, s["qseg"], s["kseg"])
    exact = jax_bwd_float32(s)
    vjp = jax_vjp_bf16(s)
    for i, name in enumerate(("dq", "dk", "dv")):
        assert excess(model[i], plain[i]) <= 0.0, f"{name} vs the plain version"
        assert excess(model[i], exact[i]) <= 0.0, f"{name} vs _flash_bwd_bhtd in float32"
        if name == "dq" or kw["H"] == kw["Hk"]:
            assert excess(model[i], vjp[i]) <= 0.0, f"{name} vs jax.vjp in bf16"


@pytest.mark.parametrize("point", ["p_into_dv", "ds_into_dq_and_dk"])
def test_one_bf16_rounding_breaks_the_gate(point):
    """Why the kernels split P and dS: on seed 1, [2, 256, 2, 64] causal
    with left pads 0 and 100, one bf16 rounding of P puts dV, and one of
    dS puts dQ and dK, over the gate against the plain version; both split
    stay under it."""
    s = setup(1, B=2, T=256, H=2, Hk=2, D=64, causal=True, pad=[0, 100])
    plain = A.flash_attention_bwd_ref(s["q"], s["k"], s["v"], s["o"], s["lse"], s["do"],
                                      True, None, s["qseg"], s["kseg"])
    split = model_of(s)
    one = model_of(s, p_parts=1) if point == "p_into_dv" else model_of(s, ds_parts=1)
    broken = [2] if point == "p_into_dv" else [0, 1]
    for i in range(3):
        assert excess(split[i], plain[i]) <= 0.0
        if i in broken:
            assert excess(one[i], plain[i]) > 0.0
        else:
            assert torch.equal(one[i], split[i])


@pytest.mark.parametrize("case", sorted(CASES))
def test_key_tile_classes_drop_only_tiles_where_no_pair_attends(case):
    kw = CASES[case]
    B, T, causal = kw["B"], kw["T"], kw["causal"]
    _, _, _, kv_mask, seg = inputs(0, **kw)
    qseg, kseg = A._seg_from_args(None if kv_mask is None else torch.from_numpy(kv_mask),
                                  None if seg is None else torch.from_numpy(seg), B, T, "cpu")
    valid = A._attend_mask(B, T, causal, qseg, kseg, "cpu").expand(B, 1, T, T)[:, 0].numpy()
    cls = key_tile_classes(None if qseg is None else qseg.numpy(),
                           None if kseg is None else kseg.numpy(), B, T, causal)
    n = cls.shape[1]
    for b in range(B):
        for kt in range(n):
            for it in range(n):
                pairs = valid[b, it * TILE:it * TILE + TILE, kt * TILE:kt * TILE + TILE]
                if cls[b, kt, it] <= 0:
                    assert not pairs.any(), (b, kt, it)
                elif cls[b, kt, it] == 2 and not (causal and kt == it):
                    assert pairs.all(), (b, kt, it)
    if kv_mask is not None and causal:  # the rule finds the left-pad key tiles
        assert (cls == 0).any()


def test_skipped_tiles_leave_the_model_bitwise_unchanged():
    """Row 1's first two key tiles are all pads and its first two query
    tiles have no key at all: dK, dV there and dQ there are exactly 0."""
    s = setup(2, **CASES["leftpad_causal"])
    skipped = model_of(s, skip=True)
    every = model_of(s, skip=False)
    for a, b in zip(skipped, every):
        assert torch.equal(a, b)
    dq, dk, dv = skipped
    assert (dk[1, :128] == 0).all() and (dv[1, :128] == 0).all() and (dq[1, :128] == 0).all()
    assert dq[1, 150:].abs().amax() > 0 and dk[1, 150:].abs().amax() > 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_operand_copies_only_a_misaligned_bf16_view(dtype):
    base = torch.randn(4 * 64 + 8).to(dtype)
    aligned = base[: 4 * 64].view(4, 64)
    odd = base[1 : 1 + 4 * 64].view(4, 64)
    assert aligned.data_ptr() % 16 == 0 and odd.data_ptr() % 16 != 0
    assert A._flash_operand(aligned) is aligned
    out = A._flash_operand(odd)
    assert torch.equal(out, odd)
    if dtype == torch.bfloat16:  # the kernels copy 16-byte vectors: one copy
        assert out.data_ptr() % 16 == 0 and out.data_ptr() != odd.data_ptr()
    else:  # the float32 bodies load scalars: no copy
        assert out is odd
