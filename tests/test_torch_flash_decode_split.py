"""The dense-cache decode's split plan, and a plain model of its split
and combine, against the JAX package on the CPU.

On a CUDA tensor ``flash_decode`` cuts the positions below ``cache_len``
into chunks of ``PAGED_SPLIT_CHUNK`` positions, one block per (chunk, kv
head, row), as the paged decode does; ``flash_decode_plan`` shapes the
float32 scratch from the host-side ``cache_len``. A lane reads the
``kv_mask`` bytes of its positions first: a masked position is never
fetched (its copy is a zero-fill), and a chunk the mask hides whole
fetches no K or V and writes ``(m, l) = (-inf, 0)``, leaving its acc
unwritten. Scores run in float64, (m, l, acc) in float32. A second kernel
combines every row's ``n_split`` chunks, one length for all rows.
``split_model`` below does the same arithmetic in plain PyTorch on the
plan's own shapes; its scratch starts as NaN, so a combine that read a
chunk no block wrote would show. It is held to the reference
``rl_tpu.ops.attention.flash_decode`` (the Pallas kernel in interpret
mode) in float32 to 1e-5, the tolerance ``chip_smoke.py`` holds the CUDA
kernel to, and to the port's plain version.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_tpu.ops.attention import flash_decode as jax_flash_decode
from rl_tpu_torch.ops import attention as A

torch.set_num_threads(1)

CHUNK = A.PAGED_SPLIT_CHUNK
NAN, NEG_INF = float("nan"), float("-inf")


def split_model(q, k, v, cache_len, kv_mask=None, scale=None):
    """Split and combine as the kernel does them. Returns ``(out [B, 1, H,
    D], acc, ml)`` with the scratch as the split blocks left it (NaN where
    no block wrote)."""
    B, _, H, D = q.shape
    Hk = k.shape[2]
    G = H // Hk
    n_split, acc_shape, ml_shape = A.flash_decode_plan(B, H, D, cache_len)
    acc = torch.full(acc_shape, NAN)
    ml = torch.full(ml_shape, NAN)
    scale = scale if scale is not None else D**-0.5
    qd = (q * scale)[:, 0].float().double().reshape(B, Hk, G, D)
    out = torch.zeros((B, H, D))
    for b in range(B):
        for i in range(n_split):
            pos = torch.arange(i * CHUNK, min(i * CHUNK + CHUNK, cache_len))
            vis = torch.ones(len(pos), dtype=torch.bool)
            if kv_mask is not None:
                vis = kv_mask[b, pos].bool()
            if not vis.any():  # hidden whole: no K/V read, acc not written
                ml[b, :, i, 0] = NEG_INF
                ml[b, :, i, 1] = 0.0
                continue
            # a masked position's copy is a zero-fill: its row is never read
            kk = torch.where(vis[:, None, None], k[b, pos].float(), 0.0)
            vv = torch.where(vis[:, None, None], v[b, pos].float(), 0.0)
            s = torch.einsum("hgd,nhd->hgn", qd[b], kk.double())
            s = torch.where(vis, s, NEG_INF)
            m = s.float().amax(dim=-1)  # the max of the scores rounded to float32
            p = torch.where(vis, torch.exp((s - m.double()[..., None]).float()), 0.0)
            acc[b, :, i] = torch.einsum("hgn,nhd->hgd", p, vv).reshape(H, D)
            ml[b, :, i, 0] = m.reshape(H)
            ml[b, :, i, 1] = p.sum(dim=-1).reshape(H)
        if n_split == 0:  # an empty cache: the combine writes zeros
            continue
        # the combine: every row's n_split splits, from the host's cache_len
        m, l, a = ml[b, :, :, 0], ml[b, :, :, 1], acc[b]
        has = l > 0
        M = torch.where(has, m, NEG_INF).amax(dim=-1, keepdim=True)
        w = torch.where(has, torch.exp(m - torch.where(M.isfinite(), M, 0.0)), 0.0)
        num = (w[..., None] * torch.where(has[..., None], a, 0.0)).sum(dim=1)
        den = (w * torch.where(has, l, 0.0)).sum(dim=1)
        out[b] = torch.where(den[:, None] > 0, num / torch.where(den > 0, den, 1.0)[:, None], 0.0)
    return out[:, None].to(q.dtype), acc, ml


def dense_inputs(seed, B, S, H, Hk, D, pads=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hk, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hk, D)).astype(np.float32)
    mask = None if pads is None else np.arange(S)[None, :] >= np.asarray(pads)[:, None]
    return q, k, v, mask


# fill levels at and across the 64-position split edges; left pads that
# hide whole splits (64, 128, 200); visible keys only in the last split;
# GQA, MQA, D 32/64/128 and an S that is no multiple of 64. Every row
# keeps a visible key (the reference leaves the mean of V on a row with
# none; the port gives zeros, tested below).
CASES = {
    "split_edges_mha_d64": dict(B=2, S=192, H=4, Hk=4, D=64, fills=(63, 64, 65, 128, 129, 192)),
    "whole_split_pads_gqa_d32": dict(B=4, S=256, H=6, Hk=2, D=32, pads=(0, 64, 128, 200),
                                     fills=(201, 256)),
    "last_split_only_mha_d32": dict(B=2, S=256, H=4, Hk=4, D=32, pads=(192, 250),
                                    fills=(256,)),
    "mqa_d32": dict(B=2, S=128, H=8, Hk=1, D=32, fills=(1, 100, 128)),
    "gqa_d128": dict(B=2, S=128, H=8, Hk=2, D=128, fills=(64, 65, 128)),
    "s200_pads": dict(B=2, S=200, H=4, Hk=2, D=64, pads=(0, 70), fills=(130, 199, 200)),
}


def case_inputs(seed, name):
    kw = dict(CASES[name])
    fills = kw.pop("fills")
    return dense_inputs(seed, **kw), fills


def torch_args(q, k, v, mask):
    return [torch.from_numpy(a) for a in (q, k, v)], None if mask is None else torch.from_numpy(mask)


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_and_combine_match_pallas_flash_decode_interpret(name):
    (q, k, v, mask), fills = case_inputs(0, name)
    t, m = torch_args(q, k, v, mask)
    for n in fills:
        out, _, _ = split_model(*t, n, m)
        ref = jax_flash_decode(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(n, jnp.int32),
            kv_mask=None if mask is None else jnp.asarray(mask), interpret=True,
        )
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0,
                                   err_msg=f"cache_len {n}")


def test_split_model_matches_the_plain_version():
    for name in sorted(CASES):
        (q, k, v, mask), fills = case_inputs(1, name)
        t, m = torch_args(q, k, v, mask)
        for n in fills:
            out, _, _ = split_model(*t, n, m)
            torch.testing.assert_close(out, A.flash_decode_ref(*t, n, kv_mask=m), atol=1e-5,
                                       rtol=0, msg=f"{name} cache_len {n}")


def test_hidden_splits_write_neg_inf_and_zero_and_leave_acc_unwritten():
    (q, k, v, mask), _ = case_inputs(2, "whole_split_pads_gqa_d32")
    t, m = torch_args(q, k, v, mask)
    out, acc, ml = split_model(*t, 256, m)
    for b, pad in enumerate((0, 64, 128, 200)):
        hidden = pad // CHUNK  # splits whose every position is a pad
        assert (ml[b, :, :hidden, 0] == NEG_INF).all() and (ml[b, :, :hidden, 1] == 0).all()
        assert torch.isnan(acc[b, :, :hidden]).all()
        assert not torch.isnan(ml[b, :, hidden:]).any() and not torch.isnan(acc[b, :, hidden:]).any()
    assert torch.isfinite(out).all()


def test_masked_and_unfilled_rows_are_never_read():
    """NaN in every K/V row under the mask or at or past cache_len changes
    nothing (the plain version's 0 * NaN would give NaN under the mask)."""
    (q, k, v, mask), _ = case_inputs(3, "s200_pads")
    n = 150
    t, m = torch_args(q, k, v, mask)
    clean, _, _ = split_model(*t, n, m)
    hidden = ~m.clone()
    hidden[:, n:] = True
    kn, vn = t[1].clone(), t[2].clone()
    kn[hidden], vn[hidden] = NAN, NAN
    dirty, _, _ = split_model(t[0], kn, vn, n, m)
    assert torch.equal(clean, dirty)
    assert torch.isnan(A.flash_decode_ref(t[0], kn, vn, n, kv_mask=m)).any()


def test_row_with_no_visible_key_is_zero():
    (q, k, v, mask), _ = case_inputs(4, "whole_split_pads_gqa_d32")
    t, m = torch_args(q, k, v, mask)
    out, _, ml = split_model(*t, 150, m)  # row 3's pads (200) cover every filled position
    assert (out[3] == 0).all() and (ml[3, :, :, 1] == 0).all()
    assert (out[:3] != 0).any(dim=-1).all()
    torch.testing.assert_close(out, A.flash_decode_ref(*t, 150, kv_mask=m), atol=1e-5, rtol=0)


def test_combine_takes_n_split_from_the_host_length():
    """Every row's combine reads exactly ceil(cache_len / 64) splits, each
    written (a state or (-inf, 0)); an empty cache has no split and gives
    zeros."""
    (q, k, v, mask), _ = case_inputs(5, "split_edges_mha_d64")
    t, _ = torch_args(q, k, v, mask)
    for n in (0, 1, 64, 65, 192):
        out, acc, ml = split_model(*t, n)
        assert ml.shape[2] == acc.shape[2] == -(-n // CHUNK)
        assert not torch.isnan(ml).any() and not torch.isnan(acc).any()
        if n == 0:
            assert (out == 0).all()


def test_plan_from_cache_len():
    # the evaluate's decode: 8 rows of 12 heads of 64, cache_len 513 .. 1023
    for n, splits in ((513, 9), (768, 12), (1023, 16), (1024, 16), (0, 0), (1, 1), (64, 1)):
        n_split, acc_shape, ml_shape = A.flash_decode_plan(8, 12, 64, n)
        assert n_split == splits
        assert acc_shape == (8, 12, n_split, 64) and ml_shape == (8, 12, n_split, 2)
        assert math.prod(acc_shape) + math.prod(ml_shape) == 8 * 12 * n_split * 66


@pytest.mark.cuda
def test_kernel_matches_split_model_on_card():
    """The CUDA kernel against the model (skipped without a card;
    ``chip_smoke.py`` holds it to the plain version at full size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    for name in sorted(CASES):
        (q, k, v, mask), fills = case_inputs(6, name)
        t, m = torch_args(q, k, v, mask)
        for n in fills:
            out = A.flash_decode(*(a.cuda() for a in t), n,
                                 kv_mask=None if m is None else m.cuda())
            model, _, _ = split_model(*t, n, m)
            torch.testing.assert_close(out.cpu(), model, atol=1e-5, rtol=0)
