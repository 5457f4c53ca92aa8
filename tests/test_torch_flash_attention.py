"""The port's flash attention against the JAX package's, on the CPU.

On CPU tensors ``flash_attention`` runs its plain versions
(``flash_attention_ref`` forward, ``flash_attention_bwd_ref`` backward);
the JAX side runs the Pallas kernels in interpret mode with 16 x 16
blocks, as ``tests/test_pallas_attention.py`` does. Float32, the same
numpy inputs. Values to rtol 2e-4, atol 2e-5 and all three gradients
(``jax.vjp`` against autograd, the same cotangent) to rtol 2e-3, atol
2e-4: the reference's own flash-vs-dense tolerances. With a padding mask
only real query rows are compared and the cotangent is zero on pad rows
(the loss-mask contract): a query with no attended key is a don't-care
row in the reference (its value depends on the block size) and exactly
zero, with lse -1e30, in the port. The CUDA kernels are held to these
plain versions by the ``cuda``-marked tests below and by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_tpu.ops.attention import _flash_fwd_bhtd
from rl_tpu.ops.attention import flash_attention as jax_flash
from rl_tpu_torch.ops import attention as A

torch.set_num_threads(1)

CASES = {
    "mha_causal": dict(H=4, Hk=4, causal=True),
    "mha_full": dict(H=4, Hk=4, causal=False),
    "gqa_causal": dict(H=4, Hk=2, causal=True),
    "mqa_full": dict(H=4, Hk=1, causal=False),
    "kv_mask_causal": dict(H=4, Hk=2, causal=True, pad=(7, 40)),  # row 1 fully padded
    "kv_mask_full": dict(H=2, Hk=2, causal=False, pad=(0, 13)),
    "segments_causal": dict(H=2, Hk=1, causal=True, packed=True),
}


def inputs(seed, H, Hk, causal, B=2, T=40, D=16, pad=None, packed=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hk, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hk, D)).astype(np.float32)
    g = rng.standard_normal((B, T, H, D)).astype(np.float32)
    kv_mask = seg = None
    real = np.ones((B, T), bool)  # query rows compared
    if pad is not None:
        kv_mask = np.arange(T)[None, :] >= np.asarray(pad)[:, None]
        real = kv_mask
    if packed:
        seg = np.repeat(np.array([[3, 3, 7, 9]]), T // 4, axis=1).repeat(B, axis=0)
    return q, k, v, g * real[:, :, None, None], kv_mask, seg, real


def run_jax(q, k, v, g, kv_mask, seg, causal):
    f = lambda q, k, v: jax_flash(  # noqa: E731
        q, k, v, causal=causal, block_q=16, block_k=16, interpret=True,
        kv_mask=None if kv_mask is None else jnp.asarray(kv_mask),
        segment_ids=None if seg is None else jnp.asarray(seg),
    )
    o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(o), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def run_port(q, k, v, g, kv_mask, seg, causal):
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o = A.flash_attention(
        tq, tk, tv, causal=causal,
        kv_mask=None if kv_mask is None else torch.from_numpy(kv_mask),
        segment_ids=None if seg is None else torch.from_numpy(seg),
    )
    o.backward(torch.from_numpy(g))
    return o.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_values_and_gradients_match_pallas_interpret(case):
    kw = CASES[case]
    q, k, v, g, kv_mask, seg, real = inputs(0, **kw)
    o_j, grads_j = run_jax(q, k, v, g, kv_mask, seg, kw["causal"])
    o_t, grads_t = run_port(q, k, v, g, kv_mask, seg, kw["causal"])
    np.testing.assert_allclose(o_t[real], o_j[real], rtol=2e-4, atol=2e-5)
    for name, a, b in zip("qkv", grads_t, grads_j):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_lse_matches_pallas_forward(causal):
    q, k, v, *_ = inputs(1, H=2, Hk=2, causal=causal)
    B, T, H, D = q.shape
    qb, kb, vb = (np.moveaxis(a, 2, 1).reshape(B * H, T, D) for a in (q, k, v))
    _, lse_j = _flash_fwd_bhtd(
        jnp.asarray(qb), jnp.asarray(kb), jnp.asarray(vb), None, None, group=1,
        causal=causal, scale=D**-0.5, block_q=16, block_k=16, interpret=True,
    )
    _, lse_t = A.flash_fwd(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(lse_t.numpy().reshape(B * H, T), np.asarray(lse_j), atol=1e-5)


def test_row_with_no_key_is_zero_with_lse_neg_1e30():
    """Left-padded prompts put pad queries before every real key. The
    port gives them o = 0 and lse = -1e30; the reference leaves a
    block-dependent value there (a don't-care row), so it is not
    compared."""
    q, k, v, g, kv_mask, seg, real = inputs(2, H=2, Hk=1, causal=True, pad=(9, 0))
    o, lse = A.flash_fwd(*(torch.from_numpy(a) for a in (q, k, v)),
                         *A._seg_from_args(torch.from_numpy(kv_mask), None, 2, 40, "cpu"),
                         causal=True)
    assert torch.all(o[0, :9] == 0) and torch.all(lse[0, :, :9] == -1e30)
    assert torch.all(o[0, 9:].abs().sum(-1) > 0) and torch.all(lse[1] > -1e29)
    o_j, _ = run_jax(q, k, v, g, kv_mask, None, True)
    assert np.abs(o_j[0, :9]).max() > 0  # the reference's don't-care rows


def test_seg_from_args_lowers_masks():
    mask = torch.tensor([[False, True, True]])
    qseg, kseg = A._seg_from_args(mask, None, 1, 3, "cpu")
    assert qseg.tolist() == [[1, 1, 1]] and kseg.tolist() == [[-1, 1, 1]]
    seg = torch.tensor([[4, 4, 5]])
    qseg, kseg = A._seg_from_args(None, seg, 1, 3, "cpu")
    assert qseg.dtype == torch.int32 and torch.equal(qseg, kseg)
    with pytest.raises(ValueError, match="not both"):
        A._seg_from_args(mask, seg, 1, 3, "cpu")


def test_wrappers_raise_on_non_cpu_tensors_instead_of_falling_back():
    q = torch.empty((1, 8, 2, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        A.flash_fwd(q, q, q)
    lse = torch.empty((1, 2, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        A.flash_bwd(q, q, q, q, lse, q)
    with pytest.raises(ValueError, match="CUDA"):
        A.flash_bwd_dq(q, q, q, q, lse, lse, None, None, True, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        A.flash_bwd_dkv(q, q, q, q, lse, lse, None, None, True, 1.0)
    seg = torch.empty((1, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="or neither"):
        A._check_flash("flash_fwd", [], q, q, q, seg, None)


@pytest.mark.cuda
class TestOnCard:
    """The three kernels against their plain versions on the card
    (skipped without one; ``chip_smoke.py`` runs the full set)."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card and nvcc")

    @pytest.mark.parametrize("case", sorted(CASES))
    @pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
    def test_kernels_match_plain_versions(self, case, dtype, tol):
        kw = CASES[case]
        q, k, v, g, kv_mask, seg, _ = inputs(3, D=32, **kw)
        q, k, v, g = (torch.from_numpy(a).cuda().to(dtype) for a in (q, k, v, g))
        qseg, kseg = A._seg_from_args(
            None if kv_mask is None else torch.from_numpy(kv_mask),
            None if seg is None else torch.from_numpy(seg), *q.shape[:2], q.device,
        )
        c = kw["causal"]
        o, lse = A.flash_fwd(q, k, v, qseg, kseg, c)
        o_r, lse_r = A.flash_attention_ref(q, k, v, c, None, qseg, kseg)
        dq, dk, dv = A.flash_bwd(q, k, v, o_r, lse_r, g, qseg, kseg, c)
        ref = A.flash_attention_bwd_ref(q, k, v, o_r, lse_r, g, c, None, qseg, kseg)
        for a, b in [(o, o_r), (dq, ref[0]), (dk, ref[1]), (dv, ref[2])]:
            assert (a.float() - b.float()).abs().max().item() <= tol * max(1.0, b.abs().max())
