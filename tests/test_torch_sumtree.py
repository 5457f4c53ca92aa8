"""Kernel B7 (the PER sum-tree update) of the port against ``rl_tpu``, on
the CPU.

On CPU tensors ``sumtree_update`` runs its plain version, an ordered
fold; it is held **bit for bit** (compared as uint32) to the reference's
stock arm, the two scatter-adds XLA applies in operand order (the arm
``rl_tpu.kernels.sumtree.sumtree_update`` takes off the TPU, and the one
its Pallas kernel is bit-exact against). The sampler that drives it is
held to the reference's in ``test_torch_prioritized_sampler.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_tpu.kernels import registry
from rl_tpu.kernels.sumtree import sumtree_update as jax_sumtree_update
from rl_tpu_torch.kernels.sumtree import sumtree_update, sumtree_update_ref

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def stock_arm(monkeypatch):
    """The reference's stock scatter-adds (no interpret kernel)."""
    monkeypatch.delenv(registry.ENV_INTERPRET, raising=False)
    assert registry.selection("sumtree") is None


def bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.uint32)


def last_writer_deltas(idx, delta):
    """Zero every delta but the last of each repeated index, as the
    sampler's ``_delta_update`` does before the kernel."""
    out = delta.copy()
    seen = set()
    for i in range(len(idx) - 1, -1, -1):
        if idx[i] in seen:
            out[i] = 0.0
        seen.add(idx[i])
    return out


def tree_case(seed, *, P, F, B, order, dedup=True, negative=False, one_block=None,
              last_block=False):
    rng = np.random.default_rng(seed)
    pri = (rng.random(P) * 3.0).astype(np.float32)
    esum = pri.reshape(-1, F).sum(-1).astype(np.float32)
    if one_block is not None:  # several updates into one block, some on one leaf
        idx = one_block * F + rng.integers(0, F, B)
    else:
        idx = rng.integers(0, P, B)
        idx[: B // 4] = idx[B // 4 : 2 * (B // 4)]  # duplicates
    if last_block:
        idx[-1] = P - 1
    if order == "sorted":
        idx = np.sort(idx)
    delta = rng.standard_normal(B).astype(np.float32) * 0.7
    if not negative:  # leaves stay non-negative, as PER's do
        delta = np.abs(delta)
    if dedup:
        delta = last_writer_deltas(idx.tolist(), delta)
    return pri, esum, idx.astype(np.int32), delta


CASES = {
    "sorted_dedup_f4": dict(P=64, F=4, B=16, order="sorted"),
    "unsorted_dups_in_blocks_f4": dict(P=64, F=4, B=24, order="unsorted", dedup=False),
    "many_adds_one_block_f4": dict(P=64, F=4, B=12, order="unsorted", dedup=False,
                                   one_block=3),
    "b1_f16": dict(P=64, F=16, B=1, order="sorted"),
    "fanout2_last_block": dict(P=32, F=2, B=20, order="unsorted", last_block=True),
    "fanout16_sorted": dict(P=256, F=16, B=64, order="sorted"),
    "negative_deltas_f4": dict(P=64, F=4, B=16, order="unsorted", dedup=False, negative=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_bit_exact_with_reference_stock_arm(case):
    kw = CASES[case]
    pri, esum, idx, delta = tree_case(7, **kw)
    jp, je = jax_sumtree_update(jnp.asarray(pri), jnp.asarray(esum), jnp.asarray(idx),
                                jnp.asarray(delta), fanout=kw["F"])
    tp, te = torch.from_numpy(pri.copy()), torch.from_numpy(esum.copy())
    out = sumtree_update(tp, te, torch.from_numpy(idx), torch.from_numpy(delta), fanout=kw["F"])
    assert out[0] is tp and out[1] is te  # in place
    np.testing.assert_array_equal(bits(tp), bits(jp))
    np.testing.assert_array_equal(bits(te), bits(je))
    # the CPU wrapper is the plain version
    rp, re_ = sumtree_update_ref(torch.from_numpy(pri.copy()), torch.from_numpy(esum.copy()),
                                 torch.from_numpy(idx), torch.from_numpy(delta), fanout=kw["F"])
    np.testing.assert_array_equal(bits(rp), bits(tp))
    np.testing.assert_array_equal(bits(re_), bits(te))


def test_order_matters_so_the_fold_is_not_presummed():
    """Three adds into one block: ((e + d1) + d2) + d3 differs from e +
    (d1 + d2 + d3) on these values, and the port gives the former."""
    e = np.float32(1.0)
    d = np.full(3, 2.0**-24, np.float32)  # each rounds away alone; their sum does not
    seq = np.float32(np.float32(np.float32(e + d[0]) + d[1]) + d[2])
    pre = np.float32(e + np.float32(np.float32(d[0] + d[1]) + d[2]))
    assert seq != pre
    pri = torch.zeros(4)
    esum = torch.tensor([1.0])
    sumtree_update(pri, esum, torch.tensor([0, 1, 2]), torch.from_numpy(d), fanout=4)
    assert bits(esum)[0] == bits(seq)


INDEX_EDGES = {
    # P = 8 leaves in 2 blocks of 4: -1 is the last leaf and block, -8 the
    # first, -9 and 8 drop the leaf, 2**30 drops both
    "exact_cover": (8, 2, [1, 8, 2**30, -1, -8, -9, -5, -4]),
    # P = 10 leaves in 3 blocks of 4: 10 and 11 drop the leaf but add to
    # block 2, -11 and -12 add to block 0 only, -4 adds to leaf 6 and block 2
    "padded_last_block": (10, 3, [-1, -10, -11, -12, -13, 9, 10, 11, 12, -4, -5]),
}


@pytest.mark.parametrize("case", sorted(INDEX_EDGES))
def test_out_of_range_and_negative_indices_like_xla(case):
    """Each level takes its index as ``.at[...].add`` does, on its own."""
    P, NB, idx = INDEX_EDGES[case]
    pri, esum = np.ones(P, np.float32), np.full(NB, 4.0, np.float32)
    idx = np.array(idx, np.int32)
    delta = (0.5 + np.arange(len(idx))).astype(np.float32)
    jp, je = jax_sumtree_update(jnp.asarray(pri), jnp.asarray(esum), jnp.asarray(idx),
                                jnp.asarray(delta), fanout=4)
    tp, te = sumtree_update(torch.from_numpy(pri), torch.from_numpy(esum),
                            torch.from_numpy(idx), torch.from_numpy(delta), fanout=4)
    assert not np.array_equal(bits(tp), bits(np.ones(P, np.float32)))
    np.testing.assert_array_equal(bits(tp), bits(jp))
    np.testing.assert_array_equal(bits(te), bits(je))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    p, e = torch.zeros(8), torch.zeros(2)
    with pytest.raises(ValueError, match="differ"):
        sumtree_update(p, e, torch.zeros(3, dtype=torch.long), torch.zeros(2), fanout=4)
    with pytest.raises(ValueError, match="float32"):
        sumtree_update(p.double(), e, torch.zeros(1, dtype=torch.long), torch.zeros(1), fanout=4)
    with pytest.raises(ValueError, match="do not cover"):
        sumtree_update(p, e, torch.zeros(1, dtype=torch.long), torch.zeros(1), fanout=2)
    with pytest.raises(ValueError, match="integer"):
        sumtree_update(p, e, torch.zeros(1), torch.zeros(1), fanout=4)


@pytest.mark.cuda
class TestOnCard:
    """B7 against its plain version on CPU copies, bit for bit (skipped
    without a card; ``chip_smoke.py`` runs the full set)."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card and nvcc")

    @pytest.mark.parametrize("case", sorted(CASES))
    def test_kernel_bit_exact(self, case):
        kw = CASES[case]
        pri, esum, idx, delta = tree_case(9, **kw)
        args = [torch.from_numpy(a) for a in (pri, esum, idx, delta)]
        cp, ce = sumtree_update_ref(args[0].clone(), args[1].clone(), args[2], args[3],
                                    fanout=kw["F"])
        gp, ge = sumtree_update(*(a.cuda() for a in args), fanout=kw["F"])
        np.testing.assert_array_equal(bits(gp.cpu()), bits(cp))
        np.testing.assert_array_equal(bits(ge.cpu()), bits(ce))
