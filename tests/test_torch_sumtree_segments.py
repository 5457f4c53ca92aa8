"""Kernel B7's segment algorithm (``kernels/csrc/sumtree.cu``) as a plain
model, against ``rl_tpu`` on the CPU.

On a CUDA tensor ``sumtree_update`` takes one of two routes, by the batch
size alone. Up to ``CAP`` updates, one block turns each index into
a 32-bit leaf and block target, keys each level by ``(target << 32) |
position``, tests whether the keys already ascend, sorts a level that does
not with a bitonic network, and lets the first key of each run of equal
targets fold the run's deltas in position order and write once. Above the
cap, each update scans the batch for an earlier one with its target. The
models below do the same steps in NumPy; they are held **bit for bit**
(compared as uint32) to the reference's stock arm, the two scatter-adds
XLA applies in operand order, as ``test_torch_sumtree.py`` holds the plain
version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_tpu.kernels import registry
from rl_tpu.kernels.sumtree import sumtree_update as jax_sumtree_update
from rl_tpu_torch.kernels import sumtree as S

torch.set_num_threads(1)

DROPPED = np.uint32(0xFFFFFFFF)
CAP = 4096  # kSegmentCap in sumtree.cu: the largest batch of the segment route


@pytest.fixture(autouse=True)
def stock_arm(monkeypatch):
    """The reference's stock scatter-adds (no interpret kernel)."""
    monkeypatch.delenv(registry.ENV_INTERPRET, raising=False)
    assert registry.selection("sumtree") is None


def bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.uint32)


def targets32(idx, P, NB, F):
    """``targets_of``: the leaf and block of each index as uint32, DROPPED
    where the scatter drops it. The range tests run on the int64 index,
    the division by the fanout on uint32 after them."""
    t = np.asarray(idx, np.int64)
    span = NB * F
    lf = np.where(t < 0, t + P, t)
    leaf = np.where((lf >= 0) & (lf < P), lf, DROPPED).astype(np.uint32)
    ok = (t >= -span) & (t < span)
    u = np.where(ok, np.where(t < 0, t + span, t), 0).astype(np.uint32)
    blk = np.where(ok, u // np.uint32(F), DROPPED).astype(np.uint32)
    return leaf, blk


def composite_keys(targets, n2):
    """``(target << 32) | position`` for positions 0..n2-1, the padding
    past the batch keyed as dropped targets."""
    tg = np.full(n2, DROPPED, np.uint64)
    tg[: len(targets)] = targets
    return (tg << np.uint64(32)) | np.arange(n2, dtype=np.uint64)


def ascending(keys) -> bool:
    """The kernel's block-wide test: every key below the next."""
    return bool(np.all(keys[:-1] < keys[1:]))


def bitonic_sort(keys):
    """The kernel's bitonic network over a power-of-two count of keys,
    one compare-exchange per pair and stage, ascending."""
    keys = keys.copy()
    n2 = len(keys)
    pr = np.arange(n2 // 2)
    k = 2
    while k <= n2:
        j = k // 2
        while j > 0:
            a = ((pr & ~(j - 1)) << 1) | (pr & (j - 1))
            b = a + j
            x, y = keys[a], keys[b]
            swap = (x > y) == ((a & k) == 0)
            keys[a] = np.where(swap, y, x)
            keys[b] = np.where(swap, x, y)
            j //= 2
        k *= 2
    return keys


def fold_runs(keys, B, values, delta):
    """The first key of each run of equal targets folds the run's deltas,
    in position order, onto the target's value and writes once."""
    tg, pos = (keys >> np.uint64(32)).astype(np.uint32), (keys & np.uint64(0xFFFFFFFF))
    owners = 0
    for k in range(B):
        if tg[k] == DROPPED or (k > 0 and tg[k - 1] == tg[k]):
            continue
        owners += 1
        acc = values[tg[k]]
        j = k
        while j < B and tg[j] == tg[k]:
            acc = np.float32(acc + delta[pos[j]])
            j += 1
        values[tg[k]] = acc
    return owners


def segment_model(pri, esum, idx, delta, F):
    """The segment route on copies; returns (priorities, esum, in_order,
    owners) with in_order and owners per level."""
    B = len(idx)
    n2 = 1 << max(B - 1, 0).bit_length()
    levels = [pri.copy(), esum.copy()]
    in_order, owners = [], []
    for values, targets in zip(levels, targets32(idx, len(pri), len(esum), F)):
        keys = composite_keys(targets, n2)
        in_order.append(ascending(keys))
        if not in_order[-1]:
            keys = bitonic_sort(keys)
        owners.append(fold_runs(keys, B, values, delta))
    return levels[0], levels[1], in_order, owners


def scan_model(pri, esum, idx, delta, F):
    """The scan route on copies: an update owns its target when no earlier
    one has it, and folds every update of it in batch order."""
    levels = [pri.copy(), esum.copy()]
    for values, targets in zip(levels, targets32(idx, len(pri), len(esum), F)):
        order = np.argsort(targets, kind="stable")  # batch order within a target
        for t in np.unique(targets[targets != DROPPED]):
            acc = values[t]
            for i in order[targets[order] == t]:
                acc = np.float32(acc + delta[i])
            values[t] = acc
    return levels[0], levels[1]


def model(pri, esum, idx, delta, F):
    """The kernel's route for this batch size, as the kernel picks it."""
    if len(idx) <= CAP:
        return segment_model(pri, esum, idx, delta, F)[:2]
    return scan_model(pri, esum, idx, delta, F)


def tree_case(seed, *, P, F, B, order, negative=False):
    rng = np.random.default_rng(seed)
    pri = (rng.random(P) * 3.0).astype(np.float32)
    esum = pri.reshape(-1, F).sum(-1).astype(np.float32)
    if order == "sorted":  # the sampler's stratified draws ascend
        idx = np.sort((rng.random(B) ** 4 * P).astype(np.int64))
    elif order == "equal":
        idx = np.full(B, rng.integers(0, P), np.int64)
    elif order == "edges":  # negative, wrapped and dropped indices, unsorted
        idx = rng.integers(-P - F, P + F, B)
    else:  # duplicates spread over the whole range, unsorted
        idx = rng.choice(rng.integers(0, P, max(B // 8, 1)), B)
    delta = (rng.standard_normal(B) * 0.7).astype(np.float32)
    if not negative:
        delta = np.abs(delta)
    return pri, esum, idx.astype(np.int64), delta


CASES = {
    "sorted_f16": dict(P=4096, F=16, B=256, order="sorted"),
    "unsorted_dups_f16": dict(P=4096, F=16, B=500, order="dups", negative=True),
    "all_equal_at_cap": dict(P=1024, F=16, B=CAP, order="equal"),
    "negative_and_out_of_range": dict(P=200, F=8, B=64, order="edges", negative=True),
    "fanout2": dict(P=512, F=2, B=300, order="dups"),
    "fanout64": dict(P=4096, F=64, B=128, order="dups"),
    "b1": dict(P=64, F=16, B=1, order="dups"),
    "above_cap_scan_route": dict(P=8192, F=16, B=CAP + 100, order="dups"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_bit_exact_with_reference_stock_arm(case):
    kw = CASES[case]
    pri, esum, idx, delta = tree_case(3, **kw)
    jp, je = jax_sumtree_update(jnp.asarray(pri), jnp.asarray(esum), jnp.asarray(idx, jnp.int32),
                                jnp.asarray(delta), fanout=kw["F"])
    mp, me = model(pri, esum, idx, delta, kw["F"])
    np.testing.assert_array_equal(bits(mp), bits(jp))
    np.testing.assert_array_equal(bits(me), bits(je))
    assert not np.array_equal(bits(mp), bits(pri))


@pytest.mark.parametrize("n2", [1, 2, 64, 4096])
def test_bitonic_network_sorts_keys_and_keeps_batch_order_within_a_target(n2):
    rng = np.random.default_rng(n2)
    targets = rng.integers(0, max(n2 // 8, 1), n2).astype(np.uint32)
    targets[rng.random(n2) < 0.1] = DROPPED
    keys = composite_keys(targets, n2)
    out = bitonic_sort(keys)
    np.testing.assert_array_equal(out, np.sort(keys))
    tg, pos = out >> np.uint64(32), out & np.uint64(0xFFFFFFFF)
    same = tg[1:] == tg[:-1]
    assert np.all(pos[1:][same] > pos[:-1][same])  # positions ascend within a target


def test_ascending_input_skips_the_sort():
    """The sampler's ascending indices pass the test on both levels, so
    the model folds them in the order given; one unsorted pair, or a
    dropped index amid valid ones, sends a level through the sort."""
    pri, esum, idx, delta = tree_case(5, **CASES["sorted_f16"])
    assert segment_model(pri, esum, idx, delta, 16)[2] == [True, True]
    i = int(np.flatnonzero(np.diff(idx) > 0)[0])
    swapped = idx.copy()
    swapped[[i, i + 1]] = idx[[i + 1, i]]
    assert segment_model(pri, esum, swapped, delta, 16)[2][0] is False
    dropped = idx.copy()
    dropped[100] = len(pri) * 2  # dropped on both levels, mid-batch
    assert segment_model(pri, esum, dropped, delta, 16)[2] == [False, False]


def test_one_owner_per_distinct_target():
    pri, esum, idx, delta = tree_case(6, **CASES["unsorted_dups_f16"])
    _, _, in_order, owners = segment_model(pri, esum, idx, delta, 16)
    assert in_order == [False, False]
    assert owners == [len(np.unique(idx)), len(np.unique(idx // 16))]


def test_32bit_targets_follow_the_reference_index_rules():
    """Each level on its own, as ``.at[...].add``: negative from the end,
    floor division for the block, out of range dropped; int64 indices far
    outside 32 bits drop too."""
    P, NB, F = 10, 3, 4
    idx = np.array([-1, -10, -11, -12, -13, 0, 9, 10, 11, 12, -4, 2**40, -(2**40), 2**31 + 5])
    leaf, blk = targets32(idx, P, NB, F)
    for t, lf, bk in zip(idx.tolist(), leaf.tolist(), blk.tolist()):
        want_leaf = t + P if t < 0 else t
        want_blk = t // F + (NB if t // F < 0 else 0)
        assert lf == (want_leaf if 0 <= want_leaf < P else int(DROPPED))
        assert bk == (want_blk if 0 <= want_blk < NB else int(DROPPED))


def test_wrapper_rejects_targets_past_32_bits():
    """The kernel keys leaves and blocks in 32 bits; the wrapper refuses a
    tree where either count reaches 2**31 (stride-0 views: no memory)."""
    one = torch.zeros(1, dtype=torch.long)
    with pytest.raises(ValueError, match=r"2\*\*31"):
        S.sumtree_update(torch.zeros(1).expand(2**31), torch.zeros(1).expand(2**27), one,
                         torch.zeros(1), fanout=16)
    with pytest.raises(ValueError, match=r"2\*\*31"):
        S.sumtree_update(torch.zeros(8), torch.zeros(1).expand(2**28), one, torch.zeros(1),
                         fanout=8)
    p, e = torch.zeros(8), torch.zeros(2)
    S.sumtree_update(p, e, one, torch.ones(1), fanout=4)  # below the limit: runs
    assert p[0] == 1 and e[0] == 1


def test_both_routes_compute_one_function():
    """The segment and the scan model agree bit for bit on the same
    batches: the route changes only how the kernel finds each target's
    run."""
    for case in ("unsorted_dups_f16", "negative_and_out_of_range"):
        kw = CASES[case]
        pri, esum, idx, delta = tree_case(8, **kw)
        sp, se = segment_model(pri, esum, idx, delta, kw["F"])[:2]
        cp, ce = scan_model(pri, esum, idx, delta, kw["F"])
        np.testing.assert_array_equal(bits(sp), bits(cp), err_msg=case)
        np.testing.assert_array_equal(bits(se), bits(ce), err_msg=case)


@pytest.mark.cuda
def test_kernel_routes_bit_exact_with_models_on_card():
    """The kernel on the card against the model of the route it takes
    (skipped without a card; ``chip_smoke.py`` runs its own cases on both
    routes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    for case, kw in sorted(CASES.items()):
        pri, esum, idx, delta = tree_case(9, **kw)
        p, e, i, d = (torch.from_numpy(a.copy()).cuda() for a in (pri, esum, idx, delta))
        S.sumtree_update(p, e, i, d, fanout=kw["F"])
        want = model(pri, esum, idx, delta, kw["F"])
        np.testing.assert_array_equal(bits(p.cpu()), bits(want[0]), err_msg=case)
        np.testing.assert_array_equal(bits(e.cpu()), bits(want[1]), err_msg=case)
