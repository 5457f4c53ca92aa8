"""The port's ``PrioritizedSampler`` (device PER over the B7 sum-tree)
against ``rl_tpu``'s, on the CPU.

Held to the reference's: ``on_write``, both dedup paths of
``update_priority``, and ``sample`` fed the reference's own uniform
draws. Tolerances: leaves and block sums bit for bit (compared as uint32)
wherever both sides add the same float32 deltas; ``esum`` rebuilt by
``on_write`` within 1 ulp relative (XLA and torch sum a row of F in
different orders); leaves written through ``(|p| + eps)^alpha`` within 2
ulps (the two libraries' ``pow`` differ in the last bit); sampled indices
equal; importance weights within 1e-6 relative (the block cumsum's order
differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_tpu.data.replay.samplers import PrioritizedSampler as JaxPER
from rl_tpu.kernels import registry
from rl_tpu_torch.data.arraydict import ArrayDict
from rl_tpu_torch.data.replay.samplers import PrioritizedSampler

torch.set_num_threads(1)
F32_ULP = 2.0**-23


@pytest.fixture(autouse=True)
def stock_arm(monkeypatch):
    """The reference's stock scatter-adds (no interpret kernel)."""
    monkeypatch.delenv(registry.ENV_INTERPRET, raising=False)
    assert registry.selection("sumtree") is None


def bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.uint32)


CAP, FANOUT, BATCH = 64, 4, 8


def port_state(jstate) -> ArrayDict:
    """The reference's sampler state, copied into the port's."""
    return ArrayDict({k: torch.from_numpy(np.array(v)) for k, v in jstate.items()})


def written(seed=0):
    """Both samplers and their states after writing slots 0-39. The tests
    after ``on_write`` copy the reference's state into the port
    (:func:`port_state`), so each step is held alone."""
    js, ts = JaxPER(fanout=FANOUT), PrioritizedSampler(fanout=FANOUT)
    jst = js.on_write(js.init(CAP), jnp.arange(40), None)
    pst = ts.on_write(ts.init(CAP), torch.arange(40), None)
    return js, ts, jst, pst


def assert_within_ulps(a, b, n):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    np.testing.assert_allclose(a, b, rtol=n * F32_ULP, atol=0)


def test_on_write_matches_reference():
    _, _, jst, pst = written()
    np.testing.assert_array_equal(bits(pst["priorities"]), bits(jst["priorities"]))
    assert_within_ulps(pst["esum"], jst["esum"], 1)
    assert float(pst["max_priority"]) == float(jst["max_priority"])


@pytest.mark.parametrize("indices_sorted", [False, True])
def test_delta_update_bit_exact_on_the_same_inputs(indices_sorted):
    """Both dedup paths, fed the reference's state and its ``_pa`` values:
    leaves and block sums bit for bit."""
    js, ts, jst, _ = written()
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 40, 24)
    idx[:6] = idx[6:12]
    if indices_sorted:
        idx = np.sort(idx)
    pa = js._pa(jnp.asarray(rng.random(24).astype(np.float32) * 5.0))
    jout = js._delta_update(jst, jnp.asarray(idx), pa, indices_sorted=indices_sorted)
    pout = ts._delta_update(port_state(jst), torch.from_numpy(idx),
                            torch.from_numpy(np.array(pa)), indices_sorted=indices_sorted)
    np.testing.assert_array_equal(bits(pout["priorities"]), bits(jout["priorities"]))
    np.testing.assert_array_equal(bits(pout["esum"]), bits(jout["esum"]))


@pytest.mark.parametrize("indices_sorted", [False, True])
def test_update_priority_matches_reference(indices_sorted):
    js, ts, jst, _ = written()
    rng = np.random.default_rng(2)
    idx = rng.integers(0, 40, 24)
    idx[:6] = idx[6:12]
    if indices_sorted:
        idx = np.sort(idx)
    prio = (rng.standard_normal(24) * 3.0).astype(np.float32)  # |p| is taken
    jout = js.update_priority(jst, jnp.asarray(idx), jnp.asarray(prio),
                              indices_sorted=indices_sorted)
    pout = ts.update_priority(port_state(jst), torch.from_numpy(idx), torch.from_numpy(prio),
                              indices_sorted=indices_sorted)
    assert_within_ulps(pout["priorities"], jout["priorities"], 2)
    # each block sum is the old one plus its deltas, each within 2 ulps of a leaf
    np.testing.assert_allclose(np.asarray(pout["esum"]), np.asarray(jout["esum"]),
                               rtol=8 * F32_ULP, atol=0)
    assert float(pout["max_priority"]) == float(jout["max_priority"])


def test_update_priority_gate_leaves_the_tree_untouched():
    """``ok`` false: NaN priorities change no leaf, block sum or max."""
    _, ts, jst, _ = written()
    pst = port_state(jst)
    before = {k: v.clone() for k, v in pst.items()}
    nan = torch.full((4,), float("nan"))
    out = ts.update_priority(pst, torch.tensor([0, 5, 5, 9]), nan, ok=torch.tensor(False))
    for k in ("priorities", "esum", "max_priority"):
        np.testing.assert_array_equal(bits(out[k]), bits(before[k]))


@pytest.mark.parametrize("size", [40, 3])
def test_sample_matches_reference_on_its_draws(size):
    js, ts, jst, _ = written()
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 40, 24)
    jst = js.update_priority(jst, jnp.asarray(idx),
                             jnp.asarray(rng.random(24).astype(np.float32) * 4.0))
    key = jax.random.key(11)
    j_idx, j_info, j_new = js.sample(jst, key, BATCH, jnp.asarray(size, jnp.int32), CAP)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (BATCH,))))
    p_idx, p_info, p_new = ts.sample(port_state(jst), None, BATCH, torch.tensor(size), CAP, u=u)
    np.testing.assert_array_equal(p_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(p_info["index"].numpy(), np.asarray(j_info["index"]))
    np.testing.assert_allclose(p_info["_weight"].numpy(), np.asarray(j_info["_weight"]),
                               rtol=1e-6, atol=0)
    assert int(p_new["step"]) == int(j_new["step"]) == 1
    assert np.all(np.diff(p_idx.numpy()) >= 0)  # stratified: ascending


def test_sample_and_update_cycle_matches_reference():
    """One fused PER cycle: stratified sample, priorities from the
    indices, sorted write-back."""
    js, ts, jst, _ = written()
    key = jax.random.key(5)
    fn_j = lambda i, info: (i.astype(jnp.float32) % 7.0) + 0.25  # noqa: E731
    fn_t = lambda i, info: (i.to(torch.float32) % 7.0) + 0.25  # noqa: E731
    j_idx, _, j_new = js.sample_and_update(jst, key, BATCH, jnp.asarray(40, jnp.int32), CAP, fn_j)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (BATCH,))))
    p_idx, _, p_new = ts.sample_and_update(port_state(jst), None, BATCH, torch.tensor(40), CAP,
                                           fn_t, u=u)
    np.testing.assert_array_equal(p_idx.numpy(), np.asarray(j_idx))
    assert_within_ulps(p_new["priorities"], j_new["priorities"], 2)
    np.testing.assert_allclose(p_new["esum"].numpy(), np.asarray(j_new["esum"]),
                               rtol=8 * F32_ULP, atol=0)


def test_high_priority_index_is_sampled_most():
    """The reference's distribution check (tests/test_replay.py::TestPER):
    index 3 holds ~92% of the mass; more than 70% of 256 draws land on it."""
    ts = PrioritizedSampler(alpha=1.0, beta=1.0, fanout=FANOUT)
    st = ts.on_write(ts.init(32), torch.arange(10), None)
    prio = torch.full((10,), 0.1)
    prio[3] = 10.0
    st = ts.update_priority(st, torch.arange(10), prio)
    gen = torch.Generator().manual_seed(0)
    idx, info, _ = ts.sample(st, gen, 256, torch.tensor(10), 32)
    assert (idx == 3).float().mean().item() > 0.7
    assert bool(((info["_weight"] > 0) & (info["_weight"] <= 1.0 + 1e-5)).all())
