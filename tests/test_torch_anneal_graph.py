"""Three small ports of this slice, on the CPU against ``rl_tpu`` (and
optax):

- **the learning-rate anneal under a graph** (``OnPolicyConfig(
  anneal_lr_to=...)``): each update's rate is computed on the device, in
  float32, from Adam's count, and equals optax's ``linear_schedule`` bit
  for bit; Adam applies a tensor rate as optax does (within optax
  parity's 1e-6); ``jit_update_from_batch`` and ``jit_train_step`` equal
  the eager anneal bit for bit over 3 steps while the rate moves; the
  anneal's bodies read nothing on the host; a checkpoint resumes the
  schedule where it was;
- **C9**: ``PrioritizedSliceSampler.update_priority`` with overlapping
  slices keeps each index's last write, as the reference's
  ``.at[idx].set``, through the host-read guard; on the card it equals
  the CPU and a graph replay equals eager;
- **``remat_policy="dots_no_batch"``**: per-block gradients equal the
  plain model's (local and flash attention); ``test_torch_transformer.py``
  holds which products the policy keeps.

Their ``cuda`` case, which needs no JAX, is in
``tests/test_torch_resilience_programs.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_registry import _assert_trees_equal, _NoHostReads, _ppo
from test_torch_resilience import no_process_state  # noqa: F401

from rl_tpu.data.replay import PrioritizedSliceSampler as JaxPrioritizedSlice
from rl_tpu_torch.checkpoint import ArrayTreeAdapter, restore_into
from rl_tpu_torch.compile import ExecutableStore, ProgramRegistry
from rl_tpu_torch.data import PrioritizedSliceSampler
from rl_tpu_torch.models import TransformerConfig, TransformerLM, token_log_probs
from rl_tpu_torch.trainers import Adam
from rl_tpu_torch.trainers.on_policy import linear_schedule

torch.set_num_threads(1)
ANNEAL = dict(learning_rate=1e-2, anneal_lr_to=1e-3, total_steps=10)  # 4 updates a step


@pytest.fixture
def registry():
    return ProgramRegistry(ExecutableStore())


def _recording(optimizer, seen):
    """Record the rate each Adam step applies (a 0-dim tensor with the
    anneal)."""
    step = optimizer.step

    def record(grads, ok, frozen=()):
        seen.append(optimizer.lr.detach().clone())
        return step(grads, ok, frozen)

    optimizer.step = record


def test_device_rate_is_optax_s_float32_schedule_bit_for_bit():
    ref = optax.linear_schedule(1e-2, 1e-3, 10)
    ours = linear_schedule(1e-2, 1e-3, 10)
    for c in range(14):
        got = ours(torch.tensor(float(c)))
        assert got.dtype == torch.float32
        assert got.numpy().tobytes() == np.asarray(ref(c), np.float32).tobytes(), c
    assert ours(3) == pytest.approx(float(ref(3)), rel=1e-6)  # the host form stays


def test_adam_with_a_tensor_rate_matches_optax_adam_on_a_schedule():
    rng = np.random.default_rng(1)
    ps = [rng.standard_normal(s).astype(np.float32) for s in [(5, 3), (7,)]]
    sched = optax.linear_schedule(1e-2, 1e-3, 4)
    opt = optax.adam(sched)
    jp = [jnp.asarray(p) for p in ps]
    state = opt.init(jp)
    tp = [torch.tensor(p) for p in ps]
    adam = Adam(tp, 1e-2)
    ours = linear_schedule(1e-2, 1e-3, 4)
    for _ in range(6):
        gs = [rng.standard_normal(p.shape).astype(np.float32) for p in ps]
        upd, state = opt.update([jnp.asarray(g) for g in gs], state)
        jp = optax.apply_updates(jp, upd)
        adam.lr = ours(adam.count)
        adam.step([torch.tensor(g) for g in gs], torch.tensor(True))
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-8)


def test_anneal_update_program_equals_eager_while_the_rate_moves(registry):
    """``jit_update_from_batch`` with the anneal against the eager
    ``update_from_batch``: 3 steps (counts 0-11, the rate moving and then
    held at its end), metrics, parameters, Adam and the applied rates bit
    for bit, the rates optax's."""
    eager, graphed = _ppo("cpu", **ANNEAL), _ppo("cpu", **ANNEAL)
    ts_e = eager.init(torch.Generator().manual_seed(0))
    ts_g = graphed.init(torch.Generator().manual_seed(0))
    seen_e, seen_g = [], []
    _recording(ts_e["optimizer"], seen_e)
    _recording(ts_g["optimizer"], seen_g)
    update = graphed.jit_update_from_batch(registry=registry)
    for _ in range(3):
        batch_e, cs_e = eager.collector.collect(ts_e["collector"])
        batch_g, cs_g = graphed.collector.collect(ts_g["collector"])
        ts_e, m_e = eager.update_from_batch({**ts_e, "collector": cs_e}, batch_e)
        ts_g, m_g = update({**ts_g, "collector": cs_g}, batch_g)
        _assert_trees_equal(m_g, m_e)
    for a, b in zip(eager.loss.parameters(), graphed.loss.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(ts_e["optimizer"].mu + [ts_e["optimizer"].count],
                    ts_g["optimizer"].mu + [ts_g["optimizer"].count]):
        assert torch.equal(a, b)
    ref = optax.linear_schedule(1e-2, 1e-3, 10)
    assert len(seen_e) == len(seen_g) == 12
    for c, (a, b) in enumerate(zip(seen_e, seen_g)):
        assert a.numpy().tobytes() == b.numpy().tobytes() == \
            np.asarray(ref(c), np.float32).tobytes()
    assert len({float(r) for r in seen_e}) == 11  # moving, then held from count 10
    assert registry.stats()["on_policy.update"]["calls"] == 3


def test_anneal_train_step_program_equals_eager(registry):
    eager, graphed = _ppo("cpu", **ANNEAL), _ppo("cpu", **ANNEAL)
    ts_e = eager.init(torch.Generator().manual_seed(1))
    ts_g = graphed.init(torch.Generator().manual_seed(1))
    step = graphed.jit_train_step(registry=registry)
    for _ in range(3):
        ts_e, m_e = eager.train_step(ts_e)
        ts_g, m_g = step(ts_g)
        _assert_trees_equal(m_g, m_e)
        _assert_trees_equal(ts_g["collector"], ts_e["collector"])
    assert ts_g["update_count"] == ts_e["update_count"] == 12
    assert ts_g["optimizer"].count.item() == 12.0
    for a, b in zip(eager.loss.parameters(), graphed.loss.parameters()):
        assert torch.equal(a, b)


def test_anneal_update_reads_nothing_on_the_host():
    prog = _ppo("cpu", **ANNEAL)
    ts = prog.init(torch.Generator().manual_seed(2))
    batch, cs = prog.collector.collect(ts["collector"])
    perms = [torch.randperm(64) for _ in range(2)]
    with _NoHostReads():
        prog.update_from_batch({**ts, "collector": cs}, batch, permutations=perms)
    assert ts["optimizer"].count.item() == 4.0


def test_a_checkpoint_resumes_the_anneal_where_it_was(tmp_path):
    """Adam's count, which the rate is computed from, is in the
    checkpoint: a program restored after step 1 applies the same rates
    and reaches the same parameters as the uninterrupted one."""
    run, other = _ppo("cpu", **ANNEAL), _ppo("cpu", **ANNEAL)
    ts = run.init(torch.Generator().manual_seed(3))
    ts, _ = run.train_step(ts)
    ArrayTreeAdapter().save(str(tmp_path / "a"), {"ts": ts, "loss": run.loss.state_dict()})
    ts, _ = run.train_step(ts)
    ts2 = other.init(torch.Generator().manual_seed(4))
    live = {"ts": ts2, "loss": other.loss.state_dict(keep_vars=True)}
    ts2 = restore_into(live, ArrayTreeAdapter().load(str(tmp_path / "a"), template=live))["ts"]
    seen = []
    _recording(ts2["optimizer"], seen)
    ts2, _ = other.train_step(ts2)
    assert [float(r) for r in seen] == [float(linear_schedule(1e-2, 1e-3, 10)(
        torch.tensor(float(c)))) for c in range(4, 8)]
    for a, b in zip(run.loss.parameters(), other.loss.parameters()):
        assert torch.equal(a, b)


def _slice_pair(capacity=16, slice_len=4):
    port, ref = PrioritizedSliceSampler(slice_len), JaxPrioritizedSlice(slice_len)
    return port, port.init(capacity), ref, ref.init(capacity)


def test_overlapping_slices_keep_the_last_write_as_the_reference():
    """Slices from 3, 5 and 3 (length 4) write positions 3-8 with repeats:
    each keeps its last write (9, 10, 11, 12, 7, 8 at 3-8), the largest
    priority counts every write, as the reference's ``.at[idx].set``; a
    false ``ok`` leaves the state; the write reads nothing on the host."""
    port, ps, ref, rs = _slice_pair()
    idx = np.concatenate([np.arange(s, s + 4) for s in (3, 5, 3)]).astype(np.int64)
    prio = np.arange(1, 13, dtype=np.float32)
    rs = ref.update_priority(rs, jnp.asarray(idx), jnp.asarray(prio))
    tidx, tprio = torch.from_numpy(idx), torch.from_numpy(prio)
    with _NoHostReads():
        ps = port.update_priority(ps, tidx, tprio)
    np.testing.assert_array_equal(ps["priorities"].numpy(), np.asarray(rs["priorities"]))
    np.testing.assert_array_equal(ps["priorities"].numpy()[3:9],
                                  np.float32([9, 10, 11, 12, 7, 8]) + np.float32(1e-8))
    assert ps["max_priority"].item() == float(rs["max_priority"])
    before = ps["priorities"].clone()
    ps = port.update_priority(ps, torch.from_numpy(idx), torch.full((12,), 50.0),
                              ok=torch.tensor(False))
    assert torch.equal(ps["priorities"], before)


def test_random_overlapping_batches_match_the_reference():
    rng = np.random.default_rng(0)
    port, ps, ref, rs = _slice_pair(capacity=64, slice_len=8)
    for _ in range(5):
        starts = rng.integers(0, 57, 4)
        idx = (starts[:, None] + np.arange(8)).reshape(-1).astype(np.int64)
        prio = rng.normal(size=32).astype(np.float32)
        rs = ref.update_priority(rs, jnp.asarray(idx), jnp.asarray(prio))
        ps = port.update_priority(ps, torch.from_numpy(idx), torch.from_numpy(prio))
        np.testing.assert_array_equal(ps["priorities"].numpy(), np.asarray(rs["priorities"]))
        assert ps["max_priority"].item() == float(rs["max_priority"])


@pytest.mark.parametrize("impl", ["local", "flash"])
def test_remat_dots_no_batch_gradients_equal_plain(impl):
    """The reference's ``checkpoint_dots_with_no_batch_dims``: every
    gradient of a block under the selective checkpoint equals the plain
    model's (the tolerance of the ``none``/``dots`` test)."""
    small = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64, max_seq_len=24)
    base = TransformerConfig(**small, dtype=torch.float32, attention_impl=impl)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 64, (3, 20)))
    mask = torch.ones(3, 20)
    mask[0, :4] = 0.0
    grads = []
    for cfg in (base, dataclasses.replace(base, remat=True, remat_policy="dots_no_batch")):
        m = TransformerLM(cfg, device="cpu", seed=1, param_dtype=torch.float32)
        (token_log_probs(m, toks, mask) * mask).sum().backward()
        grads.append([p.grad.clone() for p in m.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
