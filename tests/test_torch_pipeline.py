"""The pipelined GRPO loop of the port against ``rl_tpu``, on the CPU.

- The serving ring: a snapshot stays unchanged for ``len(ring) - 1``
  pushes and the next one overwrites it (rings of 1, 2 and 3 copies).
- The ticket gate without a race: the consumer pushes only after the
  producer has taken every snapshot its tickets allow, so the producer is
  always ahead; the consumed staleness is then exactly ``min(k,
  max_pending)`` at step k, and the consumed versions equal those of the
  reference's ``RolloutPipeline`` driven the same way.
- A producer error reaches ``get``, and its ticket comes back; ``stop``
  with a full queue joins the thread.
- The first pipelined update equals the sequential first update from the
  same seed, bit for bit, on both rollout paths; pipelined steps keep
  every copy equal to the master at the version it holds.
- ``SharedProgramScheme`` and ``DoubleBufferScheme`` count versions and
  round-trip as the reference's do; the engine's model swap keeps its
  pools and serves what a fresh engine on the new model serves.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from rl_tpu.trainers.grpo import RolloutPipeline as JaxRolloutPipeline
from rl_tpu.weight_update import DoubleBufferScheme as JaxDoubleBuffer
from rl_tpu.weight_update import SharedProgramScheme as JaxShared
from rl_tpu_torch.envs.llm import arithmetic_dataset
from rl_tpu_torch.models import ContinuousBatchingEngine, TransformerConfig, TransformerLM
from rl_tpu_torch.trainers import GRPOTrainer, PipelinedGRPOTrainer, RolloutPipeline
from rl_tpu_torch.weight_update import (DevicePutScheme, DoubleBufferScheme, ShardedSyncScheme,
                                        SharedProgramScheme)

torch.set_num_threads(1)
SMALL = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64, max_seq_len=24)
P, N = 12, 8  # prompt and response tokens


def lm(seed, dtype=torch.float32, param_dtype=None):
    cfg = TransformerConfig(**SMALL, dtype=dtype)
    return TransformerLM(cfg, device="cpu", seed=seed, param_dtype=param_dtype)


def trainer(cls=GRPOTrainer, **kw):
    cfg = TransformerConfig(**SMALL, dtype=torch.float32)
    return cls(arithmetic_dataset(32, max_operand=4), model_config=cfg, num_prompts=2,
               group_repeats=2, max_prompt_len=P, max_new_tokens=N, learning_rate=1e-2,
               device="cpu", **kw)


def params_of(model):
    return [p.detach().clone() for p in model.parameters()]


@torch.no_grad()
def nudge(model, seed):
    gen = torch.Generator().manual_seed(seed)
    for p in model.parameters():
        p.add_(torch.randn(p.shape, generator=gen) * 0.1)


@pytest.mark.parametrize("ring", [1, 2, 3])
def test_a_snapshot_outlives_ring_minus_one_pushes(ring):
    """A push writes the next copy of the ring: a held snapshot keeps its
    tensors through ``ring - 1`` pushes (a pipeline's ``max_pending``) and
    the next push overwrites it, after which its version is refused."""
    master = lm(1, torch.bfloat16, torch.float32)
    scheme = DevicePutScheme([lm(2, torch.bfloat16) for _ in range(ring)])
    scheme.push(master)
    snap, version = scheme.pull_versioned()
    assert version == 1 and scheme.published(1) is None
    held = params_of(snap)
    for (n, p), q in zip(master.named_parameters(), held):
        assert torch.equal(p.to(q.dtype), q), n
    for i in range(ring - 1):
        nudge(master, i)
        scheme.push(master)
        assert all(torch.equal(a, b) for a, b in zip(snap.parameters(), held))
        scheme.wait_published(1)  # still held
    nudge(master, 99)
    scheme.push(master)
    assert scheme.pull() is snap and scheme.version == ring + 1
    for p, q in zip(master.parameters(), snap.parameters()):
        assert torch.equal(p.to(q.dtype), q)
    with pytest.raises(RuntimeError, match="no longer held"):
        scheme.published(1)
    assert scheme.slot_versions == [ring + 1] + list(range(2, ring + 1))


class SnapshotCount:
    """The producer's snapshots so far; the consumer waits for a count."""

    def __init__(self):
        self.cond = threading.Condition()
        self.n = 0

    def taken(self):
        with self.cond:
            self.n += 1
            self.cond.notify_all()

    def wait_for(self, n):
        with self.cond:
            assert self.cond.wait_for(lambda: self.n >= n, timeout=30), (self.n, n)


def gated_run(make, push, version, max_pending, steps=6):
    """Drive a pipeline whose producer is always ahead: after popping batch
    k the consumer waits for snapshot ``k + 1 + max_pending`` (all its
    tickets allow) before it pushes. Returns the consumed ``(version,
    staleness)`` pairs and each batch's content."""
    count = SnapshotCount()

    def collect(model, _):
        count.taken()
        return {"model": model}

    pipe = make(collect)
    seen = []
    try:
        for k in range(steps):
            batch, v = pipe.get(timeout=30)
            seen.append((v, version() - v, batch["model"]))
            count.wait_for(k + 1 + max_pending)
            push()
    finally:
        pipe.stop()
    assert not pipe.running
    return seen


@pytest.mark.parametrize("max_pending", [1, 2])
def test_ticket_gate_bounds_staleness_exactly(max_pending):
    """The port's pipeline over a ring of ``max_pending + 1`` copies: the
    staleness sequence is 0, 1, .., max_pending, max_pending, ..., and
    each batch saw the copy holding the version it was stamped with."""
    master = torch.nn.Linear(2, 2)
    scheme = DevicePutScheme([torch.nn.Linear(2, 2) for _ in range(max_pending + 1)])
    pushed = {}

    def push():
        with torch.no_grad():
            master.weight.fill_(float(scheme.version + 1))
        scheme.push(master)
        pushed[scheme.version] = scheme.pull()

    push()
    seen = gated_run(lambda fn: RolloutPipeline(scheme, fn, np.random.default_rng(0),
                                                max_pending=max_pending).start(),
                     push, lambda: scheme.version, max_pending)
    assert [s for _, s, _ in seen] == [min(k, max_pending) for k in range(6)]
    for v, _, model in seen:
        assert model is pushed[v]


@pytest.mark.parametrize("max_pending", [1, 2])
def test_ticket_gate_consumes_the_versions_the_reference_consumes(max_pending):
    ref = JaxShared()
    ref.push(0)
    ref_seen = gated_run(
        lambda fn: JaxRolloutPipeline(ref, fn, jax.random.key(0),
                                      max_pending=max_pending).start(),
        lambda: ref.push(ref.version), lambda: ref.version, max_pending)
    scheme = DevicePutScheme([torch.nn.Linear(2, 2) for _ in range(max_pending + 1)])
    master = torch.nn.Linear(2, 2)
    scheme.push(master)
    seen = gated_run(lambda fn: RolloutPipeline(scheme, fn, np.random.default_rng(0),
                                                max_pending=max_pending).start(),
                     lambda: scheme.push(master), lambda: scheme.version, max_pending)
    assert [(v, s) for v, s, _ in seen] == [(v, s) for v, s, _ in ref_seen]


def test_producer_error_reaches_get_and_returns_its_ticket():
    scheme = SharedProgramScheme()
    scheme.push(torch.nn.Linear(2, 2))
    calls = []

    def collect(model, seed):
        calls.append(seed)
        if len(calls) == 2:
            raise ValueError("collect failed")
        return {"reward": torch.zeros(2)}

    pipe = RolloutPipeline(scheme, collect, np.random.default_rng(0)).start()
    pipe.get(timeout=30)
    with pytest.raises(RuntimeError, match="producer failed") as info:
        pipe.get(timeout=30)
    assert isinstance(info.value.__cause__, ValueError)
    pipe._thread.join(timeout=30)
    assert not pipe.running
    assert pipe._tickets.acquire(blocking=False)  # the crashed collect's ticket came back
    pipe.stop()
    # the seeds are the sequential collect's draws, in order
    assert calls == [int(s) for s in np.random.default_rng(0).integers(2**31, size=2)]


@pytest.mark.parametrize("max_pending", [1, 2])
def test_stop_with_a_full_queue_joins_the_producer(max_pending):
    scheme = SharedProgramScheme()
    scheme.push(torch.nn.Linear(2, 2))
    count = SnapshotCount()

    def collect(model, seed):
        count.taken()
        return {"reward": torch.zeros(2)}

    pipe = RolloutPipeline(scheme, collect, np.random.default_rng(0),
                           max_pending=max_pending).start()
    count.wait_for(max_pending)
    while pipe._q.qsize() < max_pending:
        threading.Event().wait(0.01)
    pipe.stop()
    assert not pipe.running and pipe._q.empty() and count.n == max_pending


def test_unported_options_raise_naming_their_item():
    scheme = SharedProgramScheme()
    with pytest.raises(NotImplementedError, match="A5"):
        RolloutPipeline(scheme, lambda m, s: {}, np.random.default_rng(0), supervisor=object())
    with pytest.raises(NotImplementedError, match="A5"):
        trainer(PipelinedGRPOTrainer, supervisor=object())
    with pytest.raises(NotImplementedError, match="A7"):
        ShardedSyncScheme(None)
    with trainer(PipelinedGRPOTrainer, continuous_batching=False) as tr:
        with pytest.raises(NotImplementedError, match="A5"):
            tr._drain_for_checkpoint()


@pytest.mark.parametrize("continuous_batching", [False, True])
def test_first_pipelined_update_equals_the_sequential_one(continuous_batching):
    seq = trainer(continuous_batching=continuous_batching)
    seq.step()
    with trainer(PipelinedGRPOTrainer, continuous_batching=continuous_batching) as pipe:
        pipe.step()
        for (n, a), b in zip(seq.policy.named_parameters(), pipe.policy.parameters()):
            assert torch.equal(a, b), n
        for a, b in zip(seq.opt.mu + seq.opt.nu, pipe.opt.mu + pipe.opt.nu):
            assert torch.equal(a, b)
    assert pipe.staleness_history == [0]


def test_pipelined_steps_keep_every_copy_at_its_version():
    with trainer(PipelinedGRPOTrainer, max_pending=2) as tr:
        masters = {1: params_of(tr.policy)}
        outs = []
        for k in range(4):
            outs.append(tr.step())
            masters[k + 2] = params_of(tr.policy)
    assert all(np.isfinite(o["loss"]) and np.isfinite(o["reward"]) for o in outs)
    assert tr.staleness_history[0] == 0 and max(tr.staleness_history) <= 2
    assert [o["staleness"] for o in outs] == [float(s) for s in tr.staleness_history]
    assert tr.policy_version.version == 4 and tr.scheme.version == 5
    assert tr.metrics_snapshot()["bad_steps"] == 0
    assert sorted(tr.scheme.slot_versions) == [3, 4, 5]
    for model, v in zip(tr.scheme.targets, tr.scheme.slot_versions):
        for p, q in zip(model.parameters(), masters[v]):
            assert torch.equal(p, q.to(p.dtype))
    assert 0.0 <= tr.evaluate(4) <= 1.0


def test_shared_and_double_buffer_schemes_match_the_reference(tmp_path):
    ref, port = JaxShared(), SharedProgramScheme()
    with pytest.raises(RuntimeError):
        port.pull()
    a, b = lm(1), lm(2)
    for x, m in ((1, a), (2, b)):
        ref.push({"x": x})
        port.push(m)
        assert port.version == ref.version == x
        assert port.pull() is m and port.pull_versioned() == (m, x)
    assert ref.pull_versioned() == ({"x": 2}, 2)

    jdb = JaxDoubleBuffer(str(tmp_path / "ref"))
    db = DoubleBufferScheme(str(tmp_path / "port"), target=lm(3, torch.bfloat16))
    for m, seed in ((a, 1), (b, 2)):
        arrays = {n: p.detach().numpy().copy() for n, p in m.named_parameters()}
        jdb.push(arrays)
        db.push(m)
        assert db.version == jdb.version == seed
        assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(
            p.name for p in (tmp_path / "ref").iterdir())
        got = dict(db.pull().named_parameters())
        ref_arrays = jdb.pull(jax.tree_util.tree_structure(arrays))
        for n, p in m.named_parameters():
            assert torch.equal(got[n], p.to(torch.bfloat16)), n
            np.testing.assert_array_equal(np.asarray(ref_arrays[n]), p.detach().numpy())
    fresh = lm(4)
    assert DoubleBufferScheme(str(tmp_path / "port")).pull(fresh) is fresh
    assert all(torch.equal(p, q) for p, q in zip(fresh.parameters(), b.parameters()))


def test_engine_model_swap_keeps_the_pools():
    """``set_model`` keeps pools, allocator and generator; the swapped
    engine's greedy tokens equal a fresh engine's on the new model."""
    first, second = lm(1), lm(2)
    kw = dict(n_slots=2, block_size=4, n_blocks=13, prompt_buckets=(16,), greedy=True,
              device="cpu")
    prompts = [np.arange(3, 3 + n) % 60 + 3 for n in (5, 9, 12)]

    def serve(eng):
        rids = [eng.submit(p, N) for p in prompts]
        out = eng.run()
        return [out[r].tokens for r in rids]

    eng = ContinuousBatchingEngine(first, **kw)
    serve(eng)
    pools = [t for layer in eng.pools for t in layer]
    eng.set_model(second)
    swapped = serve(eng)
    assert all(a is b for a, b in zip((t for layer in eng.pools for t in layer), pools))
    for a, b in zip(swapped, serve(ContinuousBatchingEngine(second, **kw))):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="config"):
        eng.set_model(TransformerLM(TransformerConfig(**{**SMALL, "d_ff": 32},
                                                      dtype=torch.float32), device="cpu"))
    eng.submit(prompts[0], N)
    with pytest.raises(RuntimeError, match="queued"):
        eng.set_model(first)
