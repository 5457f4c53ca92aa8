"""The graphs of this slice's programs, without JAX: the chaos K-update
(``offpolicy.k_updates_chaos``) and the GRPO update with the chaos poison
read nothing on the host, on the CPU under ``test_torch_registry.py``'s
dispatch mode; and two ``cuda`` cases, which skip here (``python -m
pytest --noconftest tests/test_torch_resilience_programs.py -m cuda`` on
a card): the anneal's ``jit_train_step`` and C9's write-back as graphs
against eager, and a poisoned update inside the GRPO update's graph and
the chaos K-update's graph against eager. Kept apart from the files that
import JAX, since the card's machine has none."""

import numpy as np
import pytest
import torch
from test_torch_async_programs import _async_sac
from test_torch_registry import _assert_trees_equal, _NoHostReads, _ppo

from rl_tpu_torch.compile import ExecutableStore, ProgramRegistry
from rl_tpu_torch.data import PrioritizedSliceSampler
from rl_tpu_torch.data.replay import samplers as samplers_mod
from rl_tpu_torch.envs.llm import arithmetic_dataset
from rl_tpu_torch.models import TransformerConfig
from rl_tpu_torch.obs import MetricsRegistry, TraceRecorder
from rl_tpu_torch.resilience import Fault, FaultInjector, injection
from rl_tpu_torch.trainers import GRPOTrainer
from rl_tpu_torch.trainers.on_policy import linear_schedule

torch.set_num_threads(1)
SMALL = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64, max_seq_len=24)
ANNEAL = dict(learning_rate=1e-2, anneal_lr_to=1e-3, total_steps=10)


def _grpo(device, warmup=False):
    cfg = TransformerConfig(**SMALL, dtype=torch.float32)
    return GRPOTrainer(arithmetic_dataset(32, max_operand=4), model_config=cfg, num_prompts=2,
                       group_repeats=2, max_prompt_len=12, max_new_tokens=8,
                       learning_rate=1e-2, warmup=warmup, device=device)


def test_chaos_bodies_read_nothing_on_the_host(monkeypatch):
    """The chaos K-update's body (poison NaN, then 0) and the GRPO update's
    body with a poison, under the host-read guard."""
    def scatter_adds(priorities, esum, idx, delta, *, fanout):  # B7's plain version reads
        priorities.index_add_(0, idx, delta)
        esum.index_add_(0, idx // fanout, delta)
        return priorities, esum

    monkeypatch.setattr(samplers_mod, "sumtree_update", scatter_adds)
    tr, ts = _async_sac("cpu")
    try:
        for value in (float("nan"), 0.0):
            poison = torch.tensor(value)
            with _NoHostReads():
                tr.k_chaos_program.fn(tr._inner(ts), poison)
    finally:
        tr.collector.pool.close()
    grpo = _grpo("cpu")
    batch = {k: v for k, v in sorted(grpo.collect().items())}
    poison = torch.tensor(float("nan"))
    with _NoHostReads():
        grpo._update_body(batch, grpo._dm, poison)
    assert grpo.opt.count.item() == 0.0


@pytest.mark.cuda
def test_anneal_and_c9_graphs_on_the_card():
    """The anneal's ``jit_train_step`` replays 3 steps equal to an eager copy
    bit for bit while the rate moves; the overlapping-slice write on the
    card equals the CPU's, and as a graph equals eager."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    registry = ProgramRegistry(ExecutableStore())
    eager, graphed = _ppo(dev, **ANNEAL), _ppo(dev, **ANNEAL)
    ts_e = eager.init(torch.Generator(device=dev).manual_seed(1))
    ts_g = graphed.init(torch.Generator(device=dev).manual_seed(1))
    step = graphed.jit_train_step(registry=registry)
    rates = []
    for _ in range(3):
        ts_e, m_e = eager.train_step(ts_e)
        ts_g, m_g = step(ts_g)
        _assert_trees_equal(m_g, m_e)
        rates.append(float(linear_schedule(1e-2, 1e-3, 10)(ts_g["optimizer"].count)))
    for a, b in zip(eager.loss.parameters(), graphed.loss.parameters()):
        assert torch.equal(a, b)
    assert registry.stats()["on_policy.update"]["compiles"] == 1 and len(set(rates)) > 1

    sampler = PrioritizedSliceSampler(8)
    rng = np.random.default_rng(0)
    idx = torch.from_numpy((rng.integers(0, 57, 16)[:, None] + np.arange(8)).reshape(-1))
    prio = torch.from_numpy(rng.normal(size=128).astype(np.float32))
    cpu = sampler.update_priority(sampler.init(64), idx, prio)
    states = [sampler.init(64, dev) for _ in range(2)]
    prog = registry.register("test.c9", lambda st, i, p: sampler.update_priority(st, i, p))
    eager_st = sampler.update_priority(states[0], idx.to(dev), prio.to(dev))
    for _ in range(2):  # the capture, then a replay
        graph_st = prog(states[1], idx.to(dev), prio.to(dev))
    for k in ("priorities", "max_priority"):
        assert torch.equal(eager_st[k].cpu(), cpu[k]) and torch.equal(graph_st[k].cpu(), cpu[k])


@pytest.mark.cuda
def test_poisoned_updates_are_no_ops_in_their_graphs_on_the_card():
    """The GRPO update's program with the injector installed (its own
    graph, the poison a new scalar each call) skips the poisoned step and
    only it, as eager does; the chaos K-update's graph equals its
    eager body over poisons NaN, 0, NaN, and a NaN dispatch counts one bad
    step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    trs = [_grpo(dev, warmup=w) for w in (False, True)]
    batch = trs[0].collect()
    for tr in trs:  # visits 1-3 of the site: 0, NaN, 0 (the graph captured at the first)
        inj = FaultInjector({"grpo.update": Fault("nan", at=(2,))}, registry=MetricsRegistry(),
                            tracer=TraceRecorder())
        with injection(inj):
            for _ in range(3):
                tr._update({k: v.clone() for k, v in batch.items()})
    for a, b in zip(trs[0].policy.parameters(), trs[1].policy.parameters()):
        assert torch.equal(a, b)
    _assert_trees_equal(trs[0]._dm, trs[1]._dm)
    assert trs[0].opt.count.item() == trs[1].opt.count.item() == 2.0

    registry = ProgramRegistry(ExecutableStore())
    (eager, ts_e), (graphed, ts_g) = _async_sac(dev), _async_sac(dev, registry=registry)
    try:
        for value in (float("nan"), 0.0, float("nan")):
            poison = torch.full((), value, device=dev)
            inner, m_e = eager.updates(eager._inner(ts_e), poison=poison)
            ts_e = {**ts_e, **inner, "update_count": ts_e["update_count"] + 2}
            ts_g, m_g = graphed.k_updates(ts_g, poison=poison)
            _assert_trees_equal((m_g, ts_g), (m_e, ts_e))
            for a, b in zip(eager._hidden_state(), graphed._hidden_state()):
                assert torch.equal(a, b)
        assert graphed.publish_device_metrics(ts_g)["bad_steps"] == 2
        assert registry.stats()["offpolicy.k_updates_chaos"]["compiles"] == 1
    finally:
        for tr in (eager, graphed):
            tr.collector.pool.close()
