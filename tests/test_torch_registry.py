"""The program registry and the executable store (``rl_tpu_torch.compile``)
and the programs that go through them: ``OffPolicyProgram.jit_train_step``
(SAC, DQN), ``PrioritizedSampler.jit_sample_and_update``, the engine's
decode chunks (``registry=``, ``warmup=``) and
``OnPolicyProgram.jit_update_from_batch``.

On the CPU a registered program runs eagerly, so each is held bit for bit
to the eager path it wraps, and the bodies a graph captures are run under
a dispatch mode that fails on any read of a tensor's value on the host (a
capture cannot contain one). The ``cuda``-marked cases capture on the
card and hold each replay to the eager run from the same state bit for
bit; they skip here. No JAX: the reference's registry compiles XLA, which
has no counterpart to compare with."""

import gc
import threading
import weakref

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import rl_tpu_torch.data.replay.samplers as samplers_mod
from rl_tpu_torch.collectors import Collector
from rl_tpu_torch.compile import (ExecutableStore, ProgramRegistry, default_store,
                                  get_program_registry, set_default_store,
                                  set_program_registry, signature_of)
from rl_tpu_torch.compile.registry import CachedProgram, _flatten, _memkey, _unflatten
from rl_tpu_torch.data import ArrayDict, DeviceStorage, PrioritizedSampler, ReplayBuffer
from rl_tpu_torch.envs import CartPoleEnv, PendulumEnv, VmapEnv
from rl_tpu_torch.envs.transforms import RewardSum, TransformedEnv
from rl_tpu_torch.models import ContinuousBatchingEngine, TransformerConfig, TransformerLM
from rl_tpu_torch.modules import (MLP, Categorical, ConcatMLP, NormalParamExtractor,
                                  ProbabilisticActor, TanhNormal, TDModule, TDSequential,
                                  ValueOperator)
from rl_tpu_torch.objectives import ClipPPOLoss, SACLoss
from rl_tpu_torch.trainers import (OffPolicyConfig, OffPolicyProgram, OnPolicyConfig,
                                   OnPolicyProgram, make_dqn_trainer)

torch.set_num_threads(1)


@pytest.fixture
def registry():
    return ProgramRegistry(ExecutableStore())


def _sac(device, policy_delay=1):
    actor = ProbabilisticActor(
        TDSequential(TDModule(MLP(out_features=2, num_cells=(32, 32)), ["observation"], ["raw"]),
                     TDModule(NormalParamExtractor(), ["raw"], ["loc", "scale"])),
        TanhNormal, dist_kwargs={"low": -2.0, "high": 2.0})
    loss = SACLoss(actor, ConcatMLP(out_features=1, num_cells=(32, 32)))
    coll = Collector(VmapEnv(PendulumEnv(), 4), lambda td, g: loss.actor(td, g),
                     frames_per_batch=16)
    return OffPolicyProgram(
        coll, loss, ReplayBuffer(DeviceStorage(256), PrioritizedSampler(fanout=4)),
        OffPolicyConfig(batch_size=8, utd_ratio=2, init_random_frames=32,
                        policy_delay=policy_delay),
        priority_key="td_error", device_metrics=True, device=device)


def _dqn(device):
    env = TransformedEnv(VmapEnv(CartPoleEnv(), 4), RewardSum())
    return make_dqn_trainer(env, total_steps=1, frames_per_batch=32, buffer_capacity=512,
                            config=OffPolicyConfig(batch_size=16, init_random_frames=64,
                                                   utd_ratio=2), device=device).program


def _ppo(device, **cfg):
    env = TransformedEnv(VmapEnv(CartPoleEnv(), 8), RewardSum())
    actor = ProbabilisticActor(TDModule(MLP(out_features=2, num_cells=(16, 16)), ["observation"],
                                        ["logits"]), Categorical, dist_keys=("logits",))
    loss = ClipPPOLoss(actor, ValueOperator(MLP(out_features=1, num_cells=(16, 16))),
                       normalize_advantage=True, entropy_coeff=0.01)
    loss.make_value_estimator(gamma=0.99, lmbda=0.95)
    cfg = dict(num_epochs=2, minibatch_size=32, **cfg)
    return OnPolicyProgram(Collector(env, actor, frames_per_batch=64), loss,
                           OnPolicyConfig(**cfg))


def _off_policy_state(prog):
    return prog.prefill(prog.init(seed=0))


def _assert_trees_equal(a, b):
    la, lb = [], []
    assert _flatten(a, la) == _flatten(b, lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            torch.testing.assert_close(x.cpu(), y.cpu(), rtol=0, atol=0, equal_nan=True)
        elif not isinstance(x, torch.Generator):
            assert x == y


def test_flatten_round_trip_and_signatures():
    tree = ({"b": ArrayDict(x=torch.zeros(2), y={"z": torch.ones(3, dtype=torch.int64)}),
             "a": [1, 2.5, None, "s"]}, (torch.zeros(4),))
    leaves = []
    struct = _flatten(tree, leaves)
    back = _unflatten(struct, leaves)
    assert isinstance(back[0]["b"], ArrayDict) and back[0]["a"] == [1, 2.5, None, "s"]
    _assert_trees_equal(back, tree)
    hash(struct)
    sig = signature_of(tree)
    assert sig == signature_of(_unflatten(struct, leaves))
    assert "T(3,):torch.int64:cpu" in sig
    for other in (({"b": ArrayDict(x=torch.zeros(3), y={"z": torch.ones(3)}), "a": [1, 2.5]},),
                  ({"b": {"x": torch.zeros(2)}, "a": [2, 2.5, None, "s"]}, (torch.zeros(4),))):
        assert signature_of(other) != sig


def test_store_keys_weak_index_libraries_and_defaults(tmp_path):
    store = ExecutableStore(tmp_path)

    class Program:  # stands for a CachedProgram
        pass

    class Graph:  # stands for a captured graph
        pass

    p, q, g = Program(), Program(), Graph()
    leaves = []
    sig = _memkey(_flatten((torch.zeros(2), 3), leaves), leaves)
    store.save(p, sig, g)
    assert store.load(p, sig) is g and store.load(q, sig) is None  # filed under its program
    assert store.load(p, ("other",)) is None and store.count(p) == 1 and store.count(q) == 0
    assert store.stats == {"hits": 1, "misses": 2, "saves": 1}
    ref = weakref.ref(g)
    del p, g
    gc.collect()
    assert ref() is None  # the graphs go with their program
    (tmp_path / "libx-0123.so").write_bytes(b"")
    assert store.libraries() == ["libx-0123.so"]
    assert default_store().root.parts[-2:] == ("build", "rl_tpu_torch")
    prev = set_default_store(store)
    try:
        assert default_store() is store
    finally:
        set_default_store(prev)
    reg = ProgramRegistry()
    old = set_program_registry(reg)
    try:
        assert get_program_registry() is reg and reg.store is default_store()
    finally:
        set_program_registry(old)


def test_register_names_weak_references_and_eager_cpu_calls(registry):
    p1 = registry.register("a", lambda x: x + 1)
    p2 = registry.register("a", lambda x: x + 2)
    p3 = registry.register("b", lambda x: x)
    assert registry.names() == ["a", "b"] and registry.program("a") is p2
    assert registry.programs() == [p1, p2, p3]
    del p2, p3
    gc.collect()
    assert registry.names() == ["a"] and registry.program("a") is p1
    with pytest.raises(KeyError):
        registry.program("b")
    seen = []
    prog = registry.register("f", lambda x, n: seen.append(n) or {"y": x * n, "n": n})
    out = prog(torch.arange(3.0), 2)
    assert torch.equal(out["y"], torch.tensor([0.0, 2.0, 4.0])) and out["n"] == 2
    prog(torch.arange(3.0), 3)
    assert seen == [2, 3]
    s = registry.stats()["f"]
    assert s["calls"] == 2 and s["eager_calls"] == 2 and s["compiles"] == 0
    assert s["executables"] == 0


def test_aot_warmup_records_signatures_and_runs_in_the_background(registry):
    prog = registry.register("g", lambda x: x)
    prog.add_signature(torch.zeros(2)).add_signature(torch.ones(2))  # one signature
    prog.add_signature(torch.zeros(3))
    assert len(prog.signatures) == 2
    assert registry.aot_warmup() == {"g": [("eager", 0.0), ("eager", 0.0)]}
    assert registry.aot_warmup(["g"], background=True).result(timeout=10) == {
        "g": [("eager", 0.0), ("eager", 0.0)]}
    gate = threading.Event()
    slow = registry.register("slow", lambda x: x)
    slow.warmup = lambda *a: (gate.wait(10), ("eager", 0.0))[1]
    slow.add_signature(torch.zeros(1))
    handle = registry.aot_warmup(programs=[slow], background=True)
    assert not handle.done()
    with pytest.raises(TimeoutError):
        handle.result(timeout=0.01)
    gate.set()
    assert handle.result(timeout=10) == {"slow": [("eager", 0.0)]}
    bad = registry.register("bad", lambda x: x)
    bad.warmup = lambda *a: (_ for _ in ()).throw(ValueError("boom"))
    bad.add_signature(torch.zeros(1))
    with pytest.raises(ValueError, match="boom"):
        registry.aot_warmup(programs=[bad], background=True).result(timeout=10)


@pytest.mark.parametrize("algo", ["sac_policy_delay_2", "dqn"])
def test_off_policy_step_program_equals_the_eager_steps_on_cpu(registry, algo):
    make = (lambda: _sac("cpu", policy_delay=2)) if algo.startswith("sac") else \
        (lambda: _dqn("cpu"))
    eager, graphed = make(), make()
    ts_e, ts_g = _off_policy_state(eager), _off_policy_state(graphed)
    step = graphed.jit_train_step(registry=registry)
    two = graphed.jit_train_step(steps_per_call=2, registry=registry)
    assert step.aot_warmup(ts_g) == {"off_policy.train_step": [("eager", 0.0)]}
    ms = []
    for _ in range(3):
        ts_e, m = eager.train_step(ts_e)
        ms.append(m)
    ts_g, m1 = step(ts_g)
    ts_g, m23 = two(ts_g)
    _assert_trees_equal(m1, ms[0])
    for k in m23.keys():
        want = torch.nanmean(torch.stack([ms[1][k], ms[2][k]]))
        torch.testing.assert_close(m23[k], want, rtol=0, atol=0, equal_nan=True)
    _assert_trees_equal(ts_g, ts_e)
    assert ts_g["update_count"] == 6 and ts_g["collector"]["step_count"] == ts_e["collector"][
        "step_count"]
    for a, b in zip(eager.loss.parameters(), graphed.loss.parameters()):
        assert torch.equal(a, b)
    assert registry.stats()["off_policy.train_step"]["calls"] == 2
    with pytest.raises(ValueError, match="donate=False"):
        graphed.jit_train_step(donate=False)


def test_per_program_equals_sample_and_update_on_cpu(registry):
    sampler = PrioritizedSampler(fanout=4)
    states = []
    for _ in range(2):
        st = sampler.init(64, "cpu")
        st = sampler.on_write(st, torch.arange(40), None)
        states.append(sampler.update_priority(st, torch.arange(40), torch.linspace(0.1, 4, 40),
                                              indices_sorted=True))
    data = torch.linspace(-1.0, 1.0, 64)
    fn = lambda idx, info: data[idx].abs() + 0.01  # noqa: E731
    prog = sampler.jit_sample_and_update(fn, 16, 64, registry=registry, warmup=True,
                                         device="cpu")
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    size = torch.tensor(40)
    for _ in range(3):
        i1, info1, states[0] = sampler.sample_and_update(states[0], g1, 16, size, 64, fn)
        i2, info2, states[1] = prog(states[1], g2, size)
        _assert_trees_equal((i1, info1, states[0]), (i2, info2, states[1]))
    assert registry.names() == ["per.sample_and_update"]


def test_engine_with_a_registry_matches_the_eager_engine_on_cpu(registry, monkeypatch):
    cfg = TransformerConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
                            max_seq_len=64, dtype=torch.float32)
    model = TransformerLM(cfg, device="cpu", seed=0)
    kw = dict(n_slots=4, block_size=4, n_blocks=48, prompt_buckets=(8, 16), device="cpu",
              decode_chunk=4, temperature=0.8, seed=1)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 64, n).astype(np.int32) for n in (3, 9, 12, 5, 7)]

    def serve(engine):
        rids = [engine.submit(p, b) for p, b in zip(prompts, (9, 6, 12, 4, 10))]
        out = engine.run()
        return [out[r] for r in rids]

    plain = serve(ContinuousBatchingEngine(model, **kw))
    for extra in (dict(registry=registry), dict(registry=registry, warmup=True),
                  dict(warmup="background")):
        eng = ContinuousBatchingEngine(model, **kw, **extra)
        for a, b in zip(plain, serve(eng)):
            np.testing.assert_array_equal(a.tokens, b.tokens)
            np.testing.assert_array_equal(a.log_probs, b.log_probs)
        if eng._warmup_handle is not None:
            report = eng._warmup_handle.result(timeout=30)
            assert report["serving.decode.k4"] == [("eager", 0.0)]
            assert all(r == [("eager", 0.0)] for r in report.values())
    s = registry.stats()["serving.decode.k4"]
    assert s["calls"] > 0 and s["eager_calls"] == s["calls"]
    # a background warm-up captures over the engine's buffers: the first
    # step waits for it, so nothing is admitted while it runs
    gate, admitted = threading.Event(), []

    def slow_warmup(prog, *args):
        gate.wait(10)
        admitted.append(eng.admissions)
        return ("eager", 0.0)

    monkeypatch.setattr(CachedProgram, "warmup", slow_warmup)
    eng = ContinuousBatchingEngine(model, **kw, registry=registry, warmup="background")
    threading.Timer(0.3, gate.set).start()
    for a, b in zip(plain, serve(eng)):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert admitted and set(admitted) == {0}
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        ContinuousBatchingEngine(model, **kw, kv_handoff=True)


def test_ppo_update_program_equals_update_from_batch_on_cpu(registry):
    eager, graphed = _ppo("cpu"), _ppo("cpu")
    ts_e = eager.init(torch.Generator().manual_seed(0))
    ts_g = graphed.init(torch.Generator().manual_seed(0))
    update = graphed.jit_update_from_batch(registry=registry)
    for _ in range(2):
        batch_e, cs_e = eager.collector.collect(ts_e["collector"])
        batch_g, cs_g = graphed.collector.collect(ts_g["collector"])
        ts_e, m_e = eager.update_from_batch({**ts_e, "collector": cs_e}, batch_e)
        ts_g, m_g = update({**ts_g, "collector": cs_g}, batch_g)  # draws the permutations
        _assert_trees_equal(m_g, m_e)
    assert ts_g["update_count"] == ts_e["update_count"] == 8
    for a, b in zip(eager.loss.parameters(), graphed.loss.parameters()):
        assert torch.equal(a, b)


def _grpo(device, warmup=False, continuous_batching=False, **cfg):
    from rl_tpu_torch.envs.llm import arithmetic_dataset
    from rl_tpu_torch.trainers import GRPOTrainer

    width = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64, max_seq_len=24)
    width.update(cfg)
    return GRPOTrainer(arithmetic_dataset(32, max_operand=4),
                       model_config=TransformerConfig(**width, dtype=torch.float32),
                       num_prompts=2, group_repeats=2, max_prompt_len=16, max_new_tokens=8,
                       microbatch_size=2, device=device, warmup=warmup,
                       continuous_batching=continuous_batching)


def _grpo_pair(registry, device, **cfg):
    """An eager GRPO trainer and one whose update (and, with
    ``continuous_batching``, its engine's decode chunks) are registered
    programs (``warmup=True``, through ``registry`` as the process
    registry)."""
    prev = set_program_registry(registry)
    try:
        return _grpo(device, **cfg), _grpo(device, warmup=True, **cfg)
    finally:
        set_program_registry(prev)


def test_grpo_update_program_equals_the_eager_update_on_cpu(registry):
    eager, graphed = _grpo_pair(registry, "cpu")
    assert registry.stats()["grpo.update"]["executables"] == 0  # nothing to capture on a CPU
    batch = eager.collect()
    graphed.collect()  # the same draw of the trainer's seed stream
    sig = signature_of({k: batch[k] for k in sorted(batch)})
    assert sig == signature_of(graphed.example_batch())  # the warm-up's layout
    for _ in range(2):
        out_e, out_g = eager.update(batch), graphed.update(batch)
        assert out_e == out_g
        for a, b in zip(eager.policy.parameters(), graphed.policy.parameters()):
            assert torch.equal(a, b)
    assert graphed.step() == eager.step()
    assert registry.stats()["grpo.update"]["calls"] == 3
    with pytest.raises(RuntimeError, match="warmup"):
        eager.aot_warmup()
    prev = set_program_registry(registry)
    try:
        background = _grpo("cpu", warmup="background")
    finally:
        set_program_registry(prev)
    assert background._warmup_handle.result(timeout=60) == {"grpo.update": [("eager", 0.0)]}
    # the collector's engine decodes through the trainer's registry
    eager, graphed = _grpo_pair(registry, "cpu", continuous_batching=True)
    assert graphed.collector.engine_registry is registry
    assert eager.collector.engine_registry is None
    for _ in range(2):
        assert graphed.step() == eager.step()
    s = registry.stats()["serving.decode.k1"]
    assert s["calls"] > 0 and s["eager_calls"] == s["calls"]


class _NoHostReads(TorchDispatchMode):
    """Fails on what a CUDA graph cannot hold: a read of a tensor's value
    on the host (``item``, ``bool``, ``tolist``), an op whose output shape
    depends on values (``nonzero``, boolean-mask indexing), and a tensor
    made from Python data (an upload from pageable memory on the card)."""

    FORBIDDEN = {"aten::_local_scalar_dense", "aten::nonzero", "aten::masked_select",
                 "aten::_unique2", "aten::unique_consecutive", "aten::unique_dim",
                 "aten::lift_fresh", "aten::bincount"}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        bool_index = name in ("aten::index", "aten::index_put", "aten::index_put_") and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in args[1] or ())
        if name in self.FORBIDDEN or bool_index:
            raise AssertionError(f"{name} in a captured body")
        return func(*args, **(kwargs or {}))


def test_captured_bodies_read_nothing_on_the_host(monkeypatch):
    """The SAC and DQN train steps, the PPO and the GRPO update, on the CPU, with B7's
    plain version (an ordered fold read on the host; the card launches the
    kernel) standing in as two scatter-adds."""

    def scatter_adds(priorities, esum, idx, delta, *, fanout):
        priorities.index_add_(0, idx, delta)
        esum.index_add_(0, idx // fanout, delta)
        return priorities, esum

    monkeypatch.setattr(samplers_mod, "sumtree_update", scatter_adds)
    for make in (_sac, _dqn):
        prog = make("cpu")
        ts = _off_policy_state(prog)
        step = prog.jit_train_step(registry=ProgramRegistry(ExecutableStore()))
        with _NoHostReads():
            step.program.fn(step._inner(ts))
    ppo = _ppo("cpu")
    ts = ppo.init(torch.Generator().manual_seed(0))
    batch, _ = ppo.collector.collect(ts["collector"])
    perms = [torch.randperm(64) for _ in range(2)]
    upd = ppo.jit_update_from_batch(registry=ProgramRegistry(ExecutableStore()))
    upd._opt = ts["optimizer"]
    with _NoHostReads():
        upd.program.fn({"optimizer": ts["optimizer"], "generator": ts["generator"],
                        "update_count": 0}, batch, perms)
    grpo = _grpo("cpu")
    batch = grpo.collect()
    with _NoHostReads():
        grpo._update_body({k: batch[k] for k in sorted(batch)}, grpo._dm)
    with pytest.raises(AssertionError, match="_local_scalar_dense"), _NoHostReads():
        torch.ones(2).sum().item()


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("program", ["sac", "dqn", "per", "engine", "ppo", "grpo",
                                     "failed_capture"])
def test_replays_equal_eager_on_the_card(registry, program):
    """Two programs built alike on the card: one steps eagerly, one through
    its graph; every state and output equal bit for bit after each of
    three calls (so each replay draws new numbers, as the eager steps do).
    Last, a body that reads a value on the host: its capture raises."""
    dev = _card()
    if program == "failed_capture":
        prog = registry.register("reads", lambda x: x * float(x.sum().item()))
        with pytest.raises(RuntimeError, match="CUDA graph capture failed"):
            prog(torch.ones(4, device=dev))
    elif program == "grpo":  # D = 64 and flash attention: B1 and B2 in the graph
        # the engine's decode chunks (B4, B5) in graphs too
        eager, graphed = _grpo_pair(registry, dev, d_model=128, n_heads=2,
                                    attention_impl="flash", continuous_batching=True)
        for _ in range(3):
            assert graphed.step() == eager.step()
            for a, b in zip(eager.policy.parameters(), graphed.policy.parameters()):
                assert torch.equal(a, b)
        assert registry.stats()["grpo.update"]["compiles"] == 1
        assert registry.stats()["serving.decode.k1"]["aot_hits"] > 0
    elif program in ("sac", "dqn"):
        make = (lambda: _sac(dev)) if program == "sac" else (lambda: _dqn(dev))
        eager, graphed = make(), make()
        ts_e, ts_g = _off_policy_state(eager), _off_policy_state(graphed)
        step = graphed.jit_train_step(registry=registry)
        for _ in range(3):
            ts_e, m_e = eager.train_step(ts_e)
            ts_g, m_g = step(ts_g)
            _assert_trees_equal((ts_g, m_g), (ts_e, m_e))
        assert registry.stats()["off_policy.train_step"]["compiles"] == 1
    elif program == "per":
        sampler = PrioritizedSampler()
        st = [sampler.init(4096, dev) for _ in range(2)]
        st = [sampler.update_priority(s, torch.arange(4096, device=dev),
                                      torch.linspace(0.1, 3.0, 4096, device=dev),
                                      indices_sorted=True) for s in st]
        fn = lambda idx, info: (idx % 7).to(torch.float32) + 0.5  # noqa: E731
        # captured on init's layout and a generator of its own: each call
        # swaps its state and generator in and out of the graph's
        prog = sampler.jit_sample_and_update(fn, 256, 4096, registry=registry, warmup=True,
                                             device=dev)
        gens = [torch.Generator(device=dev).manual_seed(0) for _ in range(2)]
        size = torch.tensor(4096, device=dev)
        drawn = []
        for _ in range(3):
            a = sampler.sample_and_update(st[0], gens[0], 256, size, 4096, fn)
            st[0] = a[2]
            b = prog(st[1], gens[1], size)
            st[1] = b[2]
            _assert_trees_equal(b, a)
            drawn.append(b[0].cpu())
        assert not torch.equal(drawn[0], drawn[1])  # each replay draws anew
    elif program == "engine":
        cfg = TransformerConfig(vocab_size=64, d_model=128, n_layers=2, n_heads=2, d_ff=64,
                                max_seq_len=64, dtype=torch.float32)  # D = 64: a kernel's
        model = TransformerLM(cfg, device=dev, seed=0)
        kw = dict(n_slots=4, block_size=8, n_blocks=48, prompt_buckets=(8, 16), device=dev,
                  decode_chunk=4, temperature=0.8, seed=1)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, 64, n).astype(np.int32) for n in (3, 9, 12, 5, 7)]
        # sampled: 4 requests of one budget in 4 slots, so that no admission
        # can fall between two chunks (when a chunk is drained depends on
        # the device's timing, and with it the order of the prefill's and
        # the chunks' draws); greedy: any schedule gives the same tokens
        for greedy, budgets in ((False, (9, 9, 9, 9)), (True, (9, 6, 12, 4, 10))):
            outs = []
            # the last engine's requests are admitted while its warm-up
            # captures in the background: its first step waits for it
            for extra in ({}, dict(registry=registry, warmup=True),
                          dict(registry=registry, warmup="background")):
                eng = ContinuousBatchingEngine(model, **kw, **extra, greedy=greedy)
                rids = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
                done = eng.run()
                outs.append([done[r] for r in rids])
            for graphed in outs[1:]:
                for a, b in zip(outs[0], graphed):
                    np.testing.assert_array_equal(a.tokens, b.tokens)
                    np.testing.assert_array_equal(a.log_probs, b.log_probs)
        s = registry.stats()["serving.decode.k4"]
        assert s["compiles"] == s["executables"] >= 1 and s["aot_hits"] > 0
    else:
        eager, graphed = _ppo(dev), _ppo(dev)
        ts_e = eager.init(torch.Generator(device=dev).manual_seed(0))
        ts_g = graphed.init(torch.Generator(device=dev).manual_seed(0))
        update = graphed.jit_update_from_batch(registry=registry)
        for _ in range(3):
            batch_e, cs_e = eager.collector.collect(ts_e["collector"])
            batch_g, cs_g = graphed.collector.collect(ts_g["collector"])
            ts_e, m_e = eager.update_from_batch({**ts_e, "collector": cs_e}, batch_e)
            ts_g, m_g = update({**ts_g, "collector": cs_g}, batch_g)
            _assert_trees_equal(m_g, m_e)
            for a, b in zip(eager.loss.parameters(), graphed.loss.parameters()):
                assert torch.equal(a, b)
