"""The programs that take the rest of the hot loops into CUDA graphs: the
engine's admission (``serving.prefill``/``pprefill``/``cowcopy``/
``admit_update``), ``GRPOTrainer.evaluate``'s ``grpo.eval_gen``, the
collector's ``collector.collect``, ``OnPolicyProgram.jit_train_step``,
the PER cycle with beta annealing, the TD3 family's
``OffPolicyProgram.jit_train_step`` (DDPG, TD3, REDQ, CrossQ) and, on
the card, the speculative engine's (``serving.verify``, ``sdecode``,
``spprefill``, ``sadmit_update``).

On the CPU a registered program runs its body eagerly, so each is held
bit for bit to the eager path it replaces, and every new body a graph
captures runs under the dispatch mode of ``test_torch_registry.py`` that
fails on a read of a tensor's value on the host. The ``cuda`` cases
capture on the card and hold each replay to the eager run bit for bit;
they skip here. No JAX: the JAX comparisons of these paths are in
``test_torch_admission.py``, ``test_torch_frame_budget.py`` and
``test_torch_replay_options.py``."""

import numpy as np
import pytest
import torch
from test_torch_registry import _assert_trees_equal, _dqn, _grpo, _NoHostReads, _ppo

from rl_tpu_torch.compile import ExecutableStore, ProgramRegistry, set_program_registry
from rl_tpu_torch.data import PrioritizedSampler
from rl_tpu_torch.envs import PendulumEnv, VmapEnv
from rl_tpu_torch.models import ContinuousBatchingEngine, TransformerConfig, TransformerLM
from rl_tpu_torch.models.serving import _admit_update
from rl_tpu_torch.trainers import (OffPolicyConfig, make_crossq_trainer, make_ddpg_trainer,
                                   make_redq_trainer, make_td3_trainer)

torch.set_num_threads(1)

CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64, max_seq_len=64)
ENGINE = dict(n_slots=4, block_size=4, n_blocks=48, prompt_buckets=(8, 16), decode_chunk=4,
              temperature=0.8, seed=1)


@pytest.fixture
def registry():
    return ProgramRegistry(ExecutableStore())


def _model(device, kv_int8=False, dtype=torch.float32, **cfg):
    return TransformerLM(TransformerConfig(**dict(CFG, **cfg), dtype=dtype, kv_int8=kv_int8),
                         device=device, seed=0)


def _prompts(n=6, lo=3, hi=14, vocab=64, seed=0, system=0):
    rng = np.random.default_rng(seed)
    sysp = rng.integers(1, vocab, system)
    return [np.concatenate([sysp, rng.integers(1, vocab, int(k))]).astype(np.int32)
            for k in np.linspace(lo, hi, n).astype(int)]


def _serve(engine, prompts, budgets, sync=False):
    """Every request's finished record in submission order; ``sync``
    waits for the card after each step, so that each step settles the
    previous chunk first whatever the device's timing (a fixed schedule,
    and with it a fixed order of the generator's draws)."""
    rids = [engine.submit(p, b) for p, b in zip(prompts, budgets)]
    while engine.step():
        if sync:
            torch.cuda.synchronize()
    out = {f.rid: f for f in engine.finished}
    engine.finished.clear()
    return [out[r] for r in rids]


def _engine_bodies(kv_int8, prefix):
    """A CPU engine mid-admission: two slots' tables written, and the
    arguments of its prefill (or partial prefill) program."""
    eng = ContinuousBatchingEngine(_model("cpu", kv_int8), device="cpu", prefix_cache=prefix,
                                   **ENGINE)
    eng.dev_table[0, :3] = torch.tensor([1, 2, 3], dtype=torch.int32)
    eng.dev_table[1, :2] = torch.tensor([4, 5], dtype=torch.int32)
    tokens = torch.randint(1, 64, (2, 8), dtype=torch.int32)
    mask = torch.ones((2, 8), dtype=torch.bool)
    mask[1, 5:] = False
    args = [eng.model, eng.dev_table, torch.tensor([0, 1]), tokens, mask]
    if prefix:
        args.append(torch.tensor([4, 0], dtype=torch.int32))
    return eng, args


TD3_FAMILY = {"td3": make_td3_trainer, "ddpg": make_ddpg_trainer, "redq": make_redq_trainer,
              "crossq": make_crossq_trainer}


def _td3_family(algo, device, utd_ratio=1):
    """The factory's program over 4 Pendulum envs, 16 frames a batch,
    batch 16 (its 256x256 nets); TD3 with ``policy_delay=2``."""
    cfg = OffPolicyConfig(batch_size=16, init_random_frames=32, utd_ratio=utd_ratio,
                          policy_delay=2 if algo == "td3" else 1)
    return TD3_FAMILY[algo](VmapEnv(PendulumEnv(), 4), total_steps=1, frames_per_batch=16,
                            buffer_capacity=256, config=cfg, device=device).program


@pytest.mark.parametrize("body", ["prefill", "pprefill", "cowcopy", "admit_update", "eval_gen",
                                  "collect", "td3_family"])
def test_new_captured_bodies_read_nothing_on_the_host(body):
    """Each body a graph of this slice captures, on the CPU with the
    kernels' plain versions, over float and int8 pools where it touches
    them."""
    if body in ("prefill", "pprefill"):
        for kv_int8 in (False, True):
            eng, args = _engine_bodies(kv_int8, body == "pprefill")
            with _NoHostReads():
                eng._prefill_body(*args)
    elif body == "cowcopy":
        eng, _ = _engine_bodies(True, True)
        src, dst = torch.tensor([1, 2, 2]), torch.tensor([6, 7, 7])
        with _NoHostReads():
            eng._cow_body(src, dst)
    elif body == "admit_update":
        S = 4
        vec = [torch.arange(S, dtype=torch.int32), torch.tensor([True, False] * 2),
               torch.ones(S, dtype=torch.int32), torch.zeros(S, dtype=torch.int32),
               torch.tensor([False, True] * 2)] + [torch.full((S,), 7, dtype=torch.int32)] * 3
        with _NoHostReads():
            out = _admit_update(*vec)
        assert out[0].tolist() == [0, 7, 2, 7] and out[1].tolist() == [True] * 4
    elif body == "eval_gen":  # the first chunk (the prefill too) and a later one
        trainer = _grpo("cpu")
        trainer.eval_chunk = 3
        tokens = torch.randint(1, 64, (2, 16))
        mask = torch.ones((2, 16))
        mask[0, :5] = 0.0
        with _NoHostReads(), torch.no_grad():
            state = trainer._eval_chunk(trainer.gen_model, {"tokens": tokens, "mask": mask}, 0,
                                        3)
            trainer._eval_chunk(trainer.gen_model, state, 3, 3)
    elif body == "collect":
        for make in (lambda: _ppo("cpu"), lambda: _dqn("cpu")):  # MultiStep, the e-greedy state
            program = make()
            ts = program.init(torch.Generator().manual_seed(0))
            with _NoHostReads():
                program.collector.collect(ts["collector"])
    else:  # the whole step: the noisy collect, REDQ's subset, CrossQ's statistics
        for algo in sorted(TD3_FAMILY):
            program = _td3_family(algo, "cpu", utd_ratio=2)
            ts = program.prefill(program.init(seed=0))
            step = program.jit_train_step(registry=ProgramRegistry(ExecutableStore()))
            with _NoHostReads():
                step.program.fn(step._inner(ts))


def test_collect_program_equals_collect_and_keeps_the_frame_count(registry):
    programs = [_dqn("cpu") for _ in range(2)]  # the e-greedy state, MultiStep
    states = [p.init(torch.Generator().manual_seed(4))["collector"] for p in programs]
    collectors = [p.collector for p in programs]
    collect = collectors[1].jit_collect(registry=registry)
    batches = []
    for i in range(3):
        batch_e, states[0] = collectors[0].collect(states[0])
        batch_g, states[1] = collect(states[1])
        _assert_trees_equal((batch_g, states[1]), (batch_e, states[0]))
        batches.append(batch_g)
    assert states[1]["step_count"] == 3 * collectors[1].frames_per_batch
    assert registry.stats()["collector.collect"]["calls"] == 3
    assert batches[0]["observation"].data_ptr() != batches[1]["observation"].data_ptr()
    c = collectors[1]
    c.total_frames = 2 * c.frames_per_batch + 1
    jit = list(c.iterate(torch.Generator().manual_seed(4), registry=registry))
    eager = list(c.iterate(torch.Generator().manual_seed(4), jit=False))
    assert len(jit) == len(eager) == 3
    _assert_trees_equal(jit, eager)


def test_ppo_train_step_program_equals_train_step_on_cpu(registry):
    eager, graphed = _ppo("cpu"), _ppo("cpu")
    ts_e = eager.init(torch.Generator().manual_seed(0))
    ts_g = graphed.init(torch.Generator().manual_seed(0))
    step = graphed.jit_train_step(registry=registry)
    for _ in range(3):
        ts_e, m_e = eager.train_step(ts_e)
        ts_g, m_g = step(ts_g)
        _assert_trees_equal(m_g, m_e)
        _assert_trees_equal(ts_g["collector"], ts_e["collector"])
    assert ts_g["update_count"] == ts_e["update_count"] == 12
    assert ts_g["collector"]["step_count"] == ts_e["collector"]["step_count"] == 3 * 64
    assert torch.equal(ts_g["generator"].get_state(), ts_e["generator"].get_state())
    for a, b in zip(eager.loss.parameters(), graphed.loss.parameters()):
        assert torch.equal(a, b)
    stats = registry.stats()
    assert stats["collector.collect"]["calls"] == stats["on_policy.update"]["calls"] == 3


def test_evaluate_through_its_program_equals_eager_across_an_update(registry):
    prev = set_program_registry(registry)
    try:
        eager, graphed = _grpo("cpu"), _grpo("cpu", warmup=True)
    finally:
        set_program_registry(prev)
    graphed.eval_chunk = 3  # 8 new tokens: chunks from steps 0, 3 and 6
    state = eager.env.reset(eager.dataset.prompts[:4])
    tokens = torch.from_numpy(state["tokens"])
    mask = torch.from_numpy(np.asarray(state["attention_mask"], np.float32))
    for _ in range(2):
        assert graphed.evaluate(num_prompts=4) == eager.evaluate(num_prompts=4)
        _assert_trees_equal(graphed._eval_generate(graphed.gen_model, tokens, mask),
                            eager._eval_generate(eager.gen_model, tokens, mask))
        assert eager.step() == graphed.step()  # the serving weights move in place
    assert registry.stats()["grpo.eval_gen"]["calls"] == 4 * 3


def test_annealed_per_program_equals_eager_and_beta_moves(registry):
    sampler = PrioritizedSampler(fanout=4, beta_annealing_steps=3)
    states = []
    for _ in range(2):
        st = sampler.on_write(sampler.init(64, "cpu"), torch.arange(40), None)
        states.append(sampler.update_priority(st, torch.arange(40), torch.linspace(0.1, 4, 40),
                                              indices_sorted=True))
    fn = lambda idx, info: idx.to(torch.float32) % 5 + 0.5  # noqa: E731
    prog = sampler.jit_sample_and_update(fn, 16, 64, registry=registry, warmup=True,
                                         device="cpu")
    plain = PrioritizedSampler(fanout=4).jit_sample_and_update(fn, 16, 64, registry=registry)
    assert prog.fingerprint != plain.fingerprint
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    size = torch.tensor(40)
    for k in range(5):
        # beta at sampler step k, 0.4 -> 1 over 3 steps, as a fixed beta
        fixed = PrioritizedSampler(fanout=4, beta=0.4 + 0.6 * min(k / 3, 1.0))
        g_fixed = torch.Generator()
        g_fixed.set_state(g1.get_state())
        _, info_fixed, _ = fixed.sample(states[0], g_fixed, 16, size, 64)
        a = sampler.sample_and_update(states[0], g1, 16, size, 64, fn)
        b = prog(states[1], g2, size)
        _assert_trees_equal(b, a)
        torch.testing.assert_close(b[1]["_weight"], info_fixed["_weight"], rtol=1e-6, atol=0)
        states = [a[2], b[2]]
    assert int(states[1]["step"]) == 5


def test_engine_warmed_with_its_ladder_in_the_background_equals_eager(registry):
    model = _model("cpu")
    prompts = _prompts(lo=1, hi=6, system=9)
    budgets = (9, 6, 12, 4, 10, 7)
    plain = _serve(ContinuousBatchingEngine(model, device="cpu", prefix_cache=True, **ENGINE),
                   prompts, budgets)
    eng = ContinuousBatchingEngine(model, device="cpu", prefix_cache=True, registry=registry,
                                   warmup="background", **ENGINE)
    for a, b in zip(plain, _serve(eng, prompts, budgets)):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.log_probs, b.log_probs)
    report = eng._warmup_handle.result(timeout=30)
    assert "serving.cowcopy.n4" in report and "serving.pprefill.a4.s16" in report


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


class _ReplayDraft:
    """Drafts the rest of whichever recorded completion the context is a
    prefix of: long accepted chains under sampling."""

    def __init__(self, finished):
        self.seqs = [f.prompt.tolist() + f.tokens.tolist() for f in finished]

    def propose(self, context, k):
        c = list(map(int, context))
        return next((s[len(c): len(c) + k] for s in self.seqs
                     if len(s) > len(c) and s[: len(c)] == c), [])

    def stats(self):
        return {}


@pytest.mark.cuda
@pytest.mark.parametrize("program", ["admission_bf16", "admission_int8", "admission_prefix",
                                     "eval_gen", "ppo_train_step", "per_annealed",
                                     "speculative", "td3_train_step", "crossq_train_step"])
def test_new_programs_replay_equal_to_eager_on_the_card(registry, program):
    """Two copies built alike on the card: one eager, one through its
    graphs; every output and state equal bit for bit, and no capture after
    the warm-up (admission, the speculative engine) or after the first
    call."""
    dev = _card()
    if program == "speculative":  # sampled verify, sdecode and spprefill graphs
        model = _model(dev, d_model=128, n_heads=2, dtype=torch.bfloat16)
        prompts = _prompts(n=6, system=20)
        budgets = (16,) * 6
        kw = dict(ENGINE, device=dev, prefix_cache=True, n_blocks=64, block_size=8,
                  prompt_buckets=(16, 64), slot_rng=True)
        vanilla = _serve(ContinuousBatchingEngine(model, **kw), prompts, budgets)
        kw.update(speculative=True, spec_lookahead=7)
        eager = _serve(ContinuousBatchingEngine(model, draft_source=_ReplayDraft(vanilla), **kw),
                       prompts, budgets)
        eng = ContinuousBatchingEngine(model, draft_source=_ReplayDraft(vanilla), **kw,
                                       registry=registry, warmup=True)
        captured = {n: s["compiles"] for n, s in registry.stats().items()}
        for a, b in zip(eager, _serve(eng, prompts, budgets)):
            np.testing.assert_array_equal(a.tokens, b.tokens)
            np.testing.assert_array_equal(a.log_probs, b.log_probs)
        stats = registry.stats()
        assert {n: s["compiles"] for n, s in stats.items()} == captured
        assert sum(s["replays"] for n, s in stats.items() if n.startswith("serving.verify")) > 0
        assert eng.spec_accepted_tokens > eng.spec_dispatches
    elif program.startswith("admission"):
        kv_int8, prefix = program == "admission_int8", program == "admission_prefix"
        # D = 64: the kernels' width; bf16 serving weights
        model = _model(dev, kv_int8, d_model=128, n_heads=2, dtype=torch.bfloat16)
        prompts = _prompts(n=10, system=20 if prefix else 0)
        budgets = (9, 6, 12, 4, 10, 7, 5, 11, 8, 3)
        kw = dict(ENGINE, device=dev, prefix_cache=prefix, n_blocks=48, block_size=8,
                  prompt_buckets=(16, 64))  # block 8: the paged kernels' smallest
        eager = _serve(ContinuousBatchingEngine(model, **kw), prompts, budgets, sync=True)
        eng = ContinuousBatchingEngine(model, **kw, registry=registry, warmup=True)
        captured = {n: s["compiles"] for n, s in registry.stats().items()}
        for a, b in zip(eager, _serve(eng, prompts, budgets, sync=True)):
            np.testing.assert_array_equal(a.tokens, b.tokens)
            np.testing.assert_array_equal(a.log_probs, b.log_probs)
        stats = registry.stats()
        assert {n: s["compiles"] for n, s in stats.items()} == captured
        assert all(s["compiles"] == s["executables"] == 1 for s in stats.values())
        kind = "serving.pprefill" if prefix else "serving.prefill"
        assert sum(s["replays"] for n, s in stats.items() if n.startswith(kind)) > 0
    elif program == "eval_gen":  # B3 inside the graph: flash_decode at D = 64
        prev = set_program_registry(registry)
        try:
            eager, graphed = (_grpo(dev, warmup=w, d_model=128, n_heads=2, flash_decode=True)
                              for w in (False, True))
        finally:
            set_program_registry(prev)
        graphed.eval_chunk = 3  # three graphs, from steps 0, 3 and 6
        state = eager.env.reset(eager.dataset.prompts[:4])
        tokens = torch.from_numpy(state["tokens"]).to(dev)
        mask = torch.from_numpy(np.asarray(state["attention_mask"], np.float32)).to(dev)
        for _ in range(3):
            _assert_trees_equal(graphed._eval_generate(graphed.gen_model, tokens, mask),
                                eager._eval_generate(eager.gen_model, tokens, mask))
            assert graphed.step() == eager.step()
        s = registry.stats()["grpo.eval_gen"]
        assert s["compiles"] == s["executables"] == 3 and s["replays"] == 9
    elif program in ("td3_train_step", "crossq_train_step"):
        # TD3: one update a step and policy_delay 2, so the steps alternate
        # between the graph that moves the policy and the one that holds
        # it; CrossQ: two updates a step and the critics' running statistics
        algo = program.split("_")[0]
        utd = 1 if algo == "td3" else 2
        eager, graphed = _td3_family(algo, dev, utd), _td3_family(algo, dev, utd)
        ts_e, ts_g = (p.prefill(p.init(seed=0)) for p in (eager, graphed))
        step = graphed.jit_train_step(registry=registry)
        stats0 = [b.clone() for b in eager.loss.buffers()]
        for i in range(4):
            actor0 = [p.clone() for p in eager.loss.actor.parameters()]
            ts_e, m_e = eager.train_step(ts_e)
            ts_g, m_g = step(ts_g)
            _assert_trees_equal((m_g, ts_g), (m_e, ts_e))
            for a, b in zip(eager.loss.state_dict().values(), graphed.loss.state_dict().values()):
                assert torch.equal(a, b)
            for a, b in zip(eager.optimizer.mu + eager.optimizer.nu,
                            graphed.optimizer.mu + graphed.optimizer.nu):
                assert torch.equal(a, b)
            moved = any(not torch.equal(a, b)
                        for a, b in zip(actor0, eager.loss.actor.parameters()))
            assert moved == (algo == "crossq" or i % 2 == 0)
        s = registry.stats()["off_policy.train_step"]
        assert s["compiles"] == s["executables"] == (2 if algo == "td3" else 1)
        if algo == "crossq":
            assert len(stats0) == 6
            assert all(not torch.equal(a, b) for a, b in zip(stats0, graphed.loss.buffers()))
    elif program == "ppo_train_step":
        eager, graphed = _ppo(dev), _ppo(dev)
        ts_e = eager.init(torch.Generator(device=dev).manual_seed(0))
        ts_g = graphed.init(torch.Generator(device=dev).manual_seed(0))
        step = graphed.jit_train_step(registry=registry)
        for _ in range(3):
            ts_e, m_e = eager.train_step(ts_e)
            ts_g, m_g = step(ts_g)
            _assert_trees_equal((m_g, ts_g["collector"]), (m_e, ts_e["collector"]))
            for a, b in zip(eager.loss.parameters(), graphed.loss.parameters()):
                assert torch.equal(a, b)
        stats = registry.stats()
        assert stats["collector.collect"]["compiles"] == stats["on_policy.update"]["compiles"] == 1
    else:
        sampler = PrioritizedSampler(beta_annealing_steps=2)
        st = [sampler.update_priority(sampler.init(4096, dev), torch.arange(4096, device=dev),
                                      torch.linspace(0.1, 3.0, 4096, device=dev),
                                      indices_sorted=True) for _ in range(2)]
        fn = lambda idx, info: (idx % 7).to(torch.float32) + 0.5  # noqa: E731
        prog = sampler.jit_sample_and_update(fn, 256, 4096, registry=registry, warmup=True,
                                             device=dev)
        gens = [torch.Generator(device=dev).manual_seed(0) for _ in range(2)]
        size = torch.tensor(4096, device=dev)
        for _ in range(3):  # beta 0.4, 0.7, 1.0: moved by the replays' own step counter
            a = sampler.sample_and_update(st[0], gens[0], 256, size, 4096, fn)
            b = prog(st[1], gens[1], size)
            _assert_trees_equal(b, a)
            st = [a[2], b[2]]
