"""End-to-end GRPO recipe: tokenizer -> chat env -> rollouts -> GRPO
update (counterpart of the sequential :class:`rl_tpu.trainers.grpo.GRPOTrainer`).

One step collects a batch (the dense-cache ``generate`` or the
continuous-batching engine, over the serving copy of the policy), scores
it against a frozen reference model, and updates the float32 master
weights:

- **Microbatched gradient accumulation.** The batch splits into
  ``microbatch_size`` rows; microbatch i's loss is scaled by
  ``w_i / sum(w)`` with ``w_i = GRPOLoss.microbatch_weight`` (its
  assistant-token count) before its backward, so the accumulated gradient
  equals the full-batch gradient while activation memory follows the
  microbatch.
- **Adam with optax's semantics** (b1 0.9, b2 0.999, eps 1e-8 added after
  the square root, bias correction by the step count), in
  ``torch._foreach_*`` ops.
- **Finite guard without a host sync.** A non-finite loss or gradient
  norm turns the step into a no-op on the device: new parameters, moments
  and step count are selected with ``torch.where(ok, new, old)`` and a
  ``bad_steps`` counter is bumped; nothing is read back to decide.
- **Publication.** :class:`~rl_tpu_torch.weight_update.DevicePutScheme`
  copies the master weights into the serving model (bf16 on the card) on
  the stream, and the policy version is bumped.
- **Lagged-one metric drain.** Step metrics accumulate in
  :class:`~rl_tpu_torch.obs.DeviceMetrics`; each step starts the copy of
  its own metrics and reads the previous step's, so the host never waits
  for the update it just launched (the first step reads its own).

:class:`PipelinedGRPOTrainer` overlaps the next collect with the update
through :class:`RolloutPipeline` (a producer thread on its own CUDA
stream) and a ring of serving copies.

With ``warmup`` the update runs as a registered program
(``grpo.update``): on the card one CUDA graph of the whole microbatched
update (forward and backward through B1 and B2, the accumulated gradients,
the finite guard, Adam and the step metrics), captured before the first
step. :meth:`GRPOTrainer.evaluate`'s greedy decode then runs as
``grpo.eval_gen`` too: the dense-cache ``generate`` in fixed chunks of
``eval_chunk`` steps (the first with the prefill), one graph a chunk,
keyed by its first step (B3's host ``cache_len`` is fixed per step
index), for each prompt shape and serving model; captured at the first
``evaluate`` and replayed by the later ones over the weights as they are
then.

Not ported (``NotImplementedError``): ``mesh`` (FSDP, ring attention),
the chaos injector and guard (``train(guard=...)``), preemption and
emergency checkpoints, and the pipeline's supervisor.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from .. import resolve_device
from .._stubs import not_ported_call
from ..collectors.llm import LLMCollector
from ..compile import GraphPool, get_program_registry
from ..data.llm.tokenizer import SimpleTokenizer
from ..envs.llm.chat import DatasetChatEnv
from ..envs.llm.datasets import QADataset
from ..envs.llm.reward import ExactMatchScorer, SumScorer, combine_scorers
from ..envs.llm.transforms import KLRewardTransform, PolicyVersion
from ..models import TransformerConfig, TransformerLM, token_log_probs
from ..models.generate import generate_prefill, generate_steps
from ..objectives.llm.grpo import GRPOLoss
from ..obs.device import DeviceMetrics
from ..weight_update.schemes import DevicePutScheme

__all__ = ["Adam", "GRPOTrainer", "PipelinedGRPOTrainer", "RolloutPipeline"]


class Adam:
    """``optax.adam`` on a list of parameters, in ``torch._foreach_*``
    ops. :meth:`step` applies one update where ``ok`` (a 0-dim bool
    tensor) holds and leaves parameters, moments and count untouched
    elsewhere, without reading ``ok`` on the host."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = torch.zeros((), dtype=torch.float32, device=self.params[0].device)

    @torch.no_grad()
    def step(self, grads, ok: torch.Tensor, frozen=()) -> None:
        """One update where ``ok`` holds. The parameters at the positions
        in ``frozen`` keep their values while their moments still update
        (TD3-style delayed policy updates)."""
        count = self.count + 1.0
        mu = torch._foreach_mul(self.mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        nu = torch._foreach_mul(self.nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(grads, grads), alpha=1.0 - self.b2)
        mu_hat = torch._foreach_div(mu, 1.0 - self.b1**count)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, 1.0 - self.b2**count))
        torch._foreach_add_(denom, self.eps)
        new = list(torch._foreach_add(self.params, torch._foreach_div(mu_hat, denom),
                                      alpha=-self.lr))
        for i in frozen:
            new[i] = self.params[i]
        # torch.where selects, so a NaN in the rejected branch cannot leak
        for p, m, v, pn, mn, vn in zip(self.params, self.mu, self.nu, new, mu, nu):
            p.copy_(torch.where(ok, pn, p))
            m.copy_(torch.where(ok, mn, m))
            v.copy_(torch.where(ok, vn, v))
        self.count.copy_(torch.where(ok, count, self.count))  # in place: a graph replays it


class GRPOTrainer:
    """Self-assembling GRPO trainer over a :class:`QADataset`.

    Args (the reference's, plus ``device``):
        dataset: (question, answer) pairs; the tokenizer trains on its corpus.
        model_config: default a small float32 LM sized to the tokenizer.
        kl_coeff: KL(pi || pi_ref) reward-shaping coefficient (pi_ref = init).
        scorer: reward override; default exact match + dense arithmetic
            credit against ``dataset.answers``.
        microbatch_size: gradient-accumulation rows (must divide
            ``num_prompts * group_repeats``); ``None`` = the whole batch.
        remat / remat_policy: per-block rematerialization of the training
            forward (``"none"`` or ``"dots"``).
        continuous_batching: roll out through the serving engine.
        warmup: ``True`` runs the update through the process program
            registry and captures it (:meth:`aot_warmup`) before
            construction returns; ``"background"`` captures on a thread
            (handle at ``self._warmup_handle``), which the first update
            waits for. Either way the collector's engine decodes through
            the same registry (``engine_registry``), capturing each
            decode chunk at its first call. ``False``: eager.
        device: the card by default (no card: raises); ``"cpu"`` runs the
            kernels' plain versions.

    ``eval_chunk`` is the number of decode steps in one of ``evaluate``'s
    graphs (64: eight graphs for 512 new tokens).
    """

    eval_chunk = 64

    def __init__(self, dataset: QADataset, model_config: TransformerConfig | None = None,
                 tokenizer: Any = None, scorer: Callable | None = None, mesh: Any = None,
                 num_prompts: int = 4, group_repeats: int = 8, max_prompt_len: int = 16,
                 max_new_tokens: int = 16, learning_rate: float = 1e-3,
                 kl_coeff: float = 0.02, clip_epsilon: float = 0.2,
                 temperature: float = 1.0, seed: int = 0, logger: Any = None,
                 continuous_batching: bool = False, microbatch_size: int | None = None,
                 remat: bool = False, remat_policy: str = "none",
                 fsdp_min_size_mb: float = 4.0, warmup: bool | str = False, device=None):
        if mesh is not None:
            raise NotImplementedError("GRPOTrainer: mesh (FSDP, ring attention) is not ported yet")
        dev = resolve_device(device)
        self.device = dev
        self.tokenizer = tokenizer or SimpleTokenizer(dataset.corpus())
        self.dataset = dataset
        self.logger = logger
        total_len = max_prompt_len + max_new_tokens
        if model_config is None:
            model_config = TransformerConfig(
                vocab_size=max(self.tokenizer.vocab_size, 64), d_model=128, n_layers=4,
                n_heads=8, d_ff=256, max_seq_len=total_len, dtype=torch.float32,
            )
        B = num_prompts * group_repeats
        self.microbatch_size = microbatch_size
        if microbatch_size is not None and B % microbatch_size:
            raise ValueError(
                f"microbatch_size ({microbatch_size}) must divide the batch "
                f"(num_prompts * group_repeats = {B})"
            )
        train_cfg = model_config
        if remat:
            train_cfg = dataclasses.replace(train_cfg, remat=True, remat_policy=remat_policy)
        # float32 master weights (cast at use) for the update; a serving
        # copy in cfg.dtype for rollouts; a frozen reference for the KL.
        # All three start from the same seeded draw.
        self.policy = TransformerLM(train_cfg, device=dev, seed=seed,
                                    param_dtype=torch.float32)
        self.gen_model = TransformerLM(model_config, device=dev, seed=seed).requires_grad_(False)
        serving = [self.gen_model] + [
            TransformerLM(model_config, device=dev, seed=seed).requires_grad_(False)
            for _ in range(self._serving_copies() - 1)]
        self.ref_model = TransformerLM(model_config, device=dev, seed=seed).requires_grad_(False)

        scorer = scorer or combine_scorers(
            ExactMatchScorer(dataset.answers), SumScorer(dataset.answers), weights=[1.0, 0.5]
        )
        self.env = DatasetChatEnv(dataset.prompts, self.tokenizer, reward_fn=scorer,
                                  group_repeats=group_repeats, max_prompt_len=max_prompt_len,
                                  seed=seed)
        self.scheme = DevicePutScheme(serving)
        self.scheme.push(self.policy)
        self.policy_version = PolicyVersion()
        kl = KLRewardTransform(coeff=kl_coeff)

        def reward_transform(rewards, batch):
            return self.policy_version(kl(rewards, batch), batch)

        self.collector = LLMCollector(
            self.env, self.gen_model, num_prompts=num_prompts,
            max_new_tokens=max_new_tokens, temperature=temperature,
            eos_id=self.tokenizer.eos_token_id, ref_model=self.ref_model,
            weight_scheme=self.scheme, reward_transform=reward_transform,
            continuous_batching=continuous_batching,
            engine_registry=get_program_registry() if warmup else None,
        )
        self.loss = GRPOLoss(
            lambda model, b: token_log_probs(model, b["tokens"], b["attention_mask"]),
            clip_epsilon=clip_epsilon,
            kl_coeff=0.0,  # the KL lives in the shaped reward, not the loss
        )
        self.opt = Adam(self.policy.parameters(), learning_rate)
        self._seeds = np.random.default_rng(seed + 1)
        self._dm_spec = DeviceMetrics(counters=("updates", "tokens", "bad_steps"),
                                      gauges=("loss", "reward", "kl_approx"))
        self._dm = self._dm_spec.init(dev)
        self._pending_dm: dict | None = None
        self.max_new_tokens = max_new_tokens
        self.history: dict[str, list[float]] = {"reward": [], "loss": []}
        self._batch_shape = (B, total_len)
        self._update_prog = self._eval_prog = None
        self._warmup_handle = self._warming = None
        if warmup:
            registry = get_program_registry()
            self._update_prog = registry.register(
                "grpo.update", self._update_body,
                fingerprint=repr((B, total_len, microbatch_size)), state=self._update_state)
            # the chunks replay one after another: one memory pool for their graphs
            self._eval_prog = registry.register(
                "grpo.eval_gen", self._eval_chunk,
                fingerprint=repr((max_new_tokens, self.tokenizer.eos_token_id)),
                pool=GraphPool())
            if warmup == "background":
                self._warmup_handle = self._warming = self.aot_warmup(background=True)
            else:
                self.aot_warmup()

    def _serving_copies(self) -> int:
        """Serving copies in the weight scheme's ring: one, since collect
        and update never overlap here."""
        return 1

    def aot_warmup(self, *, background: bool = False):
        """Capture the update for the collected batch's layout (zeros of
        its shapes and dtypes; the parameters, Adam and the metrics are
        left as they were). Returns the registry's report, or a
        :class:`~rl_tpu_torch.compile.WarmupHandle` with ``background``."""
        if self._update_prog is None:
            raise RuntimeError("GRPOTrainer.aot_warmup: construct with warmup=True or "
                               "'background'")
        self._update_prog.add_signature(self.example_batch(), self._dm)
        return self._update_prog._registry.aot_warmup(programs=[self._update_prog],
                                                      background=background)

    def example_batch(self) -> dict:
        """Zeros laid out as :meth:`collect`'s batch (keys sorted, as the
        update takes them)."""
        (G, T), dev = self._batch_shape, self.device
        f32, i64 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.int64, device=dev)
        batch = {"tokens": torch.zeros((G, T), **i64),
                 "attention_mask": torch.zeros((G, T), **f32),
                 "assistant_mask": torch.zeros((G, T), dtype=torch.bool, device=dev),
                 "sample_log_prob": torch.zeros((G, T), **f32),
                 "group_id": torch.zeros((G,), **i64), "ref_log_prob": torch.zeros((G, T), **f32),
                 "policy_version": torch.zeros((G,), dtype=torch.int32, device=dev),
                 "advantage": torch.zeros((G,), **f32), "reward": torch.zeros((G,), **f32)}
        return {k: batch[k] for k in sorted(batch)}

    def _update_state(self) -> list:
        """What the update changes in place: the master weights and Adam."""
        return [*self.policy.parameters(), *self.opt.mu, *self.opt.nu, self.opt.count]

    # -- the microbatched update -------------------------------------------

    def _accumulate(self, batch: dict):
        """``(grads, loss, kl_approx)`` of the whole batch, accumulated over
        microbatches: microbatch i's loss is scaled by ``w_i / sum(w)``
        before its backward. Loss and KL are 0-dim device tensors."""
        B = batch["tokens"].shape[0]
        mbs = self.microbatch_size or B
        mbs_list = [{k: v[i : i + mbs] for k, v in batch.items()} for i in range(0, B, mbs)]
        ws = [self.loss.microbatch_weight(mb) for mb in mbs_list]
        wsum = torch.stack(ws).sum().clamp_min(1e-8)
        params = list(self.policy.parameters())
        for p in params:
            p.grad = None
        v = kl = torch.zeros((), device=self.device)
        for mb, w in zip(mbs_list, ws):
            loss, metrics = self.loss(self.policy, mb)
            (loss * (w / wsum)).backward()
            v = v + (w / wsum) * loss.detach()
            kl = kl + (w / wsum) * metrics["kl_approx"]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        for p in params:
            p.grad = None
        return grads, v, kl

    def _update(self, batch: dict) -> None:
        """Gradient accumulation, the finite guard, the Adam step and the
        on-device metrics; nothing waits on the host. With ``warmup``,
        through the update's program (its CUDA graph on the card)."""
        if self._warming is not None:  # the capture works on the parameters, Adam and _dm
            handle, self._warming = self._warming, None
            handle.result()
        if self._update_prog is None:
            self._dm = self._update_body(batch, self._dm)
        else:
            self._dm = self._update_prog({k: batch[k] for k in sorted(batch)}, self._dm)

    def _update_body(self, batch: dict, dm: dict) -> dict:
        grads, v, kl = self._accumulate(batch)
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        ok = torch.isfinite(v) & torch.isfinite(gnorm)
        self.opt.step(grads, ok)
        okf = ok.float()
        spec = self._dm_spec
        dm = spec.inc(dm, "updates", okf)
        dm = spec.inc(dm, "bad_steps", 1.0 - okf)
        dm = spec.inc(dm, "tokens", batch["assistant_mask"].float().sum())
        dm = spec.set_gauge(dm, "loss", torch.where(ok, v, 0.0))
        dm = spec.set_gauge(dm, "reward", batch["reward"].float().mean())
        return spec.set_gauge(dm, "kl_approx", torch.where(ok, kl, 0.0))

    # -- step / train ------------------------------------------------------

    def collect(self) -> dict:
        """One rollout batch from the scheme's serving model, seeded from
        the trainer's stream."""
        return self.collector.collect(None, int(self._seeds.integers(2**31)))

    def update(self, batch: dict) -> dict[str, float]:
        """Update on a collected batch, publish the weights, drain the
        previous step's metrics."""
        self._update(batch)
        self.scheme.push(self.policy)
        self.policy_version.bump()
        out = self._drain_metrics()
        self.history["reward"].append(out["reward"])
        self.history["loss"].append(out["loss"])
        return out

    def _drain_metrics(self) -> dict[str, float]:
        """Lagged-one drain: start this update's copy, read the previous
        one's (the first step reads its own)."""
        pending = DeviceMetrics.drain_async(self._dm)
        landed = self._pending_dm if self._pending_dm is not None else pending
        self._pending_dm = pending
        flat = self._dm_spec.to_flat(DeviceMetrics.drain(landed))
        return {k: flat[k] for k in ("reward", "loss", "kl_approx", "bad_steps")}

    def metrics_snapshot(self) -> dict:
        """Host view of the landed step metrics (never blocks on an
        in-flight update's copy beyond the previous one)."""
        pending = self._pending_dm or DeviceMetrics.drain_async(self._dm)
        return self._dm_spec.to_flat(DeviceMetrics.drain(pending))

    def step(self) -> dict[str, float]:
        """collect -> update -> push weights. Returns step metrics."""
        return self.update(self.collect())

    def train(self, steps: int, log_interval: int = 10, preemption: Any = None,
              emergency: Any = None, guard: Any = None,
              start_step: int = 0) -> dict[str, list[float]]:
        """Run ``steps`` training steps."""
        if preemption is not None or emergency is not None or guard is not None:
            raise NotImplementedError(
                "GRPOTrainer.train: preemption, emergency checkpoints and the "
                "last-good-state guard are not ported yet"
            )
        for i in range(start_step, start_step + steps):
            out = self.step()
            if self.logger is not None and i % log_interval == 0:
                self.logger.log_scalars({f"grpo/{k}": v for k, v in out.items()}, step=i)
        return self.history

    def emergency_save(self, emergency: Any, step: int) -> str:
        raise NotImplementedError("GRPOTrainer: emergency checkpoints are not ported yet")

    def emergency_restore(self, emergency: Any, step: int | None = None) -> int:
        raise NotImplementedError("GRPOTrainer: emergency checkpoints are not ported yet")

    @torch.no_grad()
    def _eval_generate(self, model, tokens, mask):
        """``evaluate``'s greedy decode of the left-padded prompts ``tokens``
        / ``mask`` (the dense-cache ``generate``, chunk by chunk): the
        response tokens and mask. With ``warmup``, each chunk through the
        ``grpo.eval_gen`` program."""
        run = self._eval_chunk if self._eval_prog is None else self._eval_prog
        state = {"tokens": tokens, "mask": mask}
        for start in range(0, self.max_new_tokens, self.eval_chunk):
            state = run(model, state, start, min(self.eval_chunk, self.max_new_tokens - start))
        return state["toks"], state["valid"]

    @torch.no_grad()
    def _eval_chunk(self, model, state: dict, start: int, n: int) -> dict:
        """One ``grpo.eval_gen`` chunk: ``n`` steps from ``start`` (the
        first chunk runs the prefill of ``state``'s prompts first)."""
        if start == 0:
            state = generate_prefill(model, state["tokens"], state["mask"], self.max_new_tokens)
        return generate_steps(model, state, None, start, n,
                              eos_id=self.tokenizer.eos_token_id, greedy=True)

    @torch.no_grad()
    def evaluate(self, num_prompts: int = 32, seed: int = 0) -> float:
        """Greedy-decode exact-match accuracy over dataset prompts; with
        ``warmup``, through the ``grpo.eval_gen`` program."""
        state = self.env.reset(self.dataset.prompts[:num_prompts])
        resp, rmask = self._eval_generate(
            self.scheme.pull(), torch.from_numpy(state["tokens"]).to(self.device),
            torch.from_numpy(np.asarray(state["attention_mask"], np.float32)).to(self.device))
        em = ExactMatchScorer(self.dataset.answers, partial=0.0)
        resp, rmask = resp.cpu().numpy(), rmask.cpu().numpy()
        hits = 0.0
        for i, h in enumerate(state["histories"]):
            toks = resp[i][rmask[i]]
            hits += em(h.append("assistant", self.tokenizer.decode(toks.tolist())), toks)
        return hits / len(state["histories"])


class RolloutPipeline:
    """Background rollout producer with a bounded staleness guarantee.

    A daemon thread loops: take a ticket, draw the collect's seed from
    ``seeds`` (a ``numpy.random.Generator``, drawn as the sequential
    trainer's ``collect`` draws), snapshot ``(model, version)`` from the
    weight scheme (``pull_versioned``), run ``collect_fn(model, seed)``
    and put ``(batch, version)`` on a bounded queue. The consumer (the
    learner) pops batches with :meth:`get`, updates and pushes.

    **Staleness.** A semaphore of ``max_pending`` tickets gates every
    snapshot, and the consumer returns one when it pops a batch, before
    its update. Generation of batch ``j`` needs ``j + 1`` tickets, so
    batches ``0 .. j - max_pending`` were popped first, and the pop of
    batch ``j - max_pending`` came after the push of version ``j + 1 -
    max_pending``: batch ``j`` is generated at that version or later and
    consumed at version ``j + 1``, so its staleness is at most
    ``max_pending``. A bounded queue alone is not enough: its blocked
    ``put`` would return at the pop and the next snapshot could precede
    the update, trailing by one more version. The same count bounds the
    serving ring: when push ``v`` is issued, every batch queued or in
    generation was generated at version ``v - max_pending`` or later, so
    a ring of ``max_pending + 1`` copies never overwrites one a rollout
    reads (:class:`~rl_tpu_torch.weight_update.DevicePutScheme`).

    **Streams.** On the card the producer runs on a CUDA stream of its
    own, in ``torch.no_grad()`` (grad mode and the current stream are per
    thread, so every kernel of the collect launches there). It makes that
    stream wait on the snapshot's "published" event, and records a
    "ready" event after each collect that travels with the batch.
    :meth:`get` makes the caller's current stream wait on it and records
    the caller's stream on the batch's tensors, so the caching allocator
    does not hand their memory to the producer while the consumer still
    reads them. The consumer's stream runs its update and its next push
    after the batch's collect on the device, and so after every read of
    the copy that push overwrites.

    The seed stream is drawn as the sequential trainer draws it, so the
    first pipelined batch equals the first sequential batch from the same
    seed, bit for bit. The reference's chaos site, trace-context carry and
    hot-path marker are instrumentation, not semantics, and are left out;
    ``supervisor`` (a restarting supervisor) waits for ROADMAP A5.
    """

    def __init__(self, scheme, collect_fn: Callable[[Any, int], Any],
                 seeds: np.random.Generator, max_pending: int = 1, supervisor: Any = None,
                 device=None):
        if supervisor is not None:
            raise NotImplementedError(
                "RolloutPipeline(supervisor=...) is not ported to rl_tpu_torch yet "
                "(ROADMAP A5: the resilience supervisor)")
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.scheme = scheme
        self.collect_fn = collect_fn
        self.max_pending = max_pending
        self._seeds = seeds
        self.device = torch.device(device) if device is not None else None
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._tickets = threading.Semaphore(max_pending)
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self._thread: threading.Thread | None = None
        self._stream = None
        # host seconds of each collect, timed in the producer thread
        self.collect_seconds: list[float] = []

    def start(self) -> "RolloutPipeline":
        if self._thread is not None:
            return self
        if self.device is not None and self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
        self._thread = threading.Thread(target=self._run, name="grpo-rollout", daemon=True)
        self._thread.start()
        return self

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _run(self):
        try:
            on_stream = (torch.cuda.stream(self._stream) if self._stream is not None
                         else contextlib.nullcontext())
            with on_stream, torch.no_grad():
                self._produce()
        except BaseException as e:  # surfaced on the consumer's next get
            self._error = e

    def _produce(self):
        while not self._stop.is_set():
            if not self._tickets.acquire(timeout=0.05):
                continue
            try:
                seed = int(self._seeds.integers(2**31))
                model, version = self.scheme.pull_versioned()
                wait = getattr(self.scheme, "wait_published", None)
                if wait is not None:
                    wait(version)
                t0 = time.perf_counter()
                batch = self.collect_fn(model, seed)
                ready = None
                if self._stream is not None:
                    ready = torch.cuda.Event()
                    ready.record(self._stream)
                self.collect_seconds.append(time.perf_counter() - t0)
                self._put((batch, version, ready))
            except BaseException:
                # a crash after the acquire returns the ticket
                self._tickets.release()
                raise

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return
            except queue.Full:
                continue

    def get(self, timeout: float = 120.0) -> tuple[Any, int]:
        """Pop the next ``(batch, version generated at)``, with the
        caller's stream ordered after its collect. Re-raises a producer
        error."""
        deadline = time.monotonic() + timeout
        while True:
            if self._error is not None:
                raise RuntimeError("rollout pipeline producer failed") from self._error
            try:
                batch, version, ready = self._q.get(timeout=0.1)
            except queue.Empty:
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"no rollout batch within {timeout}s "
                                       f"(producer alive: {self.running})") from None
                continue
            # the ticket goes back before the caller's update: the next
            # collect overlaps it
            self._tickets.release()
            if ready is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(ready)
                for v in batch.values():
                    if isinstance(v, torch.Tensor) and v.is_cuda:
                        v.record_stream(stream)
            return batch, version

    def stop(self):
        """Stop the producer: drain the queue (a producer blocked on a full
        queue sees the stop) and join the thread, after the collect it may
        be running."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        if self._thread is not None:
            self._thread.join()
            self._thread = None


class PipelinedGRPOTrainer(GRPOTrainer):
    """GRPO with the next collect overlapping the update (staleness at most
    ``max_pending``, one by default).

    While the learner updates on batch k, the :class:`RolloutPipeline`'s
    thread already collects batch k + 1 from the last published copy of
    the weights. The scheme holds ``max_pending + 1`` serving copies, so
    a push never changes the copy a rollout generates from. Each consumed
    batch's staleness (the scheme's version less the version it was
    generated at) is checked against ``max_pending`` and kept in
    ``staleness_history``; its ``policy_version`` is restamped with the
    version the producer snapshotted. Rollouts default to the
    continuous-batching engine. The producer owns the trainer's seed
    stream, so the first update equals :class:`GRPOTrainer`'s first update
    from the same seed, bit for bit.

    Call :meth:`close` (or use it as a context manager) to stop the
    producer thread.
    """

    def __init__(self, dataset, *args, max_pending: int = 1, supervisor: Any = None, **kw):
        if supervisor is not None:
            raise NotImplementedError(
                "PipelinedGRPOTrainer(supervisor=...) is not ported to rl_tpu_torch yet "
                "(ROADMAP A5: the resilience supervisor)")
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        kw.setdefault("continuous_batching", True)
        self.max_pending = max_pending
        super().__init__(dataset, *args, **kw)
        self.supervisor = supervisor
        self.staleness_history: list[int] = []
        self._pipeline: RolloutPipeline | None = None

    def _serving_copies(self) -> int:
        return self.max_pending + 1

    def _ensure_pipeline(self) -> RolloutPipeline:
        if self._pipeline is None:
            self._pipeline = RolloutPipeline(
                self.scheme, lambda model, seed: self.collector.collect(model, seed),
                self._seeds, max_pending=self.max_pending, device=self.device).start()
        return self._pipeline

    _drain_for_checkpoint = not_ported_call("PipelinedGRPOTrainer._drain_for_checkpoint",
                                            __name__, "A5: checkpoints")

    def step(self) -> dict[str, float]:
        batch, version = self._ensure_pipeline().get()
        staleness = self.scheme.version - version
        self.staleness_history.append(int(staleness))
        if staleness > self.max_pending:
            raise RuntimeError(
                f"staleness invariant violated: batch generated at version {version}, "
                f"trainer at {self.scheme.version} (bound {self.max_pending})")
        # the PolicyVersion transform stamped inside collect, racing the
        # learner's bump; the snapshot's version is the authoritative one
        B = batch["reward"].shape[0]
        batch["policy_version"] = torch.full((B,), version, dtype=torch.int32,
                                             device=batch["reward"].device)
        out = self.update(batch)
        out["staleness"] = float(staleness)
        return out

    def close(self):
        if self._pipeline is not None:
            self._pipeline.stop()
            self._pipeline = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
