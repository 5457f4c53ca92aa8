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

Not ported (``NotImplementedError``): ``mesh`` (FSDP, ring attention),
the program registry and AOT warm-up (``warmup``, :meth:`aot_warmup`), the
chaos injector and guard (``train(guard=...)``), preemption and emergency
checkpoints. The pipelined trainer comes with a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from .. import resolve_device
from ..collectors.llm import LLMCollector
from ..data.llm.tokenizer import SimpleTokenizer
from ..envs.llm.chat import DatasetChatEnv
from ..envs.llm.datasets import QADataset
from ..envs.llm.reward import ExactMatchScorer, SumScorer, combine_scorers
from ..envs.llm.transforms import KLRewardTransform, PolicyVersion
from ..models import TransformerConfig, TransformerLM, generate, token_log_probs
from ..objectives.llm.grpo import GRPOLoss
from ..obs.device import DeviceMetrics
from ..weight_update.schemes import DevicePutScheme

__all__ = ["Adam", "GRPOTrainer"]


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
        self.count = torch.where(ok, count, self.count)


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
        device: the card by default (no card: raises); ``"cpu"`` runs the
            kernels' plain versions.
    """

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
        if warmup:
            raise NotImplementedError("GRPOTrainer: AOT warm-up (program registry) is not ported yet")
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
        self.ref_model = TransformerLM(model_config, device=dev, seed=seed).requires_grad_(False)

        scorer = scorer or combine_scorers(
            ExactMatchScorer(dataset.answers), SumScorer(dataset.answers), weights=[1.0, 0.5]
        )
        self.env = DatasetChatEnv(dataset.prompts, self.tokenizer, reward_fn=scorer,
                                  group_repeats=group_repeats, max_prompt_len=max_prompt_len,
                                  seed=seed)
        self.scheme = DevicePutScheme(self.gen_model)
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

    def aot_warmup(self, *, background: bool = False):
        raise NotImplementedError("GRPOTrainer: AOT warm-up (program registry) is not ported yet")

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
        on-device metrics; nothing waits on the host."""
        grads, v, kl = self._accumulate(batch)
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        ok = torch.isfinite(v) & torch.isfinite(gnorm)
        self.opt.step(grads, ok)
        okf = ok.float()
        spec = self._dm_spec
        dm = spec.inc(self._dm, "updates", okf)
        dm = spec.inc(dm, "bad_steps", 1.0 - okf)
        dm = spec.inc(dm, "tokens", batch["assistant_mask"].float().sum())
        dm = spec.set_gauge(dm, "loss", torch.where(ok, v, 0.0))
        dm = spec.set_gauge(dm, "reward", batch["reward"].float().mean())
        self._dm = spec.set_gauge(dm, "kl_approx", torch.where(ok, kl, 0.0))

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
    def evaluate(self, num_prompts: int = 32, seed: int = 0) -> float:
        """Greedy-decode exact-match accuracy over dataset prompts."""
        state = self.env.reset(self.dataset.prompts[:num_prompts])
        model = self.scheme.pull()
        out = generate(
            model, torch.from_numpy(state["tokens"]).to(self.device),
            torch.from_numpy(np.asarray(state["attention_mask"], np.float32)).to(self.device),
            None, max_new_tokens=self.max_new_tokens, eos_id=self.tokenizer.eos_token_id,
            greedy=True,
        )
        em = ExactMatchScorer(self.dataset.answers, partial=0.0)
        resp, rmask = out.response_tokens.cpu().numpy(), out.response_mask.cpu().numpy()
        hits = 0.0
        for i, h in enumerate(state["histories"]):
            toks = resp[i][rmask[i]]
            hits += em(h.append("assistant", self.tokenizer.decode(toks.tolist())), toks)
        return hits / len(state["histories"])
