"""LLM collector: chat env x generation -> GRPO training batches
(counterpart of :mod:`rl_tpu.collectors.llm`).

Three rollout paths, as in the reference: the dense-cache
:func:`rl_tpu_torch.models.generate` over one left-padded batch; the
continuous-batching engine (``continuous_batching=True``), where rows that
stop early free their slot and each prompt group is scored the moment its
last response lands, while the other slots keep decoding; or the ``batch``
lane of a :class:`~rl_tpu_torch.models.ServingFleet` (``fleet=``), where
the rollouts fill whatever capacity the interactive lane leaves idle.

Where the reference passes params, the port passes models: the rollout
model is the weight scheme's ``pull()`` (the serving copy the trainer
publishes into) unless a model is given. The engine is built once per
model config; a collect given another model of the same config swaps it
into the engine and keeps the pools, as the reference assigns
``eng.params``. The frozen reference model scores ``ref_log_prob``.
Sampling is seeded per collect (``seed``), so one seed gives one batch.
The batch is a dict of tensors on the rollout device.
"""

from __future__ import annotations

from typing import Any, Callable

import time

import numpy as np
import torch

from .._stubs import refuse_options
from ..models.generate import GenerateOutput, generate, token_log_probs
from ..objectives.llm import mc_advantage

__all__ = ["LLMCollector"]


class LLMCollector:
    """Collect GRPO batches: sample prompt groups, generate the group's
    responses, score, compute group-relative advantages.

    Args:
        env: a :class:`~rl_tpu_torch.envs.llm.DatasetChatEnv`.
        model: the rollout model used when neither ``collect`` nor a
            weight scheme gives one.
        ref_model: frozen reference model; when given, the batch carries
            ``ref_log_prob`` (teacher-forced, same attention mask).
        weight_scheme: the scheme ``collect(None, ...)`` pulls from.
        reward_transform: ``(rewards, batch) -> rewards`` applied before
            the advantages (KL shaping, policy-version stamping).
        continuous_batching: roll out through the
            :class:`~rl_tpu_torch.models.ContinuousBatchingEngine`.
        engine_slots / engine_block_size / engine_decode_chunk: the
            engine's shape (slots default to min(batch, 8)).
        engine_prefix_cache: the engine's prefix cache: a GRPO group's
            rollouts share one prompt, so every response after the group's
            first prefills only the last prompt position. The tree is
            dropped at the start of every collect, because a weight push
            between collects makes cached K/V stale.
        engine_registry: the engine's program registry: with one, its
            decode chunks run as CUDA graphs on the card, each captured at
            its first call (the reference's engine always runs its
            compiled programs). ``None``: eager decode.
        fleet: a :class:`~rl_tpu_torch.models.ServingFleet` whose
            ``batch`` lane the rollouts ride instead of a private engine;
            each collect first pushes the rollout model's weights to its
            members (:meth:`~rl_tpu_torch.models.ServingFleet.push_params`);
            a collect whose push fails, or reaches fewer members than are
            routable after it, raises rather than roll out a stale policy.
            Sampling then follows the members' own streams, not ``seed``.
        fleet_timeout_s / fleet_poll_s: the deadline for a collect's rows
            through the fleet, and the poll interval.
        engine_params_sharding: the reference's option, accepted at its
            default (None); any other value raises naming ROADMAP A7.
    """

    def __init__(self, env, model: Any = None, num_prompts: int = 8,
                 max_new_tokens: int = 64, temperature: float = 1.0,
                 eos_id: int | None = None, ref_model: Any = None,
                 weight_scheme: Any = None, reward_transform: Callable | None = None,
                 continuous_batching: bool = False, engine_slots: int | None = None,
                 engine_block_size: int = 16, engine_decode_chunk: int | str = 1,
                 engine_params_sharding: Any = None, engine_prefix_cache: bool = False,
                 engine_registry: Any = None, fleet: Any = None,
                 fleet_timeout_s: float = 120.0, fleet_poll_s: float = 0.01):
        refuse_options("LLMCollector", __name__, [
            ("engine_params_sharding", engine_params_sharding, None, "A7"),
        ])
        self.env = env
        self.model = model
        self.num_prompts = num_prompts
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.eos_id = eos_id
        self.ref_model = ref_model
        self.weight_scheme = weight_scheme
        self.reward_transform = reward_transform
        self.continuous_batching = continuous_batching
        self.engine_slots = engine_slots
        self.engine_block_size = engine_block_size
        self.engine_decode_chunk = engine_decode_chunk
        self.engine_prefix_cache = engine_prefix_cache
        self.engine_registry = engine_registry
        self.fleet = fleet
        self.fleet_timeout_s = fleet_timeout_s
        self.fleet_poll_s = fleet_poll_s
        self._engine = None

    def _engine_generate(self, model, toks, pmask, seed, on_row_done=None) -> GenerateOutput:
        """Continuous-batching rollout shaped like :func:`generate`'s
        output. ``on_row_done(row, resp, rmask)`` fires as each request's
        tokens land on the host (its row of ``resp``/``rmask`` is final)."""
        from ..models.serving import ContinuousBatchingEngine

        G, P = toks.shape
        eng = self._engine
        if eng is not None and (eng.model.cfg, eng.device) == (model.cfg, model.device):
            eng.set_model(model)  # another serving copy: keep the pools
        if self._engine is None or self._engine.model is not model:
            bucket = max(16, 1 << (P - 1).bit_length())
            slots = self.engine_slots or min(G, 8)
            self._engine = ContinuousBatchingEngine(
                model,
                n_slots=slots,
                block_size=self.engine_block_size,
                n_blocks=slots * (-(-model.cfg.max_seq_len // self.engine_block_size)) + 1,
                prompt_buckets=(bucket,),
                eos_id=self.eos_id,
                temperature=self.temperature,
                decode_chunk=self.engine_decode_chunk,
                device=model.device,
                prefix_cache=self.engine_prefix_cache,
                registry=self.engine_registry,
            )
        eng = self._engine
        if self.engine_prefix_cache:
            # blocks cached by an earlier collect hold K/V of the weights
            # before the last push: start from an empty tree
            eng.reset()
        eng._gen.manual_seed(seed)  # the per-collect seed drives sampling
        mask_np = pmask > 0
        rid_row = {eng.submit(toks[g][mask_np[g]], self.max_new_tokens): g for g in range(G)}
        N = self.max_new_tokens
        resp = np.zeros((G, N), np.int64)
        rlp = np.zeros((G, N), np.float32)
        rmask = np.zeros((G, N), bool)

        def absorb(done):
            for rid, f in done.items():
                g = rid_row.pop(rid)
                n = len(f.tokens)
                resp[g, :n] = f.tokens
                rlp[g, :n] = f.log_probs
                # every produced token, a terminal eos included, is real
                # (generate's response_mask convention)
                rmask[g, :n] = True
                if on_row_done is not None:
                    on_row_done(g, resp, rmask)

        # drive the engine step by step, consuming completions while the
        # other slots keep decoding
        while eng.step():
            absorb(eng.harvest())
        absorb(eng.harvest())
        if rid_row:
            raise RuntimeError(f"engine lost requests: {sorted(rid_row)}")
        return _rollout(model.device, toks, mask_np, resp, rlp, rmask)

    def _fleet_generate(self, model, toks, pmask, seed, on_row_done=None) -> GenerateOutput:
        """Batch-lane tenant rollout: the rows ride the fleet's ``batch``
        lane after a rolling push of ``model``'s weights. Sheds, at
        admission (:class:`~rl_tpu_torch.models.ServiceSaturated`) and
        after it (a :class:`~rl_tpu_torch.models.ShedRequest`), back off
        and resubmit until the deadline; results come through
        :meth:`~rl_tpu_torch.models.ServingFleet.poll`, which never takes
        another tenant's rows. ``seed`` is unused: sampling follows the
        members' own streams."""
        from ..models.fleet import ShedRequest
        from ..models.serving import ServiceSaturated

        fleet = self.fleet
        pushed, routable = fleet.push_params(model), fleet.n_routable()
        if pushed != routable:
            raise RuntimeError(f"fleet batch lane: the weights reached {pushed} of "
                               f"{routable} routable members")
        G, _ = toks.shape
        mask_np = pmask > 0
        N = self.max_new_tokens
        resp = np.zeros((G, N), np.int64)
        rlp = np.zeros((G, N), np.float32)
        rmask = np.zeros((G, N), bool)
        pending_rows = list(range(G))  # not admitted yet (or shed again)
        outstanding: dict[int, int] = {}  # frid -> row
        deadline = time.monotonic() + self.fleet_timeout_s
        while pending_rows or outstanding:
            still: list[int] = []
            for g in pending_rows:
                try:
                    outstanding[fleet.submit(toks[g][mask_np[g]], N, lane="batch")] = g
                except ServiceSaturated:
                    still.append(g)  # the interactive lane owns the pool now
            pending_rows = still
            for frid, res in fleet.poll(list(outstanding)).items():
                g = outstanding.pop(frid)
                if isinstance(res, ShedRequest):
                    pending_rows.append(g)  # bounded by the deadline below
                    continue
                n = len(res.tokens)
                resp[g, :n] = res.tokens
                rlp[g, :n] = res.log_probs
                rmask[g, :n] = True
                if on_row_done is not None:
                    on_row_done(g, resp, rmask)
            if pending_rows or outstanding:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"fleet batch lane: {len(pending_rows)} unadmitted + "
                        f"{len(outstanding)} outstanding rollout rows after "
                        f"{self.fleet_timeout_s}s")
                time.sleep(self.fleet_poll_s)
        return _rollout(model.device, toks, mask_np, resp, rlp, rmask)

    def _engine_collect(self, model, toks, pmask, seed, state, group_ids):
        """Engine rollout with first-come group scoring: a prompt group's
        rewards are computed on the host the moment its last response
        lands, while other groups still decode."""
        G = toks.shape[0]
        rewards = np.zeros(G, np.float32)
        group_rows: dict[int, list[int]] = {}
        for row, g in enumerate(group_ids):
            group_rows.setdefault(int(g), []).append(row)
        remaining = {g: len(rows) for g, rows in group_rows.items()}

        def on_row_done(row, resp, rmask):
            g = int(group_ids[row])
            remaining[g] -= 1
            if remaining[g] == 0:
                rows = group_rows[g]
                rewards[rows] = self.env.score_rows(state, resp, rmask, rows)

        gen = self._fleet_generate if self.fleet is not None else self._engine_generate
        return gen(model, toks, pmask, seed, on_row_done), rewards

    def collect(self, model: Any = None, seed: int = 0) -> dict:
        """One GRPO batch: ``tokens``, ``attention_mask``,
        ``assistant_mask``, ``sample_log_prob``, ``group_id``,
        ``advantage``, ``reward`` (+ ``ref_log_prob``, + what the reward
        transform adds). ``model=None`` pulls the weight scheme's serving
        model (or uses the collector's own)."""
        if model is None:
            if self.weight_scheme is not None:
                model = self.weight_scheme.pull()
            elif self.model is not None:
                model = self.model
            else:
                raise ValueError("collect(None) needs a weight_scheme or a model")
        dev = model.device
        state, group_ids = self.env.sample_batch(self.num_prompts)
        toks = np.asarray(state["tokens"])
        pmask = np.asarray(state["attention_mask"], np.float32)
        if self.fleet is not None or self.continuous_batching:
            # prompts stay on the host: the engine slot-packs them there
            out, rewards = self._engine_collect(model, toks, pmask, seed, state, group_ids)
        else:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            out = generate(
                model, torch.from_numpy(toks).to(dev), torch.from_numpy(pmask).to(dev),
                gen, max_new_tokens=self.max_new_tokens,
                temperature=self.temperature, eos_id=self.eos_id,
            )
            _, rewards, _ = self.env.step(
                state, out.response_tokens.cpu().numpy(), out.response_mask.cpu().numpy()
            )

        G, P = toks.shape
        gid = torch.from_numpy(np.asarray(group_ids, np.int64)).to(dev)
        batch = {
            "tokens": out.tokens,
            "attention_mask": out.full_mask.float(),
            "assistant_mask": torch.cat(
                [torch.zeros((G, P), dtype=torch.bool, device=dev), out.response_mask], dim=1
            ),
            "sample_log_prob": torch.cat(
                [torch.zeros((G, P), device=dev), out.response_log_probs], dim=1
            ),
            "group_id": gid,
        }
        if self.ref_model is not None:
            with torch.no_grad():
                batch["ref_log_prob"] = token_log_probs(
                    self.ref_model, batch["tokens"], batch["attention_mask"]
                ).float()
        if self.reward_transform is not None:
            rewards = self.reward_transform(rewards, batch)
        rewards = torch.as_tensor(rewards, dtype=torch.float32, device=dev)
        # advantages after reward shaping, as in the reference
        batch["advantage"] = mc_advantage(rewards, gid, self.num_prompts)
        batch["reward"] = rewards
        return batch


def _rollout(dev, toks, mask_np, resp, rlp, rmask) -> GenerateOutput:
    """An engine or fleet rollout's host arrays as :func:`generate`'s
    output on ``dev``."""

    def up(a):
        return torch.from_numpy(a).to(dev)

    return GenerateOutput(
        tokens=up(np.concatenate([toks.astype(np.int64), resp], axis=1)),
        response_tokens=up(resp),
        response_mask=up(rmask),
        response_log_probs=up(rlp),
        full_mask=up(np.concatenate([mask_np, rmask], axis=1)),
    )
