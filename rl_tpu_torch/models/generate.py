"""Autoregressive generation over a dense KV cache and teacher-forced
scoring (counterpart of :mod:`rl_tpu.models.generate`).

Conventions, as in the reference:

- prompts are **left-padded** (``attention_mask`` 0 on pads), so every
  row's last prompt token sits at the same column and the batch decodes in
  step; positions are ``cumsum(mask) - 1``, clipped at 0;
- :func:`generate` runs ``max_new_tokens`` single-token steps over a
  preallocated cache (written in place), greedy or sampled, and rows stop
  at ``eos_id`` (their later tokens are ``pad_id`` and masked). The loop
  never reads a value back to the host: the alive mask stays on the
  device. Tokens are drawn by the shared sampling rule
  (:func:`rl_tpu_torch.models.sample_tokens`, the fused-sampling kernel on
  CUDA) from an explicit ``torch.Generator``: the same distribution as the
  reference's ``jax.random.categorical``, other bits;
- :func:`token_log_probs` is the training-side scorer.
"""

from __future__ import annotations

import dataclasses

import torch

from .speculative import sample_tokens

__all__ = [
    "GenerateOutput",
    "generate",
    "generate_flops",
    "token_log_probs",
    "train_step_flops",
]


@dataclasses.dataclass
class GenerateOutput:
    tokens: torch.Tensor  # [B, Tp + Tn] full sequences (prompt + response)
    response_tokens: torch.Tensor  # [B, Tn]
    response_mask: torch.Tensor  # [B, Tn] True on real (pre-eos, eos included) tokens
    response_log_probs: torch.Tensor  # [B, Tn] behavior log-probs
    full_mask: torch.Tensor  # [B, Tp + Tn]


def _positions_from_mask(mask: torch.Tensor) -> torch.Tensor:
    return (torch.cumsum(mask.to(torch.int32), dim=1) - 1).clamp_min(0)


@torch.no_grad()
def generate(model, prompt_tokens, prompt_mask, generator: torch.Generator | None,
             max_new_tokens: int, temperature: float = 1.0, eos_id: int | None = None,
             pad_id: int = 0, greedy: bool = False) -> GenerateOutput:
    """Sample ``max_new_tokens`` after each left-padded prompt row.
    ``prompt_tokens``/``prompt_mask`` [B, Tp] on the model's device;
    ``generator`` (on that device) draws the sampling noise and may be
    None when ``greedy``."""
    B, Tp = prompt_tokens.shape
    total = Tp + max_new_tokens
    if total > model.cfg.max_seq_len:
        raise ValueError(
            f"prompt ({Tp}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"max_seq_len ({model.cfg.max_seq_len}); position embeddings would clamp silently"
        )
    dev = prompt_tokens.device
    cache = model.init_cache(B, total)
    mask = torch.cat(
        [prompt_mask.bool(), torch.zeros((B, max_new_tokens), dtype=torch.bool, device=dev)],
        dim=1,
    )
    positions = _positions_from_mask(prompt_mask)
    logits, cache = model(prompt_tokens, attention_mask=mask, cache=cache, positions=positions)
    last = logits[:, -1]
    pos = positions[:, -1] + 1  # per-row position of the next token
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    toks = torch.empty((B, max_new_tokens), dtype=torch.int64, device=dev)
    lps = torch.empty((B, max_new_tokens), dtype=torch.float32, device=dev)
    valid = torch.empty((B, max_new_tokens), dtype=torch.bool, device=dev)
    for t in range(max_new_tokens):
        tok, lp = sample_tokens(last, generator, temperature=temperature, greedy=greedy)
        tok = torch.where(alive, tok.long(), pad_id)
        col = cache[0]["len"]
        mask[:, col] = alive  # the new token is attendable where its row is alive
        logits, cache = model(tok[:, None], attention_mask=mask, cache=cache,
                              positions=pos[:, None])
        toks[:, t], lps[:, t], valid[:, t] = tok, lp, alive
        if eos_id is not None:
            alive = alive & (tok != eos_id)
        last = logits[:, -1]
        pos = pos + 1
    return GenerateOutput(
        tokens=torch.cat([prompt_tokens.long(), toks], dim=1),
        response_tokens=toks,
        response_mask=valid,
        response_log_probs=lps,
        full_mask=mask,
    )


def _matmul_flops_per_token(cfg, n_params: int) -> float:
    """Forward matmul FLOPs per token: 2 per weight for every matmul
    parameter plus the tied head (the embedding lookup is a gather)."""
    emb = cfg.vocab_size * cfg.d_model
    return 2.0 * (n_params - emb) + 2.0 * emb


def train_step_flops(cfg, n_params: int, batch_size: int, seq_len: int) -> float:
    """Model FLOPs of one forward + backward over a [batch_size, seq_len]
    batch: 3x the forward (the backward ~2x), causal attention halved;
    remat recompute is not counted."""
    n_tokens = batch_size * seq_len
    fwd = _matmul_flops_per_token(cfg, n_params) * n_tokens
    attn = cfg.n_layers * 4 * batch_size * cfg.n_heads * seq_len * seq_len * cfg.head_dim / 2
    return 3.0 * (fwd + attn)


def generate_flops(cfg, n_params: int, batch_size: int, prompt_len: int,
                   new_tokens: float) -> float:
    """Model FLOPs of one KV-cache rollout: a causal prefill over the
    prompt, then ``new_tokens`` decode steps over the growing context
    (``new_tokens`` may be a mean, fractional)."""
    per_tok = _matmul_flops_per_token(cfg, n_params)
    prefill = per_tok * batch_size * prompt_len
    prefill_attn = (
        cfg.n_layers * 4 * batch_size * cfg.n_heads * prompt_len * prompt_len * cfg.head_dim / 2
    )
    decode = per_tok * batch_size * new_tokens
    mean_ctx = prompt_len + new_tokens / 2.0
    decode_attn = cfg.n_layers * 4 * batch_size * cfg.n_heads * new_tokens * mean_ctx * cfg.head_dim
    return prefill + prefill_attn + decode + decode_attn


def token_log_probs(model, tokens, attention_mask=None, temperature: float = 1.0):
    """log p(token_t | tokens_<t) for every position, teacher-forced:
    [B, T], position 0 gets 0. ``attention_mask=None`` means every
    position is real; a left-padded mask sets positions to
    ``cumsum(mask) - 1`` and is the padding mask of every attention
    implementation ("flash" takes it as ``kv_mask``). The log-softmax runs
    in the logits' dtype, as the reference's does."""
    mask = positions = None
    if attention_mask is not None:
        mask = attention_mask.bool()
        positions = _positions_from_mask(attention_mask)
    logits = model(tokens, attention_mask=mask, positions=positions)
    return _gather_token_log_probs(logits, tokens, temperature)


def _gather_token_log_probs(logits, tokens, temperature):
    lp = torch.log_softmax(logits[:, :-1] / max(temperature, 1e-6), dim=-1)
    out = torch.gather(lp, -1, tokens[:, 1:, None].long())[..., 0]
    return torch.cat([torch.zeros_like(out[:, :1]), out], dim=1)
