"""The shared sampling rule of the serving path (counterpart of
:mod:`rl_tpu.models.speculative`; draft sources and per-slot key streams
come with speculative decoding in a later slice)."""

from __future__ import annotations

import torch

from ..kernels.sampling import fused_sample, gumbel_like

__all__ = ["sample_tokens"]


def sample_tokens(logits, generator: torch.Generator | None, *, temperature,
                  greedy, top_k=0):
    """(token, behavior log-prob of that token) per row of ``logits``
    [S, V]. ``generator`` draws the gumbel noise (one draw over the whole
    batch, as the reference's single key does); greedy decoding draws
    none and may pass None."""
    noise = None if greedy else gumbel_like(logits, generator)
    return fused_sample(
        logits, noise, temperature=temperature, greedy=greedy, top_k=top_k
    )
