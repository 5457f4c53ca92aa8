"""Models, generation and the serving engine (counterpart of
:mod:`rl_tpu.models`; the paged-cache serving path, the dense-cache
``generate`` and teacher-forced scoring are ported so far)."""

from .generate import (
    GenerateOutput,
    generate,
    generate_flops,
    token_log_probs,
    train_step_flops,
)
from .serving import ContinuousBatchingEngine, FinishedRequest, Request
from .speculative import sample_tokens
from .transformer import TransformerConfig, TransformerLM
from .weights import params_from_flax

__all__ = [
    "ContinuousBatchingEngine",
    "FinishedRequest",
    "GenerateOutput",
    "Request",
    "TransformerConfig",
    "TransformerLM",
    "generate",
    "generate_flops",
    "params_from_flax",
    "sample_tokens",
    "token_log_probs",
    "train_step_flops",
]
