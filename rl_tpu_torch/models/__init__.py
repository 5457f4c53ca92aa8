"""Models and the serving engine (counterpart of :mod:`rl_tpu.models`;
the paged-cache serving path is ported so far)."""

from .serving import ContinuousBatchingEngine, FinishedRequest, Request
from .speculative import sample_tokens
from .transformer import TransformerConfig, TransformerLM
from .weights import params_from_flax

__all__ = [
    "ContinuousBatchingEngine",
    "FinishedRequest",
    "Request",
    "TransformerConfig",
    "TransformerLM",
    "params_from_flax",
    "sample_tokens",
]
