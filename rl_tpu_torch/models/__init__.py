"""Models, generation and serving (counterpart of :mod:`rl_tpu.models`;
the paged-cache serving engine with speculative decoding and the KV
handoff, its load balancer, TCP service and client, the serving fleet and
its autoscaler, the dense-cache ``generate`` and teacher-forced scoring
are ported so far)."""

from .generate import (
    GenerateOutput,
    generate,
    generate_flops,
    token_log_probs,
    train_step_flops,
)
from .autoscale import Autoscaler, AutoscalerConfig
from .fleet import ServingFleet, ShedRequest
from .serving import (ContinuousBatchingEngine, FinishedRequest, KVHandoff, LoadBalancer,
                      RemoteEngine, Request, ServiceSaturated, ServingService)
from .speculative import DraftSource, NGramDraft, PrefixTreeDraft, sample_tokens
from .transformer import TransformerConfig, TransformerLM
from .weights import params_from_flax

__all__ = [
    "Autoscaler",
    "AutoscalerConfig",
    "ContinuousBatchingEngine",
    "DraftSource",
    "FinishedRequest",
    "GenerateOutput",
    "KVHandoff",
    "LoadBalancer",
    "NGramDraft",
    "PrefixTreeDraft",
    "RemoteEngine",
    "Request",
    "ServiceSaturated",
    "ServingFleet",
    "ServingService",
    "ShedRequest",
    "TransformerConfig",
    "TransformerLM",
    "generate",
    "generate_flops",
    "params_from_flax",
    "sample_tokens",
    "token_log_probs",
    "train_step_flops",
]
