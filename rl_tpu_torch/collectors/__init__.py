"""Collectors (counterpart of :mod:`rl_tpu.collectors`; the LLM collector
is ported so far)."""

from .llm import LLMCollector

__all__ = ["LLMCollector"]
