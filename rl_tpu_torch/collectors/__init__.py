"""Collectors (counterpart of :mod:`rl_tpu.collectors`; the LLM collector
and the single-process env collector are ported)."""

from .llm import LLMCollector
from .single import Collector

__all__ = ["Collector", "LLMCollector"]
