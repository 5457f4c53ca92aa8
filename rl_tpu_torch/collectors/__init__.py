"""Collectors (counterpart of :mod:`rl_tpu.collectors`; the LLM collector,
the single-process env collector, the host env pools, the host collector
and the asynchronous host collector are ported)."""

from .async_host import AsyncHostCollector
from .host import HostCollector, ProcessEnvPool, ThreadedEnvPool, compact_collected
from .llm import LLMCollector
from .single import Collector

__all__ = ["AsyncHostCollector", "Collector", "HostCollector", "LLMCollector", "ProcessEnvPool",
           "ThreadedEnvPool", "compact_collected"]
