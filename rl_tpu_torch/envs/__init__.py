"""Environments (counterpart of :mod:`rl_tpu.envs`; the LLM chat envs are
ported so far)."""
