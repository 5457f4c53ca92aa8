"""Data (counterpart of :mod:`rl_tpu.data`; the LLM chat containers and
the tokenizer are ported so far)."""
