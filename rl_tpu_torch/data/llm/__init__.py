"""Chat history and tokenizer: copies of :mod:`rl_tpu.data.llm.history`
and :mod:`rl_tpu.data.llm.tokenizer` (host-side, framework-free)."""

from .history import History, Message
from .tokenizer import SimpleTokenizer

__all__ = ["History", "Message", "SimpleTokenizer"]
