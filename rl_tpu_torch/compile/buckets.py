"""Shape-bucketing for the serving engine (copy of
:mod:`rl_tpu.compile.buckets`, prompt and admit ladders).

JAX compiles one program per input shape, which is why the reference
engine rounds prompt lengths up a ladder and the admitted-row count up a
power-of-two ladder. PyTorch runs eagerly, so here the ladders do not save
compiles; they keep the engine's prefill shapes the same fixed set as the
reference (so the two engines batch the same rows together) and give a
later CUDA-graph capture a bounded set of shapes to capture.
"""

from __future__ import annotations

import dataclasses
import operator

__all__ = ["ShapeBuckets", "pow2ceil"]


def pow2ceil(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1)."""
    n = operator.index(n)
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class ShapeBuckets:
    """The serving bucket config.

    Args:
        prompt: ascending prompt-length ladder; admission rounds each
            prompt length up to the next rung.
    """

    prompt: tuple = (32, 128, 512)

    def __post_init__(self):
        p = tuple(int(b) for b in self.prompt)
        if not p or any(b <= 0 for b in p) or list(p) != sorted(set(p)):
            raise ValueError(
                f"prompt ladder must be ascending positive ints, got {self.prompt}"
            )
        object.__setattr__(self, "prompt", p)

    def prompt_bucket(self, length: int) -> int:
        """Round a prompt length up to its ladder rung."""
        for b in self.prompt:
            if length <= b:
                return b
        raise ValueError(
            f"prompt length {length} exceeds the largest bucket {self.prompt[-1]}"
        )

    def admit_bucket(self, count: int, cap: int) -> int:
        """Round an admitted count up the power-of-two ladder (never past
        ``cap``, the engine's slot count)."""
        if count < 1 or count > cap:
            raise ValueError(f"admit count {count} outside 1..{cap}")
        return min(pow2ceil(count), cap)
