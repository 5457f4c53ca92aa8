"""Shape-bucketing for the serving engine (copy of
:mod:`rl_tpu.compile.buckets`: the prompt, suffix and admit ladders).

The reference engine rounds prompt lengths up a ladder and the
admitted-row count up a power-of-two ladder, so that its admission
programs come from one fixed set. The port keeps the same ladders: the
engine's prefill shapes are the reference's (the two engines batch the
same rows together), and with a program registry each rung is one CUDA
graph, which ``aot_warmup`` captures ahead of traffic
(:meth:`ShapeBuckets.admit_sizes` x the prompt or suffix ladder).
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
        suffix: extra rungs for the partial prefill of a prefix-cache
            engine, which pads only the uncached suffix (usually much
            shorter than the prompt). The suffix ladder is
            ``sorted(set(suffix) | set(prompt))``, so every suffix a legal
            prompt can leave has a rung.
    """

    prompt: tuple = (32, 128, 512)
    suffix: tuple = ()

    def __post_init__(self):
        p = tuple(int(b) for b in self.prompt)
        if not p or any(b <= 0 for b in p) or list(p) != sorted(set(p)):
            raise ValueError(
                f"prompt ladder must be ascending positive ints, got {self.prompt}"
            )
        object.__setattr__(self, "prompt", p)
        s = tuple(int(b) for b in self.suffix)
        if any(b <= 0 for b in s) or list(s) != sorted(set(s)):
            raise ValueError(f"suffix rungs must be ascending positive ints, got {self.suffix}")
        object.__setattr__(self, "suffix", s)

    def prompt_bucket(self, length: int) -> int:
        """Round a prompt length up to its ladder rung."""
        for b in self.prompt:
            if length <= b:
                return b
        raise ValueError(
            f"prompt length {length} exceeds the largest bucket {self.prompt[-1]}"
        )

    def suffix_ladder(self) -> tuple:
        """The partial-prefill ladder: the prompt rungs plus the extra
        ``suffix`` rungs."""
        return tuple(sorted(set(self.suffix) | set(self.prompt)))

    def suffix_bucket(self, length: int) -> int:
        """Round an uncached-suffix length up to its ladder rung."""
        for b in self.suffix_ladder():
            if length <= b:
                return b
        raise ValueError(f"suffix length {length} exceeds the largest rung {self.prompt[-1]}")

    def admit_bucket(self, count: int, cap: int) -> int:
        """Round an admitted count up the power-of-two ladder (never past
        ``cap``, the engine's slot count)."""
        if count < 1 or count > cap:
            raise ValueError(f"admit count {count} outside 1..{cap}")
        return min(pow2ceil(count), cap)

    def admit_sizes(self, cap: int) -> tuple:
        """Every admitted-row count a prefill can see with ``cap`` slots:
        the powers of two below ``cap``, then ``cap`` (the warm-up set)."""
        sizes = []
        s = 1
        while s < cap:
            sizes.append(s)
            s *= 2
        sizes.append(cap)
        return tuple(sizes)

    def program_count(self, cap: int) -> int:
        """Prefill programs a fully warmed engine holds: one per admit size
        and prompt rung."""
        return len(self.admit_sizes(cap)) * len(self.prompt)
