"""Fused temperature/log-softmax/gumbel-argmax sampling (counterpart of
:mod:`rl_tpu.kernels.sampling`).

:func:`fused_sample` does scale -> log-softmax -> gumbel-argmax -> gather
of the chosen log-prob (``kernels/csrc/fused_sample.cu``) on CUDA
tensors, and runs :func:`fused_sample_ref` on CPU tensors. As in the
reference, the gumbel noise is drawn outside the kernel
(:func:`gumbel_like`), so a test can feed the same noise to both
packages; greedy mode takes the argmax of the unscaled logits and needs
no noise. On the card each row is cut into the chunks of
:func:`sample_plan`: one kernel writes each chunk's max and exp-sum, a
second merges a row's chunks, scores each chunk and lets the row's last
block pick the token. float32 and bfloat16 logits go to the kernel as
they are, bfloat16 widened at load.

``top_k > 0`` keeps the k highest scaled logits, ties at the threshold
included (the k-th largest value, counted with multiplicity, is the
threshold, as with ``lax.top_k``); it takes a route of its own, one block
per row that finds the threshold with a radix select over the float bits.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["fused_sample", "fused_sample_ref", "gumbel_like", "sample_plan"]

SAMPLE_MIN_CHUNK = 2048  # entries a split block takes at least: 8 for each of its 256 threads
SAMPLE_TARGET_BLOCKS = 128  # split blocks that fill the 132 SMs of an H100 once
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _temperature(t, device) -> torch.Tensor:
    # a 0-dim tensor on the logits' device: dividing by a Python float
    # would let PyTorch's CUDA path multiply by the reciprocal instead,
    # which is not the kernel's (or the reference's) true division. A
    # fill, not a tensor made from Python data: a graph can hold it
    return torch.clamp(torch.full((), t, dtype=torch.float32, device=device), min=1e-6)


def gumbel_like(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Standard gumbel noise of x's shape, float32, on x's device:
    ``-log(-log(u))`` with ``u`` uniform in ``[tiny, 1)``, the formula of
    ``jax.random.gumbel`` (the bits differ: torch's generator, not
    threefry)."""
    u = torch.rand(x.shape, generator=generator, device=x.device, dtype=torch.float32)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def fused_sample_ref(logits, noise, *, temperature=1.0, greedy=False, top_k=0):
    """The plain version: the expression of the kernel, in its order.
    Returns ``(tok [S] int32, lp [S] float32)``."""
    x = logits.float()
    xs = x / _temperature(temperature, x.device)
    top_k = top_k or 0
    if top_k >= x.shape[-1]:
        top_k = 0  # keeping the whole vocab = no filter
    if top_k:
        thr = torch.topk(xs, top_k, dim=-1).values[:, -1:]
        xs = torch.where(xs >= thr, xs, float("-inf"))
    sh = xs - xs.amax(dim=-1, keepdim=True)
    lps = sh - torch.log(torch.exp(sh).sum(dim=-1, keepdim=True))
    if greedy:
        tok = torch.argmax(x, dim=-1)
    else:
        tok = torch.argmax(noise.float() + lps, dim=-1)
    lp = torch.gather(lps, 1, tok[:, None])[:, 0]
    return tok.to(torch.int32), lp


def sample_plan(S, V):
    """``(C, chunk)``: the split route cuts each of the ``S`` rows into
    ``C`` chunks of ``chunk`` entries (the last may be shorter, none is
    empty), from the shapes alone: enough chunks that ``S * C`` blocks fill
    the card, none below :data:`SAMPLE_MIN_CHUNK` entries unless the row
    is (C = 16 chunks of 2048 at ``S = 8, V = 32768``)."""
    want = -(-SAMPLE_TARGET_BLOCKS // max(S, 1))
    C = max(1, min(want, V // SAMPLE_MIN_CHUNK))
    chunk = -(-V // C)
    return -(-V // chunk), chunk


def fused_sample(logits, noise, *, temperature=1.0, greedy=False, top_k=0):
    """One token per row of ``logits`` [S, V] (float32 or bfloat16 as they
    are, other float dtypes cast to float32) with its log-prob under the
    temperature-scaled softmax. ``noise`` is [S, V] gumbel noise (unused,
    and may be None, when ``greedy``). Returns ``(tok [S] int32, lp [S]
    float32)``. CPU tensors: :func:`fused_sample_ref`. CUDA tensors: the
    kernel, or an exception; never the plain version."""
    if logits.device.type == "cpu":
        return fused_sample_ref(
            logits, noise, temperature=temperature, greedy=greedy, top_k=top_k
        )
    if not logits.is_cuda:
        raise ValueError("fused_sample: CUDA kernel needs CUDA tensors")
    if logits.dim() != 2:
        raise ValueError(f"fused_sample: logits must be [S, V], got {tuple(logits.shape)}")
    S, V = logits.shape
    top_k = int(top_k or 0)
    if top_k < 0:
        raise ValueError(f"fused_sample: top_k must be >= 0, got {top_k}")
    if top_k >= V:
        top_k = 0  # keeping the whole vocab = no filter
    x = logits if logits.dtype in _DTYPES else logits.float()
    if x.stride(-1) != 1:
        x = x.contiguous()  # rows may lie apart; their entries may not
    if not greedy:
        if noise is None or noise.shape != x.shape or noise.device != x.device:
            raise ValueError("fused_sample: sampling needs [S, V] noise on the logits' device")
        noise = noise.float().contiguous()
    tok = torch.empty(S, dtype=torch.int32, device=x.device)
    lp = torch.empty(S, dtype=torch.float32, device=x.device)
    if S == 0 or V == 0:
        return tok, lp
    _launch(x, None if greedy else noise, temperature, tok, lp, top_k)
    _build.count_launch(fused_sample)
    return tok, lp



def _launch(x, noise, temperature, tok, lp, top_k=0):
    """One call of the kernel on checked CUDA tensors (``x`` float32 or
    bfloat16 with contiguous rows, ``noise`` float32 contiguous or None =
    greedy): without top-k the split route's two kernels, on a scratch of
    :func:`sample_plan`'s chunks; with it the one-block route."""
    S, V = x.shape
    C, chunk = sample_plan(S, V)
    scratch = None
    if not top_k:
        scratch = torch.empty(S * (4 * C + 1), dtype=torch.int32, device=x.device)
    fn = _build.function(
        "fused_sample", "rl_fused_sample",
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_float]
        + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 4,
    )
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = fn(
            x.data_ptr(), x.stride(0), None if noise is None else noise.data_ptr(),
            max(float(temperature), 1e-6), S, V, int(noise is None), top_k,
            _DTYPES[x.dtype], C, chunk, None if scratch is None else scratch.data_ptr(),
            tok.data_ptr(), lp.data_ptr(), stream,
        )
    _build.check(code, "fused_sample", "fused_sample")


fused_sample.launches = 0  # kernel calls (CUDA path only)
