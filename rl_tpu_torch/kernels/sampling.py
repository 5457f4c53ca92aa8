"""Fused temperature/log-softmax/gumbel-argmax sampling (counterpart of
:mod:`rl_tpu.kernels.sampling`).

:func:`fused_sample` does scale -> log-softmax -> gumbel-argmax -> gather
of the chosen log-prob in one kernel pass per row
(``kernels/csrc/fused_sample.cu``) on CUDA tensors, and runs
:func:`fused_sample_ref` on CPU tensors. As in the reference, the gumbel
noise is drawn outside the kernel (:func:`gumbel_like`), so a test can
feed the same noise to both packages; greedy mode takes the argmax of the
unscaled logits and needs no noise.

``top_k > 0`` keeps the k highest scaled logits, ties at the threshold
included (the k-th largest value, counted with multiplicity, is the
threshold, as with ``lax.top_k``); the kernel finds it with a per-row
radix select over the float bits.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["fused_sample", "fused_sample_ref", "gumbel_like"]


def _temperature(t, device) -> torch.Tensor:
    # a 0-dim tensor on the logits' device: dividing by a Python float
    # would let PyTorch's CUDA path multiply by the reciprocal instead,
    # which is not the kernel's (or the reference's) true division
    return torch.clamp(
        torch.tensor(t, dtype=torch.float32, device=device), min=1e-6
    )


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


def fused_sample(logits, noise, *, temperature=1.0, greedy=False, top_k=0):
    """One token per row of ``logits`` [S, V] (any float dtype; read as
    float32) with its log-prob under the temperature-scaled softmax.
    ``noise`` is [S, V] gumbel noise (unused, and may be None, when
    ``greedy``). Returns ``(tok [S] int32, lp [S] float32)``.
    CPU tensors: :func:`fused_sample_ref`. CUDA tensors: the kernel, or an
    exception; never the plain version."""
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
    x = logits.float().contiguous()
    if not greedy:
        if noise is None or noise.shape != x.shape or noise.device != x.device:
            raise ValueError("fused_sample: sampling needs [S, V] noise on the logits' device")
        noise = noise.float().contiguous()
    tok = torch.empty(S, dtype=torch.int32, device=x.device)
    lp = torch.empty(S, dtype=torch.float32, device=x.device)
    if S == 0:
        return tok, lp
    _launch(x, None if greedy else noise, temperature, tok, lp, top_k)
    fused_sample.launches += 1
    return tok, lp


def _launch(x, noise, temperature, tok, lp, top_k=0):
    """One launch of the kernel on checked, contiguous float32 CUDA
    tensors (``noise`` None = greedy); the wrapper's body after its
    checks."""
    S, V = x.shape
    fn = _build.function(
        "fused_sample", "rl_fused_sample",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p],
    )
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = fn(
            x.data_ptr(), None if noise is None else noise.data_ptr(),
            max(float(temperature), 1e-6), S, V, int(noise is None), top_k,
            tok.data_ptr(), lp.data_ptr(), stream,
        )
    _build.check(code, "fused_sample", "fused_sample")


fused_sample.launches = 0  # kernel launches (CUDA path only)
