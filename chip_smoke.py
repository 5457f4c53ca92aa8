#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``rl_tpu_torch``) on one NVIDIA GPU.

Run from the root of the repository: ``python3 chip_smoke.py``. It needs
one CUDA card and ``nvcc``, and exits nonzero without them. Phases, each
printing one JSON line:

1. ``build``   — compile every CUDA kernel of the port from its source.
2. ``kernels`` — hold each kernel against its plain PyTorch version on the
   card at the serving path's shapes (paged decode: bf16 and f32 pools,
   GQA and MHA, tables with -1/0 entries, lengths at block edges; fused
   sampling: greedy and sampled on the same noise, an exact tie), and
   time the kernel, the plain version and, where one PyTorch call
   computes the same function, that call.
3. ``serve``   — a GPT-2-small-width LM (vocab 32768, d_model 768, 12
   layers, 12 heads, d_ff 3072, bf16, max_seq_len 1024, seeded random
   weights) served by the continuous-batching engine: 16 greedy requests
   with prompts of 16-480 tokens and 64 new tokens each, then the same
   16 sampled at temperature 1.0. Every kernel's launch count is set to
   0 just before and read just after; each must be > 0.
4. ``check``   — the same width in float32: engine tokens against the
   argmax of the no-cache forward, teacher-forced on prompt + completion.

Then one line ``{"kernels": [...]}`` (per kernel: launches in the serve
phase, error, times, bound), the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Any failed check raises.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, tensor core bf16 / fp32 ALU
TOL_DECODE = {"float32": 1e-5, "bfloat16": 2e-2}
TOL_SAMPLE_LP = 1e-5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond, msg) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def power_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters=30, warmup=3) -> float:
    """Median device time of ``fn`` in ms, each launch after an L2 flush
    (the serving path finds its inputs cold: other layers' weights and
    caches pass through L2 in between). A short device-side spin after
    the flush keeps the card busy while the host enqueues ``fn``, so the
    host's launch overhead does not land between the two events."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(200_000)  # ~0.1 ms of clock cycles
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


# -- phase 2: kernels against their plain versions --------------------------


def decode_case(torch, gen, *, S, H, Hk, D, block, max_blocks, N, dtype, lens, holes=False):
    """Random pools/q and a block table of distinct blocks covering each
    slot's ``lens`` (the rest -1). ``holes`` puts a -1 and a 0 (scratch)
    entry inside one slot's range, as the kernel's contract allows."""
    dev = "cuda"
    pool_k = torch.randn((N, Hk, block, D), generator=gen, device=dev).to(dtype)
    pool_v = torch.randn((N, Hk, block, D), generator=gen, device=dev).to(dtype)
    q = torch.randn((S, 1, H, D), generator=gen, device=dev).to(dtype)
    table = np.full((S, max_blocks), -1, np.int32)
    perm = np.random.default_rng(S * 1000 + D).permutation(np.arange(1, N))
    used = 0
    for s, L in enumerate(lens):
        nb = -(-int(L) // block)
        table[s, :nb] = perm[used : used + nb]
        used += nb
    if holes:
        s = int(np.argmax(lens))
        table[s, 1] = -1
        table[s, 2] = 0
    lens = np.asarray(lens, np.int32)
    return q, pool_k, pool_v, torch.from_numpy(table).to(dev), torch.from_numpy(lens).to(dev)


def decode_bound(q, pool_k, table, lens):
    """(bound_ms, bound_by): bytes of q, out, table, lens and of the K/V
    rows this data attends (positions < len in entries > 0), against the
    ops of the two products on those rows."""
    S, _, H, D = q.shape
    _, Hk, block, _ = pool_k.shape
    t, ln = table.cpu().numpy(), lens.cpu().numpy()
    rows = 0
    for s in range(S):
        for j in range(t.shape[1]):
            if t[s, j] > 0:
                rows += max(0, min(block, int(ln[s]) - j * block))
    esz = q.element_size()
    nbytes = 2 * q.numel() * esz + t.size * 4 + S * 4 + 2 * rows * Hk * D * esz
    ops = 4 * rows * (H // Hk) * Hk * D
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = ops / PEAK_OPS[str(q.dtype).split(".")[-1]]
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def kernels_phase(torch):
    import torch.nn.functional as F

    from rl_tpu_torch.kernels import sampling
    from rl_tpu_torch.ops import attention

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    # the serving path's decode shapes: 8 slots, 12 heads of 64, block 16,
    # 64 table entries (max_seq_len 1024), 513 pool blocks; lengths spread
    # over the served range, several at block edges
    main = dict(S=8, H=12, Hk=12, D=64, block=16, max_blocks=64, N=513)
    main_lens = [1, 16, 17, 128, 255, 256, 400, 544]
    decode_cases = [
        ("main_bf16", dict(main, dtype=torch.bfloat16, lens=main_lens)),
        ("main_f32", dict(main, dtype=torch.float32, lens=main_lens)),
        ("holes_bf16", dict(main, dtype=torch.bfloat16, lens=[0, 33, 64, 200], S=4, holes=True)),
        ("holes_f32", dict(main, dtype=torch.float32, lens=[0, 33, 64, 200], S=4, holes=True)),
        ("gqa3_d64_b16_bf16", dict(S=4, H=12, Hk=4, D=64, block=16, max_blocks=16, N=80,
                                   dtype=torch.bfloat16, lens=[16, 31, 160, 256])),
        ("gqa4_d128_b64_f32", dict(S=3, H=8, Hk=2, D=128, block=64, max_blocks=8, N=30,
                                   dtype=torch.float32, lens=[64, 65, 512])),
        ("mqa_d32_b8_bf16", dict(S=5, H=4, Hk=1, D=32, block=8, max_blocks=16, N=90,
                                 dtype=torch.bfloat16, lens=[1, 8, 9, 100, 128])),
        ("gqa2_d128_b32_f32", dict(S=2, H=16, Hk=8, D=128, block=32, max_blocks=8, N=20,
                                   dtype=torch.float32, lens=[32, 200])),
    ]
    cases, rows = [], {}
    for name, kw in decode_cases:
        dtype = kw["dtype"]
        q, pk, pv, table, lens = decode_case(torch, gen, **kw)
        out_k = attention.paged_flash_decode(q, pk, pv, table, lens)
        out_r = attention.paged_flash_decode_ref(q, pk, pv, table, lens)
        torch.cuda.synchronize()
        require(torch.isfinite(out_k.float()).all().item(), f"{name}: non-finite output")
        err = (out_k.float() - out_r.float()).abs().max().item()
        tol = TOL_DECODE[str(dtype).split(".")[-1]]
        cases.append({"kernel": "paged_flash_decode", "case": name, "max_abs_err": err, "tol": tol})
        require(err <= tol, f"paged_flash_decode {name}: max abs err {err} > {tol}")
        if name == "main_bf16":
            scale = q.shape[-1] ** -0.5
            qs = (q * scale).contiguous()
            out = torch.empty_like(qs)
            ms = time_ms(torch, lambda: attention._launch(qs, pk, pv, table, lens, out))
            plain_ms = time_ms(torch, lambda: attention.paged_flash_decode_ref(q, pk, pv, table, lens))
            # yardstick: one SDPA call over the slots' K/V gathered into
            # contiguous [S, H, Lmax, D] with a length mask (not used by the port)
            S, Lmax = q.shape[0], int(lens.max().item())
            safe = table.long().clamp_min(0)
            kc = pk[safe].permute(0, 2, 1, 3, 4).reshape(S, pk.shape[1], -1, q.shape[-1])[:, :, :Lmax]
            vc = pv[safe].permute(0, 2, 1, 3, 4).reshape(S, pk.shape[1], -1, q.shape[-1])[:, :, :Lmax]
            kc, vc = kc.contiguous(), vc.contiguous()
            mask = (torch.arange(Lmax, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
            qh = q.transpose(1, 2).contiguous()
            library_ms = time_ms(
                torch, lambda: F.scaled_dot_product_attention(qh, kc, vc, attn_mask=mask, scale=scale)
            )
            bound_ms, bound_by = decode_bound(q, pk, table, lens)
            rows["paged_flash_decode"] = {
                "name": "paged_flash_decode", "tpu_kernel": "B4", "route": "cuda",
                "source": "rl_tpu_torch/kernels/csrc/paged_decode.cu",
                "replaces": "rl_tpu/ops/attention.py:761",
                "shape": "S=8 H=12 Hk=12 D=64 block=16 max_blocks=64 bf16, lens " + str(main_lens),
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            }

    S, V = 8, 32768
    x = torch.randn((S, V), generator=gen, device="cuda") * 3.0
    x[1] = x[1].to(torch.bfloat16).float()  # the serving path's logits come from bf16
    x[0, 100] = x[0, 2000] = x[0].max() + 1.0  # exact tie: the first index must win
    noise = sampling.gumbel_like(x, gen)
    noise[0, 100] = noise[0, 2000] = 50.0  # tie under sampling too
    for name, kw in [
        ("greedy", dict(temperature=1.0, greedy=True)),
        ("sampled_t1", dict(temperature=1.0, greedy=False)),
        ("sampled_t07", dict(temperature=0.7, greedy=False)),
    ]:
        tok_k, lp_k = sampling.fused_sample(x, noise, **kw)
        tok_r, lp_r = sampling.fused_sample_ref(x, noise, **kw)
        torch.cuda.synchronize()
        same = bool(torch.equal(tok_k, tok_r))
        err = (lp_k - lp_r).abs().max().item()
        cases.append({"kernel": "fused_sample", "case": name, "tokens_equal": same,
                      "max_abs_err": err, "tol": TOL_SAMPLE_LP, "tie_token": int(tok_k[0])})
        require(same, f"fused_sample {name}: tokens differ")
        require(int(tok_k[0]) == 100, f"fused_sample {name}: tie went to {int(tok_k[0])}, not 100")
        require(err <= TOL_SAMPLE_LP, f"fused_sample {name}: lp err {err}")
        if name == "sampled_t1":
            tok, lp = torch.empty_like(tok_k), torch.empty_like(lp_k)
            ms = time_ms(torch, lambda: sampling._launch(x, noise, 1.0, tok, lp))
            plain_ms = time_ms(torch, lambda: sampling.fused_sample_ref(x, noise, temperature=1.0))
            nbytes = 2 * x.numel() * 4 + S * 8
            ops = 8 * x.numel()  # divide, max, subtract, exp, sum, subtract, add, compare
            by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS["float32"]
            rows["fused_sample"] = {
                "name": "fused_sample", "tpu_kernel": "B5", "route": "cuda",
                "source": "rl_tpu_torch/kernels/csrc/fused_sample.cu",
                "replaces": "rl_tpu/kernels/sampling.py:82",
                "shape": "S=8 V=32768 f32, sampled (logits + noise)",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(by_bytes, by_ops) * 1e3,
                "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                "library_ms": None,  # no single PyTorch call samples
            }
    emit({"phase": "kernels", "cases": cases,
          "timed": [{"name": r["name"], "tpu_kernel": r["tpu_kernel"],
                     "max_abs_err": r["max_abs_err"], "kernel_ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "library_ms": r["library_ms"]} for r in rows.values()]})
    return rows


# -- phase 3: serve at full width --------------------------------------------

FULL_WIDTH = dict(vocab_size=32768, d_model=768, n_layers=12, n_heads=12, d_ff=3072,
                  max_seq_len=1024)


def prompts(n, lo, hi, vocab, seed):
    rng = np.random.default_rng(seed)
    lengths = np.linspace(lo, hi, n).astype(int)
    return [rng.integers(0, vocab, L).astype(np.int32) for L in lengths]


def sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def serve_run(torch, engine, reqs, max_new, vocab):
    sync(torch, engine.device)
    t0 = time.perf_counter()
    for p in reqs:
        engine.submit(p, max_new)
    out = engine.run()
    sync(torch, engine.device)
    wall = time.perf_counter() - t0
    require(len(out) == len(reqs), f"{len(out)} of {len(reqs)} requests finished")
    for f in out.values():
        require(len(f.tokens) == max_new and f.finished_reason == "length",
                f"request {f.rid}: {len(f.tokens)} tokens, {f.finished_reason}")
        require(np.isfinite(f.log_probs).all() and (f.log_probs <= 1e-6).all(),
                f"request {f.rid}: bad log-probs")
        require(((f.tokens >= 0) & (f.tokens < vocab)).all(),
                f"request {f.rid}: token out of range")
    tokens = sum(len(f.tokens) for f in out.values())
    return {
        "requests": len(out), "tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall,
        "prefill_ms_total": engine.prefill_s * 1e3,
        "prefill_rounds": engine.prefill_rounds,
        "prefill_ms_per_round": engine.prefill_s * 1e3 / max(engine.prefill_rounds, 1),
        "decode_steps": engine.decode_steps,
        "decode_step_ms_mean": (wall - engine.prefill_s) * 1e3 / max(engine.decode_steps, 1),
    }


def profile_run(torch, engine, reqs, max_new):
    """One more greedy run under ``torch.profiler``: device time by
    kernel against the run's wall clock (the profiler's own host cost
    inflates that wall; the device times are the card's)."""
    from torch.profiler import ProfilerActivity, profile

    for p in reqs:
        engine.submit(p, max_new)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        engine.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [  # device-side events only (CPU ops carry their kernels' time too)
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    busy_ms = sum(t for _, t, _ in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:10]
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
        "decode_steps": engine.decode_steps,
        "device_launches_per_decode_step": sum(c for *_, c in kernels) / max(engine.decode_steps, 1),
        "top_device_ms": [{"kernel": k[:80], "ms": t, "count": c} for k, t, c in top],
    }


def serve_phase(torch, card, device="cuda", width=FULL_WIDTH):
    from rl_tpu_torch.kernels import sampling
    from rl_tpu_torch.models import ContinuousBatchingEngine, TransformerConfig, TransformerLM
    from rl_tpu_torch.ops import attention

    cfg = TransformerConfig(**width, dtype=torch.bfloat16)
    model = TransformerLM(cfg, device=device, seed=0)

    def engine(**kw):
        return ContinuousBatchingEngine(
            model, n_slots=8, block_size=16, n_blocks=513, prompt_buckets=(32, 128, 512),
            decode_chunk=4, device=device, **kw,
        )

    V = cfg.vocab_size
    reqs = prompts(16, 16, 480, V, seed=1)
    # warm-up (cuBLAS handles, allocator pools), not timed or counted
    serve_run(torch, engine(greedy=True), reqs[:2] + reqs[-1:], 8, V)

    attention.paged_flash_decode.launches = 0
    sampling.fused_sample.launches = 0
    greedy = serve_run(torch, engine(greedy=True), reqs, 64, V)
    sampled = serve_run(torch, engine(greedy=False, temperature=1.0, seed=1), reqs, 64, V)
    launches = {
        "paged_flash_decode": attention.paged_flash_decode.launches,
        "fused_sample": sampling.fused_sample.launches,
    }
    for name, n in launches.items():
        require(n > 0, f"{name} was not launched on the serving path")
    prof = profile_run(torch, engine(greedy=True), reqs, 64) if device == "cuda" else None
    emit({"phase": "serve", "config": {**width, "dtype": "bfloat16", "n_slots": 8,
                                       "block_size": 16, "n_blocks": 513,
                                       "decode_chunk": 4, "max_new_tokens": 64},
          "greedy": greedy, "sampled_t1": sampled, "launches": launches,
          "profiled_greedy": prof, "card": card})
    return launches


# -- phase 4: teacher-forced check in float32 -------------------------------


def check_phase(torch, device="cuda", width=FULL_WIDTH):
    from rl_tpu_torch.models import ContinuousBatchingEngine, TransformerConfig, TransformerLM

    cfg = TransformerConfig(**width, dtype=torch.float32)
    model = TransformerLM(cfg, device=device, seed=0)
    eng = ContinuousBatchingEngine(
        model, n_slots=4, block_size=16, n_blocks=257, prompt_buckets=(32, 128, 512),
        decode_chunk=4, greedy=True, device=device,
    )
    reqs = prompts(5, 20, 480, cfg.vocab_size, seed=2)
    for p in reqs:
        eng.submit(p, 16)
    out = eng.run()
    require(len(out) == len(reqs), "check: not every request finished")
    decisive = agree = 0
    lp_err = 0.0
    with torch.no_grad():
        for f in out.values():
            P = len(f.prompt)
            seq = torch.from_numpy(np.concatenate([f.prompt, f.tokens[:-1]])).to(device)
            rows = model(seq[None])[0, P - 1 :].float()
            top2 = rows.topk(2, dim=-1).values
            margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
            pred = rows.argmax(dim=-1).cpu().numpy()
            ok = margin >= 1e-3
            decisive += int(ok.sum())
            agree += int((pred == f.tokens)[ok].sum())
            ref_lp = torch.log_softmax(rows, dim=-1)[
                torch.arange(len(f.tokens), device=device),
                torch.from_numpy(f.tokens).to(device).long(),
            ].cpu().numpy()
            lp_err = max(lp_err, float(np.abs(ref_lp - f.log_probs).max()))
    agreement = agree / max(decisive, 1)
    emit({"phase": "check", "dtype": "float32", "requests": len(out),
          "decisive_positions": decisive, "agreement": agreement,
          "max_abs_logprob_err": lp_err})
    require(decisive > 0, "check: no position with a top-2 margin >= 1e-3")
    require(agreement == 1.0, f"check: engine tokens agree with the forward on {agreement:.4f}")
    require(lp_err < 1e-3, f"check: log-prob error {lp_err}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from rl_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in float32
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    libs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": [f"rl_tpu_torch/kernels/csrc/{s}.cu" for s in libs],
          "flags": list(_build.NVCC_FLAGS)})
    card = power_line()
    rows = kernels_phase(torch)
    launches = serve_phase(torch, card)
    check_phase(torch)
    for name, row in rows.items():
        row["launches"] = launches[name]
        row["card"] = card
    emit({"kernels": list(rows.values())})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
