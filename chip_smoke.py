#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``rl_tpu_torch``) on one NVIDIA GPU.

Run from the root of the repository: ``python3 chip_smoke.py``. It needs
one CUDA card and ``nvcc``, and exits nonzero without them. Phases, each
printing one JSON line:

1. ``build``   — compile every CUDA kernel of the port from its source.
2. ``kernels`` — hold each kernel against its plain PyTorch version on the
   card (paged decode: bf16 and f32 pools, GQA and MHA, tables with -1/0
   entries, lengths at block edges; fused sampling: greedy and sampled on
   the same noise, an exact tie, top-k with ties at the threshold; flash
   attention forward, dQ and dK/dV: bf16 and f32, MHA, GQA 12/4 and MQA,
   causal and not, a left-padded kv_mask with fully masked rows, packed
   segment ids, T = 1000, and the training shape with a left-padded
   kv_mask), and time the kernel at its main path's shape, the plain
   version and, where one PyTorch call computes the same function, that
   call.
3. ``serve``   — a GPT-2-small-width LM (vocab 32768, d_model 768, 12
   layers, 12 heads, d_ff 3072, bf16, max_seq_len 1024, seeded random
   weights) served by the continuous-batching engine: 16 greedy requests
   with prompts of 16-480 tokens and 64 new tokens each, then the same
   16 sampled at temperature 1.0. Every kernel's launch count is set to
   0 just before and read just after; paged decode and sampling must be
   > 0.
4. ``check``   — the same width in float32: engine tokens against the
   argmax of the no-cache forward, teacher-forced on prompt + completion.
5. ``train``   — the same width in bf16 with ``attention_impl="flash"``:
   ``GRPOTrainer`` (16 rollouts of 512 prompt + 512 new tokens through the
   engine, microbatch 8) takes 3 steps; per step collect and update
   seconds, update MFU, loss, reward, bad steps; then greedy
   ``evaluate`` over 8 prompts (the dense-cache ``generate``) and one
   profiled update. Counts are set to 0 before the steps and read after
   them; every kernel must be > 0.
6. ``train_check`` — full width in float32, one microbatch of 8 x 1024
   with left padding: the GRPO loss and every parameter gradient through
   the flash kernels (also under per-block remat "none" and "dots")
   against the dense attention, same weights.

Then one line ``{"kernels": [...]}`` (per kernel: launches in the main
path's phases, error, times, bound), the card's name and power limit, and
last ``{"ok": true, "device": {...}}``. Any failed check raises.
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
# flash kernels against their plain versions. Both compute in float32 from
# the same inputs. A float32 output: |kernel - plain| <= 1e-4 + 1e-4 *
# max|plain| (summation order only). A bf16 output is rounded in both, so
# an element whose float32 value lies at a rounding boundary may differ by
# one bf16 step, at most 2^-7 |plain|; per element, |kernel - plain| <=
# 2^-7 |plain| + 1e-3 rms(plain), the second term (1/8 of a step at a
# typical value) for elements near 0, where the float32 sums' own rounding
# shows.
TOL_FLASH_F32 = (1e-4, 1e-4)
TOL_FLASH_BF16 = (2.0**-7, 1e-3)
# flash vs dense training gradients in float32: the reference's own
# flash-vs-dense gradient tolerance (tests/test_pallas_attention.py)
TRAIN_RTOL, TRAIN_ATOL = 2e-3, 2e-4


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
    # top-k: row 2 holds three exact ties at the k-th largest value; the
    # noise favours the last of them, so only a threshold that keeps every
    # tie can pick it
    xk = x.clone()
    order = torch.argsort(xk[2], descending=True)
    thr_val = xk[2, order[9]].item()
    ties = order[9:12]
    xk[2, ties] = thr_val
    nk = noise.clone()
    nk[2] = 0.0
    nk[2, ties[-1]] = 80.0
    for name, kw in [
        ("topk10_sampled_ties", dict(temperature=1.0, greedy=False, top_k=10)),
        ("topk1_sampled", dict(temperature=0.8, greedy=False, top_k=1)),
        ("topk50_greedy", dict(temperature=0.7, greedy=True, top_k=50)),
    ]:
        tok_k, lp_k = sampling.fused_sample(xk, nk, **kw)
        tok_r, lp_r = sampling.fused_sample_ref(xk, nk, **kw)
        torch.cuda.synchronize()
        same = bool(torch.equal(tok_k, tok_r))
        err = (lp_k - lp_r).abs().max().item()
        cases.append({"kernel": "fused_sample", "case": name, "tokens_equal": same,
                      "max_abs_err": err, "tol": TOL_SAMPLE_LP, "row2_token": int(tok_k[2])})
        require(same, f"fused_sample {name}: tokens differ")
        require(err <= TOL_SAMPLE_LP, f"fused_sample {name}: lp err {err}")
        if name == "topk10_sampled_ties":
            require(int(tok_k[2]) == int(ties[-1]),
                    f"fused_sample {name}: tie at the threshold not kept")

    rows.update(flash_cases(torch, gen, cases))
    emit({"phase": "kernels", "cases": cases,
          "timed": [{"name": r["name"], "tpu_kernel": r["tpu_kernel"],
                     "max_abs_err": r["max_abs_err"], "kernel_ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "library_ms": r["library_ms"]} for r in rows.values()]})
    return rows


# training shape; the left pads are drawn as the train_check phase draws
# them (row 0 unpadded, row 1 one real prompt token, the rest uniform below
# the 512-token prompt), so rows with no key are present
FLASH_MAIN = dict(B=8, T=1024, H=12, Hk=12, D=64, dtype="bfloat16", causal=True)
FLASH_MAIN_PROMPT = 512


def flash_main_pads():
    pads = np.random.default_rng(3).integers(0, FLASH_MAIN_PROMPT, FLASH_MAIN["B"])
    pads[0], pads[1] = 0, FLASH_MAIN_PROMPT - 1
    return pads.tolist()


def flash_inputs(torch, gen, *, B, T, H, Hk, D, dtype, causal, pad=None, packed=False):
    """Seeded q, k, v, do; ``pad`` left-pads row b by pad[b] keys
    (kv_mask), ``packed`` gives every row three packed segments."""
    dt = getattr(torch, dtype)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    q, k, v, do = rnd(B, T, H, D), rnd(B, T, Hk, D), rnd(B, T, Hk, D), rnd(B, T, H, D)
    kv_mask = seg = None
    if pad is not None:
        kv_mask = torch.arange(T, device="cuda")[None, :] >= torch.tensor(pad, device="cuda")[:, None]
    if packed:
        seg = (torch.arange(T, device="cuda")[None, :] * 3 // T).expand(B, T).contiguous()
    return q, k, v, do, kv_mask, seg


def flash_excess(a, b):
    """(max |a - b|, max of |a - b| less its limit) for a flash kernel's
    output ``a`` against its plain version ``b``: TOL_FLASH_BF16 per
    element for a bf16 output, TOL_FLASH_F32 for a float32 one. The lse of
    a row with no key (-1e30 in both) sets no scale."""
    bf = b.float()
    d = (a.float() - bf).abs()
    real = bf.abs() < 1e29
    if str(b.dtype).endswith("bfloat16"):
        rel, floor = TOL_FLASH_BF16
        lim = rel * bf.abs() + floor * bf[real].square().mean().sqrt()
    else:
        atol, rtol = TOL_FLASH_F32
        lim = atol + rtol * bf[real].abs().max()
    return d.max().item(), (d - lim).max().item()


def hold_flash(torch, A, label, q, k, v, do, kv_mask, seg, causal, cases):
    """B1, B2-dQ and B2-dK/dV on one input against their plain versions:
    every output within its limit, and a row with no attended key exactly
    (o = 0, lse = -1e30). Returns {kernel: max abs error}."""
    qseg, kseg = A._seg_from_args(kv_mask, seg, q.shape[0], q.shape[1], q.device)
    o_k, lse_k = A.flash_fwd(q, k, v, qseg, kseg, causal)
    o_r, lse_r = A.flash_attention_ref(q, k, v, causal, None, qseg, kseg)
    dq_k, dk_k, dv_k = A.flash_bwd(q, k, v, o_r, lse_r, do, qseg, kseg, causal)
    dq_r, dk_r, dv_r = A.flash_attention_bwd_ref(q, k, v, o_r, lse_r, do, causal, None,
                                                 qseg, kseg)
    torch.cuda.synchronize()
    errs = {}
    for kern, pairs in [("flash_fwd", [(o_k, o_r), (lse_k, lse_r)]),
                        ("flash_bwd_dq", [(dq_k, dq_r)]),
                        ("flash_bwd_dkv", [(dk_k, dk_r), (dv_k, dv_r)])]:
        res = [flash_excess(a, b) for a, b in pairs]
        finite = all(torch.isfinite(a.float()).all().item() for a, _ in pairs)
        errs[kern] = max(e for e, _ in res)
        cases.append({"kernel": kern, "case": label, "max_abs_err": errs[kern],
                      "excess_over_limit": [x for _, x in res]})
        require(finite, f"{kern} {label}: non-finite output")
        require(all(x <= 0.0 for _, x in res), f"{kern} {label}: (max abs err, excess) {res}")
    if kv_mask is not None:  # rows with no attended key: zeros, lse -1e30
        dead = ~kv_mask if causal else (~kv_mask).all(dim=1, keepdim=True).expand_as(kv_mask)
        if dead.any():
            require(o_k.float()[dead].abs().max().item() == 0.0
                    and (lse_k.transpose(1, 2)[dead] == -1e30).all().item(),
                    f"flash_fwd {label}: a row with no key is not (0, -1e30)")
    return errs


def flash_bound(q, k, valid, seg_bytes, kind):
    """(bound_ms, bound_by) for one flash kernel on these inputs: the
    multiply-adds over the (query, key) pairs this data attends (``valid``,
    [B or 1, 1, T, T]) at the bf16 or float32 peak, against each input
    read once and each output written once at 3.35 TB/s. Per pair: fwd
    QK^T + PV (4D flops); dQ: QK^T, dO V^T, dS K (6D); dK/dV: QK^T, dO V^T,
    P^T dO, dS^T Q (8D)."""
    B, T, H, D = q.shape
    Hk = k.shape[2]
    pairs = H * int(valid.expand(B, 1, T, T).sum().item())
    esz = q.element_size()
    qbytes, kbytes, rows = B * T * H * D * esz, B * T * Hk * D * esz, B * H * T * 4
    flops, nbytes = {
        "fwd": (4 * D * pairs, 2 * qbytes + 2 * kbytes + rows),  # q, k, v in; o, lse out
        "dq": (6 * D * pairs, 3 * qbytes + 2 * kbytes + 2 * rows),  # q, do, k, v, lse, delta; dq
        "dkv": (8 * D * pairs, 2 * qbytes + 4 * kbytes + 2 * rows),  # q, do, k, v, lse, delta; dk, dv
    }[kind]
    by_bytes = (nbytes + seg_bytes) / HBM_BYTES_PER_S
    by_ops = flops / PEAK_OPS[str(q.dtype).split(".")[-1]]
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def flash_cases(torch, gen, cases):
    """B1, B2-dQ and B2-dK/dV against their plain versions, then each held
    and timed at the training shape [8, 1024, 12, 64] bf16 causal with a
    left-padded kv_mask."""
    import torch.nn.functional as F

    from rl_tpu_torch.ops import attention as A

    small = dict(B=3, T=200, H=12, D=64)
    specs = [
        ("mha_causal", dict(small, Hk=12, causal=True)),
        ("mha_full", dict(small, Hk=12, causal=False)),
        ("gqa12_4_causal", dict(small, Hk=4, causal=True)),
        ("mqa_full", dict(small, Hk=1, causal=False)),
        ("leftpad_causal", dict(small, Hk=4, causal=True, pad=[0, 70, 199])),
        ("leftpad_full", dict(small, Hk=12, causal=False, pad=[5, 64, 130])),
        ("packed_causal", dict(small, Hk=12, causal=True, packed=True)),
        ("t1000_gqa_d128", dict(B=2, T=1000, H=8, Hk=2, D=128, causal=True, pad=[0, 333])),
        ("t40_mqa_d32", dict(B=2, T=40, H=4, Hk=1, D=32, causal=True, pad=[3, 40])),
    ]
    for name, kw in specs:
        for dtype in ("float32", "bfloat16"):
            q, k, v, do, kv_mask, seg = flash_inputs(torch, gen, dtype=dtype, **kw)
            hold_flash(torch, A, f"{name}_{dtype}", q, k, v, do, kv_mask, seg, kw["causal"],
                       cases)

    # the training shape: held to the plain versions, then timed
    m, pads = FLASH_MAIN, flash_main_pads()
    c, B, T, D = m["causal"], m["B"], m["T"], m["D"]
    q, k, v, do, kv_mask, _ = flash_inputs(torch, gen, pad=pads, **m)
    errs = hold_flash(torch, A, "main_leftpad_bfloat16", q, k, v, do, kv_mask, None, c, cases)
    qseg, kseg = A._seg_from_args(kv_mask, None, B, T, q.device)
    scale = D**-0.5
    o, lse = A.flash_fwd(q, k, v, qseg, kseg, c)
    prep = A.flash_bwd_inputs(q, k, v, o, lse, do, qseg, kseg)
    fwd_ms = time_ms(torch, lambda: A.flash_fwd(q, k, v, qseg, kseg, c), iters=20)
    dq_ms = time_ms(torch, lambda: A.flash_bwd_dq(*prep, qseg, kseg, c, scale), iters=20)
    dkv_ms = time_ms(torch, lambda: A.flash_bwd_dkv(*prep, qseg, kseg, c, scale), iters=20)
    plain_fwd_ms = time_ms(torch, lambda: A.flash_attention_ref(q, k, v, c, None, qseg, kseg),
                           iters=5)
    plain_bwd_ms = time_ms(
        torch, lambda: A.flash_attention_bwd_ref(q, k, v, o, lse, do, c, None, qseg, kseg),
        iters=5,
    )
    # yardstick (not used by the port): one SDPA call with the same causal
    # and padding mask, and its backward (its rows with no key are not 0)
    valid = A._attend_mask(B, T, c, qseg, kseg, q.device)
    qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    lib_fwd_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=valid),
                         iters=20)
    out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=valid)
    doh = do.transpose(1, 2).contiguous()
    lib_bwd_ms = time_ms(
        torch, lambda: torch.autograd.grad(out, (qh, kh, vh), doh, retain_graph=True), iters=20
    )
    shape = f"B=8 T=1024 H=Hk=12 D=64 bf16 causal, kv_mask left pads {pads}"
    seg_bytes = 2 * B * T * 4  # query and key segment ids
    out_rows = {}
    for name, tpu, src, rep, ms, plain, lib, kind in [
        ("flash_fwd", "B1", "flash_fwd.cu", "rl_tpu/ops/attention.py:137", fwd_ms,
         plain_fwd_ms, lib_fwd_ms, "fwd"),
        ("flash_bwd_dq", "B2", "flash_bwd.cu", "rl_tpu/ops/attention.py:211", dq_ms,
         plain_bwd_ms, lib_bwd_ms, "dq"),
        ("flash_bwd_dkv", "B2", "flash_bwd.cu", "rl_tpu/ops/attention.py:261", dkv_ms,
         plain_bwd_ms, lib_bwd_ms, "dkv"),
    ]:
        bound_ms, bound_by = flash_bound(q, k, valid, seg_bytes, kind)
        out_rows[name] = {
            "name": name, "tpu_kernel": tpu, "route": "cuda",
            "source": f"rl_tpu_torch/kernels/csrc/{src}", "replaces": rep, "shape": shape,
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib,
        }
    return out_rows


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


# -- phase 5: GRPO training at full width -------------------------------------


def train_phase(torch, card, device="cuda", width=FULL_WIDTH, steps=3, prompt_len=512,
                max_new=512, microbatch=8):
    """``GRPOTrainer`` at GPT-2-small width in bf16 with the flash kernels:
    3 steps of 16 engine rollouts (2 prompts x 8) and a microbatched
    update; the kernels' launch counts are read around the steps."""
    from rl_tpu_torch.envs.llm import arithmetic_dataset
    from rl_tpu_torch.kernels import sampling
    from rl_tpu_torch.models import TransformerConfig, train_step_flops
    from rl_tpu_torch.ops import attention
    from rl_tpu_torch.trainers import GRPOTrainer

    cfg = TransformerConfig(**width, dtype=torch.bfloat16, attention_impl="flash")
    t_build = time.perf_counter()
    trainer = GRPOTrainer(
        arithmetic_dataset(64), model_config=cfg, num_prompts=2, group_repeats=8,
        max_prompt_len=prompt_len, max_new_tokens=max_new, microbatch_size=microbatch,
        continuous_batching=True, device=device,
    )
    build_s = time.perf_counter() - t_build
    master0 = [p.detach().clone() for p in trainer.policy.parameters()]
    n_params = sum(p.numel() for p in trainer.policy.parameters())
    B, T = 16, prompt_len + max_new
    flops = train_step_flops(cfg, n_params, B, T)
    kernels = [attention.flash_fwd, attention.flash_bwd_dq, attention.flash_bwd_dkv,
               attention.paged_flash_decode, sampling.fused_sample]
    for f in kernels:
        f.launches = 0
    outs, per_step = [], []
    t_phase = time.perf_counter()
    for i in range(steps):
        sync(torch, device)
        t0 = time.perf_counter()
        batch = trainer.collect()
        sync(torch, device)
        t1 = time.perf_counter()
        outs.append(trainer.update(batch))
        sync(torch, device)
        t2 = time.perf_counter()
        per_step.append({"step": i + 1, "collect_s": t1 - t0, "update_s": t2 - t1,
                         "update_mfu": flops / (t2 - t1) / PEAK_OPS["bfloat16"],
                         "response_tokens": int(batch["assistant_mask"].sum().item())})
    phase_s = time.perf_counter() - t_phase
    launches = {f.__name__: f.launches for f in kernels}
    final = trainer.metrics_snapshot()
    # update k returns step k-1's metrics (lagged drain); the last step's
    # come from the snapshot
    step_metrics = [outs[i + 1] for i in range(steps - 1)] + [final]
    for rec, m in zip(per_step, step_metrics):
        rec.update(loss=m["loss"], reward=m["reward"], kl_approx=m["kl_approx"],
                   bad_steps=m["bad_steps"])
    with torch.no_grad():
        changed = any(not torch.equal(p0, p) for p0, p in
                      zip(master0, trainer.policy.parameters()))
        serving = dict(trainer.gen_model.named_parameters())
        synced = all(torch.equal(serving[n], p.to(serving[n].dtype))
                     for n, p in trainer.policy.named_parameters())
    version = trainer.policy_version.version
    # the dense-cache generate path: greedy exact-match accuracy
    sync(torch, device)
    t0 = time.perf_counter()
    accuracy = trainer.evaluate(num_prompts=8)
    sync(torch, device)
    evaluate = {"prompts": 8, "accuracy": accuracy, "seconds": time.perf_counter() - t0}
    # profiled after every value the checks read is taken
    prof = profile_update(torch, trainer, batch) if device == "cuda" else None
    emit({"phase": "train", "config": {**width, "dtype": "bfloat16", "attention_impl": "flash",
                                       "num_prompts": 2, "group_repeats": 8,
                                       "max_prompt_len": prompt_len, "max_new_tokens": max_new,
                                       "microbatch_size": microbatch, "n_params": n_params,
                                       "train_step_flops": flops},
          "build_s": build_s, "phase_s": phase_s, "steps": per_step,
          "bad_steps": final["bad_steps"], "policy_version": version,
          "master_changed": changed, "serving_equals_master_bf16": synced,
          "launches": launches, "evaluate": evaluate, "profiled_update": prof, "card": card})
    require(all(np.isfinite(r["loss"]) for r in per_step), "train: non-finite loss")
    require(final["bad_steps"] == 0, f"train: {final['bad_steps']} bad steps")
    require(version == steps, f"train: policy version {version}, not {steps}")
    require(changed, "train: master weights did not change")
    require(synced, "train: serving copy differs from master.to(bf16)")
    require(0.0 <= accuracy <= 1.0, f"train: evaluate accuracy {accuracy}")
    for name, n in launches.items():
        require(n > 0, f"{name} was not launched on the training path")
    return launches


def profile_update(torch, trainer, batch):
    """One more update on the last batch under ``torch.profiler``: device
    time by kernel against the update's wall clock (after the checks, so
    the extra step changes nothing they read)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        trainer.update(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(t for _, t, _ in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:15]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
            "device_launches": sum(c for *_, c in kernels),
            "top_device_ms": [{"kernel": k[:80], "ms": t, "count": c} for k, t, c in top]}


# -- phase 6: flash against dense gradients in float32 --------------------------


def train_check_phase(torch, device="cuda", width=FULL_WIDTH, B=8, T=1024, prompt=512):
    """One left-padded microbatch through the GRPO loss with the flash
    kernels (plain, and under per-block remat "none" and "dots") and with
    dense attention, same float32 weights: loss and every parameter
    gradient within the reference's flash-vs-dense tolerance."""
    from rl_tpu_torch.models import TransformerConfig, TransformerLM, token_log_probs
    from rl_tpu_torch.objectives import GRPOLoss

    rng = np.random.default_rng(3)
    pads = rng.integers(0, prompt, B)
    pads[0], pads[1] = 0, prompt - 1  # no padding; a single real prompt token
    pos = np.arange(T)[None, :]
    attn = pos >= pads[:, None]
    batch = {
        "tokens": torch.from_numpy(rng.integers(0, width["vocab_size"], (B, T))).to(device),
        "attention_mask": torch.from_numpy(attn.astype(np.float32)).to(device),
        "assistant_mask": torch.from_numpy(attn & (pos >= prompt)).to(device),
        "advantage": torch.from_numpy(rng.standard_normal(B).astype(np.float32)).to(device),
    }
    loss_fn = GRPOLoss(lambda m, b: token_log_probs(m, b["tokens"], b["attention_mask"]))
    variants = {"local": dict(attention_impl="local"), "flash": dict(attention_impl="flash"),
                "flash_remat_none": dict(attention_impl="flash", remat=True),
                "flash_remat_dots": dict(attention_impl="flash", remat=True,
                                         remat_policy="dots")}
    models = {name: TransformerLM(TransformerConfig(**width, dtype=torch.float32, **kw),
                                  device=device, seed=0, param_dtype=torch.float32)
              for name, kw in variants.items()}
    with torch.no_grad():  # behavior log-probs near the policy's: ratios near 1
        lp = token_log_probs(models["local"], batch["tokens"], batch["attention_mask"])
        noise = torch.from_numpy(rng.normal(0, 0.05, (B, T)).astype(np.float32)).to(device)
        batch["sample_log_prob"] = lp + noise
    res = {}
    for name, model in models.items():
        loss, _ = loss_fn(model, batch)
        loss.backward()
        res[name] = (loss.item(), {n: p.grad for n, p in model.named_parameters()})
        models[name] = None  # free the model's activations and weights before the next
    sync(torch, device)
    l_loc, g_loc = res.pop("local")
    report = {}
    for name, (loss, grads) in res.items():
        worst, worst_name = None, None
        for n, gl in g_loc.items():
            excess = ((grads[n] - gl).abs() - TRAIN_ATOL - TRAIN_RTOL * gl.abs()).max().item()
            if worst is None or excess > worst:
                worst, worst_name = excess, n
        report[name] = {"loss": loss, "loss_abs_err": abs(loss - l_loc),
                        "worst_grad_excess_over_tol": worst, "worst_param": worst_name}
    emit({"phase": "train_check", "dtype": "float32", "batch": [B, T],
          "pads": pads.tolist(), "loss_local": l_loc, "params": len(g_loc),
          "against_local": report, "rtol": TRAIN_RTOL, "atol": TRAIN_ATOL})
    for name, r in report.items():
        require(r["loss_abs_err"] <= TRAIN_ATOL + TRAIN_RTOL * abs(l_loc),
                f"train_check: {name} loss differs")
        require(r["worst_grad_excess_over_tol"] <= 0.0,
                f"train_check: {name} gradient of {r['worst_param']} off by "
                f"{r['worst_grad_excess_over_tol']} beyond tol")


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
    by_phase = {"serve": serve_phase(torch, card)}
    check_phase(torch)
    by_phase["train"] = train_phase(torch, card)
    train_check_phase(torch)
    order = ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "paged_flash_decode", "fused_sample"]
    for name in order:
        row = rows[name]
        row["launches_by_phase"] = {ph: n.get(name, 0) for ph, n in by_phase.items()}
        row["launches"] = sum(row["launches_by_phase"].values())
        row["card"] = card
    emit({"kernels": [rows[n] for n in order]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
