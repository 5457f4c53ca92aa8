"""The fused sampler's row split, and a plain model of its two passes and
its last-block reduction, against the JAX package on the CPU.

On a CUDA tensor ``fused_sample`` (without top-k) cuts each row into the
``C`` chunks of ``sample_plan``. The first kernel writes each chunk's max
and its exp-sum at that max (and, greedy, the chunk's argmax of the raw
logits); the second merges a row's C pairs into (mx, lse), scores each
chunk's noise + ((x / t - mx) - lse), and the last block of the row to
finish reduces the C candidates, first index on ties.
``split_sample_model`` below does the same arithmetic in plain PyTorch
(merging the pairs in chunk order, where the kernel takes a shuffle tree:
the two differ in rounding only), with the blocks finishing in any
order. It is held to the reference's ``_kernel_body`` and to its Pallas
kernel in interpret mode, on the same numpy noise: tokens equal,
log-probs within 1e-5 (``TOL_SAMPLE_LP`` in ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_tpu.kernels.sampling import _kernel_body
from rl_tpu.kernels.sampling import fused_sample as jax_fused_sample
from rl_tpu_torch.kernels import sampling

torch.set_num_threads(1)

NEG_INF = float("-inf")


def split_sample_model(logits, noise, temperature=1.0, greedy=False, C=None, finish=None):
    """The split route's arithmetic. ``C``: chunks a row (default
    ``sample_plan``'s); ``finish``: the order in which a row's chunk
    blocks finish the second pass (default: chunk order). Returns ``(tok
    [S] int32, lp [S] float32)``."""
    x = logits.float()  # bf16 widened exactly
    S, V = x.shape
    if C is None:
        C, chunk = sampling.sample_plan(S, V)
    else:
        chunk = -(-V // C)
        C = -(-V // chunk)
    t = torch.clamp(torch.tensor(temperature, dtype=torch.float32), min=1e-6)
    xs = x / t
    toks, lps = [], []
    for r in range(S):
        spans = [slice(c * chunk, min(V, (c + 1) * chunk)) for c in range(C)]
        # pass 1: each chunk's max and exp-sum at it (and greedy argmax)
        ms, ss, cands = [], [], []
        for sl in spans:
            m = xs[r, sl].max()
            fin = xs[r, sl] != NEG_INF
            s = torch.exp(xs[r, sl][fin] - m).sum() if bool(fin.any()) else torch.tensor(0.0)
            ms.append(m)
            ss.append(s)
            if greedy:
                i = int(torch.argmax(x[r, sl]))
                cands.append((x[r, sl][i], sl.start + i))
        # pass 2: the row's (mx, lse) in chunk order
        mx = torch.stack(ms).max()
        total = torch.tensor(0.0)
        for m, s in zip(ms, ss):
            if m != NEG_INF:
                total = total + s * torch.exp(m - mx)
        lse = torch.log(total)
        if not greedy:
            for sl in spans:
                sc = noise[r, sl].float() + ((xs[r, sl] - mx) - lse)
                i = int(torch.argmax(sc))
                cands.append((sc[i], sl.start + i))
        # the last block: the candidates in the order their blocks finished,
        # the larger value winning, the smaller index on ties
        order = range(len(cands)) if finish is None else finish
        best, bi = NEG_INF, None
        for j in order:
            v, i = cands[j]
            if v > best or (v == best and (bi is None or i < bi)):
                best, bi = float(v), i
        tok = 0 if bi is None else bi
        toks.append(tok)
        lps.append((xs[r, tok] - mx) - lse)
    return torch.tensor(toks, dtype=torch.int32), torch.stack(lps).float()


def inputs(seed, S, V, ties=()):
    """Logits x 3 and gumbel noise; ``ties``: (row, i, j) pairs of indices
    made exact ties under greedy and under sampling."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((S, V)) * 3).astype(np.float32)
    g = rng.gumbel(size=(S, V)).astype(np.float32)
    for r, i, j in ties:
        x[r, i] = x[r, j] = x[r].max() + 1.0
        g[r, i] = g[r, j] = 50.0
    return x, g


def hold_to_kernel_body(x, g, temperature, greedy, **model_kw):
    tok, lp = split_sample_model(torch.from_numpy(x), torch.from_numpy(g), temperature, greedy,
                                 **model_kw)
    t = jnp.maximum(jnp.asarray(temperature, jnp.float32), 1e-6)
    jtok, jlp = _kernel_body(jnp.asarray(x), jnp.asarray(g), t, greedy=greedy, top_k=0)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=1e-5, rtol=0)
    return tok


# C from 1 to 64 on rows of 4000 entries: 4000 is no multiple of the
# chunk at C = 3, 16 or 64 (chunks of 1334, 250 and 63)
@pytest.mark.parametrize("C", [1, 3, 16, 64])
def test_model_matches_kernel_body(C):
    x, g = inputs(C, S=4, V=4000)
    for temperature, greedy in ((1.0, True), (1.0, False), (0.7, False), (1e-9, False)):
        hold_to_kernel_body(x, g, temperature, greedy, C=C)


def test_ties_across_chunk_boundaries_go_to_the_first_index():
    # chunks of 2048 (sample_plan at V = 32768): 100 and 30000 lie in chunks
    # 0 and 14; 2047 and 2048 on either side of the first boundary
    x, g = inputs(7, S=2, V=32768, ties=[(0, 100, 30000), (1, 2047, 2048)])
    assert sampling.sample_plan(2, 32768) == (16, 2048)
    for temperature, greedy in ((1.0, True), (1.0, False), (0.7, False)):
        tok = hold_to_kernel_body(x, g, temperature, greedy)
        assert tok.tolist() == [100, 2047]


def test_bf16_logits_are_widened_as_float():
    x, g = inputs(8, S=3, V=5000)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    xw = xb.float().numpy()
    for greedy in (True, False):
        tok, lp = split_sample_model(xb, torch.from_numpy(g), 0.8, greedy)
        t = jnp.asarray(0.8, jnp.float32)
        jtok, jlp = _kernel_body(jnp.asarray(xw), jnp.asarray(g), t, greedy=greedy, top_k=0)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=1e-5, rtol=0)


@pytest.mark.parametrize("greedy,temperature", [(True, 1.0), (False, 1.0), (False, 0.6)])
def test_matches_pallas_kernel_interpret(monkeypatch, greedy, temperature):
    """The JAX ``fused_sample`` kernel in interpret mode draws its gumbel
    noise from the key as ``jax.random.gumbel`` does; the same noise goes
    to the model. V = 50257 is no multiple of the chunk."""
    monkeypatch.setenv("RL_TPU_KERNELS_INTERPRET", "1")
    x, _ = inputs(9, S=2, V=50257)
    key = jax.random.key(5)
    g = np.array(jax.random.gumbel(key, x.shape, jnp.float32))
    jtok, jlp = jax_fused_sample(jnp.asarray(x), key, temperature=temperature, greedy=greedy)
    tok, lp = split_sample_model(torch.from_numpy(x), torch.from_numpy(g), temperature, greedy)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=1e-5, rtol=0)


def test_row_of_neg_inf_but_one_entry():
    """Every chunk but one holds only -inf (max -inf, sum 0), which the
    merge must skip: the one entry is the token, with log-prob 0."""
    x, g = inputs(10, S=2, V=32768)
    x[1] = NEG_INF
    x[1, 20000] = 2.5
    for greedy in (True, False):
        tok = hold_to_kernel_body(x, g, 1.0, greedy)
        assert int(tok[1]) == 20000


def test_last_block_result_does_not_depend_on_the_finish_order():
    x, g = inputs(11, S=3, V=32768, ties=[(0, 5, 31000)])
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    base = split_sample_model(xt, gt)
    for seed in range(3):
        order = np.random.default_rng(seed).permutation(16).tolist()
        tok, lp = split_sample_model(xt, gt, finish=order)
        assert torch.equal(tok, base[0]) and torch.equal(lp, base[1])


def test_sample_plan_fills_the_card_from_the_shapes():
    assert sampling.sample_plan(8, 32768) == (16, 2048)  # the serve and train shape
    assert sampling.sample_plan(1, 32768) == (16, 2048)  # no chunk below 2048
    assert sampling.sample_plan(64, 32768) == (2, 16384)
    assert sampling.sample_plan(8, 32000) == (15, 2134)
    assert sampling.sample_plan(8, 50257) == (16, 3142)
    assert sampling.sample_plan(256, 32768) == (1, 32768)
    assert sampling.sample_plan(4, 100) == (1, 100)
    for S in (1, 3, 8, 64, 200):
        for V in (1, 100, 2048, 32000, 50257):
            C, chunk = sampling.sample_plan(S, V)
            assert (C - 1) * chunk < V <= C * chunk  # no chunk empty, none missing
            assert C == 1 or chunk >= sampling.SAMPLE_MIN_CHUNK


@pytest.mark.cuda
def test_kernel_matches_model_on_card():
    """The CUDA kernel against the model, float32 and bf16 logits
    (skipped without a card; ``chip_smoke.py`` holds it to the plain
    version at the serving shape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    x, g = inputs(12, S=8, V=32768, ties=[(0, 100, 30000)])
    for dtype in (torch.float32, torch.bfloat16):
        xt = torch.from_numpy(x).to(dtype)
        for greedy in (True, False):
            tok, lp = sampling.fused_sample(xt.cuda(), torch.from_numpy(g).cuda(),
                                            temperature=0.8, greedy=greedy)
            mtok, mlp = split_sample_model(xt, torch.from_numpy(g), 0.8, greedy)
            assert torch.equal(tok.cpu(), mtok)
            assert (lp.cpu() - mlp).abs().max().item() <= 1e-5
