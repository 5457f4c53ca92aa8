"""The port's kernel modules against the JAX package, on the CPU.

On CPU tensors the wrappers run their plain PyTorch versions, so these
tests hold ``paged_flash_decode_ref`` and ``fused_sample_ref`` to the
reference: the Pallas paged-decode kernel in interpret mode and the XLA
gather read of the paged cache, and the fused-sampling kernel body with
the SAME numpy gumbel noise. Float32 throughout; tolerances: 1e-5 for
attention (different summation order), tokens exact and 1e-6 for
log-probs in sampling (one exp-sum reordered), top-k included. The CUDA
kernels themselves are held to these plain versions on the card by
``chip_smoke.py`` and by the ``cuda``-marked test below.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl_tpu.kernels.sampling import _kernel_body
from rl_tpu.models.transformer import TransformerConfig as JaxConfig
from rl_tpu.models.transformer import _paged_attention as jax_paged_attention
from rl_tpu.ops.attention import paged_flash_decode as jax_paged_flash_decode
from rl_tpu_torch import default_device
from rl_tpu_torch.kernels import _build
from rl_tpu_torch.kernels.sampling import fused_sample, fused_sample_ref, gumbel_like
from rl_tpu_torch.ops.attention import paged_flash_decode, paged_flash_decode_ref

torch.set_num_threads(1)


def paged_inputs(seed, S, H, Hk, D, block, max_blocks, N, lens, holes=False):
    rng = np.random.default_rng(seed)
    pool_k = rng.standard_normal((N, Hk, block, D)).astype(np.float32)
    pool_v = rng.standard_normal((N, Hk, block, D)).astype(np.float32)
    q = rng.standard_normal((S, 1, H, D)).astype(np.float32)
    table = np.full((S, max_blocks), -1, np.int32)
    perm = rng.permutation(np.arange(1, N))
    used = 0
    for s, L in enumerate(lens):
        nb = -(-L // block)
        table[s, :nb] = perm[used : used + nb]
        used += nb
    if holes:  # an unassigned and a scratch entry inside the longest range
        s = int(np.argmax(lens))
        table[s, 0] = -1
        table[s, 2] = 0
    return q, pool_k, pool_v, table, np.asarray(lens, np.int32)


# lengths at block edges (8, 16, 24), one short of and one past them
DECODE_CASES = {
    "mha": dict(S=4, H=4, Hk=4, D=16, block=8, max_blocks=4, N=20, lens=[8, 9, 16, 31]),
    "gqa": dict(S=4, H=4, Hk=2, D=16, block=8, max_blocks=4, N=20, lens=[1, 7, 24, 32]),
    "mha_holes": dict(S=3, H=2, Hk=2, D=32, block=4, max_blocks=8, N=24, lens=[4, 12, 29],
                      holes=True),
    "gqa_holes": dict(S=3, H=6, Hk=2, D=16, block=8, max_blocks=4, N=16, lens=[5, 16, 30],
                      holes=True),
}


def run_ref(q, pool_k, pool_v, table, lens):
    out = paged_flash_decode(*(torch.from_numpy(a) for a in (q, pool_k, pool_v, table, lens)))
    ref = paged_flash_decode_ref(*(torch.from_numpy(a) for a in (q, pool_k, pool_v, table, lens)))
    np.testing.assert_array_equal(out.numpy(), ref.numpy())  # CPU wrapper == plain version
    return out.numpy()


class TestPagedFlashDecode:
    @pytest.mark.parametrize("case", sorted(DECODE_CASES))
    def test_matches_pallas_kernel_interpret(self, case):
        q, pk, pv, table, lens = paged_inputs(0, **DECODE_CASES[case])
        out = run_ref(q, pk, pv, table, lens)
        ref = jax_paged_flash_decode(
            jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(table),
            jnp.asarray(lens), interpret=True,
        )
        np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5, rtol=0)

    @pytest.mark.parametrize("case", sorted(DECODE_CASES))
    def test_matches_xla_gather_read(self, case):
        """The JAX model's T=1 gather read of the paged cache: writing the
        row already stored at position len (a no-op write) and attending
        positions 0..len is paged decode with attend_lens = len + 1."""
        kw = DECODE_CASES[case]
        q, pk, pv, table, attend = paged_inputs(1, **kw)
        S, H, Hk, D, block = kw["S"], kw["H"], kw["Hk"], kw["D"], kw["block"]
        lens = attend - 1
        blk = table[np.arange(S), lens // block]
        live = blk > 0  # the no-op write needs a real block under position len
        k_row = np.where(live[:, None, None], pk[np.maximum(blk, 0), :, lens % block], 0)
        v_row = np.where(live[:, None, None], pv[np.maximum(blk, 0), :, lens % block], 0)
        cfg = JaxConfig(vocab_size=8, d_model=H * D, n_heads=H, n_kv_heads=Hk,
                        d_ff=8, dtype=jnp.float32)
        cache = {"pool_k": jnp.asarray(pk), "pool_v": jnp.asarray(pv),
                 "block_table": jnp.asarray(table), "len": jnp.asarray(lens)}
        o, new_cache = jax_paged_attention(
            cfg, jnp.asarray(q), jnp.asarray(k_row[:, None]), jnp.asarray(v_row[:, None]),
            cache, jnp.asarray(live),
        )
        out = run_ref(q, pk, pv, table, attend)
        np.testing.assert_allclose(out[live], np.asarray(o)[live], atol=1e-5, rtol=0)
        np.testing.assert_array_equal(np.asarray(new_cache["pool_k"]), pk)

    def test_no_attended_key_gives_zeros(self):
        q, pk, pv, table, lens = paged_inputs(2, S=3, H=2, Hk=1, D=8, block=4,
                                              max_blocks=2, N=6, lens=[0, 4, 5])
        table[1, 0] = -1  # slot 1: its only block unassigned
        out = run_ref(q, pk, pv, table, lens)
        assert np.all(out[0] == 0) and np.all(out[1] == 0) and np.any(out[2] != 0)

    def test_non_cpu_tensor_raises_instead_of_falling_back(self):
        args = [torch.empty((2, 1, 4, 32), device="meta"),
                torch.empty((4, 4, 8, 32), device="meta"),
                torch.empty((4, 4, 8, 32), device="meta"),
                torch.empty((2, 4), dtype=torch.int32, device="meta"),
                torch.empty((2,), dtype=torch.int32, device="meta")]
        with pytest.raises(ValueError, match="CUDA"):
            paged_flash_decode(*args)


def sample_inputs(seed, S=6, V=50):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((S, V)) * 3).astype(np.float32)
    g = rng.gumbel(size=(S, V)).astype(np.float32)
    # exact ties: row 0 under greedy argmax, row 1 under gumbel + lps
    x[0, 7] = x[0, 30] = x[0].max() + 1.0
    x[1, 4] = x[1, 40] = x[1].max() + 1.0
    g[1, 4] = g[1, 40] = 50.0
    return x, g


class TestFusedSample:
    @pytest.mark.parametrize(
        "greedy,temperature,top_k",
        [(True, 1.0, 0), (False, 1.0, 0), (False, 0.7, 0), (False, 1.3, 5),
         (True, 0.5, 3), (False, 1e-9, 0)],
    )
    def test_matches_kernel_body_on_same_noise(self, greedy, temperature, top_k):
        x, g = sample_inputs(0)
        tok, lp = fused_sample(torch.from_numpy(x), torch.from_numpy(g),
                               temperature=temperature, greedy=greedy, top_k=top_k)
        t = jnp.maximum(jnp.asarray(temperature, jnp.float32), 1e-6)
        jtok, jlp = _kernel_body(jnp.asarray(x), jnp.asarray(g), t, greedy=greedy, top_k=top_k)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=1e-6, rtol=0)
        assert tok.dtype == torch.int32 and lp.dtype == torch.float32

    @pytest.mark.parametrize("greedy,temperature,top_k", [
        (False, 1.0, 1), (False, 0.8, 5), (True, 0.7, 3), (False, 1.2, 49),
    ])
    def test_top_k_matches_pallas_interpret(self, monkeypatch, greedy, temperature, top_k):
        """The JAX ``fused_sample`` kernel in interpret mode draws its gumbel
        noise from the key exactly as ``jax.random.gumbel`` does; the same
        noise goes to the port. Row 2 holds three exact ties at the k-th
        largest value (all of them kept by the value threshold)."""
        import jax

        from rl_tpu.kernels.sampling import fused_sample as jax_fused_sample

        monkeypatch.setenv("RL_TPU_KERNELS_INTERPRET", "1")
        x, _ = sample_inputs(2)
        order = np.argsort(-x[2], kind="stable")
        kth = max(top_k - 1, 0)
        x[2, order[kth : kth + 3]] = x[2, order[kth]]
        key = jax.random.key(11)
        g = np.array(jax.random.gumbel(key, x.shape, jnp.float32))
        jtok, jlp = jax_fused_sample(jnp.asarray(x), key, temperature=temperature,
                                     greedy=greedy, top_k=top_k)
        tok, lp = fused_sample(torch.from_numpy(x), torch.from_numpy(g),
                               temperature=temperature, greedy=greedy, top_k=top_k)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=1e-6, rtol=0)

    def test_ties_go_to_first_index(self):
        x, g = sample_inputs(1)
        tok, _ = fused_sample_ref(torch.from_numpy(x), None, greedy=True)
        assert int(tok[0]) == 7
        tok, _ = fused_sample_ref(torch.from_numpy(x), torch.from_numpy(g), greedy=False)
        assert int(tok[1]) == 4

    def test_gumbel_like_is_seeded_and_standard(self):
        x = torch.zeros(64, 512)
        a = gumbel_like(x, torch.Generator().manual_seed(3))
        b = gumbel_like(x, torch.Generator().manual_seed(3))
        assert torch.equal(a, b) and a.dtype == torch.float32
        assert abs(a.mean().item() - 0.5772) < 0.02  # Euler-Mascheroni
        assert abs(a.var().item() - np.pi**2 / 6) < 0.1

    def test_non_cpu_tensor_raises_instead_of_falling_back(self):
        x = torch.empty((2, 16), device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            fused_sample(x, x, temperature=1.0, greedy=False)


class TestNoFallback:
    def test_build_without_nvcc_raises(self, monkeypatch, tmp_path):
        import torch.utils.cpp_extension as cpp

        monkeypatch.setattr(_build.shutil, "which", lambda name: None)
        monkeypatch.setattr(cpp, "CUDA_HOME", None)
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build_all()

    def test_default_device_never_picks_the_cpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            default_device()


@pytest.mark.cuda
class TestOnCard:
    """Kernels against their plain versions on the card (skipped without
    one; ``chip_smoke.py`` runs the full set at the serving shapes)."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card and nvcc")

    @pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
    def test_paged_decode_kernel(self, dtype, tol):
        for case in DECODE_CASES.values():
            kw = dict(case, D=32)
            args = [torch.from_numpy(a).cuda() for a in paged_inputs(3, **kw)]
            args[:3] = [a.to(dtype) for a in args[:3]]
            out = paged_flash_decode(*args)
            ref = paged_flash_decode_ref(*args)
            assert (out.float() - ref.float()).abs().max().item() <= tol

    @pytest.mark.parametrize("top_k", [0, 1, 40])
    def test_fused_sample_kernel(self, top_k):
        x, g = sample_inputs(4, S=8, V=32768)
        for greedy in (True, False):
            tok, lp = fused_sample(torch.from_numpy(x).cuda(), torch.from_numpy(g).cuda(),
                                   temperature=0.8, greedy=greedy, top_k=top_k)
            rtok, rlp = fused_sample_ref(torch.from_numpy(x).cuda(), torch.from_numpy(g).cuda(),
                                         temperature=0.8, greedy=greedy, top_k=top_k)
            assert torch.equal(tok, rtok)
            assert (lp - rlp).abs().max().item() <= 1e-5
