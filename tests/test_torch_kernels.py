"""The port's three kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version (the tensor lies on
the CPU); it is held against the Pallas kernel run with interpret=True on
the same numpy inputs, float32. The CUDA kernels are held against these
plain versions on the card in test_torch_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import no_compile_cache_writes  # noqa: F401
from rvc_tpu.ops import pallas_retrieval as jret
from rvc_tpu.ops.pallas_attention import banded_rel_attention as jax_attention
from rvc_tpu.ops.pallas_resblock import fused_resblock_group as jax_group
from rvc_tpu_torch.ops import attention, resblock, retrieval


def _chains(rng, C, spec):
    """spec: ((k, dilations), ...) -> numpy chains of (w, b, k, d)."""
    chains = []
    for k, dils in spec:
        chain = []
        for d in dils:
            for dd in (d, 1):
                w = (rng.standard_normal((C, C, k)) / np.sqrt(C * k)).astype(np.float32)
                b = (0.1 * rng.standard_normal(C)).astype(np.float32)
                chain.append((w, b, k, dd))
        chains.append(chain)
    return chains


@pytest.mark.parametrize("C,T,spec", [
    (16, 300, ((3, (1, 3, 5)), (7, (1, 3, 5)), (11, (1, 3, 5)))),
    (8, 77, ((5, (1, 3, 5)),)),
])
def test_resblock_group_plain_matches_pallas(rng, C, T, spec):
    """T is not a multiple of the Pallas tile; the second case is one
    chain. (The Pallas kernel takes exactly 3 units per chain; chains of
    other lengths are covered through GeneratorNSF in test_torch_models.)
    Tolerance 2e-5: float32 sums in another order."""
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    chains = _chains(rng, C, spec)
    ref = jax_group(jnp.asarray(x), [[(jnp.asarray(w), jnp.asarray(b), k, d)
                                      for w, b, k, d in c] for c in chains],
                    S=1, interpret=True)
    got = resblock.fused_resblock_group(
        torch.from_numpy(x),
        [[(torch.from_numpy(w), torch.from_numpy(b), k, d) for w, b, k, d in c]
         for c in chains])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


def _attention_inputs(rng, B=3, H=2, T=70, D=8, w=10):
    q, k, v = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(3))
    ek, ev = ((D ** -0.5) * rng.standard_normal((2 * w + 1, D)).astype(np.float32)
              for _ in range(2))
    lengths = np.array([T, T - 17, T // 3], np.int32)
    return q, k, v, ek, ev, lengths


def test_banded_attention_plain_matches_pallas(rng):
    """lengths < T on two rows: rows past the length are the reference's
    uniform softmax. All rows are compared. Tolerance 2e-5 (float32)."""
    q, k, v, ek, ev, lengths = _attention_inputs(rng)
    w, scale = 10, 8 ** -0.5
    ref = jax_attention(*map(jnp.asarray, (q, k, v, ek, ev, lengths)), window=w,
                        scale=scale, interpret=True)
    got = attention.banded_rel_attention(*map(torch.from_numpy, (q, k, v, ek, ev, lengths)),
                                         window=w, scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


def _bank(rng, N=2 * jret.TN + 500, D=32, T=40):
    """Gaussian data: the gap between a query's two nearest rows is far above
    float32 rounding, so the nearest row is the same for any summation order."""
    return (rng.standard_normal((T, D)).astype(np.float32),
            rng.standard_normal((N, D)).astype(np.float32))


def test_quantize_bank_matches_jax(rng):
    _, bank = _bank(rng)
    q, s = retrieval.quantize_bank(bank)
    jq, js = jret.quantize_bank(bank)
    np.testing.assert_array_equal(q, np.asarray(jq))
    np.testing.assert_array_equal(s, np.asarray(js))


@pytest.mark.parametrize("int8", [True, False])
def test_nearest_rows_plain_matches_pallas(rng, int8):
    """Same nearest rows (hence indices) as the Pallas kernel in both bank
    modes, over a bank of 3 Pallas tiles; the blend within 1e-6."""
    feats, bank = _bank(rng)
    if int8:
        bq, s = (np.array(a) for a in jret.quantize_bank(bank))
        ref = jret.nearest_rows_q(jnp.asarray(feats), jnp.asarray(bq), jnp.asarray(s),
                                  interpret=True)
        got = retrieval.nearest_rows_q(torch.from_numpy(feats), torch.from_numpy(bq),
                                       torch.from_numpy(s))
    else:
        ref = jret.nearest_rows(jnp.asarray(feats), jnp.asarray(bank), interpret=True)
        got = retrieval.nearest_rows(torch.from_numpy(feats), torch.from_numpy(bank))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    if int8:
        f3 = feats.reshape(2, 20, -1)
        ref_b = jret.blend_into_q(jnp.asarray(f3), jnp.asarray(bq), jnp.asarray(s), 0.75,
                                  interpret=True)
        got_b = retrieval.blend_into_q(torch.from_numpy(f3), torch.from_numpy(bq),
                                       torch.from_numpy(s), 0.75)
        np.testing.assert_allclose(got_b.numpy(), np.asarray(ref_b), atol=1e-6)
