"""The port's kernels in bfloat16 against the JAX package's Pallas kernels
in bfloat16, on the CPU.

Each wrapper runs its plain version here (the tensors lie on the CPU),
which rounds where the bf16 kernel on the card rounds; it is held against
the Pallas kernel run with interpret=True on the same bf16 inputs: kernel
1 (``fused_resblock_group``), kernel 8 (``scripts/bench_resblock_v2.py::
fused_resblock1_v2``, imported from its path), kernel 2
(``banded_rel_attention``), and kernel 3's blend with bf16 features.

Bars, fixed before the first run: the JAX package holds its own bf16
kernels to atol = rtol = 0.05 against the unfused path
(tests/test_pallas_resblock.py:61-63, :281-283). Here both sides round at
the same points and differ only in the order of float32 sums (and in
where XLA keeps excess precision), so a rounding flips by one bf16 ulp now
and then: the largest difference must stay within 1e-2 of the largest
magnitude, and at most 1% of the elements may lie more than one bf16 ulp
apart. The share of elements that differ at all and of those more than one
ulp apart is printed."""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import no_compile_cache_writes  # noqa: F401
from rvc_tpu.ops import pallas_retrieval as jret
from rvc_tpu.ops.pallas_attention import banded_rel_attention as jax_attention
from rvc_tpu.ops.pallas_resblock import fused_resblock_group as jax_group
from rvc_tpu_torch.ops import attention, resblock, retrieval

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_REL = 1e-2     # of the largest magnitude
MAX_BEYOND = 0.01  # share of elements more than one bf16 ulp apart


def _v2():
    """scripts/bench_resblock_v2.py as a module (the script is not a package)."""
    spec = importlib.util.spec_from_file_location(
        "bench_resblock_v2", os.path.join(REPO, "scripts", "bench_resblock_v2.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bf16_ulp(v: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |v| (8 significant bits)."""
    a = np.maximum(np.abs(v.astype(np.float32)), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(a)) - 7).astype(np.float32)


def agreement(got: np.ndarray, ref: np.ndarray, what: str) -> tuple[float, float]:
    """(max |got - ref| / max |ref|, share more than one ulp apart), printed."""
    got, ref = got.astype(np.float32), ref.astype(np.float32)
    diff = np.abs(got - ref)
    rel = float(diff.max() / np.abs(ref).max())
    beyond = float(np.mean(diff > bf16_ulp(ref)))
    print(f"{what}: max |diff| {rel:.3g} of the largest magnitude, elements that differ "
          f"{np.mean(diff > 0):.4%}, more than one bf16 ulp apart {beyond:.4%}")
    return rel, beyond


def to_bf16(a: np.ndarray) -> tuple[jnp.ndarray, torch.Tensor]:
    """The same bf16 values on both sides (round to nearest even)."""
    t = torch.from_numpy(a).bfloat16()
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


def _chains(rng, C, spec):
    """spec: ((k, dilations), ...) -> numpy chains of (w, b, k, d), float32."""
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


def _jax_chain(c):
    return [(jnp.asarray(w), jnp.asarray(b), k, d) for w, b, k, d in c]


def _torch_chain(c):
    return [(torch.from_numpy(w), torch.from_numpy(b), k, d) for w, b, k, d in c]


STAGE = ((3, (1, 3, 5)), (7, (1, 3, 5)), (11, (1, 3, 5)))


@pytest.mark.parametrize("C,T", [(16, 300), (32, 77)])
def test_resblock_group_bf16_plain_matches_pallas(rng, C, T):
    """Kernel 1 in bf16: a decoder stage's three chains (k 3, 7, 11,
    dilations 1, 3, 5), T not a multiple of the Pallas tile."""
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    chains = _chains(rng, C, STAGE)
    xj, xt = to_bf16(x)
    ref = jax_group(xj, [_jax_chain(c) for c in chains], S=1, interpret=True)
    got = resblock.fused_resblock_group(xt, [_torch_chain(c) for c in chains])
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    rel, beyond = agreement(got.float().numpy(), np.asarray(ref, np.float32),
                            f"kernel 1 bf16, C={C}, T={T}")
    assert rel <= MAX_REL and beyond <= MAX_BEYOND


@pytest.mark.parametrize("C,T,k", [(16, 300, 11), (32, 77, 3)])
def test_resblock1_v2_plain_matches_pallas(rng, C, T, k):
    """Kernel 8: one chain with the bf16 carry, against the Pallas
    prototype of scripts/bench_resblock_v2.py at S = 1."""
    v2 = _v2()
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    (chain,) = _chains(rng, C, ((k, (1, 3, 5)),))
    xj, xt = to_bf16(x)
    ref = v2.fused_resblock1_v2(xj, _jax_chain(chain), S=1, interpret=True)
    got = resblock.fused_resblock1_v2(xt, _torch_chain(chain))
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    rel, beyond = agreement(got.float().numpy(), np.asarray(ref, np.float32),
                            f"kernel 8, C={C}, T={T}, k={k}")
    assert rel <= MAX_REL and beyond <= MAX_BEYOND


def test_resblock_group_bf16_is_its_chains_averaged(rng):
    """The default route (kernel 1) and the fuse_group=False route (kernel 8
    per chain, the chains added in order in bf16 and divided once) give the
    same bits: the same rounding order."""
    from rvc_tpu_torch.models.nsf import mean_of

    x = torch.from_numpy(rng.standard_normal((2, 90, 16)).astype(np.float32)).bfloat16()
    chains = [_torch_chain(c) for c in _chains(rng, 16, STAGE)]
    group = resblock.fused_resblock_group(x, chains)
    per_chain = mean_of([resblock.fused_resblock1_v2(x, c) for c in chains])
    assert torch.equal(group, per_chain)


def test_banded_attention_bf16_plain_matches_pallas(rng):
    """Kernel 2 in bf16 at the 48k_v2 head width (D = 96), window 10, two
    rows with lengths < T (rows past the length are uniform)."""
    B, H, T, D, w = 3, 2, 150, 96, 10
    q, k, v = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(3))
    ek, ev = ((D ** -0.5) * rng.standard_normal((2 * w + 1, D)).astype(np.float32)
              for _ in range(2))
    lengths = np.array([T, T - 17, T // 3], np.int32)
    pairs = [to_bf16(a) for a in (q, k, v, ek, ev)]
    scale = D ** -0.5
    ref = jax_attention(*[p[0] for p in pairs], jnp.asarray(lengths), window=w, scale=scale,
                        interpret=True)
    got = attention.banded_rel_attention(*[p[1] for p in pairs], torch.from_numpy(lengths),
                                         window=w, scale=scale)
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    rel, beyond = agreement(got.float().numpy(), np.asarray(ref, np.float32),
                            "kernel 2 bf16")
    assert rel <= MAX_REL and beyond <= MAX_BEYOND


def test_blend_into_q_bf16_matches_pallas(rng):
    """bf16 features go up to float32 exactly, through the float32 search,
    and the blend comes back in bf16 (no kernel of its own): the same
    nearest rows, so the same bf16 blend up to the float32 sum's rounding."""
    feats = rng.standard_normal((2, 20, 32)).astype(np.float32)
    bank = rng.standard_normal((2 * jret.TN + 500, 32)).astype(np.float32)
    bq, s = (np.array(a) for a in jret.quantize_bank(bank))
    fj, ft = to_bf16(feats)
    ref = jret.blend_into_q(fj, jnp.asarray(bq), jnp.asarray(s), 0.75, interpret=True)
    got = retrieval.blend_into_q(ft, torch.from_numpy(bq), torch.from_numpy(s), 0.75)
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    rel, beyond = agreement(got.float().numpy(), np.asarray(ref, np.float32),
                            "kernel 3 blend, bf16 features")
    assert beyond == 0.0 and rel <= MAX_REL


def test_bf16_wrappers_count_only_kernel_launches(rng):
    """On CPU tensors the bf16 routes run their plain versions and count
    nothing; kernel 8 refuses float32 activations."""
    counts = lambda: (resblock.fused_resblock_group.launches,  # noqa: E731
                      resblock.fused_resblock_group.launches_bf16,
                      resblock.fused_resblock1_v2.launches,
                      attention.banded_rel_attention.launches,
                      attention.banded_rel_attention.launches_bf16)
    before = counts()
    x = torch.from_numpy(rng.standard_normal((1, 20, 16)).astype(np.float32)).bfloat16()
    chain = _torch_chain(_chains(rng, 16, ((3, (1, 3, 5)),))[0])
    resblock.fused_resblock_group(x, [chain])
    resblock.fused_resblock1_v2(x, chain)
    q = torch.zeros(1, 1, 8, 32, dtype=torch.bfloat16)
    e = torch.zeros(3, 32, dtype=torch.bfloat16)
    attention.banded_rel_attention(q, q, q, e, e, torch.tensor([8]), window=1, scale=0.5)
    assert counts() == before
    with pytest.raises(ValueError, match="bfloat16"):
        resblock.fused_resblock1_v2(x.float(), chain)
