"""The CUDA kernels against their plain PyTorch versions, on the card.

Needs a CUDA card and no JAX; every test here skips without a card. On the
card's machine (which has no JAX, so the repository's conftest cannot load):

    python -m pytest tests/test_torch_gpu.py --noconftest -q -m gpu
"""
import numpy as np
import pytest
import torch

from rvc_tpu_torch.ops import attention, resblock, retrieval


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


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


def _attention_inputs(rng, B=3, H=2, T=70, D=8, w=10):
    q, k, v = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(3))
    ek, ev = ((D ** -0.5) * rng.standard_normal((2 * w + 1, D)).astype(np.float32)
              for _ in range(2))
    lengths = np.array([T, T - 17, T // 3], np.int32)
    return q, k, v, ek, ev, lengths


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("C,T", [(256, 1000), (128, 3001), (64, 777), (32, 5000)])
def test_resblock_kernel_matches_plain(rng, cuda, C, T):
    x = torch.from_numpy(rng.standard_normal((2, T, C)).astype(np.float32)).to(cuda)
    chains = [[(torch.from_numpy(w).to(cuda), torch.from_numpy(b).to(cuda), k, d)
               for w, b, k, d in c]
              for c in _chains(rng, C, ((3, (1, 3, 5)), (7, (1, 3, 5)), (11, (1, 3, 5))))]
    n = resblock.fused_resblock_group.launches
    got = resblock.fused_resblock_group(x, chains)
    torch.cuda.synchronize()
    assert resblock.fused_resblock_group.launches == n + 9
    ref = resblock.resblock_group_plain(x, chains)
    torch.testing.assert_close(got, ref, atol=5e-5, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("T,D", [(70, 96), (1937, 96), (300, 32), (300, 128)])
def test_attention_kernel_matches_plain(rng, cuda, T, D):
    args = [torch.from_numpy(a).to(cuda) for a in _attention_inputs(rng, T=T, D=D)]
    got = attention.banded_rel_attention(*args, window=10, scale=D ** -0.5)
    torch.cuda.synchronize()
    ref = attention.banded_rel_attention_plain(*args, window=10, scale=D ** -0.5)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [True, False])
def test_nearest_rows_kernel_matches_plain(rng, cuda, int8):
    feats = rng.standard_normal((300, 768)).astype(np.float32)
    bank = rng.standard_normal((20000, 768)).astype(np.float32)
    f = torch.from_numpy(feats).to(cuda)
    if int8:
        bq, s = (torch.from_numpy(a).to(cuda) for a in retrieval.quantize_bank(bank))
        got = retrieval.nearest_rows_q(f, bq, s)
        ref = retrieval.topk_blend(f, bq.float() * s)
    else:
        b = torch.from_numpy(bank).to(cuda)
        got = retrieval.nearest_rows(f, b)
        ref = retrieval.topk_blend(f, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("C,T,spec", [
    (32, 1, ((3, (1, 3, 5)),)),
    (256, 3, ((11, (1, 3, 5)), (3, (1, 3, 5)))),
    (16, 50, ((3, (1, 3)), (5, (1, 2)))),
])
def test_resblock_kernel_edges(rng, cuda, C, T, spec):
    """Sequences shorter than the kernels' reach, one and two chains, chains
    of 2 units, the smallest C the kernel takes."""
    x = torch.from_numpy(rng.standard_normal((2, T, C)).astype(np.float32)).to(cuda)
    chains = [[(torch.from_numpy(w).to(cuda), torch.from_numpy(b).to(cuda), k, d)
               for w, b, k, d in c] for c in _chains(rng, C, spec)]
    got = resblock.fused_resblock_group(x, chains)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, resblock.resblock_group_plain(x, chains),
                               atol=5e-5, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("T,lengths", [(1, [1, 0, 1]), (5, [5, 0, 2]), (65, [65, 64, 1])])
def test_attention_kernel_edges(rng, cuda, T, lengths):
    """One-row and one-tile sequences, a length of 0 (every row uniform)."""
    q, k, v, ek, ev, _ = _attention_inputs(rng, T=T, D=64)
    args = [torch.from_numpy(a).to(cuda) for a in (q, k, v, ek, ev)]
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    got = attention.banded_rel_attention(*args, lens, window=10, scale=0.125)
    torch.cuda.synchronize()
    ref = attention.banded_rel_attention_plain(*args, lens, window=10, scale=0.125)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("NQ,N", [(1, 5), (33, 129), (7, 128)])
def test_nearest_rows_kernel_edges(rng, cuda, NQ, N):
    """Banks smaller than, equal to and one past a 128-row tile; one query."""
    f = torch.from_numpy(rng.standard_normal((NQ, 32)).astype(np.float32)).to(cuda)
    bank = rng.standard_normal((N, 32)).astype(np.float32)
    bq, s = (torch.from_numpy(a).to(cuda) for a in retrieval.quantize_bank(bank))
    got = retrieval.nearest_rows_q(f, bq, s)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, retrieval.topk_blend(f, bq.float() * s), atol=1e-5, rtol=0)
