"""The retrieval index built from a training set's features.

Counterpart of ``rvc_tpu/retrieval/index.py``: ``FeatureIndex`` (exact
top-k over a float32 bank, blended by 1 / d^2 weights; the reference's
faiss ``IVF{n},Flat`` search, vc_infer_pipeline.py:60-75), ``_kmeans``
(Lloyd iterations) and ``train_index``, which compacts a training set of
more than ``max_rows`` rows to k-means centroids as the reference's
MiniBatchKMeans does before faiss (rvc_nodes.py:509-549). ``train_index``'s
bank is what ``convert --index`` reads; conversion searches it through its
own kernel (``ops/retrieval.py``), and this class stays the plain float32
one of the JAX package.

``_kmeans`` computes the JAX function in row chunks: the JAX code holds the
(N, n_clusters) distances and a one-hot matrix of the same shape whole (8
GB each at 200 001 x 10 000); here each chunk's distances are one product
(``torch.matmul``), its assignments an ``argmin``, and the sums and counts
``index_add_`` and ``bincount``. An empty cluster keeps its centroid. The
sums run in another order than the JAX one-hot product's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device, set_float32_math


def _topk_blend(feats: torch.Tensor, bank: torch.Tensor, bank_sq: torch.Tensor,
                k: int) -> torch.Tensor:
    """feats (B, T, D) against bank (N, D): the 1 / d^2-weighted blend of the
    k nearest bank rows of every frame."""
    dots = torch.einsum("btd,nd->btn", feats, bank)
    q_sq = torch.sum(feats * feats, dim=-1, keepdim=True)
    d2 = q_sq - 2.0 * dots + bank_sq[None, None, :]
    neg_d2, idx = torch.topk(-d2, k, dim=-1)
    d2_k = torch.clamp(-neg_d2, min=1e-9)
    w = 1.0 / torch.square(d2_k)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    return torch.sum(bank[idx] * w[..., None], dim=-2)


class FeatureIndex:
    """Exact top-k retrieval over a bank held on ``device`` (the card unless
    "cpu")."""

    def __init__(self, bank, device=None):
        self.device = resolve_device(device)
        set_float32_math()
        self.bank = torch.as_tensor(np.asarray(bank, np.float32), device=self.device)
        self._bank_sq = torch.sum(self.bank * self.bank, dim=-1)

    @property
    def ntotal(self) -> int:
        return int(self.bank.shape[0])

    def search_blend(self, feats: torch.Tensor, k: int = 1) -> torch.Tensor:
        """The weighted-neighbour blend (reference vc_infer_pipeline.py:65-68);
        with the reference's k = 1, the nearest row."""
        return _topk_blend(feats.float(), self.bank, self._bank_sq, k)

    def blend_into(self, feats: torch.Tensor, index_rate: float, k: int = 1) -> torch.Tensor:
        """rate * retrieved + (1 - rate) * feats (reference :72-75)."""
        if index_rate <= 0:
            return feats
        retrieved = self.search_blend(feats, k)
        return (index_rate * retrieved + (1.0 - index_rate) * feats).to(feats.dtype)

    def save(self, path: str) -> None:
        np.save(path, self.bank.cpu().numpy())

    @classmethod
    def load(cls, path: str, device=None) -> "FeatureIndex":
        return cls(np.load(path), device)


@torch.no_grad()
def _kmeans(data: torch.Tensor, init: torch.Tensor, n_clusters: int, iters: int,
            chunk_rows: int = 16384, inertia: list | None = None) -> torch.Tensor:
    """``iters`` Lloyd iterations from ``init`` (n_clusters, D) over ``data``
    (N, D), ``chunk_rows`` rows at a time. A list given as ``inertia`` gets
    each iteration's sum of squared distances to the assigned centroids (as
    float64, before that iteration's update)."""
    data_sq = torch.sum(data * data, dim=-1)
    centroids = init.clone()
    for _ in range(iters):
        c_sq = torch.sum(centroids * centroids, dim=-1)
        sums = torch.zeros_like(centroids)
        counts = torch.zeros(n_clusters, dtype=torch.int64, device=data.device)
        total = torch.zeros((), dtype=torch.float64, device=data.device)
        for s in range(0, data.shape[0], chunk_rows):
            x = data[s : s + chunk_rows]
            d2 = data_sq[s : s + chunk_rows, None] - 2.0 * torch.matmul(x, centroids.T) \
                + c_sq[None, :]
            best, assign = torch.min(d2, dim=-1)
            sums.index_add_(0, assign, x)
            counts += torch.bincount(assign, minlength=n_clusters)
            if inertia is not None:
                total += best.double().sum()
        if inertia is not None:
            inertia.append(float(total))
        n = counts.to(data.dtype)[:, None]
        centroids = torch.where(n > 0, sums / torch.clamp(n, min=1.0), centroids)
    return centroids


def train_index(features: np.ndarray, max_rows: int = 200_000, n_clusters: int = 10_000,
                iters: int = 20, seed: int = 0, device=None) -> FeatureIndex:
    """A retrieval bank: the features themselves, or above ``max_rows`` rows
    their k-means centroids from ``n_clusters`` rows drawn as the JAX
    package draws them."""
    feats = np.asarray(features, np.float32)
    dev = resolve_device(device)
    if feats.shape[0] > max_rows:
        set_float32_math()
        rng = np.random.default_rng(seed)
        init_idx = rng.choice(feats.shape[0], n_clusters, replace=False)
        data = torch.from_numpy(feats).to(dev)
        centroids = _kmeans(data, data[torch.from_numpy(init_idx).to(dev)], n_clusters, iters)
        return FeatureIndex(centroids.cpu().numpy(), dev)
    return FeatureIndex(feats, dev)
