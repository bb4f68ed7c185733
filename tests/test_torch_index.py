"""The port's retrieval index (``retrieval/index.py``) against the JAX
package's on the CPU: chunked k-means against the JAX one-hot Lloyd
iterations, both branches of ``train_index``, and the top-k blend."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import no_compile_cache_writes  # noqa: F401
from rvc_tpu.retrieval import index as jindex
from rvc_tpu_torch.retrieval import index as tindex

# The chunked sums add the rows of a cluster in another order than the JAX
# one-hot product: float32 rounding of sums of ~75 rows of magnitude ~10.
TOL = dict(atol=1e-5, rtol=1e-5)


def _clusters(rng, n=600, d=16, k=8):
    """Seeded, well-separated clusters: centres 10 apart, spread 0.5."""
    centres = 10.0 * rng.standard_normal((k, d))
    labels = rng.integers(0, k, n)
    return (centres[labels] + 0.5 * rng.standard_normal((n, d))).astype(np.float32)


def test_kmeans_matches_jax_in_chunks(rng):
    """6 Lloyd iterations from the same initial rows, 128 rows a chunk (N =
    600); one initial centroid lies far from every row, so that its cluster
    stays empty and keeps its centroid, as jnp.where keeps it. The inertia
    does not rise."""
    data = _clusters(rng)
    init = data[rng.choice(len(data), 9, replace=False)]
    init[8] = 1000.0
    ref = np.asarray(jindex._kmeans(jnp.asarray(data), jnp.asarray(init), 9, 6))
    inertia = []
    got = tindex._kmeans(torch.from_numpy(data), torch.from_numpy(init), 9, 6,
                         chunk_rows=128, inertia=inertia).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_array_equal(got[8], init[8])
    assert len(inertia) == 6 and all(b <= a * (1 + 1e-6) for a, b in zip(inertia, inertia[1:]))
    assert inertia[-1] < inertia[0]
    whole = tindex._kmeans(torch.from_numpy(data), torch.from_numpy(init), 9, 6,
                           chunk_rows=len(data)).numpy()
    np.testing.assert_allclose(got, whole, **TOL)


@pytest.mark.parametrize("max_rows", [600, 500])
def test_train_index_matches_jax(rng, max_rows):
    """At or below ``max_rows`` the bank is the features; above, the k-means
    centroids from the rows drawn as the JAX package draws them."""
    data = _clusters(rng)
    kw = dict(max_rows=max_rows, n_clusters=8, iters=5, seed=3)
    ref = np.asarray(jindex.train_index(data, **kw).bank)
    got = tindex.train_index(data, device="cpu", **kw)
    assert got.ntotal == ref.shape[0] == (600 if max_rows == 600 else 8)
    np.testing.assert_allclose(got.bank.numpy(), ref, **TOL)


@pytest.mark.parametrize("k", [1, 3])
def test_search_blend_matches_jax(rng, k, tmp_path):
    """The 1 / d^2 blend of the k nearest rows, and blend_into at 0.75, after
    a save and load of the bank."""
    bank = rng.standard_normal((300, 16)).astype(np.float32)
    feats = rng.standard_normal((2, 10, 16)).astype(np.float32)
    tindex.FeatureIndex(bank, "cpu").save(str(tmp_path / "bank.npy"))
    t = tindex.FeatureIndex.load(str(tmp_path / "bank.npy"), "cpu")
    j = jindex.FeatureIndex(bank)
    np.testing.assert_allclose(t.search_blend(torch.from_numpy(feats), k).numpy(),
                               np.asarray(j.search_blend(jnp.asarray(feats), k)), **TOL)
    np.testing.assert_allclose(t.blend_into(torch.from_numpy(feats), 0.75, k).numpy(),
                               np.asarray(j.blend_into(jnp.asarray(feats), 0.75, k)), **TOL)
    assert t.blend_into(torch.from_numpy(feats), 0.0) is not None
