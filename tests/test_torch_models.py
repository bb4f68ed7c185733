"""Each ported module against its JAX counterpart on the CPU.

Weights are drawn once (the JAX package's fast_init, as numpy), carried to
the port by ``rvc_tpu_torch.compat.weights``, and both sides get the same
numpy inputs; random draws of the JAX side are recorded and handed over.
Bar: 2e-4 absolute at float32 (the bar the JAX package met against the
torch original, BASELINE.md), tighter where a test says so."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import finit, no_compile_cache_writes, np_tree, recorded_draws  # noqa: F401
from rvc_tpu.models import attention as jatt
from rvc_tpu.models import flows as jflows
from rvc_tpu.models import layers as jlayers
from rvc_tpu.models import nsf as jnsf
from rvc_tpu.models import synthesizer as jsyn
from rvc_tpu_torch.compat import weights
from rvc_tpu_torch.models import attention as tatt
from rvc_tpu_torch.models import flows as tflows
from rvc_tpu_torch.models import layers as tlayers
from rvc_tpu_torch.models import nsf as tnsf
from rvc_tpu_torch.models import synthesizer as tsyn

BAR = 2e-4
T_ = torch.from_numpy


def load(module, params, rename=weights.synthesizer_state_dict):
    return tlayers.load_numpy_state_dict(module, rename(params)).eval()


def close(got, ref, atol=BAR, transpose=False):
    got = got.detach().numpy()
    ref = np.asarray(ref)
    if transpose:
        ref = np.swapaxes(ref, 1, 2)
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)


def masks(B, T, lengths):
    m = (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)
    return m[..., None], m[:, None, :]  # JAX (B, T, 1), port (B, 1, T)


def test_fold_weight_norm_matches_jax(rng):
    tree = {"a": {"weight_v": rng.standard_normal((4, 3, 5)).astype(np.float32),
                  "weight_g": rng.uniform(0.5, 2, (4, 1, 1)).astype(np.float32),
                  "bias": np.zeros(4, np.float32)},
            "b": {"weight": np.ones((2, 2), np.float32)}}
    ref = np_tree(jlayers.fold_weight_norm(jax.tree.map(jnp.asarray, tree)))
    got = weights.fold_weight_norm(tree)
    np.testing.assert_allclose(got["a"]["weight"], ref["a"]["weight"], rtol=1e-6)
    assert set(got["a"]) == {"weight", "bias"} and set(got["b"]) == {"weight"}


CASES = {
    "conv_dilated_wn": (lambda: jlayers.Conv1d(8, 12, 5, dilation=3, padding=6, weight_norm=True),
                        lambda: tlayers.Conv1d(8, 12, 5, dilation=3, padding=6), (2, 40, 8)),
    "conv_strided": (lambda: jlayers.Conv1d(1, 8, 8, stride=4, padding=2),
                     lambda: tlayers.Conv1d(1, 8, 8, stride=4, padding=2), (2, 41, 1)),
    "conv_transpose_wn": (lambda: jlayers.ConvTranspose1d(12, 6, 8, stride=4, padding=2,
                                                          weight_norm=True),
                          lambda: tlayers.ConvTranspose1d(12, 6, 8, stride=4, padding=2),
                          (2, 9, 12)),
    "layer_norm": (lambda: jlayers.LayerNorm(12), lambda: tlayers.LayerNorm(12), (2, 7, 12)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_layers_match_jax(rng, case):
    """Channels-last JAX layers vs (B, C, T) port layers; tolerance 1e-5."""
    jmod, tmod, shape = CASES[case]
    x = rng.standard_normal(shape).astype(np.float32)
    j = jmod()
    p = finit(lambda a: j.init(jax.random.PRNGKey(0), a), jnp.asarray(x), seed=1)
    if case == "layer_norm":  # fast_init leaves gamma/beta at 1/0
        p = {"params": {"gamma": rng.uniform(0.5, 2, 12).astype(np.float32),
                        "beta": rng.standard_normal(12).astype(np.float32)}}
    ref = j.apply(p, jnp.asarray(x))
    got = load(tmod(), p)(T_(x).transpose(1, 2))
    close(got, ref, 1e-5, transpose=True)


def test_mask_and_leaky_relu_match_jax(rng):
    lengths = np.array([5, 0, 9])
    ref = np.asarray(jlayers.sequence_mask(jnp.asarray(lengths), 9))[..., 0]
    np.testing.assert_array_equal(tlayers.sequence_mask(T_(lengths), 9).numpy(), ref)
    x = rng.standard_normal(50).astype(np.float32)
    np.testing.assert_array_equal(tlayers.leaky_relu(T_(x)).numpy(),
                                  np.asarray(jlayers.leaky_relu(jnp.asarray(x))))


def test_attention_encoder_matches_jax(rng):
    """Through kernel 2's plain version, lengths < T on two rows (only the
    valid frames leave the encoder)."""
    B, T, C = 3, 30, 16
    lengths = [30, 22, 9]
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    jm, tm = masks(B, T, lengths)
    j = jatt.Encoder(C, 32, 2, 2, kernel_size=3)
    p = finit(lambda a, m: j.init(jax.random.PRNGKey(0), a, m), jnp.asarray(x),
              jnp.asarray(jm), seed=2)
    ref = j.apply(p, jnp.asarray(x), jnp.asarray(jm))
    got = load(tatt.Encoder(C, 32, 2, 2, kernel_size=3), p)(T_(x).transpose(1, 2), T_(tm))
    close(got, ref, 1e-5, transpose=True)


def test_text_encoder_matches_jax(rng):
    B, T = 2, 25
    phone = rng.standard_normal((B, T, 24)).astype(np.float32)
    pitch = rng.integers(1, 256, (B, T))
    lengths = np.array([25, 13])
    j = jsyn.TextEncoder(24, 8, 16, 32, 2, 2, 3, 0.0)
    p = finit(lambda *a: j.init(jax.random.PRNGKey(0), *a), jnp.asarray(phone),
              jnp.asarray(pitch), jnp.asarray(lengths), seed=3)
    m, logs, _ = j.apply(p, jnp.asarray(phone), jnp.asarray(pitch), jnp.asarray(lengths))
    t = load(tsyn.TextEncoder(24, 8, 16, 32, 2, 2, 3), p)
    tm_, tlogs, _ = t(T_(phone), T_(pitch), T_(lengths))
    close(tm_, m, 1e-5, transpose=True)
    close(tlogs, logs, 1e-5, transpose=True)


def test_flows_reverse_matches_jax(rng):
    B, T, C = 2, 20, 8
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    g = rng.standard_normal((B, 1, 6)).astype(np.float32)
    jm, tm = masks(B, T, [20, 14])
    j = jflows.ResidualCouplingBlock(C, 12, 5, 1, 3, gin_channels=6)
    p = finit(lambda *a: j.init(jax.random.PRNGKey(0), *a, reverse=True), jnp.asarray(x),
              jnp.asarray(jm), jnp.asarray(g), seed=4)
    # fast_init zeroes every bias; give them values so the test sees them
    p = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if path[-1].key == "bias" else a, p)
    ref = j.apply(p, jnp.asarray(x), jnp.asarray(jm), jnp.asarray(g), reverse=True)
    got = load(tflows.ResidualCouplingBlock(C, 12, 5, 1, 3, gin_channels=6), p).reverse(
        T_(x).transpose(1, 2), T_(tm), g=T_(g).transpose(1, 2))
    close(got, ref, 1e-5, transpose=True)


GEN = dict(initial_channel=8, upsample_rates=(5, 2, 2), upsample_initial_channel=32,
           upsample_kernel_sizes=(9, 4, 4), gin_channels=6, sr=16000)
GEN_CASES = {
    "resblock1": dict(resblock="1", resblock_kernel_sizes=(3, 7, 11),
                      resblock_dilation_sizes=((1, 3, 5),) * 3),
    "resblock1_short_chains": dict(resblock="1", resblock_kernel_sizes=(3, 5),
                                   resblock_dilation_sizes=((1, 3), (1, 2))),
    "resblock2": dict(resblock="2", resblock_kernel_sizes=(3, 5),
                      resblock_dilation_sizes=((1, 3), (1, 3))),
}


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_generator_nsf_matches_jax(rng, monkeypatch, case):
    """The decoder with the JAX run's sine-source draws (start phase, noise);
    partly unvoiced f0. ResBlock1 stages go through kernel 1's plain version."""
    kw = {**GEN, **GEN_CASES[case]}
    B, T = 2, 12
    x = rng.standard_normal((B, T, 8)).astype(np.float32)
    f0 = (rng.uniform(80, 400, (B, T)) * (rng.uniform(size=(B, T)) > 0.3)).astype(np.float32)
    g = rng.standard_normal((B, 1, 6)).astype(np.float32)
    j = jnsf.GeneratorNSF(**kw)
    p = finit(lambda *a: j.init({"params": jax.random.PRNGKey(0),
                                 "noise": jax.random.PRNGKey(1)}, *a),
              jnp.asarray(x), jnp.asarray(f0), jnp.asarray(g), seed=5)
    with recorded_draws(monkeypatch) as draws:
        ref = j.apply(p, jnp.asarray(x), jnp.asarray(f0), jnp.asarray(g),
                      rngs={"noise": jax.random.PRNGKey(9)})
    jax.effects_barrier()
    rand_ini, noise = draws
    t = load(tnsf.GeneratorNSF(kw.pop("initial_channel"), kw.pop("resblock"),
                               kw.pop("resblock_kernel_sizes"),
                               kw.pop("resblock_dilation_sizes"), **kw), p)
    got = t(T_(x).transpose(1, 2), T_(f0), T_(g).transpose(1, 2),
            rand_ini=T_(rand_ini), noise=T_(noise))
    close(got, ref, 1e-5, transpose=True)


def test_synthesizer_infer_matches_jax(rng, monkeypatch):
    """Synthesizer.infer with the JAX run's prior draw eps and sine draws."""
    kw = dict(spec_channels=129, segment_size=16, inter_channels=16, hidden_channels=16,
              filter_channels=32, n_heads=2, n_layers=2, kernel_size=3, p_dropout=0.0,
              resblock="1", resblock_kernel_sizes=(3, 5),
              resblock_dilation_sizes=((1, 3), (1, 2)), upsample_rates=(10, 4, 2, 2),
              upsample_initial_channel=32, upsample_kernel_sizes=(16, 8, 4, 4),
              spk_embed_dim=4, gin_channels=8, sr=16000, feature_dim=32, use_f0=True)
    B, T = 2, 24
    feat = rng.standard_normal((B, T, 32)).astype(np.float32)
    lens = np.array([T, T - 5])
    pitch = rng.integers(1, 255, (B, T))
    pitchf = (rng.uniform(0, 300, (B, T)) * (rng.uniform(size=(B, T)) > 0.3)).astype(np.float32)
    sid = np.array([0, 2])
    args = tuple(map(jnp.asarray, (feat, lens, pitch, pitchf, sid)))
    j = jsyn.Synthesizer(**kw)
    p = finit(lambda *a: j.init({"params": jax.random.PRNGKey(0),
                                 "noise": jax.random.PRNGKey(1)}, *a, method=j.infer),
              *args, seed=3)
    fn = jax.jit(lambda p, *a: j.apply(p, *a, method=j.infer,
                                       rngs={"noise": jax.random.PRNGKey(5)}))
    with recorded_draws(monkeypatch) as draws:
        o, _, (z, _, m_p, _) = fn(p, *args)
    jax.effects_barrier()
    eps, rand_ini, noise = draws
    t = load(tsyn.Synthesizer(**kw), p)
    with torch.no_grad():
        o2, _, (z2, _, m2, _) = t.infer(*map(T_, (feat, lens, pitch, pitchf, sid)),
                                        eps=T_(eps).transpose(1, 2), rand_ini=T_(rand_ini),
                                        noise=T_(noise))
    close(m2, m_p, 1e-5, transpose=True)
    close(z2, z, 1e-5, transpose=True)
    close(o2, o, 1e-5, transpose=True)
