"""HuBERT, RMVPE with the f0 chain, and the signal helpers of the
conversion path, each against its JAX counterpart on the CPU (same numpy
weights and inputs). Bar: 2e-4 absolute at float32 unless a test says
otherwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import finit, no_compile_cache_writes  # noqa: F401
from rvc_tpu.models import hubert as jhub
from rvc_tpu.models import rmvpe as jrmvpe
from rvc_tpu.native import peak_quantize_i16 as jax_peak_quantize
from rvc_tpu.ops import filters as jfilters
from rvc_tpu.pitch import extractor as jpitch
from rvc_tpu_torch.compat import weights
from rvc_tpu_torch.models import hubert as thub
from rvc_tpu_torch.models import layers as tlayers
from rvc_tpu_torch.models import rmvpe as trmvpe
from rvc_tpu_torch.ops import filters as tfilters
from rvc_tpu_torch.pitch import extractor as tpitch

T_ = torch.from_numpy


def close(got, ref, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=atol, rtol=0)


HUBERT = dict(hidden_size=32, num_hidden_layers=12, num_attention_heads=2,
              intermediate_size=64, conv_dim=(16,) * 7, conv_stride=(5, 2, 2, 2, 2, 2, 2),
              conv_kernel=(10, 3, 3, 3, 3, 2, 2), classifier_proj_size=8,
              num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_hubert_extract_features_matches_jax(rng, version):
    """v2: the output after 11 layers; v1: after 8, through final_proj. The
    second row is zero-padded past its length (masked group norm and keys);
    its valid frames are compared."""
    x = rng.standard_normal((2, 6400)).astype(np.float32)
    lengths = np.array([6400, 4000])
    x[1, 4000:] = 0.0
    j = jhub.HubertEncoder(jhub.HubertConfig(**HUBERT))
    v1 = version == "v1"
    p = finit(lambda a: j.init(jax.random.PRNGKey(2), a, output_layer=9 if v1 else 12,
                               final_proj=v1), jnp.zeros((1, 3200)), seed=6)
    ref = jax.jit(lambda p, a, n: j.apply(p, a, version=version, lengths=n,
                                          method=j.extract_features))(
        p, jnp.asarray(x), jnp.asarray(lengths))
    t = tlayers.load_numpy_state_dict(thub.HubertEncoder(thub.HubertConfig(**HUBERT), version),
                                      weights.hubert_state_dict(p)).eval()
    with torch.no_grad():
        got = t.extract_features(T_(x), T_(lengths))
    n_valid = int(np.asarray(jhub.conv_output_lengths(j.cfg, jnp.asarray(lengths)))[1])
    close(got[0], np.asarray(ref)[0], 1e-4)
    close(got[1, :n_valid], np.asarray(ref)[1, :n_valid], 1e-4)


def test_mel_frontend_matches_jax(rng):
    """Both are float32 DFT matmuls; the log of small magnitudes amplifies
    the rounding, hence 1e-3 on the log-mel (values of order 10)."""
    x = (0.3 * rng.standard_normal((2, 8000))).astype(np.float32)
    ref = jrmvpe.mel_frontend(jnp.asarray(x))
    close(trmvpe.mel_frontend(T_(x)), ref, 1e-3)


def test_rmvpe_and_f0_chain_match_jax(rng):
    """RMVPE's E2E at reduced widths (1 block per level, 4 base channels),
    then decode_cents, autotune, shift and coarse bins. The share of frames
    whose f0 differs (an argmax or voicing flip) is reported and must be 0."""
    x = (0.3 * rng.standard_normal((2, 64 * 160))).astype(np.float32)
    mel = np.array(jrmvpe.mel_frontend(jnp.asarray(x)))[:, :64]
    j = jrmvpe.E2E(n_blocks=1, en_out_channels=4)
    p = finit(lambda a: j.init(jax.random.PRNGKey(3), a), jnp.asarray(mel), seed=7)
    p = jax.tree_util.tree_map_with_path(  # non-trivial batch-norm statistics
        lambda path, a: rng.uniform(0.5, 2, a.shape).astype(np.float32)
        if path[-1].key == "running_var" else a, p)
    sal = jax.jit(j.apply)(p, jnp.asarray(mel))
    t = tlayers.load_numpy_state_dict(trmvpe.E2E(n_blocks=1, en_out_channels=4),
                                      weights.rmvpe_state_dict({"params": {"model": p["params"]}}))
    with torch.no_grad():
        sal2 = t.eval()(T_(mel))
    close(sal2, sal, 1e-5)
    ref_f0 = np.asarray(jrmvpe.decode_cents(sal, 0.03))
    f0 = trmvpe.decode_cents(sal2, 0.03)
    differ = np.mean(np.abs(f0.numpy() - ref_f0) > 1e-2)
    assert differ == 0.0, f"{differ:.2%} of f0 frames differ"
    np.testing.assert_allclose(f0.numpy(), ref_f0, rtol=1e-5)
    hz = (rng.uniform(60, 900, (2, 64)) * (rng.uniform(size=(2, 64)) > 0.2)).astype(np.float32)
    for got, ref in (
        (tpitch.autotune(T_(hz)), jpitch.autotune(jnp.asarray(hz))),
        (tpitch.shift_semitones(T_(hz), 3.0), jpitch.shift_semitones(jnp.asarray(hz), 3.0)),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    np.testing.assert_array_equal(tpitch.coarse_f0(T_(hz)).numpy(),
                                  np.asarray(jpitch.coarse_f0(jnp.asarray(hz))))
    np.testing.assert_array_equal(tpitch.median_pass(T_(hz), 3).numpy(),
                                  np.asarray(jpitch._median_filter(jnp.asarray(hz), 3)))


def test_signal_helpers_match_jax(rng):
    """change_rms (per-chunk loudness mix), the high-pass and the int16
    upload quantization."""
    src = (0.3 * rng.standard_normal((2, 32000))).astype(np.float32)
    tgt = (0.1 * rng.standard_normal((2, 96000))).astype(np.float32)
    ref = jfilters.change_rms(jnp.asarray(src), 16000, jnp.asarray(tgt), 48000, 0.25)
    close(tfilters.change_rms(T_(src), 16000, T_(tgt), 48000, 0.25), ref, 1e-6)
    a = src[0]
    np.testing.assert_array_equal(tfilters.butter_highpass_host(a),
                                  jfilters.butter_highpass_host(a))
    q, peak = tfilters.peak_quantize_i16(a)
    jq, jpeak = jax_peak_quantize(a)
    np.testing.assert_array_equal(q, jq)
    assert peak == jpeak
