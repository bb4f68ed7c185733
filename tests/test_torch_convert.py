"""The port's VoiceConverter.convert against the JAX package's, end to end
on the CPU: tiny random models, a 6 s slice of the committed speech fixture
split into 2 chunks, RMVPE f0, int8 retrieval, protect and the RMS mix on.
The same numpy weights and the JAX run's recorded random draws go into
both."""
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import finit, no_compile_cache_writes, recorded_draws  # noqa: F401
from rvc_tpu.config import RVCConfig
from rvc_tpu.models.hubert import HubertConfig, HubertEncoder
from rvc_tpu.models.rmvpe import RMVPE
from rvc_tpu.models.synthesizer import Synthesizer
from rvc_tpu.pipelines import convert as jconv
from rvc_tpu.pitch.extractor import PitchExtractor
from rvc_tpu_torch.compat import weights
from rvc_tpu_torch.models import hubert as thubert
from rvc_tpu_torch.pipelines import convert as tconv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = dict(
    spec_channels=129, segment_size=16, inter_channels=16, hidden_channels=16,
    filter_channels=32, n_heads=2, n_layers=2, kernel_size=3, p_dropout=0.0,
    resblock="1", resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (1, 2)),
    upsample_rates=(10, 4, 2, 2), upsample_initial_channel=32,
    upsample_kernel_sizes=(16, 8, 4, 4), spk_embed_dim=4, gin_channels=8,
    sr=16000, feature_dim=32, use_f0=True,
)
HUBERT = dict(
    hidden_size=32, num_hidden_layers=12, num_attention_heads=2, intermediate_size=64,
    conv_dim=(16,) * 7, conv_stride=(5, 2, 2, 2, 2, 2, 2), conv_kernel=(10, 3, 3, 3, 3, 2, 2),
    classifier_proj_size=8, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
)
CHUNKING = RVCConfig(x_pad=1, x_query=2, x_center=4, x_max=5)
SETTINGS = dict(f0_method="rmvpe", index_rate=0.75, protect=0.33, rms_mix_rate=0.25)


def speech(seconds, offset_s=10.0):
    with wave.open(os.path.join(REPO, "assets", "speech_65s.wav")) as f:
        assert f.getframerate() == 16000 and f.getnchannels() == 1
        f.setpos(int(offset_s * 16000))
        raw = f.readframes(int(seconds * 16000))
    return np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0


@pytest.fixture(scope="module")
def pair():
    """(JAX converter, port converter) with the same weights and bank."""
    js = Synthesizer(**SYNTH)
    T = 16
    sp = finit(lambda *a: js.init({"params": jax.random.PRNGKey(0),
                                   "noise": jax.random.PRNGKey(1)}, *a, method=js.infer),
               jnp.zeros((1, T, 32)), jnp.array([T]), jnp.ones((1, T), jnp.int32),
               jnp.full((1, T), 150.0), jnp.array([0]), seed=1)
    hcfg = HubertConfig(**HUBERT)
    hub = HubertEncoder(hcfg)
    hp = finit(lambda x: hub.init(jax.random.PRNGKey(2), x, output_layer=12),
               jnp.zeros((1, 3200)), seed=2)
    rm = RMVPE()
    rp = finit(lambda x: rm.init(jax.random.PRNGKey(3), x), jnp.zeros((1, 16000)), seed=3)
    bank = np.random.default_rng(7).standard_normal((500, 32)).astype(np.float32)
    jvc = jconv.VoiceConverter(sp, SYNTH, hp, hcfg, pitch=PitchExtractor(rmvpe_params=rp),
                               index_bank=bank, config=CHUNKING, index_int8=True)
    tvc = tconv.VoiceConverter.from_state_dicts(
        weights.synthesizer_state_dict(sp), SYNTH, weights.hubert_state_dict(hp),
        thubert.HubertConfig(**HUBERT), weights.rmvpe_state_dict(rp),
        index_bank=bank, config=CHUNKING, index_int8=True, device="cpu")
    return jvc, tvc


def test_convert_matches_jax(pair, monkeypatch):
    jvc, tvc = pair
    audio = speech(6.0)
    f0_rec = []  # the JAX core's f0, recorded where it enters coarse_f0
    coarse = jconv.coarse_f0

    def recording_coarse(f0, *args):
        jax.debug.callback(lambda x: f0_rec.append(np.array(x)), f0, ordered=True)
        return coarse(f0, *args)

    monkeypatch.setattr(jconv, "coarse_f0", recording_coarse)
    with recorded_draws(monkeypatch) as draws:
        ref, ref_sr = jvc.convert(audio, settings=jconv.ConvertSettings(**SETTINGS))
    eps, rand_ini, noise = draws
    got, sr = tvc.convert(audio, settings=tconv.ConvertSettings(**SETTINGS), draws=dict(
        eps=torch.from_numpy(eps).transpose(1, 2), rand_ini=torch.from_numpy(rand_ini),
        noise=torch.from_numpy(noise)))

    # chunk spans, as the JAX pipeline forms them from its split points
    hp = tconv.butter_highpass_host(audio)
    t_pad, W = tvc.t_pad, jconv.WINDOW
    spans, start = [], 0
    for t in jconv.find_split_points(hp, jvc.t_center, jvc.t_query):
        t = t // W * W
        spans.append((start, t + 2 * t_pad + W))
        start = t
    spans.append((start, len(hp) + 2 * t_pad))
    assert len(spans) >= 2
    assert tvc.spans(hp) == spans

    # f0 of the chunk batch on both sides: the share of frames that differ
    # (an RMVPE argmax or voicing flip) is reported; a flip changes the
    # synthesized frames, so the sample bar below holds only without one
    chunks, _ = tvc.chunks(audio)
    f0_jax = f0_rec[0]
    f0_port = tvc.pitch.method_fn("rmvpe", 50.0, 1100.0)(chunks).numpy()[:, :f0_jax.shape[1]]
    f0_differ = np.mean(np.abs(f0_port - f0_jax) > 1e-2 * np.maximum(f0_jax, 1.0))
    print(f"f0 frames that differ: {f0_differ:.2%}")
    assert f0_differ == 0.0

    assert sr == ref_sr == 16000
    assert got.dtype == ref.dtype == np.int16
    assert got.shape == ref.shape
    # Tolerance: both sides compute in float32 but in another order (XLA vs
    # ATen), ~1e-6 relative before the int16 scaling: at most 2 LSB
    # (measured: 1). The message gives the share of samples above it.
    n = min(len(got), len(ref))
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert np.abs(ref).max() > 1000
    print(f"int16 max |diff| {diff.max()}, mean {diff.mean():.3f}, peak {np.abs(ref).max()}")
    assert diff.max() <= 2, (diff.max(), np.mean(diff > 2), n)
