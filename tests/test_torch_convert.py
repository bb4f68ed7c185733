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

from _torch_port import finit, no_compile_cache_writes, one_thread, recorded_draws  # noqa: F401
from rvc_tpu.config import RVCConfig
from rvc_tpu.models.hubert import HubertConfig, HubertEncoder
from rvc_tpu.models.rmvpe import RMVPE
from rvc_tpu.models.synthesizer import Synthesizer
from rvc_tpu.pipelines import convert as jconv
from rvc_tpu.pitch.extractor import PitchExtractor
from rvc_tpu_torch.compat import weights
from rvc_tpu_torch.models import hubert as thubert
from rvc_tpu_torch.pipelines import convert as tconv

pytestmark = pytest.mark.usefixtures("one_thread")

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


def test_hybrid_convert_matches_jax(pair, monkeypatch):
    """A list of methods (dio, harvest, crepe-tiny) merged by median: f0 of
    the whole padded song at batch 1, each chunk's frames sliced from it.
    The f0 both sides feed the synthesizer agree first (the same voicing on
    every frame, within 1e-4 relative), then the int16 output at the float32
    bar above, 2 LSB. (pm is left out of the list: at its f0_max edge, the
    lag of 14 samples whose parabola runs through lag 13, a flat ACF flips
    its step between -0.5 and +0.5 lag with float32 rounding, which moves a
    frame's f0 by ~7%; tests/test_torch_pitch_methods.py and
    tests/test_torch_preprocess.py hold pm at a share of frames.)"""
    from rvc_tpu.compat.torch_import import crepe_params_from_state_dict
    from rvc_tpu_torch.models import crepe as tcrepe
    from rvc_tpu_torch.models.layers import load_numpy_state_dict

    jvc, tvc = pair
    sd = tcrepe.random_state_dict("tiny", 21)
    monkeypatch.setattr(jvc.pitch, "crepe_tiny_params", crepe_params_from_state_dict(sd))
    monkeypatch.setattr(tvc.pitch, "crepe_tiny",
                        load_numpy_state_dict(tcrepe.CrepeNet("tiny"), sd).eval())
    settings = dict(SETTINGS, f0_method=["dio", "harvest", "crepe-tiny"], f0_up_key=2.0)
    audio = speech(6.0, offset_s=30.0)
    f0_rec = []
    get_f0 = jvc.pitch.get_f0

    def recording_get_f0(*args, **kwargs):
        out = get_f0(*args, **kwargs)
        f0_rec.append(np.asarray(out[1]))
        return out

    monkeypatch.setattr(jvc.pitch, "get_f0", recording_get_f0)
    with recorded_draws(monkeypatch) as draws:
        ref, _ = jvc.convert(audio, settings=jconv.ConvertSettings(**settings))
    eps, rand_ini, noise = draws
    s = tconv.ConvertSettings(**settings)
    wave, starts, _, _, L = tvc._upload([tvc.padded(audio)], 1600)
    _, f0_port = tvc.pitch.get_f0(wave[None], s.f0_up_key, s.f0_method, s.merge_type)
    f0_jax, f0_port = f0_rec[0], f0_port.numpy()
    print(f"hybrid f0: {f0_jax.shape[1]} frames, {int((f0_jax > 0).sum())} voiced, "
          f"max rel diff {np.max(np.abs(f0_port - f0_jax) / np.maximum(f0_jax, 1e-6)):.3g}")
    assert f0_port.shape == f0_jax.shape and len(starts) >= 2
    np.testing.assert_array_equal(f0_port > 0, f0_jax > 0)
    np.testing.assert_allclose(f0_port, f0_jax, rtol=1e-4, atol=0)

    got, _ = tvc.convert(audio, settings=s, draws=dict(
        eps=torch.from_numpy(eps).transpose(1, 2), rand_ini=torch.from_numpy(rand_ini),
        noise=torch.from_numpy(noise)))
    assert got.shape == ref.shape and np.abs(ref).max() > 1000
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    print(f"hybrid int16 max |diff| {diff.max()}, mean {diff.mean():.3f}")
    assert diff.max() <= 2, (diff.max(), np.mean(diff > 2))
    with pytest.raises(ValueError, match="single f0 method"):
        tvc.convert_batch([audio], settings=s)
