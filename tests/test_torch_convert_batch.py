"""The port's VoiceConverter against the JAX package's on the CPU, past the
16 kHz single-song path: input at 44.1 kHz (remixed to 16 kHz on the
host), ``resample_sr`` (the int16 result resampled on the device) and
``convert_batch`` (three songs of different lengths in one chunk batch).
A tiny 48 kHz model with RMVPE f0 (its E2E net narrowed on both sides,
``_torch_port.narrow_jax_rmvpe``), int8 retrieval, protect and the RMS mix
on; the same numpy weights and the JAX run's recorded draws. Bar: 2 LSB of
int16, as tests/test_torch_convert.py's."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal

from _torch_port import (NARROW_RMVPE, finit, narrow_jax_rmvpe, no_compile_cache_writes,  # noqa: F401
                         recorded_draws, replayed_draws)
from rvc_tpu.config import RVCConfig
from rvc_tpu.models.hubert import HubertConfig, HubertEncoder
from rvc_tpu.models.rmvpe import RMVPE
from rvc_tpu.models.synthesizer import Synthesizer
from rvc_tpu.pipelines import convert as jconv
from rvc_tpu.pitch.extractor import PitchExtractor
from rvc_tpu_torch.compat import weights
from rvc_tpu_torch.models import hubert as thubert
from rvc_tpu_torch.models import rmvpe as trmvpe
from rvc_tpu_torch.models import synthesizer as tsyn
from rvc_tpu_torch.models.layers import load_numpy_state_dict
from rvc_tpu_torch.pipelines import convert as tconv
from rvc_tpu_torch.pitch.extractor import PitchExtractor as TPitchExtractor
from test_torch_convert import HUBERT, speech

SYNTH48 = dict(
    spec_channels=129, segment_size=16, inter_channels=16, hidden_channels=16,
    filter_channels=32, n_heads=2, n_layers=2, kernel_size=3, p_dropout=0.0,
    resblock="1", resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (1, 2)),
    upsample_rates=(10, 6, 4, 2), upsample_initial_channel=32,
    upsample_kernel_sizes=(16, 12, 8, 4), spk_embed_dim=4, gin_channels=8,
    sr=48000, feature_dim=32, use_f0=True,
)
# short chunks so that a 3.2 s song splits in two
CHUNKING = RVCConfig(x_pad=1, x_query=1, x_center=2, x_max=3)
SETTINGS = dict(f0_method="rmvpe", index_rate=0.75, protect=0.33, rms_mix_rate=0.25)


def lsb(got, ref) -> int:
    assert got.dtype == ref.dtype == np.int16 and got.shape == ref.shape
    assert np.abs(ref).max() > 1000
    return int(np.abs(got.astype(np.int32) - ref.astype(np.int32)).max())


def port_draws(draws):
    eps, rand_ini, noise = draws
    return dict(eps=torch.from_numpy(eps).transpose(1, 2), rand_ini=torch.from_numpy(rand_ini),
                noise=torch.from_numpy(noise))


@pytest.fixture(scope="module")
def pair():
    with narrow_jax_rmvpe():
        yield _pair()


def _pair():
    js = Synthesizer(**SYNTH48)
    T = 16
    sp = finit(lambda *a: js.init({"params": jax.random.PRNGKey(0),
                                   "noise": jax.random.PRNGKey(1)}, *a, method=js.infer),
               jnp.zeros((1, T, 32)), jnp.array([T]), jnp.ones((1, T), jnp.int32),
               jnp.full((1, T), 150.0), jnp.array([0]), seed=11)
    hcfg = HubertConfig(**HUBERT)
    hub = HubertEncoder(hcfg)
    hp = finit(lambda x: hub.init(jax.random.PRNGKey(2), x, output_layer=12),
               jnp.zeros((1, 3200)), seed=12)
    rm = RMVPE()
    rp = finit(lambda x: rm.init(jax.random.PRNGKey(3), x), jnp.zeros((1, 16000)), seed=13)
    bank = np.random.default_rng(17).standard_normal((300, 32)).astype(np.float32)
    jvc = jconv.VoiceConverter(sp, SYNTH48, hp, hcfg, pitch=PitchExtractor(rmvpe_params=rp),
                               index_bank=bank, config=CHUNKING, index_int8=True)
    rmvpe = trmvpe.RMVPE(**NARROW_RMVPE)
    load_numpy_state_dict(rmvpe.model, weights.rmvpe_state_dict(rp))
    tvc = tconv.VoiceConverter(
        load_numpy_state_dict(tsyn.Synthesizer(**SYNTH48), weights.synthesizer_state_dict(sp)),
        SYNTH48, load_numpy_state_dict(thubert.HubertEncoder(thubert.HubertConfig(**HUBERT)),
                                       weights.hubert_state_dict(hp)),
        TPitchExtractor(rmvpe), index_bank=bank, config=CHUNKING, index_int8=True,
        device="cpu")
    return jvc, tvc


def test_convert_at_44k1_in_and_out_matches_jax(pair, monkeypatch):
    """A 0.6 s clip given at 44.1 kHz (remixed to 16 kHz, limited to 0.95)
    and returned at 44.1 kHz (``resample_sr``: the 48 kHz int16 result
    resampled, clipped and truncated)."""
    jvc, tvc = pair
    g = math.gcd(16000, 44100)
    audio = signal.resample_poly(speech(0.6, 20.0), 44100 // g, 16000 // g).astype(np.float32)
    audio *= 1.2  # above the 0.95 limit
    s = dict(SETTINGS, resample_sr=44100)
    with recorded_draws(monkeypatch) as draws:
        ref, ref_sr = jvc.convert(audio, 44100, settings=jconv.ConvertSettings(**s))
    got, sr = tvc.convert(audio, 44100, settings=tconv.ConvertSettings(**s),
                          draws=port_draws(draws))
    assert sr == ref_sr == 44100
    d = lsb(got, ref)
    print(f"44.1 kHz in and out: max |diff| {d} LSB")
    assert d <= 2


def test_convert_batch_matches_jax(pair, monkeypatch):
    """Three songs of 0.6, 1.2 and 3.2 s (the last in two chunks) in one
    chunk batch, under one int16 quantization; the first song's chunk slice
    runs into the second song's buffer and the last one's is clamped at
    the flat buffer's end, as in the JAX package. Each song within 2 LSB of
    JAX's.

    Then the last song alone, on its rows of the batch's draws and at the
    batch's chunk length (a song's own buffer must hold that length): the
    JAX package's own distance between it and the batch's song, each scaled
    by its peak (the batch is normalized globally, and quantized under the
    batch's peak), is printed beside the port's, which is held to it within
    2 LSB; chip_smoke.py's phase d takes its bar from it. The port's side
    of that is a batch of the song alone through ``return_async``, held to
    JAX's ``convert`` of it within 2 LSB."""
    jvc, tvc = pair
    songs = [speech(0.6, 5.0), 0.3 * speech(1.2, 30.0), speech(3.2, 45.0)]
    s = dict(SETTINGS, resample_sr=0)
    stats = {}
    with recorded_draws(monkeypatch) as draws:
        ref = jvc.convert_batch(songs, settings=jconv.ConvertSettings(**s))
    jax.effects_barrier()
    got = tvc.convert_batch(songs, settings=tconv.ConvertSettings(**s), stats=stats,
                            draws=port_draws(draws))
    assert stats["n_chunks"] == 4 and stats["download_bytes"] > 0
    assert {"device_s", "download_s", "dispatch_s"} <= set(stats)
    for (g16, gsr), (r16, rsr) in zip(got, ref):
        assert gsr == rsr == 48000
        d = lsb(g16, r16)
        print(f"batch song: {len(g16)} samples, max |diff| {d} LSB")
        assert d <= 2

    L = stats["chunk_samples"]
    one = [x[2:] for x in draws]  # the last song's two chunks
    monkeypatch.undo()
    jvc._core_cache.clear()
    pending = replayed_draws(monkeypatch, one)
    jone, _ = jvc.convert(songs[2], settings=jconv.ConvertSettings(**s), bucket_samples=L)
    assert not pending
    dispatch, finalize = tvc.convert_batch(songs[2:], settings=tconv.ConvertSettings(**s),
                                           bucket_samples=L, return_async=True,
                                           draws=port_draws(one))
    (tone, sr), = finalize(dispatch())
    assert sr == 48000 and lsb(tone, jone) <= 2

    def dist(a, b):
        a, b = a / np.abs(a).max(), b / np.abs(b).max()
        return float(np.sqrt(np.sum((a - b) ** 2) / np.sum(b ** 2)))

    j_dist = dist(ref[2][0].astype(np.float64), jone.astype(np.float64))
    t_dist = dist(got[2][0].astype(np.float64), tone.astype(np.float64))
    two_lsb = 2 * np.sqrt(len(tone)) / np.linalg.norm(tone.astype(np.float64))
    print(f"batch song vs its own convert, relative L2 after peak scaling: JAX {j_dist:.3g}, "
          f"port {t_dist:.3g} (2 LSB: {two_lsb:.3g})")
    assert t_dist <= j_dist + two_lsb
