"""The port's VoiceConverter.convert in bfloat16 against the JAX package's
VoiceConverter(dtype=bfloat16), end to end on the CPU: tiny random models,
the 6 s slice of the speech fixture of test_torch_convert.py in 2 chunks,
RMVPE f0, int8 retrieval at index_rate 0.75, protect 0.33, the RMS mix on.

The JAX converter runs its Pallas kernels in interpret mode (fuse_resblocks,
fuse_group, fuse_attention forced on; the stage kernel takes exactly three
units per chain, hence three dilations per chain here), as the port runs its
kernels' plain versions. In bf16 RMVPE's f0 on random weights is chaotic
(the JAX module's own bf16 and float32 f0 differ on nearly every frame;
test_torch_bf16_models.py compares RMVPE on its own), and the prior's eps is
drawn in bf16: so the JAX run's f0 and draws are recorded and handed to the
port, and to a float32 JAX run that gives the JAX package's own bf16 drift.

Bar, fixed before the first run, in relative L2 over the int16 waveform:
the port must be no farther from the JAX package's bf16 output than twice
the JAX package's own bf16-to-float32 distance (if the port's bf16 error is
at most the JAX package's, the triangle inequality bounds their distance
by twice it), and no farther from the JAX package's float32 output than 1.5
times that distance (the port's bf16 is about as accurate as the JAX
package's). All three distances are printed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (finit, no_compile_cache_writes, recorded_draws,  # noqa: F401
                         replayed_draws)
from rvc_tpu.models.hubert import HubertConfig, HubertEncoder
from rvc_tpu.models.rmvpe import RMVPE
from rvc_tpu.models.synthesizer import Synthesizer
from rvc_tpu.pipelines import convert as jconv
from rvc_tpu.pitch.extractor import PitchExtractor
from rvc_tpu_torch.compat import weights
from rvc_tpu_torch.models import hubert as thubert
from rvc_tpu_torch.pipelines import convert as tconv
from test_torch_convert import CHUNKING, HUBERT, SETTINGS, SYNTH, speech

SYNTH3 = {**SYNTH, "resblock_dilation_sizes": ((1, 3, 5), (1, 3, 5))}
FUSED = dict(fuse_resblocks=True, fuse_group=True, fuse_attention=True)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def weights_np():
    js = Synthesizer(**SYNTH3)
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
    return sp, hcfg, hp, rp, bank


def jax_converter(weights_np, dtype):
    sp, hcfg, hp, rp, bank = weights_np
    return jconv.VoiceConverter(sp, {**SYNTH3, **FUSED}, hp, hcfg,
                                pitch=PitchExtractor(rmvpe_params=rp, dtype=dtype),
                                index_bank=bank, config=CHUNKING, index_int8=True, dtype=dtype)


def test_convert_bf16_matches_jax(weights_np, monkeypatch):
    sp, hcfg, hp, rp, bank = weights_np
    audio = speech(6.0)
    settings = jconv.ConvertSettings(**SETTINGS)
    f0_rec = []  # the JAX core's f0 where it enters coarse_f0
    coarse = jconv.coarse_f0

    def recording_coarse(f0, *args):
        jax.debug.callback(lambda x: f0_rec.append(np.array(x)), f0, ordered=True)
        return coarse(f0, *args)

    with monkeypatch.context() as m:
        m.setattr(jconv, "coarse_f0", recording_coarse)
        with recorded_draws(m) as draws:
            ref_b, sr = jax_converter(weights_np, jnp.bfloat16).convert(audio, settings=settings)
    (f0,) = f0_rec
    eps, rand_ini, noise = draws
    assert eps.dtype == jnp.bfloat16

    # the JAX package in float32 on the same f0 and draws
    with monkeypatch.context() as m:
        m.setattr(jconv, "shift_semitones", lambda f, s: jnp.asarray(f0))
        pending = replayed_draws(m, draws)
        ref_f, _ = jax_converter(weights_np, jnp.float32).convert(audio, settings=settings)
    assert not pending

    # the port in bf16 on the same f0 and draws
    tvc = tconv.VoiceConverter.from_state_dicts(
        weights.synthesizer_state_dict(sp), SYNTH3, weights.hubert_state_dict(hp),
        thubert.HubertConfig(**HUBERT), weights.rmvpe_state_dict(rp), index_bank=bank,
        config=CHUNKING, index_int8=True, device="cpu", dtype=torch.bfloat16)
    with monkeypatch.context() as m:
        m.setattr(tconv, "shift_semitones", lambda f, s: torch.from_numpy(f0))
        got, sr_t = tvc.convert(audio, settings=tconv.ConvertSettings(**SETTINGS), draws=dict(
            eps=torch.from_numpy(np.asarray(eps, np.float32)).transpose(1, 2),
            rand_ini=torch.from_numpy(rand_ini), noise=torch.from_numpy(noise)))

    assert sr_t == sr == 16000
    assert got.dtype == ref_b.dtype == np.int16
    assert got.shape == ref_b.shape == ref_f.shape
    assert np.abs(ref_b).max() > 1000
    port_jax = rel_l2(got, ref_b)
    drift = rel_l2(ref_b, ref_f)
    port_f32 = rel_l2(got, ref_f)
    print(f"relative L2 over the int16 waveform: port bf16 vs JAX bf16 {port_jax:.4g}, JAX bf16 "
          f"vs JAX float32 {drift:.4g}, port bf16 vs JAX float32 {port_f32:.4g}")
    assert port_jax <= 2.0 * drift
    assert port_f32 <= 1.5 * drift
