"""The port's separation route against the JAX package's on the CPU: the
STFT and iSTFT, the 4-band chain with a fixed mask, the VR and MDX
networks, the mixer, both separators end to end on 3 s of stereo, the
router and the VR ``.pth`` loader. Weights: the JAX package's ``finit``
shapes with values drawn by ``chip_smoke.lively_array`` (He-scaled
kernels, BatchNorm gains and variances in [0.5, 1.5]; ``finit``'s N(0,
0.02) everywhere would make every mask 0.5), carried to the port by
``compat.weights``."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_port import finit, no_compile_cache_writes, one_thread  # noqa: F401
from rvc_tpu.compat.torch_import import vr_params_from_state_dict
from rvc_tpu.models import mdx_net as jmdx
from rvc_tpu.models import vr_network as jvr
from rvc_tpu.ops import bands as jbands
from rvc_tpu.ops import stft as jstft
from rvc_tpu.pipelines import separate as jsep
from rvc_tpu_torch.compat import torch_import, weights
from rvc_tpu_torch.models import mdx_net as tmdx
from rvc_tpu_torch.models import vr_network as tvr
from rvc_tpu_torch.models.layers import load_numpy_state_dict
from rvc_tpu_torch.ops import bands as tbands
from rvc_tpu_torch.ops import stft as tstft
from rvc_tpu_torch.pipelines import separate as tsep

pytestmark = pytest.mark.usefixtures("one_thread")

NET_TOL = 1e-5  # masks and spectra, relative to the largest: float32 in another order
LSB = 2         # int16 stems: the conversion's CPU bar

# The 2-band layout of tests/test_separation.py narrowed to 64 bins: with
# window_size 384 one window of CascadedASPPNet(128) costs about 40 GFLOP
# (the net's widths are fixed; 672 bins x 512 frames is 0.58 TFLOP).
NARROW = {
    "bins": 64, "unstable_bins": 4, "reduction_bins": 60, "sr": 8000,
    "pre_filter_start": 60, "pre_filter_stop": 64,
    "band": {
        1: {"sr": 2000, "hl": 32, "n_fft": 64, "crop_start": 0, "crop_stop": 20,
            "lpf_start": 10, "lpf_stop": 20, "res_type": "polyphase"},
        2: {"sr": 8000, "hl": 128, "n_fft": 128, "crop_start": 4, "crop_stop": 48,
            "hpf_start": 10, "hpf_stop": 4, "res_type": "polyphase"},
    },
    "mid_side": False, "mid_side_b": False, "mid_side_b2": False,
    "stereo_w": False, "stereo_n": False, "reverse": False,
}
NARROW_WINDOW = 384
TINY_MDX = dict(num_blocks=5, l=1, g=4, bn=2, dim_f=256, norm="GroupNorm2")  # test_separation.py:103
TINY_SPEC = dict(dim_f=256, dim_t=32, n_fft=512, hop=128)


def lively(tree, seed: int = 0):
    """A JAX parameter tree (nested dicts) with every leaf drawn anew by
    ``chip_smoke.lively_array`` in the tree's order."""
    rng = np.random.default_rng(seed)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else
                chip_smoke.lively_array(k, np.shape(v), rng) for k, v in node.items()}

    return walk(jax.tree.map(np.asarray, tree))


def narrow_params(mod):
    mp = mod.ModelParameters()
    mp.param = copy.deepcopy(NARROW)
    return mp


def stereo(seconds: float, sr: int, seed: int = 3) -> np.ndarray:
    """Two partials a channel over seeded noise, (2, T) float32."""
    t = np.arange(int(seconds * sr)) / sr
    rng = np.random.default_rng(seed)
    return np.stack([0.3 * np.sin(2 * np.pi * f * t) + 0.2 * np.sin(2 * np.pi * 2.5 * f * t)
                     + 0.1 * rng.standard_normal(t.size) for f in (220.0, 330.0)]
                    ).astype(np.float32)


def assert_stems_close(ref: dict, got: dict, label: str) -> None:
    for stem in ("vocals", "instrumentals"):
        a, b = ref[stem][0], got[stem][0]
        assert a.dtype == b.dtype == np.int16 and a.shape == b.shape and ref[stem][1] == got[stem][1]
        diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
        print(f"{label} {stem}: max |diff| {diff.max()} LSB, peak {np.abs(a).max()}")
        assert np.abs(a).max() > 1000 and diff.max() <= LSB


@pytest.fixture(scope="module")
def vr128():
    """CascadedASPPNet(n_fft=128): the JAX tree and the port's state_dict."""
    net = jvr.CascadedASPPNet(n_fft=128)
    p = lively(finit(net.init, jax.random.PRNGKey(0), jnp.zeros((1, 128, 65, 2))), seed=1)
    return net, p, weights.vr_state_dict(p)


# ---- ops/stft.py ----

@pytest.mark.parametrize("n_fft,hop", [(320, 80), (640, 80), (960, 480), (6144, 1024)])
def test_stft_istft_spectrogram_match_jax(n_fft, hop):
    """Real and imaginary parts within 1e-5 of the largest |X|; the round
    trip within 1e-6; iSTFT of the same spectrum and the magnitude
    spectrogram within 1e-5 relative; the window equal."""
    x = 0.3 * np.random.default_rng(n_fft).standard_normal((2, 20000)).astype(np.float32)

    def jax_side(x):
        jr, ji = jstft.stft(x, n_fft, hop, n_fft)
        return (jr, ji, jstft.istft(jr, ji, n_fft, hop, length=20000),
                jstft.spectrogram(x, n_fft, hop, n_fft))

    # one compile for the JAX side's three calls, but for the 6144-point
    # bases, which compile slowly as XLA constants
    side = jax_side if n_fft > 4096 else jax.jit(jax_side)
    jr, ji, jback, js = (np.array(a) for a in side(jnp.asarray(x)))
    tr, ti = tstft.stft(torch.from_numpy(x), n_fft, hop)
    scale = max(np.abs(jr).max(), np.abs(ji).max())
    assert tr.shape == jr.shape == (2, 1 + 20000 // hop, n_fft // 2 + 1)
    assert np.abs(tr.numpy() - jr).max() <= NET_TOL * scale
    assert np.abs(ti.numpy() - ji).max() <= NET_TOL * scale
    back = tstft.istft(tr, ti, n_fft, hop, length=20000).numpy()
    n = back.shape[-1]
    assert np.abs(back - x[:, :n]).max() <= 1e-6
    tback = tstft.istft(torch.from_numpy(jr), torch.from_numpy(ji), n_fft, hop,
                        length=20000).numpy()
    assert np.abs(tback - jback).max() <= NET_TOL * np.abs(jback).max()
    ts = tstft.spectrogram(torch.from_numpy(x), n_fft, hop, n_fft).numpy()
    assert ts.shape == js.shape and np.abs(ts - js).max() <= NET_TOL * js.max()
    np.testing.assert_array_equal(tstft.hann_window(n_fft).numpy(),
                                  np.asarray(jstft.hann_window(n_fft)))


# ---- ops/bands.py ----

def _jax_band_chain(audio, mask, mp):
    p = mp.param
    waves, specs = {}, {}
    for d in range(4, 0, -1):
        bp = p["band"][d]
        waves[d] = audio if d == 4 else jbands._resample_np(waves[d + 1],
                                                            p["band"][d + 1]["sr"], bp["sr"])
        specs[d] = jbands.wave_to_spectrogram(waves[d], bp["hl"], bp["n_fft"])
    bp = p["band"][4]
    h = (bp["n_fft"] // 2 - bp["crop_stop"]) + (p["pre_filter_stop"] - p["pre_filter_start"])
    high_end = specs[4][:, bp["n_fft"] // 2 - h: bp["n_fft"] // 2]
    comb = jbands.combine_spectrograms(specs, mp)
    masked = comb * mask[..., : comb.shape[2]]
    he = jbands.mirroring("mirroring", masked, high_end, mp)
    return comb, he, jbands.cmb_spectrogram_to_wave(masked, mp, h, he)


def _port_band_chain(audio, mask, mp):
    p = mp.param
    waves, specs = {}, {}
    for d in range(4, 0, -1):
        bp = p["band"][d]
        waves[d] = audio if d == 4 else tbands.resample(waves[d + 1],
                                                        p["band"][d + 1]["sr"], bp["sr"])
        specs[d] = tbands.wave_to_spectrogram(waves[d], bp["hl"], bp["n_fft"])
    bp = p["band"][4]
    h = (bp["n_fft"] // 2 - bp["crop_stop"]) + (p["pre_filter_stop"] - p["pre_filter_start"])
    high_end = specs[4][:, bp["n_fft"] // 2 - h: bp["n_fft"] // 2]
    comb = tbands.combine_spectrograms(specs, mp)
    masked = comb * mask[..., : comb.shape[2]]
    he = tbands.mirroring("mirroring", masked, high_end, mp)
    return comb, he, tbands.cmb_spectrogram_to_wave(masked, mp, h, he)


def test_four_band_chain_matches_jax():
    """FOURBAND_V2_PARAM on 1 s of stereo at 44.1 kHz, a fixed seeded mask
    in place of the network: the composite spectrogram, the mirrored high end
    and the waveform within 1e-5 of their largest magnitudes. The mirror
    picks by |high end| <= |mirror|; a tie to float32 rounding would flip a
    bin, and the count of flips is printed (none is allowed for)."""
    audio = stereo(1.0, 44100)
    jmp, tmp = jbands.ModelParameters(preset="4band_v2"), tbands.ModelParameters(preset="4band_v2")
    mask = np.random.default_rng(5).uniform(0, 1, (2, 673, 200)).astype(np.float32)
    jc, jhe, jw = _jax_band_chain(audio, mask, jmp)
    tc, the, tw = _port_band_chain(torch.from_numpy(audio), torch.from_numpy(mask), tmp)
    jc, jhe = np.asarray(jc), np.asarray(jhe)
    assert tc.shape == jc.shape and tc.shape[1] == 673 and the.shape == jhe.shape
    assert np.abs(tc.numpy() - jc).max() <= NET_TOL * np.abs(jc).max()
    flips = int(np.sum(np.abs(the.numpy() - jhe) > NET_TOL * np.abs(jhe).max()))
    print(f"mirroring: {flips} of {jhe.size} bins flipped against JAX")
    assert flips == 0
    assert tw.shape == jw.shape
    assert np.abs(tw.numpy() - jw).max() <= NET_TOL * np.abs(jw).max()
    # the other high-end mode and the aggressive vocal reduction, on the
    # composite and a masked copy
    X, y = jc, jc * mask[..., : jc.shape[2]]
    tX, ty = torch.from_numpy(X), torch.from_numpy(y)
    high_end = jc[:, -40:]
    ref = jbands.mirroring("mirroring2", y, high_end, jmp)
    got = tbands.mirroring("mirroring2", ty, torch.from_numpy(high_end), tmp).numpy()
    assert np.abs(got - ref).max() <= NET_TOL * np.abs(ref).max()
    ref = jbands.reduce_vocal_aggressively(X, y, 0.3)
    got = tbands.reduce_vocal_aggressively(tX, ty, 0.3).numpy()
    assert np.abs(got - ref).max() <= NET_TOL * np.abs(ref).max()


# ---- models/vr_network.py ----

def test_cascaded_aspp_net_matches_jax(vr128):
    """CascadedASPPNet(n_fft=128) on (2, 2, 65, 128), with and without the
    aggressiveness exponent: masks within 1e-5."""
    net, p, sd = vr128
    x = np.random.default_rng(6).uniform(0, 1, (2, 128, 65, 2)).astype(np.float32)
    agg = {"split_bin": 20, "value": 0.3}
    port = load_numpy_state_dict(tvr.CascadedASPPNet(128), sd).eval()
    xt = torch.from_numpy(x.transpose(0, 3, 2, 1).copy())
    for a in (None, agg):
        ref = np.asarray(jax.jit(lambda p_, x_: net.apply(p_, x_, aggressiveness=a))(
            p, jnp.asarray(x)))
        with torch.no_grad():
            got = port(xt, a).numpy().transpose(0, 3, 2, 1)
        assert ref.std() > 0.01  # not a constant mask
        assert np.abs(got - ref).max() <= NET_TOL


def test_aspp_module_matches_jax():
    """ASPPModule alone at 6 channels on a 44-bin x 56-frame map with
    content that differs along each axis, so that every tap of the dilated
    depthwise branches (4, 8 and 16) reads data in both axes (the nets
    above reach their ASPPs at 2-4 bins) and a swap of the bins and frames
    axes would show: within 1e-5 of the largest output, and the kernels
    left time-major told apart."""
    rng = np.random.default_rng(12)
    f, t = np.arange(44)[:, None], np.arange(56)[None, :]
    ramp = np.sin(0.37 * f) + 0.05 * t  # not symmetric under bins <-> frames
    x = (rng.uniform(0, 1, (2, 6, 44, 56)) + ramp).astype(np.float32)  # (B, C, F, T)
    xj = jnp.asarray(x.transpose(0, 3, 2, 1))  # the JAX nets run (B, T, F, C)
    net = jvr.ASPPModule(6, 10)
    p = lively(finit(net.init, jax.random.PRNGKey(0), xj), seed=6)
    ref = np.asarray(jax.jit(net.apply)(p, xj)).transpose(0, 3, 2, 1)
    sd = {k.removeprefix("aspp."): v
          for k, v in weights.vr_state_dict({"aspp": p["params"]}).items()}
    port = load_numpy_state_dict(tvr.ASPPModule(6, 10), sd).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 10, 44, 56) and ref.std() > 0.01
    assert np.abs(got - ref).max() <= NET_TOL * np.abs(ref).max()
    # the kernels taken without swapping their spatial axes back are told apart
    unswapped = {k: np.ascontiguousarray(v.swapaxes(2, 3)) if v.ndim == 4 else v
                 for k, v in sd.items()}
    bad = load_numpy_state_dict(tvr.ASPPModule(6, 10), unswapped).eval()
    with torch.no_grad():
        wrong = bad(torch.from_numpy(x)).numpy()
    assert np.abs(wrong - ref).max() > 100 * NET_TOL * np.abs(ref).max()


def test_cascaded_net_matches_jax():
    """The "new" cascade (BiLSTM branch) at nout 8, nout_lstm 16 on
    (1, 2, 65, 64): mask within 1e-5."""
    net = jvr.CascadedNet(n_fft=128, nout=8, nout_lstm=16)
    x = np.random.default_rng(7).uniform(0, 1, (1, 64, 65, 2)).astype(np.float32)
    p = lively(finit(net.init, jax.random.PRNGKey(0), jnp.asarray(x)), seed=2)
    ref = np.asarray(jax.jit(net.apply)(p, jnp.asarray(x)))
    port = load_numpy_state_dict(tvr.CascadedNet(128, 8, 16), weights.vr_state_dict(p)).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x.transpose(0, 3, 2, 1).copy())).numpy().transpose(0, 3, 2, 1)
    assert ref.std() > 0.01  # not a constant mask
    assert np.abs(got - ref).max() <= NET_TOL


# ---- models/mdx_net.py ----

@pytest.mark.parametrize("norm", ["BatchNorm", "InstanceNorm", "GroupNorm2", "none"])
def test_conv_tdf_nets_match_jax(norm):
    """ConvTDFNetTrim at test_separation.py:103's tiny config and TFCTDFNet
    at :38's, each with this norm: within 1e-5 of the largest output."""
    rng = np.random.default_rng(8)
    cfg = dict(TINY_MDX, norm=norm)
    jnet = jmdx.ConvTDFNetTrim(**cfg)
    x = rng.standard_normal((2, 32, 256, 4)).astype(np.float32)
    p = lively(finit(jnet.init, jax.random.PRNGKey(0), jnp.asarray(x)), seed=3)
    ref = np.asarray(jax.jit(jnet.apply)(p, jnp.asarray(x)))
    port = load_numpy_state_dict(tmdx.ConvTDFNetTrim(**cfg), weights.convtdf_state_dict(p)).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy().transpose(0, 2, 3, 1)
    assert np.abs(got - ref).max() <= NET_TOL * np.abs(ref).max()

    cfg = dict(num_targets=2, num_subbands=2, num_scales=2, scale=(2, 2),
               num_blocks_per_scale=1, c=4, g=4, bn=2, dim_f=64, norm=norm)
    jnet = jmdx.TFCTDFNet(**cfg)
    x = rng.standard_normal((1, 8, 64, 4)).astype(np.float32)
    p = lively(finit(jnet.init, jax.random.PRNGKey(0), jnp.asarray(x)), seed=4)
    ref = np.asarray(jax.jit(jnet.apply)(p, jnp.asarray(x)))
    port = load_numpy_state_dict(tmdx.TFCTDFNet(**cfg), weights.convtdf_state_dict(p)).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    got = got.transpose(0, 1, 3, 4, 2)
    assert got.shape == ref.shape == (1, 2, 8, 64, 4)
    assert np.abs(got - ref).max() <= NET_TOL * np.abs(ref).max()


def test_mdx_spectrogram_and_mixer_match_jax():
    """MDXSpectrogram's pack and unpack (1e-5 relative) and apply_mixer
    (within 1e-6 of the largest output)."""
    rng = np.random.default_rng(9)
    jsp, tsp = jmdx.MDXSpectrogram(**TINY_SPEC), tmdx.MDXSpectrogram(**TINY_SPEC)
    x = rng.standard_normal((3, 2, jsp.chunk_size)).astype(np.float32)
    ref = np.asarray(jsp.pack(jnp.asarray(x)))
    got = tsp.pack(torch.from_numpy(x)).numpy().transpose(0, 2, 3, 1)
    assert np.abs(got - ref).max() <= NET_TOL * np.abs(ref).max()
    back = np.asarray(jsp.unpack(jnp.asarray(ref)))
    tback = tsp.unpack(torch.from_numpy(ref.transpose(0, 3, 1, 2).copy())).numpy()
    assert np.abs(tback - back).max() <= NET_TOL * np.abs(back).max()
    w = rng.standard_normal((8, 10)).astype(np.float32)
    stems = rng.standard_normal((4, 2, 1000)).astype(np.float32)
    orig = rng.standard_normal((2, 1000)).astype(np.float32)
    ref = np.asarray(jmdx.apply_mixer(w, jnp.asarray(stems), jnp.asarray(orig)))
    got = tmdx.apply_mixer(w, torch.from_numpy(stems), torch.from_numpy(orig)).numpy()
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


# ---- pipelines/separate.py ----

@pytest.fixture(scope="module")
def jax_vr(vr128):
    """One JAX VRSeparator for both cases, so that its compiled network is
    shared between them (``tta`` is read at each call)."""
    return jsep.VRSeparator(vr128[1], narrow_params(jbands), agg=10, window_size=NARROW_WINDOW)


def _mask_times_mix(sep):
    """JAX's ``VRSeparator._predict_mask`` with each window's mask multiplied
    by the window's input, as the reference's net returns mask * mix: the
    magnitude ``separate_spec`` then scales by max|X| is the mask times the
    mix's (ROADMAP §3, "Kept in mind": JAX takes the mask alone)."""
    predict = sep._predict_mask

    def masked(X_mag_pad, roi_size, split_bin, agg_value):
        mask = predict(X_mag_pad, roi_size, split_bin, agg_value)
        mix = X_mag_pad[:, :, sep.offset: sep.offset + mask.shape[2]]
        return mask * np.pad(mix, ((0, 0), (0, 0), (0, mask.shape[2] - mix.shape[2])))

    return masked


@pytest.fixture
def jax_vr_mask_times_mix(jax_vr, monkeypatch):
    monkeypatch.setattr(jax_vr, "_predict_mask", _mask_times_mix(jax_vr))
    return jax_vr


@pytest.mark.parametrize("tta", [False, True])
def test_vr_separator_matches_jax(vr128, jax_vr_mask_times_mix, tta):
    """VRSeparator.run_inference on 3 s of stereo at 8 kHz through the
    narrowed 2-band layout (two windows, three with tta), against JAX's
    VRSeparator (the CPU route of nodes.py:681-682) with its mask applied to
    the mix as the reference does (``_mask_times_mix``): both int16 stems
    within 2 LSB."""
    sd = vr128[2]
    audio = stereo(3.0, 8000)
    jax_vr = jax_vr_mask_times_mix
    jax_vr.tta = tta
    ref = jax_vr.run_inference(audio, 8000)
    got = tsep.VRSeparator(sd, narrow_params(tbands), agg=10, window_size=NARROW_WINDOW,
                           tta=tta, device="cpu").run_inference(audio, 8000)
    assert got["sr"] == ref["sr"] == 8000
    assert_stems_close(ref, got, f"VR tta={tta}")


def test_jax_vr_instrumental_magnitude_ignores_the_mix(vr128, jax_vr, monkeypatch):
    """A defect of the JAX package (ROADMAP §3): its instrumental magnitude
    is the mask times max|X| in every bin, where the reference's net returns
    mask * mix, so bins without signal get a magnitude near the mask's mean
    times max|X| with the phase of rounding noise. The port takes mask * mix.
    Both on a composite whose upper half is zero: JAX's instrumental there is
    above a tenth of max|X|, the port's is 0 and its vocal 0; against JAX's
    separator with the mask applied to the mix (``_mask_times_mix``) the
    port's spectra are within 1e-5 of the largest."""
    rng = np.random.default_rng(11)
    X = (rng.standard_normal((2, 65, 188)) + 1j * rng.standard_normal((2, 65, 188)))
    X = X.astype(np.complex64)
    X[:, 33:] = 0
    scale = np.abs(X).max()
    jax_vr.tta = False
    jy = np.asarray(jax_vr.separate_spec(X)[0])
    assert np.abs(jy[:, 33:]).mean() > 0.1 * scale
    port = tsep.VRSeparator(vr128[2], narrow_params(tbands), agg=10,
                            window_size=NARROW_WINDOW, device="cpu")
    ty, tv = (a.numpy() for a in port.separate_spec(torch.from_numpy(X)))
    assert np.abs(ty[:, 33:]).max() == 0 and np.abs(tv[:, 33:]).max() == 0
    monkeypatch.setattr(jax_vr, "_predict_mask", _mask_times_mix(jax_vr))
    jy, jv = (np.asarray(a) for a in jax_vr.separate_spec(X))
    assert np.abs(ty - jy).max() <= NET_TOL * scale and np.abs(tv - jv).max() <= NET_TOL * scale
    assert np.abs(ty).max() > 0.1 * scale  # not an empty instrumental


@pytest.mark.parametrize("denoise", [False, True])
def test_mdx_separator_matches_jax(denoise):
    """MDXSeparator.run_inference on 3 s of stereo at 44.1 kHz, the tiny net,
    1 s segments with half-second margins (three segments, margins cut) and
    compensation 1.03, against JAX's MDXSeparator: stems within 2 LSB."""
    jnet = jmdx.ConvTDFNetTrim(**TINY_MDX)
    p = lively(finit(jnet.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 256, 4))), seed=5)
    kw = dict(TINY_SPEC, chunks=1, margin=22050, compensation=1.03, denoise=denoise)
    audio = stereo(3.0, 44100)
    ref = jsep.MDXSeparator(p, net=jnet, **kw).run_inference(audio, 44100)
    got = tsep.MDXSeparator(weights.convtdf_state_dict(p), net=tmdx.ConvTDFNetTrim(**TINY_MDX),
                            device="cpu", **kw).run_inference(audio, 44100)
    assert got["sr"] == ref["sr"] == 44100
    np.testing.assert_array_equal(got["input_audio"][0], ref["input_audio"][0])
    assert_stems_close(ref, got, f"MDX denoise={denoise}")


def test_route_separator_matches_jax():
    names = ["UVR-MDX-NET-vocal.onnx", "UVR-DeEcho-DeReverb.pth", "HP5-vocals.pth",
             "5_HP-Karaoke-UVR.pth", "onnx_dereverb_By_FoxJoy", "htdemucs.th",
             "hdemucs_mmi.yaml", "tasnet_extra.th", "model_bs_roformer_ep_317.ckpt",
             "MelBandRoformer.ckpt", "VR-DeEchoAggressive.pth", "/a/b/Kim_Vocal_2.onnx",
             "UVR_MDXNET_KARA_2.onnx", "2_HP-UVR.pth"]
    for n in names:
        assert tsep.route_separator(n) == jsep.route_separator(n), n


def test_load_vr_pth_gives_back_the_jax_tree(vr128, tmp_path):
    """A .pth written from the bridge (reference names, plus the
    training-only aux outputs and num_batches_tracked a real file holds):
    the port's loader gives the bridge's arrays, and JAX's
    vr_params_from_state_dict of the same file gives back the JAX tree."""
    _, p, sd = vr128
    saved = {k: torch.from_numpy(v) for k, v in sd.items()}
    saved["aux1_out.weight"] = torch.zeros(2, 32, 1, 1)
    saved["stg2_bridge.conv.1.num_batches_tracked"] = torch.tensor(3)
    path = tmp_path / "HP2-4BAND.pth"
    torch.save(saved, path)
    got = torch_import.load_vr_pth(str(path))
    assert got.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(got[k], sd[k])
    back = jax.tree.map(np.asarray, vr_params_from_state_dict(
        torch.load(path, map_location="cpu", weights_only=True)))
    flat = weights.flatten_tree(back["params"])
    want = weights.flatten_tree(p["params"])
    assert flat.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k])


def test_load_separator_names_what_is_not_ported():
    """Every kind the router gives is ported and reads its file (the
    RoFormers since their slice); a kind no router gives is named."""
    for kind in ("bs_roformer", "mel_roformer", "demucs"):
        with pytest.raises(FileNotFoundError):
            tsep.load_separator(kind, "model.th", device="cpu")
    with pytest.raises(ValueError, match="unknown separator kind 'scnet'"):
        tsep.load_separator("scnet", "model.th", device="cpu")
