"""Separation in bfloat16 against the JAX package in bfloat16, on the CPU:
each network of the separation routes (CascadedASPPNet, ConvTDFNetTrim,
ConvTasNet, the v2 Demucs, HTDemucs, HDemucs, BSRoformer and its attention,
MelBandRoformer) at tiny widths, and the VR and BS-RoFormer
separators read from their files through ``load_separator(...,
dtype=torch.bfloat16)``. Both sides get the same float32 numpy weights (both
cast them at use) and the same float32 inputs.

The JAX networks run jitted with XLA's excess precision off
(``xla_allow_excess_precision``): every op rounds to bf16 as it does op by
op, without the minute per net that op-by-op dispatch costs (on
CascadedASPPNet the two give the same bits). The separators run as JAX
builds them.

Bars, fixed before the first run.
  * A network's output: within the larger of FLOOR, 1e-2 of its largest
    magnitude (2.5 bf16 ulps there), and the JAX module's own distance
    between its bf16 and float32 outputs on the same inputs, as
    tests/test_torch_bf16_models.py holds the conversion's modules: the
    port in bf16 no farther from JAX in bf16 than bf16 is from float32.
  * A separator's stems, relative L2 over each int16 stem, as
    tests/test_torch_bf16_convert.py holds the bf16 conversion: the port's
    bf16 stems within twice JAX's own bf16-to-float32 distance of JAX's bf16
    stems, and within 1.5 times it of JAX's float32 stems.
Every distance is printed beside its bar."""
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_port import finit, no_compile_cache_writes, one_thread  # noqa: F401
from test_torch_demucs import HDEMUCS, TINY_TASNET, randn
from test_torch_roformer import bs_cfgs, jax_params, mel_cfgs, narrow_state
from test_torch_separation import (NARROW, NARROW_WINDOW, TINY_MDX, _mask_times_mix, lively,
                                   narrow_params, stereo)
from rvc_tpu.compat import torch_import as jimport
from rvc_tpu.models import bs_roformer as jbs
from rvc_tpu.models import demucs as jdm
from rvc_tpu.models import htdemucs as jht
from rvc_tpu.models import mdx_net as jmdx
from rvc_tpu.models import mel_roformer as jmel
from rvc_tpu.models import tasnet as jts
from rvc_tpu.models import vr_network as jvr
from rvc_tpu.ops import bands as jbands
from rvc_tpu.pipelines import separate as jsep
from rvc_tpu_torch.compat import weights
from rvc_tpu_torch.models import bs_roformer as tbs
from rvc_tpu_torch.models import demucs as tdm
from rvc_tpu_torch.models import htdemucs as tht
from rvc_tpu_torch.models import mdx_net as tmdx
from rvc_tpu_torch.models import mel_roformer as tmel
from rvc_tpu_torch.models import tasnet as tts
from rvc_tpu_torch.models import vr_network as tvr
from rvc_tpu_torch.models.layers import load_numpy_state_dict, set_dtype_
from rvc_tpu_torch.ops import bands as tbands
from rvc_tpu_torch.pipelines import separate as tsep

pytestmark = pytest.mark.usefixtures("one_thread")

BF = torch.bfloat16
JBF = jnp.bfloat16
FLOOR = 1e-2


def jax_run(fn, *args):
    """``fn(*args)`` jitted with XLA's excess precision off: each op rounds
    to its dtype as op by op."""
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return np.asarray(compiled(*args), np.float32)


def rel_max(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def held(label: str, got: torch.Tensor, ref_bf: np.ndarray, ref_f32: np.ndarray) -> None:
    """got (the port in bf16, in the port's layout) against ref_bf (JAX in
    bf16, moved to that layout), with the bar max(FLOOR, distance of ref_bf
    from ref_f32)."""
    got = got.detach().float().numpy()
    assert got.shape == ref_bf.shape == ref_f32.shape, (got.shape, ref_bf.shape)
    port, drift = rel_max(got, ref_bf), rel_max(ref_bf, ref_f32)
    print(f"{label}: port bf16 vs JAX bf16 {port:.3g}, JAX bf16 vs JAX float32 {drift:.3g} "
          f"(of the largest magnitude; bar {max(FLOOR, drift):.3g})")
    assert np.isfinite(got).all() and np.abs(ref_f32).max() > 0
    assert port <= max(FLOOR, drift), (label, port, drift)


def both(make, params, *args, **kw):
    """JAX's module ``make(dtype)`` applied in bf16 and in float32."""
    return [jax_run(lambda p, *a: make(dt).apply(p, *a, **kw), params, *args)
            for dt in (JBF, jnp.float32)]


def port_run(module, state: dict, *args, **kw) -> torch.Tensor:
    module = set_dtype_(load_numpy_state_dict(module, state).eval(), BF)
    with torch.no_grad():
        return module(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args), **kw)


# ---- the VR networks ----

def test_cascaded_aspp_net_bf16_matches_jax():
    """CascadedASPPNet(n_fft=128) on (1, 2, 65, 64) with the separator's
    aggressiveness (a float32 ``value``, so the exponent is taken in
    float32): the 2x upsampling's two passes, the depthwise dilated convs,
    the leaky slope and the sigmoid in bf16."""
    net = jvr.CascadedASPPNet(n_fft=128)
    p = lively(finit(net.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 65, 2))), seed=1)
    x = np.random.default_rng(6).uniform(0, 1, (1, 64, 65, 2)).astype(np.float32)
    refs = both(lambda dt: jvr.CascadedASPPNet(n_fft=128, dtype=dt), p, x,
                aggressiveness={"split_bin": 20, "value": jnp.float32(0.3)})
    got = port_run(tvr.CascadedASPPNet(128), weights.vr_state_dict(p), x.transpose(0, 3, 2, 1),
                   aggressiveness={"split_bin": 20, "value": 0.3})
    assert got.dtype == torch.float32 and refs[1].std() > 0.01
    held("CascadedASPPNet", got, *(r.transpose(0, 3, 2, 1) for r in refs))


def test_jax_cascaded_net_bf16_lstm_fails():
    """A defect of the JAX package (ROADMAP §3): the "new" VR cascade's
    BiLSTM adds its float32 biases to bf16 products, so its scan's carry
    turns float32 and ``CascadedNet(dtype=bfloat16)`` cannot trace. No
    separator builds that net (``route_separator`` sends DeEcho / DeReverb
    names to CascadedASPPNet), so the port gives it no bf16 form either."""
    net = jvr.CascadedNet(n_fft=128, nout=8, nout_lstm=16, dtype=JBF)
    with pytest.raises(TypeError, match="carry"):
        jax.eval_shape(net.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 65, 2)))


# ---- MDX-Net ----

@pytest.mark.parametrize("norm", ["GroupNorm2", "InstanceNorm"])
def test_conv_tdf_net_bf16_matches_jax(norm):
    """ConvTDFNetTrim at test_separation.py:103's tiny config with the UVR
    layout's GroupNorm2 or InstanceNorm: statistics in float32, the rest in
    bf16; a float32 input cast at the first conv, as the separator feeds it."""
    cfg = dict(TINY_MDX, norm=norm)
    x = np.random.default_rng(8).standard_normal((2, 16, 256, 4)).astype(np.float32)
    jnet = jmdx.ConvTDFNetTrim(**cfg)
    p = lively(finit(jnet.init, jax.random.PRNGKey(0), jnp.asarray(x)), seed=3)
    refs = both(lambda dt: jmdx.ConvTDFNetTrim(**cfg, dtype=dt), p, x)
    got = port_run(tmdx.ConvTDFNetTrim(**cfg), weights.convtdf_state_dict(p),
                   x.transpose(0, 3, 1, 2))
    assert got.dtype == BF
    held(f"ConvTDFNetTrim {norm}", got, *(r.transpose(0, 3, 1, 2) for r in refs))


def test_jax_mdx_unpack_runs_the_istft_in_bf16():
    """A defect of the JAX package (ROADMAP §3): ``MDXSpectrogram.unpack``
    casts its iSTFT bases to the spectrogram's dtype, so JAX's bf16 MDX
    separator rounds the bases and every waveform sum to bf16 (a waveform in
    steps of 2^-8 near full scale). The port's unpack takes the network's
    output up to float32 first: its waveform from a bf16 spectrogram equals
    the float32 unpack of the same values."""
    jsp = jmdx.MDXSpectrogram(dim_f=64, dim_t=16, n_fft=128, hop=32)
    tsp = tmdx.MDXSpectrogram(dim_f=64, dim_t=16, n_fft=128, hop=32)
    spec = np.random.default_rng(9).standard_normal((1, 16, 64, 4)).astype(np.float32)
    spec_bf = torch.from_numpy(spec).to(BF)
    values = spec_bf.float().numpy()  # the bf16 values, held in float32
    unpack = jax.jit(jsp.unpack)
    jwave = unpack(jnp.asarray(values).astype(JBF))
    ref = np.asarray(unpack(jnp.asarray(values)))
    assert jwave.dtype == JBF
    print(f"JAX's bf16 unpack against its float32 unpack of the same values: "
          f"{rel_max(np.asarray(jwave, np.float32), ref):.3g} of the largest")
    assert rel_max(np.asarray(jwave, np.float32), ref) > 1e-3
    got = tsp.unpack(spec_bf.permute(0, 3, 1, 2))
    want = tsp.unpack(torch.from_numpy(values).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert rel_max(got.numpy(), ref) <= 1e-5


# ---- Conv-TasNet and the Demucs family ----

@pytest.mark.parametrize("mask", ["relu", "softmax"])
def test_tasnet_bf16_matches_jax(mask):
    """Conv-TasNet (gLN): the norms' statistics in float32, PReLU, the
    depthwise conv as JAX's shifted multiply-adds with each product and sum
    rounded (one grouped conv rounded once measured 1.20e-2 and 1.42e-2
    against the bars 1.18e-2 and 1.01e-2), the mask (relu, or the softmax
    over sources), the half-frame overlap-add in bf16, the stems in
    float32."""
    cfg = dict(TINY_TASNET, mask_nonlinear=mask)
    x = randn(2, TINY_TASNET["L"] * 40 + 3, 2, seed=13)
    jmod = jts.ConvTasNet(**cfg)
    p = lively(finit(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x)))
    refs = both(lambda dt: jts.ConvTasNet(**cfg, dtype=dt), p, x)
    got = port_run(tts.ConvTasNet(**cfg), weights.tasnet_state_dict(p, TINY_TASNET),
                   x.transpose(0, 2, 1))
    assert got.dtype == torch.float32
    held(f"ConvTasNet {mask}", got, *(r.transpose(0, 1, 3, 2) for r in refs))


def _demucs_case(jmod, tmod, x, label, seed=0):
    init = functools.partial(fnn.Module.init, jmod)
    p = lively(finit(init, jax.random.PRNGKey(0), jnp.asarray(x)), seed)
    refs = both(lambda dt: jmod.clone(dtype=dt), p, x)
    got = port_run(tmod, weights.demucs_state_dict(p), x.transpose(0, 2, 1))
    assert got.dtype == torch.float32
    held(label, got, *(r.transpose(0, 1, 3, 2) for r in refs))


def test_demucs_v2_bf16_matches_jax():
    """The v2 waveform U-Net with a 2-layer BiLSTM through ``layers.lstm``,
    GELU and GLU in bf16, the 2x resampling and the stems in float32."""
    kw = dict(sources=("vocals", "other"), channels=4, depth=3, lstm_layers=2, resample=True)
    jmod = jdm.Demucs(**kw)
    _demucs_case(jmod, tdm.Demucs(**kw), randn(2, jmod.valid_length(1000), 2, seed=12),
                 "Demucs v2")


def test_htdemucs_bf16_matches_jax():
    """HTDemucs v4 with bottom channels: the cross-domain transformer's
    projections, softmax, LayerScale and the positional embeddings in bf16,
    the frequency embedding's scalars rounded, the masks and iSTFT in
    float32."""
    kw = dict(sources=("a", "b"), audio_channels=2, channels=16, depth=2, nfft=256,
              norm_starts=1, t_layers=2, t_heads=2, bottom_channels=8, use_train_segment=False)
    _demucs_case(jht.HTDemucs(**kw), tht.HTDemucs(**kw), 0.3 * randn(1, 1024, 2, seed=10),
                 "HTDemucs")


def test_hdemucs_bf16_matches_jax():
    """HDemucs v3 (CaC) with the BLSTM and LocalState in its inner DConvs."""
    kw = dict(sources=("a", "b"), audio_channels=2, **HDEMUCS["cac"])
    _demucs_case(jht.HDemucs(**kw), tht.HDemucs(**kw), 0.3 * randn(1, 640, 2, seed=8), "HDemucs")


# ---- the RoFormers ----

def test_roformer_attention_bf16_matches_jax():
    """The RoFormer attention at the released head width (2 heads of 64) over
    96 tokens: the float32-rotated q and k, float32 scores and softmax
    through SDPA on v taken up to float32, the output rounded (JAX rounds
    the probabilities before p v instead), the gates in bf16."""
    jc, _ = bs_cfgs(dim=64, heads=2, dim_head=64)
    x = np.random.default_rng(4).standard_normal((2, 96, 64)).astype(np.float32)
    cos, sin = (np.asarray(t) for t in jbs._rotary_tables(96, 64, 10000.0))
    params = jax_params(jbs.Attention(jc), x, cos, sin, seed=5)
    refs = both(lambda dt: jbs.Attention(jc, dtype=dt), params, x, cos, sin)
    got = port_run(tbs.Attention(64, 2, 64), weights.roformer_state_dict(params), x, cos, sin)
    assert got.dtype == BF
    held("RoFormer Attention", got, *refs)


@pytest.mark.parametrize("kind", ["bs", "mel"])
def test_roformer_bf16_matches_jax(kind):
    """BSRoformer and MelBandRoformer at the tiny configs (2 stems): the
    features cast to bf16, the RMSNorms in float32, the attention's float32
    scores and softmax from the rotated q and k, the probabilities rounded
    before p v, the gates, GELU and GLU in bf16; the Mel masks summed onto
    their bins in float32; the masked spectrograms in float32."""
    jc, tc = (bs_cfgs if kind == "bs" else mel_cfgs)(num_stems=2)
    jcls, tcls = ((jbs.BSRoformer, tbs.BSRoformer) if kind == "bs"
                  else (jmel.MelBandRoformer, tmel.MelBandRoformer))
    spec = np.random.default_rng(5).standard_normal((2, 7, 18, 2)).astype(np.float32)
    params = jax_params(jcls(jc), spec, seed=3)
    refs = both(lambda dt: jcls(jc, dtype=dt), params, spec)
    got = port_run(tcls(tc), weights.roformer_state_dict(params), spec)
    assert got.dtype == torch.float32
    held(f"{kind} RoFormer", got, *refs)


# ---- the separators, from their files ----

def held_stems(label: str, got: dict, ref_bf: dict, ref_f32: dict) -> None:
    """Relative L2 over each int16 stem: the port's bf16 stems within twice
    JAX's own bf16-to-float32 distance of JAX's bf16 stems, and within 1.5
    times it of JAX's float32 stems."""
    stems = [k for k in ref_bf if k not in ("sr", "input_audio")]
    assert stems == [k for k in got if k not in ("sr", "input_audio")]
    for stem in stems:
        g, b, f = (np.asarray(d[stem][0], np.float64) for d in (got, ref_bf, ref_f32))
        assert g.shape == b.shape == f.shape and np.abs(f).max() > 1000
        l2 = lambda a, r: float(np.linalg.norm(a - r) / np.linalg.norm(r))  # noqa: E731
        port_jax, port_f32, drift = l2(g, b), l2(g, f), l2(b, f)
        print(f"{label} {stem}: relative L2 port bf16 vs JAX bf16 {port_jax:.4g} (bar "
              f"{2 * drift:.4g}), vs JAX float32 {port_f32:.4g} (bar {1.5 * drift:.4g}); JAX "
              f"bf16 vs JAX float32 {drift:.4g}")
        assert port_jax <= 2.0 * drift and port_f32 <= 1.5 * drift


def test_vr_separator_bf16_matches_jax(tmp_path, monkeypatch):
    """A VR .pth through ``load_separator("vr", ..., dtype=bfloat16)`` with the
    4-band layout narrowed to test_torch_separation.py's 64 bins and its
    384-frame window, on 1.5 s of stereo at 8 kHz, against JAX's
    VRSeparator at ``dtype=bfloat16`` and float32 on JAX's reading of the
    same file, with its mask applied to the mix (``_mask_times_mix``)."""
    monkeypatch.setattr(tbands, "FOURBAND_V2_PARAM", NARROW)
    monkeypatch.setattr(tsep, "VRSeparator",
                        functools.partial(tsep.VRSeparator, window_size=NARROW_WINDOW))
    path = str(tmp_path / "HP2-4BAND-3090_4band_v2.pth")
    chip_smoke.write_vr_pth(path, NARROW["bins"] * 2, seed=26)
    sep = tsep.load_separator(tsep.route_separator(path), path, 10.0, device="cpu", dtype=BF)
    assert all(m.dtype == BF for m in sep.model.modules())
    params = jimport.vr_params_from_state_dict(torch.load(path, weights_only=True))
    audio = stereo(1.5, 8000)
    refs = []
    for dt in (JBF, jnp.float32):
        jax_vr = jsep.VRSeparator(params, narrow_params(jbands), agg=10,
                                  window_size=NARROW_WINDOW, dtype=dt)
        monkeypatch.setattr(jax_vr, "_predict_mask", _mask_times_mix(jax_vr))
        refs.append(jax_vr.run_inference(audio, 8000))
    held_stems("VR", sep.run_inference(audio, 8000), *refs)


def test_bs_roformer_separator_bf16_matches_jax(tmp_path):
    """A BS-RoFormer .ckpt at the released STFT (n_fft 2048, hop 441), its
    1025 bins in 3 bands, narrowed to dim 16, one layer and head, through
    ``load_separator("bs_roformer", ..., dtype=bfloat16)`` on 1 s of stereo
    (one 8 s window), against JAX's BSRoformerSeparator from JAX's loader at
    ``dtype=bfloat16`` and float32."""
    cfg, state = narrow_state("bs", 21, freqs_per_bands=(128, 256, 641))
    path = str(tmp_path / "model_bs_roformer_ep_317_sdr_12.9755.ckpt")
    chip_smoke.write_roformer_ckpt(path, state, cfg, lightning=True)
    sep = tsep.load_separator(tsep.route_separator(path), path, device="cpu", dtype=BF)
    assert sep.model.dtype == BF
    song = stereo(1.0, 44100)
    params, jcfg = jimport.load_bs_roformer(path)
    refs = [jbs.BSRoformerSeparator(params, jcfg, dtype=dt).run_inference(song, 44100)
            for dt in (JBF, jnp.float32)]
    held_stems("BS-RoFormer", sep.run_inference(song, 44100), *refs)
