"""The port's BS-RoFormer and Mel-Band RoFormer against the JAX package's on
the CPU: each module (RMSNorm, the rotary tables, Attention, Transformer,
BandSplit, MaskEstimator) and both models on tiny spectrograms, the mel
band layout, both config inferers on ``.ckpt`` files in their forms, both
separators (``demix`` and ``run_inference``, 1.5 windows so that the
overlap-add runs), ``load_separator`` and the CLI's ``separate``. JAX
trees carry over by ``compat.weights.roformer_state_dict``; files are
written by ``chip_smoke``'s writers at narrow widths."""
import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_port import finit, no_compile_cache_writes, one_thread  # noqa: F401
from test_torch_separation import stereo
from rvc_tpu.compat import torch_import as jimport
from rvc_tpu.models import bs_roformer as jbs
from rvc_tpu.models import mel_roformer as jmel
from rvc_tpu_torch.cli import main as cli
from rvc_tpu_torch.compat import torch_import, weights
from rvc_tpu_torch.models import bs_roformer as tbs
from rvc_tpu_torch.models import mel_roformer as tmel
from rvc_tpu_torch.models.layers import load_numpy_state_dict
from rvc_tpu_torch.pipelines import separate as tsep

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-5  # of max(1, the largest output): the same float32 math, summed in another order
LSB = 2     # int16 stems: the conversion's CPU bar (1 expected)

TINY = dict(dim=32, depth=2, stereo=True, num_stems=2, dim_head=8, heads=2, ff_mult=2,
            n_fft=16, hop_length=8, win_length=16, mask_estimator_depth=2,
            mlp_expansion_factor=2)
TINY_BANDS = (2, 3, 4)  # 9 bins at n_fft 16
# an overlapping layout over the 9 bins (stereo: 18 slots), as tests/test_mel_roformer.py's
_MEL_BANDS = [(0, 1, 2), (1, 2, 3, 4), (4, 5, 6, 7, 8)]
TINY_MEL = dict(num_bands=3, freq_indices=tuple(f * 2 + c for b in _MEL_BANDS for f in b
                                                for c in (0, 1)),
                band_widths=tuple(2 * len(b) for b in _MEL_BANDS))
# through the loaders, load_separator and the CLI: the released layouts
# (n_fft 2048, hop 441, 62 or 60 bands) at a narrow width, one layer, one head
NARROW = dict(dim=16, depth=1, heads=1, dim_head=16)


def lively(tree, rng):
    """A JAX RoFormer tree redrawn: every Linear's weight and bias uniform in
    +-1/sqrt(fan_in) (torch's and the JAX initializer's scale), every gamma
    1 + N(0, 0.1^2), so that no norm's gain is the identity."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and "weight" in v:
            b = 1.0 / math.sqrt(v["weight"].shape[1])
            out[k] = {kk: rng.uniform(-b, b, vv.shape).astype(np.float32) for kk, vv in v.items()}
        elif isinstance(v, dict):
            out[k] = lively(v, rng)
        else:
            assert k == "gamma", k
            out[k] = (1 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    return out


def jax_params(module, *args, seed=0):
    """Lively JAX params of ``module`` (initialized on ``args``), as numpy."""
    p = finit(lambda *a: module.init(jax.random.PRNGKey(0), *a), *args)
    return {"params": lively(p["params"], np.random.default_rng(seed))}


def port(module, params):
    load_numpy_state_dict(module, weights.roformer_state_dict(params))
    return module.eval()


def assert_close(got, ref, label: str, tol: float = TOL) -> None:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    print(f"{label}: max |diff| {err:.3g}, largest {np.abs(ref).max():.3g}")
    assert err <= tol * max(1.0, np.abs(ref).max())


def run(module, *args):
    with torch.no_grad():
        return module(*(torch.from_numpy(np.asarray(a)) for a in args)).numpy()


def bs_cfgs(**kw):
    """(JAX, port) BSRoformerConfig with the same fields."""
    j = jbs.BSRoformerConfig(**{**TINY, "freqs_per_bands": TINY_BANDS, **kw})
    return j, tbs.BSRoformerConfig(**dataclasses.asdict(j))


def mel_cfgs(**kw):
    j = jmel.MelRoformerConfig(**{**TINY, **TINY_MEL, **kw})
    return j, tmel.MelRoformerConfig(**dataclasses.asdict(j))


# ---- modules ----

def test_rmsnorm_matches_jax():
    x = np.random.default_rng(0).standard_normal((3, 5, 24)).astype(np.float32)
    x[0, 0] = 0  # the 1e-24 floor: a zero row stays zero
    params = jax_params(jbs.RMSNorm(24), x)
    ref = jbs.RMSNorm(24).apply(params, x)
    assert_close(run(port(tbs.RMSNorm(24), params), x), ref, "RMSNorm")


def test_rotary_tables_and_rotation_match_jax():
    for n, dh in ((801, 64), (62, 64), (7, 8)):
        jc, js = jbs._rotary_tables(n, dh, 10000.0)
        tc, ts = tbs.rotary_tables(n, dh, 10000.0)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(ts, js)
    x = np.random.default_rng(1).standard_normal((2, 3, 7, 8)).astype(np.float32)
    ref = jbs._apply_rotary(jnp.asarray(x), jnp.asarray(jc), jnp.asarray(js))
    got = tbs.apply_rotary(torch.from_numpy(x), torch.from_numpy(tc), torch.from_numpy(ts))
    assert_close(got, ref, "rotary")


def test_attention_matches_jax():
    """One to_qkv split into q, k, v of heads each, rotary on q and k, the
    softmax in float32 at 1/sqrt(dim_head), each head gated before the heads
    merge."""
    jc, _ = bs_cfgs()
    x = np.random.default_rng(2).standard_normal((3, 7, 32)).astype(np.float32)
    cos, sin = jbs._rotary_tables(7, 8, 10000.0)
    params = jax_params(jbs.Attention(jc), x, cos, sin)
    ref = jbs.Attention(jc).apply(params, x, cos, sin)
    got = run(port(tbs.Attention(32, 2, 8), params), x, cos, sin)
    assert_close(got, ref, "Attention")


@pytest.mark.parametrize("norm_output", [False, True])
def test_transformer_matches_jax(norm_output):
    jc, tc = bs_cfgs(transformer_norm_output=norm_output)
    x = np.random.default_rng(3).standard_normal((2, 9, 32)).astype(np.float32)
    cos, sin = jbs._rotary_tables(9, 8, 10000.0)
    params = jax_params(jbs.Transformer(jc, 2), x, cos, sin)
    assert ("norm" in params["params"]) == norm_output
    ref = jbs.Transformer(jc, 2).apply(params, x, cos, sin)
    got = run(port(tbs.Transformer(tc, 2), params), x, cos, sin)
    assert_close(got, ref, f"Transformer norm_output={norm_output}")


def test_band_split_and_mask_estimator_match_jax():
    jc, tc = bs_cfgs()
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((2, 5, sum(jc.dims_in))).astype(np.float32)
    p = jax_params(jbs.BandSplit(jc.dims_in, 32), feats)
    ref = jbs.BandSplit(jc.dims_in, 32).apply(p, feats)
    assert_close(run(port(tbs.BandSplit(tc.dims_in, 32), p), feats), ref, "BandSplit")
    x = rng.standard_normal((2, 5, 3, 32)).astype(np.float32)
    for depth in (1, 2, 3):
        est = jbs.MaskEstimator(jc.dims_in, 32, 64, depth)
        p = jax_params(est, x, seed=depth)
        got = run(port(tbs.MaskEstimator(tc.dims_in, 32, 64, depth), p), x)
        assert_close(got, est.apply(p, x), f"MaskEstimator depth {depth}")


@pytest.mark.parametrize("stems,norm_output", [(1, False), (2, False), (2, True)])
def test_bs_roformer_matches_jax(stems, norm_output):
    jc, tc = bs_cfgs(num_stems=stems, transformer_norm_output=norm_output)
    spec = np.random.default_rng(5).standard_normal((2, 7, 18, 2)).astype(np.float32)
    params = jax_params(jbs.BSRoformer(jc), spec)
    ref = jbs.BSRoformer(jc).apply(params, spec)
    got = run(port(tbs.BSRoformer(tc), params), spec)
    assert got.shape == (stems, 2, 7, 18, 2)
    assert_close(got, ref, f"BSRoformer stems {stems} norm_output {norm_output}")


@pytest.mark.parametrize("stems,norm_output", [(1, False), (2, True)])
def test_mel_roformer_matches_jax(stems, norm_output):
    """The gather by freq_indices and the masks added back onto their bins,
    each divided by its band count."""
    jc, tc = mel_cfgs(num_stems=stems, transformer_norm_output=norm_output)
    spec = np.random.default_rng(6).standard_normal((2, 6, 18, 2)).astype(np.float32)
    params = jax_params(jmel.MelBandRoformer(jc), spec)
    ref = jmel.MelBandRoformer(jc).apply(params, spec)
    got = run(port(tmel.MelBandRoformer(tc), params), spec)
    assert_close(got, ref, f"MelBandRoformer stems {stems} norm_output {norm_output}")


@pytest.mark.parametrize("n_fft", [2048, 4096])
def test_mel_band_indices_match_jax(n_fft):
    """The Slaney filterbank's supports at 44.1 kHz, stereo and mono; no bin
    lies in more than 2 bands (so the card's atomic mask sum is exact)."""
    for ch in (2, 1):
        got = tmel.mel_band_indices(44100, n_fft, 60, ch)
        assert got == jmel.mel_band_indices(44100, n_fft, 60, ch)
        assert np.bincount(got[0]).max() <= 2
    if n_fft == 2048:
        assert len(tmel.MelRoformerConfig().freq_indices) == 3958


# ---- separators ----

def separators(kind: str, stems: int, **kw):
    """(JAX, port) separators of the tiny ``kind`` model with the same lively
    weights, 0.05 s windows (2208 samples at hop 8)."""
    jc, tc = (bs_cfgs if kind == "bs" else mel_cfgs)(num_stems=stems)
    model = (jbs.BSRoformer if kind == "bs" else jmel.MelBandRoformer)(jc)
    params = jax_params(model, np.zeros((1, 4, 18, 2), np.float32), seed=7)
    jsep_cls = jbs.BSRoformerSeparator if kind == "bs" else jmel.MelRoformerSeparator
    tsep_cls = tbs.BSRoformerSeparator if kind == "bs" else tmel.MelRoformerSeparator
    return (jsep_cls(params, jc, segment_seconds=0.05, **kw),
            tsep_cls(weights.roformer_state_dict(params), tc, segment_seconds=0.05,
                     device="cpu", **kw))


def assert_stems_close(ref: dict, got: dict, label: str) -> None:
    stems = [k for k in ref if k not in ("sr", "input_audio")]
    assert stems == [k for k in got if k not in ("sr", "input_audio")] and ref["sr"] == got["sr"]
    for stem in stems:
        a, b = ref[stem][0], got[stem][0]
        assert a.dtype == b.dtype == np.int16 and a.shape == b.shape and a.shape[0] == 2
        diff = np.abs(a.astype(np.int32) - b.astype(np.int32)).max()
        print(f"{label} {stem}: max |diff| {diff} LSB, peak {np.abs(a).max()}")
        assert np.abs(a).max() > 1000 and diff <= LSB


@pytest.mark.parametrize("kind,max_batch", [("bs", 16), ("mel", 1)])
def test_separator_matches_jax(kind, max_batch):
    """1.5 windows (two windows at half overlap, the second padded): demix's
    stems within 1e-5, run_inference's int16 stems within 1 LSB; the Mel
    separator one window a network call."""
    jsep_, tsep_ = separators(kind, 1, max_batch=max_batch)
    assert tsep_.segment == jsep_.segment == 2208 and tsep_.stride == 1104
    song = stereo(3312 / 44100, 44100)
    assert_close(tsep_.demix(song).numpy(), jsep_.demix(song), f"{kind} demix")
    ref, got = jsep_.run_inference(song, 44100), tsep_.run_inference(song, 44100)
    assert list(got) == ["sr", "input_audio", "vocals", "instrumentals"]
    assert_stems_close(ref, got, f"{kind} run_inference")
    # mono at 22.05 kHz: doubled and resampled on the host, as JAX's
    mono = stereo(0.06, 22050)[0]
    assert_stems_close(jsep_.run_inference(mono, 22050), tsep_.run_inference(mono, 22050),
                       f"{kind} 22.05 kHz mono")


def test_two_stem_labels_follow_jax():
    """A 2-stem model's stems are named drums and bass (JAX's
    ``["drums", "bass", "other", "vocals"][:num_stems]``), so it gives no
    vocals and no instrumentals."""
    jsep_, tsep_ = separators("bs", 2)
    assert tsep_.sources == jsep_.sources == ["drums", "bass"]
    song = stereo(0.06, 44100)
    ref, got = jsep_.run_inference(song, 44100), tsep_.run_inference(song, 44100)
    assert "vocals" not in got and "instrumentals" not in got
    assert_stems_close(ref, got, "2 stems")


# ---- files ----

def narrow_state(kind: str, seed: int, **kw):
    """(port config, lucidrains-named weights) of a narrow model at the
    released layout."""
    cfg = (tbs.BSRoformerConfig if kind == "bs" else tmel.MelRoformerConfig)(**NARROW, **kw)
    with torch.device("meta"):
        model = (tbs.BSRoformer if kind == "bs" else tmel.MelBandRoformer)(cfg)
    return cfg, chip_smoke.roformer_weights(model, seed)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("roformer")
    paths = {"bs": str(d / "model_bs_roformer_ep_317_sdr_12.9755.ckpt"),
             "mel": str(d / "MelBandRoformer.ckpt")}
    cfg, state = narrow_state("bs", 11)
    chip_smoke.write_roformer_ckpt(paths["bs"], state, cfg, lightning=True)
    cfg, state = narrow_state("mel", 12)
    chip_smoke.write_roformer_ckpt(paths["mel"], state, cfg, lightning=False)
    return paths


@pytest.mark.parametrize("lightning", [True, False])
def test_bs_loader_matches_jax(tmp_path, lightning):
    """The config field by field and the weights as JAX's loader reads them
    (a Lightning checkpoint's ``model.`` names, or bare), the rotary buffers
    skipped; a stereo 4-stem and a mono 1-stem layout; the checkpoint's
    own band widths and transformer norms."""
    for kw in (dict(num_stems=4, transformer_norm_output=True, mask_estimator_depth=3,
                    mlp_expansion_factor=2, freqs_per_bands=(2, 3, 4), n_fft=16, ff_mult=2),
               dict(stereo=False, time_transformer_depth=2)):
        cfg, state = narrow_state("bs", 13, **kw)
        path = str(tmp_path / "bs.ckpt")
        chip_smoke.write_roformer_ckpt(path, state, cfg, lightning=lightning)
        got, tcfg = torch_import.load_bs_roformer(path)
        jparams, jcfg = jimport.load_bs_roformer(path)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
        ref = weights.roformer_state_dict(jparams)
        assert got.keys() == ref.keys() == state.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])


@pytest.mark.parametrize("lightning,freq_indices,n_fft", [(False, False, 2048),
                                                          (True, True, 4096),
                                                          (True, False, 1024)])
def test_mel_loader_matches_jax(tmp_path, lightning, freq_indices, n_fft):
    """Without a freq_indices buffer the layout is rebuilt (n_fft tried 2048,
    4096, 1024); with one it is read, stereo from its channel siblings."""
    cfg, state = narrow_state("mel", 14, n_fft=n_fft, num_stems=2, mask_estimator_depth=2)
    path = str(tmp_path / "mel.ckpt")
    chip_smoke.write_roformer_ckpt(path, state, cfg, lightning=lightning,
                                   freq_indices=freq_indices)
    got, tcfg = torch_import.load_mel_roformer(path)
    jparams, jcfg = jimport.load_mel_roformer(path)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    ref = weights.roformer_state_dict(jparams)
    assert got.keys() == ref.keys() == state.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


def test_loaders_refuse_what_does_not_fit(files, tmp_path):
    """The BS loader refuses a Mel checkpoint, as JAX's; a checkpoint with a
    missing, an extra or a reshaped tensor raises from the module's strict
    load_state_dict."""
    cfg, state = narrow_state("mel", 15)
    path = str(tmp_path / "mel_roformer.ckpt")
    chip_smoke.write_roformer_ckpt(path, state, cfg, lightning=False, freq_indices=True)
    for load in (torch_import.load_bs_roformer, jimport.load_bs_roformer):
        with pytest.raises(ValueError, match="Mel-Band RoFormer"):
            load(path)
    cfg, state = narrow_state("bs", 16)
    for edit, match in ((lambda s: s.pop("final_norm.gamma"), "Missing key"),
                        (lambda s: s.__setitem__("extra.weight", np.zeros(2, np.float32)),
                         "Unexpected key"),
                        (lambda s: s.__setitem__("layers.0.1.layers.0.1.net.4.bias",
                                                 np.zeros(17, np.float32)), "size mismatch")):
        broken = dict(state)
        edit(broken)
        path = str(tmp_path / "bs_roformer.ckpt")
        chip_smoke.write_roformer_ckpt(path, broken, cfg, lightning=True)
        with pytest.raises(RuntimeError, match=match):
            tsep.load_separator("bs_roformer", path, device="cpu")


@pytest.mark.parametrize("kind", ["bs", "mel"])
def test_load_separator_and_cli(files, tmp_path, kind):
    """``route_separator`` -> ``load_separator`` -> ``run_inference`` on 2 s
    of stereo (one 8 s window) against JAX's separator from JAX's loader
    within 1 LSB; the CLI's ``separate --device cpu`` writes stereo
    vocals.wav and instrumentals.wav equal to load_separator's stems on the
    file's downmix, saved the same way."""
    from scipy.io import wavfile

    from rvc_tpu_torch.io.audio import load_input_audio, save_input_audio

    path = files[kind]
    name = {"bs": "bs_roformer", "mel": "mel_roformer"}[kind]
    assert tsep.route_separator(path) == name
    sep = tsep.load_separator(name, path, device="cpu")
    assert isinstance(sep, tbs.BSRoformerSeparator if kind == "bs" else tmel.MelRoformerSeparator)
    assert sep.segment == 352800 and next(sep.model.parameters()).device.type == "cpu"
    jload = jimport.load_bs_roformer if kind == "bs" else jimport.load_mel_roformer
    jcls = jbs.BSRoformerSeparator if kind == "bs" else jmel.MelRoformerSeparator
    song = stereo(2.0, 44100)
    assert_stems_close(jcls(*jload(path)).run_inference(song, 44100),
                       sep.run_inference(song, 44100), f"{kind} load_separator")

    wav = str(tmp_path / "song.wav")
    wavfile.write(wav, 44100, (song.T * 32767).astype(np.int16))
    outdir = str(tmp_path / "stems")
    cli.main(["separate", wav, outdir, "--model", path, "--device", "cpu"])
    ref = sep.run_inference(*load_input_audio(wav))
    for stem in ("vocals", "instrumentals"):
        save_input_audio(str(tmp_path / f"{stem}_ref.wav"), ref[stem])
        rate, got = wavfile.read(os.path.join(outdir, f"{stem}.wav"))
        _, want = wavfile.read(str(tmp_path / f"{stem}_ref.wav"))
        assert rate == 44100 and got.shape == want.shape == (88200, 2)
        np.testing.assert_array_equal(got, want)
