"""MuseTalk in the port against the JAX package, at tiny widths from a seed:
every network (the VAE, the UNet, S3FD, BiSeNet, FAN) within 1e-5 of the
largest magnitude, the host helpers equal (``decode_s3fd``, ``nms``,
``heatmaps_to_landmarks``, ``refine_box_with_landmarks``,
``get_sliced_feature``), ``Audio2Feature`` within 1e-5, and
``MuseTalkPipeline.process`` on 6 frames of 64 x 64 with boxes given,
with and without the parser: the UNet's latents within 1e-4 relative L2,
the frames within 2 LSB.

The weights are drawn for the port's modules (``chip_smoke.musetalk_state``,
the smoke run's seeded weights) and carried to JAX by its own importers
(``*_params_from_state_dict``, the diffusers / face-alignment /
face-parsing names); ``compat.weights`` carries them back. JAX's pipeline
builds its VAE and UNet at full width: the test swaps in tiny ones through
the module attributes it reads (``vae.AutoencoderKL``, ``unet.UNetConfig``)
while it is built. The parser runs at 64 on both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_port import finit, no_compile_cache_writes, one_thread  # noqa: F401
from rvc_tpu.models import whisper as JW
from rvc_tpu.models.musetalk import face as jface
from rvc_tpu.models.musetalk import unet as junet
from rvc_tpu.models.musetalk import vae as jvae
from rvc_tpu.pipelines import musetalk as jpipe
from rvc_tpu_torch.compat import weights as W
from rvc_tpu_torch.models import whisper as TW
from rvc_tpu_torch.models.musetalk import face, unet, vae
from rvc_tpu_torch.pipelines import musetalk as pipe

pytestmark = pytest.mark.usefixtures("one_thread")
TOL = 1e-5       # of the largest magnitude: float32 summed in another order
LAT_TOL = 1e-4   # relative L2 of the pipeline's latents
LSB = 2          # the pipeline's uint8 frames

TINY_VAE = dict(block_out_channels=(16, 16, 32, 32), norm_num_groups=8, layers_per_block=1)
TINY_UNET = dict(block_out_channels=(32, 64), norm_num_groups=8, attention_head_dim=2,
                 layers_per_block=1, down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                 up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"))
WHISPER = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=384, n_audio_head=6, n_audio_layer=1,
               n_vocab=64, n_text_ctx=8, n_text_state=384, n_text_head=6, n_text_layer=1)


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def nhwc(t) -> np.ndarray:
    return np.asarray(t.detach() if isinstance(t, torch.Tensor) else t).transpose(0, 2, 3, 1)


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def drawn(module, seed: int):
    """The port's module with the smoke run's seeded weights, and its
    state_dict as tensors (what a checkpoint holds)."""
    sd = chip_smoke.musetalk_state(module, seed, "cpu")
    module.load_state_dict(sd, strict=True)
    return module.eval(), sd


def round_trip(sd: dict, params, to_port):
    """compat.weights gives back the state_dict JAX's importer read."""
    back = to_port(params)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v.numpy(), err_msg=k)


@pytest.fixture(scope="module")
def nets():
    """Each network at its tiny form: (port module, JAX params)."""
    out = {}
    m, sd = drawn(vae.AutoencoderKL(vae.VAEConfig(**TINY_VAE)), 1)
    out["vae"] = (m, jvae.vae_params_from_state_dict(sd))
    round_trip(sd, out["vae"][1], W.vae_state_dict)
    m, sd = drawn(unet.UNet2DCondition(unet.UNetConfig(**TINY_UNET)), 2)
    out["unet"] = (m, junet.unet_params_from_state_dict(sd))
    round_trip(sd, out["unet"][1], W.unet_state_dict)
    m, sd = drawn(face.S3FD(), 3)
    out["s3fd"] = (m, jface.s3fd_params_from_state_dict(sd))
    round_trip(sd, out["s3fd"][1], W.s3fd_state_dict)
    m, sd = drawn(face.BiSeNet(), 4)
    out["bisenet"] = (m, jface.bisenet_params_from_state_dict(sd))
    round_trip(sd, out["bisenet"][1], W.bisenet_state_dict)
    m, sd = drawn(face.FAN(1), 5)
    out["fan"] = (m, jface.fan_params_from_state_dict(sd))
    round_trip({k: v for k, v in sd.items() if "num_batches" not in k}, out["fan"][1],
               W.fan_state_dict)
    return out


def test_vae_against_jax(nets):
    m, params = nets["vae"]
    jm = jvae.AutoencoderKL(jvae.VAEConfig(**TINY_VAE))
    x = np.random.default_rng(10).uniform(-1, 1, (2, 64, 48, 3)).astype(np.float32)
    mean, logvar = jax.jit(lambda p, x: jm.apply(p, x, method=jvae.AutoencoderKL.encode_moments))(
        params, jnp.asarray(x))
    z = mean * jm.cfg.scaling_factor
    y = jax.jit(lambda p, z: jm.apply(p, z, method=jvae.AutoencoderKL.decode))(params, z)
    with torch.no_grad():
        pmean, plogvar = m.encode_moments(nchw(x))
        pz = m.encode(nchw(x))
        py = m.decode(nchw(np.asarray(z)))
    close(nhwc(pmean), mean)
    close(nhwc(plogvar), logvar)
    close(nhwc(pz), z)
    close(nhwc(py), y)


def test_unet_against_jax(nets):
    m, params = nets["unet"]
    jm = junet.UNet2DCondition(junet.UNetConfig(**TINY_UNET))
    rng = np.random.default_rng(11)
    lat = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    ctx = rng.standard_normal((2, 10, 384)).astype(np.float32)
    t = np.array([0, 7], np.int32)
    want = jax.jit(jm.apply)(params, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx))
    with torch.no_grad():
        got = m(nchw(lat), torch.from_numpy(t), torch.from_numpy(ctx))
    close(nhwc(got), want)
    # small t (the pipeline's is 0): at t ~ 1000 one float32 ulp of the
    # angle t * freq, rounded apart by the two exps, is ~6e-5 of a cosine
    close(unet.timestep_embedding(torch.tensor([0.0, 3.0, 7.0]), 320),
          junet.timestep_embedding(jnp.asarray([0, 3, 7]), 320))
    np.testing.assert_array_equal(unet.positional_encoding(torch.from_numpy(ctx)).numpy(),
                                  np.asarray(junet.positional_encoding(jnp.asarray(ctx))))


def test_unet_config_from_json(tmp_path):
    import json

    path = tmp_path / "musetalk.json"
    path.write_text(json.dumps({**TINY_UNET, "sample_size": 64, "act_fn": "silu"}))
    assert unet.UNetConfig.from_json(str(path)) == unet.UNetConfig(**TINY_UNET)
    assert junet.UNetConfig.from_json(str(path)) == junet.UNetConfig(**TINY_UNET)


@pytest.fixture(scope="module")
def s3fd_maps(nets):
    """S3FD's 12 maps of one 128 x 128 frame from both packages (JAX's NHWC)."""
    m, params = nets["s3fd"]
    x = np.random.default_rng(12).uniform(-110, 130, (1, 128, 128, 3)).astype(np.float32)
    want = [np.asarray(o) for o in jax.jit(jface.S3FD().apply)(params, jnp.asarray(x))]
    with torch.no_grad():
        got = m(nchw(x))
    return got, want


def test_s3fd_against_jax(s3fd_maps):
    got, want = s3fd_maps
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        close(nhwc(g), w)


def test_s3fd_decode_and_nms_equal(s3fd_maps):
    """On the same maps (JAX's), the port's numpy helpers give JAX's arrays;
    ``first_kept`` is NMS's first box."""
    _, want = s3fd_maps
    dets = jface.decode_s3fd(want)
    port_dets = face.decode_s3fd([w.transpose(0, 3, 1, 2) for w in want])
    np.testing.assert_array_equal(port_dets, dets)
    for thresh in (0.3, 0.5):
        np.testing.assert_array_equal(face.nms(port_dets, thresh), jface.nms(dets, thresh))
    np.testing.assert_array_equal(face.first_kept(port_dets), jface.nms(dets)[0])
    assert face.first_kept(np.zeros((0, 5), np.float32)) is None
    high = [w.transpose(0, 3, 1, 2) for w in want]
    np.testing.assert_array_equal(face.decode_s3fd(high, 0.6), jface.decode_s3fd(want, 0.6))


def test_s3fd_odd_sides_run_where_jax_raises(nets):
    """JAX's 2x2 pool reshapes, so a frame side that is not a multiple of 32
    raises there; the port's pool drops the last row, as the reference's
    F.max_pool2d does, and returns the 12 maps."""
    m, params = nets["s3fd"]
    x = np.zeros((1, 70, 66, 3), np.float32)
    with pytest.raises(Exception):
        jface.S3FD().apply(params, jnp.asarray(x))
    with torch.no_grad():
        maps = m(nchw(x))
    assert maps[0].shape[2:] == (17, 16) and all(torch.isfinite(o).all() for o in maps)


def test_bisenet_against_jax(nets):
    m, params = nets["bisenet"]
    x = np.random.default_rng(13).standard_normal((2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jface.BiSeNet().apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = m(nchw(x))
    close(nhwc(got), want)
    agree = np.mean(nhwc(got).argmax(-1) == want.argmax(-1))
    print(f"BiSeNet classes equal at {agree:.4%} of pixels")
    assert agree >= 0.999


def test_fan_and_landmarks_against_jax(nets):
    m, params = nets["fan"]
    x = np.random.default_rng(14).random((2, 64, 64, 3)).astype(np.float32)
    want = jax.jit(jface.FAN(num_modules=1).apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got = m(nchw(x))
    close(nhwc(got), want)
    np.testing.assert_array_equal(face.heatmaps_to_landmarks(nchw(want)).numpy(),
                                  np.asarray(jface.heatmaps_to_landmarks(want)))
    # ties and edges: the first maximum, neighbours clamped at the border
    hm = np.zeros((1, 6, 5, 68), np.float32)
    hm[0, 0, 0, 0], hm[0, 5, 4, 1], hm[0, 2, 2, 2], hm[0, 2, 3, 2] = 1, 1, 1, 1
    np.testing.assert_array_equal(face.heatmaps_to_landmarks(nchw(hm)).numpy(),
                                  np.asarray(jface.heatmaps_to_landmarks(jnp.asarray(hm))))


def test_host_helpers_equal():
    rng = np.random.default_rng(15)
    for case in range(6):
        lm = rng.uniform(-5 if case == 5 else 10, 120, (68, 2)).astype(np.float32)
        box = (5, 6, 100, 110)
        for shift in (0, 7, -9):
            assert pipe.refine_box_with_landmarks(box, lm, shift) == \
                jpipe.refine_box_with_landmarks(box, lm, shift)
    feats = rng.standard_normal((37, 384)).astype(np.float32)
    for fps in (25.0, 30.0):
        for idx in (0, 1, 5, 17, 40):
            a, ai = pipe.Audio2Feature.get_sliced_feature(feats, idx, (2, 2), fps)
            b, bi = jpipe.Audio2Feature.get_sliced_feature(feats, idx, (2, 2), fps)
            np.testing.assert_array_equal(a, b)
            assert ai == bi
    for box in ((10, 12, 50, 70), (0, 0, 64, 64), (3, 40, 9, 41)):
        assert pipe._crop_box(box, 1.2) == jpipe._crop_box(box, 1.2)
        img = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
        cbox = pipe._crop_box(box, 1.2)[0]
        np.testing.assert_array_equal(pipe._crop_padded(img, cbox), jpipe._crop_padded(img, cbox))


@pytest.fixture(scope="module")
def whisper_pair():
    """JAX's tiny-depth Whisper (width 384, one encoder layer) and the port's
    on the same weights."""
    jdims = JW.WhisperDims(**WHISPER)
    jm = JW.Whisper(jdims)
    params = finit(lambda mel, tok: jm.init(jax.random.PRNGKey(0), mel, tok),
                   jnp.zeros((1, 3000, 80)), jnp.zeros((1, 2), jnp.int32), seed=16, scale=0.05)
    model = TW.Whisper(TW.WhisperDims(**WHISPER))
    sd = {k: torch.tensor(np.asarray(v)) for k, v in W.whisper_state_dict(params).items()}
    sd["encoder.positional_embedding"] = model.encoder.positional_embedding
    model.load_state_dict(sd, strict=True)
    return jpipe.Audio2Feature(params, jdims), model.eval()  # one JAX jit for both tests


def test_audio2feature_against_jax(whisper_pair):
    """31 s of seeded noise (two windows: the second 1 s, padded) -> the
    50 Hz rows of every encoder layer; and the chunks per video frame."""
    ja2f, model = whisper_pair
    audio = (0.1 * np.random.default_rng(17).standard_normal(31 * 16000)).astype(np.float32)
    want = ja2f.audio2feat(audio)
    a2f = pipe.Audio2Feature(model, model.dims, device="cpu")
    got = a2f.audio2feat(audio)
    assert got.shape == want.shape == (1550, 1, 384)
    close(got, want)
    chunks = a2f.feature2chunks(got[:, -1], 25.0)
    np.testing.assert_array_equal(np.stack(chunks), np.stack(ja2f.feature2chunks(got[:, -1], 25.0)))


def test_vae_loads_diffusers_files_old_and_new_names(nets, tmp_path):
    """A diffusers state_dict loads by load_vae under the current attention
    names and the older query/key/value/proj_attn."""
    m, _ = nets["vae"]
    sd = m.state_dict()
    old = {k.replace(".to_q.", ".query.").replace(".to_k.", ".key.").replace(".to_v.", ".value.")
           .replace(".to_out.0.", ".proj_attn."): v for k, v in sd.items()}
    assert any(".query." in k for k in old)
    for i, state in enumerate((sd, old)):
        torch.save(state, tmp_path / f"vae{i}.bin")
        got = vae.load_vae(str(tmp_path / f"vae{i}.bin"), vae.VAEConfig(**TINY_VAE), device="cpu")
        for k, v in got.state_dict().items():
            torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    # JAX's importer reads the older names too
    params = jvae.vae_params_from_state_dict(old)
    round_trip(sd, params, W.vae_state_dict)


FRAME_BOXES = [(8, 6, 56, 58), (4, 10, 60, 62), (0, 0, 64, 64), (10, 12, 50, 54),
               (16, 8, 48, 40), (2, 3, 62, 63)]


@pytest.fixture(scope="module")
def pipelines(nets, whisper_pair):
    """JAX's pipeline built at the tiny widths, its UNet's outputs recorded,
    and the port's on the same weights; both with the parser at 64."""
    ja2f, model = whisper_pair

    class TinyVAE(jvae.AutoencoderKL):
        cfg: jvae.VAEConfig = jvae.VAEConfig(**TINY_VAE)

    tiny_unet = junet.UNetConfig(**TINY_UNET)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvae, "AutoencoderKL", TinyVAE)
        mp.setattr(junet, "UNetConfig", lambda: tiny_unet)
        jp = jpipe.MuseTalkPipeline(nets["vae"][1], nets["unet"][1], ja2f,
                                    parse_params=nets["bisenet"][1])
    jp.parser.size = 64
    recorded = []
    step = jp._unet_step

    def record(p, lat, feat):
        out = step(p, lat, feat)
        recorded.append(np.asarray(out))
        return out

    jp._unet_step = record
    tp = pipe.MuseTalkPipeline(nets["vae"][0], nets["unet"][0],
                               pipe.Audio2Feature(model, device="cpu"),
                               parse=nets["bisenet"][0], device="cpu")
    tp.parser.size = 64
    rng = np.random.default_rng(18)
    yy, xx = np.mgrid[0:64, 0:64]
    frames = [np.clip(np.stack([xx * 3, yy * 3, 200 - xx - yy], -1)
                      + rng.integers(-30, 30, (64, 64, 3)), 0, 255).astype(np.uint8)
              for _ in range(6)]
    audio = (0.1 * rng.standard_normal(int(0.3 * 16000))).astype(np.float32)
    return jp, recorded, tp, frames, audio


@pytest.mark.parametrize("parser", [True, False], ids=["parsed", "feathered"])
def test_pipeline_process_against_jax(pipelines, parser):
    jp, recorded, tp, frames, audio = pipelines
    saved = jp.parser, tp.parser
    if not parser:
        jp.parser = tp.parser = None
    latents = []
    hook = tp.unet.register_forward_hook(lambda m, i, out: latents.append(out.numpy()))
    try:
        recorded.clear()
        want = jp.process(frames, audio, boxes=FRAME_BOXES, batch_size=6)
        got = tp.process(frames, audio, boxes=FRAME_BOXES, batch_size=6)
    finally:
        hook.remove()
        jp.parser, tp.parser = saved
    assert len(got) == len(want) == 6
    lat, jlat = np.concatenate(latents), np.concatenate(recorded)
    rel = np.linalg.norm(nhwc(lat) - jlat) / np.linalg.norm(jlat)
    diff = np.stack([np.abs(g.astype(np.int32) - w.astype(np.int32)) for g, w in zip(got, want)])
    print(f"{'parsed' if parser else 'feathered'}: latents relative L2 {rel:.3g}, frames max "
          f"|diff| {diff.max()} LSB, share beyond 1 LSB {np.mean(diff > 1):.4%}, share off "
          f"{np.mean(diff > 0):.4%}")
    assert rel <= LAT_TOL
    assert diff.max() <= LSB


def test_detection_clips_where_jax_keeps_a_negative_corner(monkeypatch):
    """A best candidate over the frame's edge: JAX keeps its negative corner
    (whose crop is then empty, and cv2.resize fails on it), the port clips
    it at 0, as the reference's face-detection API does. Both pipelines read
    the same candidates (decode_s3fd replaced in both)."""
    dets = np.array([[0.4, 20.5, 20.5, 40.2, 44.9], [0.9, -6.5, -3.2, 9.8, 12.1]], np.float32)
    monkeypatch.setattr(jface, "decode_s3fd", lambda outs: dets)
    monkeypatch.setattr(pipe, "decode_s3fd", lambda outs: dets)

    class NoNet:
        def apply(self, params, x):
            return [jnp.zeros((1, 1, 1, 2))] * 12

    monkeypatch.setattr(jface, "S3FD", lambda dtype=None: NoNet())
    frame = np.full((64, 64, 3), 100, np.uint8)
    jp = object.__new__(jpipe.MuseTalkPipeline)
    jp.face_params, jp.dtype = None, jnp.float32
    assert jpipe.MuseTalkPipeline.detect_faces(jp, [frame]) == [(-6, -3, 9, 12)]
    tp = pipe.MuseTalkPipeline(None, None, None, face=face.S3FD(), device="cpu")
    assert tp.detect_faces([frame]) == [(0, 0, 9, 12)]
    with pytest.raises(Exception):
        jpipe.blend_face(frame, frame, (-6, -3, 9, 12))
