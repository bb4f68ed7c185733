"""The port's three MuseTalk nodes against the JAX package's, from checkpoint
files written to a temporary folder (``chip_smoke.write_musetalk_files`` at
tiny widths): RVC_TPU_MuseAudioFeatures (features within 1e-5, as
``Audio2Feature``'s: two float32 Whisper encoders never agree bit for bit;
the frame count equal), RVC_TPU_MuseImageFeatures (S3FD's boxes equal, the
port's clipped at 0; the coordinate cache) and RVC_TPU_MuseTalk with the
parser and given boxes (frames within 2 LSB). Both packages' pipelines are
built at the tiny widths through the module attributes they read, the
parser at 64. The registry holds rvc_tpu.graph's keys."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_port import finit, no_compile_cache_writes, one_thread  # noqa: F401
from rvc_tpu import graph as jgraph
from rvc_tpu.graph import musetalk_nodes as jnodes
from rvc_tpu.models import whisper as JW
from rvc_tpu.models.musetalk import face as jface
from rvc_tpu.models.musetalk import unet as junet
from rvc_tpu.models.musetalk import vae as jvae
from rvc_tpu.pipelines import musetalk as jpipe
from rvc_tpu_torch import graph as tgraph
from rvc_tpu_torch.compat import weights as W
from rvc_tpu_torch.graph import musetalk_nodes, nodes
from rvc_tpu_torch.models import whisper as TW
from rvc_tpu_torch.models.musetalk import unet, vae
from rvc_tpu_torch.pipelines import musetalk as pipe

pytestmark = pytest.mark.usefixtures("one_thread")
TINY_VAE = dict(block_out_channels=(16, 16, 32, 32), norm_num_groups=8, layers_per_block=1)
TINY_UNET = dict(block_out_channels=(32, 64), norm_num_groups=8, attention_head_dim=2,
                 layers_per_block=1, down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                 up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"))
WHISPER = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=384, n_audio_head=6, n_audio_layer=1,
               n_vocab=64, n_text_ctx=8, n_text_state=384, n_text_head=6, n_text_layer=1)
TINY_VAE_CFG = vae.VAEConfig(**TINY_VAE)
BOXES = [(8, 6, 56, 58), (0, 10, 60, 64), (12, 4, 50, 44), (2, 2, 62, 62)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The checkpoints (tiny VAE and UNet, S3FD, BiSeNet) and a Whisper
    model for each package on the same weights."""
    folder = tmp_path_factory.mktemp("muse")
    paths = chip_smoke.write_musetalk_files(
        str(folder), seed=41, device="cpu", vae_cfg=vae.VAEConfig(**TINY_VAE),
        unet_cfg=unet.UNetConfig(**TINY_UNET), fan_modules=1)
    jdims = JW.WhisperDims(**WHISPER)
    jm = JW.Whisper(jdims)
    params = finit(lambda mel, tok: jm.init(jax.random.PRNGKey(0), mel, tok),
                   jnp.zeros((1, 3000, 80)), jnp.zeros((1, 2), jnp.int32), seed=42, scale=0.05)
    model = TW.Whisper(TW.WhisperDims(**WHISPER))
    sd = {k: torch.tensor(np.asarray(v)) for k, v in W.whisper_state_dict(params).items()}
    sd["encoder.positional_embedding"] = model.encoder.positional_embedding
    model.load_state_dict(sd, strict=True)
    whispers = {"jax": {"params": params, "dims": jdims},
                "port": {"model": model.eval(), "dims": model.dims}}
    rng = np.random.default_rng(43)
    yy, xx = np.mgrid[0:64, 0:64]
    images = np.stack([np.clip(np.stack([xx * 3, yy * 3, 200 - xx - yy], -1)
                               + rng.integers(-30, 30, (64, 64, 3)), 0, 255) / 255.0
                       for _ in range(4)]).astype(np.float32)
    audio = {"waveform": (0.1 * rng.standard_normal((1, 1, 3200))).astype(np.float32),
             "sample_rate": 16000}
    return paths, whispers, images, audio


@pytest.fixture
def tiny(monkeypatch):
    """Both packages at the tiny widths and the parser at 64, the port on
    the CPU with empty caches."""
    monkeypatch.setattr(nodes, "DEVICE", "cpu")
    monkeypatch.setattr(nodes, "_CACHE", {})
    monkeypatch.setattr(musetalk_nodes.MuseImageFeatureExtractionNode, "_CACHE", {})
    monkeypatch.setattr(jnodes.MuseImageFeatureExtractionNode, "_CACHE", {})

    class TinyVAE(jvae.AutoencoderKL):
        cfg: jvae.VAEConfig = jvae.VAEConfig(**TINY_VAE)

    class Parser64(jpipe.FaceParser):
        def __init__(self, params, dtype=jnp.float32, size=512):
            super().__init__(params, dtype, 64)

    class PortParser64(pipe.FaceParser):
        def __init__(self, model, size=512, device=None):
            super().__init__(model, 64, device)

    jtiny, ttiny = junet.UNetConfig(**TINY_UNET), unet.UNetConfig(**TINY_UNET)
    monkeypatch.setattr(jvae, "AutoencoderKL", TinyVAE)
    monkeypatch.setattr(junet, "UNetConfig", lambda: jtiny)
    monkeypatch.setattr(jpipe, "FaceParser", Parser64)
    monkeypatch.setattr(vae, "VAEConfig", lambda: TINY_VAE_CFG)
    monkeypatch.setattr(unet, "UNetConfig", lambda: ttiny)
    monkeypatch.setattr(pipe, "FaceParser", PortParser64)


def test_registry_holds_jax_keys():
    assert set(tgraph.NODE_CLASS_MAPPINGS) == set(jgraph.NODE_CLASS_MAPPINGS)
    for key in musetalk_nodes.MUSETALK_NODE_CLASS_MAPPINGS:
        cls, jcls = tgraph.NODE_CLASS_MAPPINGS[key], jgraph.NODE_CLASS_MAPPINGS[key]
        assert cls.INPUT_TYPES() == jcls.INPUT_TYPES()
        for attr in ("RETURN_TYPES", "RETURN_NAMES", "FUNCTION", "CATEGORY"):
            assert getattr(cls, attr, None) == getattr(jcls, attr, None)
    # neither MuseTalk node takes a FAN model: the JAX node never refines
    # S3FD's boxes (rvc_tpu/graph/musetalk_nodes.py:141-142), nor does the port's
    inputs = jgraph.NODE_CLASS_MAPPINGS["RVC_TPU_MuseTalk"].INPUT_TYPES()
    assert not any("fan" in k for part in inputs.values() for k in part)


def test_audio_features_node(files, tiny):
    _, whispers, _, audio = files
    want, n = jnodes.MuseAudioFeatureExtractionNode().extract(audio, whispers["jax"])
    got, m = musetalk_nodes.MuseAudioFeatureExtractionNode().extract(audio, whispers["port"])
    assert m == n == 5 and got.shape == want.shape == (5, 10, 384)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1e-5, err


def test_image_features_node(files, tiny):
    """S3FD's box a frame from the same s3fd.pth; the port clips a negative
    corner at 0 (the JAX node keeps it); a second call hits the cache."""
    paths, _, images, _ = files
    with pytest.MonkeyPatch.context() as mp:  # JAX's detection runs S3FD eagerly: jit it
        apply = jax.jit(jface.S3FD().apply)

        class JitS3FD(jface.S3FD):
            def apply(self, params, x):
                return apply(params, x)

        mp.setattr(jface, "S3FD", JitS3FD)
        want, _ = jnodes.MuseImageFeatureExtractionNode().process(images, paths["s3fd"])
    node = musetalk_nodes.MuseImageFeatureExtractionNode()
    got, out_images = node.process(images, paths["s3fd"])
    assert out_images is images
    assert got == [tuple(max(v, 0) for v in box) for box in want]
    assert node.process(images, paths["s3fd"])[0] is got  # cached
    plain, _ = node.process(images)
    assert plain == [(0, 0, 64, 64)] * 4


def test_musetalk_node(files, tiny):
    """The lip-synced frames with the parser at given boxes, within 2 LSB of
    JAX's; the networks stay in the node cache on the node's device."""
    paths, whispers, images, audio = files
    (want,) = jnodes.MuseTalkNode().process(images, audio, whispers["jax"], paths["vae"],
                                            paths["unet"], parsing_model_path=paths["bisenet"],
                                            coords=BOXES)
    (got,) = musetalk_nodes.MuseTalkNode().process(images, audio, whispers["port"], paths["vae"],
                                                   paths["unet"],
                                                   parsing_model_path=paths["bisenet"],
                                                   coords=BOXES)
    assert got.shape == want.shape == images.shape and got.dtype == np.float32
    lsb = np.abs(np.round(got * 255).astype(np.int32) - np.round(want * 255).astype(np.int32))
    print(f"MuseTalk node: max |diff| {lsb.max()} LSB, share beyond 1 LSB {np.mean(lsb > 1):.4%}")
    assert lsb.max() <= 2
    cached = [v for v in nodes._CACHE.values() if isinstance(v, torch.nn.Module)]
    assert len(cached) == 3 and all(next(m.parameters()).device.type == "cpu" for m in cached)
