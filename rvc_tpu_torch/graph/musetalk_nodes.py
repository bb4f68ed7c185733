"""MuseTalk lip-sync nodes: Whisper features, face boxes, and the lip-synced
frames.

Counterpart of ``rvc_tpu/graph/musetalk_nodes.py`` node for node (the
reference's custom_nodes/musetalk_nodes.py), with the same inputs, outputs
and defaults. The networks load once per file onto ``nodes.DEVICE`` and
stay in ``nodes._CACHE``; ``RVC_TPU_MuseImageFeatures`` keeps each frame
sequence's boxes in its own ``_CACHE``, keyed as the JAX node keys them.
As in the JAX package, ``RVC_TPU_MuseTalk`` detects with S3FD when given a
face model and runs no FAN.
"""
from __future__ import annotations

import numpy as np

from ..utils import get_hash


def _model(kind: str, path: str):
    """The network in ``path`` (``kind``: vae, unet, s3fd, bisenet), loaded
    onto ``nodes.DEVICE`` once and kept in ``nodes._CACHE``."""
    from . import nodes
    from ..models.musetalk.face import load_bisenet, load_s3fd
    from ..models.musetalk.unet import load_unet
    from ..models.musetalk.vae import load_vae

    key = get_hash("musetalk", kind, path)
    if key not in nodes._CACHE:
        load = {"vae": load_vae, "unet": load_unet, "s3fd": load_s3fd,
                "bisenet": load_bisenet}[kind]
        nodes._CACHE[key] = load(path, device=nodes.DEVICE)
    return nodes._CACHE[key]


def _frames(images) -> list[np.ndarray]:
    """ComfyUI IMAGE (N, H, W, 3) floats in [0, 1] (or uint8) -> uint8 frames."""
    if hasattr(images, "cpu"):
        images = images.detach().cpu().numpy()
    frames = [np.asarray(f) for f in np.asarray(images)]
    return [(f * 255).astype(np.uint8) if f.dtype != np.uint8 else f for f in frames]


def _audio_features(audio, whisper):
    """(16 kHz mono, Audio2Feature) from an AUDIO input and a Whisper loader."""
    from . import nodes
    from ..io.audio import remix_audio
    from ..pipelines.musetalk import Audio2Feature

    wav, sr = nodes.from_audio_input(audio)
    mono, _ = remix_audio((wav, sr), target_sr=16000)
    m = whisper() if callable(whisper) else whisper
    return mono, Audio2Feature(m["model"], m["dims"], device=nodes.DEVICE)


class MuseAudioFeatureExtractionNode:
    """Audio -> per-video-frame Whisper features (the last encoder layer)."""

    CATEGORY = "rvc_tpu/musetalk"
    RETURN_TYPES = ("WHISPER_FEATURES", "INT")
    RETURN_NAMES = ("features", "num_frames")
    FUNCTION = "extract"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"audio": ("AUDIO",),
                             "whisper": ("WHISPER_MODEL",),
                             "fps": ("FLOAT", {"default": 25.0})}}

    def extract(self, audio, whisper, fps: float = 25.0):
        mono, a2f = _audio_features(audio, whisper)
        chunks = a2f.feature2chunks(a2f.audio2feat(mono)[:, -1], fps)
        return (np.stack(chunks), len(chunks))


class MuseImageFeatureExtractionNode:
    """A face box per frame: S3FD's with a face model, else the whole
    frame; cached by the frame count, the first frame and the model path."""

    CATEGORY = "rvc_tpu/musetalk"
    RETURN_TYPES = ("COORDS", "IMAGE")
    RETURN_NAMES = ("coord_list", "images")
    FUNCTION = "process"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"images": ("IMAGE",)},
                "optional": {"face_model_path": ("STRING", {"default": ""}),
                             "use_cache": ("BOOLEAN", {"default": True})}}

    _CACHE: dict = {}

    def process(self, images, face_model_path="", use_cache=True):
        from . import nodes
        from ..pipelines.musetalk import MuseTalkPipeline

        frames = _frames(images)
        key = get_hash("musecoords", len(frames), get_hash(frames[0].tobytes()),
                       face_model_path)
        if use_cache and key in self._CACHE:
            return (self._CACHE[key], images)
        if face_model_path:
            pipe = MuseTalkPipeline(None, None, None, face=_model("s3fd", face_model_path),
                                    device=nodes.DEVICE)
            coords = pipe.detect_faces(frames)
        else:
            coords = [(0, 0, f.shape[1], f.shape[0]) for f in frames]
        if use_cache:
            self._CACHE[key] = coords
        return (coords, images)


class MuseTalkNode:
    """Lip-synced frames: the VAE and UNet from their files, S3FD boxes with
    a face model (else ``coords``, else whole frames), the parsed paste-back
    with a BiSeNet file."""

    CATEGORY = "rvc_tpu/musetalk"
    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "process"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "images": ("IMAGE",),
            "audio": ("AUDIO",),
            "whisper": ("WHISPER_MODEL",),
            "vae_path": ("STRING", {"default": ""}),
            "unet_path": ("STRING", {"default": ""}),
        }, "optional": {
            "face_model_path": ("STRING", {"default": ""}),
            "parsing_model_path": ("STRING", {"default": ""}),
            "coords": ("COORDS",),
            "fps": ("FLOAT", {"default": 25.0}),
            "batch_size": ("INT", {"default": 8}),
        }}

    def process(self, images, audio, whisper, vae_path, unet_path, face_model_path="",
                parsing_model_path="", coords=None, fps=25.0, batch_size=8):
        from . import nodes
        from ..pipelines.musetalk import MuseTalkPipeline

        mono, a2f = _audio_features(audio, whisper)
        face = _model("s3fd", face_model_path) if face_model_path else None
        parse = _model("bisenet", parsing_model_path) if parsing_model_path else None
        pipe = MuseTalkPipeline(_model("vae", vae_path), _model("unet", unet_path), a2f,
                                face=face, parse=parse, device=nodes.DEVICE)
        frames = _frames(images)
        if coords is not None:
            boxes = list(coords)
        elif face is not None:
            boxes = None  # detected inside the pipeline
        else:
            boxes = [(0, 0, f.shape[1], f.shape[0]) for f in frames]
        out = pipe.process(frames, mono, fps=fps, boxes=boxes, batch_size=batch_size)
        return (np.stack([f.astype(np.float32) / 255.0 for f in out]),)


MUSETALK_NODE_CLASS_MAPPINGS = {
    "RVC_TPU_MuseAudioFeatures": MuseAudioFeatureExtractionNode,
    "RVC_TPU_MuseImageFeatures": MuseImageFeatureExtractionNode,
    "RVC_TPU_MuseTalk": MuseTalkNode,
}
