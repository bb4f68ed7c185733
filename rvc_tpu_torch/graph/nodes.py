"""ComfyUI node layer: thin orchestration over the port's pipelines.

Counterpart of ``rvc_tpu/graph/nodes.py``, node for node, with the same
contracts (INPUT_TYPES, RETURN_TYPES, RETURN_NAMES, FUNCTION, CATEGORY,
OUTPUT_NODE) and registry keys, so a saved workflow runs unchanged. Nodes
work standalone (call their FUNCTION) and register with ComfyUI when it
imports ``rvc_tpu_torch.graph``. AUDIO payloads are numpy in and out; a
torch tensor from ComfyUI is read through ``.cpu()``.

Caching: results are keyed by an md5 of all their parameters (``get_hash``)
in ``_CACHE``, which also holds the loaded models on their device for the
life of the process. The model loaders return closures that load on first
call; ``RVCNode`` builds one ``VoiceConverter`` per (model, HuBERT, RMVPE)
entry, so a second clip reuses the weights on the card and kernel 1's
packed weights. A conversion's key holds the model's and HuBERT's keys
too: the JAX node's key (``rvc_tpu/graph/nodes.py:443``) leaves them out,
so two voices on one clip there return the first voice's output.

``DEVICE`` is where every node computes: None is the card
(``device.resolve_device``, which raises without one); set it to "cpu" to
run on the CPU.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any

import numpy as np

from ..config import SR_MAP, preset
from ..device import resolve_device
from ..io.audio import (SUPPORTED_AUDIO, bytes_to_audio, load_input_audio, merge_audio,
                        save_input_audio)
from ..utils import get_hash

DEVICE: str | None = None
_CACHE: dict[str, Any] = {}

PITCH_METHODS = ["rmvpe", "rmvpe+", "crepe", "crepe-tiny", "mangio-crepe",
                 "mangio-crepe-tiny", "pm", "harvest", "dio"]
MERGE_TYPES = ["median", "mean", "min", "max"]


def to_audio_dict(audio: np.ndarray, sr: int) -> dict:
    """ComfyUI's AUDIO payload: {"waveform": (1, channels, samples), "sample_rate"}."""
    return {"waveform": np.atleast_2d(audio)[None], "sample_rate": sr}


def from_audio_input(audio) -> tuple[np.ndarray, int]:
    """(waveform, sr) from an AUDIO dict (leading batch axes dropped), WAV
    bytes, an (array, sr) pair, or a callable returning one of them."""
    if callable(audio):
        audio = audio()
    if isinstance(audio, dict):
        wav = audio["waveform"]
        if hasattr(wav, "cpu"):  # a torch tensor
            wav = wav.detach().cpu().numpy()
        wav = np.asarray(wav)
        while wav.ndim > 2:
            wav = wav[0]
        return wav, int(audio["sample_rate"])
    if isinstance(audio, bytes):
        return bytes_to_audio(audio)
    return audio


class LoadAudioNode:
    CATEGORY = "rvc_tpu/audio"
    RETURN_TYPES = ("AUDIO",)
    FUNCTION = "load"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"path": ("STRING", {"default": ""}),
                             "sr": ("INT", {"default": 44100})}}

    def load(self, path: str, sr: int = 44100):
        audio, out_sr = load_input_audio(path, sr)
        return (to_audio_dict(audio, out_sr),)


def _preview_payload(saved_path: str, *hash_parts) -> list[dict]:
    """Copy a saved file into the temp preview folder and build the
    ``{"ui": {"preview": [...]}}`` entry that ``web/js/ui_handlers.js``
    plays. ComfyUI serves type "temp" from its temp directory; outside
    ComfyUI the OS temp directory takes its place."""
    widget_id = get_hash(saved_path, *hash_parts)
    ext = os.path.splitext(saved_path)[1].lstrip(".") or "wav"
    try:
        import folder_paths  # ComfyUI's module, present only inside ComfyUI

        base = folder_paths.get_temp_directory()
    except ImportError:
        base = os.path.join(tempfile.gettempdir(), "rvc_tpu")
    tempdir = os.path.join(base, "preview")
    os.makedirs(tempdir, exist_ok=True)
    audio_name = f"{widget_id}.{ext}"
    shutil.copyfile(saved_path, os.path.join(tempdir, audio_name))
    return [{"filename": audio_name, "type": "temp", "subfolder": "preview",
             "widgetId": widget_id}]


class SaveAudioNode:
    CATEGORY = "rvc_tpu/audio"
    RETURN_TYPES = ("STRING",)
    FUNCTION = "save"
    OUTPUT_NODE = True

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"audio": ("AUDIO",), "path": ("STRING", {"default": "out.wav"})}}

    def save(self, audio, path: str):
        wav, sr = from_audio_input(audio)
        save_input_audio(path, (wav, sr))
        return {"ui": {"preview": _preview_payload(path)}, "result": (path,)}


class PreviewAudioNode:
    """Writes ``<output_dir>/audio/<filename>.<save_format>`` (the first free
    ``_N`` suffix unless ``overwrite_existing``), copies it into the preview
    folder, and returns the preview payload with (output_path, audio)."""

    CATEGORY = "rvc_tpu/audio"
    RETURN_TYPES = ("STRING", "AUDIO")
    RETURN_NAMES = ("output_path", "audio")
    FUNCTION = "save_audio"
    OUTPUT_NODE = True

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "audio": ("AUDIO",),
            "filename": ("STRING", {"default": "test"}),
            "save_format": (SUPPORTED_AUDIO, {"default": "flac"}),
            "save_channels": ([1, 2], {"default": 1}),
            "overwrite_existing": ("BOOLEAN", {"default": True}),
            "autoplay": ("BOOLEAN", {"default": True}),
        }, "optional": {"output_dir": ("STRING", {"default": "output"})}}

    def save_audio(self, audio, filename: str = "test", save_format: str = "flac",
                   save_channels: int = 1, overwrite_existing: bool = True,
                   autoplay: bool = True, output_dir: str = "output"):
        filename = filename.strip()
        if not filename:
            raise ValueError("Filename cannot be empty")
        wav, sr = from_audio_input(audio)
        audio_dir = os.path.join(output_dir, "audio")
        os.makedirs(audio_dir, exist_ok=True)
        output_path = os.path.join(audio_dir, f"{filename}.{save_format}")
        if os.path.isfile(output_path) and not overwrite_existing:
            n = 1
            while os.path.isfile(output_path):
                output_path = os.path.join(audio_dir, f"{filename}_{n}.{save_format}")
                n += 1
        if save_channels == 2 and np.atleast_2d(wav).shape[0] == 1:
            wav = np.repeat(np.atleast_2d(wav), 2, axis=0)
        save_input_audio(output_path, (wav, sr))
        preview = _preview_payload(output_path, save_channels)
        preview[0]["autoplay"] = autoplay
        return {"ui": {"preview": preview},
                "result": (output_path, to_audio_dict(wav, sr))}


class MergeAudioNode:
    CATEGORY = "rvc_tpu/audio"
    RETURN_TYPES = ("AUDIO",)
    FUNCTION = "merge"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"audio1": ("AUDIO",), "audio2": ("AUDIO",),
                             "sr": ("INT", {"default": 40000})}}

    def merge(self, audio1, audio2, sr: int = 40000):
        a1, a2 = from_audio_input(audio1), from_audio_input(audio2)
        mixed, out_sr = merge_audio(a1, a2, sr=sr)
        return (to_audio_dict(mixed, out_sr),)


class DownloadAudioNode:
    """A YouTube clip's audio as AUDIO. Cache-first: a file named by the
    hash of (url, sr, format), or by ``song_name``, under ``output_dir``
    is read without a download. The download needs the optional
    ``yt_dlp`` package and the network; without ``yt_dlp`` it raises."""

    CATEGORY = "rvc_tpu/audio"
    RETURN_TYPES = ("STRING", "AUDIO")
    RETURN_NAMES = ("audio_name", "audio")
    FUNCTION = "download_audio"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"url": ("STRING", {"default": ""})},
                "optional": {"sr": (["None", 16000, 44100, 48000],
                                    {"default": "None"}),
                             "song_name": ("STRING", {"default": ""}),
                             "format": (SUPPORTED_AUDIO, {"default": "flac"}),
                             "output_dir": ("STRING",
                                            {"default": "input/audio"})}}

    def download_audio(self, url: str, sr="None", song_name: str = "",
                       format: str = "flac", output_dir: str = "input/audio"):
        if "youtube" not in url and "youtu.be" not in url:
            raise ValueError("Please provide a valid youtube URL!")
        widget_id = get_hash(url, sr, format)
        sr = None if sr == "None" else int(sr)
        audio_name = song_name or widget_id
        os.makedirs(output_dir, exist_ok=True)
        audio_path = os.path.join(output_dir, f"{audio_name}.{format}")
        if not os.path.isfile(audio_path):
            try:
                import yt_dlp
            except ImportError as e:
                raise RuntimeError(
                    "DownloadAudio needs the optional 'yt_dlp' package and "
                    "network access; in offline environments place the file "
                    f"at {audio_path} and rerun (cache-first)") from e
            ydl_opts = {
                "format": "bestaudio/best",
                "postprocessors": [{"key": "FFmpegExtractAudio",
                                    "preferredcodec": format}],
                "outtmpl": os.path.splitext(audio_path)[0],
            }
            with yt_dlp.YoutubeDL(ydl_opts) as ydl:
                ydl.download([url])
        audio, out_sr = load_input_audio(audio_path, sr)
        return {"ui": {"preview": [{"filename": os.path.basename(audio_path),
                                    "type": "input", "subfolder": "audio",
                                    "widgetId": widget_id}]},
                "result": (audio_name, to_audio_dict(audio, out_sr))}


class AudioInfoNode:
    """The audio passed through, with its duration in seconds and its rate."""

    CATEGORY = "rvc_tpu/audio"
    RETURN_TYPES = ("AUDIO", "FLOAT", "INT")
    RETURN_NAMES = ("audio", "seconds", "sr")
    FUNCTION = "get_info"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"audio": ("AUDIO",)}}

    def get_info(self, audio):
        wav, sr = from_audio_input(audio)
        seconds = float(np.atleast_2d(wav).shape[-1]) / sr
        return (audio, seconds, int(sr))


class ProcessAudioNode:
    """An ``io.audio.AudioProcessor`` with these settings, and the audio
    cleaned by it when one is given (else None)."""

    CATEGORY = "rvc_tpu/audio"
    RETURN_TYPES = ("AUDIO_PROCESSOR", "AUDIO")
    RETURN_NAMES = ("audio_processor", "audio")
    FUNCTION = "process_audio"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "normalize": ("BOOLEAN", {"default": True}),
            "threshold_silence": ("BOOLEAN", {"default": True}),
            "dynamic_threshold": ("BOOLEAN", {"default": True}),
        }, "optional": {
            "audio": ("AUDIO", {"default": None}),
            "dynamic_threshold_sample_size": ("INT", {"default": 4000}),
            "dynamic_threshold_multiplier": ("FLOAT", {"default": 2.0}),
            "dynamic_threshold_fill_method": (["median", "interpolation"],
                                              {"default": "median"}),
            "dynamic_threshold_kernel_size": ("INT", {"default": 5}),
            "silence_threshold_db": ("INT", {"default": -50}),
            "normalize_threshold_db": ("INT", {"default": -1}),
        }}

    def process_audio(self, normalize, threshold_silence, dynamic_threshold,
                      audio=None, dynamic_threshold_sample_size=16000,
                      dynamic_threshold_multiplier=2.0,
                      dynamic_threshold_fill_method="median",
                      dynamic_threshold_kernel_size=5,
                      silence_threshold_db=-50, normalize_threshold_db=-1):
        from ..io.audio import AudioProcessor

        proc = AudioProcessor(
            normalize=normalize, threshold_silence=threshold_silence,
            dynamic_threshold=dynamic_threshold,
            sample_size=dynamic_threshold_sample_size,
            multiplier=dynamic_threshold_multiplier,
            fill_method=dynamic_threshold_fill_method,
            kernel_size=dynamic_threshold_kernel_size,
            silence_threshold_db=silence_threshold_db,
            normalize_threshold_db=normalize_threshold_db)
        out = None
        if audio is not None:
            wav, sr = from_audio_input(audio)
            cleaned, out_sr = proc((wav, sr))
            out = to_audio_dict(cleaned, out_sr)
        return (proc, out)


class AudioBatchValueNode:
    """The clip's RMS over ``num_frames`` equal frames, normalized to [0, 1]
    (inverted on request) and mapped to [min_value, max_value]: a value
    curve for animation."""

    CATEGORY = "rvc_tpu/audio"
    RETURN_TYPES = ("FLOAT",)
    FUNCTION = "get_frame_weights"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "audio": ("AUDIO",),
            "num_frames": ("INT", {"default": 16}),
            "min_value": ("FLOAT", {"default": 0.0}),
            "max_value": ("FLOAT", {"default": 1.0}),
            "invert": ("BOOLEAN", {"default": False}),
        }}

    def get_frame_weights(self, audio, num_frames: int, min_value: float = 0.0,
                          max_value: float = 1.0, invert: bool = False):
        wav, sr = from_audio_input(audio)
        mono = wav.mean(0) if wav.ndim > 1 else wav
        hop = max(len(mono) // num_frames, 1)
        frames = mono[: num_frames * hop].reshape(num_frames, hop)
        rms = np.sqrt(np.mean(frames**2, axis=-1))
        lo, hi = rms.min(), rms.max()
        norm = (rms - lo) / (hi - lo + 1e-9)
        if invert:
            norm = 1.0 - norm
        vals = (min_value + norm * (max_value - min_value)).tolist()
        return (vals,)


class RVCModelLoaderNode:
    """An RVC ``.pth`` (and an optional ``.npy`` retrieval bank) as a closure
    that loads the synthesizer onto ``DEVICE`` on its first call."""

    CATEGORY = "rvc_tpu/rvc"
    RETURN_TYPES = ("RVC_MODEL",)
    FUNCTION = "load"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"model_path": ("STRING", {"default": ""})},
                "optional": {"index_path": ("STRING", {"default": ""})}}

    def load(self, model_path: str, index_path: str = ""):
        def closure():
            key = get_hash(model_path, index_path)
            if key not in _CACHE:
                from ..compat.torch_import import (load_rvc_checkpoint,
                                                   synthesizer_kwargs_from_config)
                from ..models.layers import load_numpy_state_dict
                from ..models.synthesizer import Synthesizer

                state, meta = load_rvc_checkpoint(model_path)
                kwargs = synthesizer_kwargs_from_config(
                    meta["config"], meta["version"], bool(meta["f0"]))
                synth = load_numpy_state_dict(Synthesizer(**kwargs), state)
                bank = np.load(index_path) if index_path and os.path.exists(index_path) else None
                _CACHE[key] = {"synth": synth.to(resolve_device(DEVICE)).eval(),
                               "kwargs": kwargs, "meta": meta, "index_bank": bank, "key": key}
            return _CACHE[key]

        return (closure,)


class HubertLoaderNode:
    """A HuBERT ``.safetensors`` as a closure that reads it on its first
    call; the encoder of each version is built on ``DEVICE`` at first use
    (``_hubert_encoder``)."""

    CATEGORY = "rvc_tpu/rvc"
    RETURN_TYPES = ("HUBERT_MODEL",)
    FUNCTION = "load"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"model_path": ("STRING", {"default": "content-vec-best.safetensors"})}}

    def load(self, model_path: str):
        def closure():
            key = get_hash("hubert", model_path)
            if key not in _CACHE:
                from ..compat.torch_import import load_hubert_safetensors

                state, cfg = load_hubert_safetensors(model_path)
                _CACHE[key] = {"state": state, "cfg": cfg, "key": key, "encoders": {}}
            return _CACHE[key]

        return (closure,)


def _hubert_encoder(h: dict, version: str):
    """The ``HubertEncoder`` of ``version`` ("v1": layer 9 and final_proj,
    "v2": layer 12) from a HuBERT loader's entry, built once on ``DEVICE``."""
    if version not in h["encoders"]:
        from ..pipelines.preprocess import hubert_from_state

        h["encoders"][version] = hubert_from_state(h["state"], h["cfg"], version, DEVICE)
    return h["encoders"][version]


def _rmvpe(path: str):
    """The RMVPE model of ``rmvpe.pt`` at ``path``, loaded once on ``DEVICE``."""
    key = get_hash("rmvpe", path)
    if key not in _CACHE:
        from ..compat.torch_import import load_rmvpe
        from ..models.layers import load_numpy_state_dict
        from ..models.rmvpe import RMVPE

        model = RMVPE()
        load_numpy_state_dict(model.model, load_rmvpe(path))
        _CACHE[key] = model.to(resolve_device(DEVICE)).eval()
    return _CACHE[key]


def _converter(m: dict, h: dict, rmvpe_path: str):
    """The ``VoiceConverter`` of a model entry, a HuBERT entry and an
    ``rmvpe.pt`` ("" or a missing file: no RMVPE), built once on their
    modules: the weights are uploaded and packed once per entry."""
    rmvpe_path = rmvpe_path if rmvpe_path and os.path.exists(rmvpe_path) else ""
    key = get_hash("vc", m["key"], h["key"], rmvpe_path)
    if key not in _CACHE:
        from ..pipelines.convert import VoiceConverter
        from ..pitch.extractor import PitchExtractor

        version = "v1" if m["kwargs"].get("feature_dim", 768) == 256 else "v2"
        pitch = PitchExtractor(_rmvpe(rmvpe_path) if rmvpe_path else None)
        _CACHE[key] = VoiceConverter(m["synth"], m["kwargs"], _hubert_encoder(h, version),
                                     pitch, index_bank=m["index_bank"], device=DEVICE)
    return _CACHE[key]


class PitchExtractionParamsNode:
    """The pitch and conversion settings of ``RVCNode`` as one dict."""

    CATEGORY = "rvc_tpu/rvc"
    RETURN_TYPES = ("PITCH_EXTRACTION_PARAMS",)
    FUNCTION = "load"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "f0_method": (PITCH_METHODS, {"default": "rmvpe"}),
            "f0_autotune": ("BOOLEAN", {"default": False}),
            "merge_type": (MERGE_TYPES, {"default": "median"}),
            "index_rate": ("FLOAT", {"default": 0.75}),
            "filter_radius": ("INT", {"default": 3}),
            "resample_sr": ("INT", {"default": 0}),
            "rms_mix_rate": ("FLOAT", {"default": 0.25}),
            "protect": ("FLOAT", {"default": 0.33}),
            "crepe_hop_length": ("INT", {"default": 160}),
            "rmvpe_path": ("STRING", {"default": ""}),
        }}

    def load(self, **kwargs):
        return (kwargs,)


class RVCNode:
    """Voice conversion of the audio's downmix: ``VoiceConverter.convert``
    at float32, its int16 output as float32 / 32768."""

    CATEGORY = "rvc_tpu/rvc"
    RETURN_TYPES = ("AUDIO",)
    FUNCTION = "convert"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "audio": ("AUDIO",),
            "model": ("RVC_MODEL",),
            "hubert": ("HUBERT_MODEL",),
            "f0_up_key": ("INT", {"default": 0}),
        }, "optional": {"pitch_params": ("PITCH_EXTRACTION_PARAMS",),
                        "sid": ("INT", {"default": 0})}}

    def convert(self, audio, model, hubert, f0_up_key: int = 0,
                pitch_params: dict | None = None, sid: int = 0):
        from ..pipelines.convert import ConvertSettings

        wav, sr = from_audio_input(audio)
        pp = dict(pitch_params or {})
        m = model() if callable(model) else model
        h = hubert() if callable(hubert) else hubert
        cache_key = get_hash(get_hash(wav), f0_up_key, sid, sorted(pp.items()),
                             m["key"], h["key"])
        if cache_key in _CACHE:
            return (_CACHE[cache_key],)
        vc = _converter(m, h, pp.pop("rmvpe_path", ""))
        settings = ConvertSettings(sid=sid, f0_up_key=f0_up_key, **{
            k: v for k, v in pp.items() if k in ConvertSettings.__dataclass_fields__
        })
        out, out_sr = vc.convert(wav if wav.ndim == 1 else wav.mean(0), sr, settings)
        result = to_audio_dict(out.astype(np.float32) / 32768.0, out_sr)
        _CACHE[cache_key] = result
        return (result,)


class ProcessDatasetNode:
    """Slice a folder of clips, extract HuBERT features and f0 on ``DEVICE``
    (methods that need no weights: the node takes no pitch model, as in
    the JAX package), write the mute fixtures and the filelist."""

    CATEGORY = "rvc_tpu/rvc"
    RETURN_TYPES = ("DATASET_PIPE",)
    FUNCTION = "process"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "input_dir": ("STRING", {"default": ""}),
            "exp_dir": ("STRING", {"default": ""}),
            "sr": (["32k", "40k", "48k"], {"default": "40k"}),
            "hubert": ("HUBERT_MODEL",),
            "f0_method": (PITCH_METHODS, {"default": "rmvpe"}),
            "version": (["v1", "v2"], {"default": "v2"}),
        }}

    def process(self, input_dir, exp_dir, sr, hubert, f0_method="rmvpe", version="v2"):
        from ..pipelines.preprocess import (Preprocess, build_filelist, extract_features,
                                            generate_mute_fixtures)

        sr_int = SR_MAP[sr]
        h = hubert() if callable(hubert) else hubert
        Preprocess(sr_int, exp_dir).run_dir(input_dir)
        extract_features(exp_dir, _hubert_encoder(h, version), f0_method=f0_method,
                         version=version, device=DEVICE)
        mute = os.path.join(exp_dir, "mute")
        generate_mute_fixtures(mute, sr_int, version)
        filelist = build_filelist(exp_dir, sr_int, version=version, mute_dir=mute)
        return ({"filelist": filelist, "sr": sr, "version": version,
                 "exp_dir": exp_dir},)


class TrainParamsNode:
    """Loss weights, batch size and learning rate as one dict for
    ``TrainModelNode``."""

    CATEGORY = "rvc_tpu/rvc"
    RETURN_TYPES = ("RVC_TRAINING_PARAMS",)
    RETURN_NAMES = ("rvc_training_params",)
    FUNCTION = "init"

    @classmethod
    def INPUT_TYPES(cls):
        return {"optional": {
            "batch_size": ("INT", {"default": 4}),
            "c_mel": ("FLOAT", {"default": 45.0}),
            "c_kl": ("FLOAT", {"default": 1.0}),
            "c_tefs": ("FLOAT", {"default": 0.0}),
            "c_hd": ("FLOAT", {"default": 0.0}),
            "c_tsi": ("FLOAT", {"default": 0.0}),
            "c_gp": ("FLOAT", {"default": 0.0}),
            "use_multiscale": ("BOOLEAN", {"default": False}),
            "use_balancer": ("BOOLEAN", {"default": False}),
            "learning_rate": ("FLOAT", {"default": 1e-4}),
        }}

    def init(self, **kwargs):
        return (kwargs,)


class TrainModelNode:
    """Train the dataset's preset (``<sr>_v2`` or ``<sr>``) on ``DEVICE``
    through ``pipelines.train.train_model``; returns the exported ``.pth``.
    ``use_multiscale`` and ``use_balancer`` are dropped, as the JAX node
    drops them (``rvc_tpu/graph/nodes.py:560-561``): the run keeps
    ``TrainRunConfig``'s defaults, the balancer on."""

    CATEGORY = "rvc_tpu/rvc"
    RETURN_TYPES = ("STRING",)
    FUNCTION = "train"
    OUTPUT_NODE = True

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "dataset": ("DATASET_PIPE",),
            "model_name": ("STRING", {"default": "model"}),
            "epochs": ("INT", {"default": 100}),
            "batch_size": ("INT", {"default": 4}),
            "save_every_epoch": ("INT", {"default": 10}),
        }, "optional": {
            "train_params": ("RVC_TRAINING_PARAMS",),
        }}

    def train(self, dataset, model_name, epochs=100, batch_size=4,
              save_every_epoch=10, train_params=None):
        import dataclasses

        from ..pipelines.train import TrainRunConfig, train_model

        cfg_name = dataset["sr"] + ("_v2" if dataset["version"] == "v2" else "")
        cfg = preset(cfg_name)
        overrides = dict(epochs=epochs, batch_size=batch_size)
        if train_params:
            tp = dict(train_params)
            tp.pop("use_multiscale", None)
            tp.pop("use_balancer", None)
            if "batch_size" in tp:
                overrides["batch_size"] = tp.pop("batch_size")
            field_names = set(type(cfg.train).__dataclass_fields__)
            overrides.update({k: v for k, v in tp.items() if k in field_names})
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, **overrides))
        run = TrainRunConfig(
            model_dir=os.path.join(dataset["exp_dir"], model_name),
            filelist=dataset["filelist"], total_epochs=epochs,
            save_every_epoch=save_every_epoch, export_name=model_name, device=DEVICE,
        )
        return (train_model(cfg, run),)


class TrainIndexNode:
    """The retrieval bank of the dataset's features (``retrieval.index.
    train_index`` on ``DEVICE``), saved as ``<exp_dir>/index.npy``."""

    CATEGORY = "rvc_tpu/rvc"
    RETURN_TYPES = ("STRING",)
    FUNCTION = "train_index"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"dataset": ("DATASET_PIPE",)}}

    def train_index(self, dataset):
        from ..retrieval.index import train_index

        feat_dim = "3_feature256" if dataset["version"] == "v1" else "3_feature768"
        feat_dir = os.path.join(dataset["exp_dir"], feat_dim)
        feats = np.concatenate(
            [np.load(os.path.join(feat_dir, f)) for f in sorted(os.listdir(feat_dir))]
        )
        index = train_index(feats, device=DEVICE)
        out = os.path.join(dataset["exp_dir"], "index.npy")
        index.save(out)
        return (out,)


class UVR5Node:
    """Vocal and instrumental separation with the separator that the model
    file's name asks for (``pipelines.separate.route_separator``)."""

    CATEGORY = "rvc_tpu/audio"
    RETURN_TYPES = ("AUDIO", "AUDIO")
    RETURN_NAMES = ("vocals", "instrumentals")
    FUNCTION = "split"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "audio": ("AUDIO",),
            "model_path": ("STRING", {"default": ""}),
            "aggressiveness": ("FLOAT", {"default": 10.0}),
            "use_cache": ("BOOLEAN", {"default": True}),
        }}

    def split(self, audio, model_path: str, aggressiveness: float = 10.0,
              use_cache: bool = True):
        from ..pipelines.separate import route_separator

        wav, sr = from_audio_input(audio)
        key = get_hash("uvr", get_hash(wav), model_path, aggressiveness)
        if use_cache and key in _CACHE:
            out = _CACHE[key]
        else:
            sep = _load_separator(route_separator(model_path), model_path, aggressiveness)
            out = sep.run_inference(wav, sr)
            if use_cache:
                _CACHE[key] = out
        v, vs = out["vocals"][0], out["vocals"][1]
        i, is_ = out["instrumentals"][0], out["instrumentals"][1]
        return (
            to_audio_dict(np.asarray(v, np.float32) / 32768.0, vs),
            to_audio_dict(np.asarray(i, np.float32) / 32768.0, is_),
        )


def _load_separator(kind: str, model_path: str, agg: float):
    """``pipelines.separate.load_separator`` on ``DEVICE``, once per (kind,
    file); a cached separator takes the new ``agg``. The JAX node builds
    its TPU-fused VR separator off the CPU; the port's VR separator is the
    same function."""
    key = get_hash("sep", kind, model_path)
    if key not in _CACHE:
        from ..pipelines.separate import load_separator

        _CACHE[key] = load_separator(kind, model_path, agg, device=DEVICE)
    sep = _CACHE[key]
    sep.agg = agg
    return sep


NODE_CLASS_MAPPINGS = {
    "RVC_TPU_LoadAudio": LoadAudioNode,
    "RVC_TPU_SaveAudio": SaveAudioNode,
    "RVC_TPU_PreviewAudio": PreviewAudioNode,
    "RVC_TPU_MergeAudio": MergeAudioNode,
    "RVC_TPU_DownloadAudio": DownloadAudioNode,
    "RVC_TPU_AudioInfo": AudioInfoNode,
    "RVC_TPU_ProcessAudio": ProcessAudioNode,
    "RVC_TPU_TrainParams": TrainParamsNode,
    "RVC_TPU_AudioBatchValue": AudioBatchValueNode,
    "RVC_TPU_LoadRVCModel": RVCModelLoaderNode,
    "RVC_TPU_LoadHubert": HubertLoaderNode,
    "RVC_TPU_PitchParams": PitchExtractionParamsNode,
    "RVC_TPU_Convert": RVCNode,
    "RVC_TPU_ProcessDataset": ProcessDatasetNode,
    "RVC_TPU_TrainModel": TrainModelNode,
    "RVC_TPU_TrainIndex": TrainIndexNode,
    "RVC_TPU_UVR5": UVR5Node,
}

NODE_DISPLAY_NAME_MAPPINGS = {
    k: k.replace("RVC_TPU_", "RVC-TPU ") for k in NODE_CLASS_MAPPINGS
}
