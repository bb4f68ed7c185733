"""The port's speech-to-text nodes (``rvc_tpu_torch/graph/stt_nodes.py``)
against the JAX package's, on the CPU.

- The text helpers (``polarity``, ``sentiment_tag``, ``extract_keywords``,
  ``limit_sentence``) give JAX's results on a corpus.
- ``RVC_TPU_TranscriptionEncoder`` gives JAX's outputs (prompts, schedule,
  durations, counts and, with a stand-in CLIP, the conditioning) for each
  combination of its options.
- ``RVC_TPU_LoadWhisper`` and ``RVC_TPU_Transcribe`` on one OpenAI-format
  ``.pt`` (tests/test_torch_whisper.py's tiny dims and weights), the
  repository's tokenizer and 8 s of the speech fixture (in 5 s chunks, two
  windows, or one 30 s window): the same transcription and frame count as
  JAX's nodes, greedy and beam (the port sampling on JAX's Gumbel draws),
  chunk and segment timestamps, with and without a language. Both sides' decoders run with
  ``max_len`` 8 and the fallback ladder at (0, 1) to keep the JAX side
  short. The loaded model stays in the node cache on ``nodes.DEVICE``."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from _torch_port import no_compile_cache_writes, one_thread  # noqa: F401
from rvc_tpu.graph import nodes as jnodes
from rvc_tpu.graph import stt_nodes as jstt
from rvc_tpu.models import whisper as JW
from rvc_tpu_torch.graph import nodes, stt_nodes
from rvc_tpu_torch.models import whisper as TW
from test_torch_convert import speech
from test_torch_whisper import DIMS, jax_gumbel

pytestmark = pytest.mark.usefixtures("one_thread")

TEXTS = [
    "The neural network model separates vocals from music. The model uses a neural "
    "network trained on music stems, and the network predicts vocal masks for the music.",
    "deep learning deep learning deep learning changes audio processing forever, deep "
    "learning wins",
    "I am miserable, crying, this is the worst", "a sad problem", "not good at all",
    "absolutely wonderful amazing perfect", "it was pretty fun", "very happy, really happy",
    "the audio file has ten channels", "", "the and of to",
    " ".join(f"word{i} filler{i}" for i in range(30)),
]


def test_text_helpers_match_jax():
    for text in TEXTS:
        assert stt_nodes.polarity(text) == jstt.polarity(text)
        assert stt_nodes.sentiment_tag(text) == jstt.sentiment_tag(text)
        for n in (0, 3, 16):
            assert stt_nodes.extract_keywords(text, max_words=n) == \
                jstt.extract_keywords(text, max_words=n)
            assert stt_nodes.limit_sentence(text, max_words=n) == \
                jstt.limit_sentence(text, max_words=n)


class StandInClip:
    """tokenize / encode_from_tokens as ComfyUI's CLIP offers them."""

    def tokenize(self, text):
        return [ord(c) for c in text]

    def encode_from_tokens(self, tokens, return_pooled=False):
        v = np.asarray(tokens, np.float32)
        return v[None] / 100.0, v.sum()


@pytest.mark.parametrize("options", [
    dict(),
    dict(use_tags=True, max_words=4, prefix="pre", suffix="suf", weights=0.85,
         use_sentiment=True),
    dict(max_chunks=1, max_words=2, weights=1.2),
])
def test_transcription_encoder_matches_jax(options):
    transcription = {"text": "x", "chunks": [
        {"text": TEXTS[0], "timestamp": (0.0, 4.0)},
        {"text": "the sound is dark and sad here", "timestamp": (4.0, 9.5)},
        {"text": TEXTS[5], "timestamp": (9.5, 10.1)}]}
    got = stt_nodes.BatchedTranscriptionEncoderNode().get_prompt(
        transcription, clip=StandInClip(), **options)
    ref = jstt.BatchedTranscriptionEncoderNode().get_prompt(
        transcription, clip=StandInClip(), **options)
    assert got[1:] == ref[1:]
    assert len(got[0]) == len(ref[0])
    for (c, p), (rc, rp) in zip(got[0], ref[0]):
        np.testing.assert_array_equal(c, rc)
        assert p == rp


@pytest.fixture(scope="module")
def whisper_pt(tmp_path_factory):
    """An OpenAI-format ``.pt`` of the tiny dims with seeded weights."""
    model = TW.Whisper(TW.WhisperDims(**DIMS))
    rng = np.random.default_rng(3)
    sd = {}
    for k, v in model.state_dict().items():
        if k == "encoder.positional_embedding":
            sd[k] = v
        elif k.endswith(".bias") and "ln" not in k:
            sd[k] = torch.zeros_like(v)
        elif "ln" in k.split(".")[-2]:
            sd[k] = torch.ones_like(v) if k.endswith("weight") else torch.zeros_like(v)
        else:
            sd[k] = torch.from_numpy((0.02 * rng.standard_normal(v.shape)).astype(np.float32))
    path = tmp_path_factory.mktemp("whisper") / "tiny.pt"
    torch.save({"dims": dataclasses.asdict(TW.WhisperDims(**DIMS)), "model_state_dict": sd},
               path)
    return str(path)


@pytest.fixture
def short_decodes(monkeypatch):
    """Both packages' decoders at max_len 8, the ladder at (0, 1), the
    port's sampling on JAX's draws; the port's nodes on the CPU."""
    for mod, extra in ((JW, {}), (TW, {"gumbel": jax_gumbel(DIMS["n_vocab"])})):
        for name in ("greedy_decode", "decode_with_timestamps"):
            monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name), max_len=8))
        monkeypatch.setattr(mod, "decode_with_fallback", functools.partial(
            mod.decode_with_fallback, max_len=8, temperatures=(0.0, 1.0), **extra))
    monkeypatch.setattr(nodes, "DEVICE", "cpu")
    monkeypatch.setattr(nodes, "_CACHE", {})
    monkeypatch.setattr(jnodes, "_CACHE", {})


@pytest.mark.parametrize("decode,timestamps,language,chunk", [
    ("greedy", "chunk", "", 5), ("beam", "chunk", "en", 30), ("greedy", "segment", "", 5)])
def test_transcribe_matches_jax(whisper_pt, short_decodes, decode, timestamps, language, chunk):
    audio = nodes.to_audio_dict(speech(8.0, 30.0), 16000)
    kw = dict(chunk_seconds=chunk, language=language, timestamps=timestamps, decode=decode)
    (loader,) = stt_nodes.WhisperLoaderNode().load(whisper_pt)
    got = stt_nodes.AudioTranscriptionNode().transcribe(audio, loader, **kw)
    (jloader,) = jstt.WhisperLoaderNode().load(whisper_pt)
    ref = jstt.AudioTranscriptionNode().transcribe(jnodes.to_audio_dict(
        speech(8.0, 30.0), 16000), jloader, **kw)
    assert got == ref
    assert got[1] == 8 and len(got[0]["chunks"]) >= (2 if chunk < 8 else 1)
    (entry,) = nodes._CACHE.values()
    assert entry["id"] == whisper_pt and loader() is entry
    assert next(entry["model"].parameters()).device == torch.device("cpu")
