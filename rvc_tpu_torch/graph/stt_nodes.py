"""Speech-to-text nodes: Whisper transcription -> prompt schedules.

Counterpart of ``rvc_tpu/graph/stt_nodes.py`` (the reference's
custom_nodes/stt.py): transcribe audio with Whisper (chunked, with chunk or
segment timestamps, greedy or beam decoding), then turn each chunk's text
into a CLIP prompt schedule: keywords a chunk (textacy SGRank over 1-2
grams in the reference, stt.py:31-49; here a self-contained
co-occurrence-graph ranker over the same candidates) and an optional
sentiment tag (spacytextblob polarity in the reference, stt.py:86-97;
here a compact lexicon scorer with negation and intensifiers, mapped
through the reference's polarity thresholds). The text helpers are the
JAX package's, line for line. Transcription runs on the port's
``models/whisper.py`` on ``nodes.DEVICE`` (None: the card), the loaded
model kept there in ``nodes._CACHE``; the tokenizer is the port's
``models/whisper_bpe.py`` (the HF ``WhisperTokenizer`` only for an explicit
HF-format path it cannot read, as JAX's node).
"""
from __future__ import annotations

import re

import numpy as np

SUPPORTED_LANGUAGES = ["en", "es", "fr", "de", "it", "pt", "ja", "zh", "ko"]

_STOPWORDS = set(
    "the a an and or but if then else of to in on for with at by from as is are was "
    "were be been being have has had do does did will would can could should may "
    "might it its it's this that these those i you he she we they them his her my "
    "your our their me him us so not no yes oh".split()
)

# -- sentiment (reference stt.py:86-97 SpacyTextBlobSentiment) --------------
# TextBlob scores polarity from a pattern lexicon; this is a compact stand-in
# lexicon covering common affect words, with negation flips and intensifier
# scaling — enough to land the four coarse buckets the reference maps to.
_POLARITY = {
    "good": 0.7, "great": 0.8, "excellent": 1.0, "amazing": 0.9, "awesome": 1.0,
    "wonderful": 1.0, "fantastic": 0.9, "perfect": 1.0, "best": 1.0, "love": 0.5,
    "loved": 0.7, "loves": 0.5, "like": 0.3, "liked": 0.4, "likes": 0.3,
    "happy": 0.8, "happiness": 0.8, "joy": 0.8, "joyful": 0.8, "glad": 0.5,
    "beautiful": 0.85, "nice": 0.6, "fun": 0.3, "funny": 0.25, "smile": 0.5,
    "smiling": 0.5, "laugh": 0.5, "laughing": 0.5, "delighted": 1.0,
    "pleased": 0.6, "enjoy": 0.4, "enjoyed": 0.5, "exciting": 0.35,
    "excited": 0.35, "brilliant": 0.9, "win": 0.4, "won": 0.4, "sweet": 0.35,
    "pretty": 0.25, "cool": 0.35, "better": 0.5, "super": 0.3, "thank": 0.4,
    "thanks": 0.4, "hope": 0.3, "hopeful": 0.5, "proud": 0.8, "warm": 0.6,
    "bad": -0.7, "terrible": -1.0, "awful": -1.0, "horrible": -1.0,
    "worst": -1.0, "hate": -0.8, "hated": -0.9, "hates": -0.8, "sad": -0.5,
    "sadness": -0.5, "unhappy": -0.6, "miserable": -1.0, "cry": -0.5,
    "crying": -0.5, "tears": -0.4, "angry": -0.5, "anger": -0.5, "mad": -0.6,
    "furious": -0.9, "afraid": -0.6, "scared": -0.6, "fear": -0.6,
    "wrong": -0.5, "fail": -0.5, "failed": -0.6, "failure": -0.6,
    "lost": -0.4, "lose": -0.4, "hurt": -0.6, "pain": -0.6, "painful": -0.7,
    "broken": -0.4, "sick": -0.7, "die": -0.6, "died": -0.7, "dead": -0.6,
    "death": -0.6, "alone": -0.3, "lonely": -0.6, "sorry": -0.5,
    "worse": -0.6, "annoying": -0.6, "stupid": -0.7, "ugly": -0.7,
    "boring": -0.6, "disappointed": -0.7, "disappointing": -0.7,
    "dark": -0.15, "cold": -0.3, "problem": -0.3, "trouble": -0.4,
}
_NEGATIONS = {"not", "no", "never", "nothing", "nobody", "neither", "nor",
              "n't", "dont", "don't", "cant", "can't", "wont", "won't",
              "isnt", "isn't", "wasnt", "wasn't", "hardly", "without"}
_INTENSIFIERS = {"very": 1.3, "really": 1.3, "extremely": 1.5, "so": 1.2,
                 "incredibly": 1.5, "absolutely": 1.4, "totally": 1.3,
                 "quite": 1.1, "too": 1.1, "slightly": 0.5, "somewhat": 0.6,
                 "a_bit": 0.5, "barely": 0.4, "kind": 0.7, "sort": 0.7}


def polarity(text: str) -> float:
    """Lexicon polarity in [-1, 1] (TextBlob-style averaging over the
    sentiment-bearing words, negation within a 2-token window flips sign,
    a preceding intensifier scales magnitude)."""
    tokens = re.findall(r"[a-z']+|n't", text.lower())
    scores = []
    for i, tok in enumerate(tokens):
        base = _POLARITY.get(tok)
        if base is None:
            continue
        scale = 1.0
        for j in range(max(0, i - 2), i):
            prev = tokens[j]
            if prev in _NEGATIONS:
                scale *= -0.5  # TextBlob multiplies by -0.5 on negation
            elif prev in _INTENSIFIERS:
                scale *= _INTENSIFIERS[prev]
        scores.append(max(-1.0, min(1.0, base * scale)))
    return float(np.mean(scores)) if scores else 0.0


def sentiment_tag(text: str) -> str:
    """Polarity → emotion prompt tag; thresholds mirror reference
    stt.py:90-95 exactly."""
    p = polarity(text)
    if p < -0.5:
        return "sad, tears, crying"
    if p < -0.05:
        return "sad, tears"
    if p > 0.5:
        return "happy, smile, laughing"
    if p > 0.05:
        return "slight smile"
    return ""


# -- keywording (reference stt.py:31-49 extract_keywords via SGRank) --------
def extract_keywords(text: str, max_words: int = 16, **_) -> str:
    """Graph-ranked keyword extraction over 1-2gram candidates.

    The reference runs textacy's SGRank (ngrams=[1,2], POS-filtered).
    Equivalent self-contained scheme: build a co-occurrence graph of
    content unigrams (window 4), run TextRank power iteration, then score
    bigram candidates as the sum of member ranks with SGRank's
    early-position boost (1/log2(pos+2)). Deterministic, no model files.
    """
    words = re.findall(r"[a-z0-9']*[a-z][a-z0-9']*", text.lower())
    content = [(i, w) for i, w in enumerate(words)
               if w not in _STOPWORDS and len(w) > 2]
    if not content:
        return ""
    vocab = sorted({w for _, w in content})
    idx = {w: k for k, w in enumerate(vocab)}
    n = len(vocab)
    adj = np.zeros((n, n), np.float64)
    for a in range(len(content)):
        ia, wa = content[a]
        for b in range(a + 1, len(content)):
            ib, wb = content[b]
            if ib - ia > 4:
                break
            if wa != wb:
                adj[idx[wa], idx[wb]] += 1.0
                adj[idx[wb], idx[wa]] += 1.0
    deg = adj.sum(1, keepdims=True)
    trans = np.divide(adj, deg, out=np.zeros_like(adj), where=deg > 0)
    rank = np.full(n, 1.0 / n)
    for _i in range(30):  # damped PageRank, d=0.85
        rank = 0.15 / n + 0.85 * (trans.T @ rank)
    first_pos = {}
    for i, w in content:
        first_pos.setdefault(w, i)
    # candidates: unigrams + adjacent-content bigrams
    cand: dict[str, float] = {}
    for w in vocab:
        boost = 1.0 / np.log2(first_pos[w] + 2.0)
        cand[w] = rank[idx[w]] * (1.0 + boost)
    for a in range(len(content) - 1):
        (ia, wa), (ib, wb) = content[a], content[a + 1]
        if ib == ia + 1 and wa != wb:
            bg = f"{wa} {wb}"
            boost = 1.0 / np.log2(ia + 2.0)
            score = (rank[idx[wa]] + rank[idx[wb]]) * (1.0 + boost)
            cand[bg] = max(cand.get(bg, 0.0), score)
    topn = int(max_words) if max_words > 0 else len(cand)
    ranked = sorted(cand.items(), key=lambda kv: kv[1], reverse=True)
    # drop unigrams fully absorbed by a selected bigram (SGRank-style dedup)
    out: list[str] = []
    for term, _score in ranked:
        if len(out) >= topn:
            break
        if " " not in term and any(term in t.split() for t in out):
            continue
        out.append(term)
    return ", ".join(out)


def limit_sentence(text: str, max_words: int = 16, **_) -> str:
    return " ".join(text.split()[:max_words])


class WhisperLoaderNode:
    CATEGORY = "rvc_tpu/stt"
    RETURN_TYPES = ("WHISPER_MODEL",)
    FUNCTION = "load"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"model_path": ("STRING", {"default": "whisper/tiny.pt"})}}

    def load(self, model_path: str):
        def closure():
            from . import nodes
            from ..models.whisper import load_whisper
            from ..utils import get_hash

            key = get_hash("whisper", model_path)
            if key not in nodes._CACHE:
                model, dims = load_whisper(model_path, device=nodes.DEVICE)
                nodes._CACHE[key] = {"model": model, "dims": dims, "id": model_path}
            return nodes._CACHE[key]

        return (closure,)


class AudioTranscriptionNode:
    """Whisper transcription with chunk timestamps (the reference's
    stt.py:224 AudioTranscriptionNode.transcribe): 30 s windows of the
    16 kHz mono mix, each padded to 30 s; ``timestamps="segment"`` reads the
    model's timestamp tokens (falling back to the chunk when a window has
    none), ``decode="beam"`` runs beam search with the temperature
    fallback."""

    CATEGORY = "rvc_tpu/stt"
    RETURN_TYPES = ("TRANSCRIPTION", "INT")
    RETURN_NAMES = ("transcription", "audio_frames")
    FUNCTION = "transcribe"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"audio": ("AUDIO",), "model": ("WHISPER_MODEL",)},
                "optional": {"chunk_seconds": ("INT", {"default": 30}),
                             "tokenizer_path": ("STRING", {"default": ""}),
                             "language": ("STRING", {"default": ""}),
                             "timestamps": (["chunk", "segment"], {"default": "chunk"}),
                             "decode": (["greedy", "beam"], {"default": "greedy"}),
                             "beam_size": ("INT", {"default": 5})}}

    def transcribe(self, audio, model, chunk_seconds: int = 30, tokenizer_path: str = "",
                   language: str = "", timestamps: str = "chunk", decode: str = "greedy",
                   beam_size: int = 5):
        import torch

        from .nodes import from_audio_input
        from ..io.audio import remix_audio
        from ..models import whisper as W

        wav, sr = from_audio_input(audio)
        mono, _ = remix_audio((wav, sr), target_sr=16000, norm=True)
        m = model() if callable(model) else model
        tokenizer = _load_tokenizer(tokenizer_path, m["dims"].n_vocab >= 51865)
        device = next(m["model"].parameters()).device

        def to_text(token_ids):
            if tokenizer is None:
                return " ".join(str(t) for t in token_ids)
            if hasattr(tokenizer, "_id_to_bytes"):  # the port's BPE drops specials itself
                return tokenizer.decode(token_ids)
            return tokenizer.decode([t for t in token_ids if t < 50257])

        chunks = []
        step = chunk_seconds * 16000
        for start in range(0, len(mono), step):
            seg = mono[start:start + step]
            seg = np.pad(seg, (0, 30 * 16000 - len(seg)))
            mel = W.log_mel_spectrogram(torch.as_tensor(seg, dtype=torch.float32,
                                                        device=device)[None])
            if timestamps == "segment":
                # the model's timestamp tokens, 0.02 s apart (the reference's
                # HF pipeline with return_timestamps=True)
                off = start / 16000
                segs = W.decode_with_timestamps(m["model"], mel, language=language or None)[0]
                for s0, s1, toks in segs:
                    chunks.append({"text": to_text(toks).strip(),
                                   "timestamp": (off + s0, off + s1)})
                if segs:
                    continue
                # no timestamp pair decoded: the chunk's own span below
            if decode == "beam":
                # beam search and the temperature fallback (the reference's
                # vendored transcribe.py decode_with_fallback)
                toks, _info = W.decode_with_fallback(m["model"], mel, beam_size=beam_size,
                                                     language=language or None)
                token_list = toks.tolist()
            else:
                token_list = W.greedy_decode(m["model"], mel,
                                             language=language or None)[0].tolist()
            chunks.append({"text": to_text(token_list).strip(),
                           "timestamp": (start / 16000, min((start + step) / 16000,
                                                            len(mono) / 16000))})
        transcription = {"text": " ".join(c["text"] for c in chunks), "chunks": chunks}
        frames = int(np.ceil(len(mono) / 16000))
        return (transcription, frames)


def _load_tokenizer(path: str, multilingual: bool = True):
    """The port's BPE (the repository's ``assets/whisper`` artifacts, or an
    explicit artifact or HF-format path), else HF's ``WhisperTokenizer``:
    from a local snapshot when no path is given (None if there is none),
    from an explicit path the port cannot read."""
    from ..models.whisper_bpe import load_tokenizer

    native = load_tokenizer(path or None, multilingual=multilingual)
    if native is not None:
        return native
    if not path:
        try:
            from transformers import WhisperTokenizer

            # local_files_only: offline, the hub lookup would retry for minutes
            return WhisperTokenizer.from_pretrained("openai/whisper-tiny", local_files_only=True)
        except Exception:
            return None
    from transformers import WhisperTokenizer

    return WhisperTokenizer.from_pretrained(path)


class BatchedTranscriptionEncoderNode:
    """Chunks → per-interval prompt schedule + CLIP conditioning (reference
    stt.py:300 BatchedTranscriptionEncoderNode.get_prompt)."""

    CATEGORY = "rvc_tpu/stt"
    RETURN_TYPES = ("CONDITIONING", "STRING", "INT", "INT", "INT", "STRING")
    RETURN_NAMES = ("conditioning", "batch_prompt_text", "duration_list",
                    "num_chunks", "num_frames", "prompt_text_list")
    OUTPUT_IS_LIST = (False, False, False, False, False, True)
    FUNCTION = "get_prompt"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"transcription": ("TRANSCRIPTION",)},
                "optional": {
                    "clip": ("CLIP",),
                    "use_tags": ("BOOLEAN", {"default": False}),
                    "max_words": ("INT", {"default": 16}),
                    "max_chunks": ("INT", {"default": 0}),
                    "prefix": ("STRING", {"default": "masterpiece, best quality"}),
                    "suffix": ("STRING", {"default": ""}),
                    "weights": ("FLOAT", {"default": 1.0}),
                    "use_sentiment": ("BOOLEAN", {"default": False}),
                }}

    def get_prompt(self, transcription, clip=None, use_tags=False, max_words=16,
                   max_chunks=0, prefix="", suffix="", weights=1.0,
                   use_sentiment=False, **_):
        chunks = transcription["chunks"]
        if max_chunks:
            chunks = chunks[:max_chunks]
        process = extract_keywords if use_tags else limit_sentence
        prompts, durations, conds = [], [], []
        for chunk in chunks:
            text = process(chunk["text"], max_words=max_words)
            if text and weights != 1.0:
                # reference stt.py:48,57 weight syntax: "(tags:0.850)"
                text = f"({text}:{weights:.3f})"
            sentiment = sentiment_tag(chunk["text"]) if use_sentiment else ""
            full = ", ".join(p for p in (prefix, text, sentiment, suffix) if p)
            t0, t1 = chunk.get("timestamp", (0, 1))
            durations.append(max(int(round((t1 or 0) - (t0 or 0))), 1))
            prompts.append(full)
            if clip is not None:
                tokens = clip.tokenize(full)
                cond, pooled = clip.encode_from_tokens(tokens, return_pooled=True)
                conds.append([cond * weights, {"pooled_output": pooled}])
        batch_prompt = "\n".join(
            f'"{i}": "{p}"' for i, p in enumerate(prompts)
        )
        num_frames = int(sum(durations))
        return (conds, batch_prompt, durations, len(chunks), num_frames, prompts)


STT_NODE_CLASS_MAPPINGS = {
    "RVC_TPU_LoadWhisper": WhisperLoaderNode,
    "RVC_TPU_Transcribe": AudioTranscriptionNode,
    "RVC_TPU_TranscriptionEncoder": BatchedTranscriptionEncoderNode,
}
