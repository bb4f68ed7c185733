"""Whisper, the encoder-decoder speech recognizer (speech to text, and the
audio front end of lip sync).

Counterpart of ``rvc_tpu/models/whisper.py`` (the reference vendors OpenAI's
Whisper, lib/musetalk/whisper/, and uses ``transcribe`` for the STT node,
custom_nodes/stt.py:224): a log-mel front end on the port's ``ops.stft``,
a conv stem with sinusoidal positions and a pre-norm transformer encoder,
and a decoder of causal self-attention and cross-attention. The modules
carry OpenAI's state_dict names (``encoder.blocks.N.attn.query`` ...,
``decoder.token_embedding.weight``), so an official ``.pt`` loads with no
renaming table (``load_whisper``, ``weights_only=True``).

Decoding runs on the device with a KV cache: each decoder layer's
self-attention keys and values grow one row a step, the cross-attention's
are computed once per audio (``TextDecoder.cross_kv``). JAX's host loops
run the full-context decoder over a padded token buffer and read one row
(rvc_tpu/models/whisper.py:387-410); the cached step computes the same
function in another order, and copies one row of tokens (greedy,
sampling) or the beams' top candidates (beam search) to the host a step,
as JAX's loops do. ``_sample_decode`` draws as ``jax.random.categorical``
does, argmax(log p / T + Gumbel noise), the noise from ``gumbel(seed,
step)`` when it is given (so a caller can replay JAX's draws) or from a
CPU generator seeded with ``seed``.

Every function takes ``dtype``, the compute dtype (float32, or bfloat16 as
the JAX module's): the layers round as ``models.layers``' do, norms take
float32 statistics, the softmax is taken in float32, the logits come out
in float32. In float32 the attention is ``scaled_dot_product_attention``;
below it, the scores and probabilities round as JAX's einsums do.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device, set_float32_math
from ..ops.mel import mel_filterbank_slaney_np
from ..ops.stft import stft
from .layers import (Conv1d, Linear, TorchLayerNorm, gelu, low_precision, rounded,
                     set_dtype_)

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
N_MELS = 80
SOT, EOT = 50258, 50257  # the multilingual layout's


@dataclass(frozen=True)
class WhisperDims:
    """Model dimensions (OpenAI naming). Defaults: tiny."""

    n_mels: int = 80
    n_audio_ctx: int = 1500
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_vocab: int = 51865
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4


# language codes in token order: token id = SOT + 1 + index (the public
# whisper tokenizer's LANGUAGES table; v3 appends "yue")
LANGUAGE_CODES = (
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca",
    "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms",
    "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
    "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn",
    "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
    "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
    "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha",
    "ba", "jw", "su", "yue",
)

WHISPER_SIZES = {
    "tiny": WhisperDims(),
    "base": WhisperDims(n_audio_state=512, n_audio_head=8, n_audio_layer=6,
                        n_text_state=512, n_text_head=8, n_text_layer=6),
    "small": WhisperDims(n_audio_state=768, n_audio_head=12, n_audio_layer=12,
                         n_text_state=768, n_text_head=12, n_text_layer=12),
    "medium": WhisperDims(n_audio_state=1024, n_audio_head=16, n_audio_layer=24,
                          n_text_state=1024, n_text_head=16, n_text_layer=24),
}


def log_mel_spectrogram(audio: torch.Tensor) -> torch.Tensor:
    """(B, T) at 16 kHz -> (B, frames, 80), whisper's normalized log10-mel:
    a centred reflect-padded STFT, its power without the last frame, the
    Slaney mel bank, log10 floored at 1e-10, clipped to the maximum less 8,
    then (x + 4) / 4."""
    real, imag = stft(audio.float(), N_FFT, HOP_LENGTH, N_FFT, center=True)
    power = (real * real + imag * imag)[:, :-1, :]
    fb = torch.as_tensor(mel_filterbank_slaney_np(SAMPLE_RATE, N_FFT, N_MELS, 0.0, None),
                         device=power.device)
    log_spec = torch.log10(torch.clamp(torch.matmul(power, fb), min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (log_spec + 4.0) / 4.0


def sinusoids(length: int, channels: int) -> np.ndarray:
    log_timescale = np.log(10000) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


class WhisperAttention(nn.Module):
    """Multi-head attention under OpenAI's names (``query``, ``key`` without
    a bias, ``value``, ``out``); q and k each scaled by d^-1/4."""

    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.query = Linear(n_state, n_state)
        self.key = Linear(n_state, n_state, bias=False)
        self.value = Linear(n_state, n_state)
        self.out = Linear(n_state, n_state)

    def heads(self, x: torch.Tensor, scaled: bool) -> torch.Tensor:
        """(B, T, D) -> (B, H, T, d), times d^-1/4 when ``scaled``."""
        B, T, D = x.shape
        d = D // self.n_head
        if scaled:
            x = x * rounded(d ** -0.25, x.dtype)
        return x.reshape(B, T, self.n_head, d).transpose(1, 2)

    def kv(self, src: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return self.heads(self.key(src), True), self.heads(self.value(src), False)

    def attend(self, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal_from: int | None = None) -> torch.Tensor:
        """x (B, Tq, D) against the heads k, v (B, H, Tk, d). ``causal_from``:
        the queries sit at positions causal_from.. and see keys up to their
        own (None: every key)."""
        q = self.heads(self.query(x), True)
        Tq, Tk = q.shape[2], k.shape[2]
        mask = None
        if causal_from is not None and Tq > 1:
            pos = torch.arange(causal_from, causal_from + Tq, device=x.device)
            mask = torch.arange(Tk, device=x.device)[None, :] <= pos[:, None]
        if not low_precision(q.dtype):
            o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0)
        else:
            scores = torch.matmul(q, k.transpose(-1, -2))
            if mask is not None:
                scores = scores.masked_fill(~mask, float("-inf"))
            p = torch.softmax(scores.float(), -1).to(q.dtype)
            o = torch.matmul(p, v)
        B = o.shape[0]
        return self.out(o.transpose(1, 2).reshape(B, Tq, -1))


class ResidualBlock(nn.Module):
    """Pre-norm block: self-attention, cross-attention (decoder), MLP."""

    def __init__(self, n_state: int, n_head: int, cross: bool = False):
        super().__init__()
        self.attn = WhisperAttention(n_state, n_head)
        self.attn_ln = TorchLayerNorm(n_state)
        if cross:
            self.cross_attn = WhisperAttention(n_state, n_head)
            self.cross_attn_ln = TorchLayerNorm(n_state)
        self.mlp = nn.Sequential(Linear(n_state, 4 * n_state), nn.Identity(),
                                 Linear(4 * n_state, n_state))
        self.mlp_ln = TorchLayerNorm(n_state)

    def forward(self, x: torch.Tensor, cache: list | None = None, offset: int = 0,
                cross: tuple | None = None) -> torch.Tensor:
        """``cache`` (decoder): [k, v, length] of this layer's self-attention,
        extended in place by x's keys at ``offset``; ``cross``: the
        cross-attention's (k, v)."""
        h = self.attn_ln(x)
        k, v = self.attn.kv(h)
        if cache is not None:
            end = offset + k.shape[2]
            cache[0][:, :, offset:end] = k
            cache[1][:, :, offset:end] = v
            k, v = cache[0][:, :, :end], cache[1][:, :, :end]
        x = x + self.attn.attend(h, k, v, causal_from=offset if cache is not None else None)
        if cross is not None:
            x = x + self.cross_attn.attend(self.cross_attn_ln(x), *cross)
        h = self.mlp[2](gelu(self.mlp[0](self.mlp_ln(x))))
        return x + h


class AudioEncoder(nn.Module):
    def __init__(self, dims: WhisperDims):
        super().__init__()
        self.conv1 = Conv1d(dims.n_mels, dims.n_audio_state, 3, padding=1)
        self.conv2 = Conv1d(dims.n_audio_state, dims.n_audio_state, 3, stride=2, padding=1)
        self.register_buffer("positional_embedding",
                             torch.from_numpy(sinusoids(dims.n_audio_ctx, dims.n_audio_state)))
        self.blocks = nn.ModuleList(ResidualBlock(dims.n_audio_state, dims.n_audio_head)
                                    for _ in range(dims.n_audio_layer))
        self.ln_post = TorchLayerNorm(dims.n_audio_state)

    def forward(self, mel: torch.Tensor, return_layers: bool = False):
        """mel (B, frames, n_mels) -> (B, frames // 2, n_state); with
        ``return_layers`` also every block's output, (B, layers, T, D) (the
        reference's MuseTalk features)."""
        x = gelu(self.conv1(mel.transpose(1, 2)))
        x = gelu(self.conv2(x)).transpose(1, 2)
        x = x + self.positional_embedding[:x.shape[1]].to(x.dtype)
        layers = []
        for block in self.blocks:
            x = block(x)
            layers.append(x)
        x = self.ln_post(x)
        return (x, torch.stack(layers, dim=1)) if return_layers else x


class TextDecoder(nn.Module):
    def __init__(self, dims: WhisperDims):
        super().__init__()
        self.dims = dims
        self.token_embedding = nn.Embedding(dims.n_vocab, dims.n_text_state)
        self.positional_embedding = nn.Parameter(torch.zeros(dims.n_text_ctx,
                                                             dims.n_text_state))
        self.blocks = nn.ModuleList(ResidualBlock(dims.n_text_state, dims.n_text_head, cross=True)
                                    for _ in range(dims.n_text_layer))
        self.ln = TorchLayerNorm(dims.n_text_state)

    def cross_kv(self, audio: torch.Tensor) -> list:
        """Each layer's cross-attention keys and values of ``audio`` (B, S, D)."""
        return [b.cross_attn.kv(audio) for b in self.blocks]

    def new_cache(self, batch: int, length: int, device, dtype) -> list:
        """Empty self-attention caches for ``length`` positions."""
        d = self.dims
        shape = (batch, d.n_text_head, length, d.n_text_state // d.n_text_head)
        return [[torch.zeros(shape, device=device, dtype=dtype) for _ in range(2)]
                for _ in self.blocks]

    def step(self, tokens: torch.Tensor, offset: int, cache: list, cross: list) -> torch.Tensor:
        """Logits (B, T, n_vocab) of ``tokens`` (B, T) at positions offset..,
        their keys and values appended to ``cache``."""
        pos = self.positional_embedding[offset:offset + tokens.shape[1]]
        x = self.token_embedding.weight[tokens] + pos
        x = x.to(self.ln.dtype)
        for block, c, kv in zip(self.blocks, cache, cross):
            x = block(x, cache=c, offset=offset, cross=kv)
        return torch.matmul(self.ln(x).float(), self.token_embedding.weight.t())

    def forward(self, tokens: torch.Tensor, audio: torch.Tensor) -> torch.Tensor:
        """The full-context decoder: logits (B, T, n_vocab) of every position."""
        B, T = tokens.shape
        cache = self.new_cache(B, T, tokens.device, self.ln.dtype)
        return self.step(tokens, 0, cache, self.cross_kv(audio))


class Whisper(nn.Module):
    def __init__(self, dims: WhisperDims):
        super().__init__()
        self.dims = dims
        self.encoder = AudioEncoder(dims)
        self.decoder = TextDecoder(dims)

    def embed_audio(self, mel: torch.Tensor, return_layers: bool = False):
        return self.encoder(mel, return_layers=return_layers)

    def logits(self, tokens: torch.Tensor, audio_features: torch.Tensor) -> torch.Tensor:
        return self.decoder(tokens, audio_features)

    def forward(self, mel: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        return self.decoder(tokens, self.encoder(mel))


def load_whisper(path: str, device=None) -> tuple[Whisper, WhisperDims]:
    """An OpenAI whisper ``.pt`` (``dims`` and ``model_state_dict``), read
    with ``weights_only=True`` -> (the model on ``device``, in eval mode;
    its dims). ``device`` None is the card."""
    dev = resolve_device(device)
    set_float32_math()
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    dims = WhisperDims(**{k: v for k, v in ckpt["dims"].items()
                          if k in WhisperDims.__dataclass_fields__})
    model = Whisper(dims)
    sd = dict(ckpt["model_state_dict"])
    sd.setdefault("encoder.positional_embedding", model.encoder.positional_embedding)
    model.load_state_dict(sd, strict=True)
    return model.to(dev).eval(), dims


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------


def _prepared(model: Whisper, mel, dtype) -> torch.Tensor:
    """``model`` set to compute in ``dtype``; ``mel`` as a (B, frames,
    n_mels) float32 tensor on its device."""
    set_dtype_(model, dtype)
    mel = torch.as_tensor(np.asarray(mel) if not torch.is_tensor(mel) else mel)
    if mel.dim() == 2:
        mel = mel[None]
    return mel.to(next(model.parameters()).device, torch.float32)


def _with_language(model: Whisper, mel: torch.Tensor, sot_sequence: tuple, language,
                   dtype, detect: bool = True) -> tuple:
    """sot_sequence with its language slot set: a code's token, or with
    "auto" the first batch element's detected language (``detect``)."""
    if not language or len(sot_sequence) < 2 or (language == "auto" and not detect):
        return tuple(sot_sequence)
    if language == "auto":
        lang_tok = int(detect_language(model, mel, dtype=dtype)[0][0])
    else:
        lang_tok = SOT + 1 + LANGUAGE_CODES.index(language)
    return (sot_sequence[0], lang_tok, *sot_sequence[2:])


class _Decoding:
    """One audio batch's cross-attention keys and values, and the
    self-attention cache of ``rows`` token rows, filled by ``feed``."""

    def __init__(self, model: Whisper, audio: torch.Tensor, rows: int, length: int):
        self.model = model
        dec = model.decoder
        self.cross = [(k.expand(rows, -1, -1, -1), v.expand(rows, -1, -1, -1))
                      if k.shape[0] != rows else (k, v) for k, v in dec.cross_kv(audio)]
        self.cache = dec.new_cache(rows, length, audio.device, dec.ln.dtype)
        self.pos = 0

    def feed(self, tokens: torch.Tensor) -> torch.Tensor:
        """The logits (rows, vocab) after ``tokens`` (rows, T)."""
        logits = self.model.decoder.step(tokens, self.pos, self.cache, self.cross)
        self.pos += tokens.shape[1]
        return logits[:, -1]

    def reorder(self, src: torch.Tensor) -> None:
        """Each row's cache taken from row ``src[row]`` (beam search)."""
        for c in self.cache:
            c[0] = c[0][src]
            c[1] = c[1][src]


@torch.no_grad()
def detect_language(model: Whisper, mel, dtype=torch.float32) -> tuple[np.ndarray, np.ndarray]:
    """Language id from one decoder step on SOT, the logits restricted to
    the language tokens and softmaxed (the reference's decoding.
    detect_language). Returns (language token ids (B,), probabilities
    (B,)); the multilingual vocab's language tokens are 50259..50357 (or
    ..50358 for v3)."""
    dims = model.dims
    if dims.n_vocab < 51865:
        raise ValueError("English-only model has no language tokens")
    mel = _prepared(model, mel, dtype)
    audio = model.embed_audio(mel)
    tokens = torch.full((mel.shape[0], 1), SOT, device=mel.device)
    logits = model.logits(tokens, audio)[:, 0]
    n_lang = 100 if dims.n_vocab == 51866 else 99
    probs = torch.softmax(logits[:, SOT + 1:SOT + 1 + n_lang], dim=-1)
    ids = torch.argmax(probs, dim=-1)
    return (ids.cpu().numpy() + SOT + 1,
            torch.gather(probs, 1, ids[:, None])[:, 0].cpu().numpy())


@torch.no_grad()
def greedy_decode(model: Whisper, mel, sot_sequence: tuple = (50258, 50259, 50359, 50363),
                  eot: int = EOT, max_len: int = 128, dtype=torch.float32,
                  language: str | None = None) -> np.ndarray:
    """Greedy decoding; returns (B, <= max_len) token ids (without the SOT
    sequence). ``language`` "auto" puts the first batch element's detected
    language in the SOT sequence's language slot."""
    mel = _prepared(model, mel, dtype)
    sot_sequence = _with_language(model, mel, sot_sequence, language, dtype)
    audio = model.embed_audio(mel)
    B, n_sot = mel.shape[0], len(sot_sequence)
    max_len = min(max_len, model.dims.n_text_ctx - n_sot)  # never past the text context
    run = _Decoding(model, audio, B, n_sot + max_len)
    logits = run.feed(torch.tensor([sot_sequence] * B, device=mel.device))
    out = []
    done = np.zeros(B, bool)
    for _ in range(max_len):
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        nxt = np.where(done, eot, nxt)
        done |= nxt == eot
        out.append(nxt)
        if done.all() or len(out) == max_len:
            break
        logits = run.feed(torch.as_tensor(nxt, device=mel.device)[:, None])
    return np.stack(out, axis=1)


def decode_with_timestamps(model: Whisper, mel, language: str | None = None,
                           max_len: int = 224, dtype=torch.float32) -> list[list[tuple]]:
    """Segment timestamps from the model's timestamp tokens (the
    reference's HF pipeline with return_timestamps=True, custom_nodes/
    stt.py:162): greedy decoding without the notimestamps token, then
    ``<|t0|> text <|t1|>`` pairs at 0.02 s. Returns per batch element a
    list of (start_s, end_s, [token ids])."""
    n_lang = 100 if model.dims.n_vocab == 51866 else 99
    transcribe = SOT + n_lang + 2
    ts_begin = SOT + n_lang + 7
    toks = greedy_decode(model, mel, sot_sequence=(SOT, SOT + 1, transcribe), eot=EOT,
                         max_len=max_len, dtype=dtype, language=language)
    out = []
    for row in toks:
        segments, start, text = [], None, []
        for t in row.tolist():
            if t == EOT:
                break
            if t >= ts_begin:
                stamp = (t - ts_begin) * 0.02
                if start is None:
                    start = stamp
                else:
                    segments.append((start, stamp, text))
                    start, text = None, []
            elif t < EOT:
                text.append(t)
        if start is not None and text:
            segments.append((start, start + 0.02 * len(text), text))
        out.append(segments)
    return out


@torch.no_grad()
def beam_decode(model: Whisper, mel, beam_size: int = 5,
                sot_sequence: tuple = (50258, 50259, 50359, 50363), eot: int = EOT,
                max_len: int = 128, dtype=torch.float32, language: str | None = None,
                length_penalty: float | None = None) -> tuple[np.ndarray, float]:
    """Beam search for one segment (the reference's BeamSearchDecoder,
    decoding.py:281-368): the beams are the rows of one cached decoder step;
    each step the beams' top beam_size + 1 log-probabilities go to the host,
    which ranks every candidate, retires those ending in EOT and keeps the
    best beam_size others. Returns (tokens, avg_logprob) of the best finished
    hypothesis under the MaximumLikelihoodRanker (None penalty: divide by
    the length)."""
    mel = _prepared(model, mel, dtype)
    sot_sequence = _with_language(model, mel, sot_sequence, language, dtype)
    audio = model.embed_audio(mel[:1])
    n_sot = len(sot_sequence)
    max_len = min(max_len, model.dims.n_text_ctx - n_sot)
    dev = mel.device
    run = _Decoding(model, audio, beam_size, n_sot + max_len)
    logits = run.feed(torch.tensor([sot_sequence] * beam_size, device=dev))
    # beam 0 starts live; the rest at -1e30, so step 1 fans out from one root
    sum_lp = np.array([0.0] + [-1e30] * (beam_size - 1), np.float64)
    finished: list[tuple[float, np.ndarray]] = []  # first come, as the reference's
    prefixes = [np.zeros((0,), np.int32)] * beam_size
    for step in range(max_len):
        vals, idxs = torch.topk(torch.log_softmax(logits.float(), dim=-1), beam_size + 1)
        vals, idxs = vals.cpu().double().numpy(), idxs.cpu().numpy()
        scores = (sum_lp[:, None] + vals).reshape(-1)
        new_src, new_tok, new_lp, new_pref = [], [], [], []
        for flat in np.argsort(-scores):
            b, j = divmod(int(flat), beam_size + 1)
            tok = int(idxs[b, j])
            if tok == eot:
                if len(finished) < beam_size:
                    finished.append((float(scores[flat]), prefixes[b]))
            else:
                new_src.append(b)
                new_tok.append(tok)
                new_lp.append(float(scores[flat]))
                new_pref.append(np.append(prefixes[b], tok))
                if len(new_src) == beam_size:
                    break
        sum_lp = np.asarray(new_lp, np.float64)
        prefixes = new_pref
        if len(finished) >= beam_size or step == max_len - 1:
            break
        run.reorder(torch.as_tensor(new_src, device=dev))
        logits = run.feed(torch.as_tensor(new_tok, device=dev)[:, None])
    if not finished:  # out of length: rank the live beams
        finished = [(float(sum_lp[b]), prefixes[b]) for b in range(beam_size)]
    best, best_score, best_avg = None, -np.inf, -np.inf
    for slp, toks in finished:
        n = n_sot + len(toks) + 1
        score = slp / n if length_penalty is None else slp / ((5 + n) / 6) ** length_penalty
        if score > best_score:
            best, best_score, best_avg = toks, score, slp / (len(toks) + 1)
    return np.asarray(best, np.int32), float(best_avg)


def _compression_ratio(tokens: np.ndarray) -> float:
    raw = np.asarray(tokens, np.int32).tobytes()
    if not raw:
        return 0.0
    return len(raw) / len(zlib.compress(raw))


def decode_with_fallback(model: Whisper, mel, temperatures=(0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
                         beam_size: int = 5, compression_ratio_threshold: float = 2.4,
                         logprob_threshold: float = -1.0, seed: int = 0, dtype=torch.float32,
                         language: str | None = None, max_len: int = 128,
                         sot_sequence: tuple = (50258, 50259, 50359, 50363), eot: int = EOT,
                         gumbel=None):
    """The reference's transcribe.py decode_with_fallback: beam search at
    T = 0; while the result degenerates (compression ratio above the
    threshold: a repetition loop; average log-probability below it: low
    confidence) sampling at the next temperature, seeded ``seed`` + its
    index. ``gumbel`` as ``_sample_decode`` takes it. Returns (tokens,
    {"temperature", "avg_logprob", "compression_ratio"})."""
    tokens, avg_lp = None, -np.inf
    for ti, temp in enumerate(temperatures):
        if temp == 0.0:
            tokens, avg_lp = beam_decode(model, mel, beam_size=beam_size, max_len=max_len,
                                         dtype=dtype, language=language,
                                         sot_sequence=sot_sequence, eot=eot)
        else:
            tokens, avg_lp = _sample_decode(model, mel, temp, seed=seed + ti, max_len=max_len,
                                            dtype=dtype, language=language,
                                            sot_sequence=sot_sequence, eot=eot, gumbel=gumbel)
        cr = _compression_ratio(tokens)
        if (cr <= compression_ratio_threshold and avg_lp >= logprob_threshold) or \
                temp == temperatures[-1]:
            return tokens, {"temperature": temp, "avg_logprob": avg_lp, "compression_ratio": cr}
    return tokens, {"temperature": temperatures[-1], "avg_logprob": avg_lp,
                    "compression_ratio": _compression_ratio(tokens)}


@torch.no_grad()
def _sample_decode(model: Whisper, mel, temperature: float, seed: int = 0,
                   sot_sequence: tuple = (50258, 50259, 50359, 50363), eot: int = EOT,
                   max_len: int = 128, dtype=torch.float32, language: str | None = None,
                   gumbel=None) -> tuple[np.ndarray, float]:
    """Temperature sampling for one segment (the reference's GreedyDecoder
    at T > 0): each token is argmax(log p / T + g), g the step's Gumbel
    noise (vocab,) from ``gumbel(seed, step)`` when given, else from a CPU
    generator seeded with ``seed``. Returns (tokens, avg_logprob)."""
    mel = _prepared(model, mel, dtype)
    sot_sequence = _with_language(model, mel, sot_sequence, language, dtype, detect=False)
    audio = model.embed_audio(mel[:1])
    n_sot = len(sot_sequence)
    max_len = min(max_len, model.dims.n_text_ctx - n_sot)
    dev = mel.device
    if gumbel is None:
        gen = torch.Generator().manual_seed(seed)

        def gumbel(_seed, _step):
            u = torch.rand(model.dims.n_vocab, generator=gen)
            return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(u.dtype).tiny)))
    run = _Decoding(model, audio, 1, n_sot + max_len)
    logits = run.feed(torch.tensor([sot_sequence], device=dev))
    out, lps = [], []
    for step in range(max_len):
        lp = torch.log_softmax(logits[0].float(), dim=-1)
        g = torch.as_tensor(np.array(gumbel(seed, step), np.float32)).reshape(-1).to(dev)
        tok = int(torch.argmax(lp / temperature + g))
        lps.append(float(lp[tok]))
        if tok == eot:
            break
        out.append(tok)
        if step == max_len - 1:
            break
        logits = run.feed(torch.tensor([[tok]], device=dev))
    avg = float(np.mean(lps)) if lps else -np.inf
    return np.asarray(out, np.int32), avg
