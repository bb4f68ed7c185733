"""The port's Whisper (``rvc_tpu_torch/models/whisper.py``) and BPE tokenizer
(``models/whisper_bpe.py``) against the JAX package's, on the CPU.

The model at a tiny ``WhisperDims`` (2 + 2 layers of width 64, the full
51865-token vocabulary) with the JAX module's random weights, carried
across by state_dict name (``compat.weights.whisper_state_dict``), on the
log-mel of 8 s of the speech fixture (two clips for batched calls):

- ``log_mel_spectrogram`` within 1e-5 on noise (its STFT is an FFT here,
  a DFT product there). On speech the mel's lowest bin sums a few
  low-frequency bins of small power, where each package's float32 sum is
  ~2.4e-5 from a float64 STFT: there the port is held to that reference,
  within 1e-5 or JAX's own distance to it, whichever is larger;
- the encoder (and its per-layer outputs) and the decoder's logits within
  1e-4 of the largest magnitude;
- ``detect_language``, ``greedy_decode``, ``beam_decode``,
  ``decode_with_timestamps`` and ``decode_with_fallback`` (its sampling on
  JAX's Gumbel draws) token for token. The port decodes through a KV cache
  where JAX runs the full-context decoder, so two logits within rounding
  may swap: where the tokens part, the port's logits on JAX's tokens
  (teacher forcing) must put JAX's top two within 1e-4 there, and agree
  with JAX's argmax before it wherever the top two differ by more;
- ``load_whisper`` of an OpenAI-format ``.pt`` (``dims`` and
  ``model_state_dict``) written to ``tmp_path``, through both packages;
- BPE ``encode`` equal to JAX's (its ``tiktoken`` route) on a corpus of
  punctuation, contractions, non-Latin scripts, emoji and whitespace runs,
  ``split_words`` equal to ``regex.findall`` of the pattern, and ``decode``
  (special and timestamp ids dropped) equal to JAX's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import finit, no_compile_cache_writes, one_thread  # noqa: F401
from rvc_tpu.models import whisper as JW
from rvc_tpu.models import whisper_bpe as JB
from rvc_tpu_torch.compat.weights import whisper_state_dict
from rvc_tpu_torch.models import whisper as TW
from rvc_tpu_torch.models import whisper_bpe as TB
from test_torch_convert import speech

pytestmark = pytest.mark.usefixtures("one_thread")

DIMS = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=2, n_audio_layer=2,
            n_vocab=51865, n_text_ctx=448, n_text_state=64, n_text_head=2, n_text_layer=2)
MARGIN = 1e-4  # top-two logit gap under which the two packages may pick either
MAX_LEN = 12


def port_model(params, dims: dict) -> TW.Whisper:
    model = TW.Whisper(TW.WhisperDims(**dims))
    sd = {k: torch.from_numpy(np.array(v)) for k, v in whisper_state_dict(params).items()}
    sd["encoder.positional_embedding"] = model.encoder.positional_embedding
    model.load_state_dict(sd, strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def tiny():
    """JAX's params, the port's model on them, and the log-mel of two 8 s
    clips of the speech fixture (JAX's, the common input)."""
    dims = JW.WhisperDims(**DIMS)
    jm = JW.Whisper(dims)
    params = finit(lambda mel, tok: jm.init(jax.random.PRNGKey(0), mel, tok),
                   jnp.zeros((1, 100, 80)), jnp.zeros((1, 4), jnp.int32), seed=3)
    audio = np.stack([speech(8.0, 2.0), speech(8.0, 20.0)])
    mel = np.asarray(JW.log_mel_spectrogram(jnp.asarray(audio)))
    return {"dims": dims, "params": params, "model": port_model(params, DIMS),
            "audio": audio, "mel": mel}


def forced_agreement(model, mel, sot: tuple, jax_tokens, port_tokens) -> int:
    """The teacher-forcing rule on one row: returns the number of leading
    tokens the two decodes share, after checking the port's logits on
    JAX's tokens (see the module's docstring)."""
    jax_tokens, port_tokens = list(map(int, jax_tokens)), list(map(int, port_tokens))
    seq = torch.tensor([list(sot) + jax_tokens])
    with torch.no_grad():
        logits = model.logits(seq, model.embed_audio(torch.as_tensor(mel)[None]))[0]
    logits = logits[len(sot) - 1:len(sot) - 1 + len(jax_tokens)]
    top2 = torch.topk(logits, 2).values
    close = (top2[:, 0] - top2[:, 1] <= MARGIN).numpy()
    argmax = torch.argmax(logits, dim=-1).numpy()
    n = next((i for i, (a, b) in enumerate(zip(jax_tokens, port_tokens)) if a != b),
             min(len(jax_tokens), len(port_tokens)))
    for i in range(n):
        assert close[i] or argmax[i] == jax_tokens[i], (i, argmax[i], jax_tokens[i])
    if n < max(len(jax_tokens), len(port_tokens)):
        assert n < len(jax_tokens) and close[n], ("tokens part at", n, jax_tokens, port_tokens)
    return n


def test_sizes_and_language_codes_are_jax_s():
    assert {k: dataclasses.asdict(v) for k, v in TW.WHISPER_SIZES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JW.WHISPER_SIZES.items()}
    assert TW.LANGUAGE_CODES == JW.LANGUAGE_CODES


def _log_mel_f64(audio: np.ndarray) -> np.ndarray:
    """Whisper's log-mel through a float64 STFT and filterbank."""
    from rvc_tpu_torch.ops.mel import mel_filterbank_slaney_np

    x = torch.from_numpy(audio).double()
    spec = torch.stft(x, 400, 160, window=torch.hann_window(400, dtype=torch.float64),
                      center=True, pad_mode="reflect", return_complex=True)
    power = (spec.abs() ** 2)[..., :-1].transpose(1, 2)
    fb = torch.from_numpy(mel_filterbank_slaney_np(16000, 400, 80, 0.0, None)).double()
    ls = torch.log10(torch.clamp(power @ fb, min=1e-10))
    ls = torch.maximum(ls, ls.amax(dim=(1, 2), keepdim=True) - 8.0)
    return ((ls + 4.0) / 4.0).numpy()


def test_log_mel_matches_jax(tiny):
    noise = (0.1 * np.random.default_rng(0).standard_normal((1, 16000 * 8))).astype(np.float32)
    ref = np.asarray(JW.log_mel_spectrogram(jnp.asarray(noise)))
    got = TW.log_mel_spectrogram(torch.from_numpy(noise)).numpy()
    assert np.abs(got - ref).max() <= 1e-5
    got = TW.log_mel_spectrogram(torch.from_numpy(tiny["audio"])).numpy()
    assert got.shape == tiny["mel"].shape == (2, 800, 80)
    exact = _log_mel_f64(tiny["audio"])
    assert np.abs(got - exact).max() <= max(1e-5, np.abs(tiny["mel"] - exact).max())


def test_encoder_and_decoder_logits_match_jax(tiny):
    jm = JW.Whisper(tiny["dims"])
    mel = tiny["mel"]
    ja, jl = jm.apply(tiny["params"], jnp.asarray(mel), True, method=JW.Whisper.embed_audio)
    tokens = np.array([[50258, 50259, 50359, 50363, 440, 2068, 50257]] * 2)
    jlog = np.asarray(jm.apply(tiny["params"], jnp.asarray(tokens), ja, method=JW.Whisper.logits))
    with torch.no_grad():
        ta, tl = tiny["model"].embed_audio(torch.from_numpy(mel), return_layers=True)
        tlog = tiny["model"].logits(torch.from_numpy(tokens), ta).numpy()
    for got, ref in ((ta.numpy(), ja), (tl.numpy(), jl), (tlog, jlog)):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_detect_language_matches_jax(tiny):
    jid, jp = JW.detect_language(tiny["params"], tiny["dims"], jnp.asarray(tiny["mel"]))
    tid, tp = TW.detect_language(tiny["model"], tiny["mel"])
    np.testing.assert_array_equal(tid, jid)
    np.testing.assert_allclose(tp, jp, rtol=1e-5)


def test_greedy_decode_matches_jax(tiny):
    """Both clips in one batch in Spanish; the port's "auto" takes the first
    clip's detected language (``detect_language``, held to JAX's above)."""
    sot = (50258, 50262, 50359, 50363)
    jt = JW.greedy_decode(tiny["params"], tiny["dims"], jnp.asarray(tiny["mel"]),
                          max_len=MAX_LEN, language="es")
    tt = TW.greedy_decode(tiny["model"], tiny["mel"], max_len=MAX_LEN, language="es")
    assert tt.shape == jt.shape == (2, MAX_LEN)
    for b in range(2):
        assert forced_agreement(tiny["model"], tiny["mel"][b], sot, jt[b], tt[b]) == MAX_LEN
    lang = int(TW.detect_language(tiny["model"], tiny["mel"])[0][0])
    code = TW.LANGUAGE_CODES[lang - 50259]
    np.testing.assert_array_equal(
        TW.greedy_decode(tiny["model"], tiny["mel"], max_len=4, language="auto"),
        TW.greedy_decode(tiny["model"], tiny["mel"], max_len=4, language=code))


def test_beam_decode_matches_jax(tiny):
    jt, jlp = JW.beam_decode(tiny["params"], tiny["dims"], jnp.asarray(tiny["mel"][:1]),
                             max_len=MAX_LEN, language="en")
    tt, tlp = TW.beam_decode(tiny["model"], tiny["mel"][:1], max_len=MAX_LEN, language="en")
    np.testing.assert_array_equal(tt, jt)
    assert abs(tlp - jlp) <= 1e-4 * abs(jlp)


def test_decode_with_timestamps_matches_jax(tiny, monkeypatch):
    """The decode itself (without the notimestamps token), then the parsing
    of token rows that hold timestamp pairs, an unterminated segment and
    EOT, through both packages' ``greedy_decode`` replaced by the rows."""
    jsegs = JW.decode_with_timestamps(tiny["params"], tiny["dims"], jnp.asarray(tiny["mel"]),
                                      max_len=MAX_LEN)
    tsegs = TW.decode_with_timestamps(tiny["model"], tiny["mel"], max_len=MAX_LEN)
    assert tsegs == jsegs and len(tsegs) == 2
    ts = 50364  # the first timestamp token of the 51865 vocabulary
    rows = np.array([[ts, 101, 102, ts + 50, ts + 50, 103, ts + 100, 50257, 7, 8],
                     [ts + 10, 104, 105, 50257, 50257, 50257, 50257, 50257, 50257, 50257]])
    monkeypatch.setattr(JW, "greedy_decode", lambda *a, **k: rows)
    monkeypatch.setattr(TW, "greedy_decode", lambda *a, **k: rows)
    ref = JW.decode_with_timestamps(tiny["params"], tiny["dims"], jnp.asarray(tiny["mel"]))
    assert TW.decode_with_timestamps(tiny["model"], tiny["mel"]) == ref
    assert ref[0] == [(0.0, 1.0, [101, 102]), (1.0, 2.0, [103])] and ref[1][0][2] == [104, 105]


def jax_gumbel(vocab: int):
    """The Gumbel noise ``jax.random.categorical`` adds at each step of
    JAX's ``_sample_decode`` (its key, split once a step), by (seed, step)."""
    keys = {}

    def noise(seed: int, step: int) -> np.ndarray:
        if seed not in keys:
            key, subs = jax.random.PRNGKey(seed), []
            for _ in range(MAX_LEN):
                key, sub = jax.random.split(key)
                subs.append(sub)
            keys[seed] = subs
        return np.asarray(jax.random.gumbel(keys[seed][step], (1, vocab), jnp.float32))

    return noise


def test_decode_with_fallback_matches_jax_on_its_draws(tiny):
    """Random weights are never confident, so the ladder samples at every
    temperature after the beam search; the port samples on JAX's draws."""
    temps = (0.0, 0.6)
    jt, jinfo = JW.decode_with_fallback(tiny["params"], tiny["dims"],
                                        jnp.asarray(tiny["mel"][:1]), temperatures=temps,
                                        seed=3, max_len=MAX_LEN)
    tt, tinfo = TW.decode_with_fallback(tiny["model"], tiny["mel"][:1], temperatures=temps,
                                        seed=3, max_len=MAX_LEN, gumbel=jax_gumbel(51865))
    assert jinfo["temperature"] == 0.6
    np.testing.assert_array_equal(tt, jt)
    assert tinfo["temperature"] == jinfo["temperature"]
    assert tinfo["compression_ratio"] == jinfo["compression_ratio"]
    assert abs(tinfo["avg_logprob"] - jinfo["avg_logprob"]) <= 1e-4 * abs(jinfo["avg_logprob"])
    # the port's own draws: a seeded CPU generator, the same tokens each call
    a = TW._sample_decode(tiny["model"], tiny["mel"][:1], 1.0, seed=5, max_len=4)
    b = TW._sample_decode(tiny["model"], tiny["mel"][:1], 1.0, seed=5, max_len=4)
    np.testing.assert_array_equal(a[0], b[0])


def test_load_whisper_openai_pt(tiny, tmp_path):
    """An OpenAI-format ``.pt`` (with the encoder's positions, as official
    files carry them, and without) loads into the port, on the CPU when
    asked and on the card by default (which raises here), and into JAX's
    ``load_whisper`` to the same logits."""
    model = tiny["model"]
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    path = tmp_path / "tiny.pt"
    torch.save({"dims": dataclasses.asdict(tiny["dims"]), "model_state_dict": sd}, path)
    loaded, dims = TW.load_whisper(str(path), device="cpu")
    assert dims == TW.WhisperDims(**DIMS)
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, sd[k]), k
    del sd["encoder.positional_embedding"]
    torch.save({"dims": dataclasses.asdict(tiny["dims"]), "model_state_dict": sd},
               tmp_path / "bare.pt")
    bare, _ = TW.load_whisper(str(tmp_path / "bare.pt"), device="cpu")
    assert torch.equal(bare.encoder.positional_embedding, model.encoder.positional_embedding)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TW.load_whisper(str(path))
    jparams, jdims = JW.load_whisper(str(tmp_path / "bare.pt"))
    assert jdims == tiny["dims"]
    tokens = jnp.asarray([[50258, 50259, 50359, 50363]])
    jm = JW.Whisper(jdims)
    ref = np.asarray(jm.apply(jparams, jnp.asarray(tiny["mel"][:1]), tokens))
    with torch.no_grad():
        got = loaded(torch.from_numpy(tiny["mel"][:1]), torch.as_tensor(np.asarray(tokens)))
    assert np.abs(got.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


CORPUS = [
    "Hello, world! How are you today?", "it's a café — naïve 数据 test",
    "  leading spaces and\nnewlines\t", "don't stop—believin' (1981)",
    "¿Dónde está la biblioteca? 東京タワー", "x  \n\n  y\t\t z   ",
    "emoji 😀👍🏽 and ½ ² Ⅻ ٣", "Привет, мир! Καλημέρα κόσμε. مرحبا بالعالم. नमस्ते दुनिया",
    "tabs\tand nbsp　ideographic", "'s 're 've 'll 'd 'm 't 'x '' ''s", "a\x1cb\x1fc",
    "trailing   ", "   ", "", "12,345.67 $% ^&*()_+-=[]{}|;:\",./<>?`~",
    "unbelievable tokenization edge-cases 12345",
]


@pytest.mark.parametrize("multilingual", [True, False])
def test_bpe_matches_jax(multilingual):
    import regex

    jtok = JB.load_tokenizer(multilingual=multilingual)
    ttok = TB.load_tokenizer(multilingual=multilingual)
    assert ttok.eot == jtok.eot == (50257 if multilingual else 50256)
    assert TB.bytes_to_unicode() == JB.bytes_to_unicode()
    for text in CORPUS:
        assert TB.split_words(text) == regex.findall(JB.PAT_STR, text), text
        ids = ttok.encode(text)
        assert ids == jtok.encode(text), text
        assert ttok.decode(ids) == jtok.decode(ids) == text
    ids = ttok.encode(" speech")
    specials = [ttok.eot + 1, ttok.eot + 2, *ids, 50364, 51000, ttok.eot]
    assert ttok.decode(specials) == jtok.decode(specials) == " speech"
