"""Whisper's byte-level BPE tokenizer, with no tokenizer package.

Counterpart of ``rvc_tpu/models/whisper_bpe.py``. Whisper uses GPT-2's
byte-level BPE (the reference's lib/musetalk/whisper/whisper/tokenizer.py
builds a HF GPT2TokenizerFast from vocab.json/merges.txt); the ranks come
from the repository's converted artifacts
(``assets/whisper/<name>.tokenizer.json.gz``):

- decode: id -> token string -> bytes (GPT-2's printable-byte bijection)
  -> UTF-8; special and timestamp ids (>= eot) are dropped;
- encode: GPT-2's split pattern, then the merge loop over each piece, in
  pure Python. JAX's module takes ``tiktoken`` where it is installed; the
  port has no such branch. The split pattern needs ``\\p{L}``/``\\p{N}``,
  which Python's ``re`` lacks, so ``split_words`` scans it by hand from
  ``unicodedata``'s categories and Unicode's White_Space set (the
  ``regex`` and ``tiktoken`` engines' ``\\s``).

Layouts: multilingual (eot 50257, text ids 0..50256) and gpt2/English
(eot 50256), as ``models/whisper.py``'s id constants.
"""
from __future__ import annotations

import functools
import gzip
import json
import os
import unicodedata

# GPT-2's word-split pattern (every whisper tokenizer's), scanned by split_words
PAT_STR = (r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"""
           r""" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")
CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")  # after "'", in the pattern's order
WHITE_SPACE = frozenset("\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004\u2005"
                        "\u2006\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000")


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's bijection byte value -> printable unicode char: printable
    ASCII/latin-1 bytes map to themselves, the rest to 256+k."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


@functools.lru_cache(maxsize=1)
def _unicode_to_bytes() -> dict[str, int]:
    return {c: b for b, c in bytes_to_unicode().items()}


def _token_to_bytes(token: str) -> bytes:
    inv = _unicode_to_bytes()
    return bytes(inv[c] for c in token)


def _kind(ch: str) -> str:
    """"s" (White_Space), "L" (a letter), "N" (a number) or "o" (other)."""
    if ch in WHITE_SPACE:
        return "s"
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "o"


def split_words(text: str) -> list[str]:
    """``regex.findall(PAT_STR, text)``, scanned left to right: at each
    position the pattern's first alternative that matches, each run as
    long as it goes (``\\s+(?!\\S)`` leaves a run's last blank to a word
    that follows it)."""
    out, i, n = [], 0, len(text)
    kinds = [_kind(c) for c in text]
    while i < n:
        if text[i] == "'":
            tail = next((c for c in CONTRACTIONS if text.startswith(c, i + 1)), None)
            if tail is not None:
                out.append(text[i:i + 1 + len(tail)])
                i += 1 + len(tail)
                continue
        k = kinds[i]
        start = i
        if text[i] == " " and i + 1 < n and kinds[i + 1] != "s":
            i += 1  # " ?" before a run of letters, numbers or others
            k = kinds[i]
        if k != "s":
            while i < n and kinds[i] == k:
                i += 1
            out.append(text[start:i])
            continue
        j = i
        while j < n and kinds[j] == "s":
            j += 1
        if j < n and j - i >= 2:
            j -= 1  # \s+(?!\S): the last blank goes with what follows
        out.append(text[i:j])
        i = j
    return out


class WhisperBPE:
    """Byte-level BPE codec over a whisper vocab.

    vocab: token string -> id (specials such as ``<|endoftext|>`` are
    recognized by their form and never byte-decoded). merges: the ordered
    (a, b) pairs that ``encode`` applies."""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 multilingual: bool = True):
        self.multilingual = multilingual
        self.eot = 50257 if multilingual else 50256
        self._id_to_bytes: dict[int, bytes] = {}
        for tok, i in vocab.items():
            if tok.startswith("<|") and tok.endswith("|>"):
                continue
            self._id_to_bytes[i] = _token_to_bytes(tok)
        self._merge_ranks = {tuple(m): r for r, m in enumerate(merges)}
        self._vocab = vocab
        self._words: dict[str, list[int]] = {}

    def decode(self, ids) -> str:
        """Text from token ids; special and timestamp ids are dropped."""
        data = b"".join(self._id_to_bytes[int(i)] for i in ids if int(i) in self._id_to_bytes)
        return data.decode("utf-8", errors="replace")

    def encode(self, text: str) -> list[int]:
        out: list[int] = []
        for word in split_words(text):
            ids = self._words.get(word)
            if ids is None:
                ids = self._words[word] = self._encode_word(word)
            out.extend(ids)
        return out

    def _encode_word(self, word: str) -> list[int]:
        """The merge loop (rvc_tpu/models/whisper_bpe.py:109-128): merge the
        adjacent pair of the lowest rank until none is in the merges."""
        b2u = bytes_to_unicode()
        sym = [b2u[b] for b in word.encode("utf-8")]
        while len(sym) > 1:
            rank, i = min((self._merge_ranks.get((sym[i], sym[i + 1]), 1 << 30), i)
                          for i in range(len(sym) - 1))
            if rank >= 1 << 30:
                break
            sym[i:i + 2] = [sym[i] + sym[i + 1]]
        return [self._vocab[s] for s in sym]


def save_artifact(path: str, vocab: dict[str, int], merges: list[tuple[str, str]],
                  multilingual: bool) -> None:
    payload = {"format": "rvc_tpu.whisper_bpe.v1", "multilingual": multilingual,
               "vocab": vocab, "merges": [list(m) for m in merges]}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with gzip.open(path, "wt", encoding="utf-8") as f:
        json.dump(payload, f, ensure_ascii=False, separators=(",", ":"))


@functools.lru_cache(maxsize=8)
def load_artifact(path: str) -> WhisperBPE:
    """Cached: a node graph transcribing many clips builds the tables once."""
    with gzip.open(path, "rt", encoding="utf-8") as f:
        payload = json.load(f)
    if payload.get("format") != "rvc_tpu.whisper_bpe.v1":
        raise ValueError(f"{path} is not a whisper BPE artifact")
    return WhisperBPE(payload["vocab"], [tuple(m) for m in payload["merges"]],
                      payload["multilingual"])


@functools.lru_cache(maxsize=8)
def _load_hf_file(path: str, multilingual: bool) -> WhisperBPE:
    """A HF fast tokenizer's ``tokenizer.json``: vocab and merges under "model"."""
    with open(path, encoding="utf-8") as f:
        model = json.load(f)["model"]
    merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m) for m in model["merges"]]
    return WhisperBPE(model["vocab"], merges, multilingual)


@functools.lru_cache(maxsize=8)
def _load_hf_dir(base: str, multilingual: bool) -> WhisperBPE:
    """A HF snapshot: vocab.json and merges.txt (the reference's vendored
    whisper assets are this pair)."""
    with open(os.path.join(base, "vocab.json"), encoding="utf-8") as f:
        vocab = json.load(f)
    merges: list[tuple[str, str]] = []
    with open(os.path.join(base, "merges.txt"), encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith("#version"):
                continue
            a, _, b = line.partition(" ")
            merges.append((a, b))
    return WhisperBPE(vocab, merges, multilingual)


def _repo_assets() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "assets", "whisper")


def _try_load(base: str, name: str, multilingual: bool, explicit: bool) -> WhisperBPE | None:
    """One place to look. An explicit path may also be a HF ``tokenizer.json``
    or a snapshot directory; one that exists but does not parse returns
    None (the caller's HF fallback), never the repository's artifact."""
    if os.path.isfile(base):
        try:
            return load_artifact(base)
        except Exception:
            if not explicit:
                return None
        try:
            return _load_hf_file(base, multilingual)
        except Exception:
            return None
    if os.path.isdir(base):
        cand = os.path.join(base, f"{name}.tokenizer.json.gz")
        if os.path.isfile(cand):
            return load_artifact(cand)
        if explicit and os.path.isfile(os.path.join(base, "vocab.json")):
            try:
                return _load_hf_dir(base, multilingual)
            except Exception:
                return None
    return None


def load_tokenizer(path: str | None = None, multilingual: bool = True) -> WhisperBPE | None:
    """The tokenizer at an explicit ``path`` (this repository's artifact, a
    HF ``tokenizer.json`` or a HF snapshot directory; anything else, e.g. a
    hub id, gives None), else from $RVC_TPU_WHISPER_TOKENIZER, else the
    repository's ``assets/whisper/``."""
    name = "multilingual" if multilingual else "gpt2"
    if path:
        return _try_load(path, name, multilingual, explicit=True)
    for base in (os.environ.get("RVC_TPU_WHISPER_TOKENIZER"), _repo_assets()):
        if base:
            tok = _try_load(base, name, multilingual, explicit=False)
            if tok is not None:
                return tok
    return None
