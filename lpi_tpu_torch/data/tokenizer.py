"""CLIP BPE tokenizer on the host, feeding static [B, 77] token ids (host
copy of `lpi_tpu/data/tokenizer.py`).

OpenAI CLIP's lower-cased byte-level BPE. The merges file
(`bpe_simple_vocab_16e6.txt.gz`) is public OpenAI data, not shipped here;
it is read from an explicit path or the `LPI_TPU_CLIP_BPE` environment
variable. Without it a byte-level vocabulary with no merges is built, so
that the pipeline still runs: token ids then live in a 515-symbol space,
fine for tests and synthetic training but not for real CLIP checkpoints.
Unlike the JAX package, no merges file is looked up under the user's home
directory, and the pre-tokenizer is a scan over `unicodedata` categories in
place of the `regex` package's `\\p{L}` / `\\p{N}` classes (the same
pieces).
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
import unicodedata
from typing import Iterable, List, Sequence

import numpy as np

SOT_TOKEN = "<|startoftext|>"
EOT_TOKEN = "<|endoftext|>"
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


@functools.lru_cache()
def bytes_to_unicode():
    """Reversible byte -> printable-unicode map (GPT-2/CLIP standard)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def _get_pairs(word: Sequence[str]):
    return {(a, b) for a, b in zip(word[:-1], word[1:])}


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch).startswith("L")


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch).startswith("N")


def split_pieces(text: str) -> List[str]:
    """CLIP's pre-tokenizer: the matches, left to right, of
    `<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|
    [^\\s\\p{L}\\p{N}]+` (case-insensitive), first alternative first."""
    pieces = []
    i, n = 0, len(text)
    while i < n:
        special = next((t for t in (SOT_TOKEN, EOT_TOKEN, *_CONTRACTIONS)
                        if text[i:i + len(t)].lower() == t), None)
        ch = text[i]
        if special is not None:
            j = i + len(special)
        elif _is_letter(ch):
            j = i + 1
            while j < n and _is_letter(text[j]):
                j += 1
        elif _is_number(ch):
            j = i + 1
        elif not ch.isspace():
            j = i + 1
            while j < n and not (text[j].isspace() or _is_letter(text[j])
                                 or _is_number(text[j])):
                j += 1
        else:
            i += 1
            continue
        pieces.append(text[i:j])
        i = j
    return pieces


class ClipTokenizer:
    """Byte-level BPE with CLIP's merge table and special tokens."""

    def __init__(self, bpe_path: str | None = None, context_length: int = 77):
        self.context_length = context_length
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        merges: List[tuple] = []
        path = bpe_path or os.environ.get("LPI_TPU_CLIP_BPE")
        if path is not None and os.path.exists(path):
            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
            # standard file: header line, then 48894 merge lines
            for line in lines[1 : 49152 - 256 - 2 + 1]:
                parts = line.split()
                if len(parts) == 2:
                    merges.append(tuple(parts))

        chars = list(bytes_to_unicode().values())
        vocab = chars + [c + "</w>" for c in chars]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend([SOT_TOKEN, EOT_TOKEN])

        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {SOT_TOKEN: SOT_TOKEN, EOT_TOKEN: EOT_TOKEN}
        self.sot = self.encoder[SOT_TOKEN]
        self.eot = self.encoder[EOT_TOKEN]
        self.vocab_size = len(vocab)

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        tokens: List[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for piece in split_pieces(text):
            piece = "".join(self.byte_encoder[b] for b in piece.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self._bpe(piece).split(" "))
        return tokens

    def decode(self, tokens: Iterable[int]) -> str:
        text = "".join(self.decoder.get(int(t), "") for t in tokens)
        raw = bytearray(self.byte_decoder.get(ch, 0) for ch in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def __call__(self, texts: str | Sequence[str], truncate: bool = True) -> np.ndarray:
        """Tokenize to a padded [B, context_length] int32 array (`clip.tokenize`)."""
        if isinstance(texts, str):
            texts = [texts]
        result = np.zeros((len(texts), self.context_length), np.int32)
        for i, text in enumerate(texts):
            toks = [self.sot] + self.encode(text) + [self.eot]
            if len(toks) > self.context_length:
                if not truncate:
                    raise ValueError(f"text too long ({len(toks)} tokens): {text[:40]}…")
                toks = toks[: self.context_length]
                toks[-1] = self.eot
            result[i, : len(toks)] = toks
        return result

    def tokenize_with_prefix(self, texts: Sequence[str], n_ctx: int = 16) -> np.ndarray:
        """Tokenize `"X " * n_ctx + caption + "."`: the CoOp placeholder
        format whose slots 1..n_ctx+1 the model splices with the textual
        prompt's first layer on the device."""
        prefix = " ".join(["X"] * n_ctx)
        return self([f"{prefix} {t}." for t in texts])


def pre_caption(caption: str, max_words: int = 30) -> str:
    """Caption normalisation: strip punctuation-like characters, collapse
    whitespace, cap the word count."""
    caption = re.sub(r"([.!\"()*#:;~])", " ", caption.lower())
    caption = re.sub(r"\s{2,}", " ", caption)
    caption = caption.rstrip("\n").strip(" ")
    words = caption.split(" ")
    if len(words) > max_words:
        caption = " ".join(words[:max_words])
    return caption
