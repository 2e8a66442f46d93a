"""CLIP tokenizer, self-contained.

The reference loads `CLIPTokenizer` from the SD checkpoint's `tokenizer/`
subfolder via transformers (reference: examples/brushnet/train_brushnet_mirror.py:937).
This is a dependency-free reimplementation of the same byte-level BPE
(vocab.json + merges.txt, lowercase, whitespace-collapsed, `</w>` word
suffix, BOS/EOS + EOS padding to 77) so the framework works in hermetic
environments; if transformers' tokenizer is importable and a checkpoint
folder is given, it produces identical ids.

`HashTokenizer` is the tiny-config stand-in for tests (deterministic ids,
no vocab files), mirroring the reference test-suite's tiny-model pattern.
"""

from __future__ import annotations

import functools
import html
import json
import os
import re
import zlib
from typing import Dict, List, Sequence, Tuple

import numpy as np


@functools.lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2 byte<->unicode table (standard byte-level BPE)."""
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
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


try:
    import regex as _regex  # the engine CLIP's original pattern needs (\p{L})

    _PAT = _regex.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _regex.IGNORECASE,
    )
except ImportError:  # pragma: no cover — ASCII approximation
    _PAT = re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
        re.IGNORECASE,
    )


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class CLIPTokenizer:
    """Byte-level BPE with `</w>` end-of-word markers (openai/CLIP scheme)."""

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]],
                 model_max_length: int = 77):
        self.encoder = vocab
        self.decoder = {v: k for k, v in vocab.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.model_max_length = model_max_length
        self.bos_token_id = vocab.get("<|startoftext|>", 49406)
        self.eos_token_id = vocab.get("<|endoftext|>", 49407)
        self.cache: Dict[str, str] = {}

    @classmethod
    def from_pretrained(cls, path: str, subfolder: str | None = None) -> "CLIPTokenizer":
        root = os.path.join(path, subfolder) if subfolder else path
        with open(os.path.join(root, "vocab.json")) as f:
            vocab = json.load(f)
        merges_path = os.path.join(root, "merges.txt")
        with open(merges_path, encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(l.split()) for l in lines if l and not l.startswith("#version")]
        merges = [m for m in merges if len(m) == 2]
        return cls(vocab, merges)

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
        ids: List[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for token in _PAT.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def __call__(self, texts: Sequence[str] | str) -> np.ndarray:
        """-> (B, model_max_length) int32, BOS + ids + EOS, EOS-padded,
        truncated to max length (transformers CLIPTokenizer padding='max_length')."""
        if isinstance(texts, str):
            texts = [texts]
        n = self.model_max_length
        out = np.full((len(texts), n), self.eos_token_id, dtype=np.int32)
        for i, t in enumerate(texts):
            ids = [self.bos_token_id] + self.encode(t)[: n - 2] + [self.eos_token_id]
            out[i, : len(ids)] = ids
        return out


def write_byte_vocab(tok_dir: str) -> None:
    """A valid byte-level CLIP `tokenizer/` folder with no merges: every word
    splits into byte tokens and their `</w>` variants (ids < 514), for
    checkpoints made from a seed."""
    os.makedirs(tok_dir, exist_ok=True)
    chars = list(_bytes_to_unicode().values())
    tokens = chars + [c + "</w>" for c in chars] + ["<|startoftext|>", "<|endoftext|>"]
    with open(os.path.join(tok_dir, "vocab.json"), "w") as f:
        json.dump({t: i for i, t in enumerate(tokens)}, f)
    with open(os.path.join(tok_dir, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")


class HashTokenizer:
    """Deterministic stand-in for tiny-config tests: stable ids in [0, vocab)."""

    def __init__(self, vocab_size: int = 1000, model_max_length: int = 77):
        self.vocab_size = vocab_size
        self.model_max_length = model_max_length

    def __call__(self, texts: Sequence[str] | str) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), self.model_max_length), dtype=np.int32)
        for i, t in enumerate(texts):
            words = t.lower().split()[: self.model_max_length - 2]
            ids = [1] + [
                2 + (zlib.crc32(w.encode()) % (self.vocab_size - 3)) for w in words
            ] + [self.vocab_size - 1]
            out[i, : len(ids)] = ids
        return out


class T5HashTokenizer:
    """Deterministic stand-in for T5's SentencePiece tokenizer (which the
    port does not read): the crc32 of each lower-cased word into
    [2, vocab), EOS 1 after the last, padding 0 to `model_max_length`
    (FLUX.1 pads every prompt to 512)."""

    def __init__(self, vocab_size: int = 32128, model_max_length: int = 512):
        self.vocab_size = vocab_size
        self.model_max_length = model_max_length

    def __call__(self, texts: Sequence[str] | str) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), self.model_max_length), dtype=np.int32)
        for i, t in enumerate(texts):
            words = t.lower().split()[: self.model_max_length - 1]
            ids = [2 + (zlib.crc32(w.encode()) % (self.vocab_size - 2)) for w in words] + [1]
            out[i, : len(ids)] = ids
        return out
