"""CLIP BPE tokenizer, numpy only — the port's own copy of
diffmining_tpu/models/tokenizer.py (the port imports nothing of that package).

Replacement for transformers' CLIPTokenizer used throughout the reference
(reference: diffmining/typicality/compute.py:36-37 — max_length padding to 77,
truncation). Loads `vocab.json` + `merges.txt` in the standard HF format; a
deterministic synthetic vocabulary (`tiny_tokenizer`) stands in when a
pipeline dir ships no vocabulary (tests, random-weight runs).

Tokenization pipeline (faithful to openai/CLIP):
  1. whitespace cleanup + lowercase
  2. regex split (contractions / letters / numbers / other)
  3. byte-level encode via the bytes→unicode table
  4. BPE merge loop with an end-of-word "</w>" marker
  5. bos + ids + eos, truncated/padded to model_max_length with the pad token
     (CLIP pads with eos).
"""
from __future__ import annotations

import functools
import gzip
import html
import json
import os
import re
from typing import Dict, List, Sequence, Tuple

import numpy as np


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""
    if False
    else r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
    re.IGNORECASE,
)


def get_pairs(word: Tuple[str, ...]):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


class CLIPTokenizer:
    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]], model_max_length: int = 77):
        self.encoder = vocab
        self.decoder = {v: k for k, v in vocab.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.model_max_length = model_max_length
        self.bos_token_id = vocab.get("<|startoftext|>", len(vocab) - 2)
        self.eos_token_id = vocab.get("<|endoftext|>", len(vocab) - 1)
        self.pad_token_id = self.eos_token_id
        self.cache: Dict[str, str] = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }

    @classmethod
    def from_files(cls, vocab_file: str, merges_file: str, model_max_length: int = 77) -> "CLIPTokenizer":
        with open(vocab_file, "r", encoding="utf-8") as f:
            vocab = json.load(f)
        opener = gzip.open if merges_file.endswith(".gz") else open
        with opener(merges_file, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = []
        for line in lines:
            line = line.strip()
            if not line or line.startswith("#version"):
                continue
            a, b = line.split()
            merges.append((a, b))
        return cls(vocab, merges, model_max_length)

    @classmethod
    def from_pretrained_dir(cls, path: str, model_max_length: int = 77) -> "CLIPTokenizer":
        if os.path.isfile(os.path.join(path, "vocab.json")):
            return cls.from_files(
                os.path.join(path, "vocab.json"), os.path.join(path, "merges.txt"), model_max_length
            )
        # some checkpoints ship only the single-file HF tokenizer.json
        tj = os.path.join(path, "tokenizer.json")
        if os.path.isfile(tj):
            with open(tj, "r", encoding="utf-8") as f:
                data = json.load(f)
            model = data["model"]
            merges = [tuple(m.split(" ") if isinstance(m, str) else m) for m in model["merges"]]
            return cls(model["vocab"], merges, model_max_length)
        raise FileNotFoundError(f"no vocab.json or tokenizer.json under {path}")

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
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
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode_text(self, text: str) -> List[int]:
        ids: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in re.findall(_PAT, text):
            token_bytes = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            for bpe_token in self.bpe(token_bytes).split(" "):
                ids.append(self.encoder.get(bpe_token, self.eos_token_id))
        return ids

    def __call__(self, prompts: Sequence[str] | str, max_length: int | None = None) -> np.ndarray:
        """Tokenize with bos/eos, truncation, and pad-to-max — the exact
        settings the reference uses (padding="max_length", truncation=True)."""
        if isinstance(prompts, str):
            prompts = [prompts]
        max_length = max_length or self.model_max_length
        out = np.full((len(prompts), max_length), self.pad_token_id, dtype=np.int32)
        for i, p in enumerate(prompts):
            ids = [self.bos_token_id] + self.encode_text(p)[: max_length - 2] + [self.eos_token_id]
            out[i, : len(ids)] = ids
        return out

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        raw = bytearray(self.byte_decoder.get(ch, ord(" ")) for ch in text.replace("</w>", " "))
        return raw.decode("utf-8", errors="replace").strip()


def tiny_tokenizer(vocab_size: int = 1000, model_max_length: int = 77) -> CLIPTokenizer:
    """Deterministic synthetic tokenizer for tests: single-byte tokens plus
    their `</w>` forms, no merges — every word tokenizes to its bytes."""
    byte_vocab = list(bytes_to_unicode().values())
    vocab: Dict[str, int] = {}
    for ch in byte_vocab:
        vocab[ch] = len(vocab)
    for ch in byte_vocab:
        vocab[ch + "</w>"] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    assert len(vocab) <= vocab_size, (len(vocab), vocab_size)
    return CLIPTokenizer(vocab, merges=[], model_max_length=model_max_length)
