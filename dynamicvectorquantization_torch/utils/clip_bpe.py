"""CLIP's byte-level BPE tokenizer (counterpart of
`dynamicvectorquantization_tpu/utils/clip_bpe.py`, the same code: pure Python
and numpy, so no kernel).

Re-implements the tokenizer the reference vendors at
`modules/text_encoders/clip_text_encoder/clip/simple_tokenizer.py` and the
batching wrapper at `clip/clip.py:164-215` / `my_tokenizer/my_tokenize.py`.
The merge table (`bpe_simple_vocab_16e6.txt.gz`) is an external data file the
reference downloads with CLIP; point ``DQVQ_CLIP_BPE`` (or ``bpe_path``) at
it. Without a merge file the tokenizer falls back to pure byte-level
encoding (every word becomes its byte symbols + ``</w>``) — deterministic
and reversible, for pipeline tests. Words are split by CLIP's pattern
through the `regex` module where it is installed (its Unicode letter and
number classes), else through `re` with ASCII classes, as the JAX package
does: the two packages split alike on one machine.

Vocabulary layout (identical to CLIP): 256 byte symbols, 256 byte+``</w>``
symbols, one entry per merge, then ``<|startoftext|>`` / ``<|endoftext|>``.
"""
from __future__ import annotations

import gzip
import html
import os
import unicodedata
from typing import Dict, List, Optional, Tuple

import numpy as np

SOT = "<|startoftext|>"
EOT = "<|endoftext|>"


def byte_unicode_table() -> Dict[int, str]:
    """Reversible byte -> printable-unicode map (GPT-2 convention): printable
    latin bytes map to themselves, the rest shift into U+0100.."""
    keep = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    table = {}
    bump = 0
    for b in range(256):
        if b in keep:
            table[b] = chr(b)
        else:
            table[b] = chr(256 + bump)
            bump += 1
    return table


def _clean(text: str) -> str:
    # basic_clean (sans ftfy, unavailable here): NFC-normalize + unescape
    text = unicodedata.normalize("NFC", str(text))
    text = html.unescape(html.unescape(text))
    return " ".join(text.split()).strip()


def _word_pattern():
    """CLIP's word-split regex; prefers the `regex` module for \\p classes,
    falls back to an `re` approximation (imported here, not at module load)."""
    try:
        import regex

        return regex.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
            r"""|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
            regex.IGNORECASE,
        )
    except ImportError:
        import re

        return re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
            r"""|[A-Za-z]+|[0-9]|[^\sA-Za-z0-9]+""",
            re.IGNORECASE,
        )


class ClipBPETokenizer:
    """Byte-level BPE with CLIP's end-of-word convention.

    Registry target `modules.clip_text_encoder.clip.simple_tokenizer
    .SimpleTokenizer` resolves here (reference my_tokenize.py:17-22 default).
    """

    def __init__(self, end_idx: int = 49152, bpe_path: Optional[str] = None):
        self.byte_to_sym = byte_unicode_table()
        self.sym_to_byte = {v: k for k, v in self.byte_to_sym.items()}
        bpe_path = bpe_path or os.environ.get("DQVQ_CLIP_BPE")

        merges: List[Tuple[str, str]] = []
        if bpe_path and os.path.exists(bpe_path):
            opener = gzip.open if bpe_path.endswith(".gz") else open
            with opener(bpe_path, "rb") as f:
                lines = f.read().decode("utf-8").split("\n")
            # first line is a version header; CLIP keeps end_idx-256-2 merges
            for line in lines[1 : end_idx - 256 - 2 + 1]:
                parts = tuple(line.split())
                if len(parts) == 2:
                    merges.append(parts)  # type: ignore[arg-type]

        base = list(self.byte_to_sym.values())
        vocab = base + [s + "</w>" for s in base]
        vocab += ["".join(m) for m in merges]
        vocab += [SOT, EOT]
        self.encoder: Dict[str, int] = {s: i for i, s in enumerate(vocab)}
        self.decoder = {i: s for s, i in self.encoder.items()}
        self.rank: Dict[Tuple[str, str], int] = {m: r for r, m in enumerate(merges)}
        self._pat = _word_pattern()
        self._cache: Dict[str, List[str]] = {SOT: [SOT], EOT: [EOT]}

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    @property
    def sot_token(self) -> int:
        return self.encoder[SOT]

    @property
    def eot_token(self) -> int:
        return self.encoder[EOT]

    def _merge_word(self, word: str) -> List[str]:
        if word in self._cache:
            return self._cache[word]
        symbols = list(word[:-1]) + [word[-1] + "</w>"]
        while len(symbols) > 1:
            # find the lowest-rank adjacent pair
            best_rank, best_i = None, -1
            for i in range(len(symbols) - 1):
                r = self.rank.get((symbols[i], symbols[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            merged = symbols[best_i] + symbols[best_i + 1]
            # merge EVERY occurrence of that pair left-to-right (BPE step)
            out: List[str] = []
            i = 0
            while i < len(symbols):
                if (
                    i < len(symbols) - 1
                    and symbols[i] + symbols[i + 1] == merged
                    and self.rank.get((symbols[i], symbols[i + 1])) == best_rank
                ):
                    out.append(merged)
                    i += 2
                else:
                    out.append(symbols[i])
                    i += 1
            symbols = out
        self._cache[word] = symbols
        return symbols

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for chunk in self._pat.findall(_clean(text).lower()):
            word = "".join(self.byte_to_sym[b] for b in chunk.encode("utf-8"))
            ids.extend(self.encoder[s] for s in self._merge_word(word))
        return ids

    def decode(self, ids) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        text = text.replace(SOT, "").replace(EOT, "")
        raw = bytearray(self.sym_to_byte[c] for c in text)
        return (
            raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()
        )


def tokenize(
    texts,
    context_length: int = 77,
    add_start_and_end: bool = True,
    with_mask: bool = True,
    pad_value: int = 0,
    tokenizer: Optional[ClipBPETokenizer] = None,
    just_token: bool = False,
):
    """Batch tokenizer (reference clip.py:164-215): pad/truncate to
    context_length, keeping the final token (eot) on truncation."""
    if isinstance(texts, str):
        texts = [texts]
    tokenizer = tokenizer or ClipBPETokenizer()
    sot = [tokenizer.sot_token] if add_start_and_end else []
    eot = [tokenizer.eot_token] if add_start_and_end else []
    all_tokens = [sot + tokenizer.encode(t) + eot for t in texts]
    if just_token:
        return all_tokens

    result = np.full((len(all_tokens), context_length), pad_value, np.int64)
    mask = np.zeros((len(all_tokens), context_length), bool)
    for i, tokens in enumerate(all_tokens):
        if len(tokens) > context_length:
            last = tokens[-1]
            tokens = tokens[:context_length]
            tokens[-1] = last
        result[i, : len(tokens)] = tokens
        mask[i, : len(tokens)] = True
    out = {"token": result}
    if with_mask:
        out["mask"] = mask
    return out


class Tokenize:
    """Reference `my_tokenizer/my_tokenize.py:8` wrapper: tokenize + optional
    CLIP embedding of the tokens."""

    def __init__(
        self,
        context_length: int = 77,
        add_start_and_end: bool = True,
        just_token: bool = False,
        with_mask: bool = True,
        pad_value: int = 0,
        clip_embedding: bool = False,
        condition_emb_config=None,
        tokenizer_config=None,
    ):
        self.context_length = context_length
        self.add_start_and_end = add_start_and_end
        self.with_mask = with_mask
        self.pad_value = pad_value
        self.just_token = just_token
        self.clip_embedding = clip_embedding
        if tokenizer_config is None:
            self.tokenizer = ClipBPETokenizer()
        else:
            from .instantiate import instantiate_from_config

            self.tokenizer = instantiate_from_config(tokenizer_config)
        self.condition_emb = None
        if clip_embedding:
            assert condition_emb_config is not None
            from .instantiate import instantiate_from_config

            self.condition_emb = instantiate_from_config(condition_emb_config)

    def get_tokens(self, text, **kwargs):
        out = tokenize(
            text,
            context_length=self.context_length,
            add_start_and_end=self.add_start_and_end,
            with_mask=self.with_mask,
            pad_value=self.pad_value,
            tokenizer=self.tokenizer,
            just_token=self.just_token,
        )
        if not self.clip_embedding:
            return out
        if self.condition_emb.additional_last_embedding:
            emb, last = self.condition_emb(out["token"])
            out["embed_token"] = emb
            out["last_embed"] = last
        else:
            out["embed_token"] = self.condition_emb(out["token"])
        return out
