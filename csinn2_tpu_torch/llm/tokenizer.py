"""Llama tokenizer: SentencePiece-BPE encode/decode without external deps —
a copy of csinn2_tpu/llm/tokenizer.py (the port imports nothing of the JAX
package).  HFTokenizer imports the `tokenizers` wheel only when made.

The reference consumes a sentencepiece model through its converter and ships
the llama2.c-style greedy BPE loop at inference time (ref: bpe_encode,
tests/llm/llama2.c:107-170; sentencepiece import in
tests/llm/convert/shl-convert.py:29).  Here the same algorithm runs over a
vocab+scores table extracted from a GGUF checkpoint (tokenizer.ggml.tokens /
.scores) or saved by the converter as tokenizer.json; when a HuggingFace
fast-tokenizer file is present and the `tokenizers` wheel is importable, that
backend is preferred (bit-identical to transformers).

Greedy SP-BPE: seed with per-character pieces (byte-fallback <0xXX> tokens
for unknown bytes), then repeatedly merge the adjacent pair whose merged
piece exists in the vocab with the highest score.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

_SPACE = "▁"          # ▁


class SPTokenizer:
    """Self-contained SentencePiece-BPE (llama vocab)."""

    def __init__(self, tokens: List[str], scores: List[float],
                 bos_id: int = 1, eos_id: int = 2, unk_id: int = 0,
                 add_space_prefix: bool = True):
        self.tokens = list(tokens)
        self.scores = [float(s) for s in scores] if scores is not None \
            else [0.0] * len(tokens)
        self.bos_id, self.eos_id, self.unk_id = bos_id, eos_id, unk_id
        self.add_space_prefix = add_space_prefix
        self._index: Dict[str, int] = {t: i for i, t in enumerate(self.tokens)}
        # explicit byte -> id table (a vocab's '<0xNN>' pieces need not be
        # contiguous); bytes without a piece fall back to unk
        self._byte_ids: Dict[int, int] = {}
        for b in range(256):
            i = self._index.get("<0x%02X>" % b)
            if i is not None:
                self._byte_ids[b] = i

    @property
    def vocab_size(self) -> int:
        return len(self.tokens)

    # -- encode ---------------------------------------------------------------

    def _char_pieces(self, text: str) -> List[int]:
        ids: List[int] = []
        for ch in text:
            i = self._index.get(ch)
            if i is not None:
                ids.append(i)
            elif self._byte_ids:
                ids.extend(self._byte_ids.get(b, self.unk_id)
                           for b in ch.encode("utf-8"))
            else:
                ids.append(self.unk_id)
        return ids

    def encode(self, text: str, bos: bool = True, eos: bool = False) -> List[int]:
        text = text.replace(" ", _SPACE)
        if self.add_space_prefix and not text.startswith(_SPACE):
            text = _SPACE + text
        ids = self._char_pieces(text)
        # greedy merge: best-scoring merged piece first (ref: the merge loop
        # in bpe_encode, tests/llm/llama2.c:137-166)
        while len(ids) > 1:
            best, best_id, best_pos = -1e30, -1, -1
            for i in range(len(ids) - 1):
                merged = self.tokens[ids[i]] + self.tokens[ids[i + 1]]
                j = self._index.get(merged)
                if j is not None and self.scores[j] > best:
                    best, best_id, best_pos = self.scores[j], j, i
            if best_id < 0:
                break
            ids[best_pos:best_pos + 2] = [best_id]
        if bos:
            ids = [self.bos_id] + ids
        if eos:
            ids = ids + [self.eos_id]
        return ids

    # -- decode ---------------------------------------------------------------

    def decode(self, ids) -> str:
        out: List[bytes] = []
        for i in ids:
            i = int(i)
            if i in (self.bos_id, self.eos_id):
                continue
            t = self.tokens[i] if 0 <= i < len(self.tokens) else ""
            if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
                out.append(bytes([int(t[3:5], 16)]))
            else:
                out.append(t.replace(_SPACE, " ").encode("utf-8"))
        return b"".join(out).decode("utf-8", errors="replace")

    # -- persistence ----------------------------------------------------------

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump({"model": "sp-bpe", "tokens": self.tokens,
                       "scores": self.scores, "bos_id": self.bos_id,
                       "eos_id": self.eos_id, "unk_id": self.unk_id}, f)

    @staticmethod
    def load(path: str) -> "SPTokenizer":
        with open(path) as f:
            doc = json.load(f)
        assert doc.get("model") == "sp-bpe", path
        return SPTokenizer(doc["tokens"], doc["scores"], doc["bos_id"],
                           doc["eos_id"], doc["unk_id"])


class HFTokenizer:
    """HuggingFace fast-tokenizer backend (tokenizer.json)."""

    def __init__(self, path: str, bos_id: int = 1, eos_id: int = 2):
        from tokenizers import Tokenizer
        self._tok = Tokenizer.from_file(path)
        self.bos_id, self.eos_id = bos_id, eos_id
        self.vocab_size = self._tok.get_vocab_size()

    def encode(self, text: str, bos: bool = True, eos: bool = False) -> List[int]:
        ids = self._tok.encode(text, add_special_tokens=False).ids
        if bos:
            ids = [self.bos_id] + ids
        if eos:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids) -> str:
        ids = [int(i) for i in ids if int(i) not in (self.bos_id, self.eos_id)]
        return self._tok.decode(ids)


def load_tokenizer(model_dir: str):
    """Tokenizer for a converted model dir: prefers the converter-written
    sp-bpe tokenizer.json (self-contained), falls back to a HF fast-tokenizer
    file (tokenizer_hf.json / tokenizer.json copied from the checkpoint)."""
    sp = os.path.join(model_dir, "tokenizer.json")
    if os.path.exists(sp):
        try:
            return SPTokenizer.load(sp)
        except (AssertionError, KeyError):
            return HFTokenizer(sp)          # actually a HF fast-tokenizer file
    hf = os.path.join(model_dir, "tokenizer_hf.json")
    if os.path.exists(hf):
        return HFTokenizer(hf)
    raise FileNotFoundError(f"no tokenizer in {model_dir}")
