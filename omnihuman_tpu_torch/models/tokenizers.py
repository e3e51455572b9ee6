"""HuggingFace tokenizer wrapper (host-side, numpy outputs).

Copy of omnihuman_tpu/models/tokenizers.py (reference
wan/modules/tokenizers.py:37-82): AutoTokenizer + optional text cleaning,
fixed-length padding + truncation, returns (ids, mask) as numpy int32.
Tokenizer files are read from the local HuggingFace cache only; where
they are absent the deterministic `_HashTokenizer` gives the same ids as
the JAX package's fallback.
"""

from __future__ import annotations

import html
import logging
import re
import string
from typing import List, Optional, Tuple, Union

import numpy as np

try:
    import ftfy
    _HAS_FTFY = True
except ImportError:  # pragma: no cover - environment dependent
    _HAS_FTFY = False


def basic_clean(text: str) -> str:
    if _HAS_FTFY:
        text = ftfy.fix_text(text)
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def canonicalize(text: str,
                 keep_punctuation_exact_string: Optional[str] = None) -> str:
    text = text.replace("_", " ")
    if keep_punctuation_exact_string:
        text = keep_punctuation_exact_string.join(
            part.translate(str.maketrans("", "", string.punctuation))
            for part in text.split(keep_punctuation_exact_string))
    else:
        text = text.translate(str.maketrans("", "", string.punctuation))
    text = text.lower()
    return re.sub(r"\s+", " ", text).strip()


class HuggingfaceTokenizer:

    def __init__(self, name: str, seq_len: Optional[int] = None,
                 clean: Optional[str] = None, fallback: bool = True,
                 **kwargs):
        if clean not in (None, "whitespace", "lower", "canonicalize"):
            raise ValueError(f"unknown clean mode {clean!r}")
        self.name = name
        self.seq_len = seq_len
        self.clean = clean
        try:
            from transformers import AutoTokenizer
            kwargs.setdefault("local_files_only", True)
            self.tokenizer = AutoTokenizer.from_pretrained(name, **kwargs)
            self.vocab_size = self.tokenizer.vocab_size
        except (ImportError, OSError, ValueError):
            if not fallback:
                raise
            logging.getLogger("omnihuman_tpu_torch").warning(
                f"tokenizer '{name}' unavailable; using offline hash "
                "fallback")
            self.tokenizer = _HashTokenizer(seq_len or 512)
            self.vocab_size = self.tokenizer.vocab_size

    def __call__(self, sequence: Union[str, List[str]], return_mask=False,
                 **kwargs) -> Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]:
        _kwargs = {"return_tensors": "np"}
        if self.seq_len is not None:
            _kwargs.update(padding="max_length", truncation=True,
                           max_length=self.seq_len)
        _kwargs.update(**kwargs)

        if isinstance(sequence, str):
            sequence = [sequence]
        if self.clean:
            sequence = [self._clean(u) for u in sequence]
        out = self.tokenizer(sequence, **_kwargs)

        ids = np.asarray(out["input_ids"], dtype=np.int32)
        if return_mask:
            return ids, np.asarray(out["attention_mask"], dtype=np.int32)
        return ids

    def _clean(self, text: str) -> str:
        if self.clean == "whitespace":
            return whitespace_clean(basic_clean(text))
        if self.clean == "lower":
            return whitespace_clean(basic_clean(text)).lower()
        if self.clean == "canonicalize":
            return canonicalize(basic_clean(text))
        return text


class _HashTokenizer:
    """Deterministic word-hash tokenizer (offline fallback only):
    pad id 1, eos id 0, word ids in [2, vocab_size)."""

    def __init__(self, seq_len: int, vocab_size: int = 256384):
        self.seq_len = seq_len
        self.vocab_size = vocab_size

    def __call__(self, texts, return_tensors="np", padding=None,
                 truncation=None, max_length=None, **kw):
        import hashlib
        max_length = max_length or self.seq_len
        ids = np.ones((len(texts), max_length), np.int32)   # pad id 1
        mask = np.zeros((len(texts), max_length), np.int32)
        for i, t in enumerate(texts):
            words = t.split()[: max_length - 1]
            for j, w in enumerate(words):
                h = int(hashlib.md5(w.encode()).hexdigest()[:8], 16)
                ids[i, j] = 2 + h % (self.vocab_size - 2)
            ids[i, len(words)] = 0                          # eos
            mask[i, : len(words) + 1] = 1
        return {"input_ids": ids, "attention_mask": mask}
