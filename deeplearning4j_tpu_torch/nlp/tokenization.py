"""Tokenization: TokenizerFactory SPI + tokenizers + preprocessors.

Parity with the reference `text/tokenization/` (TokenizerFactory SPI,
DefaultTokenizer, NGramTokenizer, tokenprocessors: CommonPreprocessor,
LowCasePreProcessor, EndingPreProcessor, StemmingPreprocessor [UIMA-free
approximation]).

Port of deeplearning4j_tpu/nlp/tokenization.py: a host-only copy (it holds
no tensor).
"""
from __future__ import annotations

import re
from typing import Callable, List, Optional


class TokenPreProcess:
    """Reference tokenization/tokenizer/TokenPreProcess."""

    def pre_process(self, token: str) -> str:
        raise NotImplementedError


class LowCasePreProcessor(TokenPreProcess):
    def pre_process(self, token: str) -> str:
        return token.lower()


class CommonPreprocessor(TokenPreProcess):
    """Lowercase + strip punctuation/digits (reference CommonPreprocessor)."""

    _PUNCT = re.compile(r"[\d\.:,\"'\(\)\[\]|/?!;]+")

    def pre_process(self, token: str) -> str:
        return self._PUNCT.sub("", token.lower())


class EndingPreProcessor(TokenPreProcess):
    """Crude suffix stripper (reference EndingPreProcessor)."""

    def pre_process(self, token: str) -> str:
        t = token
        for end in ("ies", "ing", "ed", "s", "ly"):
            if t.endswith(end) and len(t) > len(end) + 2:
                return t[: -len(end)]
        return t


class Tokenizer:
    """Reference tokenization/tokenizer/Tokenizer interface."""

    def __init__(self, tokens: List[str], preprocessor: Optional[TokenPreProcess] = None):
        self._tokens = tokens
        self._pre = preprocessor
        self._idx = 0

    def has_more_tokens(self) -> bool:
        return self._idx < len(self._tokens)

    def next_token(self) -> str:
        t = self._tokens[self._idx]
        self._idx += 1
        return self._pre.pre_process(t) if self._pre else t

    def count_tokens(self) -> int:
        return len(self._tokens)

    def get_tokens(self) -> List[str]:
        out = []
        while self.has_more_tokens():
            t = self.next_token()
            if t:
                out.append(t)
        return out


class TokenizerFactory:
    """Reference tokenization/tokenizerfactory/TokenizerFactory SPI."""

    def __init__(self):
        self._pre: Optional[TokenPreProcess] = None

    def set_token_pre_processor(self, pre: TokenPreProcess):
        self._pre = pre
        return self

    def create(self, text: str) -> Tokenizer:
        raise NotImplementedError


class DefaultTokenizerFactory(TokenizerFactory):
    """Whitespace/word-boundary tokenizer (reference DefaultTokenizerFactory)."""

    _SPLIT = re.compile(r"\s+")

    def create(self, text: str) -> Tokenizer:
        tokens = [t for t in self._SPLIT.split(text.strip()) if t]
        return Tokenizer(tokens, self._pre)


class NGramTokenizerFactory(TokenizerFactory):
    """Word n-grams (reference NGramTokenizerFactory)."""

    def __init__(self, min_n: int = 1, max_n: int = 2):
        super().__init__()
        self.min_n = min_n
        self.max_n = max_n

    def create(self, text: str) -> Tokenizer:
        words = [t for t in re.split(r"\s+", text.strip()) if t]
        grams: List[str] = []
        for n in range(self.min_n, self.max_n + 1):
            for i in range(0, len(words) - n + 1):
                grams.append(" ".join(words[i:i + n]))
        return Tokenizer(grams, self._pre)
