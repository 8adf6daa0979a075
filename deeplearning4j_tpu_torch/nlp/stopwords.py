"""Stop-word handling (reference deeplearning4j-nlp `text/stopwords` +
`StopWords.java`: a bundled word list consulted by tokenizers/vectorizers).

Port of deeplearning4j_tpu/nlp/stopwords.py: a host-only copy (it holds
no tensor).
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Set

from .tokenization import TokenizerFactory, Tokenizer

# the reference ships a static english stop-word resource; same role here
_ENGLISH = """a about above after again against all am an and any are aren't
as at be because been before being below between both but by can't cannot
could couldn't did didn't do does doesn't doing don't down during each few
for from further had hadn't has hasn't have haven't having he he'd he'll
he's her here here's hers herself him himself his how how's i i'd i'll i'm
i've if in into is isn't it it's its itself let's me more most mustn't my
myself no nor not of off on once only or other ought our ours ourselves out
over own same shan't she she'd she'll she's should shouldn't so some such
than that that's the their theirs them themselves then there there's these
they they'd they'll they're they've this those through to too under until
up very was wasn't we we'd we'll we're we've were weren't what what's when
when's where where's which while who who's whom why why's with won't would
wouldn't you you'd you'll you're you've your yours yourself yourselves""".split()


class StopWords:
    """Reference StopWords.getStopWords() singleton accessor."""

    _words: Optional[Set[str]] = None

    @classmethod
    def get_stop_words(cls) -> Set[str]:
        if cls._words is None:
            cls._words = set(_ENGLISH)
        return cls._words


def remove_stop_words(tokens: Iterable[str],
                      stop_words: Optional[Set[str]] = None) -> List[str]:
    sw = stop_words if stop_words is not None else StopWords.get_stop_words()
    return [t for t in tokens if t.lower() not in sw]


class StopWordFilteringTokenizerFactory(TokenizerFactory):
    """Wrap any TokenizerFactory so produced tokenizers drop stop words —
    the composition the reference applies inside its vectorizers."""

    def __init__(self, delegate: TokenizerFactory,
                 stop_words: Optional[Iterable[str]] = None):
        self._delegate = delegate
        self._stop = (set(w.lower() for w in stop_words)
                      if stop_words is not None
                      else StopWords.get_stop_words())

    def create(self, text: str) -> Tokenizer:
        tokens = self._delegate.create(text).get_tokens()
        return Tokenizer([t for t in tokens if t.lower() not in self._stop])

    def set_token_pre_processor(self, pre) -> None:
        self._delegate.set_token_pre_processor(pre)
