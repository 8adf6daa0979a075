"""NLP stack: tokenization/text pipeline + embedding models (SURVEY §2.5) —
port of deeplearning4j_tpu/nlp/, exporting the same names."""
from .tokenization import (CommonPreprocessor, DefaultTokenizerFactory,
                           EndingPreProcessor, LowCasePreProcessor,
                           NGramTokenizerFactory, Tokenizer, TokenizerFactory)
from .stopwords import (StopWords, StopWordFilteringTokenizerFactory,
                        remove_stop_words)
from .sentence_iterator import (BasicLineIterator, CollectionSentenceIterator,
                                LabelAwareSentenceIterator,
                                LabelledCollectionSentenceIterator,
                                SentenceIterator)
from .vocab import VocabCache, VocabConstructor, build_huffman
from .invertedindex import InvertedIndex
from .diskindex import DiskInvertedIndex
from .trees import Tree, parse_tree, parse_trees
from .word2vec import InMemoryLookupTable, SequenceVectors, Word2Vec
from .glove import AbstractCoOccurrences, Glove
from .paragraph import ParagraphVectors
from .tfidf import BagOfWordsVectorizer, TfidfVectorizer
from . import serializer

__all__ = [
    "Tokenizer", "TokenizerFactory", "DefaultTokenizerFactory",
    "NGramTokenizerFactory", "CommonPreprocessor", "EndingPreProcessor",
    "LowCasePreProcessor", "StopWords", "StopWordFilteringTokenizerFactory",
    "remove_stop_words", "SentenceIterator", "BasicLineIterator",
    "CollectionSentenceIterator", "LabelAwareSentenceIterator",
    "LabelledCollectionSentenceIterator", "VocabCache", "VocabConstructor",
    "build_huffman", "InvertedIndex", "DiskInvertedIndex", "Tree",
    "parse_tree", "parse_trees",
    "SequenceVectors", "Word2Vec", "InMemoryLookupTable",
    "AbstractCoOccurrences", "Glove", "ParagraphVectors",
    "BagOfWordsVectorizer", "TfidfVectorizer", "serializer",
]
