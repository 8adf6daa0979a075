"""Treebank tree structures (reference `text/corpora/treeparser/Tree.java`:
labelled constituency trees with traversal/yield utilities, produced by the
reference's UIMA/OpenNLP tree parser and consumed by recursive models).

The UIMA/OpenNLP machinery is environment infrastructure; the framework
capability is the Tree data structure + Penn-Treebank bracketed parsing,
implemented natively here.

Port of deeplearning4j_tpu/nlp/trees.py: a host-only copy (it holds
no tensor).
"""
from __future__ import annotations

from typing import Iterator, List, Optional


class Tree:
    """Labelled ordered tree (reference Tree.java surface: label/value,
    children, isLeaf/isPreTerminal, yield, depth, firstChild/lastChild,
    prediction/vector slots for recursive nets)."""

    def __init__(self, label: str = "", value: Optional[str] = None,
                 children: Optional[List["Tree"]] = None):
        self.label = label          # nonterminal tag (NP, VP, ...)
        self.value = value          # terminal token for leaves
        self.children: List[Tree] = children or []
        self.parent: Optional[Tree] = None
        for c in self.children:
            c.parent = self
        # recursive-model slots (reference Tree.vector()/prediction())
        self.vector = None
        self.prediction = None
        self.gold_label: Optional[int] = None

    # -- structure -------------------------------------------------------------
    def is_leaf(self) -> bool:
        return not self.children

    def is_pre_terminal(self) -> bool:
        return len(self.children) == 1 and self.children[0].is_leaf()

    def first_child(self) -> Optional["Tree"]:
        return self.children[0] if self.children else None

    def last_child(self) -> Optional["Tree"]:
        return self.children[-1] if self.children else None

    def depth(self) -> int:
        if self.is_leaf():
            return 0
        return 1 + max(c.depth() for c in self.children)

    def yield_words(self) -> List[str]:
        """Terminal tokens left-to-right (reference Tree.yield())."""
        if self.is_leaf():
            return [self.value] if self.value is not None else []
        out: List[str] = []
        for c in self.children:
            out.extend(c.yield_words())
        return out

    def subtrees(self) -> Iterator["Tree"]:
        yield self
        for c in self.children:
            yield from c.subtrees()

    def __repr__(self) -> str:
        return f"Tree({self.to_string()})"

    def to_string(self) -> str:
        if self.is_leaf():
            return self.value or ""
        inner = " ".join(c.to_string() for c in self.children)
        return f"({self.label} {inner})"


def parse_tree(s: str) -> Tree:
    """Parse one Penn-Treebank bracketed string:
    ``(S (NP (DT the) (NN cat)) (VP (VBD sat)))``."""
    tokens = s.replace("(", " ( ").replace(")", " ) ").split()
    pos = 0

    def parse() -> Tree:
        nonlocal pos
        assert tokens[pos] == "(", f"expected '(' at {pos}"
        pos += 1
        label = tokens[pos]
        pos += 1
        children: List[Tree] = []
        value = None
        while tokens[pos] != ")":
            if tokens[pos] == "(":
                children.append(parse())
            else:
                value = tokens[pos]
                pos += 1
        pos += 1  # consume ')'
        if value is not None and not children:
            return Tree(label, children=[Tree(label="", value=value)])
        return Tree(label, children=children)

    tree = parse()
    if pos != len(tokens):
        raise ValueError(f"trailing tokens after tree: {tokens[pos:]}")
    return tree


def parse_trees(text: str) -> List[Tree]:
    """Parse a file's worth of bracketed trees (one or more)."""
    trees = []
    depth = 0
    start = None
    for i, ch in enumerate(text):
        if ch == "(":
            if depth == 0:
                start = i
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0 and start is not None:
                trees.append(parse_tree(text[start:i + 1]))
                start = None
    return trees
