"""Instruction tokenizer and vocabulary.

Behavioral match of the reference Tokenizer (r2r_src/utils.py:129-256):
regex split on non-alphanumerics, punctuation-run splitting (except
multi-dot), <BOS>...<EOS> framing, <PAD> fill, EOS-overwrite truncation,
min-count vocab build.
"""

from __future__ import annotations

import re
import string
from collections import Counter
from typing import Iterable, List, Optional, Sequence

import numpy as np

BASE_VOCAB = ["<PAD>", "<UNK>", "<EOS>"]
PAD_IDX = BASE_VOCAB.index("<PAD>")

_SENTENCE_SPLIT_REGEX = re.compile(r"(\W+)")


def split_sentence(sentence: str) -> List[str]:
    """Break sentence into words and punctuation (utils.py:166-176)."""
    toks: List[str] = []
    for word in [
        s.strip().lower()
        for s in _SENTENCE_SPLIT_REGEX.split(sentence.strip())
        if len(s.strip()) > 0
    ]:
        if all(c in string.punctuation for c in word) and not all(
            c in "." for c in word
        ):
            toks += list(word)
        else:
            toks.append(word)
    return toks


class Tokenizer:
    """Word-level tokenizer with fixed-length id encoding."""

    split_sentence = staticmethod(split_sentence)

    def __init__(self, vocab: Optional[Sequence[str]] = None,
                 encoding_length: int = 20):
        self.encoding_length = encoding_length
        self.vocab = list(vocab) if vocab else []
        self.word_to_index = {w: i for i, w in enumerate(self.vocab)}
        self.index_to_word = {i: w for w, i in self.word_to_index.items()}
        if vocab:
            self.add_word("<BOS>")

    def add_word(self, word: str) -> None:
        assert word not in self.word_to_index
        idx = self.vocab_size()
        self.word_to_index[word] = idx
        self.index_to_word[idx] = word

    def vocab_size(self) -> int:
        return len(self.index_to_word)

    def __len__(self) -> int:
        return self.vocab_size()

    def _tok_id(self, word: str) -> int:
        return self.word_to_index.get(word, self.word_to_index["<UNK>"])

    def encode_sentence(self, sentence: str,
                        max_length: Optional[int] = None) -> Optional[np.ndarray]:
        """<BOS> w1..wn <EOS> padded/truncated to max_length; None when the
        sentence has no tokens (utils.py:180-201)."""
        if max_length is None:
            max_length = self.encoding_length
        if not self.word_to_index:
            raise RuntimeError("Tokenizer has no vocab")
        encoding = [self._tok_id("<BOS>")]
        for word in split_sentence(sentence):
            encoding.append(self._tok_id(word))
        encoding.append(self._tok_id("<EOS>"))
        if len(encoding) <= 2:
            return None
        if len(encoding) < max_length:
            encoding += [self.word_to_index["<PAD>"]] * (max_length - len(encoding))
        elif len(encoding) > max_length:
            encoding[max_length - 1] = self.word_to_index["<EOS>"]
        return np.array(encoding[:max_length])

    def decode_sentence(self, encoding: Iterable[int],
                        length: Optional[int] = None) -> str:
        sentence = []
        enc = list(encoding)
        if length is not None:
            enc = enc[:length]
        for ix in enc:
            if ix == self.word_to_index["<PAD>"]:
                break
            sentence.append(self.index_to_word[int(ix)])
        return " ".join(sentence)

    def shrink(self, inst: Sequence[int]) -> Sequence[int]:
        """Strip <BOS>/<EOS>; empty if no <EOS> (utils.py:214-227)."""
        if len(inst) == 0:
            return inst
        end = int(np.argmax(np.array(inst) == self.word_to_index["<EOS>"]))
        start = 1 if len(inst) > 1 and inst[0] == self.word_to_index["<BOS>"] else 0
        return inst[start:end]


def build_vocab(data: Iterable[dict], min_count: int = 5,
                start_vocab: Sequence[str] = BASE_VOCAB) -> List[str]:
    """Min-count vocab from dataset items (utils.py:229-244).  `data` is an
    iterable of items with an 'instructions' list field."""
    count: Counter = Counter()
    for item in data:
        for instr in item["instructions"]:
            count.update(split_sentence(instr))
    vocab = list(start_vocab)
    for word, num in count.most_common():
        if num >= min_count:
            vocab.append(word)
        else:
            break
    return vocab


def write_vocab(vocab: Sequence[str], path: str) -> None:
    with open(path, "w") as f:
        for word in vocab:
            f.write("%s\n" % word)


def read_vocab(path: str) -> List[str]:
    with open(path) as f:
        return [word.strip() for word in f.readlines()]
