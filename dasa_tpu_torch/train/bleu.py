"""Corpus BLEU for speaker evaluation (reference: r2r_src/bleu.py, the
standard corpus-BLEU with optional add-one smoothing)."""

from __future__ import annotations

import collections
import math
from typing import List, Sequence, Tuple


def _ngrams(segment: Sequence, max_order: int) -> collections.Counter:
    counts: collections.Counter = collections.Counter()
    for order in range(1, max_order + 1):
        for i in range(len(segment) - order + 1):
            counts[tuple(segment[i: i + order])] += 1
    return counts


def compute_bleu(reference_corpus: List[List[Sequence]],
                 translation_corpus: List[Sequence],
                 max_order: int = 4, smooth: bool = False) -> Tuple:
    """Returns (bleu, precisions, bp, ratio, translation_length,
    reference_length)."""
    matches = [0] * max_order
    possible = [0] * max_order
    ref_len = 0
    trans_len = 0
    for references, translation in zip(reference_corpus, translation_corpus):
        ref_len += min(len(r) for r in references)
        trans_len += len(translation)
        merged_ref = collections.Counter()
        for reference in references:
            merged_ref |= _ngrams(reference, max_order)
        trans_ngrams = _ngrams(translation, max_order)
        overlap = trans_ngrams & merged_ref
        for ngram, cnt in overlap.items():
            matches[len(ngram) - 1] += cnt
        for order in range(1, max_order + 1):
            n_possible = len(translation) - order + 1
            if n_possible > 0:
                possible[order - 1] += n_possible

    precisions = [0.0] * max_order
    for i in range(max_order):
        if smooth:
            precisions[i] = (matches[i] + 1.0) / (possible[i] + 1.0)
        elif possible[i] > 0:
            precisions[i] = float(matches[i]) / possible[i]

    if min(precisions) > 0:
        log_sum = sum((1.0 / max_order) * math.log(p) for p in precisions)
        geo_mean = math.exp(log_sum)
    else:
        geo_mean = 0.0

    ratio = float(trans_len) / max(1, ref_len)
    bp = 1.0 if ratio > 1.0 else (math.exp(1 - 1.0 / ratio) if ratio > 0 else 0.0)
    bleu = geo_mean * bp
    return bleu, precisions, bp, ratio, trans_len, ref_len
