"""Hallucination guard: truncate hypotheses at repeating n-grams.

Same semantics as the reference's src/data/postprocess.py:4-74: texts shorter
than ``min_word_threshold`` pass through; otherwise cut at the earliest of
(a) a run of >= ``unigram_min_repeat`` consecutive identical words (keep one)
or (b) the first completed occurrence of any 2..max_n-gram whose total count
exceeds ``repeat_threshold`` (same-word n-grams excluded).
"""

from __future__ import annotations

from collections import defaultdict


def count_ngrams(text: str, min_n: int = 2, max_n: int = 5) -> dict:
    words = text.split()
    counts: dict = defaultdict(int)
    for n in range(min_n, max_n + 1):
        for i in range(len(words) - n + 1):
            ngram_words = words[i : i + n]
            if all(w.lower() == ngram_words[0].lower() for w in ngram_words):
                continue
            counts[" ".join(ngram_words)] += 1
    return counts


def truncate_at_repeating_ngram(
    text: str,
    ngram_length: int = 10,
    min_n: int = 1,
    max_n: int | None = None,
    min_word_threshold: int = 30,
    unigram_min_repeat: int = 10,
    repeat_threshold: int = 10,
) -> str:
    if max_n is None:
        max_n = ngram_length
    words = text.split()
    if len(words) < min_word_threshold:
        return text

    earliest = len(words)

    if min_n == 1:
        for i in range(len(words) - unigram_min_repeat + 1):
            current = words[i].lower()
            consecutive = 1
            for j in range(i + 1, len(words)):
                if words[j].lower() == current:
                    consecutive += 1
                else:
                    break
            if consecutive >= unigram_min_repeat:
                earliest = min(earliest, i + 1)
                break

    counts = count_ngrams(text, min_n=max(2, min_n), max_n=max_n)
    lengths = [ngram_length] + [n for n in range(min_n, max_n + 1)
                                if n != ngram_length and n > 1]
    for n in lengths:
        for i in range(len(words) - n + 1):
            ngram = " ".join(words[i : i + n])
            if counts[ngram] > repeat_threshold:
                earliest = min(earliest, i + n)

    if earliest < len(words):
        return " ".join(words[:earliest])
    return text
