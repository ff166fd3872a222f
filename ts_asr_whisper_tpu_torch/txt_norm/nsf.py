"""CHiME-8/NOTSOFAR English text normalizer ('whisper_nsf').

Behavioral spec: the reference's src/txt_norm/english.py:451-690 (itself
aligned with chime-utils). Built compositionally on top of the number tables
in transformers' EnglishNumberNormalizer rather than re-typing them. Key
behaviors:

1. idempotent lowercase normalization;
2. REVERSE number normalization — numerals are spelled out ("365" ->
   "three hundred sixty five", "$20" -> "twenty dollars", "12th" ->
   "twelfth") so systems without rich numeral tokens aren't penalized;
3. filler removal (hmm/uh/ah/eh) after canonicalizing non-verbal sounds;
4. contraction expansion and title abbreviations;
5. symbol/diacritic stripping (keeping numeric symbols until numbers are
   processed);
6. optional UK->US spelling maps via env vars TSAW_SPELLING_JSON /
   TSAW_PRE_SPELLING_JSON (external data assets).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional

from transformers.models.whisper.english_normalizer import (
    EnglishNumberNormalizer,
    remove_symbols_and_diacritics,
)

# non-verbal sound canonicalization + contraction/abbrev expansion; the
# pattern set mirrors the CHiME-8 normalizer's replacers table
_SOUND_RULES = [
    (r"\b(hm+)\b|\b(mhm)\b|\b(mm+)\b|\b(m+h)\b|\b(um+)\b|\b(uhm+)\b", "hmm"),
    (r"\b(a+h+)\b|\b(ha+)\b", "ah"),
    (r"[!?.]+(?=$|\s)", ""),
    (r"\b(o+h+)\b|\b(h+o+)\b", "oh"),
    (r"\b(u+h+)\b|\b(h+u+)\b|\b(h+u+h+)\b", "uh"),
]

_WORD_RULES = [
    (r"\b(wi\sfi)\b", "wifi"),
    (r"\b(goin)\b", "going"),
    (r"\wi-fi\b", "wifi"),
    (r"\bwon't\b", "will not"),
    (r"\bcan't\b", "can not"),
    (r"\blet's\b", "let us"),
    (r"\bain't\b", "aint"),
    (r"\by'all\b", "you all"),
    (r"\bwanna\b", "want to"),
    (r"\bgotta\b", "got to"),
    (r"\bgonna\b", "going to"),
    (r"\bi'ma\b", "i am going to"),
    (r"\bimma\b", "i am going to"),
    (r"\bwoulda\b", "would have"),
    (r"\bcoulda\b", "could have"),
    (r"\bshoulda\b", "should have"),
    (r"\bma'am\b", "madam"),
    (r"\bokay\b", "ok"),
    (r"\bsetup\b", "set up"),
    (r"\beveryday\b", "every day"),
]

_TITLE_RULES = [
    (rf"\b{abbr}\b", full + " ") for abbr, full in [
        ("mr", "mister"), ("mrs", "missus"), ("st", "saint"),
        ("dr", "doctor"), ("prof", "professor"), ("capt", "captain"),
        ("gov", "governor"), ("ald", "alderman"), ("gen", "general"),
        ("sen", "senator"), ("rep", "representative"), ("pres", "president"),
        ("rev", "reverend"), ("hon", "honorable"), ("asst", "assistant"),
        ("assoc", "associate"), ("lt", "lieutenant"), ("col", "colonel"),
        ("jr", "junior"), ("sr", "senior"), ("esq", "esquire"),
    ]
]

_CONTRACTION_RULES = [
    (r"'d been\b", " had been"), (r"'s been\b", " has been"),
    (r"'d gone\b", " had gone"), (r"'s gone\b", " has gone"),
    (r"'d done\b", " had done"), (r"'s got\b", " has got"),
    (r"n't\b", " not"), (r"'re\b", " are"), (r"'s\b", " is"),
    (r"'d\b", " would"), (r"'ll\b", " will"), (r"'t\b", " not"),
    (r"'ve\b", " have"), (r"'m\b", " am"),
]

_FILLERS = ("hmm", "uh", "ah", "eh")


class ReverseNumberNormalizer:
    """Numerals -> spelled-out numbers, 0..1000 plus suffixed forms
    (english.py:451-526 semantics)."""

    def __init__(self):
        base = EnglishNumberNormalizer()
        self.int_to_ones = {v: k for k, v in base.ones.items()}
        self.int_to_tens = {v: k for k, v in base.tens.items()}
        self.str_to_ones_suffixed = {
            str(n) + s: k for k, (n, s) in base.ones_suffixed.items()}
        self.str_to_tens_suffixed = {
            str(n) + s: k for k, (n, s) in base.tens_suffixed.items()}

    def _number_to_words(self, w: str) -> str:
        if w.isdigit():
            num = int(w)
            if w == "000":
                return "thousand"  # handles "70 000" -> "seventy thousand"
            if num == 0:
                return "zero"
            if num == 100:
                return "hundred"
            if 0 < num < 1000:
                hundreds, remainder = divmod(num, 100)
                tens, ones = divmod(remainder, 10)
                h = [f"{self.int_to_ones[hundreds]} hundred"] if hundreds else []
                if 0 < remainder <= 19:
                    t, o = [self.int_to_ones[remainder]], []
                else:
                    t = [self.int_to_tens[tens * 10]] if tens else []
                    o = [self.int_to_ones[ones]] if ones else []
                return " ".join(h + t + o)
            if num == 1000:
                return "thousand"
            return w
        w = self.str_to_ones_suffixed.get(w, w)
        return self.str_to_tens_suffixed.get(w, w)

    def __call__(self, s: str) -> str:
        s = re.sub(r"\$(\d+(\.\d+)?)", r"\1 dollars", s)
        s = re.sub(r"(\d+(\.\d+)?)%", r"\1 percent", s)
        return " ".join(self._number_to_words(w) for w in s.split())


def _load_mapping(env_var: str, default_asset: str) -> Dict[str, str]:
    """Env-var override, else the vendored spelling asset (the reference
    loads english.json / pre_english.json unconditionally,
    english.py:638-639). Single resolution path shared with
    get_text_norm's 'whisper' branch."""
    from . import _load_spelling

    return _load_spelling(None, env_var, default_asset)


class NsfEnglishTextNormalizer:
    def __init__(self, standardize_numbers: bool = False,
                 standardize_numbers_rev: bool = True,
                 remove_fillers: bool = True,
                 spelling_mapping: Optional[Dict[str, str]] = None,
                 pre_spelling_mapping: Optional[Dict[str, str]] = None):
        self.number_norm = EnglishNumberNormalizer() if standardize_numbers \
            else None
        self.reverse_number_norm = ReverseNumberNormalizer() \
            if standardize_numbers_rev else None
        self.spelling = spelling_mapping if spelling_mapping is not None \
            else _load_mapping("TSAW_SPELLING_JSON", "english.json")
        self.pre_spelling = pre_spelling_mapping \
            if pre_spelling_mapping is not None \
            else _load_mapping("TSAW_PRE_SPELLING_JSON", "pre_english.json")
        self.remove_fillers = remove_fillers
        self._rules = (_SOUND_RULES + _WORD_RULES + _TITLE_RULES
                       + _CONTRACTION_RULES)

    def _apply_spelling(self, s: str, mapping: Dict[str, str]) -> str:
        if not mapping:
            return s
        return " ".join(mapping.get(w, w) for w in s.split())

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)      # bracketed tags
        s = re.sub(r"\(([^)]+?)\)", "", s)            # parenthesized asides
        s = self._apply_spelling(s, self.pre_spelling)
        s = re.sub(r"\s+'", "'", s)                   # space before apostrophe

        for pattern, repl in self._rules:
            s = re.sub(pattern, repl, s)

        s = re.sub(r"(\d),(\d)", r"\1\2", s)          # 1,000 -> 1000
        s = re.sub(r"\.([^0-9]|$)", r" \1", s)        # periods (non-numeric)
        s = remove_symbols_and_diacritics(s, keep=".%$¢€£")

        if self.number_norm is not None:
            s = self.number_norm(s)
        if self.reverse_number_norm is not None:
            s = self.reverse_number_norm(s)
        s = self._apply_spelling(s, self.spelling)

        s = re.sub(r"[.$¢€£]([^0-9])", r" \1", s)
        s = re.sub(r"([^0-9])%", r"\1 ", s)
        if self.remove_fillers:
            s = re.sub(r"\b(" + "|".join(_FILLERS) + r")\b", "", s)
        s = re.sub(r"\s+", " ", s)
        return s.strip()
