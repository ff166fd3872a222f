"""Hermetic Whisper English text normalizer.

Re-implements the normalization pipeline the reference applies for
``get_text_norm('whisper')`` (reference src/txt_norm/__init__.py:13-19, which
imports transformers' EnglishTextNormalizer — itself OpenAI Whisper's
normalizer) so scoring does not depend on a deep-learning library version.
Output is byte-identical to the transformers implementation; equivalence is
fuzz-tested in tests/test_txt_norm.py.

Pipeline (WhisperTextNormalizer.__call__):
lowercase -> drop bracketed/parenthesized spans and hesitations -> expand
contractions -> strip thousands-commas and non-numeric periods -> fold
symbols/diacritics (keeping ".%$¢€£") -> spell numbers as digits -> UK->US
spelling -> drop leftover numeric symbols -> collapse whitespace.

The spelling table (english.json) is the public tysto.com UK->US list, the
same data asset the reference ships.
"""

from __future__ import annotations

import re
import unicodedata
from fractions import Fraction
from typing import Dict, Iterator, List, Optional, Union

# -----------------------------------------------------------------------------
# unicode cleanup
# -----------------------------------------------------------------------------

# letters whose NFKD decomposition does not reach ASCII
_EXTRA_FOLDS = {
    "œ": "oe", "Œ": "OE", "ø": "o", "Ø": "O", "æ": "ae", "Æ": "AE",
    "ß": "ss", "ẞ": "SS", "đ": "d", "Đ": "D", "ð": "d", "Ð": "D",
    "þ": "th", "Þ": "th", "ł": "l", "Ł": "L",
}


def remove_symbols_and_diacritics(s: str, keep: str = "") -> str:
    """NFKD-normalize, drop combining marks, replace symbols/punctuation with
    spaces, and fold the extra non-decomposing letters."""
    out: List[str] = []
    for ch in unicodedata.normalize("NFKD", s):
        if ch in keep:
            out.append(ch)
            continue
        fold = _EXTRA_FOLDS.get(ch)
        if fold is not None:
            out.append(fold)
            continue
        cat = unicodedata.category(ch)
        if cat == "Mn":
            continue
        out.append(" " if cat[0] in "MSP" else ch)
    return "".join(out)


def remove_symbols(s: str) -> str:
    """NFKC-normalize and replace marks/symbols/punctuation with spaces,
    keeping diacritics."""
    return "".join(
        " " if unicodedata.category(ch)[0] in "MSP" else ch
        for ch in unicodedata.normalize("NFKC", s))


class BasicTextNormalizer:
    """Language-agnostic normalizer (lowercase + symbol removal)."""

    def __init__(self, remove_diacritics: bool = False,
                 split_letters: bool = False):
        self._clean = (remove_symbols_and_diacritics if remove_diacritics
                       else remove_symbols)
        self._split_letters = split_letters

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)
        s = re.sub(r"\(([^)]+?)\)", "", s)
        s = self._clean(s).lower()
        if self._split_letters:
            import regex  # grapheme-cluster split needs \X

            s = " ".join(regex.findall(r"\X", s, regex.U))
        return re.sub(r"\s+", " ", s)


# -----------------------------------------------------------------------------
# number words -> digits
# -----------------------------------------------------------------------------

_ONES_NAMES = ("one", "two", "three", "four", "five", "six", "seven",
               "eight", "nine", "ten", "eleven", "twelve", "thirteen",
               "fourteen", "fifteen", "sixteen", "seventeen", "eighteen",
               "nineteen")
_TENS_NAMES = {"twenty": 20, "thirty": 30, "forty": 40, "fifty": 50,
               "sixty": 60, "seventy": 70, "eighty": 80, "ninety": 90}
_MULT_NAMES = {"hundred": 10**2, "thousand": 10**3, "million": 10**6,
               "billion": 10**9, "trillion": 10**12, "quadrillion": 10**15,
               "quintillion": 10**18, "sextillion": 10**21,
               "septillion": 10**24, "octillion": 10**27,
               "nonillion": 10**30, "decillion": 10**33}

_ARABIC_RE = re.compile(r"^\d+(\.\d+)?$")


def _ordinal_of(name: str) -> str:
    return name + ("h" if name.endswith("t") else "th")


class EnglishNumberNormalizer:
    """Spell out number words as arabic digits.

    Semantics (all preserved exactly):
    - thousands-commas removed upstream; suffixes like ``1960s``/``274th``
      survive; currency words become symbol prefixes (``$20 million`` ->
      ``20000000 dollars``); successive single digits are nominal
      (``one oh one`` -> ``101``); literal ``one``/``ones`` stay words.
    """

    def __init__(self):
        self.zeros = {"o", "oh", "zero"}
        self.ones = {n: i + 1 for i, n in enumerate(_ONES_NAMES)}
        self.ones_plural = {
            ("sixes" if n == "six" else n + "s"): (v, "s")
            for n, v in self.ones.items()}
        self.ones_ordinal = {
            "zeroth": (0, "th"), "first": (1, "st"), "second": (2, "nd"),
            "third": (3, "rd"), "fifth": (5, "th"), "twelfth": (12, "th"),
        }
        for n, v in self.ones.items():
            if v > 3 and v not in (5, 12):
                self.ones_ordinal[_ordinal_of(n)] = (v, "th")
        self.ones_suffixed = {**self.ones_plural, **self.ones_ordinal}

        self.tens = dict(_TENS_NAMES)
        self.tens_plural = {n.replace("y", "ies"): (v, "s")
                            for n, v in self.tens.items()}
        self.tens_ordinal = {n.replace("y", "ieth"): (v, "th")
                             for n, v in self.tens.items()}
        self.tens_suffixed = {**self.tens_plural, **self.tens_ordinal}

        self.multipliers = dict(_MULT_NAMES)
        self.multipliers_plural = {n + "s": (v, "s")
                                   for n, v in self.multipliers.items()}
        self.multipliers_ordinal = {n + "th": (v, "th")
                                    for n, v in self.multipliers.items()}
        self.multipliers_suffixed = {**self.multipliers_plural,
                                     **self.multipliers_ordinal}

        self.decimals = {*self.ones, *self.tens, *self.zeros}
        self.preceding_prefixers = {"minus": "-", "negative": "-",
                                    "plus": "+", "positive": "+"}
        self.following_prefixers = {"pound": "£", "pounds": "£",
                                    "euro": "€", "euros": "€",
                                    "dollar": "$", "dollars": "$",
                                    "cent": "¢", "cents": "¢"}
        self.prefixes = set(self.preceding_prefixers.values()) \
            | set(self.following_prefixers.values())
        self.suffixers = {"per": {"cent": "%"}, "percent": "%"}
        self.specials = {"and", "double", "triple", "point"}

        self.words = set()
        for table in (self.zeros, self.ones, self.ones_suffixed, self.tens,
                      self.tens_suffixed, self.multipliers,
                      self.multipliers_suffixed, self.preceding_prefixers,
                      self.following_prefixers, self.suffixers,
                      self.specials):
            self.words.update(table)
        self.literal_words = {"one", "ones"}

    # -- the token walk ------------------------------------------------------
    # Mutable walk state: ``value`` accumulates the number under construction
    # (int while purely additive, str once digits are being concatenated),
    # ``prefix`` holds a pending sign/currency symbol applied at emission.

    def process_words(self, words: List[str]) -> Iterator[str]:
        self._value: Optional[Union[str, int]] = None
        self._prefix: Optional[str] = None
        if not words:
            return
        skip = False
        for i, cur in enumerate(words):
            prev = words[i - 1] if i > 0 else None
            nxt = words[i + 1] if i < len(words) - 1 else None
            if skip:
                skip = False
                continue
            skip = yield from self._step(cur, prev, nxt)
        if self._value is not None:
            yield self._emit(self._value)

    def _emit(self, result: Union[str, int]) -> str:
        text = str(result)
        if self._prefix is not None:
            text = self._prefix + text
        self._value = None
        self._prefix = None
        return text

    @staticmethod
    def _fraction(s) -> Optional[Fraction]:
        try:
            return Fraction(s)
        except ValueError:
            return None

    def _step(self, cur: str, prev: Optional[str],
              nxt: Optional[str]) -> Iterator[str]:
        """Handle one token; yields finished pieces, returns True to skip the
        next token."""
        value = self._value
        next_is_numeric = nxt is not None and _ARABIC_RE.match(nxt)
        has_prefix = cur[0] in self.prefixes
        bare = cur[1:] if has_prefix else cur

        if _ARABIC_RE.match(bare):
            # arabic numbers, possibly signed/currency-prefixed
            f = self._fraction(bare)
            if f is None:
                raise ValueError("Converting the fraction failed")
            if value is not None:
                if isinstance(value, str) and value.endswith("."):
                    # decimal / ip-address component concatenation
                    self._value = str(value) + str(cur)
                    return
                yield self._emit(value)
            if has_prefix:
                self._prefix = cur[0]
            self._value = f.numerator if f.denominator == 1 else bare
        elif cur not in self.words:
            if value is not None:
                yield self._emit(value)
            yield self._emit(cur)
        elif cur in self.zeros:
            self._value = str(value or "") + "0"
        elif cur in self.ones:
            self._value = self._append_ones(value, self.ones[cur], prev)
        elif cur in self.ones_suffixed:
            ones, suffix = self.ones_suffixed[cur]
            if value is None:
                yield self._emit(str(ones) + suffix)
            else:
                combined = self._append_ones(value, ones, prev,
                                             force_str=True)
                yield self._emit(str(combined) + suffix)
            self._value = None
        elif cur in self.tens:
            self._value = self._append_tens(value, self.tens[cur])
        elif cur in self.tens_suffixed:
            tens, suffix = self.tens_suffixed[cur]
            if value is None:
                yield self._emit(str(tens) + suffix)
            else:
                combined = self._append_tens(value, tens, force_str=True)
                yield self._emit(str(combined) + suffix)
        elif cur in self.multipliers:
            mult = self.multipliers[cur]
            if value is None:
                self._value = mult
            elif isinstance(value, str) or value == 0:
                f = self._fraction(value)
                p = f * mult if f is not None else None
                if f is not None and p.denominator == 1:
                    self._value = p.numerator
                else:
                    yield self._emit(value)
                    self._value = mult
            else:
                self._value = value // 1000 * 1000 + value % 1000 * mult
        elif cur in self.multipliers_suffixed:
            mult, suffix = self.multipliers_suffixed[cur]
            if value is None:
                yield self._emit(str(mult) + suffix)
            elif isinstance(value, str):
                f = self._fraction(value)
                p = f * mult if f is not None else None
                if f is not None and p.denominator == 1:
                    yield self._emit(str(p.numerator) + suffix)
                else:
                    yield self._emit(value)
                    yield self._emit(str(mult) + suffix)
            else:
                total = value // 1000 * 1000 + value % 1000 * mult
                yield self._emit(str(total) + suffix)
            self._value = None
        elif cur in self.preceding_prefixers:
            # sign words apply only when a number follows
            if value is not None:
                yield self._emit(value)
            if nxt in self.words or next_is_numeric:
                self._prefix = self.preceding_prefixers[cur]
            else:
                yield self._emit(cur)
        elif cur in self.following_prefixers:
            # currency words apply only after a number
            if value is not None:
                self._prefix = self.following_prefixers[cur]
                yield self._emit(value)
            else:
                yield self._emit(cur)
        elif cur in self.suffixers:
            if value is not None:
                suffix = self.suffixers[cur]
                if isinstance(suffix, dict):
                    if nxt in suffix:
                        yield self._emit(str(value) + suffix[nxt])
                        return True  # consume nxt
                    yield self._emit(value)
                    yield self._emit(cur)
                else:
                    yield self._emit(str(value) + suffix)
            else:
                yield self._emit(cur)
        elif cur in self.specials:
            if nxt not in self.words and not next_is_numeric:
                if value is not None:
                    yield self._emit(value)
                yield self._emit(cur)
            elif cur == "and":
                # swallow "and" after hundreds/thousands/...
                if prev not in self.multipliers:
                    if value is not None:
                        yield self._emit(value)
                    yield self._emit(cur)
            elif cur in ("double", "triple"):
                if nxt in self.ones or nxt in self.zeros:
                    repeats = 2 if cur == "double" else 3
                    digit = self.ones.get(nxt, 0)
                    self._value = str(value or "") + str(digit) * repeats
                    return True  # consume nxt
                if value is not None:
                    yield self._emit(value)
                yield self._emit(cur)
            elif cur == "point":
                if nxt in self.decimals or next_is_numeric:
                    self._value = str(value or "") + "."
            else:
                raise ValueError(f"Unexpected token: {cur}")
        else:
            raise ValueError(f"Unexpected token: {cur}")

    def _append_ones(self, value, ones: int, prev: Optional[str],
                     force_str: bool = False):
        """Attach a 1-19 word to the running value. Digit-concatenation rules:
        after another ones word or a string value, digits concatenate
        (nominal reading); after a round number they add."""
        if value is None:
            return str(ones) if force_str else ones
        if isinstance(value, str) or prev in self.ones:
            if prev in self.tens and ones < 10:
                return value[:-1] + str(ones)  # twenty + one -> 21
            return str(value) + str(ones)
        if ones < 10:
            if value % 10 == 0:
                return str(value + ones) if force_str else value + ones
            return str(value) + str(ones)
        # eleven..nineteen
        if value % 100 == 0:
            return str(value + ones) if force_str else value + ones
        return str(value) + str(ones)

    def _append_tens(self, value, tens: int, force_str: bool = False):
        if value is None:
            return str(tens) if force_str else tens
        if isinstance(value, str):
            return str(value) + str(tens)
        if value % 100 == 0:
            return str(value + tens) if force_str else value + tens
        return str(value) + str(tens)

    # -- string-level passes ---------------------------------------------------

    def preprocess(self, s: str) -> str:
        # "<number> and a half" -> "<number> point five"
        pieces: List[str] = []
        segments = re.split(r"\band\s+a\s+half\b", s)
        for i, segment in enumerate(segments):
            if not segment.strip():
                continue
            pieces.append(segment)
            if i != len(segments) - 1:
                last_word = segment.rsplit(maxsplit=2)[-1]
                if last_word in self.decimals or last_word in self.multipliers:
                    pieces.append("point five")
                else:
                    pieces.append("and a half")
        s = " ".join(pieces)
        # space at letter/number boundaries, but keep ordinal/plural suffixes
        s = re.sub(r"([a-z])([0-9])", r"\1 \2", s)
        s = re.sub(r"([0-9])([a-z])", r"\1 \2", s)
        s = re.sub(r"([0-9])\s+(st|nd|rd|th|s)\b", r"\1\2", s)
        return s

    def postprocess(self, s: str) -> str:
        def combine_cents(m: re.Match) -> str:
            try:
                return (f"{m.group(1)}{m.group(2)}"
                        f".{int(m.group(3)):02d}")
            except ValueError:
                return m.string

        def extract_cents(m: re.Match) -> str:
            try:
                return f"¢{int(m.group(1))}"
            except ValueError:
                return m.string

        # "$2 and ¢7" -> "$2.07"; "$0.79" -> "¢79"
        s = re.sub(r"([€£$])([0-9]+) (?:and )?¢([0-9]{1,2})\b",
                   combine_cents, s)
        s = re.sub(r"[€£$]0.([0-9]{1,2})\b", extract_cents, s)
        # keep "one(s)" literal for readability
        s = re.sub(r"\b1(s?)\b", r"one\1", s)
        return s

    def __call__(self, s: str) -> str:
        s = self.preprocess(s)
        s = " ".join(w for w in self.process_words(s.split())
                     if w is not None)
        return self.postprocess(s)


# -----------------------------------------------------------------------------
# spelling + the full pipeline
# -----------------------------------------------------------------------------


class EnglishSpellingNormalizer:
    """Word-for-word UK->US mapping (tysto.com list)."""

    def __init__(self, mapping: Dict[str, str]):
        self.mapping = mapping

    def __call__(self, s: str) -> str:
        return " ".join(self.mapping.get(w, w) for w in s.split())


_HESITATIONS = r"\b(hmm|mm|mhm|mmm|uh|um)\b"

_CONTRACTIONS = (
    # common contractions
    (r"\bwon't\b", "will not"), (r"\bcan't\b", "can not"),
    (r"\blet's\b", "let us"), (r"\bain't\b", "aint"),
    (r"\by'all\b", "you all"), (r"\bwanna\b", "want to"),
    (r"\bgotta\b", "got to"), (r"\bgonna\b", "going to"),
    (r"\bi'ma\b", "i am going to"), (r"\bimma\b", "i am going to"),
    (r"\bwoulda\b", "would have"), (r"\bcoulda\b", "could have"),
    (r"\bshoulda\b", "should have"), (r"\bma'am\b", "madam"),
    # titles / honorifics
    (r"\bmr\b", "mister "), (r"\bmrs\b", "missus "), (r"\bst\b", "saint "),
    (r"\bdr\b", "doctor "), (r"\bprof\b", "professor "),
    (r"\bcapt\b", "captain "), (r"\bgov\b", "governor "),
    (r"\bald\b", "alderman "), (r"\bgen\b", "general "),
    (r"\bsen\b", "senator "), (r"\brep\b", "representative "),
    (r"\bpres\b", "president "), (r"\brev\b", "reverend "),
    (r"\bhon\b", "honorable "), (r"\basst\b", "assistant "),
    (r"\bassoc\b", "associate "), (r"\blt\b", "lieutenant "),
    (r"\bcol\b", "colonel "), (r"\bjr\b", "junior "),
    (r"\bsr\b", "senior "), (r"\besq\b", "esquire "),
    # perfect tenses
    (r"'d been\b", " had been"), (r"'s been\b", " has been"),
    (r"'d gone\b", " had gone"), (r"'s gone\b", " has gone"),
    (r"'d done\b", " had done"), (r"'s got\b", " has got"),
    # general clitics
    (r"n't\b", " not"), (r"'re\b", " are"), (r"'s\b", " is"),
    (r"'d\b", " would"), (r"'ll\b", " will"), (r"'t\b", " not"),
    (r"'ve\b", " have"), (r"'m\b", " am"),
)


class WhisperTextNormalizer:
    """The full English pipeline (byte-identical to the reference's
    'whisper' normalizer)."""

    def __init__(self, spelling_mapping: Optional[Dict[str, str]] = None):
        self.numbers = EnglishNumberNormalizer()
        self.spellings = EnglishSpellingNormalizer(spelling_mapping or {})

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)   # bracketed spans
        s = re.sub(r"\(([^)]+?)\)", "", s)        # parenthesized spans
        s = re.sub(_HESITATIONS, "", s)
        s = re.sub(r"\s+'", "'", s)               # "it 's" -> "it's"
        for pattern, repl in _CONTRACTIONS:
            s = re.sub(pattern, repl, s)
        s = re.sub(r"(\d),(\d)", r"\1\2", s)      # 1,000 -> 1000
        s = re.sub(r"\.([^0-9]|$)", r" \1", s)    # non-numeric periods
        s = remove_symbols_and_diacritics(s, keep=".%$¢€£")
        s = self.numbers(s)
        s = self.spellings(s)
        # leftover numeric symbols not attached to digits
        s = re.sub(r"[.$¢€£]([^0-9])", r" \1", s)
        s = re.sub(r"([^0-9])%", r"\1 ", s)
        return re.sub(r"\s+", " ", s)
