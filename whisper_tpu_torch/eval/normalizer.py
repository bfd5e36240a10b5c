"""Full English text normalizer — the WER-protocol text canonicalizer.

The port's own copy of whisper_tpu/eval/normalizer.py (host code, no JAX),
with a copy of its english_spelling.json beside it;
tests/test_torch_port_eval.py holds the two equal.

The reference's LibriSpeech/Earnings21 WER protocol normalizes both the
transcript and the hypothesis with OpenAI Whisper's EnglishTextNormalizer
before scoring (reference sys/whisper.cpp/tests/librispeech/eval.py:30-44,
vendored under tests/librispeech/normalizers/, MIT). WER numbers are only
comparable across implementations when the normalizer matches EXACTLY, so
— like the K-quant codecs (checkpoint/quant.py) and the GBNF engine
(decoding/grammar.py) — the upstream algorithm IS the spec here: this is
a dependency-free semantic port (no jiwer/more_itertools/regex imports)
whose output is validated token-for-token against the reference's own
vendored copy by tests/test_normalizer.py, plus recorded fixture pairs so
the check stands without the reference tree.

Components (reference file:line cites against the vendored copy):
- remove_symbols_and_diacritics / remove_symbols  (normalizers/basic.py:27-57)
- BasicTextNormalizer                             (normalizers/basic.py:60-80)
- EnglishNumberNormalizer                         (normalizers/english.py:12-447)
- EnglishSpellingNormalizer  (english_spelling.json = the standard
  British->American table, normalizers/english.json; re-serialized sorted)
- EnglishTextNormalizer                           (normalizers/english.py:465-550)
"""

from __future__ import annotations

import json
import os
import re
import unicodedata
from fractions import Fraction
from typing import Iterator, List, Optional, Union

# non-ASCII letters that NFKD does not decompose (normalizers/basic.py:7-24)
_SPECIAL_LETTERS = {
    "œ": "oe", "Œ": "OE", "ø": "o", "Ø": "O", "æ": "ae", "Æ": "AE",
    "ß": "ss", "ẞ": "SS", "đ": "d", "Đ": "D", "ð": "d", "Ð": "D",
    "þ": "th", "Þ": "th", "ł": "l", "Ł": "L",
}


def remove_symbols_and_diacritics(s: str, keep: str = "") -> str:
    """NFKD-decompose, drop combining marks (Mn), map the special letters
    above, and space out any other mark/symbol/punctuation character
    (normalizers/basic.py:27-47)."""
    out = []
    for c in unicodedata.normalize("NFKD", s):
        if c in keep:
            out.append(c)
        elif c in _SPECIAL_LETTERS:
            out.append(_SPECIAL_LETTERS[c])
        else:
            cat = unicodedata.category(c)
            if cat == "Mn":
                continue
            out.append(" " if cat[0] in "MSP" else c)
    return "".join(out)


def remove_symbols(s: str) -> str:
    """Space out marks/symbols/punctuation, keep diacritics
    (normalizers/basic.py:50-57)."""
    return "".join(" " if unicodedata.category(c)[0] in "MSP" else c
                   for c in unicodedata.normalize("NFKC", s))


class BasicTextNormalizer:
    """Language-agnostic normalizer (normalizers/basic.py:60-80)."""

    def __init__(self, remove_diacritics: bool = False,
                 split_letters: bool = False):
        self.clean = (remove_symbols_and_diacritics if remove_diacritics
                      else remove_symbols)
        self.split_letters = split_letters

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)
        s = re.sub(r"\(([^)]+?)\)", "", s)
        s = self.clean(s).lower()
        if self.split_letters:
            # grapheme-cluster split; without the `regex` module, attach
            # combining marks to their base char by category
            out, cur = [], ""
            for c in s:
                if cur and unicodedata.category(c) not in ("Mn", "Mc", "Me"):
                    out.append(cur)
                    cur = ""
                cur += c
            if cur:
                out.append(cur)
            s = " ".join(out)
        return re.sub(r"\s+", " ", s)


_NUMERIC_RE = re.compile(r"^\d+(\.\d+)?$")


class EnglishNumberNormalizer:
    """Spelled-out -> arabic numbers with suffix/currency/percent handling
    (normalizers/english.py:12-447; behavior contract in its docstring:
    strip digit-group commas, keep suffixes like `1960s`/`32nd`, move
    currency words behind the amount, keep literal `one`/`ones`, read
    successive single digits as nominal — `one oh one` -> `101`)."""

    def __init__(self):
        self.zeros = {"o", "oh", "zero"}
        names = ["one", "two", "three", "four", "five", "six", "seven",
                 "eight", "nine", "ten", "eleven", "twelve", "thirteen",
                 "fourteen", "fifteen", "sixteen", "seventeen", "eighteen",
                 "nineteen"]
        self.ones = {name: i for i, name in enumerate(names, start=1)}
        self.ones_plural = {
            ("sixes" if name == "six" else name + "s"): (value, "s")
            for name, value in self.ones.items()}
        self.ones_ordinal = {
            "zeroth": (0, "th"), "first": (1, "st"), "second": (2, "nd"),
            "third": (3, "rd"), "fifth": (5, "th"), "twelfth": (12, "th"),
            **{name + ("h" if name.endswith("t") else "th"): (value, "th")
               for name, value in self.ones.items()
               if value > 3 and value != 5 and value != 12}}
        self.ones_suffixed = {**self.ones_plural, **self.ones_ordinal}

        self.tens = {"twenty": 20, "thirty": 30, "forty": 40, "fifty": 50,
                     "sixty": 60, "seventy": 70, "eighty": 80, "ninety": 90}
        self.tens_plural = {name.replace("y", "ies"): (value, "s")
                            for name, value in self.tens.items()}
        self.tens_ordinal = {name.replace("y", "ieth"): (value, "th")
                             for name, value in self.tens.items()}
        self.tens_suffixed = {**self.tens_plural, **self.tens_ordinal}

        self.multipliers = {
            "hundred": 100, "thousand": 10**3, "million": 10**6,
            "billion": 10**9, "trillion": 10**12, "quadrillion": 10**15,
            "quintillion": 10**18, "sextillion": 10**21, "septillion": 10**24,
            "octillion": 10**27, "nonillion": 10**30, "decillion": 10**33}
        self.multipliers_plural = {name + "s": (value, "s")
                                   for name, value in self.multipliers.items()}
        self.multipliers_ordinal = {name + "th": (value, "th")
                                    for name, value in self.multipliers.items()}
        self.multipliers_suffixed = {**self.multipliers_plural,
                                     **self.multipliers_ordinal}

        self.decimals = {*self.ones, *self.tens, *self.zeros}
        self.preceding_prefixers = {"minus": "-", "negative": "-",
                                    "plus": "+", "positive": "+"}
        self.following_prefixers = {"pound": "£", "pounds": "£",
                                    "euro": "€", "euros": "€",
                                    "dollar": "$", "dollars": "$",
                                    "cent": "¢", "cents": "¢"}
        self.prefixes = set(self.preceding_prefixers.values()) | set(
            self.following_prefixers.values())
        self.suffixers = {"per": {"cent": "%"}, "percent": "%"}
        self.specials = {"and", "double", "triple", "point"}

        self.words = set().union(
            self.zeros, self.ones, self.ones_suffixed, self.tens,
            self.tens_suffixed, self.multipliers, self.multipliers_suffixed,
            self.preceding_prefixers, self.following_prefixers,
            self.suffixers, self.specials)
        self.literal_words = {"one", "ones"}

    def process_words(self, words: List[str]) -> Iterator[str]:
        """The accumulator state machine (normalizers/english.py:165-386):
        `value` holds the number being built (int while arithmetic
        composition is still possible, str once positional), `prefix` a
        pending sign/currency symbol; suffixed forms flush immediately."""
        prefix: Optional[str] = None
        value: Optional[Union[str, int]] = None

        def to_fraction(s):
            try:
                return Fraction(s)
            except ValueError:
                return None

        def flush(result) -> str:
            nonlocal prefix, value
            result = str(result)
            if prefix is not None:
                result = prefix + result
            value = None
            prefix = None
            return result

        n = len(words)
        i = 0
        while i < n:
            prev = words[i - 1] if i > 0 else None
            current = words[i]
            nxt = words[i + 1] if i + 1 < n else None
            i += 1

            next_is_numeric = nxt is not None and _NUMERIC_RE.match(nxt)
            has_prefix = current[0] in self.prefixes
            current_without_prefix = current[1:] if has_prefix else current

            if _NUMERIC_RE.match(current_without_prefix):
                # arabic numbers (potentially with signs and fractions)
                f = to_fraction(current_without_prefix)
                assert f is not None
                if value is not None:
                    if isinstance(value, str) and value.endswith("."):
                        # concatenate decimals / ip address components
                        value = str(value) + str(current)
                        continue
                    else:
                        yield flush(value)
                prefix = current[0] if has_prefix else prefix
                value = (f.numerator if f.denominator == 1
                         else current_without_prefix)
            elif current not in self.words:
                if value is not None:
                    yield flush(value)
                yield flush(current)
            elif current in self.zeros:
                value = str(value or "") + "0"
            elif current in self.ones:
                ones = self.ones[current]
                if value is None:
                    value = ones
                elif isinstance(value, str) or prev in self.ones:
                    if prev in self.tens and ones < 10:
                        # replace the trailing zero with the digit
                        assert value[-1] == "0"
                        value = value[:-1] + str(ones)
                    else:
                        value = str(value) + str(ones)
                elif ones < 10:
                    if value % 10 == 0:
                        value += ones
                    else:
                        value = str(value) + str(ones)
                else:  # eleven..nineteen
                    if value % 100 == 0:
                        value += ones
                    else:
                        value = str(value) + str(ones)
            elif current in self.ones_suffixed:
                ones, suffix = self.ones_suffixed[current]
                if value is None:
                    yield flush(str(ones) + suffix)
                elif isinstance(value, str) or prev in self.ones:
                    if prev in self.tens and ones < 10:
                        assert value[-1] == "0"
                        yield flush(value[:-1] + str(ones) + suffix)
                    else:
                        yield flush(str(value) + str(ones) + suffix)
                elif ones < 10:
                    if value % 10 == 0:
                        yield flush(str(value + ones) + suffix)
                    else:
                        yield flush(str(value) + str(ones) + suffix)
                else:  # eleven..nineteen
                    if value % 100 == 0:
                        yield flush(str(value + ones) + suffix)
                    else:
                        yield flush(str(value) + str(ones) + suffix)
                value = None
            elif current in self.tens:
                tens = self.tens[current]
                if value is None:
                    value = tens
                elif isinstance(value, str):
                    value = str(value) + str(tens)
                elif value % 100 == 0:
                    value += tens
                else:
                    value = str(value) + str(tens)
            elif current in self.tens_suffixed:
                tens, suffix = self.tens_suffixed[current]
                if value is None:
                    yield flush(str(tens) + suffix)
                elif isinstance(value, str):
                    yield flush(str(value) + str(tens) + suffix)
                elif value % 100 == 0:
                    yield flush(str(value + tens) + suffix)
                else:
                    yield flush(str(value) + str(tens) + suffix)
            elif current in self.multipliers:
                multiplier = self.multipliers[current]
                if value is None:
                    value = multiplier
                elif isinstance(value, str) or value == 0:
                    f = to_fraction(value)
                    p = f * multiplier if f is not None else None
                    if f is not None and p.denominator == 1:
                        value = p.numerator
                    else:
                        yield flush(value)
                        value = multiplier
                else:
                    before = value // 1000 * 1000
                    residual = value % 1000
                    value = before + residual * multiplier
            elif current in self.multipliers_suffixed:
                multiplier, suffix = self.multipliers_suffixed[current]
                if value is None:
                    yield flush(str(multiplier) + suffix)
                elif isinstance(value, str):
                    f = to_fraction(value)
                    p = f * multiplier if f is not None else None
                    if f is not None and p.denominator == 1:
                        yield flush(str(p.numerator) + suffix)
                    else:
                        yield flush(value)
                        yield flush(str(multiplier) + suffix)
                else:
                    before = value // 1000 * 1000
                    residual = value % 1000
                    value = before + residual * multiplier
                    yield flush(str(value) + suffix)
                value = None
            elif current in self.preceding_prefixers:
                # sign applies only when a number actually follows
                if value is not None:
                    yield flush(value)
                if nxt in self.words or next_is_numeric:
                    prefix = self.preceding_prefixers[current]
                else:
                    yield flush(current)
            elif current in self.following_prefixers:
                # currency word binds to the number it follows
                if value is not None:
                    prefix = self.following_prefixers[current]
                    yield flush(value)
                else:
                    yield flush(current)
            elif current in self.suffixers:
                if value is not None:
                    suffix = self.suffixers[current]
                    if isinstance(suffix, dict):
                        if nxt in suffix:
                            yield flush(str(value) + suffix[nxt])
                            i += 1        # consumed the lookahead word
                        else:
                            yield flush(value)
                            yield flush(current)
                    else:
                        yield flush(str(value) + suffix)
                else:
                    yield flush(current)
            elif current in self.specials:
                if nxt not in self.words and not next_is_numeric:
                    if value is not None:
                        yield flush(value)
                    yield flush(current)
                elif current == "and":
                    # "and" inside "one hundred and five" is dropped
                    if prev not in self.multipliers:
                        if value is not None:
                            yield flush(value)
                        yield flush(current)
                elif current in ("double", "triple"):
                    if nxt in self.ones or nxt in self.zeros:
                        repeats = 2 if current == "double" else 3
                        ones = self.ones.get(nxt, 0)
                        value = str(value or "") + str(ones) * repeats
                        i += 1            # consumed the lookahead word
                    else:
                        if value is not None:
                            yield flush(value)
                        yield flush(current)
                elif current == "point":
                    if nxt in self.decimals or next_is_numeric:
                        value = str(value or "") + "."
                else:
                    raise ValueError(f"Unexpected token: {current}")
            else:
                raise ValueError(f"Unexpected token: {current}")

        if value is not None:
            yield flush(value)

    def preprocess(self, s: str) -> str:
        """normalizers/english.py:388-415."""
        # "<number> and a half" -> "<number> point five"
        results = []
        segments = re.split(r"\band\s+a\s+half\b", s)
        for i, segment in enumerate(segments):
            if len(segment.strip()) == 0:
                continue
            results.append(segment)
            if i != len(segments) - 1:
                last_word = segment.rsplit(maxsplit=2)[-1]
                if last_word in self.decimals or last_word in self.multipliers:
                    results.append("point five")
                else:
                    results.append("and a half")
        s = " ".join(results)

        # space at number/letter boundaries, except number suffixes
        s = re.sub(r"([a-z])([0-9])", r"\1 \2", s)
        s = re.sub(r"([0-9])([a-z])", r"\1 \2", s)
        s = re.sub(r"([0-9])\s+(st|nd|rd|th|s)\b", r"\1\2", s)
        return s

    def postprocess(self, s: str) -> str:
        """normalizers/english.py:417-440."""
        def combine_cents(m):
            try:
                return f"{m.group(1)}{m.group(2)}.{int(m.group(3)):02d}"
            except ValueError:
                return m.string

        def extract_cents(m):
            try:
                return f"¢{int(m.group(1))}"
            except ValueError:
                return m.string

        # "$2 and ¢7" -> "$2.07"
        s = re.sub(r"([€£$])([0-9]+) (?:and )?¢([0-9]{1,2})\b",
                   combine_cents, s)
        s = re.sub(r"[€£$]0.([0-9]{1,2})\b", extract_cents, s)
        # keep literal "one(s)"
        s = re.sub(r"\b1(s?)\b", r"one\1", s)
        return s

    def __call__(self, s: str) -> str:
        s = self.preprocess(s)
        s = " ".join(w for w in self.process_words(s.split()) if w is not None)
        return self.postprocess(s)


class EnglishSpellingNormalizer:
    """British->American spelling mapping (the standard tysto.com table the
    protocol ships as normalizers/english.json; bundled here re-serialized
    key-sorted as english_spelling.json)."""

    def __init__(self):
        path = os.path.join(os.path.dirname(__file__), "english_spelling.json")
        with open(path, encoding="utf-8") as f:
            self.mapping = json.load(f)

    def __call__(self, s: str) -> str:
        return " ".join(self.mapping.get(word, word) for word in s.split())


class EnglishTextNormalizer:
    """The WER-protocol normalizer (normalizers/english.py:465-550).
    Replacement order matters and is preserved: fillers removed, contraction
    and title tables applied before the generic suffix rules, digit-group
    commas and non-decimal periods stripped, symbols/diacritics spaced out
    (keeping numeric symbols), then number + spelling standardization and
    cleanup of dangling numeric symbols."""

    _REPLACERS = [
        # common contractions
        (r"\bwon't\b", "will not"), (r"\bcan't\b", "can not"),
        (r"\blet's\b", "let us"), (r"\bain't\b", "aint"),
        (r"\by'all\b", "you all"), (r"\bwanna\b", "want to"),
        (r"\bgotta\b", "got to"), (r"\bgonna\b", "going to"),
        (r"\bi'ma\b", "i am going to"), (r"\bimma\b", "i am going to"),
        (r"\bwoulda\b", "would have"), (r"\bcoulda\b", "could have"),
        (r"\bshoulda\b", "should have"), (r"\bma'am\b", "madam"),
        # titles/prefixes (trailing space is part of the protocol output)
        (r"\bmr\b", "mister "), (r"\bmrs\b", "missus "),
        (r"\bst\b", "saint "), (r"\bdr\b", "doctor "),
        (r"\bprof\b", "professor "), (r"\bcapt\b", "captain "),
        (r"\bgov\b", "governor "), (r"\bald\b", "alderman "),
        (r"\bgen\b", "general "), (r"\bsen\b", "senator "),
        (r"\brep\b", "representative "), (r"\bpres\b", "president "),
        (r"\brev\b", "reverend "), (r"\bhon\b", "honorable "),
        (r"\basst\b", "assistant "), (r"\bassoc\b", "associate "),
        (r"\blt\b", "lieutenant "), (r"\bcol\b", "colonel "),
        (r"\bjr\b", "junior "), (r"\bsr\b", "senior "),
        (r"\besq\b", "esquire "),
        # perfect tenses
        (r"'d been\b", " had been"), (r"'s been\b", " has been"),
        (r"'d gone\b", " had gone"), (r"'s gone\b", " has gone"),
        (r"'d done\b", " had done"), (r"'s got\b", " has got"),
        # general contractions
        (r"n't\b", " not"), (r"'re\b", " are"), (r"'s\b", " is"),
        (r"'d\b", " would"), (r"'ll\b", " will"), (r"'t\b", " not"),
        (r"'ve\b", " have"), (r"'m\b", " am"),
    ]

    def __init__(self):
        self.ignore_patterns = r"\b(hmm|mm|mhm|mmm|uh|um)\b"
        self.standardize_numbers = EnglishNumberNormalizer()
        self.standardize_spellings = EnglishSpellingNormalizer()

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)   # bracketed words
        s = re.sub(r"\(([^)]+?)\)", "", s)        # parenthesized words
        s = re.sub(self.ignore_patterns, "", s)   # hesitation fillers
        s = re.sub(r"\s+'", "'", s)               # space before apostrophe

        for pattern, replacement in self._REPLACERS:
            s = re.sub(pattern, replacement, s)

        s = re.sub(r"(\d),(\d)", r"\1\2", s)      # digit-group commas
        s = re.sub(r"\.([^0-9]|$)", r" \1", s)    # non-decimal periods
        s = remove_symbols_and_diacritics(s, keep=".%$¢€£")

        s = self.standardize_numbers(s)
        s = self.standardize_spellings(s)

        # numeric symbols not attached to digits become spaces
        s = re.sub(r"[.$¢€£]([^0-9])", r" \1", s)
        s = re.sub(r"([^0-9])%", r"\1 ", s)

        return re.sub(r"\s+", " ", s)
