"""openai-faithful text normalisers for WER evaluation (port of
`eval/normalizers.py`).

A copy of the JAX package's module, kept line for line: the port cannot
import that one, whose package `__init__` imports jax. The same semantics
as openai/whisper's normalisers, so WER numbers computed by
`eval/harness.py` are comparable to published Whisper results:

  * BasicTextNormalizer — lowercase, strip bracketed annotations, replace
    symbols/diacritics with spaces;
  * EnglishNumberNormalizer — spelled-out numbers -> digits, with year-style
    concatenation ("nineteen ninety nine" -> 1999), decimals ("one point
    five" -> 1.5), ordinals ("twenty first" -> 21st), plural decades
    ("the nineteen seventies" -> the 1970s), digit runs ("double oh seven"
    -> 007), currency ("five dollars seventy cents" -> $5.70) and percents;
  * EnglishSpellingNormalizer — British -> American spellings. openai ships
    this as a 60k-entry JSON data file, which is not in the repository;
    this implementation combines a curated exception table with the
    productive suffix rules (-ise/-ize, -our/-or, -re/-er, -yse/-yze,
    -ogue/-og) and loads the full openai english.json when available
    ($WHISPER_TPU_SPELLING, or this package's eval/assets/english.json)
    for exact parity;
  * EnglishTextNormalizer — the full pipeline: contraction expansion,
    abbreviation expansion, annotation removal, then numbers + spellings.
"""

from __future__ import annotations

import json
import os
import re
import unicodedata
from fractions import Fraction
from typing import Dict, Iterator, List, Optional

# ---------------------------------------------------------------------------
# Basic
# ---------------------------------------------------------------------------

# Letters NFKD cannot decompose (they are letters, not base+combining-mark):
# mapped explicitly so e.g. "søren" -> "soren" as under openai's normalizer
_LIGATURES = {
    "œ": "oe", "Œ": "OE", "ø": "o", "Ø": "O", "æ": "ae", "Æ": "AE",
    "ß": "ss", "ẞ": "SS", "đ": "d", "Đ": "D", "ð": "d", "Ð": "D",
    "þ": "th", "Þ": "th", "ł": "l", "Ł": "L",
}


def remove_symbols_and_diacritics(s: str, keep: str = "") -> str:
    """Replace markers/symbols/punctuation with a space, drop diacritics."""
    out = []
    for c in unicodedata.normalize("NFKD", s):
        if c in keep:
            out.append(c)
        elif c in _LIGATURES:
            out.append(_LIGATURES[c])
        elif unicodedata.category(c) == "Mn":
            continue  # combining mark (diacritic): drop
        elif unicodedata.category(c)[0] in "MSP":
            out.append(" ")
        else:
            out.append(c)
    return "".join(out)


def remove_symbols(s: str) -> str:
    """Replace markers/symbols/punctuation with a space, keep diacritics."""
    return "".join(
        " " if unicodedata.category(c)[0] in "MSP" else c
        for c in unicodedata.normalize("NFKC", s))


class BasicTextNormalizer:
    def __init__(self, remove_diacritics: bool = False,
                 split_letters: bool = False):
        self.clean = (remove_symbols_and_diacritics if remove_diacritics
                      else remove_symbols)
        self.split_letters = split_letters

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)  # remove words between brackets
        s = re.sub(r"\(([^)]+?)\)", "", s)  # remove words between parenthesis
        s = self.clean(s).lower()
        if self.split_letters:
            # \X (grapheme cluster) needs the third-party `regex` module;
            # stdlib re raises "bad escape \X"
            import regex as _regex

            s = " ".join(_regex.findall(r"\X", s, _regex.U))
        return re.sub(r"\s+", " ", s).strip()


# ---------------------------------------------------------------------------
# Numbers
# ---------------------------------------------------------------------------

_ONES = {w: i for i, w in enumerate(
    ["one", "two", "three", "four", "five", "six", "seven", "eight",
     "nine"], start=1)}
_TEENS = {w: i for i, w in enumerate(
    ["ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
     "sixteen", "seventeen", "eighteen", "nineteen"], start=10)}
_TENS = {w: i * 10 for i, w in enumerate(
    ["twenty", "thirty", "forty", "fifty", "sixty", "seventy", "eighty",
     "ninety"], start=2)}
_MULTIPLIERS = {"hundred": 100, "thousand": 10 ** 3, "million": 10 ** 6,
                "billion": 10 ** 9, "trillion": 10 ** 12,
                "quadrillion": 10 ** 15}

_ORDINAL_ONES = {"first": 1, "second": 2, "third": 3, "fourth": 4,
                 "fifth": 5, "sixth": 6, "seventh": 7, "eighth": 8,
                 "ninth": 9}
_ORDINAL_TEENS = {"tenth": 10, "eleventh": 11, "twelfth": 12,
                  "thirteenth": 13, "fourteenth": 14, "fifteenth": 15,
                  "sixteenth": 16, "seventeenth": 17, "eighteenth": 18,
                  "nineteenth": 19}
_ORDINAL_TENS = {"twentieth": 20, "thirtieth": 30, "fortieth": 40,
                 "fiftieth": 50, "sixtieth": 60, "seventieth": 70,
                 "eightieth": 80, "ninetieth": 90}
_ORDINAL_MULTIPLIERS = {"hundredth": 100, "thousandth": 10 ** 3,
                        "millionth": 10 ** 6, "billionth": 10 ** 9,
                        "trillionth": 10 ** 12}
_DECADES = {"twenties": 20, "thirties": 30, "forties": 40, "fifties": 50,
            "sixties": 60, "seventies": 70, "eighties": 80, "nineties": 90}

_CURRENCY = {"dollar": "$", "dollars": "$", "pound": "£", "pounds": "£",
             "euro": "€", "euros": "€"}
_CENTS = {"cent": "¢", "cents": "¢"}

_ZEROS = {"zero": "0", "oh": "0", "o": "0"}


def _ordinal_suffix(n: int) -> str:
    if n % 100 in (11, 12, 13):
        return "th"
    return {1: "st", 2: "nd", 3: "rd"}.get(n % 10, "th")


class EnglishNumberNormalizer:
    """Spelled numbers -> digit strings, matching openai's output format."""

    number_words = (set(_ONES) | set(_TEENS) | set(_TENS) | set(_MULTIPLIERS)
                    | set(_ZEROS) | {"point", "double", "triple", "and",
                                     "minus", "negative", "a", "half"}
                    | set(_ORDINAL_ONES) | set(_ORDINAL_TEENS)
                    | set(_ORDINAL_TENS) | set(_ORDINAL_MULTIPLIERS)
                    | set(_DECADES) | set(_CURRENCY) | set(_CENTS)
                    | {"percent"})

    def __call__(self, s: str) -> str:
        s = self._preprocess(s)
        s = " ".join(self._parse(s.split()))
        return self._postprocess(s)

    # -- pre / post ---------------------------------------------------------

    def _preprocess(self, s: str) -> str:
        # "<number> and a half" -> "<number> point five" when the preceding
        # word really was a number
        parts = re.split(r"\band\s+a\s+half\b", s)
        results: List[str] = []
        for i, segment in enumerate(parts):
            if not segment.strip() and i < len(parts) - 1:
                results.append("and a half")
                continue
            results.append(segment)
            if i < len(parts) - 1:
                last = segment.strip().rsplit(maxsplit=1)
                lw = last[-1] if last else ""
                if lw in _MULTIPLIERS or lw in _ONES or lw in _TEENS \
                        or lw in _TENS or lw.isdigit():
                    results.append("point five")
                else:
                    results.append("and a half")
        s = " ".join(results)
        # space at letter/digit boundaries, but keep ordinal/plural suffixes
        s = re.sub(r"([a-z])([0-9])", r"\1 \2", s)
        s = re.sub(r"([0-9])([a-z])", r"\1 \2", s)
        s = re.sub(r"([0-9])\s+(st|nd|rd|th|s)\b", r"\1\2", s)
        return s

    def _postprocess(self, s: str) -> str:
        def combine_cents(m):
            try:
                currency = m.group(1)
                integer = m.group(2)
                cents = int(m.group(3))
                return f"{currency}{integer}.{cents:02d}"
            except ValueError:
                return m.string[m.start(): m.end()]

        def extract_cents(m):
            try:
                return f"¢{int(m.group(1))}"
            except ValueError:
                return m.string[m.start(): m.end()]

        # "$5 and ¢70" -> "$5.70"
        s = re.sub(r"([€£$])([0-9]+) (?:and )?¢([0-9]{1,2})\b",
                   combine_cents, s)
        s = re.sub(r"[€£$]0\.([0-9]{1,2})\b", extract_cents, s)
        # keep "one(s)" spelled (openai readability rule); guarded so "1.5",
        # "$1", "1%" and digit runs stay numeric
        s = re.sub(r"(?<![0-9.$¢€£])\b1(s?)\b(?![.%0-9])", r"one\1", s)
        return s

    # -- core parser ----------------------------------------------------------

    def _parse(self, words: List[str]) -> Iterator[str]:
        i = 0
        n = len(words)
        while i < n:
            parsed, consumed = self._parse_number(words, i)
            if consumed:
                yield parsed
                i += consumed
            else:
                yield words[i]
                i += 1

    def _starts_number(self, w: str, nxt: Optional[str]) -> bool:
        if (w in _ONES or w in _TEENS or w in _TENS or w in _ZEROS
                or w in _ORDINAL_ONES or w in _ORDINAL_TEENS
                or w in _ORDINAL_TENS or w in _ORDINAL_MULTIPLIERS
                or w in _DECADES):
            return True
        if w in ("minus", "negative", "double", "triple", "a", "hundred"):
            # "a" / bare "hundred" only start a number before a number word
            if w in ("minus", "negative"):
                return nxt is not None and self._starts_number(nxt, None) \
                    or (nxt or "").isdigit()
            if w in ("double", "triple"):
                return nxt in _ONES or nxt in _ZEROS
            if w == "a":
                return nxt in _MULTIPLIERS
            return True  # "hundred"
        if w in _MULTIPLIERS:
            return True
        if re.fullmatch(r"[$€£¥]?[0-9]+(\.[0-9]+)?", w or ""):
            return True
        return False

    def _parse_number(self, words: List[str], start: int):
        """Try to parse a number phrase at `start`; returns (text, consumed).
        consumed == 0 means no number here."""
        i = start
        n = len(words)
        nxt = words[i + 1] if i + 1 < n else None
        if not self._starts_number(words[i], nxt):
            return "", 0

        sign = ""
        if words[i] in ("minus", "negative"):
            sign = "-"
            i += 1
            if i >= n:
                return "", 0

        concat = ""  # year-style / digit-run prefix
        cur = 0  # current accumulating group
        total = 0  # completed multiplier groups
        has_value = False
        decimal = ""  # digits after "point"
        suffix = ""  # ordinal suffix / "s"
        currency_sym = ""  # symbol carried by a "$10"-style digit token
        after_multiplier = False  # last consumed word was hundred/thousand/..
        done = False

        def flush_cur_to_concat():
            nonlocal concat, cur
            if cur:
                concat += str(cur)
            cur = 0

        while i < n and not done:
            w = words[i]
            nxt = words[i + 1] if i + 1 < n else None
            # the "and" branch must see whether the PREVIOUS word was a
            # multiplier; every other branch clears the flag for the next
            # iteration via this shuffle
            was_multiplier, after_multiplier = after_multiplier, False

            digit_tok = re.fullmatch(r"([$€£¥]?)([0-9]+)(?:\.([0-9]+))?", w)
            if digit_tok:
                # plain, decimal, or currency-prefixed digits: "10", "1.5",
                # "$10" — all may be scaled by a following multiplier word
                if has_value:
                    break
                currency_sym = digit_tok.group(1)
                cur = int(digit_tok.group(2))
                has_value = True
                if digit_tok.group(3) is not None:
                    decimal = digit_tok.group(3)
                    i += 1
                    break  # only a multiplier/unit may follow a decimal
            elif w in _ZEROS:
                if w in ("o", "oh") and not (has_value or nxt in _ZEROS
                                             or nxt in _ONES):
                    break  # bare interjection "oh" is not a number
                flush_cur_to_concat()
                concat += "0"
                has_value = True
            elif w == "double" or w == "triple":
                d = None
                if nxt in _ONES:
                    d = str(_ONES[nxt])
                elif nxt in _ZEROS:
                    d = "0"
                if d is None:
                    break
                flush_cur_to_concat()
                concat += d * (2 if w == "double" else 3)
                has_value = True
                i += 1
            elif w == "a":
                if has_value or nxt not in _MULTIPLIERS:
                    break
                cur = 1  # "a hundred", "a million"
            elif w in _ONES:
                o = _ONES[w]
                if cur == 0 and concat:
                    concat += str(o)  # digit-run append: "oh seven" -> 07
                elif cur == 0 or cur % 100 == 0 or (
                        20 <= cur % 100 <= 90 and cur % 10 == 0):
                    cur += o
                else:
                    flush_cur_to_concat()
                    cur = o
                has_value = True
            elif w in _TEENS:
                if cur == 0 or cur % 100 == 0:
                    cur += _TEENS[w]
                else:
                    flush_cur_to_concat()
                    cur = _TEENS[w]
                has_value = True
            elif w in _TENS:
                if cur == 0 or cur % 100 == 0:
                    cur += _TENS[w]
                else:
                    flush_cur_to_concat()
                    cur = _TENS[w]
                has_value = True
            elif w == "hundred":
                cur = max(cur, 1) * 100
                has_value = True
                after_multiplier = True
            elif w in _MULTIPLIERS and w != "hundred":
                total += max(cur, 1) * _MULTIPLIERS[w]
                cur = 0
                has_value = True
                after_multiplier = True
            elif w == "point":
                if not has_value and not (nxt in _ONES or nxt in _ZEROS):
                    break
                j = i + 1
                digits = ""
                while j < n and (words[j] in _ONES or words[j] in _ZEROS):
                    digits += (str(_ONES[words[j]]) if words[j] in _ONES
                               else "0")
                    j += 1
                if not digits:
                    break
                decimal = digits
                has_value = True
                i = j
                break  # a multiplier after the decimal scales the float
                # (handled below); any other word ends the number
            elif w == "and":
                # consume ONLY directly after a multiplier group ("one
                # hundred and five"); "one and two" is two numbers joined
                # by a conjunction, not 12 (openai semantics)
                if was_multiplier and nxt is not None and (
                        nxt in _ONES or nxt in _TEENS or nxt in _TENS
                        or nxt in _ORDINAL_ONES or nxt in _ORDINAL_TEENS
                        or nxt in _ORDINAL_TENS):
                    after_multiplier = True  # still inside the same number
                else:
                    break
            elif w in _ORDINAL_ONES or w in _ORDINAL_TEENS \
                    or w in _ORDINAL_TENS or w in _ORDINAL_MULTIPLIERS:
                val = (_ORDINAL_ONES.get(w) or _ORDINAL_TEENS.get(w)
                       or _ORDINAL_TENS.get(w) or _ORDINAL_MULTIPLIERS[w])
                if w in _ORDINAL_MULTIPLIERS:
                    cur = max(cur, 1) * val
                elif cur == 0 or cur % 100 == 0 or (val < 10 and
                                                    cur % 10 == 0):
                    cur += val
                else:
                    flush_cur_to_concat()
                    cur = val
                num = total + cur
                suffix = _ordinal_suffix(num)
                has_value = True
                done = True
            elif w in _DECADES:
                if cur == 0 or cur % 100 == 0:
                    cur += _DECADES[w]
                else:
                    flush_cur_to_concat()
                    cur = _DECADES[w]
                suffix = "s"
                has_value = True
                done = True
            else:
                break
            i += 1

        if not has_value:
            return "", 0

        # assemble
        int_part = concat + str(total + cur) if concat else str(total + cur)
        if concat and total + cur == 0 and concat:
            int_part = concat  # pure digit run like 007
        text = sign + currency_sym + int_part + (
            ("." + decimal) if decimal else "")

        # trailing unit: percent / currency / cents / multiplier-after-decimal
        consumed_units = 0
        j = i
        if j < n and decimal and words[j] in _MULTIPLIERS:
            value = Fraction(int(int_part) if int_part else 0)
            value += Fraction(int(decimal), 10 ** len(decimal))
            value *= _MULTIPLIERS[words[j]]
            if value.denominator == 1:
                text = sign + currency_sym + str(value.numerator)
            else:
                text = sign + currency_sym + str(float(value))
            j += 1
            consumed_units += 1
        if j < n:
            if words[j] == "percent":
                text = text + "%"
                j += 1
                consumed_units += 1
            elif words[j] in _CURRENCY:
                if not currency_sym:  # "$10 dollars" must not double up
                    text = _CURRENCY[words[j]] + text
                j += 1
                consumed_units += 1
            elif words[j] in _CENTS:
                text = _CENTS[words[j]] + text
                j += 1
                consumed_units += 1
        if suffix:
            text += suffix
        return text, (j - start)


# ---------------------------------------------------------------------------
# Spelling (British -> American)
# ---------------------------------------------------------------------------

_SPELLING_ENV = "WHISPER_TPU_SPELLING"

# curated high-frequency exceptions the suffix rules don't cover or would
# overreach on
_SPELLING_TABLE = {
    "grey": "gray", "tyre": "tire", "tyres": "tires", "kerb": "curb",
    "plough": "plow", "ploughs": "plows", "mould": "mold", "moulds": "molds",
    "moustache": "mustache", "pyjamas": "pajamas", "cheque": "check",
    "cheques": "checks", "gaol": "jail", "draught": "draft",
    "draughts": "drafts", "aluminium": "aluminum", "aeroplane": "airplane",
    "aeroplanes": "airplanes", "storey": "story", "storeys": "stories",
    "sceptic": "skeptic", "sceptical": "skeptical", "grammes": "grams",
    "gramme": "gram", "programme": "program", "programmes": "programs",
    "defence": "defense", "offence": "offense", "licence": "license",
    "pretence": "pretense", "practise": "practice", "practised": "practiced",
    "practising": "practicing", "enrol": "enroll", "enrolment": "enrollment",
    "fulfil": "fulfill", "fulfilment": "fulfillment", "instalment":
    "installment", "skilful": "skillful", "wilful": "willful",
    "jewellery": "jewelry", "woollen": "woolen", "travelling": "traveling",
    "travelled": "traveled", "traveller": "traveler", "travellers":
    "travelers", "labelled": "labeled", "labelling": "labeling",
    "modelling": "modeling", "modelled": "modeled", "cancelled": "canceled",
    "cancelling": "canceling", "counselling": "counseling", "counsellor":
    "counselor", "marvellous": "marvelous", "signalling": "signaling",
    "quarrelling": "quarreling", "grey-haired": "gray-haired",
    "whisky": "whiskey", "ageing": "aging", "artefact": "artifact",
    "artefacts": "artifacts", "encyclopaedia": "encyclopedia",
    "mediaeval": "medieval", "anaemia": "anemia", "anaesthesia":
    "anesthesia", "paediatric": "pediatric", "oesophagus": "esophagus",
    "manoeuvre": "maneuver", "manoeuvres": "maneuvers",
    # -our- derived forms the suffix rule cannot reach
    "favourite": "favorite", "favourites": "favorites",
    "favoured": "favored", "favouring": "favoring",
    "coloured": "colored", "colouring": "coloring",
    "colourful": "colorful", "colourless": "colorless",
    "honoured": "honored", "honouring": "honoring",
    "honourable": "honorable", "neighbouring": "neighboring",
    "neighbourhood": "neighborhood", "neighbourhoods": "neighborhoods",
    "flavoured": "flavored", "flavouring": "flavoring",
    "flavourful": "flavorful", "armoured": "armored",
    "behavioural": "behavioral", "laboured": "labored",
    "labourer": "laborer", "labourers": "laborers",
    "harboured": "harbored", "savoury": "savory", "vigour": "vigor",
    "rigour": "rigor", "rigours": "rigors", "humoured": "humored",
}

# words where -our / -re are NOT British variants
_OUR_KEEP = {"hour", "hours", "our", "ours", "four", "fours", "tour",
             "tours", "pour", "pours", "sour", "flour", "your", "yours",
             "contour", "contours", "velour", "detour", "detours", "devour",
             "devours", "paramour", "troubadour", "dour", "amour"}
# -ise words that are NOT British -ize variants (base forms; inflections are
# matched by reconstructing the stem in _word)
_ISE_KEEP = {"wise", "rise", "arise", "precise", "concise", "paradise",
             "promise", "premise", "surprise", "advise", "devise", "revise",
             "exercise", "franchise", "disguise", "otherwise", "likewise",
             "comprise", "compromise", "demise", "despise", "expertise",
             "improvise", "merchandise", "supervise", "televise", "treatise",
             "sunrise", "praise", "raise", "anise", "chastise", "advertise"}

_RE_KEEP = {"there", "where", "here", "were", "more", "bore", "core", "fore",
            "gore", "lore", "pore", "sore", "store", "score", "shore",
            "snore", "spore", "swore", "tore", "wore", "before", "are",
            "care", "bare", "dare", "fare", "hare", "mare", "pare", "rare",
            "snare", "spare", "square", "stare", "ware", "genre", "acre",
            "ogre", "cadre", "macabre", "mere", "sphere", "severe",
            "sincere", "adhere", "ampere", "austere", "revere", "empire",
            "umpire", "aspire", "entire", "desire", "require", "inquire",
            "acquire"}


class EnglishSpellingNormalizer:
    """British -> American spellings.

    Loads openai's english.json mapping when available (exact parity);
    otherwise applies the curated table + productive suffix rules. The rule
    fallback covers the high-frequency patterns; load the JSON for
    publication-grade WER comparison.
    """

    def __init__(self, mapping_path: Optional[str] = None):
        self.mapping: Dict[str, str] = {}
        path = mapping_path or os.environ.get(_SPELLING_ENV)
        if path is None:
            here = os.path.dirname(os.path.abspath(__file__))
            cand = os.path.join(here, "assets", "english.json")
            path = cand if os.path.exists(cand) else None
        if path and os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                self.mapping = json.load(f)

    def _word(self, w: str) -> str:
        if self.mapping:
            return self.mapping.get(w, w)
        if w in _SPELLING_TABLE:
            return _SPELLING_TABLE[w]
        # -ise/-isation family. The keep-check runs on the reconstructed
        # BASE ("promised" -> stem "promise"), so inflections of excluded
        # words stay untouched too (was: "promised" -> "promized").
        for br, us in (("isation", "ization"), ("isations", "izations"),
                       ("ising", "izing"), ("ised", "ized"), ("iser", "izer"),
                       ("isers", "izers"), ("ises", "izes"), ("ise", "ize")):
            if w.endswith(br) and len(w) > len(br) + 2:
                stem = w[: -len(br)] + "ise"
                if stem in _ISE_KEEP:
                    break  # not a British -ise verb; leave the word alone
                return w[: -len(br)] + us
        for br, us in (("yse", "yze"), ("ysed", "yzed"), ("ysing", "yzing"),
                       ("yses", "yzes")):
            if w.endswith(br) and len(w) > 4:
                return w[: -len(br)] + us
        if w.endswith("our") and w not in _OUR_KEEP and len(w) > 4:
            return w[:-3] + "or"
        if w.endswith("ours") and w[:-1] not in _OUR_KEEP and len(w) > 5:
            return w[:-4] + "ors"
        for br, us in (("ogue", "og"), ("ogues", "ogs")):
            if w.endswith(br) and w[: -len(br)] in (
                    "catal", "dial", "anal", "monol", "epil", "pedag",
                    "prol", "travel"):
                return w[: -len(br)] + us
        # centre/theatre/litre/metre + fibre/calibre/sombre families
        for br, us in (("tre", "ter"), ("tres", "ters"),
                       ("bre", "ber"), ("bres", "bers")):
            if (w.endswith(br) and len(w) > len(br) + 1
                    and w not in _RE_KEEP):
                return w[: -len(br)] + us
        return w

    def __call__(self, s: str) -> str:
        return " ".join(self._word(w) for w in s.split())


# ---------------------------------------------------------------------------
# Full English pipeline
# ---------------------------------------------------------------------------

class EnglishTextNormalizer:
    def __init__(self, spelling_path: Optional[str] = None):
        self.ignore_patterns = r"\b(hmm|mm|mhm|mmm|uh|um)\b"
        self.replacers = {
            # common contractions
            r"\bwon't\b": "will not",
            r"\bcan't\b": "can not",
            r"\blet's\b": "let us",
            r"\bain't\b": "aint",
            r"\by'all\b": "you all",
            r"\bwanna\b": "want to",
            r"\bgotta\b": "got to",
            r"\bgonna\b": "going to",
            r"\bi'ma\b": "i am going to",
            r"\bimma\b": "i am going to",
            r"\bwoulda\b": "would have",
            r"\bcoulda\b": "could have",
            r"\bshoulda\b": "should have",
            r"\bma'am\b": "madam",
            # contractions in titles/prefixes
            r"\bmr\b": "mister ",
            r"\bmrs\b": "missus ",
            r"\bst\b": "saint ",
            r"\bdr\b": "doctor ",
            r"\bprof\b": "professor ",
            r"\bcapt\b": "captain ",
            r"\bgov\b": "governor ",
            r"\bald\b": "alderman ",
            r"\bgen\b": "general ",
            r"\bsen\b": "senator ",
            r"\brep\b": "representative ",
            r"\bpres\b": "president ",
            r"\brev\b": "reverend ",
            r"\bhon\b": "honorable ",
            r"\basst\b": "assistant ",
            r"\bassoc\b": "associate ",
            r"\blt\b": "lieutenant ",
            r"\bcol\b": "colonel ",
            r"\bjr\b": "junior ",
            r"\bsr\b": "senior ",
            r"\besq\b": "esquire ",
            # perfect tenses
            r"'d been\b": " had been",
            r"'s been\b": " has been",
            r"'d gone\b": " had gone",
            r"'s gone\b": " has gone",
            r"'d done\b": " had done",
            r"'s got\b": " has got",
            # general contractions
            r"n't\b": " not",
            r"'re\b": " are",
            r"'s\b": " is",
            r"'d\b": " would",
            r"'ll\b": " will",
            r"'t\b": " not",
            r"'ve\b": " have",
            r"'m\b": " am",
        }
        self.standardize_numbers = EnglishNumberNormalizer()
        self.standardize_spellings = EnglishSpellingNormalizer(spelling_path)

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)
        s = re.sub(r"\(([^)]+?)\)", "", s)
        s = re.sub(self.ignore_patterns, "", s)
        s = re.sub(r"\s+'", "'", s)  # space before apostrophe
        for pattern, replacement in self.replacers.items():
            s = re.sub(pattern, replacement, s)
        s = re.sub(r"(\d),(\d)", r"\1\2", s)  # commas between digits
        s = re.sub(r"\.([^0-9]|$)", r" \1", s)  # periods not before digits
        s = remove_symbols_and_diacritics(s, keep=".%$¢€£")
        s = self.standardize_numbers(s)
        s = self.standardize_spellings(s)
        # prefix/suffix symbols not attached to numbers
        s = re.sub(r"[.$¢€£]([^0-9])", r" \1", s)
        s = re.sub(r"([^0-9])%", r"\1 ", s)
        return re.sub(r"\s+", " ", s).strip()
