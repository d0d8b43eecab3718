"""The port's text normalisers (`eval/normalizers.py`) against the JAX
package's: every case of tests/test_normalizers.py on both packages'
functions, then a table of strings on which every public function of the
two gives equal outputs, and a spelling-mapping file read through
$WHISPER_TPU_SPELLING."""

import json

import pytest

from openai_whisper_coreml_tpu.eval import normalizers as jn
from openai_whisper_coreml_tpu.eval import wer as jwer
from openai_whisper_coreml_tpu_torch.eval import normalizers as tn
from openai_whisper_coreml_tpu_torch.eval import wer as twer

BOTH = [pytest.param((jn, jwer), id="jax"), pytest.param((tn, twer), id="torch")]


# -- tests/test_normalizers.py, on both packages ------------------------------

@pytest.mark.parametrize("pkg", BOTH)
@pytest.mark.parametrize("inp,out", [
    ("two", "2"),
    ("thirty one", "31"),
    ("five twenty four", "524"),
    ("nineteen ninety nine", "1999"),
    ("twenty nineteen", "2019"),
    ("one point five", "1.5"),
    ("three point one four", "3.14"),
    ("two point five million", "2500000"),
    ("four point two percent", "4.2%"),
    ("fifty thousand", "50000"),
    ("one hundred and five", "105"),
    ("six hundred and sixty six", "666"),
    ("ten thousand three hundred", "10300"),
    ("minus five hundred", "-500"),
    ("double oh seven", "007"),
    ("nineteen oh five", "1905"),
    ("twenty first", "21st"),
    ("third", "3rd"),
    ("hundredth", "100th"),
    ("the nineteen seventies", "the 1970s"),
    ("five dollars", "$5"),
    ("one dollar", "$1"),
    ("five dollars and seventy cents", "$5.70"),
    ("seventy cents", "¢70"),
    ("zero point five", "0.5"),
    ("one and a half", "1.5"),
    ("a hundred", "100"),
    ("nineteen hundred", "1900"),
    ("one million", "1000000"),
    ("two thousand and one", "2001"),
    ("one percent", "1%"),
    ("he was born in nineteen sixty four", "he was born in 1964"),
])
def test_number_normalizer(pkg, inp, out):
    assert pkg[0].EnglishNumberNormalizer()(inp) == out


@pytest.mark.parametrize("pkg", BOTH)
def test_number_normalizer_leaves_prose_alone(pkg):
    num = pkg[0].EnglishNumberNormalizer()
    assert num("oh say can you see") == "oh say can you see"
    assert num("I have one brother") == "I have one brother"
    assert num("the ones that matter") == "the ones that matter"
    assert num("a cat and a dog") == "a cat and a dog"


@pytest.mark.parametrize("pkg", BOTH)
@pytest.mark.parametrize("inp,out", [
    ("colour", "color"), ("colours", "colors"), ("organise", "organize"),
    ("organisation", "organization"), ("centre", "center"),
    ("theatre", "theater"), ("analyse", "analyze"), ("litre", "liter"),
    ("metre", "meter"), ("fibre", "fiber"), ("sombre", "somber"),
    ("favourite", "favorite"), ("catalogue", "catalog"),
    ("neighbour", "neighbor"), ("behaviour", "behavior"),
    ("defence", "defense"), ("travelling", "traveling"),
    # non-British lookalikes stay put
    ("rise", "rise"), ("hour", "hour"), ("there", "there"),
    ("surprise", "surprise"), ("exercise", "exercise"), ("tour", "tour"),
    ("genre", "genre"), ("acre", "acre"),
])
def test_spelling_normalizer(pkg, inp, out, monkeypatch):
    monkeypatch.delenv("WHISPER_TPU_SPELLING", raising=False)
    assert pkg[0].EnglishSpellingNormalizer()(inp) == out


@pytest.mark.parametrize("pkg", BOTH)
def test_english_text_normalizer_pipeline(pkg):
    et = pkg[0].EnglishTextNormalizer()
    assert et("Mr. Brown won't pay $1,000 for the colour TV.") == \
        "mister brown will not pay $1000 for the color tv"
    assert et("It's twenty twenty-five and they're here!") == \
        "it is 2025 and they are here"
    assert et("I can't do [noise] that (laughs)") == "i can not do that"
    assert et("Let's meet at three thirty") == "let us meet at 330"
    assert et("um, I guess they've been, uh, busy") == \
        "i guess they have been busy"
    assert et("she'd gone by noon") == "she had gone by noon"


@pytest.mark.parametrize("pkg", BOTH)
def test_basic_normalizer_diacritics(pkg):
    b = pkg[0].BasicTextNormalizer(remove_diacritics=True)
    assert b("Héllo, wörld!") == "hello world"


@pytest.mark.parametrize("pkg", BOTH)
def test_wer_uses_english_normalizer(pkg):
    r = pkg[1].compute_wer(["Mister Brown paid one thousand dollars."],
                           ["mr. brown paid $1,000"])
    assert r.wer == 0.0


@pytest.mark.parametrize("pkg", BOTH)
def test_digit_tokens_with_decimal_and_currency_scale_multipliers(pkg):
    n = pkg[0].EnglishNumberNormalizer()
    assert n("1.5 million") == "1500000"
    assert n("$10 million") == "$10000000"
    assert n("$1.5 billion") == "$1500000000"
    assert n("50.5 percent") == "50.5%"
    assert n("$10 dollars") == "$10"


@pytest.mark.parametrize("pkg", BOTH)
def test_and_joins_numbers_only_after_multipliers(pkg):
    n = pkg[0].EnglishNumberNormalizer()
    assert n("one and two") == "one and 2"
    assert n("sixty and five") == "60 and 5"
    assert n("one hundred and five") == "105"
    assert n("two thousand and eight") == "2008"


@pytest.mark.parametrize("pkg", BOTH)
def test_ise_keep_covers_inflections(pkg):
    e = pkg[0].EnglishTextNormalizer()
    for w in ("promised", "surprised", "praised", "advising", "exercised",
              "promises"):
        assert e(w) == w, w
    assert e("organised") == "organized"
    assert e("realising") == "realizing"


@pytest.mark.parametrize("pkg", BOTH)
def test_ligatures_and_split_letters(pkg):
    assert pkg[0].remove_symbols_and_diacritics("søren œuvre straße") == \
        "soren oeuvre strasse"
    assert pkg[0].BasicTextNormalizer(split_letters=True)("héllo") == "h é l l o"


# -- equal outputs on a table of strings --------------------------------------

TABLE = [
    # numbers, decimals, fractions, scales, signs
    "zero", "one", "eleven", "twenty", "ninety nine", "one hundred",
    "three hundred and twelve", "four thousand", "seven thousand and ten",
    "two million three hundred thousand", "one billion", "twelve point five",
    "point five", "minus twelve", "negative three point two",
    "one and a quarter", "three and a half million", "two thirds",
    "a half", "one oh one", "oh oh seven", "triple five", "double two",
    "ten twenty thirty", "eighty eighty", "1,000,000", "3.14159",
    "12 thousand", "1.25 billion", "2 and a half", "42", "007",
    "nineteen eighty four", "two thousand twenty", "twenty twenty two",
    "nineteen oh one", "the year two thousand", "sixteen hundreds",
    # ordinals and decades
    "first", "second", "twelfth", "twentieth", "thirty third",
    "one hundred and first", "millionth", "the twenties",
    "the nineteen eighties", "the eighteen nineties", "the fifties",
    "the sixties and seventies", "1st 2nd 3rd 4th", "the 1990s",
    # currency and percents
    "ten dollars", "a dollar", "one dollar and one cent", "fifty cents",
    "twenty pounds", "five pounds and ten pence", "three euros",
    "two point five percent", "one hundred percent", "$3.50",
    "£20", "€5", "¢99", "45%", "50 per cent", "$1,234.56",
    "a million dollars", "half a million pounds",
    # British spellings and lookalikes
    "The colour of the theatre centre", "He apologised to his neighbours",
    "catalogue of behaviours", "litres and metres", "travelling defence",
    "organisational analysis", "favourite flavour", "grey tyres on the kerb",
    "the plough and the mould", "realise, recognise, criticise",
    "advise the wise", "surprise exercise", "humour and honour",
    "paralysed analyser", "dialogue monologue", "programme centre",
    # diacritics and ligatures
    "Héllo wörld", "Café naïve façade", "Crème brûlée", "søren kierkegaard",
    "Œuvre of Æsop", "Straße", "Łódź", "Þórr", "São Paulo", "Ångström",
    "ﬁne ﬂour", "Ǆemal",
    # brackets, annotations, punctuation, contractions, fillers
    "I can't [inaudible] hear (laughter) you", "<unk> token here",
    "He said (quietly) no", "[MUSIC] playing", "well... um, okay?!",
    "won't, can't, shouldn't", "y'all ain't", "it's Mrs. Smith & Dr. Jones",
    "St. Louis vs. Chicago", "Mr Jones' dog", "they'd've", "hmm uh mm-hmm",
    "hyphen-ated words", "quote \"this\" please", "email@example.com",
    "3:45 pm", "24/7", "#hashtag and @mention", "“smart quotes” ‘here’",
    "em—dash and en–dash", "tab\tand\nnewline", "  spaces   everywhere  ",
    "MiXeD CaSe", "", "...", "A.B.C.", "x-ray 2.0",
]


@pytest.mark.parametrize("text", TABLE)
def test_normalizers_equal_jax(text, monkeypatch):
    monkeypatch.delenv("WHISPER_TPU_SPELLING", raising=False)
    assert tn.remove_symbols_and_diacritics(text) == \
        jn.remove_symbols_and_diacritics(text)
    assert tn.remove_symbols(text) == jn.remove_symbols(text)
    for kw in ({}, {"remove_diacritics": True}, {"split_letters": True}):
        assert tn.BasicTextNormalizer(**kw)(text) == jn.BasicTextNormalizer(**kw)(text)
    assert tn.EnglishNumberNormalizer()(text) == jn.EnglishNumberNormalizer()(text)
    assert tn.EnglishSpellingNormalizer()(text) == jn.EnglishSpellingNormalizer()(text)
    assert tn.EnglishTextNormalizer()(text) == jn.EnglishTextNormalizer()(text)
    for lang in ("en", None, "fr"):
        assert twer.normalize_text(text, lang) == jwer.normalize_text(text, lang)


def test_table_has_at_least_a_hundred_strings():
    assert len(set(TABLE)) == len(TABLE) >= 100


def test_spelling_mapping_file_from_env(tmp_path, monkeypatch):
    """A mapping file named by $WHISPER_TPU_SPELLING replaces the built-in
    rules in both packages, word for word."""
    mapping = {"colour": "color", "aeroplane": "airplane", "organise": "organize"}
    path = tmp_path / "english.json"
    path.write_text(json.dumps(mapping), encoding="utf-8")
    monkeypatch.setenv("WHISPER_TPU_SPELLING", str(path))
    text = "the colour aeroplane will organise a centre"
    ours, ref = tn.EnglishSpellingNormalizer(), jn.EnglishSpellingNormalizer()
    assert ours.mapping == ref.mapping == mapping
    assert ours(text) == ref(text)
    assert "airplane" in ours(text)
    assert tn.EnglishTextNormalizer()(text) == jn.EnglishTextNormalizer()(text)
