"""Randomized stream parity: every stream surface vs the single-stream
oracle, byte for byte.

The round-4 interior-EOT epilogue bug survived three rounds of
scenario-based tests because no test composed RANDOM streams with
adversarial EOT placement (doubled EOTs, EOT after backtick-like
ignorables, streams with/without trailing EOT, empty documents).  This
fuzz closes that class: seeded random streams through
``tokenize_stream``, ``tokenize_stream_pipelined`` and
``tokenize_reader`` (several chunk sizes) must all equal
``tok.tokenize`` on the concatenated stream.
"""

import io
import random

import pytest

import datok as dt
from datok.runtime.jax_engine import BatchEngine
from datok.runtime.overlap import tokenize_stream_pipelined
from datok.runtime.pipeline import tokenize_reader, tokenize_stream

WORDS = [
    "Der", "alte", "Mann", "z.B.", "Weststr.", "bzw.", "wikipedia.org",
    "korap@ids-mannheim.de", "5.9.2018", "50,4%", "D'dorf", "Mach's",
    "müde", "Straße", "`", "``x", "...", "!!!", "(2018)", "&quot;",
    "verf*****", "T__T", ";)", "readme.txt", "ver.di", "a", "--",
]
SEPS = [" ", "  ", "\n", ". ", "! ", "? ", ", ", ": ", "\t"]


def _random_stream(rng: random.Random) -> str:
    parts = []
    for _ in range(rng.randint(1, 7)):  # documents
        n = rng.randint(0, 18)
        doc = "".join(
            rng.choice(WORDS) + rng.choice(SEPS) for _ in range(n)
        )
        if rng.random() < 0.3:
            doc += rng.choice(["`", "` ", "x`", ""])
        parts.append(doc)
        # EOT placement: none (last doc may be unterminated), single,
        # or doubled (empty document)
        r = rng.random()
        if r < 0.7:
            parts.append("\x04")
        elif r < 0.85:
            parts.append("\x04\x04")
    text = "".join(parts)
    if rng.random() < 0.5 and text.endswith("\x04"):
        text = text[:-1]  # unterminated tail
    return text


@pytest.fixture(scope="module")
def simple_eng():
    from datok.fsa.synth import model_path

    tok = dt.load_matrix_file(model_path("synth_simple"))
    return tok, BatchEngine(tok)


@pytest.fixture(scope="module")
def de_eng(mat_de):
    return mat_de, BatchEngine(mat_de, engine="general")


WORDS_EN = [
    "Don't", "they're", "we'll've", "Mr.", "Smith's", "U.S.A.",
    "isn't", "Jan.", "3rd", "approx.", "50.4%", "info@example.org",
    "won't", "cats,", "etc.", "$4.50", "`", "--",
]


@pytest.mark.parametrize("seed", range(3))
def test_stream_surfaces_fuzz_en(mat_en, seed):
    eng = BatchEngine(mat_en, engine="general")
    rng = random.Random(7000 + seed)
    for case in range(3):
        text = "".join(
            "".join(
                rng.choice(WORDS_EN) + rng.choice(SEPS)
                for _ in range(rng.randint(0, 14))
            )
            + ("\x04" if rng.random() < 0.8 else "")
            for _ in range(rng.randint(1, 5))
        )
        want = mat_en.tokenize(text)
        assert tokenize_stream(mat_en, text, engine=eng).getvalue() == want
        got_r = tokenize_reader(
            mat_en, io.BytesIO(text.encode()), engine=eng,
            chunk_bytes=rng.choice([9, 1 << 14]),
        ).getvalue()
        assert got_r == want, (seed, case, repr(text[:80]))


@pytest.mark.parametrize("model", ["de", "simple"])
@pytest.mark.parametrize("seed", range(6))
def test_stream_surfaces_fuzz(model, seed, de_eng, simple_eng):
    tok, eng = de_eng if model == "de" else simple_eng
    rng = random.Random(1000 * seed + (0 if model == "de" else 1))
    for case in range(4):
        text = _random_stream(rng)
        want = tok.tokenize(text)
        got_s = tokenize_stream(tok, text, engine=eng).getvalue()
        assert got_s == want, (model, seed, case, "tokenize_stream",
                               repr(text[:80]))
        pack = rng.choice([0, 64])
        got_p = tokenize_stream_pipelined(
            tok, text, engine=eng, lanes=rng.choice([3, 8, 64]),
            pack_len=pack,
        ).getvalue()
        assert got_p == want, (model, seed, case, "pipelined", pack,
                               repr(text[:80]))
        chunk = rng.choice([5, 37, 1 << 14])
        got_r = tokenize_reader(
            tok, io.BytesIO(text.encode()), engine=eng,
            chunk_bytes=chunk,
        ).getvalue()
        assert got_r == want, (model, seed, case, "reader", chunk,
                               repr(text[:80]))
        # position flags: offsets reset per text end — interior-EOT
        # cuts must not disturb the position arithmetic
        flags = (dt.TOKENS | dt.SENTENCES | dt.TOKEN_POS
                 | dt.SENTENCE_POS)
        want_pos = tok.tokenize(text, flags)
        wp = dt.TokenWriter(flags)
        got_pos = tokenize_stream(
            tok, text, writer=wp, engine=eng
        ).getvalue()
        assert got_pos == want_pos, (model, seed, case, "positions",
                                     repr(text[:80]))
