"""Streaming reader transduce (the reference's io.Reader surface,
matrix.go:348): chunked processing must be byte-identical to the
whole-string transduce for every chunk size, including chunk cuts
inside multi-byte UTF-8 sequences, inside tokens, and right at EOT."""

import io

import pytest

import datok as dt
from datok.runtime.oracle import transduce, transduce_reader
from datok.runtime.writer import (
    NEWLINE_AFTER_EOT, SENTENCE_POS, SENTENCES, SIMPLE, TOKEN_POS, TOKENS,
    TokenWriter,
)

TEXTS = [
    "",
    "\n",
    "Der alte Mann.",
    "Der Vorsitzende der Abk. hat gewählt. Gefunden auf wikipedia.org.",
    "Erste.\n\n\n\n\x04\x0aNächst.\x04",
    "Ein Satz. Noch einer! Und \x04 noch einer?\x04",
    "tree.\x04abc\x04\x04",
    "  wald   gehen Da kann\t man was \"erleben\"!",
    "Emoji: 😀 und Pfeile → ← ok? Ä ö ü ß.",
    "korap@ids-mannheim.de und https://korap.ids-mannheim.de/?q=Baum",
    "a" * 900 + ". Ende.",
    "Mach's macht's was'n ist's haste willste kannste biste kriegste.",
]


@pytest.mark.parametrize("chunk", [1, 2, 3, 7, 64, 1 << 16])
def test_reader_matches_string_text_mode(mat_de, chunk):
    for text in TEXTS:
        want = transduce(mat_de, text)
        got = transduce_reader(mat_de, io.StringIO(text), chunk_size=chunk)
        assert got == want, (chunk, repr(text[:40]))


@pytest.mark.parametrize("chunk", [1, 2, 3, 7, 64])
def test_reader_matches_string_binary_mode(mat_de, chunk):
    # byte-size chunks cut inside UTF-8 sequences; the incremental
    # decoder must carry partial sequences across chunks
    for text in TEXTS:
        want = transduce(mat_de, text)
        raw = text.encode("utf-8")
        got = transduce_reader(mat_de, io.BytesIO(raw), chunk_size=chunk)
        assert got == want, (chunk, repr(text[:40]))


@pytest.mark.parametrize(
    "flags",
    [
        SIMPLE,
        TOKENS,
        SENTENCES,
        TOKENS | SENTENCES | TOKEN_POS,
        TOKENS | SENTENCES | TOKEN_POS | SENTENCE_POS,
        TOKEN_POS | SENTENCE_POS,
        TOKENS | SENTENCES | TOKEN_POS | NEWLINE_AFTER_EOT,
    ],
)
def test_reader_flag_parity(mat_de, flags):
    # positions accumulate statefully in the writer; chunk cuts must
    # not disturb the offset arithmetic (token_writer.go:59-127)
    text = "This.\x0a\x04And.\n\x04\n Der Mann aß z.B. 3,5 Äpfel! Echt?\x04"
    w1 = TokenWriter(flags)
    transduce(mat_de, text, w1)
    w1.flush()
    for chunk in (1, 3, 9):
        w2 = TokenWriter(flags)
        transduce_reader(
            mat_de, io.BytesIO(text.encode()), writer=w2, chunk_size=chunk
        )
        assert w2.getvalue() == w1.getvalue(), (flags, chunk)


def test_reader_bounded_carry(mat_de):
    # a long normal text must not accumulate an unbounded tail: feed a
    # repetitive document through tiny chunks and just check output
    # parity (memory boundedness is structural: the tail resets at
    # every rewind checkpoint)
    text = ("Der alte Mann ging zur Weststr. 3. " * 200) + "Ende.\x04"
    want = transduce(mat_de, text)
    got = transduce_reader(mat_de, io.StringIO(text), chunk_size=64)
    assert got == want


def test_reader_english_clitics(mat_en):
    text = "They don't say it's o'clock. I'm sure we're fine!"
    want = transduce(mat_en, text)
    got = transduce_reader(mat_en, io.BytesIO(text.encode()), chunk_size=5)
    assert got == want
