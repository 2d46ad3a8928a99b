"""TokenWriter output-format parity.

Expectations hand-ported from the reference's token_writer_test.go
(callback-level) and matrix_test.go (flag combinations through the full
runtime, incl. newline-after-EOT offset discounting).
"""

import datok as dt
from datok import (
    NEWLINE_AFTER_EOT,
    SENTENCE_POS,
    SENTENCES,
    SIMPLE,
    TOKEN_POS,
    TOKENS,
    TokenWriter,
)


def test_writer_simple_callbacks():
    # token_writer_test.go:11-32
    w = TokenWriter(SIMPLE)
    w.token(0, "abc")
    w.token(1, "def")
    w.sentence_end(0)
    w.text_end(0)
    w.flush()
    assert w.getvalue() == "abc\nef\n\n\n"


def run(mat, flags, text, writer=None):
    w = writer if writer is not None else TokenWriter(flags)
    dt.transduce(mat, text, w)
    return w


def test_writer_from_options(mat_de):
    # token_writer_test.go:34-108
    w = run(mat_de, TOKENS | SENTENCES | TOKEN_POS, "This.\x0a\x04And.\n\x04\n")
    assert w.getvalue() == "This\n.\n\n0 4 4 5\nAnd\n.\n\n0 3 3 4\n"

    w = run(mat_de, TOKENS | SENTENCES | TOKEN_POS, "\nThis.\x0a\x04\nAnd.\n\x04\n")
    assert w.getvalue() == "This\n.\n\n1 5 5 6\nAnd\n.\n\n1 4 4 5\n"

    w = run(
        mat_de,
        TOKENS | SENTENCES | TOKEN_POS | NEWLINE_AFTER_EOT,
        "\nThis.\x0a\x04\nAnd.\n\x04\n",
    )
    assert w.getvalue() == "This\n.\n\n1 5 5 6\nAnd\n.\n\n0 3 3 4\n"

    w = run(
        mat_de,
        SENTENCES | TOKEN_POS | NEWLINE_AFTER_EOT,
        "\nThis.\x0a\x04\nAnd.\n\x04\n",
    )
    assert w.getvalue() == "\n1 5 5 6\n\n0 3 3 4\n"

    w = run(
        mat_de,
        TOKEN_POS | SENTENCE_POS | NEWLINE_AFTER_EOT,
        "\nThis.\x0a\x04\nAnd.\n\x04\n",
    )
    assert w.getvalue() == "1 5 5 6\n1 6\n0 3 3 4\n0 4\n"

    w = run(mat_de, TOKEN_POS | SENTENCE_POS | NEWLINE_AFTER_EOT, "Tree\n\x04\n")
    assert w.getvalue() == "0 4\n0 4\n"

    w = run(mat_de, TOKEN_POS | SENTENCE_POS | NEWLINE_AFTER_EOT, "Tree.\n\x04\n")
    assert w.getvalue() == "0 4 4 5\n0 5\n"

    w = run(mat_de, SENTENCE_POS | NEWLINE_AFTER_EOT, "\nThis.\x0a\x04\nAnd.\n\x04\n")
    assert w.getvalue() == "1 6\n0 4\n"


def test_writer_state_persists_across_texts(mat_de):
    # The reference reuses one writer across transduce calls; `init`
    # and position state persist (token_writer_test.go:52-66).
    w = TokenWriter(TOKENS | SENTENCES | TOKEN_POS | NEWLINE_AFTER_EOT)
    run(mat_de, None, "This.\x0a\x04", writer=w)
    run(mat_de, None, "\nAnd.\n\x04\n", writer=w)
    assert w.getvalue() == "This\n.\n\n0 4 4 5\nAnd\n.\n\n0 3 3 4\n"


def test_empty_input(mat_de):
    # matrix_test.go:310-314
    assert mat_de.tokenize("") == "\n\n"


def test_eot_without_sentence_end(mat_de):
    # Changes 0.2.2 fix; matrix_test.go:1296-1311
    assert (
        mat_de.tokenize("Erste.\n\n\n\n\x04\x0aNächst.\x04")
        == "Erste\n.\n\n\nNächst\n.\n\n\n"
    )
