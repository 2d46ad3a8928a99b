"""Bounded-memory streaming through the device batch path.

``tokenize_reader`` must be byte-identical to the whole-string
``tokenize_stream``/oracle for every chunk size — including chunks
cutting inside multi-byte UTF-8 sequences, inside tokens, at EOT —
while holding only O(chunk) of the stream (the device analog of
matrix.go:348-371's rewound ring buffer)."""

import io

import pytest

from datok.runtime.jax_engine import BatchEngine
from datok.runtime.pipeline import (
    events_until_checkpoint,
    tokenize_reader,
)
from datok.runtime.writer import TOKEN_POS, TOKENS, SENTENCES, TokenWriter

BASE = (
    "Der Vorsitzende der Abk. hat z.B. gewählt. Bald darauf folgte, "
    'laut "Bericht", die 2. Wahl am 5.9.2018 auf wikipedia.org!\n'
)

STREAMS = [
    "",
    "\x04",
    "Der alte Mann.",
    "Erste.\n\x04Zweite hier!\x04 Dritte?\x04",
    "A.\x04B ohne Ende",
    BASE * 30,                                # long unterminated doc
    (BASE * 12) + "\x04" + (BASE * 9) + "\x04Rest hier",  # mixed
    "ab `\x04cd ef\x04gh",                   # non-root exit after EOT
    "Emoji: 😀 → Ä ö ü ß. " * 40,          # multi-byte heavy
]


@pytest.fixture(scope="module")
def eng(mat_de):
    return BatchEngine(mat_de)


@pytest.mark.parametrize("chunk", [61, 256, 1 << 20])
def test_reader_batch_matches_oracle(mat_de, eng, chunk):
    for stream in STREAMS:
        w = tokenize_reader(
            mat_de,
            io.BytesIO(stream.encode("utf-8")),
            engine=eng,
            chunk_bytes=chunk,
            seg_len=128,
        )
        assert w.getvalue() == mat_de.tokenize(stream), (
            chunk, repr(stream[:40]),
        )


def test_reader_batch_text_mode(mat_de, eng):
    stream = STREAMS[6]
    w = tokenize_reader(
        mat_de, io.StringIO(stream), engine=eng, chunk_bytes=97, seg_len=128
    )
    assert w.getvalue() == mat_de.tokenize(stream)


def test_reader_batch_positions(mat_de, eng):
    stream = "This.\x0a\x04And.\n\x04\n"
    w = TokenWriter(TOKENS | SENTENCES | TOKEN_POS)
    tokenize_reader(
        mat_de, io.StringIO(stream), w, engine=eng, chunk_bytes=3,
        seg_len=128,
    )
    assert w.getvalue() == "This\n.\n\n0 4 4 5\nAnd\n.\n\n0 3 3 4\n"


def test_reader_batch_bounded_tail(mat_de, eng, monkeypatch):
    """The carried tail must reset at every checkpoint flush — observe
    the largest text ever handed to the engine while streaming a long
    unterminated document through small chunks."""
    import datok.runtime.pipeline as P

    seen = []
    orig = P.events_until_checkpoint

    def spy(engine, text, *a, **k):
        seen.append(len(text))
        return orig(engine, text, *a, **k)

    monkeypatch.setattr(P, "events_until_checkpoint", spy)
    stream = BASE * 120  # ~15 KB, no EOT anywhere
    w = tokenize_reader(
        mat_de, io.StringIO(stream), engine=eng, chunk_bytes=1024,
        seg_len=128,
    )
    assert w.getvalue() == mat_de.tokenize(stream)
    assert seen, "checkpoint path never exercised"
    # tail + one chunk, not the whole stream
    assert max(seen) < 4096, max(seen)


def test_events_until_checkpoint_resumes_exactly(mat_de, eng):
    from datok.runtime.oracle import transduce_events

    text = BASE * 20  # multiple segments
    evs, ck_pos, ck_ctx = events_until_checkpoint(
        eng, text, entry=1, seg_len=256
    )
    assert 0 < ck_pos <= len(text)
    tail = transduce_events(mat_de, text, entry_state=ck_ctx, start=ck_pos)
    assert evs + tail == transduce_events(mat_de, text)


def test_events_until_checkpoint_pathological_token(mat_de, eng):
    # one giant pending token: no rewind anywhere — degenerate result
    text = "x" * 2000
    evs, ck_pos, ck_ctx = events_until_checkpoint(
        eng, text, entry=1, seg_len=256
    )
    from datok.runtime.oracle import transduce_events

    tail = transduce_events(mat_de, text, entry_state=ck_ctx, start=ck_pos)
    assert evs + tail == transduce_events(mat_de, text)


def test_cli_batch_streams(tmp_path, capsys):
    from datok.cli import main

    inp = tmp_path / "in.txt"
    text = "Der alte Mann.\x04Und hier!"
    inp.write_text(text)
    from datok.fsa.synth import model_path

    rc = main([
        "tokenize", "-t", model_path("synth_de18k"), "--batch", str(inp),
    ])
    assert rc == 0
    import datok as dt

    tok = dt.load_matrix_file(model_path("synth_de18k"))
    assert capsys.readouterr().out == tok.tokenize(text)
