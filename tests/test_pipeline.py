"""Stream pipeline: EOT-split lane parallelism must be byte-exact."""

import pytest

import datok as dt
from datok.runtime.pipeline import (
    eot_split_safe,
    split_documents,
    tokenize_stream,
)
from datok.runtime.writer import TOKEN_POS, TokenWriter


def test_split_documents():
    assert split_documents("a\x04b\x04c") == ["a\x04", "b\x04", "c"]
    assert split_documents("abc") == ["abc"]
    assert split_documents("") == [""]
    # EOT-terminated streams gain the empty epilogue-sentinel chunk
    # (documents ending in EOT run as cuts; the stream-final epilogue
    # runs in the sentinel) — "".join stays the identity either way
    assert split_documents("\x04") == ["\x04", ""]
    assert split_documents("a\x04b\x04") == ["a\x04", "b\x04", ""]
    assert split_documents("\x04", epilogue_sentinel=False) == ["\x04"]


def test_eot_split_safe(mat_de, dat_de):
    # The DE model consumes EOT as an ignorable char from whitespace-
    # class states (targets 2/18271/18335, e.g. after a backtick), so
    # the static root-return property does NOT hold — the pipeline must
    # verify exit states and chain-repair instead.
    assert not eot_split_safe(mat_de)
    assert not eot_split_safe(dat_de)


STREAMS = [
    "Erste.\n\x04Zweite hier!\x04 Dritte?\x04",
    "A.\x04B ohne Ende",
    "\x04\x04",
    "Der alte Mann. Ging am 5.9.2018 zur Weststr. 3.\x04readme.txt fertig!\x04",
    # non-root exit after EOT (backtick leaves a whitespace-class
    # state; EOT is consumed as ignorable) — exercises chain repair
    "ab `\x04cd ef\x04gh",
    "x`\x04`y\x04z",
]


@pytest.mark.parametrize("stream", STREAMS)
def test_stream_matches_oracle(mat_de, stream):
    w = tokenize_stream(mat_de, stream)
    assert w.getvalue() == mat_de.tokenize(stream)


def test_stream_positions_across_texts(mat_de):
    stream = "This.\x0a\x04And.\n\x04\n"
    w = TokenWriter(dt.TOKENS | dt.SENTENCES | TOKEN_POS)
    tokenize_stream(mat_de, stream, w)
    assert w.getvalue() == "This\n.\n\n0 4 4 5\nAnd\n.\n\n0 3 3 4\n"


def test_cli_convert_and_tokenize(tmp_path, capsys):
    from datok.cli import main

    from conftest import require_reference

    out = tmp_path / "st.matok"
    fst = require_reference("simpletok.fst") + "/simpletok.fst"
    rc = main(["convert", "-i", fst, "-o", str(out)])
    assert rc == 0

    inp = tmp_path / "in.txt"
    inp.write_text("Der alte Mann.")
    capsys.readouterr()
    rc = main(["tokenize", "-t", str(out), str(inp)])
    assert rc == 0
    assert capsys.readouterr().out == "Der\nalte\nMann\n.\n\n\n"


def test_cli_malformed_files_exit_cleanly(tmp_path, capsys):
    """Bad model/foma files: one clean stderr line + nonzero exit, no
    traceback (reference logs and returns nil — fomafile.go:158-165,
    datok.go:645-663)."""
    import gzip

    from datok.cli import main

    bad = tmp_path / "bad.matok"
    bad.write_bytes(b"not a gzip file at all")
    rc = main(["tokenize", "-t", str(bad), "-"])
    err = capsys.readouterr().err
    assert rc == 1 and err.startswith("datok: error:")

    # gzip, but wrong magic
    wrong = tmp_path / "wrong.matok"
    with gzip.open(wrong, "wb") as f:
        f.write(b"BOGUS data here")
    rc = main(["tokenize", "-t", str(wrong), "-"])
    err = capsys.readouterr().err
    assert rc == 1 and "error" in err

    # missing file
    rc = main(["tokenize", "-t", str(tmp_path / "nope.matok"), "-"])
    assert rc == 1

    # malformed foma input to convert
    badfst = tmp_path / "bad.fst"
    with gzip.open(badfst, "wb") as f:
        f.write(b"##foma-net 1.0##\n##props##\nnot numbers\n")
    rc = main(["convert", "-i", str(badfst), "-o", str(tmp_path / "o.matok")])
    err = capsys.readouterr().err
    assert rc == 1 and err.startswith("datok: error:")


def test_long_document_segmentation(mat_de, monkeypatch):
    import datok.runtime.oracle as O
    from datok.runtime.jax_engine import BatchEngine
    from datok.runtime.oracle import transduce_events
    from datok.runtime.pipeline import events_long_batch

    # only the pathological all-x document may take the host fallback —
    # everything else must chain on device (guards against the batch
    # silently degrading to the exact-but-host path)
    host_docs = []
    orig_fast = O.transduce_events_fast
    def spy_fast(tok, text, *a, **k):
        host_docs.append(text[:8])
        return orig_fast(tok, text, *a, **k)
    monkeypatch.setattr(O, "transduce_events_fast", spy_fast)
    # the host fallback routes through transduce_doc_exact, which uses
    # pipeline's module-level import binding — patch that one too
    import datok.runtime.pipeline as P

    monkeypatch.setattr(P, "transduce_events_fast", spy_fast)

    eng = BatchEngine(mat_de)
    base = (
        "Der Vorsitzende der Abk. hat z.B. gewählt. Bald darauf folgte, "
        'laut "Bericht", die 2. Wahl am 5.9.2018 auf wikipedia.org!\n'
    )
    docs = [
        base * 40,                        # ~5 KB, segments chained
        "Der alte Mann. " * 300,
        base[:300],                        # shorter than one segment
        "x" * 2500 + " kurz.",            # token spanning segments → fallback
        "A\x04" + base * 20 + "\x04Ende.",  # EOTs inside a long doc
    ]
    evs, exits = events_long_batch(eng, docs, seg_len=1024)
    for d, e in zip(docs, evs):
        assert e == transduce_events(mat_de, d), len(d)
    assert host_docs == ["xxxxxxxx"], host_docs


def test_oracle_rewind_checkpoints_resume_exactly(mat_de):
    """Any recorded rewind checkpoint is an exact resume point."""
    from datok.runtime.oracle import transduce_events

    text = (
        "Der alte Mann ging, z.B. am 5.9.2018, zur Weststr. 3! "
        'Müller sagte: "Gut." \x04Und weiter geht es hier.'
    )
    rw = []
    full = transduce_events(mat_de, text, rewinds_box=rw)
    assert rw[0] == (0, 1, 0)
    pos_seen = [p for p, _, _ in rw]
    assert pos_seen == sorted(set(pos_seen)), "rewind positions must strictly increase"
    for pos, ctx, nev in rw:
        tail = transduce_events(mat_de, text, entry_state=ctx, start=pos)
        assert full[nev:] == tail, (pos, ctx)


def test_oracle_cut_walk_stops_cleanly(mat_de):
    from datok.runtime.oracle import transduce_events

    text = "Der alte Mann. Ging weiter."
    full = transduce_events(mat_de, text)
    rw = []
    pre = transduce_events(mat_de, text, stop_at=15, rewinds_box=rw)
    # stopping mid-stream emits exactly the events of completed rewinds
    assert pre == full[: len(pre)]
    assert all(p <= 15 for p, _, _ in rw)


def test_speculative_segmentation(mat_de, monkeypatch):
    import datok.runtime.pipeline as P
    from datok.runtime.jax_engine import BatchEngine
    from datok.runtime.oracle import transduce_events
    from datok.runtime.pipeline import events_speculative_batch

    # guard against the whole batch silently degrading to the chained/
    # host fallback (which would make this test vacuous): only the
    # pathological all-x document may fall back
    fallbacks = []
    orig_chained = P.events_long_batch
    monkeypatch.setattr(
        P,
        "events_long_batch",
        lambda engine, docs, seg_len=8192, entries=None, **kw: (
            fallbacks.extend(d[:8] for d in docs),
            orig_chained(
                engine, docs, seg_len=seg_len, entries=entries, **kw
            ),
        )[1],
    )

    eng = BatchEngine(mat_de)
    base = (
        "Der Vorsitzende der Abk. hat z.B. gewählt. Bald darauf folgte, "
        'laut "Bericht", die 2. Wahl am 5.9.2018 auf wikipedia.org!\n'
    )
    ascii_run = "Ein Mann geht am Tag zur Wahl und waehlt die Liste Nr. 7. "
    docs = [
        base * 40,                         # ~5 KB, many cuts
        "Der alte Mann. " * 300,
        base[:300],                        # single segment
        "x" * 2500 + " kurz.",             # token spans segments → fallback
        "A\x04" + base * 20 + "\x04Ende.",  # EOTs inside a long doc
        # stale-ok exactness: one known non-ASCII char, then pure ASCII
        "Müller. " + ascii_run * 60,
        # stale-ok with an *unknown* non-ASCII char (identity path)
        "ᛄ " + ascii_run * 60,
        ascii_run * 60,                    # never any non-ASCII
    ]
    assert "ᛄ" not in map(chr, mat_de.sigma)  # fixture sanity
    evs, exits = events_speculative_batch(eng, docs, seg_len=1024)
    for d, e in zip(docs, evs):
        assert e == transduce_events(mat_de, d), d[:40]
    assert fallbacks == ["xxxxxxxx"], fallbacks


def test_speculative_matches_chained_exit_contexts(mat_de):
    from datok.runtime.jax_engine import BatchEngine
    from datok.runtime.pipeline import (
        events_long_batch,
        events_speculative_batch,
    )

    eng = BatchEngine(mat_de)
    docs = ["Ein Satz. " * 500, "Wort `", "Zwei Sätze hier. " * 200]
    ev_s, ex_s = events_speculative_batch(eng, docs, seg_len=1024)
    ev_c, ex_c = events_long_batch(eng, docs, seg_len=1024)
    assert ev_s == ev_c
    assert list(ex_s) == list(ex_c)


def test_stream_speculative_strategy(mat_de):
    base = "Ein Satz mit Wörtern und z.B. Abkürzungen bzw. Zahlen wie 3,5 Mio. "
    stream = (base * 600) + "\x04" + (base * 3) + "\x04kurz"
    w = tokenize_stream(mat_de, stream, long_strategy="speculative")
    assert w.getvalue() == mat_de.tokenize(stream)


def test_stream_with_long_docs(mat_de):
    base = "Ein Satz mit Wörtern und z.B. Abkürzungen bzw. Zahlen wie 3,5 Mio. "
    stream = (base * 600) + "\x04" + (base * 3) + "\x04kurz"
    from datok.runtime.jax_engine import BatchEngine

    w = tokenize_stream(mat_de, stream)
    assert w.getvalue() == mat_de.tokenize(stream)
