"""Corpus runner: resumable manifest processing."""

import json
import os


def test_corpus_runner_resume(mat_de, tmp_path):
    from datok.runtime.corpus import CorpusRunner

    files = []
    for i in range(3):
        p = tmp_path / f"in{i}.txt"
        p.write_text(f"Text {i}. Der alte Mann!\x04Zweiter Satz {i}.")
        files.append(str(p))

    out = tmp_path / "out"
    r = CorpusRunner(mat_de, str(out))
    stats = r.run(files)
    assert (stats["done"], stats["skipped"], stats["total"]) == (3, 0, 3)
    assert stats["bytes_in"] > 0 and stats["bytes_out"] > 0
    for p in files:
        expected = mat_de.tokenize(open(p, encoding="utf-8").read())
        assert open(r.out_path(p), encoding="utf-8").read() == expected

    # resume skips completed files
    r2 = CorpusRunner(mat_de, str(out))
    stats = r2.run(files)
    assert (stats["done"], stats["skipped"], stats["total"]) == (0, 3, 3)

    # changed source re-processes
    open(files[1], "w", encoding="utf-8").write("Neu!")
    stats = CorpusRunner(mat_de, str(out)).run(files)
    assert (stats["done"], stats["skipped"], stats["total"]) == (1, 2, 3)

    m = json.load(open(out / "manifest.json", encoding="utf-8"))
    assert len(m["files"]) == 3


def test_corpus_native_writer_parity(mat_de, tmp_path):
    """The corpus runner's native C++ writer fast path produces byte-
    identical output to the Python TokenWriter replay."""
    import os

    from datok.runtime.corpus import CorpusRunner
    from datok.runtime.jax_engine import BatchEngine
    from datok.runtime.pipeline import tokenize_stream
    from datok.runtime.writer import TokenWriter

    text = (
        "Der alte Mann ging z.B. zur Weststr. 3. Zwei Sätze!\x04"
        "\nNächster Text mit korap@ids-mannheim.de und 😀.\x04"
    )
    src = tmp_path / "in.txt"
    src.write_text(text, encoding="utf-8")
    eng = BatchEngine(mat_de, accelerated=False)
    runner = CorpusRunner(mat_de, str(tmp_path / "out"), engine=eng)
    runner.run([str(src)])
    got = open(runner.out_path(str(src)), encoding="utf-8").read()

    w = TokenWriter(runner.flags)
    tokenize_stream(mat_de, text, w, engine=eng)
    assert got == w.getvalue()


def test_corpus_shared_wave_chain_breaks(mat_de, tmp_path):
    """Files share device waves in one pipelined pass, but each file's
    chain starts fresh at the root — a file ending mid-word (no EOT)
    must not leak its exit context into the next file."""
    from datok.runtime.corpus import CorpusRunner
    from datok.runtime.jax_engine import BatchEngine

    texts = [
        "Erste Datei endet mitten im Wort readme",  # no EOT, no period
        "Zweite Datei. Noch ein Satz!\x04Und Text zwei.",
        "",  # empty file
        "Abk. z.B. und mehr.\x04" * 7,
    ]
    files = []
    for i, t in enumerate(texts):
        p = tmp_path / f"f{i}.txt"
        p.write_text(t, encoding="utf-8")
        files.append(str(p))
    eng = BatchEngine(mat_de, engine="hot")
    # lanes tiny → files genuinely share / straddle waves
    runner = CorpusRunner(mat_de, str(tmp_path / "out"), engine=eng)
    st = {}
    stats = runner.run(files, stats=st)
    assert stats["done"] == 4
    # lane packing merges each file's documents into one superdoc
    # (all files here are short); file boundaries never pack together.
    # The EOT-terminated file contributes one extra chunk: its stream-
    # final epilogue sentinel (split_documents), which never packs.
    assert st["docs"] == 5
    for p, t in zip(files, texts):
        want = mat_de.tokenize(t)
        got = open(runner.out_path(p), encoding="utf-8").read()
        assert got == want, p

    # unpacked (per-document lanes) must give byte-identical outputs
    out2 = tmp_path / "out2"
    runner2 = CorpusRunner(mat_de, str(out2), engine=eng)
    st2 = {}
    runner2.run(files, stats=st2, pack_len=0)
    assert st2["docs"] >= 10
    for p in files:
        a = open(runner.out_path(p), encoding="utf-8").read()
        b = open(runner2.out_path(p), encoding="utf-8").read()
        assert a == b, p
