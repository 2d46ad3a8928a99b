"""Overlapped pipeline (runtime/overlap.py): byte parity with the
synchronous wave pipeline, zero-host-repair speculation on real
models, long-document routing, and the compacted-event device path.

Reference surface: the single-stream Transduce loop
(reference matrix.go:348-698) — output must be byte-identical
whichever host pipeline produced it.
"""

import numpy as np
import pytest

import datok as dt
from datok.runtime import overlap
from datok.runtime.jax_engine import (
    BatchEngine,
    decode_events_batch,
    decode_events_compact,
)
from datok.runtime.overlap import (
    events_pipelined,
    tokenize_stream_pipelined,
)
from datok.runtime.pipeline import predict_entries, tokenize_stream

STREAM = (
    "Der alte Mann. Er ging heim.\x04Zwei Texte? Ja!\x04" * 12
    + "Ümläut über straße.\x04Nach nicht-ASCII bleibt ok gesetzt.\x04"
    + "Ende ohne EOT am Schluss"
)

EDGES = [
    "",
    "\x04",
    "\x04\x04",
    "a",
    "Erste.\n\n\n\n\x04\x0aNächst.\x04",
    "A.\x04\x04B.\x04",
    "nur leerzeichen   \x04   \x04",
]


@pytest.fixture(scope="module")
def engines(mat_de, mat_en, dat_de):
    return {
        "de": BatchEngine(mat_de, engine="hot"),
        "en": BatchEngine(mat_en, engine="hot"),
        "da": BatchEngine(dat_de, engine="hot"),
    }


@pytest.mark.parametrize("key", ["de", "en", "da"])
def test_stream_parity(engines, key):
    eng = engines[key]
    a = tokenize_stream(eng.tok, STREAM, engine=eng).getvalue()
    b = tokenize_stream_pipelined(
        eng.tok, STREAM, engine=eng, lanes=7
    ).getvalue()
    assert a == b


def test_edge_parity(engines):
    eng = engines["de"]
    for t in EDGES:
        a = tokenize_stream(eng.tok, t, engine=eng).getvalue()
        b = tokenize_stream_pipelined(eng.tok, t, engine=eng).getvalue()
        assert a == b, repr(t)


def test_no_host_repairs_on_predicted_chain(engines, monkeypatch):
    """Predicted post-EOT entries must verify on the first round —
    bare-root speculation silently re-ran every document."""
    eng = engines["de"]
    calls = []
    import datok.runtime.pipeline as P

    orig = P.transduce_doc_exact

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    # repairs route through transduce_doc_exact, imported from
    # pipeline at generator start — patch the pipeline binding
    monkeypatch.setattr(P, "transduce_doc_exact", spy)
    tokenize_stream_pipelined(eng.tok, STREAM, engine=eng, lanes=5)
    assert calls == []


def test_long_doc_routing(engines):
    """Documents over MAX_SEGMENT run through speculative segmentation
    inside the pipeline, with exact output and chain continuity."""
    eng = engines["de"]
    long_doc = ("Langer Satz mit Wörtern und Zahlen 123. " * 1200) + "\x04"
    text = "Kurz davor.\x04" + long_doc + "Kurz danach!\x04"
    a = tokenize_stream(eng.tok, text, engine=eng).getvalue()
    b = tokenize_stream_pipelined(
        eng.tok, text, engine=eng, lanes=4
    ).getvalue()
    assert a == b


def test_early_close_releases_prep_thread(engines):
    eng = engines["de"]
    gen = events_pipelined(
        eng, ((None, d) for d in ["Eins.\x04"] * 64), lanes=4
    )
    next(gen)
    gen.close()  # must not deadlock on the slot ring


def test_tags_pass_through(engines):
    eng = engines["de"]
    items = [(("f", i), f"Satz {i}.\x04") for i in range(9)]
    out = list(events_pipelined(eng, iter(items), lanes=4))
    assert [t for t, _, _ in out] == [t for t, _ in items]
    assert all(isinstance(e, np.ndarray) and e.shape[1] == 3
               for _, _, e in out)


def test_predict_entries_chain(engines):
    """Predictions equal the oracle's true exits doc by doc."""
    from datok.runtime.oracle import transduce_events_fast
    from datok.runtime.pipeline import split_documents

    eng = engines["de"]
    docs = split_documents(STREAM)
    ents, _ = predict_entries(eng.encoder, docs)
    assert ents[0] == 1
    cur = 1
    for k, doc in enumerate(docs[:-1]):
        box = []
        transduce_events_fast(eng.tok, doc, entry_state=int(cur),
                              exit_box=box)
        cur = box[0]
        assert ents[k + 1] == cur, f"doc {k}"


def test_compact_events_parity(engines):
    eng = engines["de"]
    texts = [
        "Der alte Mann. Er ging.\x04",
        "Hallo Welt! Wie geht's?\x04",
        "a\x04",
        "",
        "Ümläute:  ähm… ja!\x04",
    ] * 5
    meta, lengths, _ = eng.encoder.encode_batch(texts)
    ys, bad, n_steps, state = eng.run_raw(meta, lengths)
    ref = decode_events_batch(ys, n_steps)
    ev, counts, bad2, state2 = eng.run_events_compact(meta, lengths)
    got = decode_events_compact(ev, counts)
    assert got == ref
    assert np.array_equal(bad, bad2)
    assert np.array_equal(state, state2)
    ga = decode_events_compact(ev, counts, as_arrays=True)
    ra = decode_events_batch(ys, n_steps, as_arrays=True)
    for a, b in zip(ga, ra):
        assert np.array_equal(a, b)


def test_native_wave_encode_parity(engines):
    """dt_encode_batch must be bit-identical to the numpy encoder,
    including the adaptive skip-class run field and CLS bits."""
    from datok.runtime.encode import text_to_codepoints
    from datok.utils.native import native_encode_wave

    eng = engines["de"]
    enc = eng.encoder
    texts = [
        "", "a", "Der alte Mann aß ößterreichisch. \U0001f600 x\x04",
        "don't", "ä" * 5, "\x04\x04", "aaa sss", "ümläute ßind süß",
        "a" * 500,
    ]
    r = native_encode_wave(enc, texts)
    if r is None:
        pytest.skip("native library unavailable")
    meta_n, len_n, cps_n = r
    cps_p = [text_to_codepoints(t) for t in texts]
    metas_p = [enc.encode(c) for c in cps_p]
    L = max(1, max(len(c) for c in cps_p))
    meta_p = np.zeros((len(texts), L), dtype=np.int32)
    for i, m in enumerate(metas_p):
        meta_p[i, : len(m)] = m
    assert meta_n.shape == meta_p.shape
    assert np.array_equal(meta_n, meta_p)
    assert np.array_equal(len_n, [len(c) for c in cps_p])
    for a, b in zip(cps_n, cps_p):
        assert np.array_equal(a, b)
    # scratch reuse across waves stays exact (pad-cell zeroing in C)
    scratch = {}
    big = native_encode_wave(enc, ["x" * 64] * 4, scratch=scratch)
    small = native_encode_wave(enc, texts, scratch=scratch)
    assert np.array_equal(small[0], meta_p)


def test_native_writer_wave_path(engines):
    """tokenize_stream_pipelined with a NativeWriter (one feed_wave C
    call per wave) is byte-identical to the Python writer path —
    including a long document (text_to_codepoints cps layout)."""
    from datok.utils.native import NativeWriter, get_lib

    if get_lib() is None:
        pytest.skip("native library unavailable")
    eng = engines["de"]
    long_doc = ("Langer Satz mit Wörtern und Zahlen 123. " * 1200) + "\x04"
    text = STREAM + "\x04" + long_doc + "Danach noch.\x04"
    for flags in (dt.SIMPLE, dt.TOKENS | dt.SENTENCES | dt.TOKEN_POS):
        a = tokenize_stream_pipelined(
            eng.tok, text, engine=eng, lanes=6,
            writer=dt.TokenWriter(flags),
        ).getvalue()
        b = tokenize_stream_pipelined(
            eng.tok, text, engine=eng, lanes=6,
            writer=NativeWriter(flags),
        ).getvalue()
        assert a == b


def test_waves_pipelined_stats(engines):
    """The stats dict reports stage seconds and exact doc/wave counts."""
    from datok.runtime.overlap import waves_pipelined

    eng = engines["de"]
    st = {}
    docs = [f"Satz {i}.\x04" for i in range(23)]
    n = 0
    for w in waves_pipelined(
        eng, ((None, d) for d in docs), lanes=8, stats=st
    ):
        n += len(w.docs)
        assert len(w.counts) == len(w.docs)
        assert w.tri.shape[0] == int(w.counts.sum())
    assert n == 23
    assert st["docs"] == 23
    assert st["waves"] == 3
    assert st["repairs"] == 0
    assert all(st[k] >= 0.0 for k in ("encode", "dispatch", "fetch",
                                      "decode"))
