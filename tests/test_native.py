"""Native C++ host runtime parity (encode / transduce / format)."""

import numpy as np
import pytest

import datok as dt
from datok.runtime.encode import SymbolEncoder, text_to_codepoints
from datok.runtime.events import format_events
from datok.runtime.oracle import transduce_events, transduce_events_fast
from datok.utils.native import (
    NativeWriter,
    get_lib,
    native_encode,
    native_transduce_events,
)

pytestmark = pytest.mark.skipif(get_lib() is None, reason="native lib unavailable")

TEXTS = [
    "Der alte Mann aß z.B. Äpfel... \x04Früh läuft's!",
    "",
    "a\x04😀 toll!",
    "Erste.\n\n\n\n\x04\x0aNächst.\x04",
    "  wald   gehen Da kann\t man was \"erleben\"!",
    "This.\x0a\x04And.\n\x04\n",
]


@pytest.fixture(scope="module")
def enc(mat_de):
    return SymbolEncoder(mat_de)


@pytest.mark.parametrize("text", TEXTS)
def test_native_encode_parity(mat_de, enc, text):
    cps, metas = native_encode(enc, text.encode("utf-8"))
    ref_cps = text_to_codepoints(text)
    assert np.array_equal(cps, ref_cps)
    if len(ref_cps):
        assert np.array_equal(metas, enc.encode(ref_cps))


@pytest.mark.parametrize("text", TEXTS)
def test_native_transduce_parity(mat_de, enc, text):
    _cps, metas = native_encode(enc, text.encode("utf-8"))
    ev = native_transduce_events(mat_de, metas)
    assert ev == transduce_events(mat_de, text)


def test_native_writer_all_flags(mat_de, enc):
    text = "This.\x0a\x04And.\n\x04\n"
    cps, metas = native_encode(enc, text.encode("utf-8"))
    ev = native_transduce_events(mat_de, metas)
    for flags in range(0, 32):
        w = NativeWriter(flags)
        w.feed(ev, cps)
        assert w.getvalue() == format_events(ev, text, flags), flags


def test_fast_oracle_dispatch(mat_de):
    text = "Der alte Mann. Und z.B. readme.txt!"
    assert transduce_events_fast(mat_de, text) == transduce_events(mat_de, text)


def test_native_cut_walk_parity(mat_de, enc):
    from datok.utils.native import native_cut_walk

    text = (
        "Der alte Mann ging, z.B. am 5.9.2018, zur Weststr. 3! "
        'Müller sagte: "Gut." \x04Und weiter geht es hier im Text. '
        "korap@ids-mannheim.de und www.wikipedia.org! Ende gut."
    )
    _cps, metas = native_encode(enc, text.encode("utf-8"))

    # collect real checkpoints from a full oracle walk, then replay cut
    # walks from each of them with several stop positions
    rw_full = []
    transduce_events(mat_de, text, rewinds_box=rw_full)
    assert len(rw_full) > 5
    for pos, ctx, _nev in rw_full:
        for stop in (pos, pos + 7, pos + 40, len(text)):
            stop = min(stop, len(text))
            o_rw = []
            o_ev = transduce_events(
                mat_de, text, entry_state=ctx, start=pos, stop_at=stop,
                rewinds_box=o_rw,
            )
            n = native_cut_walk(mat_de, metas, ctx, pos, stop)
            assert n is not None
            n_ev, n_rw = n
            assert n_ev == o_ev, (pos, ctx, stop)
            assert n_rw == o_rw, (pos, ctx, stop)


def test_native_da_build_matches_python():
    """Native C++ double-array builder is bit-identical to the Python
    builder (same BFS order and first-fit + Niu-skip placement)."""
    import datok.utils.native as nat
    from datok.fsa.double_array import DaTokenizer
    from datok.fsa.synth import build_automaton

    auto, _ = build_automaton("synth_small")
    r = nat.native_da_build(auto)
    if r is None:
        pytest.skip("native library unavailable")
    orig = nat.native_da_build
    nat.native_da_build = lambda a: None  # force the Python fallback
    try:
        py = DaTokenizer.from_automaton(auto)
    finally:
        nat.native_da_build = orig
    np.testing.assert_array_equal(r[0], py.base)
    np.testing.assert_array_equal(r[1], py.check)
    # reference load-factor class (datok_test.go:1242 asserts > 88)
    # reference load-factor class (datok_test.go:239 asserts >= 60)
    dat = DaTokenizer.from_automaton(auto)
    assert dat.load_factor() >= 60.0


def test_native_writer_feed_wave_parity(mat_de, enc):
    """One dt_writer_feed_wave call must equal per-document feeds —
    including empty documents and non-contiguous codepoint layouts."""
    texts = TEXTS + ["", "Nur noch ein Satz. Und einer!?\x04"]
    evs, cpss = [], []
    for t in texts:
        cps, metas = native_encode(enc, t.encode("utf-8"))
        evs.append(np.asarray(
            native_transduce_events(mat_de, metas), dtype=np.int32
        ).reshape(-1, 3))
        cpss.append(np.asarray(cps, dtype=np.int32))
    for flags in (0, 1, 3, 7, 21, 31):
        ref = NativeWriter(flags)
        for ev, cps in zip(evs, cpss):
            ref.feed(ev, cps)
        ref_out = ref.getvalue()

        tri = (np.concatenate(evs) if evs
               else np.zeros((0, 3), dtype=np.int32))
        counts = np.asarray([len(e) for e in evs], dtype=np.int32)
        # interleave padding between docs: offsets need not be dense
        pad = 5
        offs = np.zeros(len(cpss), dtype=np.int64)
        total = 0
        for i, c in enumerate(cpss):
            offs[i] = total
            total += len(c) + pad
        flat = np.full(max(total, 1), -1, dtype=np.int32)
        for i, c in enumerate(cpss):
            flat[offs[i] : offs[i] + len(c)] = c
        w = NativeWriter(flags)
        w.feed_wave(tri, counts, flat, offs,
                    np.asarray([len(c) for c in cpss], dtype=np.int32))
        assert w.getvalue() == ref_out, flags
