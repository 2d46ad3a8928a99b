"""Parallel host stages must be byte-identical to their serial twins.

Round-3 verdict #1: the host can't feed the chip — encode and
decode+format ran effectively single-threaded.  The native library now
threads all three host stages (dt_encode_batch rows, dt_decode_events
lanes, dt_writer_feed_wave_mt chunks at clean writer boundaries).
Parallelism must never change a byte: these tests pin each stage
against its serial/numpy oracle, including writer state carried across
waves and every output flag combination.
"""

import numpy as np
import pytest

import datok as dt
from datok.runtime.encode import text_to_codepoints
from datok.runtime.oracle import transduce_events
from datok.runtime.writer import (NEWLINE_AFTER_EOT, SENTENCE_POS,
                                      SENTENCES, TOKEN_POS, TOKENS,
                                      TokenWriter)

native = pytest.importorskip("datok.utils.native")
if native.get_lib() is None:
    pytest.skip("native library unavailable", allow_module_level=True)


def test_native_decode_events_parity():
    rng = np.random.default_rng(3)
    B, E = 257, 64
    counts = rng.integers(0, E + 1, size=B).astype(np.int32)
    ev = np.zeros((B, E), dtype=np.uint32)
    for i in range(B):
        n = counts[i]
        kinds = rng.integers(1, 4, size=n)
        starts = rng.integers(0, 1 << 15, size=n)
        ends = rng.integers(0, 1 << 15, size=n)
        ev[i, :n] = kinds | (starts << 2) | (ends << 17)
    for workers in (1, 2, 5):
        tri = native.native_decode_events(ev, counts, workers=workers)
        # numpy oracle (the original decode_events_flat body)
        mask = np.arange(E)[None, :] < counts[:, None]
        flat = ev[mask]
        want = np.stack(
            [flat & 3, (flat >> 2) & 0x7FFF, (flat >> 17) & 0x7FFF],
            axis=1,
        ).astype(np.int32)
        np.testing.assert_array_equal(tri, want)


def _wave_of(tok, docs):
    """Per-doc oracle events + the flat wave layout."""
    tri_parts, counts = [], []
    for d in docs:
        ev = np.asarray(
            transduce_events(tok, d), dtype=np.int32
        ).reshape(-1, 3)
        tri_parts.append(ev)
        counts.append(len(ev))
    tri = (
        np.concatenate(tri_parts)
        if tri_parts
        else np.zeros((0, 3), np.int32)
    )
    cps = [text_to_codepoints(d) for d in docs]
    offs = np.zeros(len(docs), dtype=np.int64)
    if len(cps) > 1:
        np.cumsum([len(c) for c in cps[:-1]], out=offs[1:])
    flat = (
        np.concatenate(cps) if cps else np.zeros(0, np.int32)
    )
    lens = np.asarray([len(c) for c in cps], dtype=np.int32)
    return tri, np.asarray(counts, np.int32), flat, offs, lens


DOCS = (
    ["Der alte Mann.\x04", "\nKurz!\x04", "ohne Ende hier"]
    + [f"Satz {i}. Noch was längeres, Nr. {i}!\x04" for i in range(24)]
    + ["\x04", "", "z.B. 5.9.2018 übrig"]
)

FLAG_SETS = [
    TOKENS | SENTENCES,
    TOKENS,
    SENTENCES,
    TOKENS | SENTENCES | TOKEN_POS,
    TOKENS | SENTENCES | TOKEN_POS | SENTENCE_POS,
    TOKENS | SENTENCES | TOKEN_POS | SENTENCE_POS | NEWLINE_AFTER_EOT,
    0,
]


@pytest.mark.parametrize("flags", FLAG_SETS)
def test_feed_wave_mt_parity(mat_de, flags):
    tri, counts, flat, offs, lens = _wave_of(mat_de, DOCS)
    w1 = native.NativeWriter(flags)
    w1.feed_wave(tri, counts, flat, offs, lens, workers=1)
    for workers in (2, 3, 8):
        wN = native.NativeWriter(flags)
        wN.feed_wave(tri, counts, flat, offs, lens, workers=workers)
        assert wN.getvalue() == w1.getvalue(), (flags, workers)


@pytest.mark.parametrize("flags", FLAG_SETS)
def test_feed_wave_mt_state_across_waves(mat_de, flags):
    """A wave ending in an unterminated doc carries writer state into
    the next wave; chunked formatting must preserve it exactly."""
    wave1 = DOCS[:10] + ["angefangen aber nie"]
    wave2 = [" beendet bis hier.\x04"] + DOCS[10:]
    w1 = native.NativeWriter(flags)
    wN = native.NativeWriter(flags)
    for docs in (wave1, wave2):
        tri, counts, flat, offs, lens = _wave_of(mat_de, docs)
        w1.feed_wave(tri, counts, flat, offs, lens, workers=1)
        wN.feed_wave(tri, counts, flat, offs, lens, workers=4)
    assert wN.getvalue() == w1.getvalue()


def test_feed_wave_mt_matches_python_writer(mat_de):
    """The chunked native path equals the pure-Python TokenWriter."""
    from datok.runtime.events import replay_events

    flags = TOKENS | SENTENCES | TOKEN_POS | SENTENCE_POS
    tri, counts, flat, offs, lens = _wave_of(mat_de, DOCS)
    wN = native.NativeWriter(flags)
    wN.feed_wave(tri, counts, flat, offs, lens, workers=4)
    py = TokenWriter(flags)
    for d in DOCS:
        replay_events(transduce_events(mat_de, d), d, py)
    assert wN.getvalue() == py.getvalue()
