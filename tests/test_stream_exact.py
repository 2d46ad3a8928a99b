"""Stream semantics at interior EOT boundaries must match the
reference's single-stream transduce byte for byte.

The reference processes a stream in ONE Transduce call: at an interior
``\\x04`` the machine continues directly from the EOT transition's
target (matrix.go:593-605); the EOF epilogue (trailing ε chase +
implicit ends, matrix.go:637-697) runs only at real EOF.  A per-
document decomposition that runs the epilogue per document diverges
whenever the post-EOT state has ε arcs (simpletok: every EOT leaves
such a state) — caught as a real round-4 regression.  These tests pin
the fix: interior chunks run as cuts, the stream-final epilogue runs
as the split sentinel chunk.
"""

import io

import numpy as np
import pytest

import datok as dt
from datok.runtime.jax_engine import BatchEngine
from datok.runtime.overlap import tokenize_stream_pipelined
from datok.runtime.pipeline import (
    eot_in_sigma,
    eot_split_safe,
    tokenize_reader,
    tokenize_stream,
    transduce_doc_exact,
)


@pytest.fixture(scope="module")
def simpletok():
    """Generated stand-in for the reference's simpletok: no \\x04 in
    sigma, and the identity arc EOT rides leads to a state with ε."""
    from datok.fsa.synth import model_path

    return dt.load_matrix_file(model_path("synth_simple"))


@pytest.fixture(scope="module")
def eng(simpletok):
    return BatchEngine(simpletok)


LONG = "aaa bbb ccc. " * 40
STREAMS = [
    "aab. ccc.\x04Xy?\x04",  # post-EOT state has an ε arc (unsafe)
    "aab. ccc.\x04Xy?",
    LONG + "\x04Xy?\x04",
    "Kurz.\x04" + LONG + "\x04Xy?\x04",
    "\x04\x04",
    "a\x04",
]


def test_split_gating(simpletok, mat_de):
    """simpletok has NO \\x04 in sigma (EOT rides the identity arc),
    so EOT cuts are not provably clean → streams run unsplit (exact
    via segment-level speculation).  DE has \\x04 in sigma but its EOT
    arcs don't all return to the root → the cut + chain-repair regime.
    """
    from datok.runtime.pipeline import split_stream

    assert not eot_in_sigma(simpletok)
    assert split_stream(simpletok, "a\x04b\x04") == ["a\x04b\x04"]
    assert eot_in_sigma(mat_de)
    assert not eot_split_safe(mat_de)
    assert split_stream(mat_de, "a\x04b\x04") == ["a\x04", "b\x04", ""]


# DE streams whose interior EOTs leave NON-root states (backtick lands
# in a whitespace-class state; EOT is consumed as an ignorable char) —
# the cut-dispatch + chain-repair regime, including post-EOT states
# with ε availability where the old per-doc epilogue diverged.
DE_STREAMS = [
    "ab `\x04cd ef\x04gh",
    "x`\x04`y\x04z.\x04",
    "Der alte Mann.\x04`\x04Weststr. 3 bzw. 4?\x04",
    "`\x04`\x04`\x04",
    "Zum Ende `\x04",
]


@pytest.mark.parametrize("i", range(len(DE_STREAMS)))
def test_de_stream_parity_cut_regime(mat_de, i):
    text = DE_STREAMS[i]
    eng = BatchEngine(mat_de, engine="general")
    want = mat_de.tokenize(text)
    assert tokenize_stream(mat_de, text, engine=eng).getvalue() == want
    got = tokenize_stream_pipelined(
        mat_de, text, engine=eng, lanes=4, pack_len=0
    ).getvalue()
    assert got == want


@pytest.mark.parametrize("i", range(len(STREAMS)))
def test_stream_parity_tokenize_stream(simpletok, eng, i):
    text = STREAMS[i]
    want = simpletok.tokenize(text)
    assert tokenize_stream(simpletok, text, engine=eng).getvalue() == want


@pytest.mark.parametrize("i", range(len(STREAMS)))
@pytest.mark.parametrize("pack", [0, 1024])
def test_stream_parity_pipelined(simpletok, eng, i, pack):
    text = STREAMS[i]
    want = simpletok.tokenize(text)
    got = tokenize_stream_pipelined(
        simpletok, text, engine=eng, lanes=16, pack_len=pack
    ).getvalue()
    assert got == want


@pytest.mark.parametrize("chunk", [7, 64, 1 << 20])
def test_stream_parity_reader(simpletok, eng, chunk):
    text = "".join(STREAMS)
    want = simpletok.tokenize(text)
    w = tokenize_reader(
        simpletok, io.BytesIO(text.encode()), engine=eng,
        chunk_bytes=chunk,
    )
    assert w.getvalue() == want


def test_transduce_doc_exact_cut_matches_stream(simpletok):
    """The host cut walk of an EOT-ending chunk + continuation equals
    the full-stream oracle (events and exit context)."""
    from datok.runtime.oracle import transduce_events

    d0, d1 = "aab. ccc.\x04", "Xy?\x04"
    full = transduce_events(simpletok, d0 + d1)
    e0, x0 = transduce_doc_exact(simpletok, d0, 1, cut=True)
    e1, x1 = transduce_doc_exact(simpletok, d1, x0, cut=True)
    ep, _x = transduce_doc_exact(simpletok, "", x1, cut=False)
    shifted = [(k, a + len(d0), b + len(d0)) for k, a, b in e1]
    shifted_ep = [
        (k, a + len(d0) + len(d1), b + len(d0) + len(d1)) for k, a, b in ep
    ]
    assert list(e0) + shifted + shifted_ep == full


def test_corpus_runner_stream_exact(simpletok, tmp_path):
    """Per-file outputs equal the reference's per-file transduce."""
    texts = ["aa bb.\x04cc?\x04", LONG + "\x04dd!", "x\x04"]
    files = []
    for i, t in enumerate(texts):
        p = tmp_path / f"f{i}.txt"
        p.write_text(t, encoding="utf-8")
        files.append(str(p))
    out = tmp_path / "out"
    runner = dt.CorpusRunner(simpletok, str(out))
    runner.run(files)
    for f, t in zip(files, texts):
        got = (out / (f.split("/")[-1] + ".tok")).read_text()
        assert got == simpletok.tokenize(t), f
