"""Device engine ↔ oracle event-stream parity (CPU backend).

The batched XLA state machine must produce byte-identical event
streams to the scalar oracle for every input — this is the conformance
contract of the device path (BASELINE.md north star).
"""

import json
import os
import random

import pytest

import datok as dt
from datok.runtime.events import format_events
from datok.runtime.jax_engine import BatchEngine
from datok.runtime.oracle import transduce_events

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

with open(os.path.join(HERE, "conformance", "scenarios.json"), encoding="utf-8") as f:
    CORPUS = sorted({s["input"] for s in json.load(f)})

EDGE = [
    "",
    "\x04",
    "\x04\x04x\x04",
    "a" * 900 + ". Ende.",
    "Erste.\n\n\n\n\x04\x0aNächst.\x04",
]

rng = random.Random(42)
ALPHA = "aA.  ,!?\x04\nü😀z.B-co mwww"
FUZZ = ["".join(rng.choice(ALPHA) for _ in range(rng.randint(0, 60))) for _ in range(60)]


@pytest.fixture(scope="module")
def eng_mat(mat_de):
    return BatchEngine(mat_de)


@pytest.fixture(scope="module")
def eng_da(dat_de):
    # auto-converts to the dense matrix and runs the accelerated
    # machine (DaTokenizer.to_matrix); parity is still asserted
    # against the DOUBLE-ARRAY oracle, pinning the conversion
    return BatchEngine(dat_de)


@pytest.fixture(scope="module")
def eng_da_general(dat_de):
    # the general serial-gather machine on the raw base/check tables
    return BatchEngine(dat_de, engine="general")


def assert_parity(eng, tok, texts):
    evs = eng.events_batch(texts)
    for t, e in zip(texts, evs):
        assert e == transduce_events(tok, t), repr(t[:60])


def test_matrix_engine_corpus_parity(eng_mat, mat_de):
    assert_parity(eng_mat, mat_de, CORPUS + EDGE)


def test_datok_engine_corpus_parity(eng_da, dat_de):
    assert_parity(eng_da, dat_de, CORPUS + EDGE)


def test_matrix_engine_fuzz_parity(eng_mat, mat_de):
    assert_parity(eng_mat, mat_de, FUZZ)


def test_datok_engine_fuzz_parity(eng_da, dat_de):
    assert_parity(eng_da, dat_de, FUZZ)


def test_datok_general_engine_parity(eng_da_general, dat_de):
    assert eng_da_general.engine == "general"
    assert_parity(eng_da_general, dat_de, CORPUS[:40] + EDGE)


def test_tokenize_batch_output(eng_mat, mat_de):
    texts = ["Der alte Mann.", "", "Zwei Sätze. Hier!"]
    outs = eng_mat.tokenize_batch(texts)
    for t, o in zip(texts, outs):
        assert o == mat_de.tokenize(t)


def test_flags_through_engine(eng_mat, mat_de):
    text = "This.\x0a\x04And.\n\x04\n"
    fl = dt.TOKENS | dt.SENTENCES | dt.TOKEN_POS
    out = eng_mat.tokenize_batch([text], flags=fl)[0]
    assert out == "This\n.\n\n0 4 4 5\nAnd\n.\n\n0 3 3 4\n"


def test_en_model_engine(mat_en):
    eng = BatchEngine(mat_en)
    texts = ["they're They're their don't wouldn't", "I've we'll isn't."]
    for t, o in zip(texts, eng.tokenize_batch(texts)):
        assert o == mat_en.tokenize(t)


@pytest.mark.parametrize("model", ["de", "en"])
def test_auto_hot_set_rule(model, mat_de, mat_en):
    """The hot machine's auto hot set: root first, no duplicates, a
    multiple of 128 within [384, 640], and covering >= 98.5 % of the
    profiled transitions unless the cap cut it."""
    import numpy as np

    from datok.runtime.jax_engine import (
        default_profile_texts,
        profile_hot_states,
    )

    tok = mat_de if model == "de" else mat_en
    texts = default_profile_texts(tok)
    hot = profile_hot_states(tok, texts, "auto")
    H = len(hot)
    assert int(hot[0]) == 1, "root state must be hot id 0"
    assert len(np.unique(hot)) == H
    assert 384 <= H <= 640 and H % 128 == 0, H
    counter = {}
    for t in texts:
        transduce_events(tok, t, state_counter=counter)
    hot_set = set(int(s) for s in hot)
    covered = sum(c for s, c in counter.items() if s in hot_set)
    assert H == 640 or covered >= 0.985 * sum(counter.values())
    assert list(profile_hot_states(tok, texts, 200)) == list(hot[:200])
