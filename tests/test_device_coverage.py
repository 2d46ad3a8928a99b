"""Every model family is first-class on every device engine.

Parametrized parity over the generated grammars {DE-size, EN-size,
small, simple (no EOT symbol)} × {general, hot}: each engine must
produce oracle-identical event streams on the full conformance corpus
plus inputs drawn from the grammar's own vocabulary — the reference's
cross-model test spread (matrix_test.go:1017-1230) on the device
engines.
"""

import json
import os

import pytest

from datok.fsa import synth
from datok.runtime.jax_engine import BatchEngine
from datok.runtime.oracle import transduce_events

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

with open(os.path.join(HERE, "conformance", "scenarios.json"), encoding="utf-8") as f:
    CORPUS = sorted({s["input"] for s in json.load(f)})

MODELS = ["synth_de18k", "synth_en15k", "synth_small", "synth_simple"]
EXTRA = [
    "Der alte  Mann.   Hier!\x04Und (dort)?",
    " \t\n mixed   spacing . ",
    "# lone hash, @ lone at, `backtick`\x04`\x04",
    "",
    "\x04",
]


@pytest.fixture(scope="module")
def model_cache():
    import datok as dt

    return {name: dt.load_matrix_file(synth.model_path(name)) for name in MODELS}


def _texts(name):
    own = synth.documents(
        name if name != "synth_simple" else "synth_small",
        [40, 200, 700], seed=11,
    )
    return CORPUS + EXTRA + own


def _assert_parity(eng, tok, texts):
    evs = eng.events_batch(texts)
    for t, e in zip(texts, evs):
        assert e == transduce_events(tok, t), repr(t[:60])


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("engine", ["general", "hot"])
def test_corpus_parity(model_cache, name, engine):
    tok = model_cache[name]
    eng = BatchEngine(tok, engine=engine)
    assert eng.engine == engine
    _assert_parity(eng, tok, _texts(name))


def test_en_hot_profile_covers_clitics(model_cache):
    """Profile texts decide the hot set: every state visited while
    transducing the profile sample must be hot (cold states there would
    run at service-step speed).  The generated EN grammar has no
    clitic rules; its own sentences take their place."""
    tok = model_cache["synth_en15k"]
    sample = " ".join(synth.sentence_pool("synth_en15k", n=8))
    eng = BatchEngine(tok, engine="hot", profile_texts=[sample],
                      hot_size=2048)
    hot = set(eng.spec.hot_full.tolist())
    counter = {}
    transduce_events(tok, sample, state_counter=counter)
    cold = [s for s in counter if s not in hot]
    assert not cold, f"profiled states missing from hot set: {cold[:10]}"
