"""Models past 2^15 states run byte-exact on both XLA machines.

No generated grammar is that large, so this synthesizes a
~32.8K-state model whose hot path walks state ids above 2^15 — ids a
narrower packing of state ids would corrupt.  Both device machines
must finish on device (no oracle fallback) and match the oracle byte
for byte.
"""

import pytest

from datok.fsa.automaton import Automaton, Edge
from datok.fsa.matrix import MatrixTokenizer
from datok.runtime.jax_engine import BatchEngine, decode_events_batch
from datok.runtime.oracle import transduce_events

# chain states occupy the TOP of the id range so every deep-chain
# transition's (source, target) ids exceed 2^15
CHAIN_BASE = 32600
CHAIN_LEN = 200


def _big_tok() -> MatrixTokenizer:
    """Synthesize a >2^15-state tokenizer: root + '.' state + a long
    'a'-chain at ids 32600..32799, every chain state with an ε
    token-bound arc back to the root (valid Datok conventions,
    Readme.md:106-124)."""
    S = CHAIN_BASE + CHAIN_LEN - 1
    auto = Automaton()
    auto.epsilon, auto.unknown, auto.identity = 1, 2, 3
    auto.final = -1
    auto.sigma_rev = {4: "a", 5: " ", 6: "."}
    auto.sigma_count = 6
    auto.state_count = S
    auto.transitions = [None] * (S + 2)
    auto.transitions[1] = {
        4: Edge(4, 4, CHAIN_BASE),
        5: Edge(5, 1, 1, nontoken=True),
        6: Edge(6, 6, 2),
    }
    auto.transitions[2] = {1: Edge(1, 0, 1, tokenend=True)}
    for i in range(CHAIN_LEN):
        s = CHAIN_BASE + i
        nxt = s + 1 if i + 1 < CHAIN_LEN else s
        auto.transitions[s] = {
            4: Edge(4, 4, nxt),
            1: Edge(1, 0, 1, tokenend=True),
        }
    return MatrixTokenizer.from_automaton(auto)


@pytest.fixture(scope="module")
def big_tok():
    return _big_tok()


TEXTS = [
    "a" * 180 + " aa.",
    "aaa a. " + "a" * 170 + ".",
    "a a. " + "a" * 150 + " a.",
]


def _assert_device_exact(big_tok, engine):
    eng = BatchEngine(big_tok, engine=engine, hot_size=128,
                      profile_texts=["aaa aa. a."])
    assert eng.rep.S >= (1 << 15)
    meta, lengths, _ = eng.encoder.encode_batch(TEXTS)
    ys, bad, n_steps, state = eng.run_raw(meta, lengths)
    assert not bad[: len(TEXTS)].any(), (
        "device must finish within budget (no hidden oracle fallback)"
    )
    evs = decode_events_batch(ys, n_steps)
    for t, e in zip(TEXTS, evs):
        assert e == transduce_events(big_tok, t), repr(t[:40])


def test_service_fallback_exact(big_tok):
    """Deep-chain texts (states with ids > 2^15, cold for the hot
    machine, whose hot_size=128 keeps the chain out of its hot set) run
    through its service steps on device and match the oracle byte for
    byte."""
    _assert_device_exact(big_tok, "hot")


def test_general_machine_exact(big_tok):
    """The general machine gathers ids > 2^15 directly; same parity."""
    _assert_device_exact(big_tok, "general")


@pytest.mark.parametrize("engine", ["general", "hot"])
def test_big_model_tokenize_batch_parity(big_tok, engine):
    """Formatted output through the public batch surface equals the
    oracle's on the >2^15-state model."""
    eng = BatchEngine(big_tok, engine=engine, hot_size=128,
                      profile_texts=["aaa aa. a."])
    assert eng.tokenize_batch(TEXTS) == [big_tok.tokenize(t) for t in TEXTS]
