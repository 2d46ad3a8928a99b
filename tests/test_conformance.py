"""Oracle conformance against the reference's extracted test scenarios.

Scenarios are mechanically extracted from the reference's Go tests
(conformance/extract.py); each asserts token surfaces / full output for
a given model and input, end-to-end through the scalar oracle.
"""

import json
import os
import re

import pytest

from conftest import require_reference

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCEN_PATH = os.path.join(HERE, "conformance", "scenarios.json")

with open(SCEN_PATH, encoding="utf-8") as f:
    SCENARIOS = json.load(f)

_model_cache = {}


def get_model(spec):
    typ, name = spec
    key = (typ, name)
    if key in _model_cache:
        return _model_cache[key]
    import datok as dt

    # the scenarios' expectations belong to the reference's own models
    path = os.path.join(require_reference(name), name)
    if typ == "matok":
        tok = dt.load_matrix_file(path)
    elif typ == "datok":
        tok = dt.load_datok_file(path)
    elif typ == "foma-matrix":
        tok = dt.MatrixTokenizer.from_automaton(dt.load_foma_file(path))
    elif typ == "foma-da":
        tok = dt.DaTokenizer.from_automaton(dt.load_foma_file(path))
    else:
        raise ValueError(typ)
    _model_cache[key] = tok
    return tok


def scenario_id(i, s):
    text = s["input"][:30].replace("\n", "\\n")
    return f"{i}-{s['model'][1]}-{text}"


def check_scenario(scen):
    """Assert one scenario end-to-end through the scalar oracle.

    Shared with test_stale_fixtures.py, which asserts the *inverse*
    (stale scenarios must still fail on the committed fixtures)."""
    tok = get_model(scen["model"])
    out = tok.tokenize(scen["input"])

    if scen["mode"] == "plain":
        tokens = out.split("\n")
    else:
        tokens = re.split("\n+", out)
        tokens = tokens[:-1]

    if scen["mode"] == "joined":
        assert "\n".join(tokens) == scen["full"]
        return

    if scen["full"] is not None:
        assert out == scen["full"]
    for idx, expected in scen["tokens"].items():
        i = int(idx)
        assert i < len(tokens), f"token {i} missing (got {len(tokens)}: {tokens})"
        assert tokens[i] == expected, f"token {i}: {tokens[i]!r} != {expected!r}"
    if scen["len"] is not None:
        assert len(tokens) == scen["len"]

    if scen.get("sentences") or scen.get("sent_len") is not None:
        sentences = out.split("\n\n")
        for idx, expected in (scen.get("sentences") or {}).items():
            i = int(idx)
            assert i < len(sentences), f"sentence {i} missing: {sentences}"
            assert sentences[i] == expected, (sentences[i], expected)
        if scen.get("sent_len") is not None:
            assert len(sentences) == scen["sent_len"]


@pytest.mark.parametrize(
    "scen", SCENARIOS, ids=[scenario_id(i, s) for i, s in enumerate(SCENARIOS)]
)
def test_scenario(scen):
    if scen.get("stale_fixture"):
        pytest.skip(
            "expectation requires 0.3.1 grammar features absent from the "
            "snapshot's committed binary fixtures (see conformance/extract.py "
            "and tests/test_stale_fixtures.py, which asserts the staleness)"
        )
    check_scenario(scen)
