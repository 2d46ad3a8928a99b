"""Stale-fixture skips must be self-verifying.

conformance/extract.py tags 17 scenarios whose expectations need 0.3.1
grammar features (hyphenated abbreviations, Wikipedia templates,
gender forms, the ver.di plusampersand entry — reference Changes:1-8)
absent from the snapshot's committed binary fixtures; test_conformance
skips them.  A bare skip could silently mask a future regression that
re-breaks a genuinely supported form, so this module asserts the
staleness itself, two ways:

1. a **direct table walk** per expected stale token: the committed
   model must have *no accepting path* that could emit the token whole
   (no root→…→token-bound traversal exists in the raw table);
2. each skipped scenario must still **fail** end-to-end — if one
   starts passing, the fixture was rebuilt and the skip (plus the
   marker list) must be removed.
"""

import json
import os

import numpy as np
import pytest

from datok.fsa.io import FIRSTBIT, RESTBIT

from test_conformance import (  # noqa: E402 (tests run with rootdir on sys.path)
    SCENARIOS,
    check_scenario,
    get_model,
    scenario_id,
)

STALE = [
    (i, s) for i, s in enumerate(SCENARIOS) if s.get("stale_fixture")
]

MARKERS_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "conformance",
    "extract.py",
)


def _markers():
    # the authoritative list lives in the extractor; import it
    import importlib.util

    spec = importlib.util.spec_from_file_location("_extract", MARKERS_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.STALE_FIXTURE_MARKERS


def _symbol(tok, cp: int) -> int:
    if cp < 256:
        return int(tok.sigma_ascii[cp])
    return int(tok.sigma.get(cp, 0))


def _walk_matrix(tok, text: str) -> bool:
    """True iff the raw matrix has a root→…→token-bound path for text.

    Mirrors the transition semantics only (gather + unknown retry —
    matrix.go:463,478-485); no backtracking is needed because we ask
    about a *single* whole-token path existence.
    """
    S = tok.state_count
    arr = np.asarray(tok.array)
    eps = tok.epsilon
    t = 1
    for ch in text:
        a = _symbol(tok, ord(ch))
        nxt = 0
        if a > 0:
            nxt = int(arr[(a - 1) * S + t]) & ~FIRSTBIT
        if nxt == 0 and tok.unknown > 0:
            nxt = int(arr[(tok.unknown - 1) * S + t]) & ~FIRSTBIT
        if nxt == 0:
            return False
        t = nxt
    return int(arr[(eps - 1) * S + t]) != 0


def _walk_datok(tok, text: str) -> bool:
    """Direct base/check walk (datok.go:889-901,1056-1063 semantics)."""
    base = np.asarray(tok.base, dtype=np.int64)
    check = np.asarray(tok.check, dtype=np.int64)
    size = int(check[1] & RESTBIT)

    def step(t0: int, a: int) -> int:
        if a <= 0:
            return 0
        tc = (int(base[t0]) & RESTBIT) + a
        if tc > size or tc >= len(check) or (int(check[tc]) & RESTBIT) != t0:
            return 0
        if int(base[tc]) & (1 << 31):  # separate state: representative hop
            return int(base[tc]) & RESTBIT
        return tc

    t = 1
    for ch in text:
        nxt = step(t, _symbol(tok, ord(ch)))
        if nxt == 0:
            nxt = step(t, tok.unknown)
        if nxt == 0:
            return False
        t = nxt
    return step(t, tok.epsilon) != 0


def walk_token(tok, text: str) -> bool:
    if tok.type() == "MATOK":
        return _walk_matrix(tok, text)
    return _walk_datok(tok, text)


def _stale_tokens(scen):
    marks = _markers()
    toks = [t for t in scen["tokens"].values() if any(m in t for m in marks)]
    assert toks, f"stale scenario without a marked expected token: {scen}"
    return toks


@pytest.mark.parametrize(
    "scen", [s for _, s in STALE], ids=[scenario_id(i, s) for i, s in STALE]
)
def test_stale_token_has_no_accepting_path(scen):
    """The committed model must lack a whole-token path for each stale
    expectation — the direct table walk extract.py's rationale claims."""
    tok = get_model(scen["model"])
    for t in _stale_tokens(scen):
        assert not walk_token(tok, t), (
            f"model HAS an accepting path for {t!r}: the fixture is no "
            "longer stale — remove it from STALE_FIXTURE_MARKERS and "
            "unskip the scenario"
        )


@pytest.mark.parametrize(
    "scen", [s for _, s in STALE], ids=[scenario_id(i, s) for i, s in STALE]
)
def test_stale_scenario_still_fails(scen):
    """A skipped scenario that starts passing means the skip now masks
    nothing — the fixtures were rebuilt; remove the marker."""
    with pytest.raises(AssertionError):
        check_scenario(scen)


def test_non_stale_supported_forms_still_pass():
    """Spot-guard: sibling forms the committed model DOES support must
    keep passing (the walk above is not vacuous)."""
    for model in (["datok", "tokenizer_de.datok"], ["matok", "tokenizer_de.matok"]):
        tok = get_model(model)
        # abbreviations/domains the committed model keeps whole
        # (runtime-verified: tokenize() emits each as a single token)
        for good in ["Lehrer", "bzw.", "Abk.", "Weststr.", "wikipedia.org"]:
            assert walk_token(tok, good), good
        # and the walk is runtime-consistent on a split form too
        assert not walk_token(tok, "Dipl.-Ing.")


def test_marker_list_matches_tagged_scenarios():
    """Every marker matches ≥1 tagged scenario and every tagged
    scenario carries ≥1 marker (no orphan entries either way)."""
    marks = _markers()
    tagged = [s for _, s in STALE]
    for m in marks:
        assert any(m in s["input"] for s in tagged), f"orphan marker {m!r}"
    with open(
        os.path.join(os.path.dirname(MARKERS_PATH), "scenarios.json"),
        encoding="utf-8",
    ) as f:
        allscen = json.load(f)
    for s in allscen:
        has = any(m in s["input"] for m in marks)
        assert bool(s.get("stale_fixture")) == has, s["input"][:40]
