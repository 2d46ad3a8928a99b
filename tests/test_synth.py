"""Generated grammars and texts (datok.fsa.synth), the engine
choice of ``engine="auto"``, and the compile-cache helper."""

import gzip
import os

import numpy as np
import pytest

import datok as dt
from datok.fsa import synth
from datok.runtime import jax_engine
from datok.runtime.jax_engine import MAX_SEGMENT, BatchEngine
from datok.runtime.oracle import transduce_events


def test_de_profile_has_published_shape(mat_de):
    # tokenizer_de.matok: 18,400 states × 171 symbols (BASELINE.md:18)
    S = mat_de.state_count
    assert abs(S - 18400) <= 0.05 * 18400
    assert len(mat_de.array) // (S + 1) == 171
    assert abs(mat_de.array.nbytes - 12.6e6) <= 0.05 * 12.6e6


def test_en_profile_has_published_shape(mat_en):
    # tokenizer_en.matok: 14,768 states × 172 symbols (BASELINE.md:19)
    S = mat_en.state_count
    assert abs(S - 14768) <= 0.05 * 14768
    assert abs(len(mat_en.array) // (S + 1) - 172) <= 5


def test_small_profile_is_small(small_tok):
    assert 100 <= small_tok.state_count <= 1000


@pytest.mark.parametrize("profile", ["synth_small", "synth_simple",
                                     "synth_de18k"])
def test_same_seed_same_bytes(profile, tmp_path):
    synth.build_models(profile, str(tmp_path), verbose=False)
    for kind in ("matok", "datok"):
        with open(tmp_path / f"{profile}.{kind}", "rb") as f:
            fresh = f.read()
        with open(synth.model_path(profile, kind), "rb") as f:
            built = f.read()
        assert fresh == built, (profile, kind)


def test_model_path_builds_on_first_use(tmp_path):
    p = synth.model_path("synth_simple", "datok", build_dir=str(tmp_path))
    assert os.path.exists(p)
    assert os.path.exists(tmp_path / "synth_simple.matok")
    assert dt.load_tokenizer_file(p).type() == "DATOK"
    with pytest.raises(ValueError):
        synth.model_path("synth_simple", "fst", build_dir=str(tmp_path))
    with pytest.raises(KeyError):
        synth.model_path("no_such_profile", build_dir=str(tmp_path))


def test_stale_build_is_rebuilt(tmp_path):
    """A build is current only while its stamp matches the sources; a
    changed stamp (an edit to the generator or a serializer) rebuilds."""
    d = str(tmp_path)
    assert not synth.is_current("synth_simple", d)
    p = synth.model_path("synth_simple", build_dir=d)
    assert synth.is_current("synth_simple", d)
    good = open(p, "rb").read()
    (tmp_path / "synth_simple.stamp").write_text("old sources\n")
    (tmp_path / "synth_simple.matok").write_bytes(b"stale")
    assert not synth.is_current("synth_simple", d)
    assert open(synth.model_path("synth_simple", build_dir=d), "rb").read() == good
    assert synth.is_current("synth_simple", d)
    assert synth.build_stamp("synth_simple") != synth.build_stamp("synth_small")


def test_eot_symbol_variants(small_tok):
    simple = dt.load_matrix_file(synth.model_path("synth_simple"))
    assert 4 in small_tok.sigma and 4 not in simple.sigma
    # alphabet + 3 specials + the final column
    assert len(small_tok.array) // (small_tok.state_count + 1) == 171
    assert len(simple.array) // (simple.state_count + 1) == 170


def test_automaton_follows_datok_conventions():
    auto, vocab = synth.build_automaton("synth_small")
    assert (auto.epsilon, auto.unknown, auto.identity) == (1, 2, 3)
    assert auto.final == auto.sigma_count
    assert 1 not in auto.transitions[1]  # no token bound at the root
    for s in range(1, auto.state_count + 1):
        for sym, e in (auto.transitions[s] or {}).items():
            if sym == auto.epsilon:
                assert e.tokenend and e.end in (1, 2)
            elif e.nontoken:
                # only whitespace, EOT and the backtick state drop chars
                assert s in (1, 3) and e.end in (1, 3)
    assert len(vocab.abbrevs) == synth.PROFILES["synth_small"].n_abbrev
    assert all(a.endswith(".") for a in vocab.abbrevs)


def test_documents_are_seeded():
    a = synth.documents("synth_small", [100, 500, 2000], seed=4)
    b = synth.documents("synth_small", [100, 500, 2000], seed=4)
    c = synth.documents("synth_small", [100, 500, 2000], seed=5)
    assert a == b and a != c
    for doc, n in zip(a, [100, 500, 2000]):
        assert len(doc) >= n and doc.endswith("\x04")
        assert doc.count("\x04") == 1


def test_texts_use_every_component():
    text = "".join(synth.sentence_pool("synth_de18k", n=4096))
    vocab = synth.vocabulary(synth.PROFILES["synth_de18k"])
    for needle in ("://", "@", "</", "&", ":)", "%", "ß", "#", "`"):
        assert needle in text, needle
    assert any(a in text for a in vocab.abbrevs[:50])
    assert any(ch in text for ch in synth.OOV_CHARS)
    assert any(f"{d}:" in text for d in "0123456789")  # times


def test_heavy_tail_lengths():
    x = synth.heavy_tail_lengths(10000, seed=1, median=1000, hi=100000)
    assert abs(np.median(x) - 1000) < 100
    assert x.max() > 20 * np.median(x)
    assert (synth.heavy_tail_lengths(50, seed=1)
            == synth.heavy_tail_lengths(50, seed=1)).all()
    assert MAX_SEGMENT < 100000


def test_lane_texts_shape_and_parity(small_tok):
    texts = synth.lane_texts("synth_small", 16, 300, seed=2)
    assert len(texts) == 16 and all(len(t) == 300 for t in texts)
    assert len(set(texts)) == 16
    eng = BatchEngine(small_tok, engine="general")
    for t, e in zip(texts, eng.events_batch(texts)):
        assert e == transduce_events(small_tok, t)


def test_force_emit_and_identity_paths(small_tok):
    """A lone '#' has no token bound (force-emit path); characters
    outside sigma take the identity → unknown retry inside words."""
    state = {}
    transduce_events(small_tok, "# x", state_counter=state)
    ev = transduce_events(small_tok, "a # b😀c")
    toks = [(s, e) for k, s, e in ev if k == 1]
    assert (2, 3) in toks  # '#'
    assert (4, 7) in toks  # 'b😀c' stays one word


# ---- engine="auto" ----------------------------------------------------


def test_auto_engine_choice(small_tok):
    eng = BatchEngine(small_tok)
    assert eng.engine == jax_engine.AUTO_ENGINE
    assert jax_engine.AUTO_ENGINE in ("general", "hot")
    dat = dt.load_datok_file(synth.model_path("synth_small", "datok"))
    eng_da = BatchEngine(dat)
    # auto converts double arrays to the dense matrix first
    assert eng_da.tok.type() == "MATOK"
    assert eng_da.engine == jax_engine.AUTO_ENGINE
    # the general machine runs the double array as it is
    assert BatchEngine(dat, engine="general").tok.type() == "DATOK"
    assert BatchEngine(small_tok, accelerated=False).engine == "general"
    with pytest.raises(ValueError):
        BatchEngine(small_tok, engine="pallas")


def test_auto_engine_does_not_depend_on_backend(small_tok, monkeypatch):
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert BatchEngine(small_tok).engine == jax_engine.AUTO_ENGINE


# ---- compile cache ----------------------------------------------------


def test_compile_cache_env_wins(monkeypatch):
    import jax

    from datok.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    assert compile_cache.enable_compile_cache() == "/some/where"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_in_checkout(monkeypatch):
    import jax

    from datok.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        d = compile_cache.enable_compile_cache()
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert d == os.path.join(root, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == d
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


# ---- card only ----------------------------------------------------------


@pytest.mark.gpu
def test_wave_parity_on_gpu(small_tok):
    """Both XLA machines on the card, byte-exact against the oracle
    (also covered at full size by chip_smoke.py)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run: JAX_PLATFORMS=cuda pytest -m gpu)")
    texts = synth.lane_texts("synth_small", 1024, 512, seed=9)
    for engine in ("general", "hot"):
        eng = BatchEngine(small_tok, engine=engine)
        for t, e in zip(texts[:64], eng.events_batch(texts)[:64]):
            assert e == transduce_events(small_tok, t)


def test_gzip_header_is_deterministic(tmp_path):
    from datok.fsa.io import gz_write

    gz_write(str(tmp_path / "a"), b"payload")
    gz_write(str(tmp_path / "b"), b"payload")
    a = (tmp_path / "a").read_bytes()
    assert a == (tmp_path / "b").read_bytes()
    assert gzip.decompress(a) == b"payload"
