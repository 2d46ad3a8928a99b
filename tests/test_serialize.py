"""Serialization parity: byte-identical conversion and round-trips.

The reference's `.matok` content is a deterministic function of the
FST, so converting a committed `.fst` must reproduce the committed
`.matok` byte for byte (gzip layer excluded).  `.datok` layout depends
on Go map iteration order, so only load→save round-trips are byte
checked there; constructed double arrays are checked behaviorally.
The reference's files are optional (those cases skip without them);
the generated grammars (datok.fsa.synth) stand in for them.
"""

import gzip
import os

import pytest

import datok as dt
from datok.fsa import synth
from conftest import require_reference

SYNTH = ["synth_small", "synth_simple"]


def _path(name: str, ext: str) -> str:
    """Generated model file, or the reference's (skip when absent)."""
    if name.startswith("synth_"):
        return synth.model_path(name, ext)
    return os.path.join(require_reference(f"{name}.{ext}"), f"{name}.{ext}")


def _automaton(name: str):
    if name.startswith("synth_"):
        return synth.build_automaton(name)[0]
    return dt.load_foma_file(_path(name, "fst"))


@pytest.mark.parametrize(
    "name",
    ["simpletok", "tokenizer_de", "tokenizer_en", "clitic_test"] + SYNTH,
)
def test_convert_matrix_byte_parity(name):
    mat = dt.MatrixTokenizer.from_automaton(_automaton(name))
    ref = gzip.open(_path(name, "matok"), "rb").read()
    assert mat.to_bytes() == ref


@pytest.mark.parametrize(
    "name", ["simpletok", "tokenizer_de", "tokenizer_en"] + SYNTH
)
def test_matok_roundtrip(name):
    raw = gzip.open(_path(name, "matok"), "rb").read()
    mat = dt.parse_matrix(raw)
    assert mat.to_bytes() == raw


@pytest.mark.parametrize("name", ["simpletok", "tokenizer_de"] + SYNTH)
def test_datok_roundtrip(name):
    raw = gzip.open(_path(name, "datok"), "rb").read()
    da = dt.parse_datok(raw)
    assert da.to_bytes() == raw


def test_matok_header_fields(mat_de):
    # the published DE model's shape (BASELINE.md:18): 18,400 states ×
    # 171 symbols; the generated stand-in is held to ±5 % of it
    S = mat_de.state_count
    assert abs(S - 18400) <= 0.05 * 18400
    assert mat_de.epsilon == 1
    assert mat_de.unknown == 2
    assert mat_de.identity == 3
    assert len(mat_de.array) == (S + 1) * 171


def test_datok_stats(dat_de):
    # LoadFactor >= 60% asserted by the reference (datok_test.go:239)
    assert dat_de.load_factor() >= 60
    assert dat_de.get_size() == len(dat_de.base)


def test_constructed_da_load_factor():
    # > 88 on the Kanda-style bench FST (datok_test.go:1238-1243)
    auto = dt.load_foma_file(_path("abbr_bench", "fst"))
    da = dt.DaTokenizer.from_automaton(auto)
    assert da.load_factor() > 88


def test_load_tokenizer_file_dispatch():
    mat = dt.load_tokenizer_file(synth.model_path("synth_de18k"))
    assert mat.type() == "MATOK"
    da = dt.load_tokenizer_file(synth.model_path("synth_simple", "datok"))
    assert da.type() == "DATOK"


def test_constructed_da_roundtrip():
    da = dt.DaTokenizer.from_automaton(_automaton("synth_simple"))
    raw = da.to_bytes()
    assert dt.parse_datok(raw).to_bytes() == raw
