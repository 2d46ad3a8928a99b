"""Matrix ↔ double-array equivalence (the reference's conformance
oracle pattern, matrix_test.go:1248-1275) plus constructed-vs-loaded
representation equivalence."""

import os

import pytest

import datok as dt
from datok.fsa.synth import build_automaton
from conftest import require_reference

# The reference's mixed-German benchmark text (matrix_test.go:13-21).
BENCH_TEXT = """Der Vorsitzende der Abk. hat gewählt. Gefunden auf wikipedia.org. Ich bin unter korap@ids-mannheim.de erreichbar.
Unsere Website ist https://korap.ids-mannheim.de/?q=Baum. Unser Server ist 10.0.10.51. Zu 50.4% ist es sicher.
Der Termin ist am 5.9.2018.
Ich habe die readme.txt heruntergeladen.
Ausschalten!!! Hast Du nicht gehört???
Ich wohne in der Weststr. und Du? Kupietz und Schmidt [2018]: Korpuslinguistik. Dieses verf***** Kleid! Ich habe die readme.txt heruntergeladen.
Er sagte: \"Es geht mir gut!\", daraufhin ging er. &quot;Das ist von C&A!&quot; Früher bzw. später ... Sie erreichte den 1. Platz!
Archive:  Ich bin kein zip. D'dorf Ku'damm Lu'hafen M'gladbach W'schaft.
Mach's macht's was'n ist's haste willste kannste biste kriegste."""

EXTRA_TEXTS = [
    "",
    "\n",
    "Der alte Mann.",
    "Erste.\n\n\n\n\x04\x0aNächst.\x04",
    "Ein Satz. Noch einer! Und \x04 noch einer?\x04",
    "tree.\x04abc\x04\x04",
    "  wald   gehen Da kann\t man was \"erleben\"!",
    "Emoji: 😀 und Pfeile → ← ok?",
    "a" * 3000 + ". Ende.",
]


def test_matok_datok_equivalence(mat_de, dat_de):
    for text in [BENCH_TEXT] + EXTRA_TEXTS:
        assert mat_de.tokenize(text) == dat_de.tokenize(text), repr(text[:40])


def test_da_to_matrix_equivalence(dat_de):
    """DaTokenizer.to_matrix preserves the DOUBLE-ARRAY behavior
    exactly (including any quirks of the committed table), which is
    what lets .datok models ride the fused-kernel engine."""
    mat2 = dat_de.to_matrix()
    assert mat2.type() == "MATOK"
    for text in [BENCH_TEXT] + EXTRA_TEXTS:
        assert mat2.tokenize(text) == dat_de.tokenize(text), repr(text[:40])


def test_constructed_da_matches_loaded_matrix(mat_de):
    auto, _ = build_automaton("synth_de18k")
    # the matrix constructed from the same automaton must behave like
    # the loaded one
    mat2 = dt.MatrixTokenizer.from_automaton(auto)
    for text in [BENCH_TEXT, "Der alte Mann aß z.B. 3,5 Mio. Äpfel..."]:
        assert mat2.tokenize(text) == mat_de.tokenize(text)


@pytest.mark.parametrize(
    "name",
    ["simpletok", "wahlamt", "bauamt", "clitic_test", "synth_small",
     "synth_simple"],
)
def test_small_fst_representation_equivalence(name):
    if name.startswith("synth_"):
        auto, _ = build_automaton(name)
    else:
        fst = f"{name}.fst"
        auto = dt.load_foma_file(os.path.join(require_reference(fst), fst))
    mat = dt.MatrixTokenizer.from_automaton(auto)
    da = dt.DaTokenizer.from_automaton(auto)
    for text in [
        "bau bauamt wahlamt wahlen",
        "don't they're isn't",
        "  wald   gehen was \"erleben\"!",
        "",
        "x\x04y\x04",
    ]:
        assert mat.tokenize(text) == da.tokenize(text), (name, text)
