"""Engine exactness under runtime adaptation: lanes killed at a starved
step budget, the corpus auto-pack decision, and the event decoder's
guard against a truncated event slice.

A lane the device machine cannot finish within ``max_steps_for(L)``
comes back flagged ``bad`` and is redone exactly on the host; packing is
decided at run time from the median document length.
"""

import numpy as np
import pytest

from datok.runtime.jax_engine import BatchEngine

STALL_TEXTS = [
    "Zyklotronresonanz vexiert jodhaltige Quarzbrocken famos und "
    "die Psychopharmakakommission qualifizierte Oxymorone.",
    "Der alte Mann ging heim.",
    "Wachstumsschmerzen plagen juvenile Axolotl, ca. 7,5%.",
]


@pytest.fixture(scope="module")
def eng(mat_de):
    return BatchEngine(mat_de, engine="general")


@pytest.mark.parametrize("machine", ["general", "hot"])
def test_budget_kill_repairs_exactly(mat_de, machine):
    """Lanes killed at the global step budget must repair EXACTLY on
    the host: a deliberately starved budget (fewer steps than chars)
    over long lanes of novel vocabulary."""
    e = BatchEngine(mat_de, engine=machine, steps_factor=0.25)
    texts = [" ".join(STALL_TEXTS * 4)] * 2 + STALL_TEXTS
    meta, lengths, _ = e.encoder.encode_batch(texts)
    _ys, bad, n_steps, _ = e.run_raw(meta, lengths)
    assert n_steps <= e.max_steps_for(meta.shape[1])
    assert bad[:2].all()  # the long lanes cannot finish in L/4 + 64 steps
    got = e.tokenize_batch(texts)
    want = [mat_de.tokenize(t) for t in texts]
    assert got == want


def test_corpus_auto_pack_decision(tmp_path, mat_de, eng):
    from datok.runtime.corpus import CorpusRunner

    tiny = "Kurz.\x04" * 400
    (tmp_path / "tiny.txt").write_text(tiny)
    big = ("Der alte Mann ging sehr langsam über die lange Straße "
           "hinunter zum Fluss und wieder zurück. " * 8 + "\x04") * 40
    (tmp_path / "big.txt").write_text(big)

    for name, want_pack in (("tiny.txt", 1024), ("big.txt", 0)):
        st = {}
        r = CorpusRunner(mat_de, str(tmp_path / ("out_" + name)),
                         engine=eng)
        r.run([str(tmp_path / name)], stats=st)
        assert st["pack_len"] == want_pack, (name, st)
        src = (tmp_path / name).read_text()
        out = (tmp_path / ("out_" + name) / (name + ".tok")).read_text()
        assert out == mat_de.tokenize(src)


def test_native_decode_events_rejects_narrow_slice(mat_de, eng):
    """A narrower event-row slice than counts implies must fail loud:
    downstream offsets use the unclamped counts, so silent truncation
    would misattribute events across documents."""
    from datok.utils.native import native_decode_events

    ev, counts, bad, _ = eng.run_events_compact(
        *eng.encoder.encode_batch(["Der alte Mann ging heim."] * 4)[:2]
    )
    assert not bad.any()
    if native_decode_events(ev, counts) is None:
        pytest.skip("native library unavailable")
    wide = int(counts.max())
    assert wide > 1
    with np.testing.assert_raises(ValueError):
        native_decode_events(ev[:, : wide - 1], counts)
