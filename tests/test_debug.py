"""Divergence introspection (runtime/debug.py)."""

import numpy as np

from datok.runtime.debug import (
    device_events,
    dump_divergence,
    oracle_trace,
    show_buffer,
)
from datok.runtime.jax_engine import BatchEngine


def test_oracle_trace_shape(mat_de):
    evs, log = oracle_trace(mat_de, "Der alte Mann.")
    assert evs and log
    assert any("Check" in ln and "c=" in ln for ln in log)


def test_show_buffer_markers():
    s = show_buffer("Der alte Mann ging heim.", 4, 8)
    assert "⟦" in s and "∣" in s
    assert s.index("⟦") < s.index("∣")


def test_device_matches_oracle_no_dump(mat_de, capsys):
    eng = BatchEngine(mat_de, engine="hot")
    assert dump_divergence(eng, "Der alte Mann. Er ging z.B. heim!") is None


def test_dump_reports_mismatch(mat_de, monkeypatch):
    """Force a fake divergence (truncated device stream) and check the
    report contents."""
    import io

    import datok.runtime.debug as dbg

    eng = BatchEngine(mat_de, engine="hot")
    real = dbg.device_events

    def broken(engine, doc, entry=1):
        evs, bad = real(engine, doc, entry)
        evs = list(evs)
        evs[2] = (evs[2][0], evs[2][1], evs[2][2] + 1)  # corrupt one
        return evs, bad

    monkeypatch.setattr(dbg, "device_events", broken)
    buf = io.StringIO()
    r = dbg.dump_divergence(eng, "Der alte Mann ging heim.", out=buf)
    assert r is not None and r["mismatch_event"] == 2
    text = buf.getvalue()
    assert "divergence" in text and "oracle[" in text and "device[" in text
