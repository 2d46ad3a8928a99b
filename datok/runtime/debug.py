"""Device↔oracle divergence introspection.

The reference has DEBUG-gated per-transition logging and a buffer
visualizer (datok.go:40,733-766; matrix.go:412-414).  The device
engines are batched and traced, so per-step printing is impossible *inside*
the machine — instead this module reconstructs both sides' views on
the host for one lane:

* :func:`oracle_trace` — the scalar oracle's per-transition log (the
  reference's DEBUG output shape) plus its event stream;
* :func:`device_events` — the device machine's raw step-ordered event
  stream for the same document (single lane, uncompacted ``ys``);
* :func:`dump_divergence` — aligns the two event streams, reports the
  first mismatch with the surrounding text (buffer visualizer:
  ``...text [b→c] text...``), and prints the oracle's transition log
  around the diverging cursor.

The exactness pipelines call :func:`dump_divergence` automatically on
a device↔oracle mismatch when ``DATOK_DEBUG_DIVERGENCE`` is set —
otherwise they repair silently (host replay) as before.
"""

from __future__ import annotations

import io
import os
import sys
from contextlib import redirect_stdout
from typing import List, Optional, Tuple

import numpy as np

from .events import EV_SENT, EV_TEXT, EV_TOKEN
from .oracle import transduce_events


def oracle_trace(tok, doc: str, entry: int = 1):
    """Scalar-oracle events + per-transition log lines for one doc."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        evs = transduce_events(tok, doc, debug=True, entry_state=entry)
    return evs, buf.getvalue().splitlines()


def device_events(engine, doc: str, entry: int = 1) -> List[Tuple[int, int, int]]:
    """Device machine's event stream for ``doc`` as one lane."""
    meta, lengths, _ = engine.encoder.encode_batch([doc])
    ys, bad, steps, state = engine.run_raw(
        meta, lengths, entries=np.asarray([entry], np.int32)
    )
    from .jax_engine import decode_events_batch

    return decode_events_batch(np.asarray(ys), int(steps))[0], bool(bad[0])


def show_buffer(text: str, b: int, c: int, width: int = 30) -> str:
    """Reference-style buffer visualizer: text window with the pending
    token start (``b``) and cursor (``c``) marked."""
    lo = max(0, min(b, c) - width)
    hi = min(len(text), max(b, c) + width)
    out = []
    for i in range(lo, hi):
        if i == b:
            out.append("⟦")
        if i == c:
            out.append("∣")
        out.append(text[i].replace("\n", "\\n").replace("\x04", "␄"))
    return "".join(out)


_KIND = {EV_TOKEN: "TOKEN", EV_SENT: "SENT", EV_TEXT: "TEXT"}


def dump_divergence(
    engine,
    doc: str,
    entry: int = 1,
    out=None,
    context: int = 6,
) -> Optional[dict]:
    """Compare device vs oracle event streams for one document.

    Returns None if they match; otherwise prints an aligned report to
    ``out`` (stderr by default) and returns a dict with the mismatch
    index, both streams around it, and the buffer view.
    """
    out = out if out is not None else sys.stderr
    want = transduce_events(engine.tok, doc, entry_state=entry)
    got, bad = device_events(engine, doc, entry=entry)
    got = [tuple(e) for e in got]
    want = [tuple(e) for e in want]
    if got == want and not bad:
        return None
    k = next(
        (i for i, (a, b) in enumerate(zip(got, want)) if a != b),
        min(len(got), len(want)),
    )
    pos = want[k][1] if k < len(want) else (want[-1][2] if want else 0)

    def fmt(evs):
        return [
            f"{_KIND.get(kd, kd)}[{s}:{e}]={doc[s:e]!r}"
            if kd == EV_TOKEN
            else f"{_KIND.get(kd, kd)}[{s}:{e}]"
            for kd, s, e in evs
        ]

    print("=== device↔oracle divergence ===", file=out)
    print(f"lane flagged bad: {bad}; first mismatch at event {k}", file=out)
    print(f"buffer: {show_buffer(doc, pos, pos)}", file=out)
    lo = max(0, k - context)
    print(f"oracle[{lo}:{k + context}]: "
          f"{fmt(want[lo : k + context])}", file=out)
    print(f"device[{lo}:{k + context}]: "
          f"{fmt(got[lo : k + context])}", file=out)
    _evs, log = oracle_trace(engine.tok, doc, entry=entry)
    near = [ln for ln in log if f"c={pos}" in ln or f"c={pos + 1}" in ln
            or f"c={pos - 1}" in ln]
    if near:
        print("oracle transitions near the divergence:", file=out)
        for ln in near[:12]:
            print("  " + ln, file=out)
    return {
        "mismatch_event": k,
        "position": pos,
        "device_bad": bad,
        "oracle": want[lo : k + context],
        "device": got[lo : k + context],
    }


def divergence_debug_enabled() -> bool:
    return bool(os.environ.get("DATOK_DEBUG_DIVERGENCE"))
