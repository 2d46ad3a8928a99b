"""Host orchestration: stream → lanes → events → formatted output.

The reference processes one stream with one goroutine (SURVEY.md §2.3);
production parallelism was "run many processes".  Here a stream is
split into documents at ``\\x04`` (EOT) boundaries — exact, because a
conforming tokenizer grammar returns to the root state after EOT
(verified per model: every EOT arc reachable in the table targets the
root) — and documents are transduced as parallel device lanes.  Events
are replayed in order through one TokenWriter, which reproduces the
reference's single-stream output byte for byte (including position
counters that persist across texts).

Documents longer than the packed-event segment limit run on device
in one of two exact modes (SURVEY.md §5 "long-context"):

* *chained* (``events_long_batch``): each segment stops cleanly at its
  cut and hands the machine context checkpointed at its last buffer
  rewind to the next segment, which re-reads only the pending token's
  text.  Segments of one document are sequential; parallelism comes
  from processing many documents at once.
* *speculative* (``events_speculative_batch``): all segments of all
  documents run as one parallel wave; non-initial segments start from
  a guessed fresh context at their cut and each cut is verified on
  host by rewind-stream convergence, falling back to chaining for the
  rare document where speculation fails.  This parallelizes *inside*
  a single giant document.

Both are exact for any input, with host fallback for pathological
single tokens longer than a segment.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..fsa.io import FIRSTBIT
from .events import EV_SENT, replay_events
from .jax_engine import MAX_SEGMENT, BatchEngine
from .oracle import transduce_events, transduce_events_fast
from .writer import SIMPLE, TokenWriter


def split_documents(text: str, epilogue_sentinel: bool = True) -> List[str]:
    """Split a stream into chunks, each ending just after an EOT.

    ``epilogue_sentinel`` appends an EMPTY final chunk when the stream
    ends exactly at an EOT: documents ending in ``\\x04`` are
    transduced as *cuts* (no EOF epilogue — the stream continues past
    an interior EOT, matrix.go:593-605 vs 637-697), so the stream-final
    epilogue (trailing ε chase + implicit ends from the post-EOT state)
    runs as its own zero-length chunk chained from the last exit
    context.  ``"".join(result) == text`` either way.
    """
    out = []
    start = 0
    while True:
        i = text.find("\x04", start)
        if i < 0:
            break
        out.append(text[start : i + 1])
        start = i + 1
    if start < len(text) or not out:
        out.append(text[start:])
    elif epilogue_sentinel:
        out.append("")
    return out


def eot_in_sigma(tok) -> bool:
    """True if ``\\x04`` is a real sigma symbol of the model.

    This is the property that makes EOT-boundary *cuts* clean: the
    ``eot`` flag set at the read of a real EOT symbol provably survives
    to a buffer rewind (success → EOT rewind, matrix.go:593-605; hard
    fail → force-emit rewind, matrix.go:499-551 — the only flag-dropping
    path, the identity→unknown retry, requires the symbol to BE the
    identity fallback, i.e. ``\\x04`` absent from sigma).  So a document
    ending in ``\\x04`` always leaves the machine at ``b == c == len``
    with cleared backtrack registers, and its packed exit context fully
    determines the stream continuation.  Models WITHOUT ``\\x04`` in
    sigma may consume it as a plain unknown character mid-token; for
    those, splitting at EOT is not exact at all and the stream must be
    processed as one document (the long-document machinery is exact for
    any model).
    """
    return 4 in tok.sigma


def split_stream(tok, text: str) -> List[str]:
    """Model-aware stream split: EOT chunks + epilogue sentinel when
    EOT cuts are provably clean (:func:`eot_in_sigma`), else the whole
    stream as one document."""
    if eot_in_sigma(tok):
        return split_documents(text, epilogue_sentinel=True)
    return [text]


def transduce_doc_exact(tok, doc: str, entry: int, cut: bool,
                        encoder=None):
    """Host-exact transduce of one stream chunk; returns
    ``(events, exit_ctx)``.

    ``cut=True`` (a chunk ending in ``\\x04`` interior to its stream)
    stops at ``len(doc)`` with no EOF epilogue — the stream-exact
    semantics; ``cut=False`` runs the full walk with the epilogue (a
    stream-final chunk).  Native cut walk / native transduce when
    available, Python oracle otherwise.
    """
    if not cut:
        box: List[int] = []
        ev = transduce_events_fast(
            tok, doc, entry_state=int(entry), exit_box=box
        )
        return ev, (box[0] if box else 1)
    metas = _full_doc_metas(encoder, doc) if encoder is not None else None
    ev, rw = _cut_walk(tok, doc, metas, int(entry), 0, len(doc))
    pos, ctx, nev = rw[-1]
    if pos == len(doc) and nev == len(ev):
        return list(ev), int(ctx)
    # Unreachable for eot_in_sigma models (proof in eot_in_sigma's
    # docstring).  A silent fallback here would run the EOF epilogue on
    # an interior chunk — emitting implicit sentence/text ends
    # mid-stream, i.e. NON-stream-exact output diverging from the
    # reference with only a log line as evidence.  Fail loud instead:
    # if this ever fires, the cleanliness proof is wrong for this model
    # and stream splitting must not be used on it.
    raise RuntimeError(
        "EOT-ending interior chunk left an unclean cut "
        f"(b={pos} != len={len(doc)}, events {nev}/{len(ev)}): the "
        "eot_in_sigma cut-cleanliness invariant is violated for this "
        "model; process the stream unsplit (split_stream would need "
        "eot_in_sigma()=False for it)"
    )


def eot_split_safe(tok) -> bool:
    """True if every EOT arc in the model targets the root state.

    This is the property that makes document splitting exact: after a
    chunk ending in ``\\x04`` the machine is in the same state a fresh
    chunk starts in.
    """
    cached = getattr(tok, "_eot_split_safe", None)
    if cached is not None:
        return cached
    safe = False
    if tok.type() == "MATOK":
        a = int(tok.sigma_ascii[4])
        if a > 0:
            S = tok.state_count
            col = np.asarray(tok.array[(a - 1) * S : (a - 1) * S + S + 1])
            targets = np.unique(col[col != 0] & ~np.uint32(FIRSTBIT))
            # every EOT arc targets the root, and the root accepts EOT
            # (so the never-fail retry path also converges to the root)
            safe = col[1] != 0 and set(targets.tolist()) <= {1}
    else:
        # double array: check every *reachable* state's EOT target
        # (unreachable cells can alias valid-looking transitions).
        from ..fsa.io import RESTBIT

        a = int(tok.sigma_ascii[4])
        if a > 0:
            base = np.asarray(tok.base, dtype=np.int64)
            check = np.asarray(tok.check, dtype=np.int64)
            size = int(check[1] & RESTBIT)
            n = len(base)
            A = max(max(tok.sigma.values(), default=0), tok.final) + 1
            sym = np.arange(1, A, dtype=np.int64)
            # the 'final' pseudo-symbol marks finality and is never a
            # runtime input — its cells are not states
            sym = sym[sym != tok.final]
            eot_pos = int(np.searchsorted(sym, a))

            seen = np.zeros(n, dtype=bool)
            seen[1] = True
            frontier = [1]
            finals = set()
            while frontier:
                nxt = []
                for s in frontier:
                    tc = (base[s] & RESTBIT) + sym
                    ok = (tc <= size) & (tc < n)
                    tcc = np.clip(tc, 0, n - 1)
                    valid = ok & ((check[tcc] & RESTBIT) == s)
                    tgts = tcc[valid]
                    sep = (base[tgts] & (1 << 31)) != 0
                    reps = np.where(sep, base[tgts] & RESTBIT, tgts)
                    if valid[eot_pos]:  # EOT arc from this state
                        te = int(tcc[eot_pos])
                        if base[te] & (1 << 31):
                            te = int(base[te] & RESTBIT)
                        finals.add(te)
                    for t in np.unique(reps):
                        t = int(t)
                        if 0 < t < n and not seen[t]:
                            seen[t] = True
                            nxt.append(t)
                frontier = nxt
            root_tc = (base[1] & RESTBIT) + a
            root_ok = (
                root_tc <= size
                and root_tc < n
                and (check[root_tc] & RESTBIT) == 1
            )
            safe = root_ok and finals <= {1}
    tok._eot_split_safe = safe
    return safe


# Packed context flag bits (oracle.py entry layout): after an EOT the
# machine has emitted both the sentence and the text end, so the
# canonical post-EOT context is root + both flags (+ the stale-ok bit
# carried from the last non-ASCII codepoint seen, matrix.go:421-435).
SPLIT_FLAGS = (1 << 28) | (1 << 29)


def _stale_ok_after(encoder, doc: str, ok: int) -> int:
    """Stale-``ok`` register value after transducing ``doc``.

    The reference reassigns ``ok`` only on the non-ASCII symbol path,
    so the exit value is "was the last codepoint ≥ 256 in sigma",
    falling back to the entry value for pure-ASCII documents.
    """
    if doc.isascii():
        return ok
    # scan a bounded tail in Python (non-ASCII is dense in real text);
    # fall back to a vectorized full scan for pathological tails
    tail = doc[-4096:]
    for ch in reversed(tail):
        if ord(ch) >= 256:
            keys = encoder.keys
            i = int(np.searchsorted(keys, ord(ch)))
            return int(i < len(keys) and keys[i] == ord(ch))
    if len(doc) > len(tail):
        return _stale_ok_at_cuts(encoder, doc, [len(doc)], ok)[0]
    return ok


def predict_entries(encoder, docs: Sequence[str], entry: int = 1,
                    breaks=None):
    """Predicted packed entry contexts for an EOT-split document list.

    Every non-final document ends in EOT, after which a conforming
    model sits at the root with both end flags set and the chained
    stale-``ok`` bit — dispatching successors with THIS context (not
    bare root) makes the speculative chain verify on the first round
    for ordinary corpora, where bare-root speculation forced a second
    pass for every document.  Exactness is unchanged: the caller still
    verifies real exits against these predictions and repairs
    mismatches (e.g. models whose EOT arcs don't return to the root).

    Returns ``(entries[n] int32, next_entry)`` — the context predicted
    after the final document (for cross-wave chaining).

    ``breaks[k]`` true marks document k as the start of a NEW stream
    (e.g. a new corpus file): its entry is the fresh-transduce root
    context by definition, not chained from the previous document.
    """
    n = len(docs)
    ents = np.empty(n, dtype=np.int32)
    cur = int(entry)
    for k, doc in enumerate(docs):
        if breaks is not None and breaks[k]:
            cur = 1
        ents[k] = cur
        ok = _stale_ok_after(encoder, doc, (cur >> 30) & 1)
        cur = 1 | SPLIT_FLAGS | (ok << 30)
    return ents, cur


def events_long_batch(
    engine: BatchEngine,
    docs: Sequence[str],
    seg_len: int = 8192,
    entries: Optional[np.ndarray] = None,
    stops=None,
):
    """Transduce long documents on device via chained segmentation.

    Each document is processed as fixed-length segments; a segment cuts
    cleanly at its end (no EOF epilogue).  The machine checkpoints its
    packed context at every buffer rewind — the point where all
    backtrack registers are provably reset (matrix.go:608-627) — so the
    next segment resumes exactly by re-reading from the pending token's
    start in the checkpointed context (SURVEY.md §5 "long-context":
    exit-state chaining; the backtrack window never crosses the last
    emitted token, so the re-read is at most one token plus trailing
    whitespace).  Trailing sentence-end events after the last rewind
    are dropped from the cut segment because the resumed replay
    re-emits them.  Segments of one document are sequential;
    *different documents' segments run as parallel lanes*, so
    corpus-level parallelism is preserved.

    Returns (events, exit_ctxs) with absolute positions per document.
    """
    n = len(docs)
    events: List[List] = [[] for _ in range(n)]
    pos = [0] * n  # current segment origin per doc
    ctx = np.ones(n, dtype=np.int32)
    if entries is not None:
        ctx[:] = entries
    orig_entry = ctx.copy()
    # stops[k]: doc k ends in EOT interior to its stream — its FINAL
    # segment also cuts (no EOF epilogue), see transduce_doc_exact
    doc_stop = np.zeros(n, dtype=bool)
    if stops is not None:
        doc_stop[:] = stops
    done = [len(d) == 0 for d in docs]
    exit_ctx = np.ones(n, dtype=np.int32)

    def host_whole_doc(k: int) -> None:
        """Exact host fallback: redo document k from scratch."""
        events[k], exit_ctx[k] = transduce_doc_exact(
            engine.tok, docs[k], int(orig_entry[k]), bool(doc_stop[k]),
            encoder=engine.encoder,
        )
        done[k] = True

    while not all(done):
        lanes = [k for k in range(n) if not done[k]]
        seg_texts = []
        is_last = []
        for k in lanes:
            seg = docs[k][pos[k] : pos[k] + seg_len]
            seg_texts.append(seg)
            is_last.append(pos[k] + seg_len >= len(docs[k]))
        meta, lengths, _ = engine.encoder.encode_batch(seg_texts)
        ys, bad, n_steps, state = engine.run_raw(
            meta,
            lengths,
            entries=ctx[lanes],
            stops=~np.asarray(is_last) | doc_stop[lanes],
        )
        decoded = decode_events_batch_from(ys, n_steps)
        for j, k in enumerate(lanes):
            if bad[j]:
                host_whole_doc(k)
                continue
            off = pos[k]
            if is_last[j]:
                events[k].extend(
                    (kd, s + off, e + off) for kd, s, e in decoded[j]
                )
                exit_ctx[k] = int(state[j, 0])
                done[k] = True
            else:
                b_exit = int(state[j, 2])
                if b_exit <= 0:
                    # pending token spans the whole segment — exact
                    # host fallback rather than spinning
                    host_whole_doc(k)
                    continue
                evs = decoded[j]
                # trailing sentence-end events after the last rewind are
                # re-emitted by the next segment's replay — drop them
                while evs and evs[-1][0] == 2:
                    evs = evs[:-1]
                events[k].extend((kd, s + off, e + off) for kd, s, e in evs)
                ctx[k] = int(state[j, 1])  # checkpoint context at b
                pos[k] += b_exit
    return events, exit_ctx


def decode_events_batch_from(ys, n_steps):
    from .jax_engine import decode_events_batch

    return decode_events_batch(ys, n_steps)


def _stale_ok_at_cuts(encoder, doc: str, cuts, entry_ok: int):
    """Exact stale-``ok`` flag at each cut position.

    The reference only (re)assigns ``ok`` on the non-ASCII symbol path
    (matrix.go:421-435), so its value at any position is "was the last
    codepoint ≥ 256 before here in sigma" — bug-compatible persistence
    that a speculative segment's entry context must reproduce, or pure
    ASCII stretches could never converge with the true machine.
    """
    cps = np.frombuffer(
        doc.encode("utf-32-le", "surrogatepass"), dtype=np.uint32
    )
    hi = np.nonzero(cps >= 256)[0]
    keys = encoder.keys
    if hi.size and len(keys):
        vals = cps[hi].astype(np.int64)
        idx = np.clip(np.searchsorted(keys, vals), 0, len(keys) - 1)
        known = keys[idx] == vals
    else:
        known = np.zeros(len(hi), dtype=bool)
    out = []
    for cut in cuts:
        p = int(np.searchsorted(hi, cut))
        out.append(int(entry_ok) if p == 0 else int(known[p - 1]))
    return out


def _full_doc_metas(encoder, doc: str):
    """Absolute-indexed packed symbol metas for a whole document.

    Used by the native cut walks; None when the native encoder is
    unavailable (cut walks then run on the Python oracle).  One char
    per codepoint, matching Python string indexing.
    """
    try:
        from ..utils.native import native_encode

        r = native_encode(encoder, doc.encode("utf-8", "surrogatepass"))
        if r is not None:
            return r[1]
    except Exception:
        pass
    return None


def _cut_walk(tok, text, metas, entry, start, stop):
    """One bounded walk: events + rewind stream, native when possible."""
    if metas is not None:
        from ..utils.native import native_cut_walk

        r = native_cut_walk(tok, metas, entry, start, stop)
        if r is not None:
            return r
    rw: List = []
    ev = transduce_events(
        tok, text, entry_state=entry, start=start, stop_at=stop,
        rewinds_box=rw,
    )
    return ev, rw


def _verify_cut(
    tok, text: str, x_ctx: int, x_pos: int, cut: int, spec_entry: int,
    seg_end: int, windows=(256, 2048, 8192), metas=None,
):
    """Verify one speculative cut; return the splice or None.

    Walks the *true* machine (host oracle) from the previous segment's
    rewind checkpoint ``(x_ctx, x_pos)`` across the cut, and the
    *speculative* machine from ``(spec_entry, cut)`` — the exact entry
    the device lane used — recording both rewind-checkpoint streams.
    The first true rewind at/after the cut that coincides with a
    speculative rewind (same position, same packed context) proves the
    two machines are in identical configurations; everything the device
    lane emitted from that rewind on is exact.

    Returns ``(true_events, n_spec_drop, spec_prefix)``:
    the exact events covering ``[x_pos, convergence)`` (absolute
    positions), the number of leading device events to drop, and the
    host-replayed prefix those dropped events must equal (a device↔
    oracle divergence check).  ``None`` = no convergence in the window
    (pathological input — caller falls back to chained segmentation).
    """
    for w in windows:
        stop = min(cut + w, seg_end)
        spec_ev, spec_rw = _cut_walk(tok, text, metas, spec_entry, cut, stop)
        spec_at = {pos: (ctx, nev) for pos, ctx, nev in spec_rw}
        tr_ev, tr_rw = _cut_walk(tok, text, metas, x_ctx, x_pos, stop)
        for pos, ctx, nev in tr_rw:
            if pos < cut:
                continue
            hit = spec_at.get(pos)
            if hit is not None and hit[0] == ctx:
                return tr_ev[:nev], hit[1], spec_ev[: hit[1]]
        if stop >= seg_end:
            break
    return None


def events_speculative_batch(
    engine: BatchEngine,
    docs: Sequence[str],
    seg_len: int = 8192,
    entries: Optional[np.ndarray] = None,
    max_lanes: int = 4096,
    stops=None,
):
    """Transduce long documents via *speculative* segmentation.

    Unlike :func:`events_long_batch` (sequential chaining of one
    document's segments), every segment of every document runs as a
    parallel device lane in one wave: segment 0 with the exact entry,
    later segments speculatively from a fresh root context at their cut
    (with the exact stale-``ok`` bit).  Cuts are then verified on host
    by rewind-stream convergence (see :func:`_verify_cut`) — the
    SURVEY.md §5 "overlap + speculative state-walk until lane state
    converges" design.  Convergence normally happens at the first or
    second token boundary after a cut, so the host walk is a few
    hundred characters per cut.  Any document whose cuts fail to
    verify (e.g. a single token spanning a whole segment) falls back
    to exact chained segmentation.

    Returns (events, exit_ctxs) with absolute positions per document.
    """
    tok = engine.tok
    n = len(docs)
    ent = np.ones(n, dtype=np.int32)
    if entries is not None:
        ent[:] = entries
    doc_stop = np.zeros(n, dtype=bool)
    if stops is not None:
        doc_stop[:] = stops

    # ---- lane plan: all segments of all documents -----------------------
    doc_cuts: List[List[int]] = []
    lane_text: List[str] = []
    lane_entry: List[int] = []
    lane_stop: List[bool] = []
    lane_of: List[List[int]] = []  # per doc: lane indices in segment order
    spec_entry_of: List[List[int]] = []
    doc_metas: List = []
    for k, doc in enumerate(docs):
        cuts = list(range(0, len(doc), seg_len)) or [0]
        doc_cuts.append(cuts)
        doc_metas.append(
            _full_doc_metas(engine.encoder, doc) if len(cuts) > 1 else None
        )
        entry_ok = (int(ent[k]) >> 30) & 1
        oks = _stale_ok_at_cuts(engine.encoder, doc, cuts, entry_ok)
        lanes = []
        spec_entries = []
        for j, cut in enumerate(cuts):
            e = int(ent[k]) if j == 0 else (1 | (oks[j] << 30))
            spec_entries.append(e)
            lanes.append(len(lane_text))
            lane_text.append(doc[cut : cut + seg_len])
            lane_entry.append(e)
            # the final segment of an EOT-interior doc cuts too (the
            # stream-final epilogue is a separate sentinel chunk)
            lane_stop.append(j < len(cuts) - 1 or bool(doc_stop[k]))
        lane_of.append(lanes)
        spec_entry_of.append(spec_entries)

    # ---- one parallel wave over all segments (grouped by lane budget) ---
    total = len(lane_text)
    decoded: List = [None] * total
    bad = np.zeros(total, dtype=bool)
    state = np.zeros((total, 6), dtype=np.int64)
    for gi in range(0, total, max_lanes):
        sl = slice(gi, min(gi + max_lanes, total))
        meta, lengths, _ = engine.encoder.encode_batch(lane_text[sl])
        ys, bad_g, n_steps, state_g = engine.run_raw(
            meta,
            lengths,
            entries=np.asarray(lane_entry[sl], dtype=np.int32),
            stops=np.asarray(lane_stop[sl], dtype=bool),
        )
        dec_g = decode_events_batch_from(ys, n_steps)
        decoded[sl] = dec_g
        bad[sl] = np.asarray(bad_g, dtype=bool)
        state[sl] = np.asarray(state_g)[:, : state.shape[1]]

    # ---- stitch: verify each cut, splice exact events --------------------
    events: List[List] = [None] * n
    exit_ctx = np.ones(n, dtype=np.int32)
    chained_fallback: List[int] = []
    for k, doc in enumerate(docs):
        cuts = doc_cuts[k]
        lanes = lane_of[k]
        K = len(lanes)
        if any(bad[lane] for lane in lanes):
            chained_fallback.append(k)
            continue
        evs: List = []
        x_ctx = x_pos = None
        failed = False
        for j, lane in enumerate(lanes):
            cut = cuts[j]
            seg_end = cuts[j + 1] if j + 1 < K else len(doc)
            dec_abs = [(kd, s + cut, e + cut) for kd, s, e in decoded[lane]]
            drop = 0
            if j > 0:
                r = _verify_cut(
                    tok, doc, x_ctx, x_pos, cut, spec_entry_of[k][j],
                    seg_end, metas=doc_metas[k],
                )
                if r is None:
                    failed = True
                    break
                true_evs, drop, spec_prefix = r
                if drop > len(dec_abs) or dec_abs[:drop] != spec_prefix:
                    from .debug import divergence_debug_enabled

                    if divergence_debug_enabled():
                        import sys as _sys

                        print(
                            f"datok: speculative-cut divergence "
                            f"(lane {lane}, seg {j}, cut {cut}); "
                            f"falling back to exact host replay — "
                            f"use runtime.debug.dump_divergence on "
                            f"the document for a step trace",
                            file=_sys.stderr,
                        )
                    failed = True  # device↔oracle divergence — be exact
                    break
                evs.extend(true_evs)
            body = dec_abs[drop:]
            if j < K - 1:
                b_exit = int(state[lane, 2])
                if b_exit <= 0:
                    # no rewind inside the segment (token spans it all)
                    failed = True
                    break
                # events after the last rewind are re-emitted by the
                # next cut's true walk (only SENTs can follow a rewind)
                while body and body[-1][0] == EV_SENT:
                    body.pop()
                x_ctx = int(state[lane, 1])
                x_pos = cut + b_exit
            evs.extend(body)
        if failed:
            chained_fallback.append(k)
            continue
        events[k] = evs
        exit_ctx[k] = int(state[lanes[-1], 0])

    if chained_fallback:
        evs_c, exits_c = events_long_batch(
            engine,
            [docs[k] for k in chained_fallback],
            seg_len=seg_len,
            entries=ent[chained_fallback],
            stops=doc_stop[chained_fallback],
        )
        for k, ev, ex in zip(chained_fallback, evs_c, exits_c):
            events[k] = ev
            exit_ctx[k] = ex
    return events, exit_ctx


def events_until_checkpoint(
    engine: BatchEngine,
    text: str,
    entry: int = 1,
    seg_len: int = 8192,
    max_lanes: int = 4096,
):
    """Device-transduce ``text`` up to its LAST rewind checkpoint.

    The streaming analog of :func:`events_speculative_batch` for one
    *unterminated* document (no EOT, no EOF yet): every segment — the
    final one included — cuts cleanly at its end; all segments run as
    one parallel wave with speculative entries, cuts are verified by
    rewind-stream convergence, and the machine context checkpointed at
    the last buffer rewind is returned so the caller can resume when
    more input arrives (the reference's 1024-rune rewound ring buffer,
    matrix.go:365-371,608-627, generalized to device waves).

    Returns ``(events, ck_pos, ck_ctx)``: exact events covering
    ``[0, ck_pos)``, and the packed context at ``ck_pos``.  With no
    rewind in the whole text (one giant pending token) the checkpoint
    degenerates to ``([], 0, entry)``.
    """
    tok = engine.tok

    def host_tail():
        # exact bounded fallback: native/oracle walk with its rewind
        # stream; O(len(text)) once per pathological chunk
        metas = _full_doc_metas(engine.encoder, text)
        ev, rw = _cut_walk(tok, text, metas, int(entry), 0, len(text))
        best = None
        for pos, ctx, nev in rw:
            if pos > 0:
                best = (pos, ctx, nev)
        if best is None:
            return [], 0, int(entry)
        pos, ctx, nev = best
        evs = list(ev[:nev])
        while evs and evs[-1][0] == EV_SENT:
            evs.pop()
        return evs, pos, ctx

    cuts = list(range(0, len(text), seg_len)) or [0]
    K = len(cuts)
    metas = _full_doc_metas(engine.encoder, text) if K > 1 else None
    entry_ok = (int(entry) >> 30) & 1
    oks = _stale_ok_at_cuts(engine.encoder, text, cuts, entry_ok)
    lane_entry = [
        int(entry) if j == 0 else (1 | (oks[j] << 30)) for j in range(K)
    ]

    decoded: List = [None] * K
    bad = np.zeros(K, dtype=bool)
    state = np.zeros((K, 6), dtype=np.int64)
    for gi in range(0, K, max_lanes):
        sl = slice(gi, min(gi + max_lanes, K))
        seg_texts = [text[c : c + seg_len] for c in cuts[sl]]
        meta, lengths, _ = engine.encoder.encode_batch(seg_texts)
        ys, bad_g, n_steps, state_g = engine.run_raw(
            meta,
            lengths,
            entries=np.asarray(lane_entry[sl], dtype=np.int32),
            stops=np.ones(len(seg_texts), dtype=bool),
        )
        decoded[sl] = decode_events_batch_from(ys, n_steps)
        bad[sl] = np.asarray(bad_g, dtype=bool)
        state[sl] = np.asarray(state_g)[:, : state.shape[1]]

    if bad.any():
        return host_tail()

    evs: List = []
    x_ctx, x_pos = int(entry), 0
    progressed = False
    for j in range(K):
        cut = cuts[j]
        seg_end = cuts[j + 1] if j + 1 < K else len(text)
        dec_abs = [(kd, s + cut, e + cut) for kd, s, e in decoded[j]]
        drop = 0
        if j > 0:
            r = _verify_cut(
                tok, text, x_ctx, x_pos, cut, lane_entry[j], seg_end,
                metas=metas,
            )
            if r is None:
                return host_tail()
            true_evs, drop, spec_prefix = r
            if drop > len(dec_abs) or dec_abs[:drop] != spec_prefix:
                return host_tail()  # device↔oracle divergence — be exact
            evs.extend(true_evs)
        body = dec_abs[drop:]
        b_exit = int(state[j, 2])
        if b_exit <= 0:
            # no rewind inside this segment (pending token spans it):
            # chained verification across a segment-sized token is not
            # covered by the verify windows — take the exact host path
            return host_tail() if j > 0 else ([], 0, int(entry))
        while body and body[-1][0] == EV_SENT:
            body.pop()
        evs.extend(body)
        x_ctx = int(state[j, 1])
        x_pos = cut + b_exit
        progressed = True
    if not progressed:
        return [], 0, int(entry)
    return evs, x_pos, x_ctx


def _run_docs(
    tok,
    engine: BatchEngine,
    docs: Sequence[str],
    *,
    entry: int = 1,
    max_lanes: int = 4096,
    long_strategy: str = "auto",
    as_arrays: bool = False,
):
    """Transduce EOT-split documents as parallel lanes, exactly.

    ``entry`` is the packed machine context the FIRST document starts
    in (1 = fresh root; a checkpoint ctx when resuming a stream).
    Returns ``(events_per_doc, exit_ctx_of_last_doc)``.  Speculation +
    chain repair as described in :func:`tokenize_stream`.
    """
    n = len(docs)
    verified_safe = eot_split_safe(tok) and entry == 1

    # stream-exact cut dispatch: chunks ending in EOT stop at their end
    # (no EOF epilogue — the stream continues there); the epilogue runs
    # in the stream-final chunk (split_documents' sentinel).  Gated on
    # eot_in_sigma, which proves such cuts are clean (rewound).
    can_cut = eot_in_sigma(engine.tok)
    cuts = np.array(
        [can_cut and d.endswith("\x04") for d in docs], dtype=bool
    )

    # speculative entries: predicted post-EOT contexts (root + end
    # flags + chained stale-ok) — these verify on the first round for
    # ordinary corpora; bare-root speculation re-ran every document
    entries, _ = predict_entries(engine.encoder, docs, entry=entry)
    events: List = [None] * n
    exits = np.ones(n, dtype=np.int32)
    have = [False] * n
    rounds = 0

    while not all(have):
        rounds += 1
        if rounds > n + 2:  # defensive: should converge in <= n rounds
            for k in range(n):
                if not have[k]:
                    # entries[] hold state ids in the *engine's*
                    # representation (BatchEngine may convert DATOK →
                    # MATOK, whose dense ids differ from DA slot ids
                    # beyond the root) — walk engine.tok, not tok
                    events[k], exits[k] = transduce_doc_exact(
                        engine.tok, docs[k], int(entries[k]),
                        bool(cuts[k]), encoder=engine.encoder,
                    )
                    have[k] = True
            break
        todo = [k for k in range(n) if not have[k]]
        # length-bucketed waves: each wave pads to its own max, so
        # grouping similar lengths avoids padding 10-char documents to
        # an 8 KB wave max (events are reassembled by index, so device
        # order is free)
        todo.sort(key=lambda k: len(docs[k]))
        for gi in range(0, len(todo), max_lanes):
            group = todo[gi : gi + max_lanes]
            small = [k for k in group if len(docs[k]) <= MAX_SEGMENT]
            large = [k for k in group if len(docs[k]) > MAX_SEGMENT]
            if small:
                evs, exs = engine.events_batch(
                    [docs[k] for k in small],
                    entries=entries[small],
                    return_exits=True,
                    as_arrays=as_arrays,
                    stops=cuts[small],
                )
                for k, ev, ex in zip(small, evs, exs):
                    events[k] = ev
                    exits[k] = ex
                    have[k] = True
            if large:
                # Long documents: chained segmentation parallelizes
                # *across* documents only, so with few giant documents
                # the device lanes sit idle — speculate across each
                # document's own segments instead (one wave of all
                # segments + host cut verification).  With many long
                # documents, chaining already saturates the lanes and
                # costs no host walks.
                spec = long_strategy == "speculative" or (
                    long_strategy == "auto" and len(large) < 64
                )
                run_long = (
                    events_speculative_batch if spec else events_long_batch
                )
                evs_l, exits_l = run_long(
                    engine, [docs[k] for k in large],
                    entries=entries[large], stops=cuts[large],
                )
                for k, ev, ex in zip(large, evs_l, exits_l):
                    events[k] = ev
                    exits[k] = ex
                    have[k] = True
        if verified_safe:
            break  # exits provably return to root; no chaining needed
        # verify the chain: a mismatched entry invalidates the successor
        for k in range(n - 1):
            if have[k] and exits[k] != entries[k + 1]:
                entries[k + 1] = exits[k]
                have[k + 1] = False
    return events, int(exits[-1]) if n else entry


def _replay_docs(docs, events, w) -> None:
    """Feed per-document event streams through the writer."""
    feed = getattr(w, "feed", None)
    if feed is not None:
        # batch event feed (NativeWriter): one C call per document
        # instead of three Python callbacks per token
        from .encode import text_to_codepoints

        for doc, evs in zip(docs, events):
            feed(evs, text_to_codepoints(doc))
    else:
        for doc, evs in zip(docs, events):
            replay_events(evs, doc, w)


def tokenize_stream(
    tok,
    text: str,
    writer: Optional[TokenWriter] = None,
    *,
    engine: Optional[BatchEngine] = None,
    accelerated: bool = True,
    max_lanes: int = 4096,
    long_strategy: str = "auto",
) -> TokenWriter:
    """Tokenize one stream through the batched device engine.

    The stream is split at EOT boundaries and transduced as parallel
    lanes *speculatively* (each chunk assumes root entry).  Exit states
    are verified against the next chunk's assumed entry: if a model
    ever leaves a non-root state after an EOT (possible — e.g. EOT can
    be consumed as an ignorable character), the affected chunks are
    re-run with the exact chained entry state until the chain is
    consistent.  This makes splitting exact for *any* model, with the
    statically-verified root-return property (``eot_split_safe``) as
    the fast path that skips verification entirely.

    Returns the writer (creating a ``SIMPLE`` one if none given).
    """
    w = writer if writer is not None else TokenWriter(SIMPLE)

    if engine is None:
        engine = BatchEngine(tok, accelerated=accelerated)

    docs = split_stream(engine.tok, text)
    events, _exit = _run_docs(
        tok,
        engine,
        docs,
        max_lanes=max_lanes,
        long_strategy=long_strategy,
        as_arrays=getattr(w, "feed", None) is not None,
    )
    _replay_docs(docs, events, w)
    return w


def tokenize_reader(
    tok,
    reader,
    writer: Optional[TokenWriter] = None,
    *,
    engine: Optional[BatchEngine] = None,
    chunk_bytes: int = 4 << 20,
    seg_len: int = 8192,
    max_lanes: int = 4096,
) -> TokenWriter:
    """Stream-tokenize a file-like object through the device engine
    with **bounded memory** — the device-batch analog of the reference's
    ``Transduce(io.Reader, io.Writer)`` (matrix.go:348-371): input
    flows in ``chunk_bytes`` chunks, each chunk's complete documents
    run as parallel device lanes, the trailing unterminated document is
    advanced to its last rewind checkpoint on device
    (:func:`events_until_checkpoint`), and only the un-checkpointed
    tail (≤ one pending token + trailing sentence context, bounded by
    one chunk) is carried forward.  Peak memory is O(chunk), never
    O(stream).

    ``reader`` may be binary (incremental UTF-8 decode, split
    multi-byte sequences safe) or text mode.  Output is byte-identical
    to :func:`tokenize_stream` on the concatenated stream (parity
    pinned by tests at many chunk sizes).
    """
    import codecs

    w = writer if writer is not None else TokenWriter(SIMPLE)
    if engine is None:
        engine = BatchEngine(tok)

    dec = codecs.getincrementaldecoder("utf-8")(errors="replace")
    ctx = 1  # packed machine context carried across chunk boundaries
    tail = ""
    can_cut = eot_in_sigma(engine.tok)
    while True:
        data = reader.read(chunk_bytes)
        at_eof = not data
        new = (
            dec.decode(data, final=at_eof)
            if isinstance(data, bytes)
            else (data or "")
        )
        if at_eof:
            tail += new
            break
        if not new:  # pure UTF-8 continuation bytes
            continue
        text = tail + new
        if can_cut:
            docs = split_documents(text, epilogue_sentinel=False)
            # trailing doc is unterminated unless the chunk ended in EOT
            partial = "" if docs[-1].endswith("\x04") else docs[-1]
            complete = docs[:-1] if partial or not docs[-1] else docs
        else:
            # EOT cuts not provably clean for this model: no document
            # splitting; the checkpoint machinery below is exact
            partial, complete = text, []
        if complete and any(complete):
            # mid-stream chunks all end in EOT and run as CUTS — the
            # stream-final epilogue runs after the read loop
            events, ctx = _run_docs(
                tok, engine, complete, entry=ctx, max_lanes=max_lanes,
                as_arrays=getattr(w, "feed", None) is not None,
            )
            _replay_docs(complete, events, w)
        if len(partial) >= 2 * seg_len:
            evs, ck_pos, ck_ctx = events_until_checkpoint(
                engine, partial, entry=ctx, seg_len=seg_len,
                max_lanes=max_lanes,
            )
            if evs:
                _replay_docs([partial[:ck_pos]], [evs], w)
            tail = partial[ck_pos:]
            ctx = ck_ctx
        else:
            tail = partial
    # EOF: the remaining tail (possibly empty) runs to completion from
    # the carried context — including the stream-final epilogue when
    # the stream ended exactly at an EOT (split_stream's sentinel;
    # matrix.go:637-697) and the reference's "\n\n" for empty streams.
    docs = split_stream(engine.tok, tail)
    events, ctx = _run_docs(
        tok, engine, docs, entry=ctx, max_lanes=max_lanes,
        as_arrays=getattr(w, "feed", None) is not None,
    )
    _replay_docs(docs, events, w)
    w.flush()
    return w
