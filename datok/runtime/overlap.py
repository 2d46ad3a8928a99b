"""Overlapped end-to-end pipeline: encode ∥ device ∥ format.

The reference is a single synchronous loop (matrix.go:348-698); the
repo's wave pipeline (pipeline.py) was synchronous too — encode →
device → decode → format, stage by stage, so end-to-end throughput was
the *sum* of the stage times.  This module overlaps them:

* a **prep thread** assembles waves of documents, encodes them with
  the internally-threaded native encoder (GIL released), stages the
  wave on device and *dispatches* the machine + event compaction —
  JAX dispatch is asynchronous, so the device crunches wave N while
  the host encodes wave N+1;
* a **fetch thread** moves wave N−1's compacted events to the host
  (the only device→host traffic) so the transfer overlaps the
  consumer's work instead of serializing with it;
* the **consumer** (the generator's caller) decodes wave N−2's
  events, verifies the entry-state chain, and formats — concurrently
  with all of the above.

Steady-state end-to-end throughput is max(stage), not sum(stages).
Backpressure and buffer reuse come from a fixed ring of scratch
slots: a wave's encode buffers are reused only after its results are
consumed, so the 100+ MB meta arrays are page-faulted once per run,
not once per wave.

The core generator is **wave-level** (:func:`waves_pipelined`): one
flat event array + per-doc counts + the flat codepoint layout per
wave, so the native writer can replay a whole wave in ONE C call
(``dt_writer_feed_wave``) instead of one per document.
:func:`events_pipelined` is the per-document convenience wrapper.

Exactness: every document is dispatched speculatively from the root
context (the reference semantics after an EOT, matrix.go:593-605).
For models where EOT provably returns to the root
(``eot_split_safe``) no verification is needed; otherwise the
consumer replays the chain — any document whose true entry context
(the previous document's exit) differs from the dispatched root is
re-transduced exactly on the host (native scalar loop), and the chain
continues from its corrected exit.  Device-reported fallback lanes
(``bad``) take the same host path.  This mirrors the speculation +
repair design of ``pipeline._run_docs`` with the verification moved
off the dispatch path.
"""

from __future__ import annotations

import queue
import threading
import time as _time
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np

from .jax_engine import (
    MAX_SEGMENT,
    BatchEngine,
    decode_events_flat,
)
from .writer import SIMPLE, TokenWriter


class _Wave:
    __slots__ = ("tags", "docs", "handles", "slot", "events",
                 "exits", "entries", "breaks", "inv", "cuts", "n_enc")

    def __init__(self, tags, docs, handles, slot, entries, breaks,
                 events=None, exits=None, inv=None, cuts=None,
                 n_enc=0):
        self.tags = tags
        self.docs = docs
        self.handles = handles  # (ev_T, counts, bad, state) device arrays
        self.slot = slot
        self.entries = entries  # dispatched (predicted) entry contexts
        self.breaks = breaks  # per-doc stream-start markers
        self.events = events  # precomputed (long-doc path)
        self.exits = exits  # precomputed exit contexts (long-doc path)
        self.inv = inv  # doc→lane map when shard-balanced (else None)
        self.cuts = cuts  # per-doc: dispatched as interior-EOT cut
        self.n_enc = n_enc  # encoded lane count (docs + shape pads)


class WaveResult:
    """One consumed wave: flat events + flat codepoints, repair-exact.

    ``tri``: (N, 3) int32 — the concatenation of every document's
    event triples (kind, pos_a, pos_b), document-relative positions;
    document k owns ``counts[k]`` consecutive rows.  ``cps_flat`` /
    ``cps_offs`` / ``cps_lens`` give document k's codepoints at
    ``cps_flat[cps_offs[k] : cps_offs[k] + cps_lens[k]]``.

    ``cps_flat`` may be a view of a reused encode scratch buffer: it
    is valid only until the generator is advanced again (the slot
    returns to the ring when the consumer resumes it).  Format first,
    then ``next()``.
    """

    __slots__ = ("tags", "docs", "tri", "counts",
                 "cps_flat", "cps_offs", "cps_lens")

    def __init__(self, tags, docs, tri, counts, cps_flat, cps_offs,
                 cps_lens):
        self.tags = tags
        self.docs = docs
        self.tri = tri
        self.counts = counts
        self.cps_flat = cps_flat
        self.cps_offs = cps_offs
        self.cps_lens = cps_lens


def _pack_items(items, pack_len):
    """Merge consecutive compatible items into ≤``pack_len``-char
    "superdocs" — the lane-packing pass.

    The device engine processes one document per lane; short documents
    leave lanes idle once they finish while long ones straggle, and a
    mixed-length corpus runs far below uniform-batch throughput
    (measured: 150 vs 330+ MB/s/chip).  Packing consecutive documents
    of the SAME stream (equal tag, no stream break) into one lane
    restores near-uniform lane lengths at zero exactness cost: the
    machine crosses the in-lane EOT boundaries natively, which IS the
    reference's single-stream semantics (matrix.go:593-605) — no
    speculation or verification is needed *within* a lane, only at
    lane boundaries, exactly as before.  Only a document ending in
    EOT can be followed within a superdoc (the machine must see the
    terminator to reset); order is preserved, so output equals the
    per-document replay concatenated.
    """
    cur = None
    for it in items:
        tag, doc = it[0], it[1]
        brk = bool(it[2]) if len(it) > 2 else False
        if cur is not None:
            ctag, cdoc, cbrk = cur
            if (
                not brk
                and tag == ctag
                and doc != ""  # the epilogue sentinel stays its own item
                and cdoc.endswith("\x04")
                and len(cdoc) + len(doc) <= pack_len
                # stop growing once half full: longer lanes amplify
                # the kernel's cold-stall idling (measured: packing a
                # mixed corpus to 2048-char lanes ran 4.0 steps/char
                # vs 1.75 unpacked), so packing pays only for SMALL
                # documents, where unpacked lanes would waste the
                # per-wave fixed cost on a few bytes each
                and len(cdoc) < pack_len // 2
            ):
                cur = (ctag, cdoc + doc, cbrk)
                continue
            yield cur
        cur = (tag, doc, brk)
    if cur is not None:
        yield cur


def _assemble(items, lanes, max_wave_chars):
    """Group items into waves; oversize docs go alone.

    Items are ``(tag, doc)`` pairs or ``(tag, doc, stream_start)``
    triples — a true third element marks the document as the first of
    a NEW stream (fresh root entry, e.g. a new corpus file) instead of
    chaining from its predecessor."""
    batch: List = []
    chars = 0
    for it in items:
        tag, doc = it[0], it[1]
        brk = bool(it[2]) if len(it) > 2 else False
        if len(doc) > MAX_SEGMENT:
            if batch:
                yield ("wave", batch)
                batch, chars = [], 0
            yield ("long", [(tag, doc, brk)])
            continue
        batch.append((tag, doc, brk))
        chars += max(len(doc), 1)
        if len(batch) >= lanes or chars >= max_wave_chars:
            yield ("wave", batch)
            batch, chars = [], 0
    if batch:
        yield ("wave", batch)


def _bucket(n: int, lo: int) -> int:
    """Smallest power-of-two ≥ ``n`` that is ≥ ``lo``."""
    b = lo
    while b < n:
        b *= 2
    return b


def _splice(tri, counts, repl):
    """Replace document k's event rows with ``repl[k]`` (host repairs)."""
    offs = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=offs[1:])
    parts = []
    new_counts = np.asarray(counts, dtype=np.int32).copy()
    for k in range(len(counts)):
        if k in repl:
            parts.append(repl[k])
            new_counts[k] = len(repl[k])
        else:
            parts.append(tri[offs[k] : offs[k + 1]])
    tri2 = np.concatenate(parts) if parts else tri[:0]
    return np.ascontiguousarray(tri2), new_counts


def waves_pipelined(
    engine: BatchEngine,
    items: Iterable[Tuple[object, str]],
    *,
    lanes: int = 8192,
    slots: int = 3,
    max_wave_chars: int = 32 << 20,
    long_seg_len: int = 8192,
    pack_len: int = 0,
    stats: Optional[dict] = None,
    copy_cps: bool = False,
) -> Iterator[WaveResult]:
    """Yield :class:`WaveResult` per wave, in input order.

    ``copy_cps=True`` copies each wave's ``cps_flat`` out of the reused
    encode scratch slot, so the :class:`WaveResult` stays valid after
    the generator is advanced.  The default (zero-copy) alias is the
    fast path for consumers that format before calling ``next()`` —
    the contract in :class:`WaveResult`'s docstring.

    ``pack_len`` > 0 merges consecutive same-tag documents into
    ≤pack_len-char lanes (see :func:`_pack_items`) — large throughput
    win on mixed-length corpora, exact by stream semantics.  Callers
    that need per-ITEM event granularity must leave it 0.

    ``items`` yields ``(tag, doc)`` pairs (the tag is passed through —
    callers use it to route output, e.g. a corpus file index).  Event
    positions are document-relative.  The generator owns a prep
    thread; closing it (``.close()``) or exhausting it joins the
    thread.

    ``stats``: optional dict, filled with cumulative per-stage wall
    seconds (``encode``, ``dispatch``, ``fetch``, ``decode``), wave
    and document counts, and ``repairs`` (host chain-repair count) —
    the observability the stage-overlap design needs (a stage whose
    time approaches total wall is the new bottleneck).
    """
    import jax  # noqa: F401  (device backend init)
    import jax.numpy as jnp

    from .encode import text_to_codepoints
    from .jax_engine import _compact_ys
    from .pipeline import (eot_in_sigma, events_speculative_batch,
                           predict_entries, transduce_doc_exact)

    try:
        from ..utils.native import native_encode_wave
    except ImportError:
        native_encode_wave = None

    q: "queue.Queue" = queue.Queue()
    free = queue.Queue()
    for i in range(max(2, slots)):
        free.put({})  # scratch dict per slot
    stop = threading.Event()
    err: List[BaseException] = []
    if pack_len:
        items = _pack_items(items, pack_len)
    st = stats if stats is not None else {}
    for k in ("encode", "dispatch", "fetch", "decode"):
        st.setdefault(k, 0.0)
    for k in ("waves", "docs", "repairs", "long_docs"):
        st.setdefault(k, 0)

    can_cut = eot_in_sigma(engine.tok)

    def prep():
        pred = 1  # prep-side predicted entry chain (host, cheap)
        try:
            for kind, batch in _assemble(items, lanes, max_wave_chars):
                if stop.is_set():
                    return
                tags = [t for t, _, _ in batch]
                docs = [d for _, d, _ in batch]
                breaks = [b for _, _, b in batch]
                # interior-EOT chunks run as CUTS (no EOF epilogue) —
                # the stream-exact dispatch; the stream-final epilogue
                # arrives as split_documents' empty sentinel chunk
                cuts = [can_cut and d.endswith("\x04") for d in docs]
                entries, pred = predict_entries(
                    engine.encoder, docs, entry=pred, breaks=breaks
                )
                if kind == "long":
                    # giant document: exact speculative segmentation
                    # (its own device waves + host cut verification)
                    evs, exits = events_speculative_batch(
                        engine, docs, seg_len=long_seg_len,
                        entries=entries, stops=cuts,
                    )
                    evs = [
                        np.asarray(e, dtype=np.int32).reshape(-1, 3)
                        for e in evs
                    ]
                    st["long_docs"] += len(docs)
                    q.put(_Wave(tags, docs, None, None, entries,
                                breaks, events=evs, exits=exits,
                                cuts=cuts))
                    continue
                slot = free.get()  # backpressure: ring of reusable slots
                if stop.is_set():
                    return
                t0 = _time.time()
                # Compile-shape bucketing: encode every wave at a
                # power-of-two padded length and lane count so natural
                # mixed-length corpora reuse a handful of compiled
                # machine shapes instead of re-tracing the jitted
                # device machine (multi-second XLA compiles)
                # per distinct (L, B) pair.  Tail-lane pads are empty
                # docs: their lanes run the trivial epilogue and the
                # consumer drops their events.
                L_max = max((len(d) for d in docs), default=1)
                L_pad = min(_bucket(max(L_max, 1), 128), MAX_SEGMENT)
                B_real = len(docs)
                B_pad = _bucket(max(B_real, 1), 8)
                full_docs = list(docs) + [""] * (B_pad - B_real)
                full_entries = np.concatenate(
                    [
                        np.asarray(entries, dtype=np.int32),
                        np.ones(B_pad - B_real, dtype=np.int32),
                    ]
                )
                # Lane placement: on a mesh engine, shard-aware snake
                # balancing (lanes shard in contiguous blocks) so
                # every shard carries equal work; on one device, a
                # plain length sort (the hot machine's ring window
                # follows the slowest live lane, so similar lengths
                # keep the lanes' cursor spread small).  Results are
                # unpermuted at consume via inv[:B_real]; the entry
                # chain is order-independent of lane placement.
                inv = None
                n_sh = getattr(engine, "n_shards", 1)
                lens_full = [len(d) for d in full_docs]
                if n_sh > 1 and B_real > n_sh:
                    from ..parallel.mesh import balance_perm

                    perm = balance_perm(lens_full, n_sh)
                elif B_real > 64 and min(lens_full[:B_real]) != max(
                    lens_full[:B_real]
                ):
                    perm = np.argsort(
                        np.asarray(lens_full), kind="stable"
                    )
                else:
                    perm = None
                if perm is not None:
                    inv_full = np.empty_like(perm)
                    inv_full[perm] = np.arange(len(perm))
                    enc_docs = [full_docs[i] for i in perm]
                    enc_entries = full_entries[perm]
                    inv = inv_full[:B_real]
                else:
                    enc_docs = full_docs
                    enc_entries = full_entries
                r = (
                    native_encode_wave(
                        engine.encoder, enc_docs, pad_to=L_pad,
                        scratch=slot,
                    )
                    if native_encode_wave is not None
                    else None
                )
                if r is None:
                    slot.pop("cps_offs", None)  # not flat-laid-out
                    r = engine.encoder.encode_batch(
                        enc_docs, pad_to=L_pad
                    )
                meta, lengths, cps = r
                if "cps_offs" in slot:
                    cps_layout = (slot["cps"], slot["cps_offs"], lengths)
                else:
                    offs = np.zeros(len(cps), dtype=np.int64)
                    if len(cps) > 1:
                        np.cumsum(
                            [len(c) for c in cps[:-1]], out=offs[1:]
                        )
                    flat = (
                        np.concatenate(cps)
                        if cps
                        else np.zeros(0, dtype=np.int32)
                    )
                    cps_layout = (
                        flat, offs,
                        np.asarray([len(c) for c in cps],
                                   dtype=np.int32),
                    )
                st["encode"] += _time.time() - t0
                t0 = _time.time()
                stops_w = np.array(
                    [can_cut and d.endswith("\x04") for d in enc_docs],
                    dtype=bool,
                )
                meta_d = jnp.asarray(meta)
                ys, bad, steps, state = engine.run_raw_device(
                    meta_d, lengths, entries=enc_entries,
                    stops=stops_w if stops_w.any() else None,
                )
                # compact at the static step bound: reading the actual
                # step count here would SYNC the prep thread on the
                # device run and destroy the overlap
                ev_T, counts = _compact_ys(ys, ys.shape[0])
                st["dispatch"] += _time.time() - t0
                st["waves"] += 1
                q.put(
                    _Wave(tags, docs,
                          (ev_T, counts, bad, state, cps_layout),
                          slot, entries, breaks, inv=inv, cuts=cuts,
                          n_enc=len(enc_docs))
                )
        except BaseException as e:  # surfaced by the consumer
            err.append(e)
        finally:
            q.put(None)

    def _fetch_wave(wave: "_Wave") -> None:
        """Device→host fetch of one wave's results (in the fetch
        thread): the only d2h traffic of the pipeline.  Replaces the
        device handles with numpy arrays so the consumer's
        decode+format overlaps the NEXT wave's transfer."""
        ev_T, counts_d, bad_d, state_d, cps_layout = wave.handles
        B = len(wave.docs)
        Bf = wave.n_enc if wave.inv is not None else B
        t0 = _time.time()
        counts = np.asarray(counts_d[:Bf])
        cmax = int(counts.max()) if counts.size else 0
        E = 32
        while E < cmax:
            E *= 2
        E = min(E, ev_T.shape[1])
        # slice on device: padding lanes and empty columns never
        # cross the (bottleneck) device→host link
        ev = np.asarray(ev_T[:Bf, :E])
        bad = np.asarray(bad_d[:Bf])
        state = np.asarray(state_d[:Bf])
        st["fetch"] += _time.time() - t0
        wave.handles = ("np", ev, counts, bad, state, cps_layout)

    q2: "queue.Queue" = queue.Queue()

    def fetcher():
        try:
            while True:
                w = q.get()
                if w is None:
                    return
                if w.handles is not None and not stop.is_set():
                    _fetch_wave(w)
                q2.put(w)
        except BaseException as e:  # surfaced by the consumer
            err.append(e)
        finally:
            q2.put(None)

    t = threading.Thread(target=prep, name="datok-prep", daemon=True)
    t.start()
    tf = threading.Thread(target=fetcher, name="datok-fetch", daemon=True)
    tf.start()

    entry = 1  # TRUE packed entry context for the next document
    wave = None
    try:
        while True:
            wave = q2.get()
            if wave is None:
                if err:
                    raise err[0]
                break
            if wave.events is not None:  # precomputed long docs
                repl = {}
                for k, doc in enumerate(wave.docs):
                    if wave.breaks[k]:
                        entry = 1  # fresh stream: root by definition
                    if entry != int(wave.entries[k]):
                        st["repairs"] += 1
                        ev_l, entry = transduce_doc_exact(
                            engine.tok, doc, int(entry),
                            bool(wave.cuts[k]), encoder=engine.encoder,
                        )
                        repl[k] = np.asarray(
                            ev_l, dtype=np.int32
                        ).reshape(-1, 3)
                    else:
                        entry = int(wave.exits[k])
                evs = [repl.get(k, e) for k, e in enumerate(wave.events)]
                tri = (
                    np.concatenate(evs)
                    if evs
                    else np.zeros((0, 3), dtype=np.int32)
                )
                counts = np.asarray([len(e) for e in evs],
                                    dtype=np.int32)
                cps_l = [text_to_codepoints(d) for d in wave.docs]
                offs = np.zeros(len(cps_l), dtype=np.int64)
                if len(cps_l) > 1:
                    np.cumsum([len(c) for c in cps_l[:-1]], out=offs[1:])
                st["docs"] += len(wave.docs)
                yield WaveResult(
                    wave.tags, wave.docs, tri, counts,
                    np.concatenate(cps_l)
                    if cps_l else np.zeros(0, dtype=np.int32),
                    offs,
                    np.asarray([len(c) for c in cps_l], dtype=np.int32),
                )
                continue

            # the fetch thread already moved this wave's results to
            # host ("np" marker); shard-balanced waves scatter real
            # docs over all encoded lanes, so Bf covered them all
            _tag, ev, counts, bad, state, cps_layout = wave.handles
            B = len(wave.docs)
            t0 = _time.time()
            tri, counts = decode_events_flat(ev, counts)
            cps_flat, cps_offs, cps_lens = cps_layout
            if wave.inv is not None:
                # restore input order (see shard balancing in prep);
                # inv[:B] drops the shape-pad lanes
                inv = wave.inv
                offs_p = np.zeros(len(counts) + 1, dtype=np.int64)
                np.cumsum(counts, out=offs_p[1:])
                tri = (
                    np.concatenate(
                        [tri[offs_p[i] : offs_p[i + 1]] for i in inv]
                    )
                    if len(inv)
                    else tri[:0]
                )
                counts = counts[inv]
                bad = bad[inv]
                state = state[inv]
                cps_offs = np.asarray(cps_offs)[inv]
                cps_lens = np.asarray(cps_lens)[inv]
            st["decode"] += _time.time() - t0
            st["docs"] += B
            repl = {}
            for k, doc in enumerate(wave.docs):
                if wave.breaks[k]:
                    entry = 1  # fresh stream: root by definition
                # the prediction dispatched for this doc must equal the
                # TRUE entry (previous doc's actual exit); mismatches
                # (rare: models whose EOT arcs leave the root) replay
                # exactly on the host and realign the chain
                if bad[k] or entry != int(wave.entries[k]):
                    if bad[k]:
                        from .debug import (divergence_debug_enabled,
                                            dump_divergence)

                        if divergence_debug_enabled():
                            dump_divergence(engine, doc,
                                            entry=int(entry))
                    st["repairs"] += 1
                    ev_l, entry = transduce_doc_exact(
                        engine.tok, doc, int(entry),
                        bool(wave.cuts[k]), encoder=engine.encoder,
                    )
                    repl[k] = np.asarray(
                        ev_l, dtype=np.int32
                    ).reshape(-1, 3)
                else:
                    entry = int(state[k, 0])
            if repl:
                tri, counts = _splice(tri, counts, repl)
            if copy_cps:
                cps_flat = np.array(cps_flat, copy=True)
            yield WaveResult(
                wave.tags, wave.docs, tri, counts,
                cps_flat, cps_offs, cps_lens,
            )
            free.put(wave.slot)  # buffers reusable from here on
            wave = None
    finally:
        stop.set()
        # drain so the prep thread can't block on a full slot ring
        # (waves may sit in either queue or in the consumer's hand)
        if wave is not None and wave.slot is not None:
            free.put(wave.slot)
        for qq in (q, q2):
            try:
                while True:
                    w = qq.get_nowait()
                    if w is not None and w.slot is not None:
                        free.put(w.slot)
            except queue.Empty:
                pass
        # the drain may have stolen prep's final None from q; wake the
        # fetch thread unconditionally so it can exit
        q.put(None)
        # stop is set and the slot ring is drained, so the prep thread
        # exits after at most one in-flight wave (and the fetch thread
        # after the prep's final None); join without a practical
        # timeout, but surface a warning instead of silently leaving a
        # daemon thread issuing device work
        t.join(timeout=300)
        tf.join(timeout=60)
        if t.is_alive() or tf.is_alive():
            import warnings

            warnings.warn(
                "datok pipeline thread did not exit within its join "
                "timeout; it may still be issuing device work on this "
                "engine",
                RuntimeWarning,
                stacklevel=2,
            )


def events_pipelined(
    engine: BatchEngine,
    items: Iterable[Tuple[object, str]],
    *,
    lanes: int = 8192,
    slots: int = 3,
    max_wave_chars: int = 32 << 20,
    long_seg_len: int = 8192,
    stats: Optional[dict] = None,
) -> Iterator[Tuple[object, str, np.ndarray]]:
    """Yield ``(tag, doc, events[N,3] int32)`` in input order.

    Per-document wrapper over :func:`waves_pipelined` (same arguments;
    see there for semantics and the ``stats`` dict)."""
    for w in waves_pipelined(
        engine, items, lanes=lanes, slots=slots,
        max_wave_chars=max_wave_chars, long_seg_len=long_seg_len,
        stats=stats,
    ):
        offs = np.zeros(len(w.counts) + 1, dtype=np.int64)
        np.cumsum(w.counts, out=offs[1:])
        for k, (tag, doc) in enumerate(zip(w.tags, w.docs)):
            yield tag, doc, w.tri[offs[k] : offs[k + 1]]


def tokenize_stream_pipelined(
    tok,
    text: str,
    writer: Optional[TokenWriter] = None,
    *,
    engine: Optional[BatchEngine] = None,
    lanes: int = 8192,
    flags: Optional[int] = None,
    pack_len: int = 1024,
    stats: Optional[dict] = None,
) -> TokenWriter:
    """Overlapped-pipeline twin of :func:`pipeline.tokenize_stream`.

    Byte-identical output (parity pinned by tests); use for large
    streams where end-to-end wall clock matters.  When the writer is
    native (``NativeWriter``) the whole wave is formatted in one
    GIL-releasing C call.
    """
    from .events import replay_events
    from .pipeline import split_stream

    w = writer if writer is not None else TokenWriter(
        SIMPLE if flags is None else flags
    )
    if engine is None:
        engine = BatchEngine(tok)
    docs = split_stream(engine.tok, text)
    feed_wave = getattr(w, "feed_wave", None)
    feed = getattr(w, "feed", None)
    st = stats if stats is not None else {}
    st.setdefault("format", 0.0)
    for wave in waves_pipelined(
        engine, ((None, d) for d in docs), lanes=lanes, stats=st,
        pack_len=pack_len,
    ):
        t0 = _time.time()
        if feed_wave is not None:
            feed_wave(wave.tri, wave.counts, wave.cps_flat,
                      wave.cps_offs, wave.cps_lens)
        else:
            offs = np.zeros(len(wave.counts) + 1, dtype=np.int64)
            np.cumsum(wave.counts, out=offs[1:])
            for k, doc in enumerate(wave.docs):
                evs = wave.tri[offs[k] : offs[k + 1]]
                if feed is not None:
                    feed(
                        evs,
                        wave.cps_flat[
                            wave.cps_offs[k] :
                            wave.cps_offs[k] + wave.cps_lens[k]
                        ],
                    )
                else:
                    replay_events(
                        [tuple(r) for r in evs.tolist()], doc, w
                    )
        st["format"] += _time.time() - t0
    w.flush()
    return w
