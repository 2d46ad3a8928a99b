#!/usr/bin/env python
"""Smoke test of the corpus path on a GPU, through the normal entry points.

    python chip_smoke.py               # one card, phases 1-5
    python chip_smoke.py --devices 4   # four cards: the sharded corpus run only

Phases (any failure exits non-zero):

1. devices and ``nvidia-smi`` name/power limit; the default backend must
   be ``gpu`` and the native host library (the exact comparison path)
   must build;
2. build the DE-size generated grammar (``synth_de18k``, 18.6K states ×
   171 symbols) and its ``.datok``;
3. ``BatchEngine`` (``auto`` and each XLA machine by name) on one
   bench-shape wave (32,768 lanes × 1,024 chars of generated DE text),
   checked against the native scalar transduce on every lane and the
   Python oracle on ≥1 MB; lanes redone on the host are counted;
4. ``cli corpus`` in-process over ≥64 MB of generated files with
   heavy-tailed document lengths (one document past ``MAX_SEGMENT``),
   every output file compared byte for byte with the native transduce;
5. the ``.datok`` model through ``BatchEngine``, checked the same way;
6. (``--devices N`` only) ``ShardedEngine`` over N cards on the phase-4
   corpus, checked against the native transduce.

The last line of standard output is one JSON object
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

WAVE_B, WAVE_L = 32768, 1024
CORPUS_MB = 64
ORACLE_SAMPLE_CHARS = 1 << 20
MAX_BAD_SHARE = 0.001
DA_BUILD_LIMIT_S = 120.0


class SmokeError(RuntimeError):
    pass


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


# ---------------------------------------------------------------------------
# exact references
# ---------------------------------------------------------------------------


def native_events(tok, text, encoder):
    """(N, 3) events of the native scalar transduce over ``text``."""
    from datok.utils.native import native_encode, native_transduce_events

    _cps, metas = native_encode(encoder, text.encode("utf-8", "surrogatepass"))
    ev = native_transduce_events(tok, metas, as_array=True)
    check(ev is not None, "native transduce unavailable")
    return ev


def native_output(tok, text, flags, encoder):
    """Formatted output of the native transduce + native writer."""
    from datok.runtime.encode import text_to_codepoints
    from datok.utils.native import NativeWriter

    w = NativeWriter(flags)
    w.feed(native_events(tok, text, encoder), text_to_codepoints(text))
    return w.getvalue().encode("utf-8")


def references(texts, ref_tok, ref_encoder, oracle_tok):
    """Native events of every lane, and Python-oracle events of a lane
    sample of at least ORACLE_SAMPLE_CHARS characters."""
    from datok.runtime.oracle import transduce_events

    native = [native_events(ref_tok, t, ref_encoder) for t in texts]
    sample, chars = {}, 0
    step = max(1, len(texts) // 4096)
    for i in range(0, len(texts), step):
        if chars >= ORACLE_SAMPLE_CHARS:
            break
        sample[i] = transduce_events(oracle_tok, texts[i])
        chars += len(texts[i])
    check(chars >= ORACLE_SAMPLE_CHARS or step == 1,
          f"oracle sample too small ({chars} chars)")
    return native, sample, chars


def compare_wave(eng, texts, refs, label):
    """Run ``texts`` as one wave (twice: compile, then warm) and compare
    every lane with the native transduce and the sampled lanes with the
    Python oracle.  Returns (warm seconds, bad lanes)."""
    import numpy as np

    from datok.runtime.jax_engine import decode_events_flat

    native, sample, chars = refs
    meta, lengths, _ = eng.encoder.encode_batch(texts)
    t0 = time.perf_counter()
    eng.run_events_compact(meta, lengths)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    ev, counts, bad, _state = eng.run_events_compact(meta, lengths)
    warm = time.perf_counter() - t0
    tri, counts = decode_events_flat(ev, counts)
    offs = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=offs[1:])
    n_bad = int(np.asarray(bad).sum())
    mism = [i for i in range(len(texts)) if not bad[i]
            and not np.array_equal(tri[offs[i]:offs[i + 1]], native[i])]
    check(not mism, f"{label}: {len(mism)} lanes differ from the native "
                    f"transduce (first: {mism[:5]})")
    for i, want in sample.items():
        if not bad[i]:
            got = [tuple(r) for r in tri[offs[i]:offs[i + 1]].tolist()]
            check(got == want, f"{label}: lane {i} differs from the oracle")
    share = n_bad / len(texts)
    log(f"  {label}: engine={eng.engine} first run {first:.2f}s "
        f"(compile included), warm run {warm:.4f}s "
        f"({sum(len(t.encode()) for t in texts) / warm / 1e6:.1f} MB/s incl. "
        f"transfers); {len(texts)} lanes identical to the native transduce, "
        f"{len(sample)} lanes / {chars} chars identical to the Python "
        f"oracle; lanes redone on the host (bad): {n_bad}")
    check(share <= MAX_BAD_SHARE,
          f"{label}: {n_bad} bad lanes ({share:.2%}) above {MAX_BAD_SHARE:.1%}")
    return warm, n_bad


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_devices():
    import jax

    from datok.utils.native import get_lib

    devs = jax.devices()
    log(f"phase 1: jax {jax.__version__}, backend {jax.default_backend()}, "
        f"devices {[str(d) for d in devs]}")
    check(jax.default_backend() == "gpu",
          f"default backend is {jax.default_backend()!r}, not 'gpu'")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(f"nvidia-smi: {smi}")
    check(get_lib() is not None, "native host library did not build")
    return devs


def phase_grammar():
    from datok.fsa import synth

    if not synth.is_current("synth_de18k"):
        info = synth.build_models("synth_de18k", verbose=False)
        log(f"phase 2: built synth_de18k: {info}")
        da_s = info["datok_s"]
    else:
        log("phase 2: synth_de18k already built in "
            f"{synth.BUILD_DIR}")
        da_s = 0.0
    da_profile = "synth_de18k"
    if da_s > DA_BUILD_LIMIT_S:
        da_profile = "synth_small"
        synth.model_path(da_profile)
        log(f"  double-array build took {da_s:.1f}s > {DA_BUILD_LIMIT_S}s: "
            "phase 5 uses the small profile")
    return da_profile


def phase_wave(tok):
    from datok.fsa import synth
    from datok.runtime.encode import SymbolEncoder
    from datok.runtime.jax_engine import BatchEngine

    t0 = time.perf_counter()
    texts = synth.lane_texts("synth_de18k", WAVE_B, WAVE_L, seed=1)
    log(f"phase 3: one wave {WAVE_B} × {WAVE_L} chars "
        f"({sum(len(t.encode()) for t in texts) / 1e6:.1f} MB, generated "
        f"in {time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    refs = references(texts, tok, SymbolEncoder(tok), tok)
    log(f"  references computed in {time.perf_counter() - t0:.1f}s")
    for engine in ("auto", "general", "hot"):
        eng = BatchEngine(tok, engine=engine)
        compare_wave(eng, texts, refs, f"wave/{engine}")
        del eng


def make_corpus(root, total_bytes, seed=7):
    """Files of generated DE documents with heavy-tailed lengths; the
    first document is longer than MAX_SEGMENT."""
    import numpy as np

    from datok.fsa import synth
    from datok.runtime.jax_engine import MAX_SEGMENT

    pool = synth.sentence_pool("synth_de18k", n=8192, seed=seed)
    # log-normal lengths below MAX_SEGMENT (a document is whole
    # sentences, so it ends up to a sentence past its target), plus two
    # documents past it that take the segmentation path (each runs as
    # its own device waves today, so their number sets this phase's time)
    lens = synth.heavy_tail_lengths(
        int(total_bytes / 2500) + 64, seed=seed, median=1500, sigma=1.3,
        hi=MAX_SEGMENT - 1024,
    )
    lens[0] = 2 * MAX_SEGMENT + 1234
    lens[len(lens) // 2] = 3 * MAX_SEGMENT
    docs = synth.documents("synth_de18k", lens, seed=seed, pool=pool)
    os.makedirs(root, exist_ok=True)
    files, size, k = [], 0, 0
    n_files = 64
    per = max(1, len(docs) // n_files)
    while k < len(docs) and size < total_bytes:
        chunk = "".join(docs[k:k + per])
        k += per
        path = os.path.join(root, f"doc{len(files):03d}.txt")
        data = chunk.encode("utf-8")
        with open(path, "wb") as f:
            f.write(data)
        files.append(path)
        size += len(data)
    check(size >= total_bytes, f"corpus only {size} bytes")
    check(max(lens) > MAX_SEGMENT, "no document past MAX_SEGMENT")
    return files, size


def check_outputs(tok, files, out_dir, flags):
    from datok.runtime.encode import SymbolEncoder

    enc = SymbolEncoder(tok)
    for path in files:
        with open(path, "rb") as f:
            text = f.read().decode("utf-8", errors="replace")
        with open(os.path.join(out_dir, os.path.basename(path) + ".tok"),
                  "rb") as f:
            got = f.read()
        check(got == native_output(tok, text, flags, enc),
              f"corpus output of {path} differs from the native transduce")


def phase_corpus(tok, model, work, mb):
    import datok as dt
    from datok.cli import main as cli_main

    t0 = time.perf_counter()
    files, size = make_corpus(os.path.join(work, "corpus"), mb << 20)
    log(f"phase 4: {len(files)} files, {size} bytes generated in "
        f"{time.perf_counter() - t0:.1f}s")
    out_dir = os.path.join(work, "out")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["corpus", "-t", model, "-o", out_dir] + files)
    wall = time.perf_counter() - t0
    check(rc == 0, f"cli corpus exited {rc}")
    stats = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(stats["done"] == len(files), f"cli corpus stats: {stats}")
    log(f"  cli corpus: {size / wall / 1e6:.1f} MB/s end to end "
        f"({size} bytes in {wall:.2f}s, compiles included; lengths "
        f"clipped below MAX_SEGMENT plus 2 long documents); stages "
        f"{json.dumps(stats['pipeline'])}")
    t0 = time.perf_counter()
    check_outputs(tok, files, out_dir, dt.SIMPLE)
    log(f"  all {len(files)} output files byte-identical to the native "
        f"transduce (checked in {time.perf_counter() - t0:.1f}s)")
    return files, size


def phase_datok(da_profile, mat_tok):
    import datok as dt
    from datok.fsa import synth
    from datok.runtime.encode import SymbolEncoder
    from datok.runtime.jax_engine import BatchEngine

    dat = dt.load_datok_file(synth.model_path(da_profile, "datok"))
    ref = mat_tok if da_profile == "synth_de18k" else dt.load_matrix_file(
        synth.model_path(da_profile))
    texts = synth.lane_texts("synth_de18k", 8192, WAVE_L, seed=2)
    log(f"phase 5: {da_profile}.datok ({len(dat.base)} cells), "
        f"{len(texts)} lanes × {WAVE_L}")
    # native transduce on the matrix of the same automaton; the Python
    # oracle runs on the double array itself
    refs = references(texts, ref, SymbolEncoder(ref), dat)
    for engine in ("auto", "general"):
        eng = BatchEngine(dat, engine=engine)
        compare_wave(eng, texts, refs, f"datok/{engine}")
        del eng


def phase_sharded(tok, n, work, mb):
    import datok as dt
    import jax
    from jax.sharding import Mesh
    import numpy as np

    from datok.parallel.mesh import ShardedEngine
    from datok.runtime.corpus import CorpusRunner

    devs = jax.devices()
    check(len(devs) >= n, f"{n} devices requested, {len(devs)} present")
    files, size = make_corpus(os.path.join(work, "corpus"), mb << 20)
    log(f"phase 6: ShardedEngine over {n} devices, {len(files)} files, "
        f"{size} bytes")
    eng = ShardedEngine(tok, mesh=Mesh(np.array(devs[:n]), ("data",)))
    out_dir = os.path.join(work, "out_sharded")
    for attempt in ("cold", "warm"):
        shutil.rmtree(out_dir, ignore_errors=True)
        stats = {}
        t0 = time.perf_counter()
        CorpusRunner(tok, out_dir, engine=eng).run(files, stats=stats)
        wall = time.perf_counter() - t0
        log(f"  {attempt}: {size / wall / 1e6:.1f} MB/s end to end "
            f"({wall:.2f}s); repairs {stats.get('repairs')}")
    check_outputs(tok, files, out_dir, dt.SIMPLE)
    log(f"  all {len(files)} output files byte-identical to the native "
        "transduce")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--devices", type=int, default=1,
                   help="run only the sharded corpus phase over N devices")
    args = p.parse_args(argv)

    try:
        import datok as dt
        from datok.fsa import synth
        from datok.utils.compile_cache import enable_compile_cache
    except ImportError as e:
        print(f"chip_smoke: the datok package is not beside this "
              f"script: {e}", file=sys.stderr)
        return 2

    t_all = time.perf_counter()
    work = os.path.join(HERE, "build", "smoke")
    shutil.rmtree(work, ignore_errors=True)
    try:
        cache = enable_compile_cache()
        devs = phase_devices()
        log(f"compile cache: {cache}")
        da_profile = phase_grammar()
        model = synth.model_path("synth_de18k")
        tok = dt.load_matrix_file(model)
        if args.devices > 1:
            phase_sharded(tok, args.devices, work, CORPUS_MB)
        else:
            phase_wave(tok)
            phase_corpus(tok, model, work, CORPUS_MB)
            phase_datok(da_profile, tok)
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"all phases passed in {time.perf_counter() - t_all:.1f}s")
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
