#!/usr/bin/env python
"""Benchmark: tokenization throughput on generated DE-size text.

Prints ONE JSON line.  Every rate is MB/s of UTF-8 input; device rows
time one wave pre-staged on the device, synchronised by a host fetch of
a result scalar (the bad-lane count, which doubles as the exactness
guard).  Grammars and texts come from ``datok.fsa.synth``.

  device        platform, device kind and count as JAX reports them,
                plus nvidia-smi's name and power limit when present
  value         wave_mbps: one wave of BENCH_LANES × BENCH_LEN chars of
                generated DE text (every lane a different stream cut),
                the ``auto`` machine; conformance-guarded on every lane
  uniform_mbps  every lane the same generated document
  mixed_mbps    heavy-tailed lengths (L/16..L), length-sorted lanes
  en_mbps       the EN-size generated grammar, same shape as ``value``
  datok_mbps    the ``.datok`` model (``auto`` converts it to the matrix)
  mixed_pipeline  waves_pipelined over heavy-tailed documents: dispatch
                rate, waves, host repairs
  e2e_mbps      tokenize_stream_pipelined over BENCH_E2E_MB of generated
                documents with the native writer; e2e_stage_mbps gives
                each stage's standalone rate
  host_scaling  encode / decode / format rates at the thread counts
                this host has, [median, min, max] over BENCH_HOST_REPS

Flags:
  --profile     add a jax.profiler trace reduction of one wave
                (:func:`trace_summary`): device busy time, idle share,
                kernels and host copies per machine step, peak memory
  --machines    add the general-vs-hot A/B on the ``value`` wave: wall
                time, steps, ns per lane-step, compiled memory, HLO copies
                of the event buffer, and a trace reduction of each
  BENCH_FAST=1  ``value``, ``uniform`` and the flags only
  BENCH_TRACE_DIR  trace directory (default build/traces)
"""

import glob
import gzip
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# where --profile / --machines write their traces
TRACE_DIR = os.environ.get("BENCH_TRACE_DIR", os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "build", "traces"))


def _device_info():
    import jax

    d = jax.devices()[0]
    info = {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}
    try:
        info["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        info["nvidia_smi"] = None
    return info


def _stage(eng, texts):
    import jax
    import jax.numpy as jnp

    meta, lengths, _ = eng.encoder.encode_batch(texts)
    meta_d = jax.block_until_ready(jnp.asarray(meta))
    lengths_d = jax.block_until_ready(jnp.asarray(lengths))
    return meta_d, lengths_d, sum(len(t.encode()) for t in texts)


def _timed(eng, meta_d, lengths_d, reps):
    """Median wall seconds of ``reps`` warm runs (first run warms)."""
    times = []
    steps = 0
    for i in range(reps + 1):
        t0 = time.perf_counter()
        out = eng.run_raw_device(meta_d, lengths_d)
        nbad = int(np.asarray(out[1]).sum())  # host fetch = sync
        if i:
            times.append(time.perf_counter() - t0)
        steps = int(out[2])
        assert nbad == 0, "fallback lanes"
    return float(np.median(times)), steps


def _guard(eng, tok, texts, n=256):
    """Device events of the first ``n`` lanes == the oracle's."""
    from datok.runtime.oracle import transduce_events

    sub = texts[:n]
    evs = eng.events_batch(sub)
    for t, e in zip(sub, evs):
        assert e == transduce_events(tok, t), "device/oracle mismatch"


def _rate(eng, tok, texts, reps):
    _guard(eng, tok, texts)
    meta_d, lengths_d, nbytes = _stage(eng, texts)
    dt_s, steps = _timed(eng, meta_d, lengths_d, reps)
    return nbytes / dt_s / 1e6, steps, (meta_d, lengths_d, nbytes)


# ---------------------------------------------------------------------------
# trace reduction
# ---------------------------------------------------------------------------


def trace_summary(trace_dir, steps=None, lanes=None):
    """Reduce the newest perfetto trace under ``trace_dir`` to device
    metrics: busy time (union of device op intervals), idle share of
    the device span, op counts per machine step, the longest ops, and
    host↔device copies (XLA's while loop fetches its predicate to the
    host every iteration on this backend)."""
    paths = sorted(glob.glob(os.path.join(
        trace_dir, "**", "*perfetto_trace.json.gz"), recursive=True))
    if not paths:
        return {"error": f"no perfetto trace under {trace_dir}"}
    with gzip.open(paths[-1], "rt") as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    names = {e["pid"]: e.get("args", {}).get("name", "")
             for e in events
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    dev = {p for p, n in names.items() if "/device:" in n}
    ops = [e for e in events if e.get("ph") == "X" and e.get("pid") in dev
           and "dur" in e]
    if not ops:
        return {"error": "no device ops in trace",
                "processes": sorted(set(names.values()))}
    iv = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                for e in ops)
    busy, cur_s, cur_e = 0.0, iv[0][0], iv[0][1]
    for s, e in iv[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = iv[-1][1] - iv[0][0]
    by_name = {}
    for e in ops:
        k = e.get("name", "")
        c, t = by_name.get(k, (0, 0.0))
        by_name[k] = (c + 1, t + float(e["dur"]))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    memcpy = {k: v for k, v in by_name.items() if "emcpy" in k or "opy" in k}
    out = {
        "trace": os.path.relpath(paths[-1]),
        "device_processes": sorted(names[p] for p in dev),
        "device_span_ms": round(span / 1e3, 3),
        "device_busy_ms": round(busy / 1e3, 3),
        "device_idle_share": round(1.0 - busy / span, 4) if span else None,
        "device_ops": len(ops),
        "top_ops": [{"name": k[:80], "count": c, "total_ms": round(t / 1e3, 3),
                     "mean_us": round(t / c, 2)} for k, (c, t) in top],
        "copy_ops": {k[:80]: {"count": c, "total_ms": round(t / 1e3, 3)}
                     for k, (c, t) in memcpy.items()},
    }
    if steps:
        out["ops_per_step"] = round(len(ops) / steps, 2)
        out["span_us_per_step"] = round(span / steps, 3)
        out["busy_us_per_step"] = round(busy / steps, 3)
        if lanes:
            out["busy_ns_per_lane_step"] = round(
                busy * 1e3 / (steps * lanes), 4)
    return out


def _profile(eng, meta_d, lengths_d, steps, label):
    import jax

    d = os.path.join(TRACE_DIR, label)
    with jax.profiler.trace(d, create_perfetto_trace=True):
        out = eng.run_raw_device(meta_d, lengths_d)
        int(np.asarray(out[1]).sum())
    return trace_summary(d, steps=steps, lanes=meta_d.shape[0])


def _machine_ab(tok, texts, reps):
    """general vs hot on one wave: times, steps, compiled memory, HLO
    copies of the (max_steps, B) event buffer, trace reduction."""
    import jax
    import jax.numpy as jnp

    from datok.runtime import jax_engine as je

    out = {}
    for engine in ("general", "hot"):
        eng = je.BatchEngine(tok, engine=engine)
        meta_d, lengths_d, nbytes = _stage(eng, texts)
        B, L = meta_d.shape
        ms = eng.max_steps_for(L)
        entries = jnp.ones(B, jnp.int32)
        kw = dict(eps=eng.rep.eps, unknown=eng.rep.unknown,
                  identity=eng.rep.identity, rep=eng.rep, max_steps=ms)
        t0 = time.perf_counter()
        if engine == "general":
            lowered = je._run_machine.lower(
                eng.tables, meta_d, lengths_d, entries, None, **kw)
        else:
            ones = jnp.ones(B, bool)
            lowered = je._run_machine_hot.lower(
                eng.tables, eng.hot_tables, meta_d, lengths_d, entries,
                jnp.full(B, eng.spec.hid1, jnp.int32),
                ones & eng.spec.eps1, ones & eng.spec.lc1, None,
                spec=eng.spec, service_k=eng.service_k, **kw)
        compiled = lowered.compile()
        compile_s = time.perf_counter() - t0
        ma = compiled.memory_analysis()
        hlo = compiled.as_text()
        ys_shape = f"s32[{ms},{B}]"
        ys_copies = sum(1 for ln in hlo.splitlines()
                        if ys_shape in ln and " copy(" in ln)
        dt_s, steps = _timed(eng, meta_d, lengths_d, reps)
        rec = {
            "compile_s": round(compile_s, 2),
            "wave_ms": round(dt_s * 1e3, 3),
            "mbps": round(nbytes / dt_s / 1e6, 2),
            "steps": steps,
            "wall_ns_per_lane_step": round(dt_s * 1e9 / (steps * B), 4),
            "wall_us_per_step": round(dt_s * 1e6 / steps, 3),
            "event_buffer_mb": round(ms * B * 4 / 2**20, 1),
            "hlo_event_buffer_copies": ys_copies,
            "temp_mb": round(ma.temp_size_in_bytes / 2**20, 1)
            if ma is not None else None,
            "trace": _profile(eng, meta_d, lengths_d, steps,
                              f"machine_{engine}"),
        }
        stats = jax.devices()[0].memory_stats() or {}
        rec["peak_mb_so_far"] = round(
            stats.get("peak_bytes_in_use", 0) / 2**20, 1)
        out[engine] = rec
        del eng, meta_d, lengths_d
    return out


# ---------------------------------------------------------------------------
# host stages
# ---------------------------------------------------------------------------


def _host_scaling(eng, docs):
    """Per-stage host rates at the thread counts this host has."""
    import datok as dt
    from datok.utils.native import (NativeWriter, native_decode_events,
                                        native_encode_wave)

    nbytes = sum(len(d.encode()) for d in docs)
    cores = os.cpu_count() or 1
    ws = [w for w in (1, 2, 4, 8, 16) if w <= cores]
    ev, counts, bad, _state = eng.run_events_compact(
        *eng.encoder.encode_batch(docs)[:2])
    assert not bad.any()
    scratch = {}
    native_encode_wave(eng.encoder, docs, scratch=scratch)
    N = int(os.environ.get("BENCH_HOST_REPS", "9"))

    def rate(fn):
        fn()
        ts = []
        for _ in range(N):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        ts.sort()
        return [round(nbytes / t / 1e6, 1)
                for t in (ts[len(ts) // 2], ts[-1], ts[0])]

    out = {"cores": cores, "reps": N, "cell": "[median, min, max] MB/s",
           "encode": {}, "decode": {}, "format": {}}
    tri = native_decode_events(ev, counts, workers=cores)
    wtr = NativeWriter(dt.SIMPLE)
    for w in ws:
        out["encode"][str(w)] = rate(lambda: native_encode_wave(
            eng.encoder, docs, threads=w, scratch=scratch))
        out["decode"][str(w)] = rate(
            lambda: native_decode_events(ev, counts, workers=w))

        def fmt():
            wtr.lib.dt_writer_reset_output(wtr.h)
            wtr.feed_wave(tri, counts, scratch["cps"], scratch["cps_offs"],
                          scratch["cps_lens"], workers=w)

        out["format"][str(w)] = rate(fmt)
    return out


def main():
    B = int(os.environ.get("BENCH_LANES", "32768"))
    L = int(os.environ.get("BENCH_LEN", "1024"))
    reps = int(os.environ.get("BENCH_REPS", "5"))
    fast = os.environ.get("BENCH_FAST") == "1"

    import datok as dt
    from datok.fsa import synth
    from datok.runtime.jax_engine import BatchEngine
    from datok.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    tok = dt.load_matrix_file(synth.model_path("synth_de18k"))
    eng = BatchEngine(tok)
    texts = synth.lane_texts("synth_de18k", B, L, seed=1)

    result = {"metric": "tokenize_de_wave_throughput", "unit": "MB/s",
              "device": _device_info(), "engine": eng.engine,
              "lanes": B, "len": L}
    wave_mbps, steps, staged = _rate(eng, tok, texts, reps)
    result["value"] = round(wave_mbps, 2)
    result["wave_steps"] = steps
    if "--profile" in sys.argv:
        result["profile"] = _profile(eng, staged[0], staged[1], steps, "wave")
    del staged
    result["uniform_mbps"] = round(
        _rate(eng, tok, [texts[0]] * B, reps)[0], 2)
    if "--machines" in sys.argv:
        result["machines"] = _machine_ab(tok, texts, reps)

    if not fast:
        pool = synth.sentence_pool("synth_de18k", seed=3)
        lens = np.clip(synth.heavy_tail_lengths(B, seed=3, median=L // 3),
                       L // 16, L - 1)
        mixed = sorted((d[:L] for d in synth.documents(
            "synth_de18k", lens, seed=3, pool=pool)), key=len)
        result["mixed_mbps"] = round(_rate(eng, tok, mixed, reps)[0], 2)

        tok_en = dt.load_matrix_file(synth.model_path("synth_en15k"))
        eng_en = BatchEngine(tok_en)
        result["en_mbps"] = round(_rate(
            eng_en, tok_en, synth.lane_texts("synth_en15k", B, L, seed=1),
            reps)[0], 2)
        del eng_en

        dat = dt.load_datok_file(synth.model_path("synth_de18k", "datok"))
        eng_da = BatchEngine(dat)
        result["datok_mbps"] = round(
            _rate(eng_da, eng_da.tok, texts, reps)[0], 2)
        del eng_da

        from datok.runtime.overlap import tokenize_stream_pipelined
        from datok.utils.native import NativeWriter

        e2e_mb = int(os.environ.get("BENCH_E2E_MB", "48"))
        lens = synth.heavy_tail_lengths(
            (e2e_mb << 20) // 1500, seed=5, median=1500, sigma=1.2,
            hi=16384)
        text = "".join(synth.documents("synth_de18k", lens, seed=5,
                                       pool=pool))
        nbytes = len(text.encode())
        tokenize_stream_pipelined(tok, text[: len(text) // 8], engine=eng,
                                  writer=NativeWriter(dt.SIMPLE))
        best, stages = None, None
        for _ in range(2):
            stt = {}
            t0 = time.perf_counter()
            tokenize_stream_pipelined(tok, text, engine=eng,
                                      writer=NativeWriter(dt.SIMPLE),
                                      stats=stt)
            wall = time.perf_counter() - t0
            if best is None or wall < best:
                best, stages = wall, stt
        result["e2e_mbps"] = round(nbytes / best / 1e6, 2)
        result["e2e_stage_mbps"] = {
            k: round(nbytes / max(stages[k], 1e-9) / 1e6, 1)
            for k in ("encode", "dispatch", "fetch", "decode", "format")
        }
        result["mixed_pipeline"] = {
            "waves": stages["waves"], "docs": stages["docs"],
            "repairs": stages["repairs"], "long_docs": stages["long_docs"],
        }
        result["host_scaling"] = _host_scaling(eng, texts[: min(16384, B)])

    print(json.dumps(result))


if __name__ == "__main__":
    main()
