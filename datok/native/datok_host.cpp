// Native host runtime for datok.
//
// The device owns the transduce hot loop; these are the *host-side* hot
// paths around it, equivalent to the reference's Go runtime glue:
//
//   * dt_encode      — UTF-8 bytes → codepoints + packed symbol metadata
//                      (the sigma lookup of matrix.go:421-435, vectorized
//                      per byte on the host feeding side)
//   * dt_transduce   — full scalar matrix transduce emitting boundary
//                      events (the exact loop of matrix.go:383-697); used
//                      for fallback lanes and as a fast CPU baseline
//   * dt_format      — event stream → output bytes with TokenWriter
//                      parity for every flag combination
//                      (token_writer.go:36-175)
//
// Exposed as a plain C ABI for ctypes; built with setup_native.py.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// UTF-8 decode + symbol metadata packing (see runtime/encode.py)
// ---------------------------------------------------------------------------

static const uint32_t META_FOUND = 1u << 16;
static const uint32_t META_NONASCII = 1u << 17;
static const uint32_t META_EOT = 1u << 18;
static const int META_RUN_SHIFT = 19;
// Bits 19..23 = capped skip-class run length (META_RUN_*).
static const uint32_t META_RUN_MASK = 0x1F;

// Decode UTF-8 `data[0:n]`; write codepoints to cps (capacity n) and
// packed meta to metas.  `ascii_tab` has 256 entries; `keys`/`vals`
// (n_keys) are the sorted non-ASCII sigma pairs; `fallback` is the
// identity symbol or 0.  Returns number of codepoints.
// Fused single-streaming-pass core: UTF-8 decode + meta, with the
// suffix-run field filled per skip-class SEGMENT as each run closes
// (the just-written metas are still in L1).  Bit-identical to
// encode.py's numpy encoder by construction (parity pinned by
// tests/test_native.py).

static inline void fill_run(int32_t* metas, int64_t s, int64_t e) {
  // run[i] = e - i for i in [s, e): length of the skip-class run
  // starting at i (clamped to the field mask), matching encode.py's
  // next_nonlc - idx
  for (int64_t j = s; j < e; j++) {
    int64_t r = e - j;
    if (r > (int64_t)META_RUN_MASK) r = (int64_t)META_RUN_MASK;
    metas[j] |= (int32_t)r << META_RUN_SHIFT;
  }
}

static int64_t encode_core(const uint8_t* data, int64_t n,
                           const int32_t* ascii_tab, const int32_t* keys,
                           const int32_t* vals, int64_t n_keys,
                           int32_t fallback, const uint8_t* lc_mask,
                           int32_t* cps, int32_t* metas) {
  int64_t out = 0;
  int64_t i = 0;
  int64_t run_start = -1;  // open skip-class segment, or -1
  // Precomputed ASCII meta line (256 × i32): collapses the EOT test
  // into one load for the ~95% of German/English bytes that are
  // single-byte UTF-8.
  int32_t ascii_meta[256];
  uint8_t ascii_lc[256];
  for (int c = 0; c < 256; c++) {
    uint32_t m = (uint32_t)ascii_tab[c] & 0xFFFF;
    if (c == 4) m |= META_EOT;
    ascii_meta[c] = (int32_t)m;
    ascii_lc[c] = lc_mask != nullptr ? (c < 128 && lc_mask[c])
                                     : (c >= 'a' && c <= 'z');
  }
  while (i < n) {
    // ASCII chunk fast path: no UTF-8 branching, one table load per
    // byte (checked 8 bytes at a time via the high-bit mask)
    while (i + 8 <= n) {
      uint64_t w;
      memcpy(&w, data + i, 8);
      if (w & 0x8080808080808080ULL) break;
      for (int k = 0; k < 8; k++) {
        uint8_t b = data[i + k];
        if (ascii_lc[b]) {
          if (run_start < 0) run_start = out;
        } else if (run_start >= 0) {
          fill_run(metas, run_start, out);
          run_start = -1;
        }
        cps[out] = (int32_t)b;
        metas[out] = ascii_meta[b];
        out++;
      }
      i += 8;
    }
    if (i >= n) break;
    uint32_t cp;
    uint8_t b0 = data[i];
    if (b0 < 0x80) {
      cp = b0;
      i += 1;
    } else if ((b0 >> 5) == 0x6 && i + 1 < n) {
      cp = ((b0 & 0x1F) << 6) | (data[i + 1] & 0x3F);
      i += 2;
    } else if ((b0 >> 4) == 0xE && i + 2 < n) {
      cp = ((b0 & 0x0F) << 12) | ((data[i + 1] & 0x3F) << 6) |
           (data[i + 2] & 0x3F);
      i += 3;
    } else if ((b0 >> 3) == 0x1E && i + 3 < n) {
      cp = ((b0 & 0x07) << 18) | ((data[i + 1] & 0x3F) << 12) |
           ((data[i + 2] & 0x3F) << 6) | (data[i + 3] & 0x3F);
      i += 4;
    } else {
      cp = 0xFFFD;  // invalid byte: U+FFFD, advance one (Go ReadRune)
      i += 1;
    }
    uint32_t meta;
    if (cp < 256) {
      meta = (uint32_t)ascii_tab[cp] & 0xFFFF;
      if (cp == 4) meta |= META_EOT;
    } else {
      // binary search the sorted non-ASCII keys
      int64_t lo = 0, hi = n_keys;
      while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if ((uint32_t)keys[mid] < cp)
          lo = mid + 1;
        else
          hi = mid;
      }
      if (lo < n_keys && (uint32_t)keys[lo] == cp) {
        meta = ((uint32_t)vals[lo] & 0xFFFF) | META_FOUND | META_NONASCII;
      } else {
        meta = ((uint32_t)fallback & 0xFFFF) | META_NONASCII;
      }
    }
    bool is_lc = lc_mask != nullptr ? (cp < 128 && lc_mask[cp])
                                    : (cp >= 'a' && cp <= 'z');
    if (is_lc) {
      if (run_start < 0) run_start = out;
    } else if (run_start >= 0) {
      fill_run(metas, run_start, out);
      run_start = -1;
    }
    cps[out] = (int32_t)cp;
    metas[out] = (int32_t)meta;
    out++;
  }
  if (run_start >= 0) fill_run(metas, run_start, out);
  return out;
}

int64_t dt_encode(const uint8_t* data, int64_t n, const int32_t* ascii_tab,
                  const int32_t* keys, const int32_t* vals, int64_t n_keys,
                  int32_t fallback, int32_t* cps, int32_t* metas) {
  return encode_core(data, n, ascii_tab, keys, vals, n_keys, fallback,
                     nullptr, cps, metas);
}

// Device-feed encoder: dt_encode plus the engine-coupled skip-class
// mask (`lc_mask`, 128 bytes; the engine's hot-spec class, which may
// drop letters like 's' from [a-z]) for the run field.  It may be null
// (run field falls back to [a-z]).  Output metas are valid input for
// any engine constructed with the same encoder tables.
int64_t dt_encode2(const uint8_t* data, int64_t n, const int32_t* ascii_tab,
                   const int32_t* keys, const int32_t* vals, int64_t n_keys,
                   int32_t fallback, const uint8_t* lc_mask, int32_t* cps,
                   int32_t* metas) {
  return encode_core(data, n, ascii_tab, keys, vals, n_keys, fallback,
                     lc_mask, cps, metas);
}

// Whole-wave encoder: B documents concatenated in `data` at byte
// offsets `offs[0..B]`, each row encoded straight into the padded
// device layout `meta_out + i*L` (caller pre-zeroes the pad cells)
// with its codepoints packed at `cps_out + offs[i]` (codepoint count
// ≤ byte count, so byte offsets are safe row bounds).  Rows are
// independent, so the wave is split across `n_threads` OS threads —
// the ctypes caller releases the GIL, making this the host feeding
// stage that runs concurrently with the device wave (SURVEY.md §5
// "communication backend": scaling is bounded by input feeding).
// Returns 0, or -1 if any row's codepoint count exceeds L.
int64_t dt_encode_batch(const uint8_t* data, const int64_t* offs, int64_t B,
                        const int32_t* ascii_tab, const int32_t* keys,
                        const int32_t* vals, int64_t n_keys, int32_t fallback,
                        const uint8_t* lc_mask, int64_t L, int32_t* meta_out,
                        int32_t* cps_out, int32_t* lengths,
                        int32_t n_threads);

// Per-row codepoint counts (bytes minus UTF-8 continuation bytes) —
// the cheap pre-pass that sizes the padded meta wave exactly.
void dt_cp_lens(const uint8_t* data, const int64_t* offs, int64_t B,
                int32_t* out) {
  for (int64_t i = 0; i < B; i++) {
    int64_t cont = 0;
    for (int64_t j = offs[i]; j < offs[i + 1]; j++)
      cont += (data[j] & 0xC0) == 0x80;
    out[i] = (int32_t)(offs[i + 1] - offs[i] - cont);
  }
}

static void encode_rows(const uint8_t* data, const int64_t* offs, int64_t lo,
                        int64_t hi, const int32_t* ascii_tab,
                        const int32_t* keys, const int32_t* vals,
                        int64_t n_keys, int32_t fallback,
                        const uint8_t* lc_mask, int64_t L, int32_t* meta_out,
                        int32_t* cps_out, int32_t* lengths, int* err) {
  for (int64_t i = lo; i < hi; i++) {
    int64_t n = offs[i + 1] - offs[i];
    int64_t out = dt_encode2(data + offs[i], n, ascii_tab, keys, vals,
                             n_keys, fallback, lc_mask, cps_out + offs[i],
                             meta_out + i * L);
    if (out > L) {
      *err = 1;
      return;
    }
    // zero the pad cells so callers can reuse buffers across waves
    if (out < L)
      memset(meta_out + i * L + out, 0, (size_t)(L - out) * sizeof(int32_t));
    lengths[i] = (int32_t)out;
  }
}

int64_t dt_encode_batch(const uint8_t* data, const int64_t* offs, int64_t B,
                        const int32_t* ascii_tab, const int32_t* keys,
                        const int32_t* vals, int64_t n_keys, int32_t fallback,
                        const uint8_t* lc_mask, int64_t L, int32_t* meta_out,
                        int32_t* cps_out, int32_t* lengths,
                        int32_t n_threads) {
  int err = 0;
  if (n_threads <= 1 || B < 64) {
    encode_rows(data, offs, 0, B, ascii_tab, keys, vals, n_keys, fallback,
                lc_mask, L, meta_out, cps_out, lengths, &err);
    return err ? -1 : 0;
  }
  std::vector<std::thread> ts;
  std::vector<int> errs(n_threads, 0);
  int64_t chunk = (B + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; t++) {
    int64_t lo = t * chunk, hi = lo + chunk > B ? B : lo + chunk;
    if (lo >= hi) break;
    ts.emplace_back(encode_rows, data, offs, lo, hi, ascii_tab, keys, vals,
                    n_keys, fallback, lc_mask, L, meta_out,
                    cps_out, lengths, &errs[t]);
  }
  for (auto& th : ts) th.join();
  for (int e : errs)
    if (e) return -1;
  return 0;
}

// ---------------------------------------------------------------------------
// Scalar matrix transduce → events (matrix.go:383-697 semantics)
// ---------------------------------------------------------------------------

static const uint32_t FIRSTBIT = 1u << 31;

// events written as triples (kind, start, end); kinds 1=TOKEN 2=SENT 3=TEXT.
// Returns event count, or -1 if ev_cap exceeded.
int64_t dt_transduce(const uint32_t* table, int32_t state_count, int32_t eps,
                     int32_t unknown, int32_t identity, int32_t t_init,
                     const int32_t* metas, int64_t n, int32_t* ev,
                     int64_t ev_cap, int32_t* t_out) {
  const int64_t S = state_count;
  int64_t nev = 0;
#define EMIT(k, s, e)                        \
  do {                                       \
    if (nev + 3 > ev_cap) return -1;         \
    ev[nev++] = (k);                         \
    ev[nev++] = (int32_t)(s);                \
    ev[nev++] = (int32_t)(e);                \
  } while (0)

  uint32_t t = (uint32_t)t_init & 0x0FFFFFFF;
  int64_t t0 = 0;
  int32_t a = 0;
  bool ok = ((t_init >> 30) & 1) != 0, eot = false, newchar = true;
  int64_t eps_state = 0, eps_offset = 0;
  bool sentence_end = ((t_init >> 28) & 1) != 0;
  bool text_end = ((t_init >> 29) & 1) != 0;
  int64_t b = 0, ft = 0, c = 0;
  bool in_loop = true;

  for (;;) {
    if (in_loop) {
      if (newchar) {
        if (c >= n) {
          in_loop = false;
          continue;
        }
        uint32_t m = (uint32_t)metas[c];
        a = (int32_t)(m & 0xFFFF);
        eot = (m & META_EOT) != 0;
        if (m & META_NONASCII) ok = (m & META_FOUND) != 0;
        t0 = (int64_t)t;
        if (table[(int64_t)(eps - 1) * S + t0] != 0) {
          eps_state = t0;
          eps_offset = c;
        }
      }
      uint32_t traw = (a == 0) ? 0u : table[(int64_t)(a - 1) * S + t0];
      if (traw == 0) {
        if (!ok && a == identity) {
          a = unknown;
          newchar = false;
          eot = false;
          continue;
        } else if (a != eps && eps_state != 0) {
          t0 = eps_state;
          eps_state = 0;
          c = eps_offset;
          a = eps;
          newchar = false;
          eot = false;
          continue;
        } else {
          if (c - b - ft <= 0) c++;
          EMIT(1, b + ft, c);
          sentence_end = false;
          text_end = false;
          b = c;
          ft = 0;
          eps_state = 0;
          a = eps;
          t = 1;
          newchar = true;
          continue;
        }
      }
      // success
      bool rewind = false;
      bool nontoken = (traw & FIRSTBIT) != 0;
      if (a == eps) {
        if (c - b > ft) {
          EMIT(1, b + ft, c);
          rewind = true;
          sentence_end = false;
          text_end = false;
        } else {
          sentence_end = true;
          EMIT(2, c, c);
        }
      } else {
        c++;
        if ((c - b) - ft == 1 && nontoken) ft++;
      }
      if (eot) {
        eot = false;
        if (!sentence_end) {
          sentence_end = true;
          EMIT(2, c, c);
        }
        text_end = true;
        EMIT(3, c, c);
        rewind = true;
      }
      if (rewind) {
        b = c;
        ft = 0;
        eps_offset = 0;
        eps_state = 0;
      }
      t = traw & ~FIRSTBIT;
      newchar = true;
      continue;
    }
    // epilogue
    t0 = (int64_t)t;
    a = eps;
    newchar = false;
    if (table[(int64_t)(eps - 1) * S + t0] != 0) {
      in_loop = true;
      continue;
    }
    if (eps_state != 0) {
      t0 = eps_state;
      eps_state = 0;
      c = eps_offset;
      in_loop = true;
      continue;
    }
    break;
  }
  if (c - b > ft) {
    EMIT(1, b + ft, c);
    sentence_end = false;
    text_end = false;
  }
  if (!sentence_end) EMIT(2, c, c);
  if (!text_end) EMIT(3, c, c);
#undef EMIT
  if (t_out)
    *t_out = (int32_t)(t | ((uint32_t)sentence_end << 28) |
                       ((uint32_t)text_end << 29) | ((uint32_t)ok << 30));
  return nev / 3;
}

// Cut walk for speculative segmentation (runtime/oracle.py
// transduce_events(start/stop_at/rewinds_box) semantics): replay from a
// rewind checkpoint `t_init` with buffer base `start` over absolute
// document metas, stopping cleanly before reading the character at
// `stop_at` — no EOF epilogue, no residual flush.  Emits events
// (absolute positions) and the rewind-checkpoint stream as
// (pos, packed_ctx, n_events_so_far) triples, including the entry
// configuration.  Returns event count, or -1 on capacity overflow
// (`n_rw` in/out: capacity in, count out).
int64_t dt_cut_walk(const uint32_t* table, int32_t state_count, int32_t eps,
                    int32_t unknown, int32_t identity, int32_t t_init,
                    const int32_t* metas, int64_t start, int64_t stop_at,
                    int32_t* ev, int64_t ev_cap, int32_t* rw, int64_t* n_rw) {
  const int64_t S = state_count;
  const int64_t rw_cap = *n_rw;
  int64_t nev = 0, nrw = 0;
#define EMIT(k, s, e)                        \
  do {                                       \
    if (nev + 3 > ev_cap) return -1;         \
    ev[nev++] = (k);                         \
    ev[nev++] = (int32_t)(s);                \
    ev[nev++] = (int32_t)(e);                \
  } while (0)
#define CKPT(p, ctx)                         \
  do {                                       \
    if (nrw + 3 > rw_cap) return -1;         \
    rw[nrw++] = (int32_t)(p);                \
    rw[nrw++] = (int32_t)(ctx);              \
    rw[nrw++] = (int32_t)(nev / 3);          \
  } while (0)

  uint32_t t = (uint32_t)t_init & 0x0FFFFFFF;
  int64_t t0 = 0;
  int32_t a = 0;
  bool ok = ((t_init >> 30) & 1) != 0, eot = false;
  int64_t eps_state = 0, eps_offset = 0;
  bool sentence_end = ((t_init >> 28) & 1) != 0;
  bool text_end = ((t_init >> 29) & 1) != 0;
  int64_t b = start, ft = 0, c = start;
  bool newchar = true;
  CKPT(start, t_init);

  for (;;) {
    if (newchar) {
      if (c >= stop_at) break;  // stop cleanly before reading stop_at
      uint32_t m = (uint32_t)metas[c];
      a = (int32_t)(m & 0xFFFF);
      eot = (m & META_EOT) != 0;
      if (m & META_NONASCII) ok = (m & META_FOUND) != 0;
      t0 = (int64_t)t;
      if (table[(int64_t)(eps - 1) * S + t0] != 0) {
        eps_state = t0;
        eps_offset = c;
      }
    }
    uint32_t traw = (a == 0) ? 0u : table[(int64_t)(a - 1) * S + t0];
    if (traw == 0) {
      if (!ok && a == identity) {
        a = unknown;
        newchar = false;
        eot = false;
        continue;
      } else if (a != eps && eps_state != 0) {
        t0 = eps_state;
        eps_state = 0;
        c = eps_offset;
        a = eps;
        newchar = false;
        eot = false;
        continue;
      } else {
        if (c - b - ft <= 0) c++;
        EMIT(1, b + ft, c);
        sentence_end = false;
        text_end = false;
        b = c;
        ft = 0;
        eps_state = 0;
        a = eps;
        t = 1;
        CKPT(b, 1u | ((uint32_t)ok << 30));
        newchar = true;
        continue;
      }
    }
    bool rewind = false;
    bool nontoken = (traw & FIRSTBIT) != 0;
    if (a == eps) {
      if (c - b > ft) {
        EMIT(1, b + ft, c);
        rewind = true;
        sentence_end = false;
        text_end = false;
      } else {
        sentence_end = true;
        EMIT(2, c, c);
      }
    } else {
      c++;
      if ((c - b) - ft == 1 && nontoken) ft++;
    }
    if (eot) {
      eot = false;
      if (!sentence_end) {
        sentence_end = true;
        EMIT(2, c, c);
      }
      text_end = true;
      EMIT(3, c, c);
      rewind = true;
    }
    if (rewind) {
      b = c;
      ft = 0;
      eps_offset = 0;
      eps_state = 0;
    }
    t = traw & ~FIRSTBIT;
    if (rewind)
      CKPT(b, t | ((uint32_t)sentence_end << 28) | ((uint32_t)text_end << 29) |
                   ((uint32_t)ok << 30));
    newchar = true;
  }
#undef CKPT
#undef EMIT
  *n_rw = nrw / 3;
  return nev / 3;
}

// ---------------------------------------------------------------------------
// Double-array construction (datok.go:82-236 semantics)
//
// Bit-identical to the Python builder in fsa/double_array.py (same BFS
// order, same first-fit + Niu-skip placement policy, datok.go:381-401)
// but runs the sequential slot search in C++ — the reference's Go
// construction speed class for the offline model compiler.  Arcs come
// flattened per state, symbols ascending: arc_off[s]..arc_off[s+1]
// index arc_sym/arc_end/arc_flags (flags: bit0 nontoken, bit1
// tokenend; the `final` pseudo-symbol has end=0).
// ---------------------------------------------------------------------------

static const uint32_t DA_SECONDBIT = 1u << 30;

struct DaBuild {
  std::vector<uint32_t> base, check;
  int64_t n = 0;
};

void* dt_da_build(const int64_t* arc_off, const int32_t* arc_sym,
                  const int32_t* arc_end, const uint8_t* arc_flags,
                  int32_t n_states, int32_t final_sym) {
  auto* h = new DaBuild();
  std::vector<uint32_t>& base = h->base;
  std::vector<uint32_t>& check = h->check;
  std::vector<uint8_t> occ;
  int64_t cap = 1024;
  base.assign(cap, 0);
  check.assign(cap, 0);
  occ.assign(cap, 0);
  int64_t first_free = 1, max_size = 0;
  std::vector<int64_t> lookup(n_states + 2, 0);
  std::vector<int32_t> qs;
  std::vector<int64_t> qt;
  qs.reserve(n_states + 1);
  qt.reserve(n_states + 1);
  qs.push_back(1);
  qt.push_back(1);
  lookup[1] = 1;
  auto ensure = [&](int64_t need) {
    if (need >= cap) {
      int64_t ncap = cap * 2;
      while (ncap <= need) ncap *= 2;
      base.resize(ncap, 0);
      check.resize(ncap, 0);
      occ.resize(ncap, 0);
      cap = ncap;
    }
  };
  for (size_t mark = 0; mark < qs.size(); mark++) {
    int32_t s = qs[mark];
    int64_t t = qt[mark];
    int64_t a0 = arc_off[s], a1 = arc_off[s + 1];
    int64_t b = 1;
    if (a1 > a0) {
      int32_t amin = arc_sym[a0], amax = arc_sym[a1 - 1];
      if (a1 - a0 >= 3) {  // Niu skip: dense states start near the end
        b = (int64_t)std::fabs((double)(max_size - 1) * 0.9) + 1;
      } else {
        while (first_free < cap && occ[first_free]) first_free++;
        b = first_free - amin;
        if (b < 1) b = 1;
      }
      for (;; b++) {
        ensure(b + amax + 1);
        bool ok = true;
        for (int64_t i = a0; i < a1; i++)
          if (occ[b + arc_sym[i]]) {
            ok = false;
            break;
          }
        if (ok) break;
      }
    }
    base[t] = (uint32_t)b;
    for (int64_t i = a0; i < a1; i++) {
      int32_t a = arc_sym[i];
      int64_t t1 = b + a;
      ensure(t1 + 1);
      if (a != final_sym) {
        uint32_t cell = (uint32_t)t;
        if (arc_flags[i] & 1) cell |= FIRSTBIT;
        if (arc_flags[i] & 2) cell |= DA_SECONDBIT;
        check[t1] = cell;
        occ[t1] = 1;
        if (max_size < t1) max_size = t1;
        int32_t s1 = arc_end[i];
        int64_t r = lookup[s1];
        if (r == 0) {
          lookup[s1] = t1;
          qs.push_back(s1);
          qt.push_back(t1);
        } else {
          // duplicate target: point at the representative (separate bit)
          base[t1] = (uint32_t)r | FIRSTBIT;
        }
      } else {
        check[t1] = (uint32_t)t;
        occ[t1] = 1;
        if (max_size < t1) max_size = t1;
      }
    }
  }
  int64_t n = max_size + final_sym;
  ensure(n);
  base.resize(n);
  check.resize(n);
  check[1] = (uint32_t)n;  // array size lives in check(1) (datok.go:230)
  h->n = n;
  return h;
}

int64_t dt_da_size(void* hv) { return ((DaBuild*)hv)->n; }
void dt_da_copy(void* hv, uint32_t* base_out, uint32_t* check_out) {
  auto* h = (DaBuild*)hv;
  memcpy(base_out, h->base.data(), h->n * 4);
  memcpy(check_out, h->check.data(), h->n * 4);
}
void dt_da_free(void* hv) { delete (DaBuild*)hv; }

// ---------------------------------------------------------------------------
// Event formatting with TokenWriter parity (token_writer.go:36-175)
// ---------------------------------------------------------------------------

static const int F_TOKENS = 1;
static const int F_SENTENCES = 2;
static const int F_TOKEN_POS = 4;
static const int F_SENTENCE_POS = 8;
static const int F_NEWLINE_AFTER_EOT = 16;

struct DtWriter {
  int flags;
  std::string out;
  int64_t pos_c = 0;
  std::vector<int64_t> pos;
  bool sent_b = true;
  std::vector<int64_t> sent;
  bool init = true;
};

static void append_utf8(std::string& s, const int32_t* cps, int64_t a,
                        int64_t b) {
  for (int64_t i = a; i < b; i++) {
    uint32_t cp = (uint32_t)cps[i];
    if (cp < 0x80) {
      s.push_back((char)cp);
    } else if (cp < 0x800) {
      s.push_back((char)(0xC0 | (cp >> 6)));
      s.push_back((char)(0x80 | (cp & 0x3F)));
    } else if (cp < 0x10000) {
      s.push_back((char)(0xE0 | (cp >> 12)));
      s.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
      s.push_back((char)(0x80 | (cp & 0x3F)));
    } else {
      s.push_back((char)(0xF0 | (cp >> 18)));
      s.push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
      s.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
      s.push_back((char)(0x80 | (cp & 0x3F)));
    }
  }
}

static void append_list(std::string& s, const std::vector<int64_t>& v) {
  char buf[24];
  for (size_t i = 0; i < v.size(); i++) {
    if (i) s.push_back(' ');
    int len = snprintf(buf, sizeof buf, "%lld", (long long)v[i]);
    s.append(buf, len);
  }
  s.push_back('\n');
}

DtWriter* dt_writer_new(int flags) { return new DtWriter{flags}; }
void dt_writer_free(DtWriter* w) { delete w; }

// Replay one document's events.  `cps` are the document codepoints,
// `base0` the replay base (0 for a fresh document).
void dt_writer_feed(DtWriter* w, const int32_t* ev, int64_t nev,
                    const int32_t* cps, int64_t n_cps) {
  int64_t base = 0;
  int f = w->flags;
  for (int64_t i = 0; i < nev; i++) {
    int32_t kind = ev[i * 3];
    int64_t start = ev[i * 3 + 1];
    int64_t end = ev[i * 3 + 2];
    if (kind == 1) {  // TOKEN(offset=start-base, buf=cps[base:end])
      int64_t offset = start - base;
      if (f & (F_TOKEN_POS | F_SENTENCE_POS)) {
        if (w->pos_c == 0 && (f & F_NEWLINE_AFTER_EOT) && end > base &&
            cps[base] == '\n' && !w->init)
          w->pos_c--;
        w->init = false;
        w->pos_c += offset;
        w->pos.push_back(w->pos_c);
        if (w->sent_b) {
          w->sent_b = false;
          w->sent.push_back(w->pos_c);
        }
        w->pos_c += (end - base) - offset;
        w->pos.push_back(w->pos_c);
        if (f & F_TOKENS) {
          append_utf8(w->out, cps, start, end);
          w->out.push_back('\n');
        }
      } else if (f & F_TOKENS) {
        append_utf8(w->out, cps, start, end);
        w->out.push_back('\n');
      }
      base = end;
    } else if (kind == 2) {  // SENT
      if (f & F_SENTENCE_POS) {
        w->sent.push_back(w->pos.empty() ? 0 : w->pos.back());
        w->sent_b = true;
        if (f & F_SENTENCES) w->out.push_back('\n');
      } else if (f & F_SENTENCES) {
        w->out.push_back('\n');
      }
    } else if (kind == 3) {  // TEXT
      if (f & (F_TOKEN_POS | F_SENTENCE_POS)) {
        if (f & F_TOKEN_POS) append_list(w->out, w->pos);
        if (f & F_SENTENCE_POS) {
          append_list(w->out, w->sent);
          w->sent.clear();
          w->sent_b = true;
        }
        w->pos_c = 0;
        w->pos.clear();
      } else {
        w->out.push_back('\n');
      }
      base = end;
    }
  }
}

// Replay a whole wave of documents in one call: events for document i
// are `ev_counts[i]` consecutive triples in `ev`; its codepoints sit
// at `cps + cps_offs[i]` with length `cps_lens[i]`.  One GIL-releasing
// call per wave replaces tens of thousands of per-document calls in
// the overlapped pipeline's formatting stage.
void dt_writer_feed_wave(DtWriter* w, const int32_t* ev,
                         const int32_t* ev_counts, int64_t n_docs,
                         const int32_t* cps, const int64_t* cps_offs,
                         const int32_t* cps_lens) {
  int64_t off = 0;
  for (int64_t i = 0; i < n_docs; i++) {
    dt_writer_feed(w, ev + off * 3, ev_counts[i], cps + cps_offs[i],
                   cps_lens[i]);
    off += ev_counts[i];
  }
}

// Multithreaded wave replay: split the wave's documents into chunks
// at CLEAN writer boundaries (a document whose final event is a TEXT
// end — after TextEnd every writer register is reset,
// token_writer.go:130-167), format each chunk into a private writer
// on its own OS thread, then concatenate the chunk outputs in order.
// Chunk 0 inherits the parent writer's carried state; later chunks
// start in the canonical post-TextEnd state (init=false: they are
// never the stream's first text, so the NEWLINE_AFTER_EOT discount
// applies normally).  The parent adopts the last chunk's state.
// Byte-identical to the serial feed by construction.
void dt_writer_feed_wave_mt(DtWriter* w, const int32_t* ev,
                            const int32_t* ev_counts, int64_t n_docs,
                            const int32_t* cps, const int64_t* cps_offs,
                            const int32_t* cps_lens, int n_threads) {
  if (n_threads <= 1 || n_docs < 4) {
    dt_writer_feed_wave(w, ev, ev_counts, n_docs, cps, cps_offs, cps_lens);
    return;
  }
  std::vector<int64_t> ev_off(n_docs + 1);
  int64_t total_cps = 0;
  for (int64_t i = 0; i < n_docs; i++) {
    ev_off[i + 1] = ev_off[i] + ev_counts[i];
    total_cps += cps_lens[i];
  }
  // clean boundary AFTER doc i ⇔ its last event is TEXT (kind 3)
  // greedy chunking toward equal codepoint shares
  std::vector<int64_t> starts;
  starts.push_back(0);
  int64_t target = total_cps / n_threads + 1;
  int64_t acc = 0;
  for (int64_t i = 0; i < n_docs - 1; i++) {
    acc += cps_lens[i];
    bool clean = ev_counts[i] > 0 && ev[(ev_off[i + 1] - 1) * 3] == 3;
    if (clean && acc >= target && (int64_t)starts.size() < n_threads) {
      starts.push_back(i + 1);
      acc = 0;
    }
  }
  int64_t n_chunks = (int64_t)starts.size();
  if (n_chunks <= 1) {
    dt_writer_feed_wave(w, ev, ev_counts, n_docs, cps, cps_offs, cps_lens);
    return;
  }
  starts.push_back(n_docs);
  std::vector<DtWriter> locals(n_chunks);
  for (int64_t c = 0; c < n_chunks; c++) {
    locals[c].flags = w->flags;
    if (c == 0) {
      locals[c].pos_c = w->pos_c;
      locals[c].pos = w->pos;
      locals[c].sent_b = w->sent_b;
      locals[c].sent = w->sent;
      locals[c].init = w->init;
    } else {
      locals[c].init = false;
    }
  }
  std::vector<std::thread> ths;
  for (int64_t c = 0; c < n_chunks; c++) {
    int64_t lo = starts[c], hi = starts[c + 1];
    ths.emplace_back([&, c, lo, hi]() {
      dt_writer_feed_wave(&locals[c], ev + ev_off[lo] * 3, ev_counts + lo,
                          hi - lo, cps, cps_offs + lo, cps_lens + lo);
    });
  }
  for (auto& t : ths) t.join();
  size_t add = 0;
  for (auto& l : locals) add += l.out.size();
  w->out.reserve(w->out.size() + add);
  for (auto& l : locals) w->out += l.out;
  DtWriter& last = locals[n_chunks - 1];
  w->pos_c = last.pos_c;
  w->pos = std::move(last.pos);
  w->sent_b = last.sent_b;
  w->sent = std::move(last.sent);
  w->init = last.init;
}

// Threaded decode of the compacted device event buffer: lane i's
// `counts[i]` packed events (kind|start<<2|end<<17, row-major (B, E))
// become consecutive (kind, start, end) triples at tri + out_off[i]*3.
// Replaces the numpy mask-and-fancy-index decode (GIL-bound, one
// core) in the pipeline's decode stage.
void dt_decode_events(const uint32_t* ev, int64_t B, int64_t E,
                      const int32_t* counts, int32_t* tri,
                      int n_threads) {
  // Clamp each lane's count to the row width E: callers are expected
  // to slice ev so E >= counts.max(), but a narrower slice must read
  // garbage rows, not out-of-bounds memory (the numpy decode this
  // replaces silently truncated via its mask).  Offsets use the same
  // clamped counts so tri stays densely packed.
  std::vector<int64_t> off(B + 1);
  for (int64_t i = 0; i < B; i++) {
    int64_t c = counts[i] < E ? counts[i] : E;
    if (c < 0) c = 0;
    off[i + 1] = off[i] + c;
  }
  int nt = n_threads < 1 ? 1 : n_threads;
  if ((int64_t)nt > B) nt = (int)B;
  std::vector<std::thread> ths;
  for (int t = 0; t < nt; t++) {
    int64_t lo = B * t / nt, hi = B * (t + 1) / nt;
    ths.emplace_back([&, lo, hi]() {
      for (int64_t i = lo; i < hi; i++) {
        const uint32_t* src = ev + i * E;
        int32_t* dst = tri + off[i] * 3;
        int64_t n = off[i + 1] - off[i];
        for (int64_t j = 0; j < n; j++) {
          uint32_t v = src[j];
          dst[j * 3] = (int32_t)(v & 3u);
          dst[j * 3 + 1] = (int32_t)((v >> 2) & 0x7FFFu);
          dst[j * 3 + 2] = (int32_t)((v >> 17) & 0x7FFFu);
        }
      }
    });
  }
  for (auto& t : ths) t.join();
}

int64_t dt_writer_size(DtWriter* w) { return (int64_t)w->out.size(); }
void dt_writer_copy(DtWriter* w, uint8_t* dst) {
  memcpy(dst, w->out.data(), w->out.size());
}
void dt_writer_reset_output(DtWriter* w) { w->out.clear(); }

}  // extern "C"
