"""Vectorized input encoding: text → codepoints → symbol metadata.

The per-char symbol lookup of the reference's hot loop
(reference matrix.go:421-435: ASCII fast-path table, rune map
with identity fallback) is precomputed here for whole batches in one
vectorized pass, so the device state machine only gathers a single
packed int32 per step:

    meta = a | found<<16 | nonascii<<17 | eot<<18

where ``a`` is the symbol id (16 bit), ``found``/``nonascii`` feed the
stale-``ok`` replication, and ``eot`` marks the \\x04 end-of-text char.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..fsa.io import EOT

META_A_MASK = 0xFFFF
META_FOUND = 1 << 16
META_NONASCII = 1 << 17
META_EOT = 1 << 18
# bits 19..23: length (capped 31) of the ASCII-lowercase run starting
# at this position — lets the hot machine consume whole word interiors
# in one step for states that self-loop on every lowercase letter
META_RUN_SHIFT = 19
META_RUN_MASK = 0x1F


def text_to_codepoints(text: str) -> np.ndarray:
    """Decode a Python str into an int32 codepoint array (fast path)."""
    if not text:
        return np.zeros(0, dtype=np.int32)
    return np.frombuffer(text.encode("utf-32-le", "surrogatepass"), dtype="<u4").astype(
        np.int32
    )


class SymbolEncoder:
    """Precomputes per-position symbol metadata for a tokenizer."""

    def __init__(self, tok, lc_mask=None) -> None:
        """``lc_mask``: optional (128,) bool — the skip-class letters
        used for run marking (default ASCII [a-z]); must match the
        engine's hot-spec class for the run-skip path to be valid."""
        self.eot = EOT
        if lc_mask is None:
            lc_mask = np.zeros(128, dtype=bool)
            lc_mask[ord("a") : ord("z") + 1] = True
        self.lc_mask = np.asarray(lc_mask, dtype=bool)
        self.identity = tok.identity
        self.ascii_tab = np.asarray(tok.sigma_ascii, dtype=np.int32)
        nonascii = sorted((cp, num) for cp, num in tok.sigma.items() if cp >= 256)
        self.keys = np.array([k for k, _ in nonascii], dtype=np.int32)
        self.vals = np.array([v for _, v in nonascii], dtype=np.int32)
        self.fallback = self.identity if self.identity != -1 else 0
        self._lc_mask_u8 = None  # cached u8 view for the native encoder

    def encode(self, cp: np.ndarray) -> np.ndarray:
        """codepoints (…,) int32 → packed meta (…,) int32."""
        cp = np.asarray(cp, dtype=np.int32)
        is_ascii = cp < 256
        a_ascii = self.ascii_tab[np.clip(cp, 0, 255)]
        if len(self.keys):
            idx = np.searchsorted(self.keys, cp)
            idx_c = np.clip(idx, 0, len(self.keys) - 1)
            found = self.keys[idx_c] == cp
            a_non = np.where(found, self.vals[idx_c], self.fallback)
        else:
            found = np.zeros(cp.shape, dtype=bool)
            a_non = np.full(cp.shape, self.fallback, dtype=np.int32)
        a = np.where(is_ascii, a_ascii, a_non).astype(np.int32)
        meta = a & META_A_MASK
        meta = meta | np.where(~is_ascii & found, META_FOUND, 0)
        meta = meta | np.where(~is_ascii, META_NONASCII, 0)
        meta = meta | np.where(cp == self.eot, META_EOT, 0)
        # suffix run lengths of the skip class (vectorized)
        is_lc = (cp >= 0) & (cp < 128) & self.lc_mask[np.clip(cp, 0, 127)]
        n = cp.shape[-1] if cp.ndim else 0
        if n:
            idx = np.arange(n, dtype=np.int32)
            nn = np.where(~is_lc, idx, n)
            next_nonlc = np.minimum.accumulate(nn[::-1])[::-1]
            run = np.where(is_lc, next_nonlc - idx, 0)
            meta = meta | (np.minimum(run, META_RUN_MASK) << META_RUN_SHIFT)
        return meta.astype(np.int32)

    def encode_batch(
        self, texts: Sequence[str], pad_to: int | None = None
    ) -> Tuple[np.ndarray, np.ndarray, List[np.ndarray]]:
        """Pad a batch of texts to a common length.

        Returns (meta[B, L] int32, lengths[B] int32, codepoint arrays).
        Rides the native encoder (dt_encode2, ~240 MB/s/core, GIL
        released) when available; the pure-numpy per-text path is the
        fallback and the parity oracle (tests pin bit-identity).
        """
        try:
            from ..utils.native import native_encode_wave

            r = native_encode_wave(self, texts, pad_to=pad_to)
        except ImportError:
            r = None
        if r is not None:
            return r
        cps = [text_to_codepoints(t) for t in texts]
        metas = [self.encode(c) for c in cps]
        lengths = np.array([len(c) for c in cps], dtype=np.int32)
        L = max(1, int(lengths.max()) if len(cps) else 1)
        if pad_to is not None:
            if L > pad_to:
                raise ValueError(f"text length {L} exceeds pad_to {pad_to}")
            L = pad_to
        meta = np.zeros((len(cps), L), dtype=np.int32)
        for i, m in enumerate(metas):
            if len(m):
                meta[i, : len(m)] = m
        return meta, lengths, cps
