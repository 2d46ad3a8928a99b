"""Batched transduce engine (XLA state machines).

Runs the reference's greedy single-backtrack transduce loop
(matrix.go:383-697, datok.go:830-1135) as a *masked, branchless*
state machine over B independent input lanes: one loop iteration
executes exactly one iteration of the reference's per-character loop
for every lane in parallel — divergence (backtracks, retries,
force-emits, epilogue) is handled with masks, not branches.

Two machines share one step-semantics factory (:func:`_make_step`):

**General machine** — transition/probe/meta fetched with ``jnp.take``
(plain gathers from the transition table).  Correct for either
representation (matrix or double array); it is also the *service
step* of the hot machine.

**Hot machine** (matrix representation) — transitions through a
profiled hot set of H states are computed without gathers:

  * the hot transition table is stored as three bf16 byte planes
    ``(A_pad, 3H)``; a one-hot of the input symbol row-selects via a
    matrix product (exact: byte values ≤ 255 are exact in bf16 and the
    product accumulates in f32 — widening the operands to f32 would
    need ``precision=HIGHEST``, or TF32 rounding corrupts state ids),
    and a mask-reduce over H selects the current state's column;
  * packed entries carry target (hot id or full state id), the
    nontoken flag, and the ε-availability of the *target*, so the
    per-char ε-probe becomes a carried register instead of a lookup;
  * per-lane input symbols come from a ring window of the meta array
    refreshed by contiguous ``dynamic_slice`` — lanes that leave the
    window or reach a cold state simply *stall*;
  * every ``service_k`` steps (or when too many lanes stall) one
    general step runs with full gathers, advancing every lane exactly
    per the reference semantics and re-deriving hot ids — cold
    transitions are therefore exact, just amortized.

Boundary events are emitted scatter-free: each lane emits at most one
packed int32 event per step (``kind | start<<2 | end<<17``) written as
one contiguous row into a step-indexed buffer, with a 2-deep pending
queue draining the rare multi-event steps.  The host decodes lanes
with vectorized numpy and replays events through :class:`TokenWriter`
for byte-identical output (see :mod:`datok.runtime.events`).

Lanes that exceed the step budget are flagged and transparently re-run
through the scalar oracle by the pipeline.  Packed positions carry 15
bits, so one engine call handles segments up to 32 K chars; longer
streams go through the segmentation layer.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import numpy as np

import jax
import jax.numpy as jnp

from ..fsa.io import FIRSTBIT, RESTBIT
from .encode import (META_A_MASK, META_EOT, META_FOUND, META_NONASCII,
                     META_RUN_MASK, META_RUN_SHIFT, SymbolEncoder)
from .events import EV_SENT, EV_TEXT, EV_TOKEN

I32 = jnp.int32

# Packed-event layout: kind(2) | start(15) | end(15)
PACK_POS_BITS = 15
PACK_POS_MASK = (1 << PACK_POS_BITS) - 1
MAX_SEGMENT = PACK_POS_MASK - 2

# Hot-entry layout (3 byte planes = 24 bits):
#   bit0 valid | bit1 hot-target | bit2 nontoken | bit3 eps-at-target |
#   bit4 lowercase-self-loop-at-target |
#   bits5.. payload (hot id if hot-target else full state id)
_HE_VALID = 1
_HE_HOT = 2
_HE_NONTOK = 4
_HE_EPS = 8
_HE_LC = 16

RING = 128  # meta ring window rows


class MatrixRep:
    """Dense-matrix transition semantics (matrix.go:442-463, 629)."""

    def __init__(self, tok):
        self.S = int(tok.state_count)
        self.eps = int(tok.epsilon)
        self.unknown = int(tok.unknown)
        self.identity = int(tok.identity)
        self.n_cells = len(tok.array)
        self.max_sym = self.n_cells // (self.S + 1) if self.S else 0
        self.tables = (np.asarray(tok.array, dtype=np.uint32),)

    def eps_avail(self, tables, t):
        (table,) = tables
        idx = (self.eps - 1) * self.S + t
        return jnp.take(table, idx, mode="fill", fill_value=0) != 0

    def transition(self, tables, t0, a):
        (table,) = tables
        a_ok = (a > 0) & (a <= self.max_sym)
        idx = (jnp.clip(a, 1, self.max_sym) - 1) * self.S + t0
        traw = jnp.take(table, idx, mode="fill", fill_value=0)
        traw = jnp.where(a_ok, traw, jnp.uint32(0))
        valid = traw != 0
        nontok = (traw & jnp.uint32(FIRSTBIT)) != 0
        t_next = (traw & jnp.uint32(RESTBIT | (1 << 30))).astype(I32)
        return valid, nontok, t_next


class DoubleArrayRep:
    """Base/check transition semantics (datok.go:876-901, 988-1063)."""

    def __init__(self, tok):
        self.S = 0
        self.eps = int(tok.epsilon)
        self.unknown = int(tok.unknown)
        self.identity = int(tok.identity)
        self.size = int(tok.check[1] & RESTBIT)
        self.n_cells = len(tok.base)
        self.tables = (
            np.asarray(tok.base, dtype=np.uint32),
            np.asarray(tok.check, dtype=np.uint32),
        )

    def eps_avail(self, tables, t):
        base, check = tables
        b0 = (jnp.take(base, t, mode="fill", fill_value=0) & jnp.uint32(RESTBIT)).astype(I32)
        tc = b0 + self.eps
        chk = (jnp.take(check, tc, mode="fill", fill_value=0) & jnp.uint32(RESTBIT)).astype(I32)
        return (tc < self.n_cells) & (chk == t)

    def transition(self, tables, t0, a):
        base, check = tables
        b0 = (jnp.take(base, t0, mode="fill", fill_value=0) & jnp.uint32(RESTBIT)).astype(I32)
        tc = b0 + a  # NOTE: no a==0 guard — bug-compatible with the reference
        in_rng = (tc >= 0) & (tc < self.n_cells)
        tc_c = jnp.clip(tc, 0, self.n_cells - 1)
        chk_raw = jnp.take(check, tc_c, mode="clip")
        chk_raw = jnp.where(in_rng, chk_raw, jnp.uint32(0))
        valid = (tc <= self.size) & in_rng & (
            (chk_raw & jnp.uint32(RESTBIT)).astype(I32) == t0
        )
        nontok = (chk_raw & jnp.uint32(FIRSTBIT)) != 0
        # separate-state hop to the representative (datok.go:1056-1063)
        b_t = jnp.take(base, tc_c, mode="clip")
        sep = (b_t & jnp.uint32(FIRSTBIT)) != 0
        t_next = jnp.where(sep, (b_t & jnp.uint32(RESTBIT)).astype(I32), tc)
        return valid, nontok, t_next


def make_rep(tok):
    return MatrixRep(tok) if tok.type() == "MATOK" else DoubleArrayRep(tok)


def _pack(kind, start, end):
    return kind | (start << 2) | (end << (2 + PACK_POS_BITS))


def _bsel(c, x, y):
    """``jnp.where`` for boolean-valued operands, as mask logic.

    ``x`` may be a Python bool constant.
    """
    if x is True:
        return c | y
    if x is False:
        return ~c & y
    return (c & x) | (~c & y)


def _tree_select(x, idx):
    """out[b] = x[b, idx[b]] via a log2 select tree (no gather).

    ``x``: (B, n) with n a power of two.
    """
    n = x.shape[1]
    assert (n & (n - 1)) == 0, "tree select needs a power-of-two width"
    k = n // 2
    while k >= 1:
        bit = (idx & k) != 0
        x = jnp.where(bit[:, None], x[:, k : 2 * k], x[:, :k])
        k //= 2
    return x[:, 0]


def _tree_select_shared(vec, idx):
    """out[b] = vec[idx[b]] for a shared (n,) vector (power-of-two n)."""
    n = vec.shape[0]
    assert (n & (n - 1)) == 0
    k = n // 2
    bit = (idx & k) != 0
    x = jnp.where(bit[:, None], vec[None, k : 2 * k], vec[None, :k])
    k //= 2
    while k >= 1:
        bit = (idx & k) != 0
        x = jnp.where(bit[:, None], x[:, k : 2 * k], x[:, :k])
        k //= 2
    return x[:, 0]


def _make_step(
    *,
    eps,
    unknown,
    identity,
    fetch_meta,
    probe_fn,
    fetch_trans,
    aux_update,
    eps1,
    hid1,
    lc1=False,
    enable_skip=False,
):
    """Build one masked step of the reference loop.

    ``fetch_meta(carry) -> (meta int32 (B,), can (B,) bool)``
    ``probe_fn(carry) -> (B,) bool`` — ε availability at carry["t"]
    ``fetch_trans(carry, t0, t0_hid, a) ->
        (can, valid, nontok, t_next, t_next_hid, eps_tgt, lc_tgt)``
    ``aux_update(carry) -> carry`` — refresh hot-id/ε registers (service)
    ``eps1``/``hid1``/``lc1`` — ε-availability, hot id and run-skip
    flag of the root state.  Events go to row ``carry["steps"]`` of
    the carried ``ys`` buffer.
    """

    def step(carry):
        t = carry["t"]
        t0 = carry["t0"]
        a = carry["a"]
        ok = carry["ok"]
        eot = carry["eot"]
        newchar = carry["newchar"]
        eps_s = carry["eps_s"]
        eps_o = carry["eps_o"]
        c = carry["c"]
        b = carry["b"]
        ft = carry["ft"]
        sflag = carry["sflag"]
        tflag = carry["tflag"]
        phase = carry["phase"]
        pend = carry["pend"]
        pend2 = carry["pend2"]
        ckpt = carry["ckpt"]
        nbt = carry["n_backtrack"]
        nfe = carry["n_force"]
        hid = carry["hid"]
        t0_hid = carry["t0_hid"]
        eps_s_hid = carry["eps_s_hid"]
        length = carry["length"]

        # Lanes with queued events drain one per step and do nothing else.
        m_drain = pend != 0
        running = (phase == 0) & ~m_drain
        m_new0 = running & newchar
        m_end = m_new0 & (c >= length)
        # chained segmentation: cut lanes stop cleanly before the
        # epilogue — their full machine state is handed to the next
        # segment instead of flushing (SURVEY.md §5 long-context)
        m_cut = m_end & carry["stop"]
        m_eof = m_end & ~carry["stop"]
        m_read0 = m_new0 & ~m_end
        m_old0 = running & ~newchar

        # ---- newchar: fetch symbol metadata -----------------------------
        meta_v, can_meta = fetch_meta(carry)
        a_new = meta_v & META_A_MASK
        found_new = (meta_v & META_FOUND) != 0
        nonascii_new = (meta_v & META_NONASCII) != 0
        eot_new = (meta_v & META_EOT) != 0

        # tentative read-phase registers feed the transition fetch
        a_t = jnp.where(m_read0, a_new, a)
        t0_t = jnp.where(m_read0, t, t0)
        t0_hid_t = jnp.where(m_read0, hid, t0_hid)

        can_tr, valid, nontok, t_succ, t_succ_hid, eps_tgt, lc_tgt = (
            fetch_trans(carry, t0_t, t0_hid_t, a_t)
        )

        # run skipping: a lowercase-absorbing state consumes the whole
        # [a-z] run in one step (each skipped char would take the same
        # self-arc and probe the same ε bit; ASCII chars leave the
        # stale-ok flag untouched; the leading-char drop only applies
        # to the first pending char, which is excluded)
        rl = (meta_v >> META_RUN_SHIFT) & META_RUN_MASK
        if enable_skip:
            m_skip = (
                m_read0
                & can_meta
                & carry["lc_t"]
                & (rl >= 2)
                & ((c - b) - ft >= 1)
            )
        else:
            m_skip = jnp.zeros_like(m_read0)

        # stall: lane cannot proceed this step (hot machine only);
        # read phase is idempotent, so re-running it later is safe.
        cold_stall = ((m_read0 & ~m_skip) | m_old0) & ~can_tr
        stall = (m_read0 & ~can_meta) | cold_stall
        m_read = m_read0 & ~stall
        m_old = m_old0 & ~stall

        # commit read-phase registers
        # stale-ok: only the non-ASCII path reassigns ok (matrix.go:426-434)
        ok = _bsel(m_read, _bsel(nonascii_new, found_new, ok), ok)
        a = jnp.where(m_read, a_new, a)
        eot = _bsel(m_read, eot_new, eot)
        t0 = jnp.where(m_read, t, t0)
        t0_hid = jnp.where(m_read, hid, t0_hid)

        # ε availability probe / epilogue chase share one predicate on t
        eps_here = probe_fn(carry)
        probe = m_read & eps_here
        eps_s = jnp.where(probe, t, eps_s)
        eps_s_hid = jnp.where(probe, hid, eps_s_hid)
        # a skipped run probes at every char; the final register holds
        # the last run position
        eps_o = jnp.where(probe, jnp.where(m_skip, c + rl - 1, c), eps_o)

        # ---- transition outcome -----------------------------------------
        m_trans = (m_read & ~m_skip) | m_old
        m_fail = m_trans & ~valid
        f1 = m_fail & ~ok & (a == identity)
        f2 = m_fail & ~f1 & (a != eps) & (eps_s != 0)
        f3 = m_fail & ~f1 & ~f2

        m_succ = m_trans & valid
        is_eps = a == eps
        has_pending = (c - b) > ft
        flush = m_succ & is_eps & has_pending
        sent = m_succ & is_eps & ~has_pending
        cons = m_succ & ~is_eps

        c_cons = jnp.where(cons, c + 1, c)
        f3_bump = f3 & ((c - b) - ft <= 0)
        c_f3 = jnp.where(f3_bump, c + 1, c)

        # leading nontoken drop (matrix.go:579-591)
        lead = cons & ((c_cons - b) - ft == 1) & nontok
        ft_cons = jnp.where(lead, ft + 1, ft)

        # EOT handling after the consume/eps branch (matrix.go:593-605)
        sflag1 = _bsel(flush, False, _bsel(sent, True, sflag))
        tflag1 = _bsel(flush, False, tflag)
        e_m = m_succ & eot
        sent2 = e_m & ~sflag1
        sflag2 = sflag1 | sent2
        tflag2 = _bsel(e_m, True, tflag1)
        rewind = flush | e_m

        # ---- epilogue entry (EOF break, matrix.go:637-697) ---------------
        echase = m_eof & eps_here
        ebt = m_eof & ~eps_here & (eps_s != 0)
        efin = m_eof & ~eps_here & (eps_s == 0)
        resid = efin & has_pending
        sflag_e = _bsel(resid, False, sflag)
        tflag_e = _bsel(resid, False, tflag)
        efin_sent = efin & ~sflag_e
        efin_text = efin & ~tflag_e

        # ---- event emission (candidates are always ordered T, S, X) ------
        w_tok = flush | f3 | resid
        w_sent = sent | sent2 | efin_sent
        w_text = e_m | efin_text
        tok_start = b + ft
        tok_end = jnp.where(f3, c_f3, c)
        sent_pos = jnp.where(sent2, c_cons, c)
        text_pos = jnp.where(e_m, c_cons, c)

        v_tok = _pack(EV_TOKEN, tok_start, tok_end)
        v_sent = _pack(EV_SENT, sent_pos, sent_pos)
        v_text = _pack(EV_TEXT, text_pos, text_pos)

        first = jnp.where(
            w_tok, v_tok, jnp.where(w_sent, v_sent, jnp.where(w_text, v_text, 0))
        )
        second = jnp.where(
            w_tok & w_sent, v_sent, jnp.where((w_tok | w_sent) & w_text, v_text, 0)
        )
        third = jnp.where(w_tok & w_sent & w_text, v_text, 0)

        act = running & ~stall
        emit = jnp.where(m_drain, pend, jnp.where(act, first, 0))
        pend_new = jnp.where(m_drain, pend2, jnp.where(act, second, pend))
        pend2_new = jnp.where(m_drain, 0, jnp.where(act, third, pend2))

        # ---- merge state updates (paths are disjoint) ---------------------
        # NB: f2/ebt read the post-probe backtrack register, like the
        # reference (probe and failing transition share an iteration,
        # matrix.go:442-497).
        bt_state = eps_s
        bt_hid = eps_s_hid
        bt_off = eps_o

        t_new = jnp.where(f3, 1, jnp.where(m_succ, t_succ, t))
        hid_new = jnp.where(f3, hid1, jnp.where(m_succ, t_succ_hid, hid))
        eps_t_new = _bsel(f3, eps1, _bsel(m_succ, eps_tgt, carry["eps_t"]))
        lc_new = _bsel(f3, lc1, _bsel(m_succ, lc_tgt, carry["lc_t"]))
        t0_new = jnp.where(f2 | ebt, bt_state, jnp.where(echase, t, t0))
        t0_hid_new = jnp.where(f2 | ebt, bt_hid, jnp.where(echase, hid, t0_hid))
        a_new2 = jnp.where(f1, unknown, jnp.where(f2 | f3 | echase | ebt, eps, a))
        c_new = jnp.where(
            m_skip,
            c + rl,
            jnp.where(
                f2 | ebt, bt_off, jnp.where(f3, c_f3, jnp.where(m_succ, c_cons, c))
            ),
        )
        b_new = jnp.where(f3, c_f3, jnp.where(m_succ & rewind, c_cons, b))
        ft_new = jnp.where(f3 | (m_succ & rewind), 0, jnp.where(cons, ft_cons, ft))
        eps_s_new = jnp.where(f2 | f3 | ebt | (m_succ & rewind), 0, eps_s)
        eps_s_hid_new = jnp.where(
            f2 | f3 | ebt | (m_succ & rewind), -1, eps_s_hid
        )
        eps_o_new = jnp.where(m_succ & rewind, 0, eps_o)
        newchar_new = _bsel(f1 | f2 | echase | ebt, False, _bsel(f3 | m_succ, True, newchar))
        eot_new2 = _bsel(f1 | f2 | m_succ, False, eot)
        sflag_new = _bsel(f3, False, _bsel(m_succ, sflag2, sflag))
        tflag_new = _bsel(f3, False, _bsel(m_succ, tflag2, tflag))
        phase_new = jnp.where(efin | m_cut, 1, phase)
        # checkpoint the machine context at rewinds: the buffer base b
        # restarts here with zeroed registers, so a later segment can
        # resume exactly by re-reading text from b in this context
        ckpt_new = jnp.where(
            f3 | (m_succ & rewind),
            t_new
            | (sflag_new.astype(I32) << 28)
            | (tflag_new.astype(I32) << 29)
            | (ok.astype(I32) << 30),
            ckpt,
        )

        out = dict(carry)
        out["ys"] = jax.lax.dynamic_update_slice(
            carry["ys"], emit.astype(I32)[None, :], (carry["steps"], 0)
        )
        out.update(
            t=t_new,
            t0=t0_new,
            a=a_new2,
            ok=ok,
            eot=eot_new2,
            newchar=newchar_new,
            eps_s=eps_s_new,
            eps_o=eps_o_new,
            c=c_new,
            b=b_new,
            ft=ft_new,
            sflag=sflag_new,
            tflag=tflag_new,
            phase=phase_new,
            pend=pend_new,
            pend2=pend2_new,
            ckpt=ckpt_new,
            hid=hid_new,
            t0_hid=t0_hid_new,
            lc_t=lc_new,
            eps_s_hid=eps_s_hid_new,
            eps_t=eps_t_new,
            steps=carry["steps"] + 1,
        )
        out["stalls"] = jnp.sum(stall.astype(I32))
        out["cold"] = jnp.sum(cold_stall.astype(I32))
        out["n_backtrack"] = nbt + f2.astype(I32)
        out["n_force"] = nfe + f3.astype(I32)
        return aux_update(out) if aux_update is not None else out

    return step


# ---------------------------------------------------------------------------
# General machine: gather fetches (any representation)
# ---------------------------------------------------------------------------


def _general_fetches(rep, tables, meta):
    L = meta.shape[1]

    def fetch_meta(carry):
        cc = jnp.clip(carry["c"], 0, L - 1)
        m = jnp.take_along_axis(meta, cc[:, None], axis=1)[:, 0]
        return m, jnp.ones_like(carry["phase"], bool)

    def probe_fn(carry):
        return rep.eps_avail(tables, carry["t"])

    def fetch_trans(carry, t0, t0_hid, a):
        valid, nontok, t_next = rep.transition(tables, t0, a)
        can = jnp.ones_like(valid)
        false = jnp.zeros_like(valid)
        return can, valid, nontok, t_next, jnp.full_like(t_next, -1), false, false

    return fetch_meta, probe_fn, fetch_trans


def _init_carry(B, max_steps, length, eps1, hid1, ctx_init=None, hid_init=None,
                epst_init=None, lc_init=None, stop_flags=None):
    zeros = jnp.zeros(B, I32)
    fb = jnp.zeros(B, bool)
    if ctx_init is None:
        ctx_init = jnp.ones(B, I32)
    if stop_flags is None:
        stop_flags = fb
    # packed entry context: t | sflag<<28 | tflag<<29 | ok<<30 (1 = root)
    t_init = ctx_init & 0x0FFFFFFF
    sflag_init = ((ctx_init >> 28) & 1) != 0
    tflag_init = ((ctx_init >> 29) & 1) != 0
    ok_init = ((ctx_init >> 30) & 1) != 0
    if hid_init is None:
        hid_init = jnp.full(B, hid1, I32)
    if epst_init is None:
        epst_init = jnp.full(B, eps1, bool)
    if lc_init is None:
        lc_init = fb
    return {
        "t": t_init,
        "t0": t_init,
        "a": zeros,
        "ok": ok_init,
        "eot": fb,
        "newchar": jnp.ones(B, bool),
        "eps_s": zeros,
        "eps_o": zeros,
        "c": zeros,
        "b": zeros,
        "ft": zeros,
        "sflag": sflag_init,
        "tflag": tflag_init,
        "phase": zeros,
        "pend": zeros,
        "pend2": zeros,
        "hid": hid_init,
        "t0_hid": hid_init,
        "eps_s_hid": jnp.full(B, -1, I32),
        "eps_t": epst_init,
        "lc_t": lc_init,
        "ys": jnp.zeros((max_steps, B), I32),
        "steps": jnp.int32(0),
        "stalls": jnp.int32(0),
        "cold": jnp.int32(0),
        "sref": jnp.int32(0),
        "need_srv": jnp.array(False),
        "since": jnp.int32(0),
        "length": length,
        "stop": stop_flags,
        "ckpt": ctx_init,
        "n_backtrack": zeros,
        "n_force": zeros,
    }


def _finish(out):
    bad = (out["phase"] == 0) | (out["pend"] != 0)
    ctx = (
        out["t"]
        | (out["sflag"].astype(I32) << 28)
        | (out["tflag"].astype(I32) << 29)
        | (out["ok"].astype(I32) << 30)
    )
    state = jnp.stack(
        [ctx, out["ckpt"], out["b"], out["c"], out["n_backtrack"], out["n_force"]],
        axis=-1,
    )
    return out["ys"], bad, out["steps"], state


@functools.partial(
    jax.jit, static_argnames=("eps", "unknown", "identity", "rep", "max_steps")
)
def _run_machine(tables, meta, length, ctx_init, stop_flags=None,
                 *, eps, unknown, identity, rep, max_steps):
    """General machine: run until all lanes finish (or step budget)."""
    B, L = meta.shape
    fm, pf, ft_ = _general_fetches(rep, tables, meta)
    step = _make_step(
        eps=eps,
        unknown=unknown,
        identity=identity,
        fetch_meta=fm,
        probe_fn=pf,
        fetch_trans=ft_,
        aux_update=None,
        eps1=False,
        hid1=-1,
    )

    def cond(carry):
        return (carry["steps"] < max_steps) & jnp.any(
            (carry["phase"] == 0) | (carry["pend"] != 0)
        )

    out = jax.lax.while_loop(
        cond,
        step,
        _init_carry(
            B, max_steps, length, False, -1, ctx_init=ctx_init,
            stop_flags=stop_flags,
        ),
    )
    return _finish(out)


# ---------------------------------------------------------------------------
# Hot machine: one-hot product transitions over a profiled hot state set
# ---------------------------------------------------------------------------


def _tok_static(tok):
    """Hot-set-independent precomputations, cached on the tokenizer."""
    st = getattr(tok, "_hotspec_static", None)
    if st is not None:
        return st
    rep = MatrixRep(tok)
    S, A = rep.S, rep.max_sym
    arr = np.asarray(tok.array, dtype=np.uint32)
    eps = rep.eps

    # ε availability per state (probe semantics, matrix.go:442)
    states = np.arange(S + 1, dtype=np.int64)
    eps_cells = arr[(eps - 1) * S + states]
    eps_avail = eps_cells != 0
    eps_avail[0] = False
    eps_avail = eps_avail.astype(np.uint8)

    # letter-absorbing states: self-loop (no nontoken flag) on every
    # letter of an adaptively chosen skip class — these consume
    # whole letter runs in one step (semantically exact: each
    # skipped char would probe the same ε bit and take the same
    # self-arc).  The class starts as ASCII [a-z] and greedily
    # drops letters that break many otherwise-absorbing states
    # (a grammar may route one letter, e.g. a genitive 's', through
    # its own machinery, so the word-interior state loops on every
    # letter but that one).
    letters = [cp for cp in range(ord("a"), ord("z") + 1) if cp in tok.sigma]
    lc_avail = np.zeros(S + 1, dtype=np.uint8)
    lc_mask = np.zeros(128, dtype=bool)
    if letters:
        syms = np.array([tok.sigma[cp] for cp in letters], dtype=np.int64)
        cells_lc = arr[((syms[:, None] - 1) * S + states[None, :])]
        ok_lc = (
            (cells_lc != 0)
            & ((cells_lc & ~np.uint32(FIRSTBIT)) == states[None, :])
            & ((cells_lc >> 31) == 0)
        )  # (len(letters), S+1)
        counts = ok_lc.sum(axis=0)
        cand = counts >= max(1, int(len(letters) * 0.75))  # absorbing-ish
        keep = np.ones(len(letters), dtype=bool)
        for _ in range(6):  # drop at most a few run-splitting letters
            flagged = ok_lc[keep].all(axis=0) & cand
            best_gain, best_i = 0, -1
            for i in np.flatnonzero(keep):
                k2 = keep.copy()
                k2[i] = False
                gain = int((ok_lc[k2].all(axis=0) & cand).sum()) - int(
                    flagged.sum()
                )
                if gain > best_gain:
                    best_gain, best_i = gain, i
            if best_i < 0 or best_gain < max(4, int(cand.sum() * 0.1)):
                break
            keep[best_i] = False
        lc_avail = (ok_lc[keep].all(axis=0)).astype(np.uint8)
        lc_avail[0] = 0
        for i in np.flatnonzero(keep):
            lc_mask[letters[i]] = True

    st = dict(
        rep=rep, S=S, A=A, arr=arr, eps=eps,
        eps_avail=eps_avail, lc_avail=lc_avail, lc_mask=lc_mask,
    )
    tok._hotspec_static = st
    return st


class HotSpec:
    """Precomputed hot-set tables for the matrix representation.

    Passed to the jitted hot machine as a static argument: every scalar
    the tracer bakes in (H, A_pad, state-1 properties) is in
    :attr:`sig`, and every array flows through ``device_tables()``.
    """

    def __init__(self, tok, hot_states: np.ndarray):
        st = _tok_static(tok)
        S, A = st["S"], st["A"]
        arr = st["arr"]
        eps_avail = st["eps_avail"].astype(bool)
        lc_avail = st["lc_avail"]

        hot_states = np.asarray(hot_states, dtype=np.int64)
        # state 1 rides slot 0 (hid1=0)
        hot_states = np.concatenate([[1], hot_states[hot_states != 1]])
        H = len(hot_states)
        self.H = H
        self.A_pad = ((A + 1 + 127) // 128) * 128

        hot_index = np.full(S + 1, -1, dtype=np.int32)
        hot_index[hot_states] = np.arange(H, dtype=np.int32)
        self.hot_index = hot_index
        self.hot_full = hot_states.astype(np.int32)
        self.hid1 = int(hot_index[1])

        self.eps_avail = st["eps_avail"]
        self.eps1 = bool(eps_avail[1])
        self.lc_mask = st["lc_mask"]
        self.lc_avail = lc_avail
        self.lc1 = bool(lc_avail[1])

        # hot entries: (A_pad, H) packed 24-bit values
        aa = np.arange(1, A + 1, dtype=np.int64)
        cells = arr[((aa[:, None] - 1) * S + hot_states[None, :])]  # (A, H)
        tgt = (cells & ~np.uint32(FIRSTBIT)).astype(np.int64)
        nt = (cells >> 31).astype(np.int64)
        valid = cells != 0
        tgt_hid = hot_index[tgt]
        is_hot = tgt_hid >= 0
        payload = np.where(is_hot, tgt_hid, tgt)
        entry = np.where(
            valid,
            _HE_VALID
            | np.where(is_hot, _HE_HOT, 0)
            | nt * _HE_NONTOK
            | eps_avail[tgt] * _HE_EPS
            | lc_avail[tgt].astype(np.int64) * _HE_LC
            | (payload << 5),
            0,
        ).astype(np.int64)
        full = np.zeros((self.A_pad, H), dtype=np.int64)
        full[1 : A + 1, :] = entry
        self.planes = np.concatenate(
            [(full & 0xFF), (full >> 8) & 0xFF, (full >> 16) & 0xFF], axis=1
        ).astype(np.float32)  # (A_pad, 3H), bf16-exact byte values

        self.sig = (self.H, self.A_pad, self.hid1, self.eps1, self.lc1)

    def __hash__(self):
        return hash(self.sig)

    def __eq__(self, other):
        return isinstance(other, HotSpec) and self.sig == other.sig

    def device_tables(self):
        # hot_full padded to a power of two for the select tree
        p2 = 1
        while p2 < max(2, self.H):
            p2 *= 2
        hf = np.zeros(p2, dtype=np.int32)
        hf[: self.H] = self.hot_full
        return (
            jnp.asarray(self.planes, dtype=jnp.bfloat16),
            jnp.asarray(hf),
            jnp.asarray(self.hot_index),
            jnp.asarray(self.eps_avail),
            jnp.asarray(self.lc_avail),
        )


def _hot_fetches(spec: HotSpec, hot_tables):
    planes, hot_full_p2, _hot_index, _eps_avail, _lc_avail = hot_tables
    H = spec.H
    A_pad = spec.A_pad
    P2 = hot_full_p2.shape[0]
    iota_A = jnp.arange(A_pad, dtype=I32)
    iota_H = jnp.arange(H, dtype=I32)

    def fetch_meta(carry):
        w = carry["w"]
        ring = carry["ring"]  # (B, RING)
        off = carry["c"] - w
        can = (off >= 0) & (off < RING)
        v = _tree_select(ring, jnp.clip(off, 0, RING - 1))
        return v, can

    def probe_fn(carry):
        return carry["eps_t"]

    def fetch_trans(carry, t0, t0_hid, a):
        oh = ((a[:, None] == iota_A[None, :]) & (a > 0)[:, None]).astype(jnp.bfloat16)
        rows = jnp.dot(oh, planes, preferred_element_type=jnp.float32)  # (B, 3H)
        # rows is loop-variant (fresh matmul output), so this mask-reduce
        # stays vectorized — only invariant operands get gather-matched.
        msel = iota_H[None, :] == t0_hid[:, None]
        lo = jnp.sum(jnp.where(msel, rows[:, :H], 0.0), axis=1).astype(I32)
        mid = jnp.sum(jnp.where(msel, rows[:, H : 2 * H], 0.0), axis=1).astype(I32)
        hi = jnp.sum(jnp.where(msel, rows[:, 2 * H :], 0.0), axis=1).astype(I32)
        entry = lo | (mid << 8) | (hi << 16)
        valid = (entry & _HE_VALID) != 0
        hot_t = (entry & _HE_HOT) != 0
        nontok = (entry & _HE_NONTOK) != 0
        eps_tgt = (entry & _HE_EPS) != 0
        lc_tgt = (entry & _HE_LC) != 0
        payload = entry >> 5
        full_hot = _tree_select_shared(hot_full_p2, jnp.clip(payload, 0, P2 - 1))
        t_next = jnp.where(hot_t, full_hot, payload)
        t_next_hid = jnp.where(hot_t, payload, -1)
        can = t0_hid >= 0
        return can, valid, nontok, t_next, t_next_hid, eps_tgt, lc_tgt

    return fetch_meta, probe_fn, fetch_trans


@functools.partial(
    jax.jit,
    static_argnames=(
        "eps",
        "unknown",
        "identity",
        "rep",
        "spec",
        "max_steps",
        "service_k",
    ),
)
def _run_machine_hot(
    tables,
    hot_tables,
    meta,
    length,
    ctx_init,
    hid_init,
    epst_init,
    lc_init,
    stop_flags=None,
    *,
    eps,
    unknown,
    identity,
    rep,
    spec,
    max_steps,
    service_k,
):
    """Hot machine: one-hot product steps + periodic general service steps."""
    B, L = meta.shape
    planes, hot_full, hot_index, eps_avail, lc_avail = hot_tables

    fm_g, _pf_g, ft_g = _general_fetches(rep, tables, meta)
    fm_h, pf_h, ft_h = _hot_fetches(spec, hot_tables)

    # Combined auxiliary per-state map: (hot_index + 1) | eps_avail << 20
    # | lc_avail << 21 — one take refreshes the hot registers in
    # the service step.
    aux_map = (
        (hot_index.astype(jnp.int32) + 1)
        | (eps_avail.astype(jnp.int32) << 20)
        | (lc_avail.astype(jnp.int32) << 21)
    )

    def aux(carry):
        out = dict(carry)
        v = jnp.take(aux_map, jnp.clip(carry["t"], 0, aux_map.shape[0] - 1))
        out["hid"] = (v & 0xFFFFF) - 1
        out["eps_t"] = ((v >> 20) & 1) != 0
        out["lc_t"] = ((v >> 21) & 1) != 0
        out["since"] = jnp.int32(0)
        return out

    # The service step uses the carried ε register as its probe too —
    # the invariant eps_t == eps_avail[t] holds at every step entry
    # (hot steps carry it from entries; aux refreshes it after service).
    step_general = _make_step(
        eps=eps,
        unknown=unknown,
        identity=identity,
        fetch_meta=fm_g,
        probe_fn=pf_h,
        fetch_trans=ft_g,
        aux_update=aux,
        eps1=spec.eps1,
        hid1=spec.hid1,
        lc1=spec.lc1,
    )

    def hot_aux(carry):
        out = dict(carry)
        out["since"] = carry["since"] + 1
        out["sref"] = carry["sref"] + 1
        return out

    step_hot = _make_step(
        eps=eps,
        unknown=unknown,
        identity=identity,
        fetch_meta=fm_h,
        probe_fn=pf_h,
        fetch_trans=ft_h,
        aux_update=hot_aux,
        eps1=spec.eps1,
        hid1=spec.hid1,
        lc1=spec.lc1,
        enable_skip=True,
    )

    def live_mask(carry):
        return (carry["phase"] == 0) | (carry["pend"] != 0)

    def refresh_ring(carry):
        # window follows the slowest live lane
        live = live_mask(carry)
        c_live = jnp.where(live, carry["c"], jnp.int32(1 << 28))
        w_new = jnp.clip(jnp.min(c_live), 0, max(0, L - RING))
        out = dict(carry)
        out["w"] = w_new
        out["ring"] = jax.lax.dynamic_slice(meta, (0, w_new), (B, RING))
        out["sref"] = jnp.int32(0)
        # stale stall counts would keep the inner loop from re-entering
        out["stalls"] = jnp.int32(0)
        return out

    # Nested while loops keep the service step a real branch (a
    # lax.cond inside a while body may lower to both-branches-plus-
    # select): the inner loop runs pure hot steps until the ring window
    # goes stale or lanes stall; the outer loop refreshes the window
    # and runs one exact general (gather) service step ONLY when cold
    # lanes need it (or the heartbeat fires) — expressed as a
    # single-iteration while_loop.
    def inner_cond(carry):
        live = jnp.any(live_mask(carry))
        n_live = jnp.sum(live_mask(carry).astype(I32))
        # Stall exit relative to *live* lanes: stalled lanes idle until
        # the next service, so in sparse batches (few live lanes, e.g.
        # the long-document pipeline) waiting for `stalls == n_live`
        # lets each cold character cost a stalled lane up to a full
        # round of idle steps and blows the step budget.  A quarter of
        # the live lanes stalled triggers the service step (untuned on
        # the current hardware); full blocks keep the absolute B/8 bound
        # (it binds first there, preserving big-batch behavior).
        ok_stalls = (carry["stalls"] * 8 <= B) & (
            carry["stalls"] * 4 < n_live
        )
        return (
            (carry["steps"] < max_steps)
            & live
            & (carry["sref"] < RING // 2)
            & (carry["since"] < service_k)
            & ok_stalls
        )

    def service_cond(carry):
        return carry["need_srv"]

    def service_body(carry):
        out = step_general(carry)
        out["need_srv"] = jnp.array(False)
        return out

    def outer_body(carry):
        carry = refresh_ring(carry)
        carry = jax.lax.while_loop(inner_cond, step_hot, carry)
        need = jnp.any(live_mask(carry)) & (
            (carry["cold"] > 0) | (carry["since"] >= service_k)
        )
        carry["need_srv"] = need
        return jax.lax.while_loop(service_cond, service_body, carry)

    def outer_cond(carry):
        return (carry["steps"] < max_steps) & jnp.any(live_mask(carry))

    init = _init_carry(
        B, max_steps, length, spec.eps1, spec.hid1,
        ctx_init=ctx_init, hid_init=hid_init, epst_init=epst_init,
        lc_init=lc_init, stop_flags=stop_flags,
    )
    init["w"] = jnp.int32(0)
    init["ring"] = jnp.zeros((B, RING), I32)
    init["since"] = jnp.int32(0)
    out = jax.lax.while_loop(outer_cond, outer_body, init)
    return _finish(out)


# ---------------------------------------------------------------------------
# Host-side decode + engine classes
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=(1,))
def _compact_ys(ys, S):
    """Device-side event compaction: (max_steps, B) → (B, S) dense.

    The step-indexed event buffer is mostly zeros (one slot per machine
    step, ~0.3 events/char emitted); a stable sort per lane moves the
    events to the front *in step order*, so only ``counts.max()`` rows
    ever cross the device→host link (SURVEY.md §7.3 item 5:
    variable-length output from fixed-shape compute).
    """
    sub = ys[:S]
    key = (sub == 0).astype(jnp.int32)  # events first, zeros last
    _, srt = jax.lax.sort((key, sub), dimension=0, is_stable=True,
                          num_keys=1)
    counts = (sub != 0).sum(axis=0, dtype=jnp.int32)
    return jnp.transpose(srt), counts


def decode_events_flat(ev, counts):
    """Decode compacted (B, E) event rows to ONE flat (N, 3) array.

    Lane i's events are the ``counts[i]`` consecutive triples starting
    at ``counts[:i].sum()`` — the zero-copy wave layout the native
    writer replays in a single call (``dt_writer_feed_wave``).  Rides
    the threaded native decoder when available (parity pinned by
    tests); the numpy path below is the fallback and oracle."""
    ev = np.asarray(ev)
    counts = np.asarray(counts)
    try:
        from ..utils.native import native_decode_events

        tri = native_decode_events(ev, counts)
        if tri is not None:
            return tri, counts
    except ImportError:
        pass
    E = ev.shape[1]
    mask = np.arange(E, dtype=np.int32)[None, :] < counts[:, None]
    flat = ev[mask].astype(np.uint32)  # row-major → per-lane step order
    tri = np.empty((len(flat), 3), dtype=np.int32)
    tri[:, 0] = flat & 3
    tri[:, 1] = (flat >> 2) & PACK_POS_MASK
    tri[:, 2] = (flat >> (2 + PACK_POS_BITS)) & PACK_POS_MASK
    return tri, counts


def decode_events_compact(ev, counts, as_arrays: bool = False) -> List:
    """Decode compacted (B, E) event rows (see ``_compact_ys``)."""
    tri, counts = decode_events_flat(ev, counts)
    out = []
    off = 0
    if as_arrays:
        for n in counts.tolist():
            out.append(tri[off : off + n])
            off += n
        return out
    trl = [tuple(r) for r in tri.tolist()]
    for n in counts.tolist():
        out.append(trl[off : off + n])
        off += n
    return out


def decode_events_batch(
    ys: np.ndarray, n_steps: int, as_arrays: bool = False
) -> List:
    """Vectorized decode of all lanes' packed event streams.

    ``as_arrays=True`` returns per-lane (N, 3) int32 arrays instead of
    tuple lists — the zero-copy shape the native C++ writer feeds at
    hundreds of MB/s (list-of-tuples conversion alone caps the host
    formatting path at ~5 MB/s)."""
    sub = ys[:n_steps].T  # (B, steps) — row-major per lane, step order
    mask = sub != 0
    counts = mask.sum(axis=1)
    flat = sub[mask].astype(np.uint32)
    if as_arrays:
        tri = np.empty((len(flat), 3), dtype=np.int32)
        tri[:, 0] = flat & 3
        tri[:, 1] = (flat >> 2) & PACK_POS_MASK
        tri[:, 2] = (flat >> (2 + PACK_POS_BITS)) & PACK_POS_MASK
        out = []
        off = 0
        for n in counts.tolist():
            out.append(tri[off : off + n])
            off += n
        return out
    kinds = (flat & 3).astype(int)
    starts = ((flat >> 2) & PACK_POS_MASK).astype(int)
    ends = ((flat >> (2 + PACK_POS_BITS)) & PACK_POS_MASK).astype(int)
    triples = list(zip(kinds.tolist(), starts.tolist(), ends.tolist()))
    out = []
    off = 0
    for n in counts.tolist():
        out.append(triples[off : off + n])
        off += n
    return out


# Small built-in calibration sample for hot-state profiling (mixed
# German/English with URLs, abbreviations, numbers, EOT, punctuation).
_CALIBRATION = (
    "Der Vorsitzende der Abk. hat z.B. gewählt und bzw. verlor. "
    'Sie sagte: "Es geht mir gut!", daraufhin ging sie zur Weststr. 3. '
    "Gefunden auf https://korap.ids-mannheim.de/?q=Baum und www.wikipedia.org. "
    "Ich bin unter korap@ids-mannheim.de erreichbar, auch am 5.9.2018 um 14:30 Uhr. "
    "Die Preise lagen bei 3,50 Euro bzw. 50.4% — toll!!! Oder etwa nicht??? "
    "Don't they're we'll it's I'm isn't a test? Mr. Smith paid $4.50 on Jan. 3rd. "
    "Dieses verf***** Kleid kostet 3,5 Mio. Euro ... D'dorf Ku'damm M'gladbach.\x04\n"
    "Emoticons ;) :-) T__T und Emojis 😀 sowie Pfeile → und <b>XML</b> &quot; "
    "eine readme.txt zum Herunterladen via ftp://files.example.org/pub/a.zip. "
    "Kupietz und Schmidt (2018): Korpuslinguistik. [2018] war super, oder?\x04"
)


# English-centric calibration twin of _CALIBRATION: clitics, months,
# ordinals, honorifics.
_CALIBRATION_EN = (
    "Don't you think they're ready? We'll've seen it by Jan. 3rd, won't we. "
    "I'm sure it's Mr. Smith's car — he can't park there, shan't he move it? "
    "She'd said: \"You mustn't worry\", but we weren't worried at all. "
    "Prof. Jones et al. published on Feb. 29, 2016 at www.example.com. "
    "The U.S.A. isn't the U.K.; approx. 50.4% agreed vs. 23% who didn't.\x04\n"
    "Visit https://en.wikipedia.org/wiki/Token or mail info@example.org asap. "
    "Cats, dogs etc. cost $4.50 apiece in Oct. — that's a lot, isn't it?\x04"
)


def default_profile_texts(tok) -> List[str]:
    """Calibration corpus for hot-state profiling: the built-in samples
    plus the conformance scenarios (extracted from the reference's test
    suite).  Callers that know their traffic pass ``profile_texts``
    instead — a sample of it covers the grammar's word-list machinery
    (abbreviation and URL tries) that these samples miss."""
    import json
    import os

    texts = [_CALIBRATION]
    root = os.path.join(os.path.dirname(__file__), "..", "..")
    scen = os.path.join(root, "conformance", "scenarios.json")
    try:
        with open(scen, encoding="utf-8") as fh:
            data = json.load(fh)
        texts.extend(
            s["input"] for s in data if isinstance(s.get("input"), str)
        )
    except OSError:
        pass
    texts.append(_CALIBRATION_EN)
    return texts


def profile_hot_states(tok, texts: Sequence[str], limit) -> np.ndarray:
    """Rank states by transition-time occupancy over sample texts.

    ``limit`` may be an int or ``"auto"``: auto sizes the hot set to
    cover ≥98.5% of profiled transitions, rounded up to a multiple of
    128 within [384, 640].  These bounds were tuned on other hardware
    and are untuned on the current one.
    """
    from .oracle import transduce_events

    counter = {}
    for text in texts:
        transduce_events(tok, text, state_counter=counter)
    ranked = [s for s, _ in sorted(counter.items(), key=lambda kv: -kv[1])]
    if limit == "auto":
        total = sum(counter.values()) or 1
        cum = 0
        need = len(ranked)
        for i, st in enumerate(ranked):
            cum += counter[st]
            if cum >= 0.985 * total:
                need = i + 1
                break
        limit = max(384, min(640, ((need + 127) // 128) * 128))
    hot = [1] + [s for s in ranked if s != 1]
    if len(hot) < limit:
        # structural fill: breadth-first from the root
        arr = np.asarray(tok.array, dtype=np.uint32).reshape(-1)
        S = tok.state_count
        seen = set(hot)
        queue = list(hot)
        qi = 0
        A = len(arr) // (S + 1)
        while qi < len(queue) and len(hot) < limit:
            s = queue[qi]
            qi += 1
            cells = arr[np.arange(A) * S + s]
            for cell in cells[cells != 0]:
                tgt = int(cell & ~np.uint32(FIRSTBIT))
                if tgt and tgt not in seen:
                    seen.add(tgt)
                    hot.append(tgt)
                    queue.append(tgt)
                    if len(hot) >= limit:
                        break
    return np.array(hot[:limit], dtype=np.int64)


# The machine ``engine="auto"`` runs, on every backend: the general
# machine.  On one wave of generated DE-size text (B=32,768 lanes ×
# L=1,024 chars, synth_de18k) on an NVIDIA H100 (700 W limit) it took
# 58 ms against the hot machine's 199 ms (44 µs against 176 µs per
# step); the hot machine's one-hot product and mask-reduce alone cost
# ~133 µs per hot step there.  See PERF.md and ROADMAP S2/S3.
AUTO_ENGINE = "general"


class BatchEngine:
    """Host-facing batched tokenization engine.

    ``engine`` selects the device machine:
      - ``"general"``: gather machine (any representation);
      - ``"hot"``: one-hot product hot machine with periodic service
        steps (matrix representation);
      - ``"auto"`` (default): :data:`AUTO_ENGINE`; double-array models
        are converted to the dense matrix first.

    ``accelerated=False`` is a legacy alias for ``engine="general"``.
    """

    def __init__(
        self,
        tok,
        steps_factor: float = 2.0,
        accelerated: Optional[bool] = None,
        hot_size="auto",
        service_k: int = 128,
        profile_texts: Optional[Sequence[str]] = None,
        engine: str = "auto",
    ):
        if accelerated is False:
            engine = "general"
        if engine not in ("auto", "general", "hot"):
            raise ValueError(f"unknown engine {engine!r}")
        if tok.type() == "DATOK" and engine in ("auto", "hot"):
            # the dense layout is runtime-equivalent (transduce parity
            # pinned by tests) and fetches a transition in one gather
            try:
                tok = tok.to_matrix()
            except Exception as e:
                # an explicitly requested hot machine must not silently
                # downgrade to the general machine
                if engine == "hot":
                    raise RuntimeError(
                        f"engine={engine!r} requires the dense matrix "
                        f"layout but to_matrix() failed: {e}"
                    ) from e
                import warnings

                warnings.warn(
                    f"double-array → matrix conversion failed ({e}); "
                    "falling back to the general engine",
                    RuntimeWarning,
                    stacklevel=2,
                )
        self.tok = tok
        self.rep = make_rep(tok)
        self.steps_factor = steps_factor
        self.tables = tuple(jnp.asarray(t) for t in self.rep.tables)
        if engine == "auto":
            engine = AUTO_ENGINE
        if tok.type() != "MATOK":
            engine = "general"
        self.service_k = service_k
        self.engine = engine
        self.accelerated = engine == "hot"
        if self.accelerated:
            hot = profile_hot_states(
                tok, profile_texts or default_profile_texts(tok), hot_size
            )
            self.spec = HotSpec(tok, hot)
            self.hot_tables = self.spec.device_tables()
            # run marking must use the spec's adaptive skip class
            self.encoder = SymbolEncoder(tok, lc_mask=self.spec.lc_mask)
        else:
            self.encoder = SymbolEncoder(tok)

    def max_steps_for(self, L: int) -> int:
        return int(self.steps_factor * L) + 64

    def run_raw_device(
        self,
        meta: np.ndarray,
        lengths: np.ndarray,
        entries: Optional[np.ndarray] = None,
        stops: Optional[np.ndarray] = None,
    ):
        """Run the device machine; returns *device* arrays
        ``(ys, bad, steps, state)`` (see :meth:`run_raw`)."""
        B, L = meta.shape
        if L > MAX_SEGMENT:
            raise ValueError(
                f"segment length {L} exceeds packed-event limit {MAX_SEGMENT}; "
                "use the segmentation pipeline for longer streams"
            )
        if entries is None:
            entries = np.ones(B, dtype=np.int32)
        entries = np.asarray(entries, dtype=np.int32)
        t_part = entries & 0x0FFFFFFF
        stop_flags = None if stops is None else jnp.asarray(
            np.asarray(stops, dtype=bool)
        )
        if self.accelerated:
            if L < RING:  # ring window needs at least RING meta rows
                meta = jnp.pad(jnp.asarray(meta), ((0, 0), (0, RING - L)))
                L = RING
            hid_init = self.spec.hot_index[np.clip(t_part, 0, len(self.spec.hot_index) - 1)]
            epst_init = self.spec.eps_avail[
                np.clip(t_part, 0, len(self.spec.eps_avail) - 1)
            ].astype(bool)
            lc_init = self.spec.lc_avail[
                np.clip(t_part, 0, len(self.spec.lc_avail) - 1)
            ].astype(bool)
            ys, bad, steps, state = _run_machine_hot(
                self.tables,
                self.hot_tables,
                jnp.asarray(meta),
                jnp.asarray(lengths),
                jnp.asarray(entries),
                jnp.asarray(hid_init.astype(np.int32)),
                jnp.asarray(epst_init),
                jnp.asarray(lc_init),
                stop_flags,
                eps=self.rep.eps,
                unknown=self.rep.unknown,
                identity=self.rep.identity,
                rep=self.rep,
                spec=self.spec,
                max_steps=self.max_steps_for(L),
                service_k=self.service_k,
            )
        else:
            ys, bad, steps, state = _run_machine(
                self.tables,
                jnp.asarray(meta),
                jnp.asarray(lengths),
                jnp.asarray(entries),
                stop_flags,
                eps=self.rep.eps,
                unknown=self.rep.unknown,
                identity=self.rep.identity,
                rep=self.rep,
                max_steps=self.max_steps_for(L),
            )
        return ys, bad, steps, state

    def run_raw(
        self,
        meta: np.ndarray,
        lengths: np.ndarray,
        entries: Optional[np.ndarray] = None,
        stops: Optional[np.ndarray] = None,
    ):
        """Run the device machine.

        Returns (ys, bad, n_steps, state) numpy arrays where ``state``
        is (B, 6): packed exit ctx, rewind-checkpoint ctx, b (pending
        token start), c (cursor), backtrack and force-emit counts.
        ``entries`` optionally sets per-lane packed entry contexts;
        ``stops`` marks lanes that cut at segment end instead of running
        the EOF epilogue.
        """
        ys, bad, steps, state = self.run_raw_device(
            meta, lengths, entries, stops
        )
        n_steps = int(steps)
        return (
            np.asarray(ys[:n_steps]),
            np.asarray(bad),
            n_steps,
            np.asarray(state),
        )

    def run_events_compact(
        self,
        meta,
        lengths,
        entries: Optional[np.ndarray] = None,
        stops: Optional[np.ndarray] = None,
    ):
        """Run the device machine and fetch *compacted* events.

        Returns ``(ev[B, E] u32, counts[B], bad[B], state)`` numpy
        arrays, with ``E`` the smallest power-of-two bucket holding the
        fullest lane (bucketing bounds recompiles of the compaction
        jit).  The device→host link moves only the compacted rows.
        """
        ys, bad, steps, state = self.run_raw_device(
            meta, lengths, entries, stops
        )
        n_steps = int(steps)
        # static step bucket for the compaction jit
        S = 256
        while S < n_steps:
            S *= 2
        S = min(S, ys.shape[0])
        ev_T, counts_d = _compact_ys(ys, S)
        counts = np.asarray(counts_d)
        cmax = int(counts.max()) if counts.size else 0
        E = 32
        while E < cmax:
            E *= 2
        E = min(E, S)
        ev = np.asarray(ev_T[:, :E])
        return ev, counts, np.asarray(bad), np.asarray(state)

    def events_batch(
        self,
        texts: Sequence[str],
        entries: Optional[np.ndarray] = None,
        return_exits: bool = False,
        as_arrays: bool = False,
        stops: Optional[np.ndarray] = None,
    ):
        """Boundary events per text (device path, oracle fallback).

        ``as_arrays=True`` yields per-text (N, 3) int32 arrays — the
        shape the native writer feeds without per-tuple conversion.
        ``stops[i]`` runs lane i as a *cut* (stop at segment end, no
        EOF epilogue) — the stream-exact dispatch for chunks ending in
        an interior EOT (see pipeline.transduce_doc_exact)."""
        if not texts:
            return ([], np.zeros(0, np.int32)) if return_exits else []
        meta, lengths, _cps = self.encoder.encode_batch(texts)
        ys, bad, n_steps, state = self.run_raw(meta, lengths, entries, stops)
        decoded = decode_events_batch(ys, n_steps, as_arrays=as_arrays)
        exits = state[:, 0].copy()
        out = []
        for i, text in enumerate(texts):
            if bad[i]:
                from .pipeline import transduce_doc_exact

                e0 = int(entries[i]) if entries is not None else 1
                ev, ex = transduce_doc_exact(
                    self.tok, text, e0,
                    bool(stops[i]) if stops is not None else False,
                    encoder=self.encoder,
                )
                if as_arrays:
                    ev = np.asarray(ev, dtype=np.int32).reshape(-1, 3)
                out.append(ev)
                exits[i] = ex
            else:
                out.append(decoded[i])
        if return_exits:
            return out, exits
        return out

    def tokenize_batch(self, texts: Sequence[str], flags: Optional[int] = None) -> List[str]:
        from .events import format_events
        from .writer import SIMPLE

        fl = SIMPLE if flags is None else flags
        return [
            format_events(evs, text, fl)
            for text, evs in zip(texts, self.events_batch(texts))
        ]
