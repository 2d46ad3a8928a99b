"""Mesh-sharded batch tokenization.

The reference scales by running one OS process per file (SURVEY.md
§2.3 — no in-process parallelism at all).  Here one process drives
every device through SPMD over a 1-D ``jax.sharding.Mesh``:

  * corpus lanes are **data-parallel** across devices (one ``data``
    axis over all devices) — each device transduces its shard of the
    segment batch;
  * the transition table (and the hot machine's tables) are
    **replicated** (12.6 MB for a DE-size matrix);
  * per-shard token/sentence/text/char counters all-reduce with
    ``psum`` — the only collective this workload needs (the model is
    read-only, so there is no parameter synchronization).

The device machine is the SAME one :class:`~datok.runtime
.jax_engine.BatchEngine` runs on one device, wrapped in
``jax.shard_map`` so every shard runs its own loops at local speed with
no cross-shard synchronization until the final counter reduction.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..runtime.events import EV_SENT, EV_TEXT, EV_TOKEN
from ..runtime.jax_engine import BatchEngine, decode_events_batch


def _counters(ys, length, state, axes):
    """Shard-local corpus counters, all-reduced over the mesh axes."""
    kinds = ys & 3
    local = jnp.stack(
        [
            jnp.sum(kinds == EV_TOKEN),
            jnp.sum(kinds == EV_SENT),
            jnp.sum(kinds == EV_TEXT),
            jnp.sum(length),
            jnp.sum(state[:, 4]),  # backtracks
            jnp.sum(state[:, 5]),  # force emits
        ]
    )
    return jax.lax.psum(local, axes)


def balance_perm(lengths: Sequence[int], n_shards: int) -> np.ndarray:
    """Length-balancing lane permutation for an ``n_shards`` mesh.

    Lanes are sharded in contiguous blocks along axis 0, so a wave
    whose long documents cluster gives one shard most of the work and
    the others idle at the barrier (per-shard step counts are the
    efficiency number — see ``corpus_stats``).  Snake-deal documents
    by descending length across shards: shard s receives ranks
    s, 2n−1−s, 2n+s, … — cumulative work per shard stays within one
    document of even.  Returns ``perm`` such that submitting
    ``docs[perm[j]]`` as lane j balances the shards; invert with
    ``inv[perm] = arange`` to restore input order on the results.
    """
    order = np.argsort(
        -np.asarray(lengths, dtype=np.int64), kind="stable"
    )
    shards: List[List[int]] = [[] for _ in range(n_shards)]
    for i, idx in enumerate(order):
        s = i % n_shards
        if (i // n_shards) % 2:
            s = n_shards - 1 - s
        shards[s].append(int(idx))
    return np.asarray(
        [i for sh in shards for i in sh], dtype=np.int64
    )


class ShardedEngine(BatchEngine):
    """Data-parallel tokenization over a device mesh.

    Drop-in equivalent of :class:`BatchEngine` that shards the lane
    dimension over every axis of ``mesh`` and replicates the transition
    tables.  All ``BatchEngine`` engine knobs apply per shard.
    """

    def __init__(self, tok, mesh: Optional[Mesh] = None, **kwargs):
        if mesh is None:
            mesh = Mesh(np.array(jax.devices()), ("data",))
        self.mesh = mesh
        self.axes = tuple(mesh.axis_names)
        self.n_shards = int(np.prod([mesh.shape[a] for a in self.axes]))
        super().__init__(tok, **kwargs)
        self.last_shard_steps = np.zeros(self.n_shards, np.int32)
        self.last_padded_lanes = 0
        self._repl = NamedSharding(mesh, P())
        self._lane = NamedSharding(mesh, P(self.axes))
        self._batch = NamedSharding(mesh, P(self.axes, None))
        self.tables = tuple(jax.device_put(t, self._repl) for t in self.tables)
        if self.accelerated:
            self.hot_tables = tuple(
                jax.device_put(t, self._repl) for t in self.hot_tables
            )

    # -- lane padding ------------------------------------------------

    def _lane_quantum(self) -> int:
        return self.n_shards

    def pad_batch(self, meta: np.ndarray, lengths: np.ndarray):
        """Pad the lane count to a multiple of the shard quantum."""
        B = meta.shape[0]
        rem = (-B) % self._lane_quantum()
        if rem:
            meta = np.pad(meta, ((0, rem), (0, 0)))
            lengths = np.pad(np.asarray(lengths, np.int32), (0, rem))
        return meta, lengths, B

    # -- sharded machine ---------------------------------------------

    @functools.cached_property
    def _sharded_call(self):
        """shard_map-wrapped device machine (built per engine type)."""
        axes = self.axes
        lane = P(axes)
        row = P(None, axes)  # (steps, B) event buffer
        col = P(axes, None)  # (B, L) meta / (B, 6) state

        def local(meta, length, ctx, hid, epst, lc, stop, *, max_steps):
            if self.accelerated:
                from ..runtime.jax_engine import _run_machine_hot

                ys, bad, steps, state = _run_machine_hot(
                    self.tables, self.hot_tables, meta, length, ctx,
                    hid, epst, lc, stop,
                    eps=self.rep.eps, unknown=self.rep.unknown,
                    identity=self.rep.identity, rep=self.rep,
                    spec=self.spec, max_steps=max_steps,
                    service_k=self.service_k,
                )
            else:
                from ..runtime.jax_engine import _run_machine

                ys, bad, steps, state = _run_machine(
                    self.tables, meta, length, ctx, stop,
                    eps=self.rep.eps, unknown=self.rep.unknown,
                    identity=self.rep.identity, rep=self.rep,
                    max_steps=max_steps,
                )
            stats = _counters(ys, length, state, axes)
            # per-shard step counts differ; ship one per shard
            return ys, bad, steps[None], state, stats

        @functools.partial(jax.jit, static_argnames=("max_steps",))
        def call(meta, length, ctx, hid, epst, lc, stop, *, max_steps):
            fn = jax.shard_map(
                functools.partial(local, max_steps=max_steps),
                mesh=self.mesh,
                in_specs=(col, lane, lane, lane, lane, lane, lane),
                out_specs=(row, lane, P(axes), col, P()),
                check_vma=False,
            )
            return fn(meta, length, ctx, hid, epst, lc, stop)

        return call

    def run_raw_device(self, meta, lengths, entries=None, stops=None):
        """Run the sharded device machine; returns device arrays.

        Same contract as :meth:`BatchEngine.run_raw_device` plus a
        ``stats`` attribute (``last_counters``) of globally-reduced
        corpus counters.
        """
        meta = np.asarray(meta)
        B0 = meta.shape[0]
        meta, lengths, _ = self.pad_batch(meta, np.asarray(lengths, np.int32))
        B, L = meta.shape
        from ..runtime.jax_engine import RING

        if self.accelerated and L < RING:
            meta = np.pad(meta, ((0, 0), (0, RING - L)))
            L = RING
        if entries is None:
            entries = np.ones(B, dtype=np.int32)
        else:
            entries = np.pad(
                np.asarray(entries, np.int32), (0, B - B0), constant_values=1
            )
        t_part = entries & 0x0FFFFFFF
        if stops is None:
            stops_a = np.zeros(B, dtype=bool)
        else:
            stops_a = np.pad(np.asarray(stops, bool), (0, B - B0))
        if self.accelerated:
            hid = self.spec.hot_index[
                np.clip(t_part, 0, len(self.spec.hot_index) - 1)
            ].astype(np.int32)
            epst = self.spec.eps_avail[
                np.clip(t_part, 0, len(self.spec.eps_avail) - 1)
            ].astype(bool)
            lc = self.spec.lc_avail[
                np.clip(t_part, 0, len(self.spec.lc_avail) - 1)
            ].astype(bool)
        else:
            hid = np.full(B, -1, np.int32)
            epst = np.zeros(B, bool)
            lc = np.zeros(B, bool)

        meta_d = jax.device_put(jnp.asarray(meta), self._batch)
        put = lambda x: jax.device_put(jnp.asarray(x), self._lane)
        ys, bad, steps, state, stats = self._sharded_call(
            meta_d, put(lengths), put(entries), put(hid), put(epst),
            put(lc), put(stops_a), max_steps=self.max_steps_for(L),
        )
        self.last_counters = stats
        # per-shard local step counts: the workload is embarrassingly
        # parallel (no cross-shard communication until the final psum),
        # so multi-chip efficiency ≈ work balance = mean/max of these
        self.last_shard_steps = steps
        self.last_padded_lanes = B - B0
        steps_g = jnp.max(steps)
        return (
            ys[:, :B0] if B0 != B else ys,
            bad[:B0],
            steps_g,
            state[:B0],
        )

    # -- host-facing surfaces (run_raw / tokenize_batch inherited;
    #    events_batch and corpus_stats balance lanes first) -----------

    def events_batch(
        self,
        texts: Sequence[str],
        entries=None,
        return_exits: bool = False,
        as_arrays: bool = False,
        stops=None,
    ):
        """Shard-balanced :meth:`BatchEngine.events_batch`.

        Lanes shard in contiguous blocks, so a direct batch whose long
        texts cluster would idle every other shard at the barrier
        (round-3 verdict applied balancing only inside the wave
        pipeline).  Balance-permute the lanes, run, unpermute the
        results — output order and exactness unchanged.
        """
        n = len(texts)
        if self.n_shards > 1 and n > self.n_shards:
            perm = balance_perm([len(t) for t in texts], self.n_shards)
            inv = np.empty_like(perm)
            inv[perm] = np.arange(n)
            r = super().events_batch(
                [texts[i] for i in perm],
                None if entries is None else np.asarray(entries)[perm],
                return_exits,
                as_arrays,
                None if stops is None else np.asarray(stops)[perm],
            )
            if return_exits:
                out, exits = r
                return [out[i] for i in inv], exits[inv]
            return [r[i] for i in inv]
        return super().events_batch(
            texts, entries, return_exits, as_arrays, stops
        )

    def corpus_stats(self, texts: Sequence[str],
                     balance: bool = True) -> dict:
        """Tokenize a corpus and return globally-reduced counters.

        ``balance=False`` keeps the caller's lane order (the A/B knob
        for the scaling sweep); the default balances like
        :meth:`events_batch`."""
        if balance and self.n_shards > 1 and len(texts) > self.n_shards:
            # counters are order-independent; balancing the lanes is
            # pure efficiency (see events_batch)
            perm = balance_perm([len(t) for t in texts], self.n_shards)
            texts = [texts[i] for i in perm]
        meta, lengths, _ = self.encoder.encode_batch(texts)
        _ys, bad, _n, _state = self.run_raw(meta, lengths)
        stats = np.asarray(self.last_counters)
        # Padding lanes are empty texts and emit one sentence-end and
        # one text-end each; discount them from the global counters.
        pad = (-len(texts)) % self._lane_quantum()
        shard_steps = np.asarray(self.last_shard_steps, dtype=np.int64)
        smax = int(shard_steps.max()) if shard_steps.size else 0
        return {
            "tokens": int(stats[0]),
            "sentences": int(stats[1]) - pad,
            "texts": int(stats[2]) - pad,
            "chars": int(stats[3]),
            "backtracks": int(stats[4]),
            "force_emits": int(stats[5]),
            "fallback_lanes": int(bad.sum()),
            "shards": self.n_shards,
            # scaling observability (BASELINE.md north star): shards
            # never communicate until the final counter psum, so
            # efficiency on a real mesh is work balance × (1 − padded
            # waste); both are reported per run
            "shard_steps": shard_steps.tolist(),
            "balance_efficiency": (
                round(float(shard_steps.mean()) / smax, 4) if smax else 1.0
            ),
            "padded_lanes": int(self.last_padded_lanes),
            "padded_fraction": round(
                self.last_padded_lanes
                / max(1, len(texts) + self.last_padded_lanes), 4
            ),
        }
