"""Mesh-sharded engine on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from datok.parallel.mesh import ShardedEngine


@pytest.fixture(scope="module")
def mesh8():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return Mesh(np.array(devs[:8]), ("data",))


@pytest.fixture(scope="module")
def sharded(mat_de, mesh8):
    return ShardedEngine(mat_de, mesh=mesh8)


def test_sharded_matches_oracle(sharded, mat_de):
    texts = [
        f"Lane {i}: Der alte Mann las z.B. die readme.txt am 5.9.2018!\x04"
        for i in range(19)  # non-multiple of shard count exercises padding
    ] + ["", "Kurz."]
    outs = sharded.tokenize_batch(texts)
    for t, o in zip(texts, outs):
        assert o == mat_de.tokenize(t)


def test_corpus_stats(sharded):
    texts = ["Ein Satz. Und noch einer!\x04", "Zweiter Text.\x04", "dritter"]
    stats = sharded.corpus_stats(texts)
    assert stats["texts"] == 3
    assert stats["tokens"] == 11
    assert stats["shards"] == 8
    assert stats["chars"] == sum(len(t) for t in texts)


def test_graft_entry_contract():
    import __graft_entry__ as g

    fn, args = g.entry()
    ys, bad, steps, exits = fn(*args)
    assert int(bad.sum()) == 0
    g.dryrun_multichip(8)


# ---- multi-host distribution primitives (single-process semantics) ----


def test_process_shard_partition():
    from datok.parallel.distributed import process_shard

    items = [f"f{i}" for i in range(23)]
    for pc in (1, 2, 3, 8, 23, 40):
        shards = [process_shard(items, pi, pc) for pi in range(pc)]
        flat = [x for s in shards for x in s]
        assert flat == items  # exact cover, order-preserving
        sizes = [len(s) for s in shards]
        assert max(sizes) - min(sizes) <= 1  # balanced


def test_initialize_single_process_noop():
    from datok.parallel import distributed

    assert distributed.initialize() is False  # no coordinator configured


def test_global_mesh_single_host():
    import jax
    from datok.parallel.distributed import global_mesh

    mesh = global_mesh()
    assert mesh.axis_names == ("host", "data")
    assert mesh.shape["host"] == 1
    assert mesh.shape["data"] == jax.local_device_count()


def test_allreduce_counters_identity():
    from datok.parallel.distributed import allreduce_counters

    c = {"tokens": 5, "bytes": 123}
    assert allreduce_counters(c) == c


def test_run_corpus_distributed_single_process(mat_de, tmp_path):
    from datok.parallel.distributed import run_corpus_distributed

    files = []
    for i in range(3):
        p = tmp_path / f"d{i}.txt"
        p.write_text(f"Der {i}. Satz hier!\x04")
        files.append(str(p))
    stats = run_corpus_distributed(mat_de, files, str(tmp_path / "out"))
    assert stats["done"] == 3
    assert stats["processes"] == 1
    out0 = open(tmp_path / "out" / "d0.txt.tok", encoding="utf-8").read()
    assert out0 == mat_de.tokenize("Der 0. Satz hier!\x04")


def test_balance_perm_properties():
    from datok.parallel.mesh import balance_perm

    lens = [1000, 10, 10, 10, 900, 20, 800, 30, 700, 40, 50, 600,
            5, 500, 60, 70]
    perm = balance_perm(lens, 4)
    assert sorted(perm.tolist()) == list(range(16))
    # per-shard char totals within one max-doc of even
    tot = sum(lens)
    for s in range(4):
        shard = perm[s * 4 : (s + 1) * 4]
        work = sum(lens[i] for i in shard)
        assert abs(work - tot / 4) <= max(lens)


def test_sharded_wave_balancing_parity(sharded, mat_de):
    """waves_pipelined on a mesh engine permutes lanes for shard
    balance — output must still be byte-identical and in input order,
    and per-shard step counts near-even on a skewed batch."""
    from datok.runtime.overlap import tokenize_stream_pipelined
    from datok.runtime.pipeline import tokenize_stream

    # skewed: long docs clustered at the front
    docs = (
        ["Lang und länger. " * 50 + "Ende gut!\x04"] * 4
        + [f"Kurz {i}.\x04" for i in range(28)]
    )
    text = "".join(docs)
    a = tokenize_stream(mat_de, text).getvalue()
    b = tokenize_stream_pipelined(
        sharded.tok, text, engine=sharded, pack_len=0
    ).getvalue()
    assert a == b
    steps = np.asarray(sharded.last_shard_steps, dtype=np.int64)
    assert steps.max() > 0
    # balanced: no shard does more than ~2x the mean (unbalanced
    # clustering would give one shard everything)
    assert steps.max() <= 2 * max(1.0, steps.mean())


def test_corpus_stats_scaling_fields(sharded):
    texts = ["Ein Satz. Und noch einer!\x04"] * 10
    stats = sharded.corpus_stats(texts)
    assert len(stats["shard_steps"]) == 8
    assert 0 < stats["balance_efficiency"] <= 1.0
    assert stats["padded_lanes"] == 6  # 10 -> 16 lanes at 8 shards
    assert stats["padded_fraction"] == round(6 / 16, 4)
