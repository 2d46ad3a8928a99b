"""Worker process for the 2-process localhost coordinator test.

Launched by ``test_distributed_real.py`` with JAX_COORDINATOR_ADDRESS /
JAX_NUM_PROCESSES / JAX_PROCESS_ID in the environment — the same
variables a cluster launcher would set (distributed.initialize reads
them).  Runs :func:`run_corpus_distributed` twice (fresh + resume) over
its deterministic shard and writes the globally-reduced counters to a
JSON result file.

Exit codes: 0 = success, 3 = distributed init refused (environmental —
the test skips), anything else = real failure (the test fails).
"""

import json
import os
import sys
import traceback


def main() -> int:
    corpus_dir, out_dir, result_path = sys.argv[1:4]
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from datok.parallel import distributed as dist

    try:
        active = dist.initialize()
        if not active or jax.process_count() != 2:
            print(
                f"init did not yield 2 processes (count={jax.process_count()})",
                file=sys.stderr,
            )
            return 3
    except Exception:
        traceback.print_exc()
        return 3

    import datok as dt
    from datok.fsa.synth import model_path

    tok = dt.load_matrix_file(model_path("synth_simple"))
    files = sorted(
        os.path.join(corpus_dir, f) for f in os.listdir(corpus_dir)
    )
    fresh = dist.run_corpus_distributed(tok, files, out_dir)
    resume = dist.run_corpus_distributed(tok, files, out_dir)
    with open(result_path, "w", encoding="utf-8") as fh:
        json.dump(
            {
                "process_id": jax.process_index(),
                "process_count": jax.process_count(),
                "fresh": fresh,
                "resume": resume,
            },
            fh,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
