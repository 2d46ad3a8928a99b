"""datok — finite-state tokenization on an accelerator.

A from-scratch re-design of the capabilities of KorAP/Datok (a Go
finite-state tokenizer + sentence splitter) for accelerators driven
through JAX:

  * Foma-compiled FSTs are loaded into Datok's two runtime automaton
    representations — a dense transition *matrix* and an Aoe/Mizobuchi
    *double array* — kept byte-compatible with the ``.matok``/``.datok``
    on-disk formats (reference: matrix.go, datok.go).
  * The greedy single-backtrack transduce loop runs as a batched,
    masked state machine over many input streams in parallel on the
    device (JAX/XLA), emitting compact boundary *events* that a
    host-side formatter turns into byte-identical Datok output.
  * Corpus shards scale over a ``jax.sharding.Mesh`` with the
    transition table replicated and counters reduced with ``psum``.

Public API (mirrors the reference's library surface, Readme.md:76-104):

    from datok import load_tokenizer_file, TokenWriter, SIMPLE
    tok = load_tokenizer_file("tokenizer_de.matok")
    out = tok.tokenize("Der alte Mann.")          # scalar oracle path
    eng = BatchEngine(tok)                        # device batch path
    outs = eng.tokenize_batch(["...", "..."])
"""

from .fsa.automaton import Automaton
from .fsa.foma import load_foma_file, parse_foma
from .fsa.matrix import MatrixTokenizer, load_matrix_file, parse_matrix
from .fsa.double_array import DaTokenizer, load_datok_file, parse_datok
from .fsa.io import load_tokenizer_file
from .runtime.writer import (
    TokenWriter,
    TOKENS,
    SENTENCES,
    TOKEN_POS,
    SENTENCE_POS,
    NEWLINE_AFTER_EOT,
    SIMPLE,
)
from .runtime.oracle import transduce, transduce_reader
from .runtime.events import EV_TOKEN, EV_SENT, EV_TEXT, replay_events, format_events

__version__ = "0.1.0"


def __getattr__(name):
    # Device-engine surfaces import jax; load them lazily so the pure
    # host paths (oracle, formats, writer) stay jax-free at import.
    if name == "BatchEngine":
        from .runtime.jax_engine import BatchEngine

        return BatchEngine
    if name in ("tokenize_stream", "tokenize_reader"):
        from .runtime import pipeline

        return getattr(pipeline, name)
    if name in ("tokenize_stream_pipelined", "events_pipelined"):
        from .runtime import overlap

        return getattr(overlap, name)
    if name == "CorpusRunner":
        from .runtime.corpus import CorpusRunner

        return CorpusRunner
    raise AttributeError(f"module 'datok' has no attribute {name!r}")

__all__ = [
    "Automaton",
    "load_foma_file",
    "parse_foma",
    "MatrixTokenizer",
    "load_matrix_file",
    "parse_matrix",
    "DaTokenizer",
    "load_datok_file",
    "parse_datok",
    "load_tokenizer_file",
    "TokenWriter",
    "TOKENS",
    "SENTENCES",
    "TOKEN_POS",
    "SENTENCE_POS",
    "NEWLINE_AFTER_EOT",
    "SIMPLE",
    "transduce",
    "transduce_reader",
    "EV_TOKEN",
    "EV_SENT",
    "EV_TEXT",
    "replay_events",
    "format_events",
    "BatchEngine",
    "tokenize_stream",
    "tokenize_reader",
    "CorpusRunner",
]
