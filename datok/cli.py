"""Command-line interface.

Mirrors the reference CLI (reference cmd/datok.go:18-134):

    datok convert -i FOMA -o TOKENIZER [-d]
    datok tokenize -t TOKENIZER INPUT [--no-tokens] [--no-sentences]
        [-p|--token-positions] [--sentence-positions] [--newline-after-eot]
        [--batch] [--accelerated/--no-accelerated]

``tokenize`` defaults to the scalar oracle for small stdin-style usage
and switches to the batched device engine with ``--batch`` (splitting
the input stream into per-``\\x04`` documents for lane parallelism).
"""

from __future__ import annotations

import argparse
import json
import sys

from .fsa.double_array import DaTokenizer
from .fsa.foma import load_foma_file
from .fsa.io import load_tokenizer_file
from .fsa.matrix import MatrixTokenizer
from .runtime.writer import (
    NEWLINE_AFTER_EOT,
    SENTENCE_POS,
    SENTENCES,
    TOKEN_POS,
    TOKENS,
    TokenWriter,
)


def cmd_convert(args) -> int:
    auto = load_foma_file(args.foma)
    if args.double_array:
        dat = DaTokenizer.from_automaton(auto)
        print("Load factor", dat.load_factor())
        dat.save(args.tokenizer)
    else:
        mat = MatrixTokenizer.from_automaton(auto)
        mat.save(args.tokenizer)
    print("File successfully converted.")
    return 0


def make_flags(args) -> int:
    flags = 0
    if args.tokens:
        flags |= TOKENS
    if args.token_positions:
        flags |= TOKEN_POS
    if args.sentences:
        flags |= SENTENCES
    if args.sentence_positions:
        flags |= SENTENCE_POS
    if args.newline_after_eot:
        flags |= NEWLINE_AFTER_EOT
    return flags


def cmd_tokenize(args) -> int:
    tok = load_tokenizer_file(args.tokenizer)
    flags = make_flags(args)
    w = TokenWriter(flags, out=sys.stdout)

    if args.batch:
        # bounded-memory streaming through the device engine: a
        # multi-GB file flows chunk by chunk (O(chunk) peak memory),
        # matching the reference's io.Reader surface (matrix.go:348)
        from .runtime.jax_engine import BatchEngine
        from .runtime.pipeline import tokenize_reader
        from .utils.compile_cache import enable_compile_cache

        enable_compile_cache()
        engine = BatchEngine(tok, accelerated=args.accelerated)
        if args.input == "-":
            tokenize_reader(tok, sys.stdin.buffer, w, engine=engine)
        else:
            with open(args.input, "rb") as f:
                tokenize_reader(tok, f, w, engine=engine)
    else:
        # stream with bounded memory (the reference transduces an
        # io.Reader through a ring buffer — cmd/datok.go:108-133)
        from .runtime.oracle import transduce_reader

        if args.input == "-":
            transduce_reader(tok, sys.stdin.buffer, writer=w)
        else:
            with open(args.input, "rb") as f:
                transduce_reader(tok, f, writer=w)
    w.flush()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="datok", description="FSA based tokenizer")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("convert", help="Convert a compiled foma FST file")
    c.add_argument("-i", "--foma", required=True, help="The Foma FST file")
    c.add_argument("-o", "--tokenizer", required=True, help="The Tokenizer file")
    c.add_argument(
        "-d",
        "--double-array",
        action="store_true",
        help="Convert to Double Array instead of Matrix representation",
    )

    t = sub.add_parser("tokenize", help="Tokenize a text")
    t.add_argument("-t", "--tokenizer", required=True)
    t.add_argument("input", help="Input file to tokenize (use - for STDIN)")
    t.add_argument("--tokens", action=argparse.BooleanOptionalAction, default=True)
    t.add_argument("--sentences", action=argparse.BooleanOptionalAction, default=True)
    t.add_argument("-p", "--token-positions", action="store_true", default=False)
    t.add_argument("--sentence-positions", action="store_true", default=False)
    t.add_argument("--newline-after-eot", action="store_true", default=False)
    t.add_argument("--batch", action="store_true", default=False,
                   help="Use the batched device engine")
    t.add_argument(
        "--accelerated", action=argparse.BooleanOptionalAction, default=True,
        help="--no-accelerated forces the general device machine",
    )

    c2 = sub.add_parser(
        "corpus", help="Tokenize many files resumably (shard manifest)"
    )
    c2.add_argument("-t", "--tokenizer", required=True)
    c2.add_argument("-o", "--out-dir", required=True)
    c2.add_argument("files", nargs="+")
    c2.add_argument("--tokens", action=argparse.BooleanOptionalAction, default=True)
    c2.add_argument("--sentences", action=argparse.BooleanOptionalAction, default=True)
    c2.add_argument("-p", "--token-positions", action="store_true", default=False)
    c2.add_argument("--sentence-positions", action="store_true", default=False)
    c2.add_argument("--newline-after-eot", action="store_true", default=False)

    args = p.parse_args(argv)
    # malformed model/foma files exit with a clean one-line error, not
    # a traceback (the reference logs and returns nil —
    # fomafile.go:158-165, datok.go:645-663)
    import gzip
    import struct
    import zlib

    try:
        if args.cmd == "convert":
            return cmd_convert(args)
        if args.cmd == "corpus":
            from .fsa.io import load_tokenizer_file as _load
            from .runtime.corpus import CorpusRunner
            from .utils.compile_cache import enable_compile_cache

            enable_compile_cache()
            tok = _load(args.tokenizer)
            runner = CorpusRunner(tok, args.out_dir, flags=make_flags(args))
            pst = {}
            stats = runner.run(args.files, verbose=True, stats=pst)
            # pipeline observability (SURVEY §5 metrics row): stage
            # seconds, wave/doc counts, host chain repairs
            stats["pipeline"] = {
                k: (round(v, 3) if isinstance(v, float) else v)
                for k, v in pst.items()
            }
            print(json.dumps(stats))
            return 0
        return cmd_tokenize(args)
    except (
        OSError,
        ValueError,
        KeyError,
        IndexError,
        EOFError,
        gzip.BadGzipFile,
        zlib.error,
        struct.error,
        UnicodeDecodeError,
    ) as e:
        print(f"datok: error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
