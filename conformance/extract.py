#!/usr/bin/env python
"""Extract conformance scenarios from the reference's Go tests.

The reference's test files (matrix_test.go, datok_test.go) contain the
behavioral specification of Datok: ~120 inline tokenization scenarios
asserted end-to-end through the real runtime (SURVEY.md §4).  This
script mechanically extracts (tokenizer, input, expected) triples into
``conformance/scenarios.json`` so our oracle and device machines can be
diffed against the same spec.  Only expectations (string literals in
assertions) are read — no reference *code* is used.

Extracted patterns:
  * ``tokens = ttokenize(tok, w, STR)``  + ``assert.Equal(STR, tokens[i])``
    (+ optional length asserts)                       → token scenarios
  * ``tokens = strings.Split(w.String(), "\\n")`` after ``Transduce``
                                                      → plain-split scenarios
  * ``assert.Equal(ttokenizeStr(tok, IN), OUT)`` (either arg order)
                                                      → joined scenarios
  * ``tok.Transduce(strings.NewReader(IN), w)`` +
    ``assert.Equal(OUT, w.String())``                 → full-output scenarios

Run:  python conformance/extract.py REFERENCE_CHECKOUT [out.json]
"""

from __future__ import annotations

import json
import re
import sys


def unescape_go(s: str) -> str:
    """Unescape a Go interpreted string literal body."""
    out = []
    i = 0
    n = len(s)
    while i < n:
        ch = s[i]
        if ch != "\\":
            out.append(ch)
            i += 1
            continue
        i += 1
        e = s[i]
        simple = {
            "n": "\n", "t": "\t", "r": "\r", "a": "\a", "b": "\b",
            "f": "\f", "v": "\v", "\\": "\\", '"': '"', "'": "'",
        }
        if e in simple:
            out.append(simple[e])
            i += 1
        elif e == "x":
            out.append(chr(int(s[i + 1 : i + 3], 16)))
            i += 3
        elif e == "u":
            out.append(chr(int(s[i + 1 : i + 5], 16)))
            i += 5
        elif e == "U":
            out.append(chr(int(s[i + 1 : i + 9], 16)))
            i += 9
        elif e.isdigit():
            out.append(chr(int(s[i : i + 3], 8)))
            i += 3
        else:
            raise ValueError("unknown escape: \\" + e)
    return "".join(out)


# A Go string literal (interpreted or raw), non-greedy.
STR_RE = r'(?:"(?:[^"\\]|\\.)*"|`[^`]*`)'


def strip_comments(src: str) -> str:
    """Remove Go block and line comments (string-literal aware)."""
    out = []
    i = 0
    n = len(src)
    while i < n:
        ch = src[i]
        if ch == '"':
            j = i + 1
            while j < n and src[j] != '"':
                j += 2 if src[j] == "\\" else 1
            out.append(src[i : j + 1])
            i = j + 1
        elif ch == "`":
            j = src.find("`", i + 1)
            out.append(src[i : j + 1])
            i = j + 1
        elif src.startswith("//", i):
            j = src.find("\n", i)
            i = n if j < 0 else j  # keep the newline
        elif src.startswith("/*", i):
            j = src.find("*/", i)
            i = n if j < 0 else j + 2
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def lit(value: str, env: dict) -> str:
    """Resolve a literal or a known variable name to its string value."""
    value = value.strip()
    if value.startswith('"'):
        return unescape_go(value[1:-1])
    if value.startswith("`"):
        return value[1:-1]
    if value in env:
        return env[value]
    raise KeyError(value)


def extract(ref_dir: str):
    scenarios = []
    env = {}  # named string vars (package level + locals)

    files = ["matrix_test.go", "datok_test.go"]
    sources = {f: strip_comments(open(f"{ref_dir}/{f}", encoding="utf-8").read()) for f in files}

    # Package-level string vars (e.g. the mixed-German benchmark text `s`)
    for src in sources.values():
        for m in re.finditer(
            r"var (\w+) string = (%s)" % STR_RE, src, re.S
        ):
            env[m.group(1)] = lit(m.group(2), env)

    # Map tokenizer variables to models per test function.
    for fname, src in sources.items():
        funcs = re.split(r"\nfunc ", src)
        for body in funcs:
            # Track var -> model spec within the function.
            models = {
                # package-level fixtures (set up lazily in tests)
                "mat_de": ("matok", "tokenizer_de.matok"),
                "mat_en": ("matok", "tokenizer_en.matok"),
                "dat": ("datok", "tokenizer_de.datok"),
            }
            local_env = dict(env)

            events = []  # (pos, kind, payload)

            for m in re.finditer(
                r"(\w+)\s*:?=\s*LoadMatrixFile\(\s*(%s)\s*\)" % STR_RE, body
            ):
                events.append((m.start(), "model", (m.group(1), "matok", lit(m.group(2), local_env))))
            for m in re.finditer(
                r"(\w+)\s*:?=\s*LoadDatokFile\(\s*(%s)\s*\)" % STR_RE, body
            ):
                events.append((m.start(), "model", (m.group(1), "datok", lit(m.group(2), local_env))))
            for m in re.finditer(
                r"(\w+)\s*:?=\s*LoadFomaFile\(\s*(%s)\s*\)" % STR_RE, body
            ):
                events.append((m.start(), "foma", (m.group(1), lit(m.group(2), local_env))))
            for m in re.finditer(r"(\w+)\s*:?=\s*(\w+)\.ToMatrix\(\)", body):
                events.append((m.start(), "lower", (m.group(1), m.group(2), "foma-matrix")))
            for m in re.finditer(r"(\w+)\s*:?=\s*(\w+)\.ToDoubleArray\(\)", body):
                events.append((m.start(), "lower", (m.group(1), m.group(2), "foma-da")))

            # local string vars (declaration or re-assignment)
            for m in re.finditer(r"(\w+)\s*:?=\s*(%s)\s*$" % STR_RE, body, re.M):
                events.append((m.start(), "setvar", (m.group(1), lit(m.group(2), local_env))))

            # scenario starters
            for m in re.finditer(
                r"tokens\s*=\s*ttokenize\((\w+),\s*w,\s*((?:%s|\w+))\)" % STR_RE, body
            ):
                events.append((m.start(), "ttokenize", (m.group(1), m.group(2))))
            for m in re.finditer(
                r"(\w+)\.Transduce\(\s*(?:strings\.NewReader\(((?:%s|\w+))\)|r)\s*,\s*w\s*\)" % STR_RE,
                body,
            ):
                events.append((m.start(), "transduce", (m.group(1), m.group(2))))
            for m in re.finditer(
                r"r\s*:?=\s*strings\.NewReader\(((?:%s|\w+))\)" % STR_RE, body
            ):
                events.append((m.start(), "reader", (m.group(1),)))
            for m in re.finditer(
                r'tokens\s*=\s*strings\.Split\(w\.String\(\),\s*"\\n"\)', body
            ):
                events.append((m.start(), "plainsplit", ()))
            for m in re.finditer(
                r'sentences\s*=\s*strings\.Split\(w\.String\(\),\s*"\\n\\n"\)', body
            ):
                events.append((m.start(), "sentsplit", ()))

            # asserts
            for m in re.finditer(
                r"assert\.Equal\((%s),\s*tokens\[(\d+)\]\)" % STR_RE, body
            ):
                events.append((m.start(), "tokassert", (int(m.group(2)), lit(m.group(1), local_env))))
            for m in re.finditer(
                r"assert\.Equal\(tokens\[(\d+)\],\s*(%s)\)" % STR_RE, body
            ):
                events.append((m.start(), "tokassert", (int(m.group(1)), lit(m.group(2), local_env))))
            for m in re.finditer(r"assert\.Equal\((\d+),\s*len\(tokens\)\)", body):
                events.append((m.start(), "lenassert", (int(m.group(1)),)))
            for m in re.finditer(
                r"assert\.Equal\((%s),\s*sentences\[(\d+)\]\)" % STR_RE, body
            ):
                events.append((m.start(), "sentassert", (int(m.group(2)), lit(m.group(1), local_env))))
            for m in re.finditer(
                r"assert\.Equal\(sentences\[(\d+)\],\s*(%s)\)" % STR_RE, body
            ):
                events.append((m.start(), "sentassert", (int(m.group(1)), lit(m.group(2), local_env))))
            for m in re.finditer(r"assert\.Equal\((\d+),\s*len\(sentences\)\)", body):
                events.append((m.start(), "sentlen", (int(m.group(1)),)))
            for m in re.finditer(r"assert\.Equal\(len\(sentences\),\s*(\d+)\)", body):
                events.append((m.start(), "sentlen", (int(m.group(1)),)))
            for m in re.finditer(r"assert\.Equal\(len\(tokens\),\s*(\d+)\)", body):
                events.append((m.start(), "lenassert", (int(m.group(1)),)))
            for m in re.finditer(
                r"assert\.Equal\(ttokenizeStr\((\w+),\s*((?:%s|\w+))\),\s*(%s)\)" % (STR_RE, STR_RE),
                body,
            ):
                events.append((m.start(), "joined", (m.group(1), m.group(2), lit(m.group(3), local_env))))
            for m in re.finditer(
                r"assert\.Equal\((%s),\s*ttokenizeStr\((\w+),\s*((?:%s|\w+))\)\)" % (STR_RE, STR_RE),
                body,
            ):
                events.append((m.start(), "joined", (m.group(2), m.group(3), lit(m.group(1), local_env))))
            for m in re.finditer(
                r"assert\.Equal\((%s),\s*w\.String\(\)\)" % STR_RE, body
            ):
                events.append((m.start(), "fullassert", (lit(m.group(1), local_env),)))
            for m in re.finditer(
                r"assert\.Equal\(w\.String\(\),\s*(%s)\)" % STR_RE, body
            ):
                events.append((m.start(), "fullassert", (lit(m.group(1), local_env),)))

            events.sort(key=lambda e: e[0])

            fomas = {}
            cur = None  # current scenario dict
            pending_reader = None

            def close(c):
                if c and (
                    c.get("tokens")
                    or c.get("len") is not None
                    or c.get("full") is not None
                    or c.get("sentences")
                    or c.get("sent_len") is not None
                ):
                    scenarios.append(c)

            for pos, kind, payload in events:
                if kind == "model":
                    var, typ, path = payload
                    models[var] = (typ, path.split("/")[-1])
                elif kind == "foma":
                    fomas[payload[0]] = payload[1].split("/")[-1]
                elif kind == "lower":
                    var, src_var, how = payload
                    if src_var in fomas:
                        models[var] = (how, fomas[src_var])
                elif kind == "setvar":
                    local_env[payload[0]] = payload[1]
                elif kind == "ttokenize":
                    close(cur)
                    tokvar, arg = payload
                    try:
                        text = lit(arg, local_env)
                    except KeyError:
                        cur = None
                        continue
                    if tokvar not in models:
                        cur = None
                        continue
                    cur = {
                        "file": fname,
                        "model": models[tokvar],
                        "input": text,
                        "mode": "collapse",
                        "tokens": {},
                        "len": None,
                        "full": None,
                    }
                elif kind == "reader":
                    try:
                        pending_reader = lit(payload[0], local_env)
                    except KeyError:
                        pending_reader = None
                elif kind == "transduce":
                    close(cur)
                    tokvar, arg = payload
                    text = pending_reader
                    if arg:
                        try:
                            text = lit(arg, local_env)
                        except KeyError:
                            pass
                    if text is None or tokvar not in models:
                        cur = None
                        continue
                    cur = {
                        "file": fname,
                        "model": models[tokvar],
                        "input": text,
                        "mode": "plain",
                        "tokens": {},
                        "len": None,
                        "full": None,
                    }
                elif kind == "plainsplit":
                    if cur:
                        cur["mode"] = "plain"
                elif kind == "sentsplit":
                    pass  # sentence asserts reference the same scenario
                elif kind == "sentassert":
                    if cur:
                        cur.setdefault("sentences", {})[str(payload[0])] = payload[1]
                elif kind == "sentlen":
                    if cur:
                        cur["sent_len"] = payload[0]
                elif kind == "tokassert":
                    if cur:
                        cur["tokens"][str(payload[0])] = payload[1]
                elif kind == "lenassert":
                    if cur:
                        cur["len"] = payload[0]
                elif kind == "fullassert":
                    if cur:
                        cur["full"] = payload[0]
                elif kind == "joined":
                    tokvar, arg, expected = payload
                    try:
                        text = lit(arg, local_env)
                    except KeyError:
                        continue
                    if tokvar not in models:
                        continue
                    scenarios.append(
                        {
                            "file": fname,
                            "model": models[tokvar],
                            "input": text,
                            "mode": "joined",
                            "tokens": {},
                            "len": None,
                            "full": expected,
                        }
                    )
            close(cur)

    return scenarios


# Scenarios whose expectations require grammar features from the 0.3.1
# changelog (hyphenated abbreviations, Wikipedia templates, colon/slash/
# paren gender forms, the ver.di plusampersand entry — Changes:1-8) that
# are ABSENT from the snapshot's committed binary fixtures: converting
# the committed tokenizer_de.fst reproduces the committed .matok byte
# for byte, and that model has no transition path for these inputs
# (verified by direct table walks).  The reference's own `go test` fails
# these at this snapshot unless fixtures are rebuilt with foma (which is
# not shipped).  They are tagged so conformance tests can skip them with
# a documented reason rather than hiding them.
STALE_FIXTURE_MARKERS = [
    "ver.di",
    "Ba.-Wü.",
    "[_EMOJI:",
    "[_ANONYMIZED_]",
    "Schüler:innen",
    "Künstler:innen",
    "Autor/in",
    "Kaufmann/-frau",
    "Kaufmann/frau",
    "Lehrer(in)",
    "Kosovo-Albaner/innen",
    "Kosovo-Albaner/-innen",
    "Fachmann/-frau",
    "Geschäftsmann/frau",
    "Innenminister/in",
]


def main():
    if len(sys.argv) < 2:
        sys.exit("usage: extract.py REFERENCE_CHECKOUT [out.json]")
    ref = sys.argv[1]
    out = sys.argv[2] if len(sys.argv) > 2 else "conformance/scenarios.json"
    scen = extract(ref)
    for s in scen:
        if any(m in s["input"] for m in STALE_FIXTURE_MARKERS):
            s["stale_fixture"] = True
    with open(out, "w", encoding="utf-8") as f:
        json.dump(scen, f, ensure_ascii=False, indent=1)
    by_model = {}
    for s in scen:
        k = tuple(s["model"])
        by_model[k] = by_model.get(k, 0) + 1
    print(f"{len(scen)} scenarios -> {out}")
    for k, v in sorted(by_model.items()):
        print(f"  {k}: {v}")


if __name__ == "__main__":
    main()
