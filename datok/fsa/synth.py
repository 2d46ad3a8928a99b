"""Seeded synthetic tokenizer grammars and texts.

The published Datok models (``tokenizer_de.matok`` and friends) are
compiled with foma from XFST sources and word lists that this
repository does not carry.  This module builds stand-ins from a seed:
Datok-convention :class:`~datok.fsa.automaton.Automaton` objects
(the same convention ``fomafile.go`` produces, see automaton.py), plus
texts drawn from each grammar's own vocabulary.  The same profile and
seed always give a byte-identical ``.matok``/``.datok``.

Grammar shape (the components of SURVEY.md §2.2, one small DFA each,
merged by subset construction into one deterministic automaton):

  * letter words (ASCII, umlauts, ß, accented Latin letters), with
    inner hyphens; an unknown character inside a word continues it
    (the identity → unknown retry of matrix.go:472-485);
  * an abbreviation trie over a seeded list (``n_abbrev`` entries such
    as ``bzw.`` or ``z.B.``); it carries most of the states;
  * numbers with ``.``/``,`` separators, ordinals (``3.``), dates
    (``5.9.2018``), times (``14:30``) and percentages;
  * URLs (``http``/``https``/``ftp`` schemes), e-mail addresses and
    domains (``www.example.org``, with paths);
  * a few emoticons; XML tags and entities; hashtags and mentions
    (whose lone ``#``/``@`` take the force-emit path);
  * punctuation as single-character tokens; sentence-final ``.!?…``
    runs end with a token bound into a state whose only arc is a
    second token bound — the double bound that marks a sentence end;
  * whitespace and newline as nontoken arcs of the root; ``\\x04``
    (EOT) as a root self-arc; the unknown and identity symbols;
  * a backtick state: `` ` `` is dropped like whitespace into a state
    with a token bound whose EOT arc stays there, so a document ending
    in `` `\\x04`` hands its successor a non-root entry context (the
    published DE model has such EOT arcs; they drive the pipeline's
    chain-repair path).

Profiles with ``eot_symbol=False`` leave ``\\x04`` out of sigma; it
then rides the identity arc, like the reference's ``simpletok`` test
model, and streams cannot be split at EOT.

Assumed against the real DE grammar (BASELINE.md:18): the state count
is met by the size of the abbreviation trie (18,400 states ± 5 %), the
symbol count by the alphabet (171 = 3 specials + 167 characters + the
final pseudo-symbol column); clitics, the word-list driven splits
(``de/split.txt``) and the lower-case rules after a period are not
modelled; the trie is not minimised as foma would minimise it.  None
of this touches the runtime contract: ground truth for every engine
is parity with :mod:`datok.runtime.oracle`.

Build the models with ``python -m datok.fsa.synth`` (all profiles)
or let :func:`model_path` build one on first use; files land in
``build/grammars/`` at the repository root, beside a ``.stamp`` that
hashes the sources they were built from (a stale build is rebuilt).
"""

from __future__ import annotations

import argparse
import fcntl
import hashlib
import os
import random
import sys
import time
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

from .automaton import Automaton, Edge

# ---------------------------------------------------------------------------
# Alphabet: 167 characters → symbol ids 4..170 (1-3 are ε/unknown/identity)
# ---------------------------------------------------------------------------

EPS, UNKNOWN, IDENTITY = 1, 2, 3

WS = " \t\n\r"
EOT = "\x04"
ASCII_LOWER = "abcdefghijklmnopqrstuvwxyz"
ASCII_UPPER = ASCII_LOWER.upper()
DIGITS = "0123456789"
GERMAN = "äöüÄÖÜß"
LATIN = "àáâçèéêëíîïñóôøùúûœåæÀÁÇÈÉÊÎÑÓÔØÚŒ"
ASCII_PUNCT = "".join(
    chr(c) for c in range(0x21, 0x7F) if not chr(c).isalnum()
)
TYPO = "„“”‚‘’«»‹›–—…€£¥§°²³µ½×·•¿¡"
ALPHABET = WS + EOT + ASCII_LOWER + ASCII_UPPER + DIGITS + GERMAN + LATIN \
    + ASCII_PUNCT + TYPO
assert len(ALPHABET) == len(set(ALPHABET)) == 167
LETTERS = ASCII_LOWER + ASCII_UPPER + GERMAN + LATIN
SENT_FINAL = ".!?…"
URL_CHARS = ASCII_LOWER + ASCII_UPPER + DIGITS + "-._~:/?#[]@!$&'()*+,;=%"
URL_TRAIL = ".,;:!?)'"  # a URL does not end on these
LABEL = ASCII_LOWER + ASCII_UPPER + DIGITS + "-"
EMAIL_LOCAL = ASCII_LOWER + ASCII_UPPER + DIGITS + "._-+"
TAG_BODY = "".join(
    c for c in ALPHABET if c not in "<>\n\r" + EOT
)


EMOTICONS = (
    ":)", ":-)", ";)", ";-)", ":(", ":-(", ":D", ":-D", ":P", ":-P",
    ":'(", "^^", "^_^", "T_T", "T__T", "<3", "o.O", "O_o", ":-*", ":/",
)
XML_TAGS = ("b", "i", "p", "s", "em", "div", "span", "a", "br", "text")
ENTITIES = ("&quot;", "&amp;", "&lt;", "&gt;", "&nbsp;", "&#8211;", "&#39;")
SCHEMES = ("http", "https", "ftp")
TLDS = ("de", "org", "com", "net", "eu", "at", "ch", "info", "io")
# characters outside the alphabet: the identity/unknown paths
OOV_CHARS = "😀🙂👍→✓Жжλπ東京ĳſ\x07"


@dataclass(frozen=True)
class Profile:
    name: str
    n_abbrev: int
    n_words: int
    abbrev_len: Tuple[int, int]  # letters per single-part abbreviation
    multi_part: float  # share of "z.B."-style entries
    seed: int = 0
    eot_symbol: bool = True  # \x04 in sigma, plus the backtick state


PROFILES: Dict[str, Profile] = {
    # stands in for tokenizer_de.matok: 18,400 states × 171 symbols
    "synth_de18k": Profile("synth_de18k", 5400, 4000, (2, 6), 0.12),
    # stands in for tokenizer_en.matok (14,768 × 172): another seed and
    # vocabulary at the same construction
    "synth_en15k": Profile("synth_en15k", 3750, 3000, (2, 7), 0.12, seed=1),
    # a few hundred states, for fast tests
    "synth_small": Profile("synth_small", 60, 300, (2, 5), 0.15, seed=2),
    # synth_small without \x04 in sigma (EOT rides the identity arc)
    "synth_simple": Profile("synth_simple", 60, 300, (2, 5), 0.15, seed=2,
                            eot_symbol=False),
}


# ---------------------------------------------------------------------------
# Vocabulary
# ---------------------------------------------------------------------------

_ONSETS = ("b", "d", "f", "g", "h", "k", "l", "m", "n", "p", "r", "s",
           "t", "w", "z", "sch", "st", "br", "tr", "gr", "kl", "pf", "sp",
           "ch", "fr", "bl", "v", "j")
_NUCLEI = ("a", "e", "i", "o", "u", "ä", "ö", "ü", "ei", "au", "ie", "eu",
           "e", "a", "é")
_CODAS = ("", "", "n", "r", "s", "t", "ch", "ng", "l", "m", "ß", "st",
          "nd", "rt", "ck", "tz")


_ASCIIFY = str.maketrans({"ä": "a", "ö": "o", "ü": "u", "ß": "ss", "é": "e"})


@dataclass
class Vocabulary:
    words: List[str]
    abbrevs: List[str]
    domains: List[str]


def _word(rng: random.Random) -> str:
    n = rng.choice((1, 2, 2, 3, 3, 4))
    w = "".join(
        rng.choice(_ONSETS) + rng.choice(_NUCLEI) + rng.choice(_CODAS)
        for _ in range(n)
    )
    return w.capitalize() if rng.random() < 0.4 else w


def _abbrev(rng: random.Random, prof: Profile) -> str:
    if rng.random() < prof.multi_part:
        parts = rng.choice((2, 2, 3))
        return "".join(
            "".join(rng.choice(ASCII_LOWER + GERMAN[:3]) for _ in
                    range(rng.choice((1, 1, 2)))) + "."
            for _ in range(parts)
        )
    lo, hi = prof.abbrev_len
    n = rng.randint(lo, hi)
    s = "".join(rng.choice(ASCII_LOWER + "äöüß") for _ in range(n))
    if rng.random() < 0.5:
        s = s[0].upper() + s[1:]
    return s + "."


def vocabulary(prof: Profile) -> Vocabulary:
    rng = random.Random(f"vocab/{prof.name}/{prof.seed}")
    words = sorted({_word(rng) for _ in range(prof.n_words * 2)})
    rng.shuffle(words)
    words = words[: prof.n_words]
    abbrevs: set = set()
    while len(abbrevs) < prof.n_abbrev:
        abbrevs.add(_abbrev(rng, prof))
    abbrevs = sorted(abbrevs)
    domains = sorted({
        rng.choice(("www.", "", "")) + _word(rng).lower().translate(_ASCIIFY)
        + "." + rng.choice(TLDS)
        for _ in range(64)
    })
    return Vocabulary(words, abbrevs, domains)


# ---------------------------------------------------------------------------
# Component NFA and subset construction
# ---------------------------------------------------------------------------


class _Nfa:
    """Union of small per-component DFAs over symbol ids.

    ``acc[s]`` is None (not accepting), "R" (token bound back to the
    root) or "P" (token bound into the sentence-end state).  ``sym``
    maps the alphabet's characters to symbol ids."""

    def __init__(self, sym: Dict[str, int]) -> None:
        self.sym = sym
        self.trans: List[Dict[int, set]] = []
        self.acc: List[Optional[str]] = []

    def state(self, acc: Optional[str] = None) -> int:
        self.trans.append({})
        self.acc.append(acc)
        return len(self.trans) - 1

    def arc(self, s: int, chars, t: int) -> None:
        for c in chars:
            sym = c if isinstance(c, int) else self.sym.get(c)
            if sym is not None:
                self.trans[s].setdefault(sym, set()).add(t)

    def word(self, s: int, text: str, acc: Optional[str] = None) -> int:
        """Chain of fresh states spelling ``text`` from ``s``."""
        for c in text:
            t = self.state()
            self.arc(s, c, t)
            s = t
        self.acc[s] = acc
        return s


def _trie(nfa: _Nfa, entries: Sequence[str], acc: str = "R") -> int:
    start = nfa.state()
    nodes: Dict[str, int] = {"": start}
    for e in entries:
        for i in range(1, len(e) + 1):
            p = e[:i]
            if p not in nodes:
                nodes[p] = nfa.state()
                nfa.arc(nodes[p[:-1]], p[-1], nodes[p])
        nfa.acc[nodes[e]] = acc
    return start


def _components(vocab: Vocabulary,
                sym: Dict[str, int]) -> Tuple[_Nfa, List[int]]:
    n = _Nfa(sym)
    starts = []

    # letter words with inner hyphens; unknown chars continue a word
    w0, w1, w2 = n.state(), n.state("R"), n.state()
    n.arc(w0, LETTERS, w1)
    n.arc(w1, LETTERS, w1)
    n.arc(w1, [UNKNOWN], w1)
    n.arc(w1, "-", w2)
    n.arc(w2, LETTERS, w1)
    starts.append(w0)

    starts.append(_trie(n, vocab.abbrevs))
    starts.append(_trie(n, EMOTICONS))

    # numbers: 12 | 3. | 3.5 | 5.9.2018 | 1.000.000 | 3,50 | 14:30 | 50%
    n0, n1, n2, n3 = n.state(), n.state("R"), n.state("R"), n.state("R")
    n4, n5, n6, n7, n8 = (n.state(), n.state("R"), n.state(), n.state("R"),
                          n.state("R"))
    n.arc(n0, DIGITS, n1)
    n.arc(n1, DIGITS, n1)
    n.arc(n1, ".", n2)
    n.arc(n2, DIGITS, n3)
    n.arc(n3, DIGITS, n3)
    n.arc(n3, ".", n2)
    n.arc(n1, ",", n4)
    n.arc(n4, DIGITS, n5)
    n.arc(n5, DIGITS, n5)
    n.arc(n1, ":", n6)
    n.arc(n6, DIGITS, n7)
    n.arc(n7, DIGITS, n7)
    for s in (n1, n3, n5):
        n.arc(s, "%", n8)
    starts.append(n0)

    # URL bodies: accept unless the last char is trailing punctuation
    u_ok, u_p = n.state("R"), n.state()
    for s in (u_ok, u_p):
        n.arc(s, [c for c in URL_CHARS if c not in URL_TRAIL], u_ok)
        n.arc(s, URL_TRAIL, u_p)
    sch = n.state()
    for scheme in SCHEMES:
        end = n.word(sch, scheme)
        n.arc(n.word(end, ":/"), "/", u_ok)
    starts.append(sch)

    # domains (label.label+, last label ≥ 2 chars), then an optional path
    ds, dl0, dd, dl1, dl2 = (n.state(), n.state(), n.state(), n.state(),
                             n.state("R"))
    n.arc(ds, LABEL, dl0)
    n.arc(dl0, LABEL, dl0)
    n.arc(dl0, ".", dd)
    n.arc(dd, LABEL, dl1)
    n.arc(dl1, LABEL, dl2)
    n.arc(dl2, LABEL, dl2)
    n.arc(dl1, ".", dd)
    n.arc(dl2, ".", dd)
    n.arc(dl2, "/", u_ok)
    starts.append(ds)

    # e-mail: local@domain
    e0, e1, ea = n.state(), n.state(), n.state()
    n.arc(e0, EMAIL_LOCAL, e1)
    n.arc(e1, EMAIL_LOCAL, e1)
    n.arc(e1, "@", ea)
    n.arc(ea, LABEL, dl0)
    starts.append(e0)

    # XML tags <b>, </span>, <a href="x">, <br/>
    x0, x1, x2, x3, x4, x5 = (n.state(), n.state(), n.state(), n.state(),
                              n.state(), n.state("R"))
    n.arc(x0, "<", x1)
    n.arc(x1, "/", x2)
    n.arc(x1, ASCII_LOWER + ASCII_UPPER, x3)
    n.arc(x2, ASCII_LOWER + ASCII_UPPER, x3)
    n.arc(x3, ASCII_LOWER + ASCII_UPPER + DIGITS + "-_:", x3)
    n.arc(x3, " /", x4)
    n.arc(x4, [c for c in TAG_BODY if c != ">"], x4)
    n.arc(x3, ">", x5)
    n.arc(x4, ">", x5)
    starts.append(x0)

    # entities &quot; &#8211;
    a0, a1, a2, a3, a4, a5 = (n.state(), n.state(), n.state(), n.state(),
                              n.state(), n.state("R"))
    n.arc(a0, "&", a1)
    n.arc(a1, ASCII_LOWER + ASCII_UPPER, a2)
    n.arc(a2, ASCII_LOWER + ASCII_UPPER + DIGITS, a2)
    n.arc(a2, ";", a5)
    n.arc(a1, "#", a3)
    n.arc(a3, DIGITS, a4)
    n.arc(a4, DIGITS, a4)
    n.arc(a4, ";", a5)
    starts.append(a0)

    # hashtags and mentions: a lone # or @ has no token bound
    h0, h1, h2 = n.state(), n.state(), n.state("R")
    n.arc(h0, "#@", h1)
    n.arc(h1, LETTERS + DIGITS + "_", h2)
    n.arc(h2, LETTERS + DIGITS + "_", h2)
    starts.append(h0)

    # punctuation: single-char tokens; sentence-final runs end in P
    p0, p1, pf = n.state(), n.state("R"), n.state("P")
    singles = [c for c in ASCII_PUNCT + TYPO if c not in SENT_FINAL + "#@`"]
    n.arc(p0, singles, p1)
    n.arc(p0, SENT_FINAL, pf)
    n.arc(pf, SENT_FINAL, pf)
    starts.append(p0)

    # characters outside the alphabet: one token each
    q0, q1 = n.state(), n.state("R")
    n.arc(q0, [IDENTITY, UNKNOWN], q1)
    starts.append(q0)
    return n, starts


def _determinize(nfa: _Nfa, starts: Sequence[int],
                 eot_symbol: bool) -> Automaton:
    """Subset construction; DFA state 1 is the root, 2 the sentence-end
    state, 3 the backtick state, subsets follow in breadth-first order
    over sorted symbols."""
    chars = nfa.sym
    final = len(chars) + 4  # 0 unused, 1-3 specials, characters, final
    root = frozenset(starts)
    ids: Dict[FrozenSet[int], int] = {root: 1}
    order: List[FrozenSet[int]] = [root]
    arcs: List[Dict[int, int]] = []
    qi = 0
    while qi < len(order):
        sub = order[qi]
        qi += 1
        merged: Dict[int, set] = {}
        for s in sorted(sub):
            for sym, tgts in nfa.trans[s].items():
                merged.setdefault(sym, set()).update(tgts)
        out = {}
        for sym in sorted(merged):
            key = frozenset(merged[sym])
            t = ids.get(key)
            if t is None:
                t = ids[key] = len(order) + 3  # ids 2, 3: P, backtick
                order.append(key)
            out[sym] = t
        arcs.append(out)

    S = len(order) + 2
    auto = Automaton()
    auto.epsilon, auto.unknown, auto.identity = EPS, UNKNOWN, IDENTITY
    auto.final = final
    auto.sigma_count = final
    auto.sigma_rev = {i: c for c, i in chars.items()}
    auto.state_count = S
    auto.transitions = [None] * (S + 1)
    for k, sub in enumerate(order):
        sid = 1 if k == 0 else k + 3
        tr = {sym: Edge(sym, sym, t) for sym, t in arcs[k].items()}
        labels = {nfa.acc[s] for s in sub if nfa.acc[s]}
        if labels:
            tgt = 2 if labels == {"P"} else 1
            tr[EPS] = Edge(EPS, 0, tgt, tokenend=True)
        auto.transitions[sid] = tr
    root_tr = auto.transitions[1]
    for c in WS + EOT:
        if c in chars:
            root_tr[chars[c]] = Edge(chars[c], 0, 1, nontoken=True)
    root_tr[final] = Edge(0, 0, 0)
    auto.transitions[2] = {
        EPS: Edge(EPS, 0, 1, tokenend=True),
        final: Edge(0, 0, 0),
    }
    if eot_symbol:
        bq = {EPS: Edge(EPS, 0, 1, tokenend=True)}
        for c in "`" + EOT:
            bq[chars[c]] = Edge(chars[c], 0, 3, nontoken=True)
        root_tr[chars["`"]] = Edge(chars["`"], 0, 3, nontoken=True)
        auto.transitions[3] = bq
    else:
        # unreachable placeholder keeps the numbering of both variants
        auto.transitions[3] = {}
    auto.arc_count = sum(len(t) for t in auto.transitions if t)
    return auto


def build_automaton(profile: str) -> Tuple[Automaton, Vocabulary]:
    prof = PROFILES[profile]
    vocab = vocabulary(prof)
    alphabet = ALPHABET if prof.eot_symbol else ALPHABET.replace(EOT, "")
    sym = {c: i + 4 for i, c in enumerate(alphabet)}
    nfa, starts = _components(vocab, sym)
    return _determinize(nfa, starts, prof.eot_symbol), vocab


# ---------------------------------------------------------------------------
# Built model files
# ---------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
BUILD_DIR = os.path.join(ROOT, "build", "grammars")


# sources whose edits change the built files: this generator and the
# automaton, matrix, double-array and gzip serializers
_STAMP_SOURCES = ("synth.py", "automaton.py", "matrix.py",
                  "double_array.py", "io.py")


def build_stamp(profile: str) -> str:
    """Hash of the profile and of every source the built files depend
    on; a build whose stamp differs is stale."""
    h = hashlib.sha256(repr(PROFILES[profile]).encode())
    here = os.path.dirname(os.path.abspath(__file__))
    for name in _STAMP_SOURCES:
        with open(os.path.join(here, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()


def is_current(profile: str, build_dir: str = BUILD_DIR) -> bool:
    """Whether ``profile``'s ``.matok`` and ``.datok`` exist in
    ``build_dir`` and were built from the present sources."""
    base = os.path.join(build_dir, profile)
    if not all(os.path.exists(f"{base}.{k}") for k in ("matok", "datok")):
        return False
    try:
        with open(f"{base}.stamp") as f:
            return f.read().strip() == build_stamp(profile)
    except OSError:
        return False


def model_path(profile: str, kind: str = "matok",
               build_dir: str = BUILD_DIR) -> str:
    """Path of the built ``.matok``/``.datok`` for ``profile``, building
    it (and its sibling) first if absent or stale (see
    :func:`is_current`).  Concurrent callers (test workers) serialize on
    a lock file; the writes are atomic."""
    if kind not in ("matok", "datok"):
        raise ValueError(f"unknown model kind {kind!r}")
    PROFILES[profile]  # KeyError for unknown profiles
    path = os.path.join(build_dir, f"{profile}.{kind}")
    if is_current(profile, build_dir):
        return path
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, ".lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if not is_current(profile, build_dir):
                build_models(profile, build_dir, verbose=False)
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)
    return path


def build_models(profile: str, build_dir: str = BUILD_DIR,
                 verbose: bool = True) -> dict:
    """Build ``<profile>.matok`` and ``<profile>.datok``; returns the
    shape and the seconds each stage took."""
    from .double_array import DaTokenizer
    from .matrix import MatrixTokenizer

    os.makedirs(build_dir, exist_ok=True)
    t0 = time.perf_counter()
    auto, _ = build_automaton(profile)
    t1 = time.perf_counter()
    mat = MatrixTokenizer.from_automaton(auto)
    _atomic_save(mat, os.path.join(build_dir, f"{profile}.matok"))
    t2 = time.perf_counter()
    dat = DaTokenizer.from_automaton(auto)
    _atomic_save(dat, os.path.join(build_dir, f"{profile}.datok"))
    t3 = time.perf_counter()
    stamp = os.path.join(build_dir, f"{profile}.stamp")
    with open(f"{stamp}.{os.getpid()}.tmp", "w") as f:
        f.write(build_stamp(profile) + "\n")
    os.replace(f"{stamp}.{os.getpid()}.tmp", stamp)
    info = {
        "profile": profile,
        "states": mat.state_count,
        "symbols": len(mat.array) // (mat.state_count + 1),
        "matrix_bytes": int(mat.array.nbytes),
        "da_cells": len(dat.base),
        "automaton_s": round(t1 - t0, 3),
        "matok_s": round(t2 - t1, 3),
        "datok_s": round(t3 - t2, 3),
    }
    if verbose:
        print(f"built {profile}: {info}", file=sys.stderr)
    return info


def _atomic_save(model, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    model.save(tmp)
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# Texts
# ---------------------------------------------------------------------------


def _token(rng: random.Random, vocab: Vocabulary) -> str:
    r = rng.random()
    if r < 0.70:
        w = rng.choice(vocab.words)
        return w + rng.choice(",,;:") if rng.random() < 0.06 else w
    if r < 0.79:
        return rng.choice(vocab.abbrevs)
    if r < 0.86:
        k = rng.random()
        if k < 0.3:
            return str(rng.randint(0, 9999))
        if k < 0.45:
            return f"{rng.randint(1, 31)}."
        if k < 0.6:
            return f"{rng.randint(1, 28)}.{rng.randint(1, 12)}.{rng.randint(1900, 2030)}"
        if k < 0.75:
            return f"{rng.randint(0, 23)}:{rng.randint(0, 59):02d}"
        if k < 0.9:
            return f"{rng.randint(0, 999)},{rng.randint(0, 99):02d}"
        return f"{rng.randint(0, 100)}%"
    if r < 0.90:
        k = rng.random()
        d = rng.choice(vocab.domains)
        if k < 0.35:
            path = "/".join(rng.choice(vocab.words).lower() for _ in
                            range(rng.randint(0, 3)))
            return f"{rng.choice(SCHEMES)}://{d}/{path}".translate(_ASCIIFY)
        if k < 0.6:
            return d
        local = rng.choice(vocab.words).lower().translate(_ASCIIFY)
        return f"{local}@{d.removeprefix('www.')}"
    if r < 0.93:
        t = rng.choice(XML_TAGS)
        k = rng.random()
        if k < 0.4:
            return f"<{t}>{rng.choice(vocab.words)}</{t}>"
        if k < 0.7:
            return f'<{t} class="{rng.choice(vocab.words)}">'
        return rng.choice(ENTITIES)
    if r < 0.95:
        return rng.choice(EMOTICONS)
    if r < 0.965:
        return rng.choice(("#", "@")) + rng.choice(("", rng.choice(vocab.words)))
    if r < 0.985:
        # out-of-vocabulary: unseen letter strings and foreign scripts
        w = "".join(rng.choice(LETTERS) for _ in range(rng.randint(2, 12)))
        if rng.random() < 0.5:
            i = rng.randint(0, len(w))
            w = w[:i] + rng.choice(OOV_CHARS) + w[i:]
        return w
    return rng.choice(("(", ")", "\"", "„", "“", "'", "–", "-", "/", "«", "»", "`",
                       "§", "€", "*", "+", "…"))


def _sentence(rng: random.Random, vocab: Vocabulary) -> str:
    toks = [_token(rng, vocab) for _ in range(rng.randint(3, 22))]
    end = rng.choice((".", ".", ".", ".", "!", "?", "...", "!!!", "?!",
                      "…", ""))
    if end == "" and rng.random() < 0.5:
        toks.append(rng.choice(vocab.abbrevs))  # abbreviation at the end
    return " ".join(toks) + end


def sentence_pool(profile: str, n: int = 4096, seed: int = 0) -> List[str]:
    """``n`` seeded sentences drawn from ``profile``'s vocabulary."""
    vocab = vocabulary(PROFILES[profile])
    rng = random.Random(f"text/{profile}/{seed}")
    return [_sentence(rng, vocab) for _ in range(n)]


def documents(profile: str, lengths: Sequence[int], seed: int = 0,
              pool: Optional[List[str]] = None) -> List[str]:
    """One document per target length (in characters, approximate: a
    document is whole sentences joined by spaces and newlines, ending
    in ``\\x04``; the result is at least the target long)."""
    pool = pool if pool is not None else sentence_pool(profile, seed=seed)
    rng = np.random.default_rng(seed)
    seps = (" ", " ", " ", "\n", "\n\n")
    lens = np.array([len(s) + 1 for s in pool])
    out = []
    for target in lengths:
        need = max(1, int(target))
        k = max(1, int(need / lens.mean()) + 2)
        idx = rng.integers(0, len(pool), size=k)
        while lens[idx].sum() < need:
            idx = np.concatenate([idx, rng.integers(0, len(pool), size=k)])
        cut = int(np.searchsorted(np.cumsum(lens[idx]), need)) + 1
        sep = rng.integers(0, len(seps), size=cut)
        out.append("".join(pool[i] + seps[j] for i, j in
                           zip(idx[:cut], sep)).rstrip(" ") + EOT)
    return out


def heavy_tail_lengths(n: int, seed: int = 0, median: int = 2000,
                       sigma: float = 1.6, hi: int = 200_000) -> np.ndarray:
    """Seeded log-normal document lengths in [8, hi] (a heavy right
    tail, from a few words to book chapters)."""
    rng = np.random.default_rng(seed)
    x = rng.lognormal(np.log(median), sigma, size=n)
    return np.clip(x, 8, hi).astype(np.int64)


def lane_texts(profile: str, B: int, L: int, seed: int = 0) -> List[str]:
    """``B`` texts of exactly ``L`` characters each (the bench wave):
    one sentence stream cut at ``L``; 2 % of the sentence separators
    (seeded) are ``\\x04`` document boundaries, so EOT runs through the
    device machine too."""
    pool = sentence_pool(profile, seed=seed)
    rng = np.random.default_rng(seed + 1)
    stream_len = B * L
    lens = np.array([len(s) + 1 for s in pool])
    k = int(stream_len / lens.mean() * 1.1) + 16
    idx = rng.integers(0, len(pool), size=k)
    seps = np.where(rng.random(k) < 0.02, EOT, " ")
    text = "".join(pool[i] + s for i, s in zip(idx.tolist(), seps.tolist()))
    while len(text) < stream_len:
        text += text
    return [text[i * L:(i + 1) * L] for i in range(B)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Build the seeded synthetic tokenizer models "
                    "(.matok and .datok) into build/grammars/.")
    p.add_argument("profiles", nargs="*", default=sorted(PROFILES),
                   help=f"profiles to build (default: all of "
                        f"{', '.join(sorted(PROFILES))})")
    p.add_argument("--out", default=BUILD_DIR, help="output directory")
    args = p.parse_args(argv)
    for name in args.profiles:
        if name not in PROFILES:
            p.error(f"unknown profile {name!r}")
        build_models(name, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
