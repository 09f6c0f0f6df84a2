"""METEOR — all four METEOR-1.5 matcher stages with chunk-minimizing
alignment.

The reference computes METEOR through the nlg_eval submodule's Java
METEOR-1.5 jar (reference utils/__init__.py:2, train_iq.py:41, 196, 236).
This is an offline-buildable re-implementation of that scorer's algorithm:

- matcher stages: EXACT (weight 1.0), STEM (0.6, in-repo Porter stemmer
  below), SYNONYM (0.8 — shared-synset match against a pluggable table;
  the vendored minimal table lives in train/meteor_data.py because the
  WordNet corpus cannot ship in this image), and PARAPHRASE (0.6 —
  multi-word span matches against a pluggable paraphrase table).  Every
  vendored-table match is one the jar would also fire, so the remaining
  delta vs the jar is one-sided (ours ≤ jar's where its bigger tables
  fire; quantified in tests/test_meteor.py + PARITY.md §2.3 #22).
- alignment: the jar's Aligner semantics — a one-to-one matching (over
  token SPANS; singles for exact/stem/synonym) chosen by beam search to
  (1) maximize covered words, then (2) MINIMIZE CHUNKS, then (3) minimize
  the sum of absolute match-position distances.  (The previous
  "METEOR-lite" used greedy left-to-right alignment, which over-counts
  chunks; regression cases live in tests/test_meteor.py.)
- parameters: the jar's English defaults — alpha=0.85, beta=0.2,
  gamma=0.6, delta=0.75 (content-vs-function word weight; function-word
  list embedded below, approximating the jar's ``function/en.words``).
- aggregation: corpus score from summed sufficient statistics (micro
  average), per-segment best reference — exactly the jar's test-set score,
  NOT a mean of segment scores.  With phrase matches the hyp- and ref-side
  matched word counts can differ; fragmentation uses their average,
  as the jar does.
- perfect-alignment special case: a single chunk that covers BOTH strings
  entirely carries zero fragmentation (identical segments score exactly
  1.0); with the 1.5-tuned beta=0.2/gamma=0.6 the penalty curve is steep
  enough that, without this case, even a verbatim hypothesis would be
  penalized ~40%.

Stemming note: the jar stems with Snowball English (Porter2); this module
implements the classic Porter (1980) algorithm in-repo (golden-tested
against nltk's ORIGINAL_ALGORITHM mode).  The two differ on a small set of
suffix classes; both map inflectional variants (plural/tense) identically,
which is what the STEM stage exists for.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

# jar English defaults (meteor-1.5 Parameters for -l en)
ALPHA = 0.85
BETA = 0.2
GAMMA = 0.6
DELTA = 0.75
W_EXACT = 1.0
W_STEM = 0.6
W_SYN = 0.8
W_PAR = 0.6
BEAM = 40  # the jar Aligner's beam width
MAX_PHRASE = 5  # longest phrase considered by the PARAPHRASE stage

# Approximation of meteor-1.5's function/en.words (common closed-class
# English words; the jar derives its list from corpus frequency).
FUNCTION_WORDS = frozenset("""
a an the this that these those some any each every no all both few many
much more most other another such what which who whom whose i you he she
it we they me him her us them my your his its our their mine yours hers
ours theirs myself yourself himself herself itself ourselves yourselves
themselves and or but nor so yet for if because although though while
whereas unless until when whenever where wherever after before since as
than whether not never also too very quite rather just only even still
about above across against along among around at behind below beneath
beside between beyond by down during except from in inside into like near
of off on onto out outside over past through to toward towards under
until up upon with within without am is are was were be been being have
has had having do does did doing will would shall should may might must
can could there here then now how why 's 't n't '' `` ' " . , ? ! ; :
""".split())


# --------------------------------------------------------------- stemmer
_VOWELS = "aeiou"


def _is_cons(word: str, i: int) -> bool:
    ch = word[i]
    if ch in _VOWELS:
        return False
    if ch == "y":
        return i == 0 or not _is_cons(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """Porter's m: number of VC sequences in [C](VC)^m[V]."""
    forms = []
    for i in range(len(stem)):
        forms.append("c" if _is_cons(stem, i) else "v")
    collapsed = []
    for f in forms:
        if not collapsed or collapsed[-1] != f:
            collapsed.append(f)
    return "".join(collapsed).count("vc")


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(word: str) -> bool:
    return (len(word) >= 2 and word[-1] == word[-2]
            and _is_cons(word, len(word) - 1))


def _cvc(word: str) -> bool:
    """*o: stem ends cvc where the final c is not w, x or y."""
    if len(word) < 3:
        return False
    return (_is_cons(word, len(word) - 3)
            and not _is_cons(word, len(word) - 2)
            and _is_cons(word, len(word) - 1)
            and word[-1] not in "wxy")


def porter_stem(word: str) -> str:
    """Classic Porter (1980) stemmer — the in-repo STEM stage."""
    if len(word) <= 2 or not word.isalpha():
        return word
    w = word

    # Step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]

    # Step 1b
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    else:
        flag = False
        if w.endswith("ed") and _has_vowel(w[:-2]):
            w, flag = w[:-2], True
        elif w.endswith("ing") and _has_vowel(w[:-3]):
            w, flag = w[:-3], True
        if flag:
            if w.endswith(("at", "bl", "iz")):
                w += "e"
            elif _ends_double_cons(w) and not w.endswith(("l", "s", "z")):
                w = w[:-1]
            elif _measure(w) == 1 and _cvc(w):
                w += "e"

    # Step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"

    # Step 2
    step2 = [("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
             ("anci", "ance"), ("izer", "ize"), ("abli", "able"),
             ("alli", "al"), ("entli", "ent"), ("eli", "e"),
             ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
             ("ator", "ate"), ("alism", "al"), ("iveness", "ive"),
             ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"),
             ("iviti", "ive"), ("biliti", "ble")]
    for suf, rep in step2:
        if w.endswith(suf):
            if _measure(w[:-len(suf)]) > 0:
                w = w[:-len(suf)] + rep
            break

    # Step 3
    step3 = [("icate", "ic"), ("ative", ""), ("alize", "al"),
             ("iciti", "ic"), ("ical", "ic"), ("ful", ""), ("ness", "")]
    for suf, rep in step3:
        if w.endswith(suf):
            if _measure(w[:-len(suf)]) > 0:
                w = w[:-len(suf)] + rep
            break

    # Step 4
    step4 = ["al", "ance", "ence", "er", "ic", "able", "ible", "ant",
             "ement", "ment", "ent", "ou", "ism", "ate", "iti", "ous",
             "ive", "ize"]
    # longest-suffix-first ordering matters ("ement" before "ment"/"ent")
    for suf in sorted(step4, key=len, reverse=True):
        if w.endswith(suf):
            stem = w[:-len(suf)]
            if _measure(stem) > 1:
                w = stem
            break
    else:
        if w.endswith("ion") and _measure(w[:-3]) > 1 and w[-4] in "st":
            w = w[:-3]

    # Step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _cvc(stem)):
            w = stem

    # Step 5b
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]
    return w


# ------------------------------------------------- pluggable stage tables
_DEFAULT_SYN: Optional[Dict[str, frozenset]] = None
_DEFAULT_PAR: Optional[Dict[tuple, tuple]] = None


def build_synonym_map(groups) -> Dict[str, frozenset]:
    """word → frozenset of group ids; SYNONYM-match = shared group
    (= shared WordNet synset in the jar)."""
    by_word: Dict[str, set] = {}
    for gid, group in enumerate(groups):
        for w in group:
            by_word.setdefault(w, set()).add(gid)
    return {w: frozenset(g) for w, g in by_word.items()}


def build_paraphrase_map(pairs) -> Dict[tuple, tuple]:
    """phrase-tuple → tuple of equivalent phrase-tuples (symmetric +
    transitive closure within each listed pair; phrases whitespace-split)."""
    by_phrase: Dict[tuple, set] = {}
    for a, b in pairs:
        ta, tb = tuple(a.split()), tuple(b.split())
        by_phrase.setdefault(ta, set()).add(tb)
        by_phrase.setdefault(tb, set()).add(ta)
    return {k: tuple(sorted(v)) for k, v in by_phrase.items()}


def _default_tables():
    global _DEFAULT_SYN, _DEFAULT_PAR
    if _DEFAULT_SYN is None:
        from blt_vqg_tpu_torch.train.meteor_data import (PARAPHRASES,
                                                   SYNONYM_GROUPS)
        _DEFAULT_SYN = build_synonym_map(SYNONYM_GROUPS)
        _DEFAULT_PAR = build_paraphrase_map(PARAPHRASES)
    return _DEFAULT_SYN, _DEFAULT_PAR


# -------------------------------------------------------------- aligner
def _match_stages(hyp: Sequence[str], ref: Sequence[str],
                  syn_map: Optional[Dict[str, frozenset]],
                  par_map: Optional[Dict[tuple, tuple]]
                  ) -> List[List[Tuple[int, float, int, int]]]:
    """cands[i] = [(j, stage_weight, hyp_len, ref_len)] for matches whose
    hyp span STARTS at i; best stage per identical span pair (EXACT shadows
    STEM shadows SYNONYM; PARAPHRASE contributes the multi-word spans)."""
    ref_stems = [porter_stem(r) for r in ref]
    hyp_stems = [porter_stem(h) for h in hyp]
    cands: List[List[Tuple[int, float, int, int]]] = []
    for i, h in enumerate(hyp):
        row: List[Tuple[int, float, int, int]] = []
        for j, r in enumerate(ref):
            if h == r:
                row.append((j, W_EXACT, 1, 1))
            elif hyp_stems[i] == ref_stems[j]:
                row.append((j, W_STEM, 1, 1))
            elif (syn_map is not None
                  and syn_map.get(h, frozenset())
                  & syn_map.get(r, frozenset())):
                row.append((j, W_SYN, 1, 1))
        cands.append(row)
    if par_map:
        # phrase spans: hyp[i:i+lh] vs every ref occurrence of a listed
        # equivalent; 1:1 single-word pairs already covered above keep
        # their higher-stage weight (skip duplicates)
        singles = {(i, c[0]) for i, r in enumerate(cands) for c in r}
        for i in range(len(hyp)):
            for lh in range(1, min(MAX_PHRASE, len(hyp) - i) + 1):
                ph = tuple(hyp[i:i + lh])
                for pr in par_map.get(ph, ()):
                    lr = len(pr)
                    for j in range(len(ref) - lr + 1):
                        if tuple(ref[j:j + lr]) != pr:
                            continue
                        if lh == 1 and lr == 1 and (i, j) in singles:
                            continue
                        cands[i].append((j, W_PAR, lh, lr))
    return cands


def align(hyp: Sequence[str], ref: Sequence[str],
          syn_map: Optional[Dict[str, frozenset]] = None,
          par_map: Optional[Dict[tuple, tuple]] = None
          ) -> List[Tuple[int, int, float, int, int]]:
    """One-to-one span alignment [(hyp_i, ref_j, stage_weight, hyp_len,
    ref_len)] — beam search per the jar's Aligner: maximize covered words,
    then minimize chunks, then minimize the summed |i-j| distance.
    Processed as a DP over hyp positions so multi-word (paraphrase) spans
    advance the position by their length."""
    cands = _match_stages(hyp, ref, syn_map, par_map)
    n = len(hyp)

    # state: (covered, chunks, dist, used_ref_frozenset, last_ends, pairs)
    # covered = hyp+ref matched word count; ranked by (-covered, chunks,
    # dist, -stage_weight_sum)
    start = (0, 0, 0, frozenset(), None, ())
    beams: List[List[tuple]] = [[] for _ in range(n + 1)]
    beams[0] = [start]

    def prune(states):
        states.sort(key=lambda s: (-s[0], s[1], s[2],
                                   -sum(p[2] for p in s[5])))
        seen = set()
        out = []
        for s in states:
            key = (s[3], s[4])
            if key in seen:
                continue
            seen.add(key)
            out.append(s)
            if len(out) >= BEAM:
                break
        return out

    for i in range(n):
        if not beams[i]:
            continue
        beams[i] = prune(beams[i])
        for covered, chunks, dist, used, last, pairs in beams[i]:
            # skip hyp[i]
            beams[i + 1].append((covered, chunks, dist, used, last, pairs))
            for j, w, lh, lr in cands[i]:
                span = frozenset(range(j, j + lr))
                if span & used:
                    continue
                contiguous = (last is not None
                              and last[0] == i and last[1] == j)
                beams[i + lh].append((
                    covered + lh + lr,
                    chunks + (0 if contiguous else 1),
                    dist + abs(i - j),
                    used | span, (i + lh, j + lr),
                    pairs + ((i, j, w, lh, lr),)))
    best = prune(beams[n])[0]
    return list(best[5])


# -------------------------------------------------------------- scoring
class _Stats:
    """Sufficient statistics of one segment-reference pair (micro-
    aggregated across the corpus, like the jar's test-set score)."""

    __slots__ = ("p_num", "p_den", "r_num", "r_den", "chunks", "matches")

    def __init__(self, p_num=0.0, p_den=0.0, r_num=0.0, r_den=0.0,
                 chunks=0.0, matches=0.0):
        self.p_num, self.p_den = p_num, p_den
        self.r_num, self.r_den = r_num, r_den
        self.chunks, self.matches = chunks, matches

    def add(self, other: "_Stats") -> None:
        self.p_num += other.p_num
        self.p_den += other.p_den
        self.r_num += other.r_num
        self.r_den += other.r_den
        self.chunks += other.chunks
        self.matches += other.matches

    def score(self) -> float:
        if self.p_den == 0 or self.r_den == 0:
            return 0.0
        p = self.p_num / self.p_den
        r = self.r_num / self.r_den
        if p == 0.0 or r == 0.0:
            return 0.0
        fmean = p * r / (ALPHA * p + (1 - ALPHA) * r)
        frag = (self.chunks / self.matches) if self.matches else 0.0
        penalty = GAMMA * (frag ** BETA) if self.chunks > 0 else 0.0
        return fmean * (1.0 - penalty)


def _content_weight(tok: str) -> float:
    return DELTA if tok.lower() not in FUNCTION_WORDS else 1.0 - DELTA


def _segment_stats(hyp: Sequence[str], ref: Sequence[str],
                   syn_map=None, par_map=None) -> _Stats:
    pairs = align(hyp, ref, syn_map, par_map)
    st = _Stats()
    st.p_den = sum(_content_weight(t) for t in hyp)
    st.r_den = sum(_content_weight(t) for t in ref)
    st.p_num = sum(w * sum(_content_weight(t) for t in hyp[i:i + lh])
                   for i, _, w, lh, _lr in pairs)
    st.r_num = sum(w * sum(_content_weight(t) for t in ref[j:j + lr])
                   for _, j, w, _lh, lr in pairs)
    mh = sum(p[3] for p in pairs)
    mr = sum(p[4] for p in pairs)
    # with phrase matches the two sides' matched word counts may differ;
    # fragmentation uses their average (the jar's Stats.avgMatches)
    st.matches = (mh + mr) / 2.0
    # chunk count from the chosen alignment (contiguity in both strings,
    # in hyp order — matches the aligner's chunk definition; spans are
    # contiguous when they abut end-to-start on both sides)
    chunks = 0
    last = None
    for i, j, _w, lh, lr in sorted(pairs):
        if not (last is not None and i == last[0] and j == last[1]):
            chunks += 1
        last = (i + lh, j + lr)
    # a perfectly contiguous full alignment carries no fragmentation
    st.chunks = 0.0 if (chunks == 1 and mh == len(hyp) and mr == len(ref)
                        ) else float(chunks)
    return st


def meteor(refs_per_hyp: List[List[List[str]]],
           hyps: List[List[str]],
           synonyms=None, paraphrases=None) -> float:
    """Corpus METEOR: per segment the best-scoring reference's statistics
    enter the micro-aggregate; final score from the summed statistics.

    ``synonyms`` / ``paraphrases`` override the vendored stage tables
    (train/meteor_data.py): pass the output of ``build_synonym_map`` /
    ``build_paraphrase_map``, or ``False`` to disable that stage (the
    exact+stem-only scorer of rounds ≤3)."""
    syn_map, par_map = _resolve_tables(synonyms, paraphrases)
    total = _Stats()
    for refs, hyp in zip(refs_per_hyp, hyps):
        best_st, best_sc = None, -1.0
        for r in refs:
            st = _segment_stats(hyp, r, syn_map, par_map)
            sc = st.score()
            if sc > best_sc:
                best_st, best_sc = st, sc
        if best_st is not None:
            total.add(best_st)
    return total.score()


def _resolve_tables(synonyms, paraphrases):
    d_syn, d_par = _default_tables()
    syn_map = (None if synonyms is False
               else (synonyms if synonyms is not None else d_syn))
    par_map = (None if paraphrases is False
               else (paraphrases if paraphrases is not None else d_par))
    return syn_map, par_map


def meteor_sentence(hyp: Sequence[str], ref: Sequence[str],
                    synonyms=None, paraphrases=None) -> float:
    """Single segment-pair score (for tests/goldens)."""
    syn_map, par_map = _resolve_tables(synonyms, paraphrases)
    return _segment_stats(hyp, ref, syn_map, par_map).score()
