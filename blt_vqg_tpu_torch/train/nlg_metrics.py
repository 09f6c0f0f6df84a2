"""In-repo NLG metrics: BLEU-1..4, ROUGE-L, CIDEr, METEOR-lite.

Replaces the reference's external ``nlg_eval`` submodule (Java METEOR jar +
pycocoevalcap, reference utils/__init__.py:2, train_iq.py:41, 196) with
self-contained numpy/python implementations pinned to the pycocoevalcap
formulas (fractional golden tests in tests/test_nlg_goldens.py, cross-checked
against nltk/sacrebleu/rouge_score where formulas coincide):

- BLEU-n: corpus-level modified n-gram precision with brevity penalty
  (Papineni et al. 2002).  Matches pycocoevalcap's BleuScorer exactly:
  UNSMOOTHED, with its tiny=1e-15 / small=1e-9 numerical fudges — a zero
  n-gram precision makes the cumulative score collapse to ~0 rather than
  being epsilon-floored;
- ROUGE-L: LCS-based F-measure with beta=1.2, taking max precision and max
  recall *independently* across references (pycocoevalcap Rouge.calc_score);
- CIDEr: TF-IDF n-gram cosine similarity, n=1..4, sigma=6 length-penalty
  Gaussian, using RAW term counts (not length-normalized) and
  ref_len=log(num images), exactly as pycocoevalcap's CiderScorer — with a
  single image the IDF log collapses to 0 and CIDEr is 0 by construction;
- METEOR: the METEOR-1.5 algorithm (train/meteor.py) — all four matcher
  stages (exact 1.0, Porter-stem 0.6, synonym 0.8, paraphrase 0.6),
  chunk-MINIMIZING beam-search alignment over token spans (the jar
  Aligner's objective order), jar-default English parameters (alpha=0.85,
  beta=0.2, gamma=0.6, delta=0.75 content/function weighting), corpus
  score from micro-aggregated statistics.  The synonym/paraphrase stages
  run against PLUGGABLE tables with a vendored minimal table in-repo
  (train/meteor_data.py — WordNet itself cannot ship here); every vendored
  match is one the jar would also fire, so the remaining delta vs the jar
  is one-sided (≤ jar where its bigger tables fire).  The stem stage uses
  classic Porter rather than Snowball English.
- meteor_lite (kept for comparison only): the round-2 greedy exact-match
  approximation with METEOR-1.0-era constants; no longer what the facade
  reports.

API mirrors NLGEval.compute_metrics(ref_list, hyp_list) → dict of floats.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence

_TINY = 1e-15  # pycocoevalcap bleu_scorer numerator fudge
_SMALL = 1e-9  # pycocoevalcap bleu_scorer denominator fudge


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


# ----------------------------------------------------------------- BLEU
def corpus_bleu(refs_per_hyp: List[List[List[str]]],
                hyps: List[List[str]], max_n: int = 4) -> List[float]:
    """Returns [BLEU-1, ..., BLEU-max_n] (cumulative, geometric mean).

    pycocoevalcap-exact: unsmoothed corpus statistics; cumulative BLEU-k is
    (prod_{n<=k} p_n)^(1/k) with p_n = (clipped_n + tiny)/(total_n + small);
    brevity penalty exp(1 - 1/ratio) when ratio=(hyp_len+tiny)/(ref_len+small)
    is < 1, using per-segment *closest* reference length (ties → shorter).
    """
    clipped = [0] * max_n
    totals = [0] * max_n
    hyp_len = 0
    ref_len = 0
    for refs, hyp in zip(refs_per_hyp, hyps):
        hyp_len += len(hyp)
        # closest reference length (ties → shorter), pycocoevalcap 'closest'
        ref_len += min((abs(len(r) - len(hyp)), len(r)) for r in refs)[1]
        for n in range(1, max_n + 1):
            hyp_ng = _ngrams(hyp, n)
            max_ref = Counter()
            for r in refs:
                for ng, c in _ngrams(r, n).items():
                    max_ref[ng] = max(max_ref[ng], c)
            clipped[n - 1] += sum(min(c, max_ref[ng])
                                  for ng, c in hyp_ng.items())
            totals[n - 1] += sum(hyp_ng.values())
    ratio = (hyp_len + _TINY) / (ref_len + _SMALL)
    bp = math.exp(1 - 1 / ratio) if ratio < 1 else 1.0
    out = []
    prod = 1.0
    for n in range(1, max_n + 1):
        prod *= (clipped[n - 1] + _TINY) / (totals[n - 1] + _SMALL)
        out.append(bp * prod ** (1.0 / n))
    return out


# --------------------------------------------------------------- ROUGE-L
def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[-1]


def rouge_l(refs_per_hyp: List[List[List[str]]], hyps: List[List[str]],
            beta: float = 1.2) -> float:
    """pycocoevalcap Rouge: max precision and max recall are taken
    independently across references, then combined into one F-measure."""
    scores = []
    for refs, hyp in zip(refs_per_hyp, hyps):
        prec_max = 0.0
        rec_max = 0.0
        for r in refs:
            lcs = _lcs_len(r, hyp)
            if lcs == 0:
                continue
            prec_max = max(prec_max, lcs / len(hyp) if hyp else 0.0)
            rec_max = max(rec_max, lcs / len(r) if r else 0.0)
        if prec_max > 0 and rec_max > 0:
            scores.append(((1 + beta ** 2) * prec_max * rec_max)
                          / (rec_max + beta ** 2 * prec_max))
        else:
            scores.append(0.0)
    return sum(scores) / len(scores) if scores else 0.0


# ----------------------------------------------------------------- CIDEr
def cider(refs_per_hyp: List[List[List[str]]], hyps: List[List[str]],
          max_n: int = 4, sigma: float = 6.0) -> float:
    """pycocoevalcap CiderScorer: vec[n][ng] = raw_count * (log(D) - log(df)),
    cosine similarity with min-clipping against the reference vector, Gaussian
    length penalty exp(-(len_h - len_r)^2 / 2σ²), mean over n, ×10."""
    # document frequency: an n-gram counts once per image whose reference
    # set contains it
    df: List[defaultdict] = [defaultdict(float) for _ in range(max_n)]
    for refs in refs_per_hyp:
        for n in range(1, max_n + 1):
            seen = set()
            for r in refs:
                seen.update(_ngrams(r, n).keys())
            for ng in seen:
                df[n - 1][ng] += 1.0
    log_docs = math.log(max(len(refs_per_hyp), 1))

    def tfidf_vec(tokens, n):
        vec = {}
        norm = 0.0
        for ng, c in _ngrams(tokens, n).items():
            idf = log_docs - math.log(max(df[n - 1].get(ng, 0.0), 1.0))
            w = float(c) * idf  # raw count, NOT length-normalized
            vec[ng] = w
            norm += w * w
        return vec, math.sqrt(norm)

    scores = []
    for refs, hyp in zip(refs_per_hyp, hyps):
        score_n = [0.0] * max_n
        for r in refs:
            delta = len(hyp) - len(r)
            gauss = math.exp(-(delta ** 2) / (2 * sigma ** 2))
            for n in range(1, max_n + 1):
                hv, hnorm = tfidf_vec(hyp, n)
                rv, rnorm = tfidf_vec(r, n)
                s = sum(min(w, rv.get(ng, 0.0)) * rv.get(ng, 0.0)
                        for ng, w in hv.items())
                if hnorm != 0 and rnorm != 0:
                    s /= hnorm * rnorm
                score_n[n - 1] += s * gauss
        per_image = sum(score_n) / max_n / max(len(refs), 1)
        scores.append(10.0 * per_image)
    return sum(scores) / len(scores) if scores else 0.0


# ----------------------------------------------------------- METEOR-lite
def meteor_lite(refs_per_hyp: List[List[List[str]]], hyps: List[List[str]],
                alpha: float = 0.9, beta_: float = 3.0, gamma: float = 0.5
                ) -> float:
    """Exact-match METEOR core (no WordNet): F_alpha × (1 − γ·frag^β), best
    reference wins.  An approximation of the Java scorer, not a clone."""
    scores = []
    for refs, hyp in zip(refs_per_hyp, hyps):
        best = 0.0
        for r in refs:
            matches, chunks = _align(hyp, r)
            if matches == 0:
                continue
            p = matches / len(hyp)
            rec = matches / len(r)
            f_mean = p * rec / (alpha * p + (1 - alpha) * rec)
            frag = chunks / matches
            penalty = gamma * (frag ** beta_)
            best = max(best, f_mean * (1 - penalty))
        scores.append(best)
    return sum(scores) / len(scores) if scores else 0.0


def _align(hyp: Sequence[str], ref: Sequence[str]):
    """Greedy left-to-right exact-match alignment; returns (matches, chunks)."""
    used = [False] * len(ref)
    positions = []
    for h in hyp:
        for j, r in enumerate(ref):
            if not used[j] and h == r:
                used[j] = True
                positions.append(j)
                break
        else:
            positions.append(None)
    matches = sum(1 for p in positions if p is not None)
    chunks = 0
    prev = None
    for p in positions:
        if p is None:
            prev = None
            continue
        if prev is None or p != prev + 1:
            chunks += 1
        prev = p
    return matches, chunks


# -------------------------------------------------------------- facade
class NLGEval:
    """Drop-in for the reference's NLGEval facade
    (compute_metrics(ref_list=[refs], hyp_list=hyps) → metric dict)."""

    def __init__(self, no_glove: bool = True, no_skipthoughts: bool = True):
        del no_glove, no_skipthoughts  # capability flags of the original

    def compute_metrics(self, ref_list: List[List[str]],
                        hyp_list: List[str]) -> Dict[str, float]:
        # ref_list: list of reference *streams*; stream i holds one reference
        # per hypothesis (the reference passes [gts], train_iq.py:196)
        refs_per_hyp = [[ref_list[s][i].split() for s in range(len(ref_list))]
                        for i in range(len(hyp_list))]
        hyps = [h.split() for h in hyp_list]
        from blt_vqg_tpu_torch.train.meteor import meteor
        bleu = corpus_bleu(refs_per_hyp, hyps, 4)
        return {
            "Bleu_1": bleu[0], "Bleu_2": bleu[1],
            "Bleu_3": bleu[2], "Bleu_4": bleu[3],
            "METEOR": meteor(refs_per_hyp, hyps),
            "ROUGE_L": rouge_l(refs_per_hyp, hyps),
            "CIDEr": cider(refs_per_hyp, hyps),
        }
