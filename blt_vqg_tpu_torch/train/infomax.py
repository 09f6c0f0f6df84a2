"""Information-maximization evaluation (counterpart of
``blt_vqg_tpu/train/infomax.py``).

What the latent ``z`` buys: k decodes of one image under independent prior
draws should give questions that are varied yet valid.

- :func:`multi_z_decode` runs the port's decode step k times, each draw
  with generators of its own, made from a base seed and the draw index by
  ``core/rng.py``'s ``RngStream`` (the counterpart of
  ``jax.random.fold_in(base_key, j)``; the two packages draw different
  numbers for the same seed);
- :func:`diversity_metrics` scores the draws: distinct-question rate,
  self-BLEU, distinct-1/2 n-gram ratios, and, with a predicate,
  consistency with the conditioning category and validity against a
  paraphrase corpus.

Everything below :func:`multi_z_decode` is the JAX module's source, held
equal to it by tests/test_torch_infomax.py.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from blt_vqg_tpu_torch.core.rng import RngStream
from blt_vqg_tpu_torch.train.nlg_metrics import corpus_bleu


def multi_z_decode(decode_step, images: torch.Tensor, context: torch.Tensor,
                   base_seed: int, k: int) -> List[np.ndarray]:
    """k decodes of one batch under independent draws.

    ``decode_step(images, context, generator, sample_generator) ->
    {"tokens": [B, L]}`` is the port's decode step (train/step.py
    ``make_decode_step``).  Draw j takes ``RngStream(base_seed).key(j)`` for
    the prior sample and the stream's ``"sample"`` generator of step j for
    sampled tokens, both on the images' device.  Returns k host arrays
    [B, L]."""
    stream = RngStream(base_seed)
    dev = images.device
    out = []
    for j in range(k):
        sample = stream.step_keys(j, "sample", device=dev)["sample"]
        tokens = decode_step(images, context, stream.key(j, dev),
                             sample)["tokens"]
        out.append(tokens.cpu().numpy())
    return out


def _ngrams(tokens: Sequence, n: int):
    return [tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1)]


def diversity_metrics(samples: List[List[str]],
                      contexts: Optional[Sequence] = None,
                      consistent_fn: Optional[Callable[[str, object], bool]]
                      = None,
                      refs: Optional[Sequence[str]] = None,
                      valid_fn: Optional[Callable[[str, str], bool]]
                      = None) -> Dict[str, float]:
    """Diversity/consistency over ``samples[j][b]`` = draw j's question for
    image b (whitespace-tokenized strings).

    Returns:
      distinct_rate   mean_b |{unique questions}| / k      (1.0 = all differ)
      self_bleu       corpus BLEU-4 of each draw against the OTHER draws of
                      the same image (1.0 = identical; lower = varied)
      distinct_1/2    unique n-grams / total n-grams, pooled per image
      consistency     mean of consistent_fn(question, contexts[b]) over all
                      draws (only when both are supplied)
      valid_rate      mean of valid_fn(question, refs[b]) over all draws —
                      with template_validity, the fraction of draws that are
                      EXACTLY one of the corpus's valid paraphrases for the
                      image's combo (only when valid_fn+refs are supplied)
      distinct_valid  mean_b |{distinct VALID questions among the k draws}|
                      — the info-max headline: varied AND correct (compare
                      against the corpus's templates-per-combo T)
    """
    k = len(samples)
    b = len(samples[0]) if k else 0
    if k == 0 or b == 0:
        return {}
    per_image = [[samples[j][i] for j in range(k)] for i in range(b)]

    distinct_rate = float(np.mean([len(set(qs)) / k for qs in per_image]))

    d1_num = d1_den = d2_num = d2_den = 0
    for qs in per_image:
        toks = [q.split() for q in qs]
        uni = [g for t in toks for g in _ngrams(t, 1)]
        bi = [g for t in toks for g in _ngrams(t, 2)]
        d1_num += len(set(uni))
        d1_den += max(len(uni), 1)
        d2_num += len(set(bi))
        d2_den += max(len(bi), 1)

    out = {
        "distinct_rate": distinct_rate,
        "distinct_1": d1_num / d1_den,
        "distinct_2": d2_num / d2_den,
    }

    if k > 1:
        sb_hyps, sb_refs = [], []
        for qs in per_image:
            toks = [q.split() for q in qs]
            for j in range(k):
                sb_hyps.append(toks[j])
                sb_refs.append([t for jj, t in enumerate(toks) if jj != j])
        try:
            out["self_bleu"] = corpus_bleu(sb_refs, sb_hyps, 4)[3]
        except ZeroDivisionError:
            out["self_bleu"] = 0.0

    if consistent_fn is not None and contexts is not None:
        hits = [float(bool(consistent_fn(samples[j][i], contexts[i])))
                for j in range(k) for i in range(b)]
        out["consistency"] = float(np.mean(hits))

    if valid_fn is not None and refs is not None:
        hits, dv = [], []
        for i in range(b):
            qs = [samples[j][i] for j in range(k)]
            ok = [bool(valid_fn(q, refs[i])) for q in qs]
            hits.extend(float(o) for o in ok)
            dv.append(len({q for q, o in zip(qs, ok) if o}))
        out["valid_rate"] = float(np.mean(hits))
        out["distinct_valid"] = float(np.mean(dv))
    return out


def category_word_consistency(vocab, num_reserved: int = 6
                              ) -> Callable[[str, int], bool]:
    """Consistency predicate for the synthetic corpora: category ``c`` maps
    to word id ``num_reserved + c`` (text/vocabulary.py reserved-id
    contract), so a consistent question for context category ``c`` contains
    that word.  Returns ``consistent_fn(question_str, category_id)``."""
    def fn(question: str, category) -> bool:
        word = vocab.idx2word.get(num_reserved + int(category))
        return word is not None and word in question.split()
    return fn


def mapped_word_consistency(cat2words: Dict, idx2word: Optional[Dict] = None
                            ) -> Callable[[str, object], bool]:
    """Consistency predicate from an explicit category → word-list map
    (e.g. the factored flagship corpus's ``consistency_map.json``, where
    each category NAME maps to the two template words its questions must
    contain — benchmarks/make_flagship_dataset.py factored_consistency_map).

    The context evaluate_iq collects per image is the batch's
    ``answer_types`` value — the VOCAB WORD ID of the category word
    (data/packed.py:107 ``type_word``) — so with ``idx2word`` the lookup
    key is the decoded category name ('cat2'); integer/str keys are also
    accepted directly for raw-category maps.  A question is consistent
    iff it contains ALL of the category's words."""
    table = {str(k): list(v) for k, v in cat2words.items()}
    def fn(question: str, category) -> bool:
        expect = None
        if idx2word is not None:
            name = idx2word.get(int(category))
            if name is not None:
                expect = table.get(str(name))
        if expect is None:
            expect = table.get(str(int(category)))
        words = set(question.split())
        return bool(expect) and all(w in words for w in expect)
    return fn


def _norm_question(q: str) -> str:
    """Punctuation/whitespace-insensitive comparison form: the corpus
    generator writes ``...word?`` while the eval detokenizer emits
    ``...word ?`` (the tokenizer splits punctuation)."""
    return " ".join(q.replace("?", " ").split())


def template_validity(valid_questions: Dict[str, Sequence[str]]
                      ) -> Callable[[str, str], bool]:
    """Validity predicate from a paraphrase corpus's ground truth
    (``valid_questions.json``: combo id → its T valid paraphrases,
    benchmarks/make_flagship_dataset.py valid_questions_map).

    Returns ``valid_fn(question, ref_question)``: True iff the generated
    question is EXACTLY one of the valid paraphrases of the combo the
    image's REFERENCE question belongs to (paraphrases are injective per
    combo, so the reference identifies the combo).  Together with
    ``distinct_rate`` this is the info-max claim in one number: prior
    z-draws produce questions that are varied AND drawn from the valid
    set (reference iq.py:124-127)."""
    q2combo: Dict[str, str] = {}
    for combo, qs in valid_questions.items():
        for q in qs:
            q2combo[_norm_question(q)] = str(combo)

    def fn(question: str, ref: str) -> bool:
        c = q2combo.get(_norm_question(ref))
        return c is not None and q2combo.get(_norm_question(question)) == c
    return fn
