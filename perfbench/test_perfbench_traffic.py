"""The traffic generator and the corpus copy: the same seed gives the
same questions; every seed the same kinds and lengths in another order."""
from __future__ import annotations

import itertools
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR))

from pbkit import corpus as corpus_mod, questions  # noqa: E402

TRAFFIC = json.loads((BENCH_DIR / "traffic" / "factoid_1u.json").read_text())


def _corpus():
    texts, entities, cores = corpus_mod.make_topical_corpus(
        n_docs=300, doc_len=40, n_topics=8, n_entities=40, seed=5,
        sharpness=0.85)
    return corpus_mod.Corpus(texts, entities, cores)


def _take(seed, user, n=60):
    return list(itertools.islice(questions.question_stream(
        TRAFFIC, _corpus(), seed, user), n))


def _shape(q: str) -> tuple:
    return ("lookup",) if q.startswith("UNIQUE_") else ("topical",
                                                        len(q.split()))


def test_same_seed_same_questions():
    assert _take(2 ** 31 + 7, 0) == _take(2 ** 31 + 7, 0)
    assert _take(2 ** 31 + 7, 0) != _take(2 ** 31 + 8, 0)
    assert _take(2 ** 31 + 7, 0) != _take(2 ** 31 + 7, 1)


def test_every_seed_the_same_kinds_and_lengths():
    a = [_shape(q) for q in _take(11, 0)]
    b = [_shape(q) for q in _take(2 ** 32 + 3, 0)]
    assert a != b and sorted(a) == sorted(b)
    assert sum(s == ("lookup",) for s in a) == 30
    lo, hi = TRAFFIC["topical_words"]
    assert {s[1] for s in a if s[0] == "topical"} == set(range(lo, hi + 1))


def test_lookups_name_one_document_each():
    c = _corpus()
    for q in _take(3, 0):
        if q.startswith("UNIQUE_"):
            assert sum(q in t for t in c.texts) == 1


def test_sample_holds_the_longest_prompt_and_enough_tokens():
    class Out:
        def __init__(self, n, toks):
            self.prompt_len, self.token_ids = n, [0] * toks

    class Req:
        def __init__(self, n, toks):
            self.out = Out(n, toks)

    answers = [Req(1900 + i % 7, 8) for i in range(100)]
    answers[42] = Req(2048, 8)
    picked = questions.sample_answers(answers, TRAFFIC, seed=9)
    assert picked[0] is answers[42]
    assert sum(len(a.out.token_ids) for a in picked) >= TRAFFIC["check_tokens"]
    assert picked == questions.sample_answers(answers, TRAFFIC, seed=9)
