"""The one traffic generator: a closed loop of ``users`` users, each
asking its own stream of questions and waiting for each answer before
the next.  A mix file (``traffic/<name>.json``) gives its parameters:

- ``users``: closed-loop users;
- ``max_new_tokens``: tokens generated for every answer (greedy);
- ``lookup_share``: the share of entity-code lookups (the paper's RQ2
  task: the question is the code alone); the rest are topical questions
  of ``topical_words`` = [least, most] core words of one topic;
- ``check_tokens``: served tokens the output check samples at least.

Every seed gives the same set of question kinds and lengths in another
order: kinds come in blocks of ten with the mix's share of lookups,
topical lengths in blocks that hold each length once, both shuffled by
the seed; the codes, topics and words are drawn by the seed.
"""
from __future__ import annotations

from collections.abc import Iterator

import numpy as np

BLOCK = 10


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def question_stream(traffic: dict, corpus, seed: int,
                    user: int) -> Iterator[str]:
    """One user's questions, without end."""
    rng = _rng(seed, 1, user)
    n_lookup = round(traffic["lookup_share"] * BLOCK)
    lo, hi = traffic["topical_words"]
    lengths = np.arange(lo, hi + 1)
    codes = sorted(corpus.entities)
    code_order = rng.permutation(len(codes))
    n_codes = 0
    len_block: list[int] = []
    kinds = np.array([1] * n_lookup + [0] * (BLOCK - n_lookup))
    while True:
        for is_lookup in rng.permutation(kinds):
            if is_lookup:
                yield codes[code_order[n_codes % len(codes)]]
                n_codes += 1
                continue
            if not len_block:
                len_block = list(rng.permutation(lengths))
            n_words = int(len_block.pop())
            core = corpus.cores[int(rng.integers(len(corpus.cores)))]
            pick = rng.choice(len(core), size=n_words, replace=False)
            yield " ".join(core[i] for i in pick)


def sample_answers(answers: list, traffic: dict, seed: int) -> list:
    """The answered requests (``loop.Request``) the output check
    compares: the one with the longest prompt, then others drawn by the
    seed, until they hold at least ``check_tokens`` served tokens (all
    of them where fewer do)."""
    if not answers:
        return []
    rng = _rng(seed, 2)
    longest = max(range(len(answers)),
                  key=lambda i: (answers[i].out.prompt_len, -i))
    order = [longest] + [int(i) for i in rng.permutation(len(answers))
                         if i != longest]
    picked, tokens = [], 0
    for i in order:
        if tokens >= traffic["check_tokens"]:
            break
        picked.append(answers[i])
        tokens += len(answers[i].out.token_ids)
    return picked
