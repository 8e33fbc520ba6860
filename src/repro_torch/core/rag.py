"""RAG orchestration: retrieve → pack context → generate (the JAX
package's ``core/rag.py``).

The deterministic HSF retriever feeds the generator's prompt window;
generation is the port's own LM serving path (prefill through the
flash-attention kernel on the card, then greedy decode with KV caches).
Retrieval is batched (``answer_batch`` scores every question in one
``QueryEngine.query_batch`` dispatch); generation runs per request,
since prompt lengths differ.  It runs on static shapes
(``launch/steps.GenerationSteps``): the prompt is right-padded to a
power-of-two bucket, prefilled into one cache of ``max_context_tokens +
max_new_tokens`` slots and decoded there, so on the card each step is a
captured CUDA graph, replayed (captured at its first use, outside the
timings).  On the CPU the same steps run eagerly.

Tokenization for the LM uses the retrieval plane's stable hashing (word
→ fnv1a64 mod vocab), as the reference does.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from repro_torch.core import hashing
from repro_torch.core.engine import QueryEngine, RetrievalResult
from repro_torch.core.ingest import KnowledgeBase
from repro_torch.core.tokenizer import tokenize
from repro_torch.kernels.moe_decode import ops as md_ops
from repro_torch.launch.steps import GenerationSteps
from repro_torch.models import mla as mla_mod
from repro_torch.models import transformer as T
from repro_torch.obs import trace as obs_trace


def text_to_tokens(text: str, vocab: int) -> list[int]:
    return [hashing.fnv1a64(w) % vocab for w in tokenize(text)]


@dataclass
class RAGOutput:
    retrieved: list[RetrievalResult]
    token_ids: list[int]
    prompt_len: int
    # host-clock seconds of the prefill (through the first token's read
    # back) and of the decode steps; each ends in a device → host read.
    # Graph captures made for this request are not in them
    prefill_s: float = 0.0
    decode_s: float = 0.0


@dataclass
class RAGPipeline:
    kb: KnowledgeBase
    model: T.LM
    cfg: T.LMConfig
    max_context_tokens: int = 512
    alpha: float = 1.0
    beta: float = 1.0
    use_kernel: bool = False
    # injectable: serving drivers pass the runtime's engine so the
    # retrieval tensors exist once.  Its device is the pipeline's; the
    # model must live there.  Retrieval entry points here
    # (answer/answer_batch) call engine.refresh() and so count as
    # writer-thread operations; concurrent callers retrieve via
    # runtime.submit() and use generate() with the served results, as
    # launch/serve.py does.
    engine: QueryEngine | None = field(default=None, repr=False)
    # the static-shape steps of the last horizon asked for (one request
    # at a time: generate() is not for concurrent callers)
    steps: GenerationSteps | None = field(default=None, init=False,
                                          repr=False)
    # the serving runtime's capture guard, set by its arm_sanitizers(
    # rag=...): checked after every generation, so a prompt bucket that
    # was not warmed (a capture on the hot path) raises on its request
    retrace_guard: object | None = field(default=None, init=False,
                                         repr=False)

    def __post_init__(self):
        if self.engine is None:
            self.engine = QueryEngine(self.kb, self.alpha, self.beta,
                                      use_kernel=self.use_kernel,
                                      device=self.model.device)
        elif self.engine.kb is not self.kb:
            raise ValueError("injected engine serves a different "
                             "KnowledgeBase than this pipeline")
        if self.model.device.type != self.engine.device.type:
            raise ValueError(
                f"the model is on {self.model.device}, the engine on "
                f"{self.engine.device}")

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _pack_context(self, results: list[RetrievalResult]) -> list[int]:
        """Greedy context packing: best-scored docs first, truncated to
        the token budget."""
        budget = self.max_context_tokens
        packed: list[int] = []
        for r in results:
            toks = text_to_tokens(self.kb.texts[r.doc_id], self.cfg.vocab)
            take = min(len(toks), budget - len(packed))
            packed.extend(toks[:take])
            if len(packed) >= budget:
                break
        return packed

    def answer(self, question: str, max_new_tokens: int = 16,
               top_k_docs: int = 3) -> RAGOutput:
        return self.answer_batch([question], max_new_tokens=max_new_tokens,
                                 top_k_docs=top_k_docs)[0]

    def answer_batch(self, questions: list[str], max_new_tokens: int = 16,
                     top_k_docs: int = 3) -> list[RAGOutput]:
        """One retrieval dispatch, then generation per question."""
        retrieved = self.engine.query_batch(questions, k=top_k_docs)
        return [
            self.generate(question, results, max_new_tokens)
            for question, results in zip(questions, retrieved)
        ]

    def generation_steps(self, max_new_tokens: int) -> GenerationSteps:
        """The steps for a ``max_new_tokens`` horizon (made anew, with
        their cache and graphs, when the horizon changes)."""
        horizon = self.max_context_tokens + max_new_tokens
        if self.steps is None or self.steps.max_len != horizon:
            self.steps = None  # frees the old cache and graphs first
            self.steps = GenerationSteps(self.model, self.cfg,
                                         self.max_context_tokens,
                                         max_new_tokens)
        return self.steps

    def generate(self, question: str, results: list[RetrievalResult],
                 max_new_tokens: int, *,
                 trace=obs_trace.INHERIT) -> RAGOutput:
        """Generation stage alone: pack pre-retrieved context, prefill
        (attention backend ``"auto"``: the kernel on the card), then
        greedy decode (first index of the largest logit).

        With the tracer on, a ``generate`` span in ``trace`` (by default
        the enclosing span's on this thread, else a trace of its own)
        holds a ``pack_context`` span and, for the prefill and each
        decode step, a ``step_launch`` span (the step's inputs built,
        copied in and its graph launched; a capture too on a cold call)
        and a ``token_readback`` span (the host blocked until the step's
        token is back).  With it off, or ``trace`` 0 (an unsampled
        request), nothing is recorded and no clock read or sync is
        added."""
        if not obs_trace.enabled():
            return self._generate(question, results, max_new_tokens, None)
        with obs_trace.span("generate", trace=trace) as span:
            if not span.trace_id:
                return self._generate(question, results, max_new_tokens,
                                      None)
            marks = _Marks()
            routes = (dict(mla_mod.counts) if self.cfg.mla is not None
                      else None)
            moe_layers = (_moe_decode_layers() if self.cfg.moe is not None
                          else None)
            out = self._generate(question, results, max_new_tokens, marks)
            if routes is not None:
                marks.args.update(
                    (arg, mla_mod.counts[key] - routes[key])
                    for arg, key in _MLA_ROUTE_ARGS)
            if moe_layers is not None:
                marks.args["moe_decode_layers"] = (_moe_decode_layers()
                                                   - moe_layers)
            span.set(prompt_len=out.prompt_len, tokens=len(out.token_ids),
                     **marks.args)
            obs_trace.record_batch(span.trace_id,
                                   marks.children(span.span_id))
        return out

    def _generate(self, question: str, results: list[RetrievalResult],
                  max_new_tokens: int, marks: _Marks | None) -> RAGOutput:
        clock = time.perf_counter
        if marks is not None:
            t = clock()
        prompt = self._pack_context(results) + text_to_tokens(
            question, self.cfg.vocab
        )
        prompt = prompt[-self.max_context_tokens:] or [0]
        n = len(prompt)
        if marks is not None:
            marks.add("pack_context", t, clock(), passages=len(results),
                      tokens=n)
        steps = self.generation_steps(max_new_tokens)
        bucket = steps.bucket(n)
        prefill = steps.prefill(bucket)
        if marks is not None:
            captures = prefill.captures + steps.decode.captures
            t = clock()

        tokens = torch.tensor([prompt + [0] * (bucket - n)],
                              dtype=torch.int64)
        length = torch.tensor([n], dtype=torch.int32)
        if not prefill.captured:
            prefill.capture(tokens, length)
        t0 = clock()
        logits, _, _ = prefill(tokens, length)
        if marks is not None:
            t1 = clock()
            marks.add("step_launch", t, t1, step="prefill")
        next_tok = int(torch.argmax(logits[0]))
        t2 = clock()
        prefill_s = t2 - t0
        if marks is not None:
            marks.add("token_readback", t1, t2, step="prefill")
        out: list[int] = []
        decode_s = 0.0
        for _ in range(max_new_tokens):
            out.append(next_tok)
            n += 1
            if marks is not None:
                t = clock()
            tok = torch.tensor([[next_tok]], dtype=torch.int64)
            length = torch.tensor([n], dtype=torch.int32)
            if not steps.decode.captured:
                # captured on this step's own inputs: the warm-up writes
                # the cache slot the step writes, with the same values
                steps.decode.capture(tok, length)
            t0 = clock()
            logits, _ = steps.decode(tok, length)
            if marks is not None:
                t1 = clock()
                marks.add("step_launch", t, t1, step="decode")
            next_tok = int(torch.argmax(logits[0, 0]))
            t2 = clock()
            decode_s += t2 - t0
            if marks is not None:
                marks.add("token_readback", t1, t2, step="decode")
        if self.retrace_guard is not None:
            self.retrace_guard.check("rag.generate")
        if marks is not None:
            marks.args.update(bucket=bucket, captures=prefill.captures
                              + steps.decode.captures - captures)
        return RAGOutput(retrieved=results, token_ids=out,
                         prompt_len=len(prompt), prefill_s=prefill_s,
                         decode_s=decode_s)


def _moe_decode_layers() -> int:
    """MoE layer calls the MoE decode layer's wrapper has served (kernel
    launches and plain calls; a replayed graph counts what it captured)."""
    return md_ops.counts["launches"] + md_ops.counts["plain"]


# the generate span's args of an MLA model: (arg, ``mla.counts`` key)
_MLA_ROUTE_ARGS = (("mla_prefill_unpadded", "prefill_unpadded"),
                   ("mla_prefill_padded", "prefill_padded"),
                   ("mla_decode_layers", "decode_absorbed"))


class _Marks:
    """The stages of one traced ``generate`` on the generator thread, on
    the ``time.perf_counter`` clock, and the args of its span."""

    __slots__ = ("stages", "args")

    def __init__(self):
        self.stages: list[tuple[str, float, float, dict]] = []
        self.args: dict = {}

    def add(self, name: str, t0: float, t1: float, **args) -> None:
        self.stages.append((name, t0, t1 - t0, args))

    def children(self, parent: int) -> list[tuple]:
        """``record_batch`` intervals: each stage a child of ``parent``."""
        return [(name, t0, dur, 0, parent, args)
                for name, t0, dur, args in self.stages]
