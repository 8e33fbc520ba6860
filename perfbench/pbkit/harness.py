"""One run of one cell: set-up, the measured window, the metrics, and
the output check.

Set-up: the corpus and the program's knowledge container (built once
per checkout into the cache directory, then loaded), the weights from
``--seed`` on the device, the serving runtime and the RAG pipeline,
and a warm-up of every shape the cell's traffic reaches (the HSF
flushes up to the users' count, two whole answers, which capture the
prompt bucket's prefill and the decode step).  The window: the closed
loop for ``--seconds`` (with ``--trace 1`` the program's spans on, and
a profiled slice just past the window).  After it: the peak memory,
the check that no JAX module was loaded, the program's state freed,
then the references.
"""
from __future__ import annotations

import gc
import itertools
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from pbkit import check as chk
from pbkit import corpus as corpus_mod
from pbkit import questions, retrieval_ref, spec as spec_mod, weights as wts
from pbkit.loop import closed_loop
from pbkit.profiling import ProfilerHooks
from pbkit.peaks import peaks as peaks_of

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WARM_ANSWERS = 2
PROFILE_S = 3.0  # the trace run's profiled slice, just past the window


class NoDevice(RuntimeError):
    pass


def process_start() -> float:
    """The process's start on the ``time.perf_counter`` clock (Linux:
    from /proc; elsewhere the harness's import)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.perf_counter()


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that are JAX's or the JAX
    package's (whole names: ``repro_torch`` is not ``repro``)."""
    names = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(names & set(FORBIDDEN))


def use_cache_dirs(cache_root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    cache_root.mkdir(parents=True, exist_ok=True)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(cache_root / sub)
    from repro_torch.kernels import build as kbuild
    kbuild.BUILD_DIR = cache_root / "kernels"


def device_for(cell: spec_mod.Cell, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < cell.chips:
        raise NoDevice(f"{torch.cuda.device_count()} CUDA devices, the cell "
                       f"asks for {cell.chips}")
    return torch.device("cuda", 0)


def container(cell: spec_mod.Cell, corpus, cache_dir: Path):
    """The program's knowledge container of the corpus: ingested through
    ``KnowledgeBase`` and saved with its matrix on the first run in a
    checkout, loaded afterwards."""
    from repro_torch.core.ingest import KnowledgeBase

    path = cache_dir / "container" / "kb.ragdb"
    if not path.exists():
        r = cell.config["retrieval"]
        kb = KnowledgeBase(dim=r["dim"], sig_words=r["sig_words"])
        for i, text in enumerate(corpus.texts):
            kb.add_text(corpus_mod.doc_id(i), text)
        tmp = cache_dir / "container.tmp"
        tmp.mkdir(parents=True, exist_ok=True)
        kb.save(str(tmp / "kb.ragdb"))
        os.replace(tmp, cache_dir / "container")
    return KnowledgeBase.load(str(path))


@dataclass
class RunData:
    """What the metric readers read (``metrics/<name>.py``)."""
    cell: spec_mod.Cell
    counts: dict
    peaks: dict | None
    t0: float
    t_end: float
    setup_s: float
    requests: list
    spans: list = field(default_factory=list)
    profile: object = None

    @property
    def answers(self) -> list:
        """Answers whose question was asked and answered in the window."""
        return [r for r in self.requests
                if r.out is not None and r.t_done <= self.t_end]

    @property
    def retrievals(self) -> list:
        return [r for r in self.requests
                if r.t_retrieved is not None and r.t_retrieved <= self.t_end]

    @property
    def t_last_done(self) -> float | None:
        done = [r.t_done for r in self.answers]
        return max(done) if done else None

    @property
    def open_ages(self) -> list[float]:
        """Seconds from ``submit()`` to the window's close of every
        question asked in it and neither answered nor failed by then."""
        return [self.t_end - r.t_submit for r in self.requests
                if r.t_submit <= self.t_end and r.error is None
                and (r.t_done is None or r.t_done > self.t_end)]

    @property
    def stalled(self) -> bool:
        """No answer came for longer, up to the close, than between any
        two answers (or the start and the first) in the window: the
        generator stalled, and the time since its last answer counts."""
        done = sorted(r.t_done for r in self.answers)
        if not done:
            return bool(self.open_ages)
        longest = max(b - a for a, b in zip([self.t0] + done, done))
        return self.t_end - done[-1] > longest

    def close(self) -> dict:
        """What the window's close left: the time since the last answer,
        the longest time between two answers, and the open questions."""
        done = sorted(r.t_done for r in self.answers)
        ages = self.open_ages
        return {"tail_gap_ms": (self.t_end - done[-1]) * 1e3 if done else None,
                "longest_gap_ms": max(b - a for a, b in zip(
                    [self.t0] + done, done)) * 1e3 if done else None,
                "open": len(ages),
                "open_age_max_ms": max(ages) * 1e3 if ages else None,
                "stalled": self.stalled}

    def spans_named(self, name: str) -> list:
        lo, hi = self.t0 * 1e9, self.t_end * 1e9
        return [s for s in self.spans if s.name == name and lo <= s.t0_ns
                and s.t0_ns + s.dur_ns <= hi]


@dataclass
class Served:
    """The program's part of a run, its state already freed."""
    requests: list
    t0: float
    t_end: float
    memory_peak: int
    spans: list
    profile: object


def serve_window(cell, kb, weights: dict, seed: int, seconds: float,
                 trace: bool, device: torch.device, corpus,
                 hooks=None) -> Served:
    """Build the program over ``weights``, warm it, run the closed loop
    for ``seconds``, and free it.  ``hooks`` (``loop.Hooks``) are the
    loop's where the trace run's profiler does not take their place."""
    from repro_torch.core.rag import RAGPipeline
    from repro_torch.models import transformer as T
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serving import ServingRuntime

    cfg, traffic = cell.config, cell.traffic
    r, s = cfg["retrieval"], cfg["serving"]
    k, users, max_new = r["top_k"], traffic["users"], traffic["max_new_tokens"]
    adapter = spec_mod.adapter_module(cell)
    lm_cfg = adapter.program_config(cfg)
    model = T.LM(lm_cfg, adapter.program_tree(weights, cfg), device)
    runtime = ServingRuntime(
        kb, max_batch=s["max_batch"],
        flush_deadline=s["flush_deadline_ms"] / 1e3,
        scoring_path=s["scoring_path"], index=s["index"], device=device)
    rag = RAGPipeline(kb, model, lm_cfg, engine=runtime.engine,
                      max_context_tokens=s["max_context_tokens"])
    streams = [questions.question_stream(traffic, corpus, seed, u)
               for u in range(users)]
    warm = list(itertools.islice(questions.question_stream(
        traffic, corpus, seed, users), WARM_ANSWERS + users))
    with runtime:
        b = 1
        while True:  # every flush size up to the users', in its bucket
            runtime.snapshots.current.query_batch(warm[WARM_ANSWERS:][:b], k)
            if b >= users:
                break
            b *= 2
        for question in warm[:WARM_ANSWERS]:
            served = runtime.submit(question, k=k).result()
            rag.generate(question, served.results, max_new)
        if trace:
            obs_trace.enable()
        hook = None
        if trace and device.type == "cuda":
            hook = ProfilerHooks(min(PROFILE_S, seconds / 3))
        t0 = time.perf_counter()
        t_end = t0 + seconds
        if hook is not None:
            hook.window(t_end)
        requests = closed_loop(runtime, rag, streams, k, max_new, t_end,
                               hook or hooks)
        if hook is not None:
            hook.stop()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        memory_peak = (torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else 0)
    spans = obs_trace.get().drain() if trace else []
    obs_trace.disable()
    del rag, runtime, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return Served(requests, t0, t_end, memory_peak, spans,
                  hook.profile if hook is not None else None)


def judge(cell, served: Served, weights: dict, corpus, cache_dir: Path,
          device: torch.device, seed: int, control: bool = False) -> dict:
    """The output check's numbers for the window's retrievals and a
    sample of its answers (``control``: the references' lower precision
    judged in the program's place)."""
    cfg = cell.config
    r = cfg["retrieval"]
    arrays = retrieval_ref.load_or_build(corpus.texts, r["dim"],
                                         r["sig_words"], cache_dir)
    ref = retrieval_ref.RetrievalReference(arrays, r, device)
    data = RunData(cell, {}, None, served.t0, served.t_end, 0.0,
                   served.requests)
    got = data.retrievals
    rows = [chk.served_rows(q.served.results, ref.n, r["top_k"])
            for q in got]
    numbers = chk.retrieval_numbers(ref, [q.question for q in got], rows,
                                    r["top_k"], control=control)
    del ref
    sample = questions.sample_answers(data.answers, cell.traffic, seed)
    answers = [(q.question, q.served.results, q.out.prompt_len,
                q.out.token_ids) for q in sample]
    numbers.update(chk.generation_numbers(
        spec_mod.reference_module(cell), weights, cfg, corpus.texts,
        answers, cfg["serving"]["max_context_tokens"], len(corpus.texts),
        control=control))
    numbers["sampled_answers"] = len(sample)
    numbers["sampled_tokens"] = sum(len(a[3]) for a in answers)
    numbers["checked_retrievals"] = len(got)
    return numbers


@dataclass
class Outcome:
    result: dict
    checks: list
    numbers: dict
    setup_s: float


def run(cell: spec_mod.Cell, seed: int, seconds: float, trace: bool,
        cache_root: Path, device=None) -> Outcome:
    t_start = process_start()
    device = device_for(cell, device)
    use_cache_dirs(cache_root)
    cache_dir = cache_root / corpus_mod.corpus_key(cell.config)
    corpus = corpus_mod.load_or_make(cell.config, cache_dir)
    kb = container(cell, corpus, cache_dir)
    ref_mod = spec_mod.reference_module(cell)
    weights = wts.make(ref_mod.weight_specs(cell.config), seed, device)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    pk = peaks_of(kind)
    served = serve_window(cell, kb, weights, seed, seconds, trace, device,
                          corpus)
    setup_s = served.t0 - t_start
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)
    data = RunData(cell, ref_mod.counts(cell.config), pk, served.t0,
                   served.t_end, setup_s, served.requests, served.spans,
                   served.profile)
    metrics = {}
    for m in cell.metrics(trace):
        value = spec_mod.metric_reader(cell.bench_dir, m["name"])(data)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    del kb
    t_judge = time.perf_counter()
    numbers = judge(cell, served, weights, corpus, cache_dir, device, seed)
    numbers["judge_s"] = time.perf_counter() - t_judge
    ok, rows = chk.verdict(numbers, cell.workload["limits"])
    in_window = [q for q in served.requests if q.t_submit <= served.t_end]
    failed = sum(q.error is not None for q in in_window)
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": served.memory_peak}
    result = {"correct": bool(ok and failed == 0),
              "attempted": len(in_window), "failed": failed,
              "metrics": metrics, "device": device_info}
    result["window"] = data.close()
    if served.profile is not None:
        prof = served.profile
        device_info["busy_s"] = prof.busy_s()
        device_info["window_s"] = prof.window_s
        result["breakdown"] = breakdown(prof)
    return Outcome(result, rows, numbers, setup_s)


class ForbiddenModules(RuntimeError):
    def __init__(self, names):
        super().__init__(f"loaded after the window: {', '.join(names)}")
        self.names = names


def breakdown(prof) -> dict:
    ops: dict[str, float] = {}
    for name, _, dur in prof.kernels:
        ops[name] = ops.get(name, 0.0) + dur / 1e6
    gaps: dict[str, float] = {}
    for label, _, length in prof.idle_gaps():
        gaps[label] = gaps.get(label, 0.0) + length / 1e6
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:200], s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in idle]}
