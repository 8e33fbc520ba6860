"""Query EXPLAIN plans: a structured record of what one query ran.

The paper's pitch is a deterministic, *inspectable* retrieval stack —
HSF scores are reproducible, so "why did this result rank where it
did, and what did the query cost" should be a queryable artifact, not
something reconstructed from spans after the fact.  A
:class:`QueryPlan` captures, per query:

- the **index kind** (``flat`` / ``ivf`` / ``ivf-sharded``) and
  **scoring path** (``map`` / ``gemm`` / ``kernel``) actually chosen;
- the **probe decomposition** for clustered indexes: clusters probed
  vs total, the probe ordering, exact-mode widening rounds, the final
  kth score vs the unprobed upper bound (the termination proof);
- **candidate volume**: rows gathered from probed clusters vs rows
  reranked;
- **caching**: query-vector cache hit, result-cache hit/miss/bypass,
  coalesce fanout, and the pinned snapshot generation;
- **per-stage durations** sourced from the existing span machinery via
  a thread-local :class:`~repro_torch.obs.trace.StageCollector` — the same
  timed sections tracing records, so EXPLAIN timings and Chrome traces
  can never disagree.

Capture is allocation-light: the engine binds one collector per query
*chunk* (not per query), the index plane materializes its per-query
probe tuples only when ``explain=True``, and nothing touches the
jitted path — host syncs reuse the audited tracing sync points
(HostSyncRule pragmas), now gated on ``trace.active()``.

**Lazy materialization.**  Building a 20-field frozen dataclass per
query (~3 µs) plus a per-request enriched copy (~7 µs) is real money
against the serving plane's <5 % traced-QPS overhead budget, so the
hot path only *captures* plan ingredients: dispatches hand back a
:class:`PlanBatch` (a sequence that constructs its ``QueryPlan``s on
first access), and ``ServedResult.plan`` finalizes the per-request
copy on first read.  The closed-loop benchmark gate
(``bench_serving_traced``, every traced request submitted with
``explain=True``) is what holds this honest.

Pure stdlib, importable from anywhere in the tree without cycles.
"""
from __future__ import annotations

import copy
import json
from dataclasses import asdict, dataclass

from repro_torch.obs.trace import StageCollector  # noqa: F401  (re-export)


@dataclass(frozen=True)
class QueryPlan:
    """One query's plan.  Frozen: enrich with :func:`finalize_plan`
    (or ``dataclasses.replace`` off the hot path)."""

    query: str
    k: int
    index: str = "flat"              # flat | ivf | ivf-sharded
    scoring_path: str = "map"        # map | gemm | kernel
    guarantee: str | None = None     # probe | exact (ivf only)
    n_docs: int = 0
    n_clusters: int = 0
    clusters_probed: int | None = None
    probe_order: tuple = ()          # cluster ids, probe order
    rounds: int | None = None        # exact-mode widening rounds
    kth_score: float | None = None   # final kth candidate score
    unprobed_bound: float | None = None  # max upper bound left unprobed
    rows_gathered: int | None = None
    rows_reranked: int | None = None
    vector_cache: str = "miss"       # hit | miss | none
    result_cache: str = "bypass"     # hit | miss | bypass
    coalesced: int = 1               # requests served by this dispatch
    generation: int | None = None
    tenant: str | None = None
    stages: tuple = ()               # (name, dur_s, args) engine stages
    request_stages: tuple = ()       # (name, dur_s) scheduler stages
    total_s: float = 0.0

    # ---- serialization --------------------------------------------------

    def to_dict(self) -> dict:
        d = asdict(self)
        d["probe_order"] = list(self.probe_order)
        d["stages"] = [[n, s, dict(a)] for n, s, a in self.stages]
        d["request_stages"] = [[n, s] for n, s in self.request_stages]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "QueryPlan":
        kw = dict(d)
        kw["probe_order"] = tuple(kw.get("probe_order") or ())
        kw["stages"] = tuple(
            (n, s, dict(a)) for n, s, a in kw.get("stages") or ())
        kw["request_stages"] = tuple(
            (n, s) for n, s in kw.get("request_stages") or ())
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in kw.items() if k in known})

    # ---- rendering ------------------------------------------------------

    def render(self) -> str:
        """Text tree, the `EXPLAIN` a human reads."""
        L = []
        q = self.query if len(self.query) <= 60 else self.query[:57] + "..."
        head = f"EXPLAIN {q!r} (k={self.k}"
        if self.tenant:
            head += f", tenant={self.tenant}"
        if self.generation is not None:
            head += f", generation={self.generation}"
        head += f", {self.total_s * 1e3:.3f} ms)"
        L.append(head)
        if self.result_cache == "hit":
            L.append("└─ result cache: HIT (no scoring dispatch)")
            for name, dur in self.request_stages:
                L.append(f"     {name:<12s} {dur * 1e6:8.1f} µs")
            return "\n".join(L)
        L.append(f"├─ index: {self.index}  scoring_path: "
                 f"{self.scoring_path}"
                 + (f"  guarantee: {self.guarantee}" if self.guarantee
                    else ""))
        L.append(f"├─ corpus: {self.n_docs} docs"
                 + (f", {self.n_clusters} clusters" if self.n_clusters
                    else ""))
        if self.clusters_probed is not None:
            probe = (f"├─ probe: {self.clusters_probed}/{self.n_clusters} "
                     f"clusters")
            if self.rounds is not None:
                probe += f", {self.rounds} widen round(s)"
            L.append(probe)
            if self.probe_order:
                order = ",".join(str(c) for c in self.probe_order[:16])
                if len(self.probe_order) > 16:
                    order += f",…(+{len(self.probe_order) - 16})"
                L.append(f"│    order: [{order}]")
            if self.kth_score is not None:
                bound = ("-inf (all clusters probed)"
                         if self.unprobed_bound is None
                         else f"{self.unprobed_bound:.6f}")
                L.append(f"│    kth score {self.kth_score:.6f} ≥ "
                         f"unprobed bound {bound}")
        if self.rows_gathered is not None:
            L.append(f"├─ candidates: {self.rows_gathered} gathered → "
                     f"{self.rows_reranked} reranked")
        cache_bits = [f"result_cache={self.result_cache}"]
        if self.vector_cache != "none":
            cache_bits.append(f"vector_cache={self.vector_cache}")
        if self.coalesced > 1:
            cache_bits.append(f"coalesced×{self.coalesced}")
        L.append("├─ cache: " + "  ".join(cache_bits))
        if self.stages:
            L.append("├─ engine stages:")
            for name, dur, args in self.stages:
                extra = ""
                if args:
                    extra = "  " + " ".join(
                        f"{k}={v}" for k, v in sorted(args.items()))
                L.append(f"│    {name:<24s} {dur * 1e3:9.3f} ms{extra}")
        if self.request_stages:
            L.append("└─ request stages:")
            for name, dur in self.request_stages:
                L.append(f"     {name:<24s} {dur * 1e3:9.3f} ms")
        elif L[-1].startswith("├─"):
            L[-1] = "└─" + L[-1][2:]
        return "\n".join(L)


def plans_from_dispatch(texts, k, *, index, scoring_path, guarantee,
                        n_docs, stats=None, stages=(),
                        vector_cache_hits=None, generation=None,
                        total_s=0.0):
    """Build one QueryPlan per query of a scoring dispatch from the
    index stats + collected stages.  ``stats`` is the (possibly
    extended) ``IVFSearchStats`` for clustered dispatches, None for
    flat scans; ``vector_cache_hits`` is a per-query bool tuple or
    None when the caller has no query-vector cache."""
    stages = tuple(stages)
    plans = []
    for i, text in enumerate(texts):
        kw = dict(
            query=text, k=k, index=index, scoring_path=scoring_path,
            n_docs=n_docs, generation=generation, stages=stages,
            total_s=total_s,
            vector_cache=("none" if vector_cache_hits is None else
                          "hit" if vector_cache_hits[i] else "miss"),
        )
        if stats is not None:
            kw.update(
                guarantee=guarantee,
                n_clusters=stats.n_clusters,
                clusters_probed=stats.clusters_probed,
                rounds=stats.rounds,
                rows_gathered=stats.candidate_rows,
                rows_reranked=stats.candidate_rows,
            )
            if stats.probe_order:
                kw["probe_order"] = stats.probe_order[i]
            if stats.kth_scores:
                kw["kth_score"] = stats.kth_scores[i]
                kw["unprobed_bound"] = stats.unprobed_bounds[i]
        plans.append(QueryPlan(**kw))
    return plans


class PlanBatch:
    """A lazily-materialized sequence of ``QueryPlan``s.

    The scoring hot path constructs this with a zero-argument thunk
    (usually a closure over :func:`plans_from_dispatch` ingredients);
    the dataclasses are built on the first sequence access and cached.
    Materialization is idempotent, so a benign race between two
    consumers resolving concurrently just builds the same list twice.
    """

    __slots__ = ("_thunk", "_plans")

    def __init__(self, thunk):
        self._thunk = thunk
        self._plans = None

    @classmethod
    def concat(cls, batches: list) -> "PlanBatch":
        if len(batches) == 1:
            return batches[0]
        return cls(lambda: [p for b in batches for p in b])

    def _all(self) -> list:
        if self._plans is None:
            self._plans = list(self._thunk())
        return self._plans

    def __len__(self) -> int:
        return len(self._all())

    def __getitem__(self, i):
        return self._all()[i]

    def __iter__(self):
        return iter(self._all())


def finalize_plan(base: QueryPlan, **overrides) -> QueryPlan:
    """A cheaper ``dataclasses.replace`` for the per-request plan copy
    (~2.5x: ``replace`` re-runs the 20-field ``__init__``).  The copy
    is required — coalesced requests share one engine plan but differ
    in request stages / fanout / cache disposition."""
    plan = copy.copy(base)
    for k, v in overrides.items():
        # analysis: allow[snapshot-mutation] -- writes only to the
        # fresh private copy made on the line above, never to the
        # shared base plan; the copy escapes already-frozen
        object.__setattr__(plan, k, v)
    return plan


# ---- plan files (CI artifacts, `python -m repro_torch.obs explain`) -----------

def write_plans(path: str, plans, extra: dict | None = None) -> None:
    doc = {"plans": [p.to_dict() for p in plans]}
    if extra:
        doc.update(extra)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)


def load_plans(path: str) -> list[QueryPlan]:
    with open(path) as f:
        doc = json.load(f)
    raw = doc.get("plans", doc) if isinstance(doc, dict) else doc
    return [QueryPlan.from_dict(d) for d in raw]
