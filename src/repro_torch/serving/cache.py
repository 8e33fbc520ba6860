"""Serving-tier result cache, keyed on (canonical query, k, generation)
within an isolated *keyspace* per tenant.

Distinct from — and composing with — the engine's query-*vector* LRU:
that cache skips tokenize/hash/scatter for repeated query texts; this
one skips the entire scoring dispatch for repeated *(query, k)* pairs
against the *same corpus generation*.  Putting the generation in the
key makes invalidation free: publishing generation *g+1* means new
lookups simply miss (their key differs), and entries for dead
generations age out of the LRU naturally — no epoch sweeps, no locks
held during publication.  ``evict_generations_before`` is an optional
hygiene hook for long-lived processes with tiny corpora where old-gen
entries would otherwise linger.

Keyspaces (the tenancy plane, docs/ARCHITECTURE.md §13): every entry
lives in exactly one keyspace (the tenant id; ``DEFAULT_KEYSPACE`` for
the single-tenant path), and **capacity accounting, LRU eviction, and
generation eviction are all scoped per keyspace**.  Two tenants at
"generation 3" are different corpora — a global generation sweep (the
pre-tenancy behavior) would let one tenant's publish evict another
tenant's hot entries, and a shared LRU would let one hot tenant push
every cold tenant's entries out.  ``drop_keyspace`` is the pool's
eviction hook: unmounting a tenant drops its cached results wholesale.

Values are the scheduler's result lists; they are treated as immutable
by every consumer (RetrievalResult rows are never mutated after
construction), so a hit returns the stored list without copying.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

from repro_torch.core.tokenizer import normalize

# The single-tenant keyspace: equals tenancy's DEFAULT_TENANT (defined
# here, dependency-free, and re-exported by the tenancy package) so the
# classic ServingRuntime path and a one-tenant pool share semantics.
DEFAULT_KEYSPACE = "default"


def result_key(text: str, k: int, generation: int) -> tuple[str, int, int]:
    """Canonical cache key — same normalization as the engine's
    query-vector LRU, so "INV-2024" and "inv-2024" share one entry."""
    return (normalize(text), k, generation)


class ResultCache:
    """Thread-safe LRU over full retrieval results, one LRU per
    keyspace (``capacity`` bounds each keyspace independently)."""

    def __init__(self, capacity: int = 2048):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._spaces: dict[str, OrderedDict[tuple, object]] = {}
        self.hits = 0
        self.misses = 0

    def get(self, text: str, k: int, generation: int,
            keyspace: str = DEFAULT_KEYSPACE):
        key = result_key(text, k, generation)
        with self._lock:
            space = self._spaces.get(keyspace)
            val = None if space is None else space.get(key)
            if val is None:
                self.misses += 1
                return None
            space.move_to_end(key)
            self.hits += 1
            return val

    def put(self, text: str, k: int, generation: int, results,
            keyspace: str = DEFAULT_KEYSPACE) -> None:
        key = result_key(text, k, generation)
        with self._lock:
            space = self._spaces.setdefault(keyspace, OrderedDict())
            space[key] = results
            space.move_to_end(key)
            # capacity is per keyspace: a hot tenant filling its own LRU
            # can never push a cold tenant's entries out
            while len(space) > self.capacity:
                space.popitem(last=False)

    def evict_generations_before(self, generation: int,
                                 keyspace: str = DEFAULT_KEYSPACE) -> int:
        """Drop ``keyspace``'s entries pinned to generations older than
        ``generation``; returns how many were evicted.  Scoped: another
        keyspace's generation counter is a different corpus lineage, so
        its entries are never touched."""
        with self._lock:
            space = self._spaces.get(keyspace)
            if space is None:
                return 0
            dead = [key for key in space if key[2] < generation]
            for key in dead:
                del space[key]
            if not space:
                del self._spaces[keyspace]
            return len(dead)

    def drop_keyspace(self, keyspace: str) -> int:
        """Drop every entry in ``keyspace`` (tenant unmount hook);
        returns how many entries were dropped."""
        with self._lock:
            space = self._spaces.pop(keyspace, None)
            return 0 if space is None else len(space)

    def keyspace_bytes(self) -> dict:
        """Estimated resident bytes per keyspace, for the resource
        ledger's ``result_cache`` plane: per entry, the key text plus
        ~96 B of tuple/dict overhead plus ~96 B per cached
        RetrievalResult row (object header + 4 boxed fields) — a
        documented estimate, not an exact object-graph walk."""
        with self._lock:
            return {
                ks: sum(
                    96 + len(key[0]) + 96 * len(results)
                    for key, results in space.items()
                )
                for ks, space in self._spaces.items()
            }

    def __len__(self) -> int:
        with self._lock:
            return sum(len(s) for s in self._spaces.values())

    def stats(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "entries": sum(len(s) for s in self._spaces.values()),
                "keyspaces": len(self._spaces),
                "capacity": self.capacity,
            }
