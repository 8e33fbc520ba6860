"""The closed loop: ``users`` client threads, each submitting its next
question to the serving runtime only once its previous answer has
come, and one generator (the calling thread) that turns retrievals into
answers one at a time in the order they resolved, as the program's
``launch/serve.py`` does (the port has no batched generation path)."""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field


@dataclass
class Request:
    user: int
    question: str
    t_submit: float
    t_retrieved: float | None = None
    served: object = None          # the runtime's ServedResult
    t_gen_start: float | None = None
    t_done: float | None = None
    out: object = None             # the pipeline's RAGOutput
    error: str | None = None
    done: threading.Event = field(default_factory=threading.Event,
                                  repr=False)


class Hooks:
    """Called by the generator between answers (the trace run's
    profiler starts and stops there) and around its phases; ``active``
    keeps the loop running past the window's end."""

    def active(self, now: float) -> bool:
        return False

    def between(self, now: float) -> None:
        pass

    def phase(self, name: str):
        return _NULL

    def answered(self, req: Request) -> None:
        pass


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()

RESULT_TIMEOUT_S = 120.0


def closed_loop(runtime, rag, streams: list, k: int,
                max_new_tokens: int, t_end: float,
                hooks: Hooks | None = None) -> list[Request]:
    """Every request submitted before ``t_end`` (or while ``hooks`` keep
    the loop running past it); answers are generated one at a time for
    the retrievals resolved by then.  ``streams`` holds one iterator of
    questions a user."""
    hooks = hooks or Hooks()

    def running(now: float) -> bool:
        return now < t_end or hooks.active(now)

    requests: list[Request] = []
    lock = threading.Lock()
    gen_q: queue.Queue = queue.Queue()
    stop = threading.Event()

    def client(user: int) -> None:
        for question in streams[user]:
            if stop.is_set() or not running(time.perf_counter()):
                return
            req = Request(user, question, time.perf_counter())
            with lock:
                requests.append(req)
            try:
                req.served = runtime.submit(question, k=k).result(
                    timeout=RESULT_TIMEOUT_S)
            except Exception as exc:  # noqa: BLE001 - counted as failed
                req.error = f"{type(exc).__name__}: {exc}"
                continue
            req.t_retrieved = time.perf_counter()
            gen_q.put(req)
            req.done.wait()

    threads = [threading.Thread(target=client, args=(u,), daemon=True,
                                name=f"pb-user-{u}")
               for u in range(len(streams))]
    for t in threads:
        t.start()
    try:
        while True:
            now = time.perf_counter()
            hooks.between(now)
            if not running(now):
                break
            try:
                with hooks.phase("pb.wait_retrieval"):
                    req = gen_q.get(timeout=0.05)
            except queue.Empty:
                if not any(t.is_alive() for t in threads):
                    break
                continue
            req.t_gen_start = time.perf_counter()
            try:
                with hooks.phase("pb.generate"):
                    req.out = rag.generate(req.question, req.served.results,
                                           max_new_tokens)
                req.t_done = time.perf_counter()
                hooks.answered(req)
            except Exception as exc:  # noqa: BLE001 - counted as failed
                req.error = f"{type(exc).__name__}: {exc}"
            req.done.set()
    finally:
        stop.set()
        while True:
            try:
                gen_q.get_nowait().done.set()
            except queue.Empty:
                break
        with lock:
            for req in requests:
                req.done.set()
        for t in threads:
            t.join(timeout=RESULT_TIMEOUT_S)
    return requests
