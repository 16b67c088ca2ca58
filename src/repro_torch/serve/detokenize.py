"""Background detokenize/stream thread — host post-processing off the hot
path.

The scheduler commits tokens at host-visible points (``finish_prefill`` /
``commit_decode``); detokenization and the per-request stream callbacks
are *host* work that would otherwise sit between two device dispatches.
:class:`AsyncDetokenizer` moves it onto a single background consumer
thread so it overlaps device execution:

  * the scheduler ``push``es ``(request, token, final)`` at each commit —
    a queue append, nothing else, so the policy loop never blocks on a
    slow callback;
  * ONE consumer thread drains the queue in FIFO order, detokenizes and
    invokes the request's ``stream_callback`` with a
    :class:`~repro_torch.serve.api.StreamEvent` — a single consumer makes the
    delivery order exactly the global commit order, per request and
    across requests;
  * ``drain()`` blocks until every pushed event has been delivered and
    then re-raises the first callback/detokenizer exception, so errors
    surface at a deterministic point instead of dying on a daemon
    thread (the scheduler's commit loop is never unwound mid-batch);
  * timing is NOT captured here: TTFT/TPOT stamps live on the request,
    written by the scheduler at commit (see
    :class:`~repro_torch.serve.api.RequestTiming`), so stream lag cannot skew
    SLO numbers;
  * ``detok_backlog_peak`` records the deepest the queue ever got — the
    observable for "host post-processing is falling behind the device".

The thread starts lazily on the first push (engines that never stream
never spawn it) and is a daemon, so an abandoned engine cannot hang
interpreter shutdown; ``close()`` retires it deterministically.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable

import numpy as np

from repro_torch.serve.api import StreamEvent

__all__ = ["AsyncDetokenizer", "default_detokenize"]

_SENTINEL = object()


def default_detokenize(token: Any) -> str:
    """Placeholder vocabulary-free detokenizer: the token id as text.

    Real deployments pass a tokenizer's ``decode``; the serving stack
    only needs *some* token->text function to exercise the streaming
    pipeline (ordering, backlog, drain semantics are tokenizer-blind).
    """
    if token is None:
        return ""
    if np.ndim(token) == 0:
        return f"<{int(token)}>"
    return "<" + ",".join(str(int(t)) for t in np.ravel(token)) + ">"


class AsyncDetokenizer:
    """Ordered background detokenize + stream-callback delivery."""

    def __init__(self, detokenize: Callable[[Any], str] | None = None,
                 counters=None):
        self._detok = detokenize or default_detokenize
        self._counters = counters
        self._q: queue.Queue = queue.Queue()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._exc: BaseException | None = None
        self._next_index: dict[int, int] = {}
        self._closed = False

    # ------------------------------------------------------------------
    # producer side (the scheduler's commit points)
    # ------------------------------------------------------------------

    def push(self, req, token: Any, final: bool) -> None:
        """Enqueue one committed token for ``req`` (no-op for requests
        without a ``stream_callback``).  Called by the scheduler at the
        commit point; must never block or raise on the policy path —
        callback exceptions surface on :meth:`drain`/:meth:`close`."""
        cb = getattr(req, "stream_callback", None)
        if cb is None:
            return
        if self._closed:
            raise RuntimeError("AsyncDetokenizer is closed")
        self._ensure_thread()
        idx = self._next_index.get(req.req_id, 0)
        self._next_index[req.req_id] = idx + 1
        self._q.put((req.req_id, idx, token, cb, final,
                     getattr(req, "t_last_token", 0.0)))
        if self._counters is not None:
            depth = self._q.qsize()
            if depth > self._counters.get("detok_backlog_peak"):
                # a peak, not an increment — written directly (the
                # counter dict is open-vocabulary)
                self._counters.counters["detok_backlog_peak"] = depth

    # ------------------------------------------------------------------
    # consumer thread
    # ------------------------------------------------------------------

    def _ensure_thread(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._worker, name="serve-detokenize",
                    daemon=True,
                )
                self._thread.start()

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is _SENTINEL:
                    return
                req_id, idx, token, cb, final, t_commit = item
                try:
                    text = self._detok(token)
                    cb(StreamEvent(req_id=req_id, index=idx, token=token,
                                   text=text, final=final,
                                   t_commit=t_commit))
                except BaseException as e:   # noqa: BLE001 — surfaced on drain
                    if self._exc is None:
                        self._exc = e
            finally:
                self._q.task_done()

    # ------------------------------------------------------------------
    # shutdown / synchronization
    # ------------------------------------------------------------------

    @property
    def backlog(self) -> int:
        return self._q.qsize()

    def drain(self) -> None:
        """Block until every pushed event has been delivered; re-raise
        the first exception a callback (or the detokenizer) raised."""
        if self._thread is not None:
            self._q.join()
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def close(self) -> None:
        """Drain, stop the consumer thread, and refuse further pushes.
        Idempotent; re-raises like :meth:`drain`."""
        if self._closed:
            return
        self._closed = True
        if self._thread is not None:
            self._q.join()
            self._q.put(_SENTINEL)
            self._thread.join(timeout=10.0)
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc
