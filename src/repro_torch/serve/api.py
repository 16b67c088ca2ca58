"""The stable typed client surface of :mod:`repro_torch.serve`.

Everything a *client* of the serving stack touches lives here, decoupled
from the internal policy/data-plane types:

  :class:`ServeRequest`
      What a client submits — prompt, token budget, optional per-request
      :class:`SamplingParams`, optional ``stream_callback`` (invoked with
      :class:`StreamEvent` records from the background detokenize thread,
      in commit order), optional explicit ``req_id`` (auto-allocated when
      omitted).
  :class:`ServeResult`
      What a client gets back from ``Engine.drain()`` /
      ``ReplicaRouter.drain()`` — the sampled tokens, terminal status, a
      :class:`RequestTiming` (enqueue / first-token / last-token
      timestamps captured at ``commit_decode``, the host-visible commit
      point — never at detokenize, so async streaming cannot skew the SLO
      numbers) and the request's peak page footprint.

The internal :class:`~repro_torch.serve.scheduler.Request` dataclass remains
the *scheduler-plane* type (fake data planes, scheduler unit tests build
it directly and drive ``Scheduler.submit``); passing one to
``Engine.submit`` / ``ReplicaRouter.submit`` is a hard :class:`TypeError`
— every client-facing path — benchmarks, the launch driver, the SLO
harness — speaks :class:`ServeRequest`/:class:`ServeResult` (lowered via
:func:`to_internal`).

Sampling is engine-global (one PRNG stream, one temperature per fused
dispatch), so per-request :class:`SamplingParams` are *validated* against
the engine's :class:`~repro_torch.serve.scheduler.ServeConfig` rather than
applied per-lane: a mismatch raises at submit instead of silently
sampling with the wrong knobs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

from repro_torch.serve.scheduler import Request, ServeConfig

__all__ = [
    "SamplingParams",
    "ServeRequest",
    "ServeResult",
    "RequestTiming",
    "StreamEvent",
    "to_internal",
]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs, validated against the engine config.

    The executor samples batches with one PRNG stream and one temperature
    per dispatch (on-device inside fused horizons), so these cannot vary
    *within* an engine — requests may state what they need and the engine
    enforces agreement at submit time.
    """

    greedy: bool = True
    temperature: float = 1.0

    def validate_for(self, cfg: ServeConfig) -> None:
        if self.greedy != cfg.greedy or (
            not self.greedy and self.temperature != cfg.temperature
        ):
            raise ValueError(
                f"sampling {self} conflicts with the engine's "
                f"ServeConfig(greedy={cfg.greedy}, "
                f"temperature={cfg.temperature}): sampling is engine-"
                "global (one PRNG stream / temperature per fused "
                "dispatch) — build an engine with matching config"
            )


@dataclasses.dataclass(frozen=True)
class StreamEvent:
    """One streamed token, delivered by the async detokenize thread."""

    req_id: int
    index: int                    # position in the request's output
    token: Any                    # the committed token (None on failure)
    text: str                     # detokenized text for this token
    final: bool                   # True on the request's last event
    t_commit: float               # perf_counter stamp of the host commit


@dataclasses.dataclass
class ServeRequest:
    """A client submission (``Engine.submit`` / ``ReplicaRouter.submit``).

    ``req_id`` is optional — the engine/router allocates the next free id
    when omitted.  ``stream_callback`` is invoked once per committed
    token with a :class:`StreamEvent`, from the background detokenize
    thread, in global commit order; exceptions it raises surface on
    ``drain()``.
    """

    prompt: np.ndarray
    max_new_tokens: int
    req_id: int | None = None
    sampling: SamplingParams | None = None
    stream_callback: Callable[[StreamEvent], None] | None = None
    share_prefix: bool = False

    def __post_init__(self) -> None:
        self.prompt = np.asarray(self.prompt, np.int32)
        if self.prompt.size == 0:
            raise ValueError("ServeRequest.prompt must be non-empty")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}"
            )


@dataclasses.dataclass(frozen=True)
class RequestTiming:
    """Per-request latency stamps (``time.perf_counter`` seconds).

    All three are captured by the *scheduler* at host-visible commit
    points — ``submit`` / ``finish_prefill`` / ``commit_decode`` — never
    by the detokenize thread, so asynchronous streaming can lag
    arbitrarily without skewing TTFT/TPOT.
    """

    enqueue: float
    first_token: float
    last_token: float

    @property
    def ttft(self) -> float:
        """Time to first token: queue wait + prefill."""
        return self.first_token - self.enqueue


@dataclasses.dataclass(frozen=True)
class ServeResult:
    """Terminal record for one request (``Engine.drain`` /
    ``ReplicaRouter.drain``)."""

    req_id: int
    tokens: tuple
    status: str                    # "done" | "failed"
    timing: RequestTiming
    pages_peak: int                # peak mapped-page footprint

    @property
    def ttft(self) -> float:
        return self.timing.ttft

    @property
    def tpot(self) -> float:
        """Mean time per output token over the decode tail."""
        n = len(self.tokens)
        return (self.timing.last_token - self.timing.first_token) \
            / max(n - 1, 1)

    @classmethod
    def from_request(cls, req: Request) -> "ServeResult":
        toks = tuple(
            int(t) if np.ndim(t) == 0 else np.asarray(t)
            for t in req.output
        )
        return cls(
            req_id=req.req_id, tokens=toks, status=req.status,
            timing=RequestTiming(enqueue=req.t_enqueue,
                                 first_token=req.t_first_token,
                                 last_token=req.t_last_token),
            pages_peak=req.pages_peak,
        )


def to_internal(sreq: ServeRequest, req_id: int | None = None,
                cfg: ServeConfig | None = None) -> Request:
    """Lower a client :class:`ServeRequest` onto the scheduler-plane
    :class:`Request` (sampling validated against ``cfg`` when given;
    ``req_id`` supplies the auto-allocated id when the client omitted
    one)."""
    if sreq.sampling is not None and cfg is not None:
        sreq.sampling.validate_for(cfg)
    rid = sreq.req_id if sreq.req_id is not None else req_id
    if rid is None:
        raise ValueError("req_id required: pass one explicitly or submit "
                         "through an Engine/ReplicaRouter (auto-allocates)")
    return Request(
        req_id=int(rid),
        prompt=sreq.prompt,
        max_new_tokens=sreq.max_new_tokens,
        share_prefix=sreq.share_prefix,
        stream_callback=sreq.stream_callback,
    )
