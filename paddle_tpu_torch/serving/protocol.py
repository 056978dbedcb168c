"""Wire protocol for the serving HTTP frontend (the port of
``paddle_tpu/serving/protocol.py``, stdlib code carried over).

OpenAI-style completions over token ids: the toy models in
``paddle_tpu_torch/models`` have no tokenizer, so ``prompt`` is a list of token
ids (a server configured with a ``tokenize`` callable also accepts
strings) and responses carry ``token_ids`` where the OpenAI schema
carries ``text``.  Everything here is pure data — parsing/validation of
the request body, JSON response bodies, and SSE framing — so
``server.py`` stays transport-only and tests can exercise the protocol
without a socket.

SSE wire format (``stream=true``)::

    data: {"id": ..., "object": "text_completion.chunk", "choices":
           [{"index": 0, "token_ids": [123], "finish_reason": null}]}\n\n
    ...
    data: {"id": ..., ... "token_ids": [], "finish_reason": "length"}\n\n
    data: [DONE]\n\n

Each event carries the tokens NEW since the previous event; the final
data event has empty ``token_ids``, the request's ``finish_reason`` and
a ``usage`` block (prompt/completion totals plus
``prompt_cached_tokens`` — the prefix-cache saving); the
literal ``[DONE]`` sentinel terminates the stream (the OpenAI
convention).
"""

from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

from .request import SamplingParams

SSE_DONE = b"data: [DONE]\n\n"

# request-body caps: a public frontend must bound what one POST can ask
# for before it ever touches the engine
MAX_BODY_BYTES = 1 << 20
MAX_PROMPT_TOKENS = 32768
MAX_MAX_TOKENS = 65536


class ProtocolError(ValueError):
    """Malformed/invalid request body → HTTP 400."""


@dataclass
class CompletionRequest:
    """Validated ``POST /v1/completions`` body."""

    prompt_ids: List[int]
    max_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    eos_token_id: Optional[int] = None
    stream: bool = False
    timeout: Optional[float] = None   # seconds; server clamps to its max
    priority: int = 0
    slo_ms: Optional[float] = None    # per-request latency objective:
                                      # scored into the serving_slo_*
                                      # goodput pair on finish
    retryable: bool = False           # opt-in transparent retry-from-
                                      # scratch if the owning replica
                                      # dies mid-stream:
                                      # greedy recompute re-delivers
                                      # identical tokens; off = such a
                                      # request finishes with
                                      # finish_reason="replica_failed"

    def sampling(self) -> SamplingParams:
        return SamplingParams(
            max_new_tokens=self.max_tokens, temperature=self.temperature,
            top_k=self.top_k, top_p=self.top_p,
            eos_token_id=self.eos_token_id, seed=self.seed)


def _typed(obj: dict, key: str, kinds, default, *, none_ok: bool = False):
    v = obj.get(key, default)
    if v is None and none_ok:
        return None
    if isinstance(v, bool) and bool not in (kinds if isinstance(kinds, tuple)
                                            else (kinds,)):
        raise ProtocolError(f"{key!r} must be {kinds}, got bool")
    if not isinstance(v, kinds):
        raise ProtocolError(
            f"{key!r} must be {getattr(kinds, '__name__', kinds)}, "
            f"got {type(v).__name__}")
    return v


def parse_completion_request(
        body: bytes,
        tokenize: Optional[Callable[[str], List[int]]] = None,
) -> CompletionRequest:
    """Parse + validate a completions body; raises :class:`ProtocolError`
    (→ 400) on anything malformed."""
    if len(body) > MAX_BODY_BYTES:
        raise ProtocolError(f"body exceeds {MAX_BODY_BYTES} bytes")
    try:
        obj = json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"body is not valid JSON: {e}") from None
    if not isinstance(obj, dict):
        raise ProtocolError("body must be a JSON object")

    prompt = obj.get("prompt")
    if prompt is None:
        raise ProtocolError("'prompt' is required")
    if isinstance(prompt, str):
        if tokenize is None:
            raise ProtocolError(
                "string prompts need a server-side tokenizer; "
                "send a list of token ids")
        prompt = tokenize(prompt)
    if isinstance(prompt, int) and not isinstance(prompt, bool):
        prompt = [prompt]
    if (not isinstance(prompt, list) or not prompt
            or not all(isinstance(t, int) and not isinstance(t, bool)
                       for t in prompt)):
        raise ProtocolError("'prompt' must be a non-empty list of token ids")
    if len(prompt) > MAX_PROMPT_TOKENS:
        raise ProtocolError(
            f"prompt of {len(prompt)} tokens exceeds {MAX_PROMPT_TOKENS}")

    max_tokens = _typed(obj, "max_tokens", int, 16)
    if not 1 <= max_tokens <= MAX_MAX_TOKENS:
        raise ProtocolError(
            f"'max_tokens' must be in [1, {MAX_MAX_TOKENS}]")
    temperature = float(_typed(obj, "temperature", (int, float), 0.0))
    # json.loads accepts the NaN/Infinity literals: a non-finite value
    # here would detonate inside the ENGINE thread's sampler, not this
    # handler — validate it out at the door
    if not math.isfinite(temperature) or temperature < 0.0:
        raise ProtocolError("'temperature' must be finite and >= 0")
    top_k = _typed(obj, "top_k", int, 0)
    if top_k < 0:
        raise ProtocolError("'top_k' must be >= 0")
    top_p = float(_typed(obj, "top_p", (int, float), 1.0))
    # NaN compares False against everything, so an unvalidated
    # NaN would silently disable the nucleus cut inside the traced
    # sampler; 0 would keep no tokens at all — both are 400s here
    if not math.isfinite(top_p) or not 0.0 < top_p <= 1.0:
        raise ProtocolError("'top_p' must be finite and in (0, 1]")
    timeout = _typed(obj, "timeout", (int, float), None, none_ok=True)
    if timeout is not None and (not math.isfinite(float(timeout))
                                or float(timeout) <= 0):
        raise ProtocolError("'timeout' must be finite and > 0 seconds")
    seed = _typed(obj, "seed", int, 0)
    if seed < 0:
        raise ProtocolError("'seed' must be >= 0")  # np rng requirement
    slo_ms = _typed(obj, "slo_ms", (int, float), None, none_ok=True)
    if slo_ms is not None and (not math.isfinite(float(slo_ms))
                               or float(slo_ms) <= 0):
        raise ProtocolError("'slo_ms' must be finite and > 0 milliseconds")

    return CompletionRequest(
        prompt_ids=[int(t) for t in prompt],
        max_tokens=max_tokens,
        temperature=temperature,
        top_k=top_k,
        top_p=top_p,
        seed=seed,
        eos_token_id=_typed(obj, "eos_token_id", int, None, none_ok=True),
        stream=_typed(obj, "stream", bool, False),
        timeout=None if timeout is None else float(timeout),
        priority=_typed(obj, "priority", int, 0),
        slo_ms=None if slo_ms is None else float(slo_ms),
        retryable=_typed(obj, "retryable", bool, False),
    )


# --- response bodies --------------------------------------------------------

def usage_body(prompt_tokens: int, completion_tokens: int,
               prompt_cached_tokens: int = 0) -> dict:
    """The ``usage`` accounting block:
    ``prompt_cached_tokens`` is how many prompt tokens the prefix cache
    served for free at admission — the client-visible cache saving."""
    return {
        "prompt_tokens": int(prompt_tokens),
        "completion_tokens": int(completion_tokens),
        "total_tokens": int(prompt_tokens) + int(completion_tokens),
        "prompt_cached_tokens": int(prompt_cached_tokens),
    }


def completion_body(request_id: str, model: str, token_ids: List[int],
                    finish_reason: Optional[str], prompt_tokens: int,
                    error: Optional[str] = None,
                    prompt_cached_tokens: int = 0) -> dict:
    """Non-streaming ``text_completion`` response object."""
    choice = {"index": 0, "token_ids": list(token_ids),
              "finish_reason": finish_reason}
    if error:
        choice["error"] = error
    return {
        "id": request_id,
        "object": "text_completion",
        "created": int(time.time()),
        "model": model,
        "choices": [choice],
        "usage": usage_body(prompt_tokens, len(token_ids),
                            prompt_cached_tokens),
    }


def chunk_body(request_id: str, model: str, token_ids: List[int],
               finish_reason: Optional[str],
               usage: Optional[dict] = None) -> dict:
    """One streaming ``text_completion.chunk`` event payload.  The FINAL
    chunk (the one carrying ``finish_reason``) also carries ``usage``
    with the per-request cache attribution, so SSE clients see the
    prefix-cache savings too."""
    out = {
        "id": request_id,
        "object": "text_completion.chunk",
        "model": model,
        "choices": [{"index": 0, "token_ids": list(token_ids),
                     "finish_reason": finish_reason}],
    }
    if usage is not None:
        out["usage"] = usage
    return out


def error_body(message: str, type: str = "invalid_request_error") -> dict:
    return {"error": {"message": message, "type": type}}


def sse_event(payload: dict) -> bytes:
    """Frame one JSON payload as a Server-Sent Events data line."""
    return b"data: " + json.dumps(
        payload, separators=(",", ":")).encode("utf-8") + b"\n\n"
