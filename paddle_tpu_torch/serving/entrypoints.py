"""User-facing serving entrypoints over :class:`EngineCore` (the port of
``paddle_tpu/serving/entrypoints.py``).

* :class:`LLM` — offline batch inference: hand it every prompt, it drives
  the continuous-batching loop to completion and returns per-request
  outputs in submission order.  At mp > 1 every rank of the mp group calls
  it with the same prompts (SPMD): the controller schedules, the followers
  follow its steps, and every rank returns the controller's outputs.
* :func:`stream_generate` — online single-request streaming over a shared
  engine: yields tokens as they decode while other requests keep batching.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Union

import torch

from .engine import EngineCore
from .request import Request, SamplingParams
from .scheduler import SchedulerConfig
from .tp import follow


class CompletionOutput:
    """What one request produced: tokens + why it stopped."""

    def __init__(self, req: Request):
        self.request_id = req.request_id
        self.prompt_ids = list(req.prompt_ids)
        self.token_ids = list(req.output_tokens)
        self.finish_reason = (req.finish_reason.value
                              if req.finish_reason else None)
        self.num_preemptions = req.num_preemptions
        self.error = req.error

    def __repr__(self):
        return (f"CompletionOutput(request_id={self.request_id!r}, "
                f"tokens={self.token_ids}, finish={self.finish_reason})")


class LLM:
    """Offline batch generation with continuous batching underneath.

    ``LLM(model)`` takes the JAX package's signature and builds its engine
    the same way: ``EngineCore(model, num_blocks=..., block_size=...,
    dtype=..., scheduler_config=SchedulerConfig(max_num_seqs=...),
    **engine_kw)`` — the legacy families unless ``engine_kw`` says
    otherwise.  ``LLM(model, config=EngineConfig(...))`` passes a whole
    config through ``engine_kw``; it then wins over the keywords."""

    def __init__(self, model, num_blocks: int = 256, block_size: int = 16,
                 dtype=None, max_num_seqs: int = 8, **engine_kw):
        self.engine = EngineCore(
            model, num_blocks=num_blocks, block_size=block_size,
            dtype=dtype if dtype is not None else torch.float32,
            scheduler_config=SchedulerConfig(max_num_seqs=max_num_seqs),
            **engine_kw)

    def generate(self, prompts: Sequence,
                 sampling_params: Union[SamplingParams,
                                        Sequence[SamplingParams], None] = None,
                 ) -> List[CompletionOutput]:
        """Submit every prompt, drain the engine, return outputs in
        submission order."""
        if sampling_params is None:
            params = [SamplingParams() for _ in prompts]
        elif isinstance(sampling_params, SamplingParams):
            params = [sampling_params for _ in prompts]
        else:
            params = list(sampling_params)
            if len(params) != len(prompts):
                raise ValueError("one SamplingParams per prompt required")
        eng = self.engine
        if eng.tp is not None and not eng.tp.is_controller:
            follow(eng)
            return eng.tp.share()
        reqs = [eng.add_request(p, sampling=sp)
                for p, sp in zip(prompts, params)]
        eng.run()
        if eng.tp is not None:
            eng.tp.release()
        outputs = [CompletionOutput(r) for r in reqs]
        return outputs if eng.tp is None else eng.tp.share(outputs)

    def summary(self) -> str:
        return self.engine.metrics.summary()


def stream_generate(engine: EngineCore, prompt_ids,
                    sampling: Optional[SamplingParams] = None,
                    request_id=None, priority: int = 0) -> Iterator[int]:
    """Submit one request to a (possibly shared) engine and stream its
    tokens; other in-flight requests keep decoding in the same batches."""
    req = engine.add_request(prompt_ids, sampling=sampling,
                             request_id=request_id, priority=priority)
    return engine.stream(req.request_id)
