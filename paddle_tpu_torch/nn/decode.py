"""Sequence decoding: the port of ``paddle_tpu/nn/decode.py``
(``Decoder``, ``BeamSearchDecoder``, ``dynamic_decode``).

The search is the JAX package's, step for step:

* ``initialize`` repeats each initial state ``beam_size`` times along the
  batch (``[batch * beam, ...]``, a sample's beams adjacent) and scores
  beam 0 at 0 and the others at -1e9, so the first step expands one beam;
* a step embeds the tokens, runs ``cell(inputs, states)`` and
  ``output_fn``, takes the log-softmax, lets a finished beam emit only
  ``end_token`` at score 0 (so it keeps its total), adds the beams'
  scores and keeps the ``beam_size`` best of ``beam * vocab`` per sample;
  the states are gathered by each survivor's parent beam;
* ``dynamic_decode`` loops on the host until every beam has finished or
  ``max_step_num`` steps, reading ``finished.all()`` once a step (the one
  host read of a step), then follows the parents back (``gather_tree``)
  and measures each sequence up to its first ``end_token``, inclusive (its
  full length without one) on the backtraced sequences.

``lax.top_k`` breaks ties by the lower index of ``beam * vocab``, and the
order ``torch.topk`` gives among equal values is not specified on either
device, so a step ranks by a stable descending sort instead: equal totals
keep their index order on the CPU and on the card.  Scores are in the
logits' dtype; tokens, parents and sequences are int64 (the JAX package's
are int32).  Everything stays on the cell's device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .functional.common import gather_tree

__all__ = ["Decoder", "BeamSearchDecoder", "dynamic_decode", "gather_tree"]


class Decoder:
    """The ``initialize`` / ``step`` / ``finalize`` contract that
    :func:`dynamic_decode` drives."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        raise NotImplementedError


class BeamSearchDecoder(Decoder):
    """Beam search over a step cell: ``cell(inputs, states) -> (outputs,
    new_states)``, ``states`` one tensor or a tuple of tensors with a
    leading ``batch * beam`` axis; ``embedding_fn`` maps token ids to the
    cell's inputs, ``output_fn`` the cell's outputs to vocabulary logits
    (the outputs are the logits when it is None)."""

    def __init__(self, cell, start_token: int, end_token: int,
                 beam_size: int, embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """``x`` ``[batch, ...]`` repeated ``beam_size`` times along the
        batch, a sample's copies adjacent: ``[batch * beam_size, ...]``, as
        ``initialize`` tiles the states (Paddle's name; the JAX package has
        no such method)."""
        return x.unsqueeze(1).expand(x.shape[0], beam_size, *x.shape[1:]) \
            .reshape(x.shape[0] * beam_size, *x.shape[1:])

    def initialize(self, inits):
        """``inits``: the initial cell states (a tensor or a sequence of
        them) with a leading batch axis."""
        states = [inits] if isinstance(inits, torch.Tensor) else list(inits)
        batch, K = states[0].shape[0], self.beam_size
        tiled = [self.tile_beam_merge_with_batch(s, K) for s in states]
        dev = tiled[0].device
        log_probs = torch.where(torch.arange(K, device=dev) == 0, 0.0,
                                -1e9).expand(batch, K)
        tokens = torch.full((batch, K), self.start_token, dtype=torch.int64,
                            device=dev)
        finished = torch.zeros((batch, K), dtype=torch.bool, device=dev)
        return tokens, (tiled, log_probs, finished)

    def step(self, time, inputs, states, **kwargs):
        tiled, log_probs, finished = states
        batch, K = log_probs.shape
        x = inputs.reshape(-1)
        if self.embedding_fn is not None:
            x = self.embedding_fn(x)
        out, new_states = self.cell(x, tiled[0] if len(tiled) == 1
                                    else tuple(tiled))
        if self.output_fn is not None:
            out = self.output_fn(out)
        V = out.shape[-1]
        step_lp = F.log_softmax(out, dim=-1).reshape(batch, K, V)
        # built with no host value (an indexed store of one copies it from
        # the host and syncs): 0 at end_token, -1e9 elsewhere
        eos_only = torch.where(
            torch.arange(V, device=step_lp.device) == self.end_token, 0.0,
            -1e9).to(step_lp.dtype)
        step_lp = torch.where(finished[..., None], eos_only, step_lp)
        total = (log_probs[..., None] + step_lp).reshape(batch, K * V)
        ranked, order = torch.sort(total, dim=-1, descending=True,
                                   stable=True)
        top_lp, flat_idx = ranked[:, :K], order[:, :K]
        parent = flat_idx // V
        token = flat_idx % V
        gidx = (torch.arange(batch, device=parent.device)[:, None] * K
                + parent).reshape(-1)
        new_states = ([new_states] if isinstance(new_states, torch.Tensor)
                      else list(new_states))
        retiled = [s.index_select(0, gidx) for s in new_states]
        new_finished = finished.gather(1, parent) | (token == self.end_token)
        return ((token, parent), token, (retiled, top_lp, new_finished),
                new_finished)

    def finalize(self, outputs, final_states, sequence_lengths):
        ids = torch.stack([t for t, _ in outputs])          # [T, B, K]
        parents = torch.stack([p for _, p in outputs])
        return gather_tree(ids, parents), final_states


def dynamic_decode(decoder: Decoder, inits=None, max_step_num: int = 100,
                   output_time_major: bool = False, impute_finished=False,
                   is_test=False, return_length: bool = False, **kwargs):
    """Drive ``decoder`` until every sequence has finished or
    ``max_step_num`` steps; returns ``(outputs, final_states)`` (and the
    lengths with ``return_length``), outputs ``[batch, beam, time]``
    (``[time, batch, beam]`` with ``output_time_major``).  ``is_test`` is
    accepted and unused; ``impute_finished=True`` raises, as in the JAX
    package (the step already masks finished beams)."""
    if impute_finished:
        raise NotImplementedError(
            "dynamic_decode(impute_finished=True) is not supported: "
            "finished-beam outputs are masked inside BeamSearchDecoder."
            "step (end-token-only at score 0), which covers the "
            "reference's use of the flag")
    inputs, states = decoder.initialize(inits)
    outputs = []
    for t in range(int(max_step_num)):
        step_out, inputs, states, finished = decoder.step(t, inputs, states,
                                                          **kwargs)
        outputs.append(step_out)
        if bool(finished.all()):
            break
    seqs, final_states = decoder.finalize(outputs, states, None)
    end = getattr(decoder, "end_token", None)
    T = seqs.shape[0]
    if end is not None:
        is_end = seqs == end
        first = is_end.to(torch.int32).argmax(0) + 1
        lengths = torch.where(is_end.any(0), first, T)
    else:
        lengths = torch.full(seqs.shape[1:], T, dtype=torch.int64,
                             device=seqs.device)
    if not output_time_major:
        seqs = seqs.permute(1, 2, 0)
    if return_length:
        return seqs, final_states, lengths
    return seqs, final_states
