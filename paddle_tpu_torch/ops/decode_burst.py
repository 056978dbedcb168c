"""Device-resident decode-burst loop (the port of
``paddle_tpu/ops/decode_burst.py``).

:func:`run_burst` chains ``n_steps`` decode forwards: each iteration writes
the input token's KV into its pre-routed pool slot, runs the model,
samples the next token on the device and feeds it straight back as the
next input.  The JAX version traces a ``lax.fori_loop`` with a traced
trip count into one program; a CUDA graph cannot hold a trip count that
changes per call, so here the unit is ONE iteration,
:func:`burst_iteration`, on a static :class:`BurstState` that it updates
in place — the iteration index ``j`` included, as a device tensor — and
:func:`run_burst` is a loop over it.  The engine captures that iteration
once per bucket and replays it ``n_steps`` times.  Nothing crosses to the
host between iterations: tokens, positions, lengths, the active mask and
``j`` stay device tensors, EOS masking is a ``torch.where``, and only the
final ``[B, Nb]`` token buffer is copied to the host, by the caller.

* **Host-side clamp, device-side EOS masking.**  The engine clamps the
  burst length so no row can pass ``max_new_tokens`` or its pre-allocated
  slots; the only early exit is EOS.  A row that samples its EOS token
  emits it, then goes inactive: its remaining iterations write KV to the
  null page (block 0) and its buffer lanes stay ``-1`` (token ids are
  ``>= 0``, so ``-1`` means "not emitted").
* **Sampling keys advance on the device.**  Iteration ``j`` draws with key
  ``(seed, draw0 + j)`` — an active row emits one token per iteration, so
  ``draw0 + j`` IS its output position, and a burst replays the draws of
  per-step decode.  Keys are int64 here; the sampler masks them to 32
  bits, so a draw index past ``2**32 - 1`` wraps as the JAX u32 does.
* **KV discipline matches per-step decode.**  Iteration ``j`` writes the
  KV of its INPUT token at ``pos0 + j``; a row that emitted ``e`` tokens
  has written ``pos0 .. pos0 + e - 1``, the state the host's ``commit(e)``
  describes.

:func:`burst_oracle` is the twin: the same arithmetic with the active
mask and the tokens brought to the host every iteration, as plainly as it
can be written.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .sampling import sample_tokens


def _step_keys(keys, j):
    """Every row's ``(seed, draw)`` key at iteration ``j`` (an int, or a
    one-element int64 tensor on the keys' device): the seed column
    untouched, the draw column ``+ j`` (wrapped to 32 bits by the
    sampler)."""
    out = keys.clone()
    out[:, 1] += j     # a device add: no host read, no host-to-device copy
    return out


class BurstState(NamedTuple):
    """What a burst carries from one iteration to the next, all device
    tensors that :func:`burst_iteration` updates in place:

    ``ids`` ``[B, 1]`` int64 — each row's input token (its last emission);
    ``pos`` ``[B]`` int32 — that token's position (= committed KV length);
    ``lens`` ``[B]`` int32 — attention length after the slot write;
    ``act`` ``[B]`` bool — rows still emitting (padding rows never do);
    ``buf`` ``[B, Nb]`` int32 — the tokens so far, ``-1`` = not emitted;
    ``last`` ``[B, V]`` f32 — each row's last active logits (its rows are
    reset to 0 at iteration 0, so a buffer may be reused across bursts);
    ``j`` ``[1]`` int64 — the iteration index."""

    ids: torch.Tensor
    pos: torch.Tensor
    lens: torch.Tensor
    act: torch.Tensor
    buf: torch.Tensor
    last: torch.Tensor
    j: torch.Tensor


def burst_state(vocab, ids, pos, lens, active, Nb) -> BurstState:
    """A fresh state at iteration 0: copies of the row inputs, an empty
    token buffer, zero last logits."""
    B, dev = ids.shape[0], ids.device
    return BurstState(
        ids.clone(), pos.clone(), lens.clone(), active.clone(),
        torch.full((B, Nb), -1, dtype=torch.int32, device=dev),
        torch.zeros((B, vocab), dtype=torch.float32, device=dev),
        torch.zeros((1,), dtype=torch.int64, device=dev))


def burst_iteration(model_step, state: BurstState, eos_ids, slot_blocks,
                    slot_offsets, temps, top_ks, top_ps, keys, k_pools,
                    v_pools, any_sampled: bool = True):
    """Iteration ``state.j`` of a burst, in place on ``state``.

    Reads the iteration's slot column by a device index and ends by
    incrementing ``j`` in place, so the same call — the same captured
    graph — serves every iteration, and nothing is read back to the host.
    Returns ``(k_pools, v_pools)`` as ``model_step`` returns them.  The
    arguments are those of :func:`run_burst`."""
    ids, pos, lens, act, buf, last, j = state
    zero = torch.zeros_like(slot_blocks[:, 0])
    # inactive rows (padding, or finished mid-burst) write the null page
    sb = torch.where(act, slot_blocks.index_select(1, j)[:, 0], zero)
    so = torch.where(act, slot_offsets.index_select(1, j)[:, 0], zero)
    logits, k_pools, v_pools = model_step(ids, pos, lens, sb, so, k_pools,
                                          v_pools)
    # inactive rows sample greedy (temp 0): cheap, discarded
    if any_sampled:
        toks = sample_tokens(logits, torch.where(act, temps,
                                                 torch.zeros_like(temps)),
                             top_ks, top_ps, _step_keys(keys, j))
    else:
        toks = torch.argmax(logits, dim=-1).to(torch.int32)
    buf.index_copy_(1, j, torch.where(act, toks,
                                      torch.full_like(toks, -1))[:, None])
    last.copy_(torch.where(act[:, None], logits,
                           torch.where(j == 0, 0.0, last)))
    # EOS is emitted, then the row goes inactive
    still = act & (toks != eos_ids)
    ids.copy_(torch.where(still[:, None], toks[:, None].to(ids.dtype), ids))
    pos.copy_(torch.where(still, pos + 1, pos))
    lens.copy_(torch.where(still, lens + 1, lens))
    act.copy_(still)
    j.add_(1)
    return k_pools, v_pools


def run_burst(model_step, n_steps, vocab, ids, pos, lens, active, eos_ids,
              slot_blocks, slot_offsets, temps, top_ks, top_ps, keys,
              k_pools, v_pools, any_sampled: bool = True):
    """Run ``n_steps`` chained decode steps on the device: ``n_steps``
    calls of :func:`burst_iteration` on a fresh :func:`burst_state` (the
    inputs are not modified).

    Args:
      model_step: ``(ids[B,1], pos[B], lens[B], slot_blocks[B],
        slot_offsets[B], k_pools, v_pools) -> (last_logits[B,V], k_pools,
        v_pools)`` — one decode forward that writes the input token's KV
        into the routed slot (the engine closes it over its block tables).
      n_steps: int — burst length N ≤ the ``slot_blocks`` width Nb.
      vocab: int — logits width.
      ids: ``[B, 1]`` int64 — each row's input token (its last emission).
      pos: ``[B]`` int32 — that token's position (= committed KV length).
      lens: ``[B]`` int32 — attention length after the slot write
        (``pos + 1`` for real rows, 1 for padding rows).
      active: ``[B]`` bool — real rows; padding rows never emit.
      eos_ids: ``[B]`` int32 — per-row EOS token id, ``-1`` = none.
      slot_blocks / slot_offsets: ``[B, Nb]`` int64 — iteration ``j``'s KV
        slot per row (position ``pos + j``), from the pre-extended tables.
      temps / top_ks / top_ps / keys: the sampling quartet; ``keys[:, 1]``
        holds each row's FIRST draw index.
      k_pools / v_pools: per-layer pools, passed through ``model_step``.
      any_sampled: False when every row is greedy: the sampler then equals
        its argmax, which is taken directly instead of sorting the
        vocabulary.

    Returns:
      ``(tokens[B, Nb] int32 with -1 = not emitted, last_logits[B, V]
      f32, k_pools, v_pools)``, all on the device.
    """
    state = burst_state(vocab, ids, pos, lens, active, slot_blocks.shape[1])
    for _ in range(int(n_steps)):
        k_pools, v_pools = burst_iteration(
            model_step, state, eos_ids, slot_blocks, slot_offsets, temps,
            top_ks, top_ps, keys, k_pools, v_pools, any_sampled=any_sampled)
    return state.buf, state.last, k_pools, v_pools


def burst_oracle(model_step, n_steps, vocab, ids, pos, lens, active,
                 eos_ids, slot_blocks, slot_offsets, temps, top_ks, top_ps,
                 keys, k_pools, v_pools):
    """The twin of :func:`run_burst`: one decode step at a time over the
    SAME ``model_step``, with each row's state kept in host Python lists
    and the routing rebuilt from them every iteration."""
    B, Nb = slot_blocks.shape
    dev = slot_blocks.device
    buf = [[-1] * Nb for _ in range(B)]
    last = torch.zeros((B, vocab), dtype=torch.float32, device=dev)
    act = active.tolist()
    cur_ids = ids[:, 0].tolist()
    cur_pos, cur_lens = pos.tolist(), lens.tolist()
    eos = eos_ids.tolist()

    def put(x, like):
        return torch.tensor(x, dtype=like.dtype, device=dev)

    for j in range(int(n_steps)):
        sb = [int(slot_blocks[i, j]) if act[i] else 0 for i in range(B)]
        so = [int(slot_offsets[i, j]) if act[i] else 0 for i in range(B)]
        logits, k_pools, v_pools = model_step(
            put(cur_ids, ids)[:, None], put(cur_pos, pos),
            put(cur_lens, lens), put(sb, slot_blocks),
            put(so, slot_offsets), k_pools, v_pools)
        row_temps = torch.where(torch.tensor(act, device=dev), temps,
                                torch.zeros_like(temps))
        toks = sample_tokens(logits, row_temps, top_ks, top_ps,
                             _step_keys(keys, j)).tolist()
        for i in range(B):
            if not act[i]:
                continue
            buf[i][j] = toks[i]
            last[i] = logits[i]
            if toks[i] == eos[i]:
                act[i] = False
                continue
            cur_ids[i] = toks[i]
            cur_pos[i] += 1
            cur_lens[i] += 1
    return (torch.tensor(buf, dtype=torch.int32, device=dev), last,
            k_pools, v_pools)
