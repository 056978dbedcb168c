#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout on a machine with a CUDA device and the
CUDA toolkit (``nvcc``)::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``paddle_tpu_torch/csrc/`` and runs
these phases, printing one JSON line for each:

``device``   the card (``nvidia-smi`` name and power limit, torch's name).
``build``    the four kernel sources in one build (one nvcc each, started
             together), and beside it the decode kernel in the worker
             processes' kernel directory (their ``--compile-cache``),
             and the data loader's host library ``csrc/shm_ring.cpp``
             (g++); nvcc's ptxas report goes to standard error.  Every line also
             carries ``script_s``, the script's wall seconds so far.
``custom_op`` the custom-op path: the scale kernel (``csrc/scaled.cu``)
             against its twin bit for bit (``torch.equal``) over fp32, bf16
             and fp16, alpha in {2, 3, 0.1, -3.5}, 1 to 1,000,003
             elements, aligned and at storage offset 3, plus a planted
             fault the check must refuse; the JAX docstring example,
             ``ops/scaled.py::my_scaled``, called 3 times on a [8192,
             4096] bf16 tensor with its backward (launches = 3, gradient
             exactly 9: three runs of the custom bwd); one call under
             torch.profiler (taken again, twice at most, when it recorded
             no scale kernel), whose ``my_scaled`` range must hold the
             kernel; the kernel, the op, its twin and ``torch.mul`` timed
             at that shape by CUDA events, the kernel and ``torch.mul``
             also by profiler device time, beside the bound, and the two
             in turns (40 rounds of 5 calls each, order reversed every
             round; medians and spread by both clocks); a
             ``cpp_extension.load`` host op on a CUDA tensor.
``kernels``  the ragged kernel against its plain PyTorch version on the same
             inputs, each (token, head) row against its twin row by
             ``flash.rowwise_error`` and absolutely (fp32 within 1e-4; bf16
             within 2e-2 of the plain version run in fp32 on the same bf16
             inputs), over the packings of the CPU tests at tiny shapes (the
             simple route) and over Llama-3-8B's attention shapes (H=32,
             Hkv=8, D=128, bs=16, T in {8, 64, 256, 512}, tables of up to 64
             pages; bf16 takes the tma route, fp32 the simple one), plus GQA
             7:1 (H=28, Hkv=4), a chunk starting mid-page and decode-only
             steps on the tma route; the device work list against its twin
             at each packing; a planted fault, the kernel's output with the
             last page of each chunk token's walk dropped, which the row
             check must refuse at T=512; the launches of each route.  Times
             from CUDA events: the kernel, the plain version, one PyTorch
             library call computing the same function
             (``scaled_dot_product_attention`` over the K/V gathered to a
             dense context beforehand, a yardstick the port never calls)
             and the bound, the larger of the operations over the card's
             peak rate and the bytes over its memory rate; at T=512 bf16
             also the profiler's device time of every device function of
             the call (work list, chunk, decode and combine kernels).  And
             the packing speculative decoding gives it (``spec_packing``):
             16 verify rows of 2-5 tokens starting mid-page at random
             positions up to 2048, 4 decode rows and a 128-token chunk in a
             T=256 bucket, bf16 on the tma route and fp32 on the simple
             one, checked row by row and timed like the others, with the
             launches of each route.
``decode_kernels``  the paged decode kernel against its plain version,
             each (row, head) row against its twin row by
             ``flash.rowwise_error`` and absolutely (fp32 within 1e-4, bf16
             within 2e-2 of the plain version in fp32 on the same bf16
             inputs), over the CPU tests' decode buckets B x W in {1,2,4,8}^2
             and Llama-3-8B's decode shapes (H=32, Hkv=8, D=128, bs=16, B in
             {1, 4, 16}, random lengths up to 2112 tokens in tables padded
             to 256 pages; bf16 takes the mma route, fp32 the simple one);
             a planted fault, the twin with each row's last span dropped,
             which the row check must refuse at B=16; each row's bits alone
             (B=1), inside B=16, at table width 2W and on a second run;
             timed like the ragged kernel, plus the kernel's device time per
             call read from torch.profiler (walk and combine), the host's
             cost a call (event time minus device time, and the wrapper's
             own CPU time by time.perf_counter), the span plan's work items
             and, at B=1 and 16 bf16, the device time at spans of 32 and 64
             tokens beside the 128 the kernel uses; the launches of each
             route.
``identity`` Llama-3-8B at full width cut to 2 layers (4 until PR 15: the
             script's time limit), fp32, random weights
             from a seeded generator: 8 prompts sharing a 64-token prefix
             through the unified engine with the kernel and with the plain
             version, and with the step graphs and under
             ``graphs.disable_graphs()`` (greedy and seeded sampled; and a
             bf16 model of the same widths on the tma route, graphs against
             eager); the tokens of each pair must be identical, the kernel
             must have launched once per layer per engine step through the
             replays (fp32 on the simple route, bf16 on the tma route) and
             each run's ``ragged_trace_count`` must equal its bucket set
             (0 eagerly).  A planted fault: replays whose static inputs are
             never refreshed must give other tokens.
``identity_telemetry``  the identity model (fp32, simple route) and a bf16
             model of the same widths (tma and mma routes), through the
             unified engine and the legacy one with decode bursts of 8, each
             with every telemetry hook on (the defaults, the numerics
             auditor at ``sample_every=1``, a metrics history with the
             default alert rules, a flight recorder) and with every one off:
             greedy tokens and capture counts equal, launches = steps x
             layers both ways; the step profiler's scheduled tokens equal
             the scheduler's and its bucket sets the engine's; the pool
             invariant on the timeline; the fp32 runs audit clean at the
             default 1e-4 tolerance (0 divergences, 0 oracle failures; the
             largest logit gap printed), no oracle failure anywhere.
``audit_fault``  a planted fault: the decode and ragged wrappers' output
             negated (a call pinning the plain twin, the oracle's, left
             alone); an fp32 unified and an fp32 legacy engine (no bursts:
             a burst is not audited) go degraded with exactly one repro
             under ``max_repro_bytes``, and ``replay_repro`` of it on a clean
             engine re-executes the step on the card and reproduces it.
``spec_identity``  the identity model (fp32, simple route): 8 prompts of
             100-600 tokens, each ``R + S + O + S`` (``R`` and ``S`` seeded
             random texts, ``O`` the model's own greedy continuation of
             ``R + S``, so the n-gram proposer drafts ``O`` again), 32 new
             tokens each, through the unified engine with speculative
             decoding off and on (``SpecConfig(k=4)``, 256 tokens a step),
             greedy and seeded sampled: identical tokens, strictly fewer
             steps greedy, drafts accepted, the ragged kernel launched once
             per layer per step through the replays.
``disagg_identity``  the same prompts through a prefill and a decode
             replica (``roles=["prefill", "decode"]``, both unified, one
             shared model module, not scaled): the tokens of one unified
             engine, one KV hand-off per request served on the decode
             replica from the imported pages (its admission found every
             handed-off block cached) by replayed graphs, both pools'
             invariant, one capture per key on each replica, the launch
             rule over both replicas (counters set to 0 just before the
             fleet runs).
``server_identity``  the same prompts as completions (plain and streamed)
             through ``CompletionServer`` over a dp=1 unified fleet with
             the supervisor on: the tokens of ``LLM.generate`` on the same
             engine config; the launch rule on the simple route.
``serve``    Llama-3-8B at full width and depth, bf16 weights and pools:
             16 prompts of 256-2048 tokens, 64 greedy tokens each, through
             ``LLM.generate`` with the step graphs (the cold pass: the
             captures happen inside it); output tokens/s, mean TTFT, mean
             inter-token latency, the mean wall time of one unified step,
             engine steps, kernel launches (= steps x layers, every one on
             the tma route), captures and their seconds, replays, and peak
             device memory (allocated and reserved).  Then the same on
             fresh prompts of the same lengths twice: a warm pass (replays
             only) and an eager pass.
``profile``  torch.profiler over a short window of the same engine: device
             time by kernel, the ragged kernel's and the matrix products'
             shares, and the device's idle share, with the captures and
             replays of the window (a kernel share of 0 fails the phase:
             the kernels must show inside graph replays).
``serve_telemetry``  on the serve engine (telemetry on by default): the
             pool invariant and the step profiler against the scheduler and
             the bucket sets; a capture window of 4 steps with
             ``device_trace=True`` whose chrome trace holds 4
             ``engine_step`` spans and whose torch.profiler trace under
             ``log_dir`` names the ragged kernel inside graph replays
             (three windows at most, as the profile phase); a GET of
             ``/metrics`` from ``start_metrics_server(port=0)``; then warm
             passes with the defaults and with every telemetry field off in
             turns (on, off, off, on) and one with the auditor at its
             default ``sample_every=16``: tokens/s, mean ITL, the warm
             unified step's ms, ``host_split`` with its ``telemetry`` part,
             and the auditor's snapshot bytes and peak memory over the
             defaults.
``identity_legacy``  the identity model and prompts through the JAX
             package's default serving call, ``LLM(model, num_blocks=...,
             block_size=16, max_num_seqs=8)`` (the legacy prefill / chunk /
             decode families) with a 256-token prefill budget, and through
             an LLM with decode bursts of 8: the decode kernel and the plain
             version give identical greedy tokens, so do bursts with
             strictly fewer host round trips, and so do the step graphs
             and ``disable_graphs()`` with and without bursts, greedy and
             seeded sampled; the decode kernel launched (decode steps +
             burst iterations) x layers times through the replays, all on
             the simple route (fp32); ``decode_trace_count`` and
             ``burst_trace_count`` equal their bucket sets.
``prefill_identity``  the legacy prefill families as step programs on the
             identity model: the identity prompts and two fresh prompts of
             150 and 230 tokens (one one-shot bucket of 256 for two
             lengths) through a legacy LLM with a 256-token prefill budget
             and the prefix cache off, with the step graphs and under
             ``disable_graphs()``: the same tokens;
             ``prefill_trace_count`` and its metric equal to the prefill
             and chunk keys in use, each captured once; a second pass of
             the same prompts captures nothing and gives the same tokens.
``aot_identity``  AOT artifacts on the identity model: a legacy engine with
             decode bursts of 8 and a unified one (16 sequences, 512
             tokens a step), each saved at max_seq_len 1024 from a saving
             engine, loaded, bound and warmed on a fresh engine: the legacy
             lattice's 138 keys (11 prefill, 77 chunk, 35 decode, 15
             burst), 2 captures a saved bucket at the warm and none while
             serving, the tokens of the same engine without an artifact,
             every trace counter 0, the launch rule (simple routes), an
             oversize request aborted at admission; the legacy artifact
             with its device capability edited, and with its kernel's hash
             edited, each refuses to load.
``serve_legacy``  the serve model and prompts through the legacy ``LLM``
             in bf16, without and with decode bursts of 8, each as the
             serve phase's three passes: the serve numbers, the steps of
             each family, the mean wall time of one launch of each (and,
             from the step profiler, of each program: the one-shot prefill
             graphed in the warm pass against eager in the eager one), the
             launch rule (every launch on the mma route), captures and peak
             memory, the step profiler against the scheduler and the pool
             invariant.  Then a profile window on each of the two engines: the
             decode kernel's, the matrix products' and the idle shares.
``spec``     the serve model (full depth, bf16, unified, 512 tokens a
             step, ``SpecConfig(k=4)``): 16 ``R + S + O + S`` prompts of
             256-2048 tokens, 128 new tokens each, greedy and seeded sampled
             (temperature 0.8, top_p 0.95), spec off then spec on, each a
             cold pass (the captures) and a warm pass of the same prompts
             (prefix cache off, so both do the same work): steps,
             tokens/s, mean TTFT and ITL, accept ratio (the runs here and
             in spec_identity on the model with its token embedding scaled
             by 65536 in bf16 and 4096 in fp32, a first-order chain that
             writes its own continuation again after an echo, and sampled
             runs with its LM head scaled by 8 too: a random model's
             drafts are otherwise never accepted), captures and their
             keys (one capture per key, none in the warm pass, every key
             of the one unified family inside the plain plan's lattice,
             and the keys spec off lacks listed and at most the verify
             rows' token buckets, 32 to 128, at each table bucket); greedy
             spec on takes strictly fewer steps; the launch rule on the
             tma route; the share of tokens identical to spec off and, at
             each request's first divergence, spec off's top-2 logit gap
             (a no-cache forward of the prompt and the tokens before it).
``disagg``   the spec prompts without spec through a prefill and a decode
             replica on the one card (unified, bf16, the one model, not
             scaled): one hand-off per request served from the imported
             pages by replayed graphs, both pools' invariant, one capture
             per key, the launch rule over both replicas (tma), blocks,
             bytes and ms of each hand-off, the tokens, TTFT and ITL (from
             the request timelines) against one unified engine on the same
             prompts; then one 2048-token hand-off taken apart, each part
             timed alone (gather, device-to-host copy, digest,
             verification, pool import, scatter) and the scattered pages
             compared bit for bit.
``server``   ``CompletionServer`` on loopback with the supervisor on, over a
             dp=1 unified fleet and a dp=2 legacy fleet with bursts of 8
             (both replicas share the one model): two rounds of 24
             concurrent completions of 64 tokens (8 streamed, 8 plain, 8
             sharing a 256-token prefix), the first taking the captures;
             a drain begins with all 24 of the second in flight and every
             one must finish whole; the prefix-sharing ones on one
             replica, ``/metrics`` with the fleet, per-replica and
             hand-off series, ``/v1/debug/compiles`` listing captures,
             ``/v1/requests/{id}`` a timeline, every replica captured;
             the launch rule over the replicas and both rounds (the
             ragged kernel on tma, the decode kernel on mma); tokens/s,
             TTFT and ITL against the serve phase's warm pass.
``aot_boot``  the serve model's widths (bf16) cut to 4 layers (32 until
             PR 15: the script's time limit) in worker processes booted off an AOT artifact saved in the run from an
             in-process saving engine (legacy families, bursts of 8, at
             the 2112-token max_seq_len the server rounds need): 2
             workers with ``--aot-path --warm`` and a fresh, empty
             ``--compile-cache`` (no ``nvcc``: it stays empty), 0 trace
             counts and 2 captures a saved bucket each; a server round
             (the full serve prompts) captures nothing after the ready
             lines and keeps the launch rule (decode on mma); a
             ``kill -9`` heals off the artifact (the respawn warms too),
             and a second round captures nothing; boot, ready and warm
             seconds, the heal's seconds.
``procfleet_identity``  the identity model built in worker processes
             (``python -m paddle_tpu_torch.serving.worker``, preset
             ``llama3_8b`` at 2 layers, fp32, the same seeded generator):
             a ``ProcessFleet`` of 2 unified workers gives one in-process
             engine's greedy tokens on the spec prompts (32 new tokens);
             a second wave with the stream's worker killed by SIGKILL
             mid-stream loses no request and gives the same tokens, with
             exactly one ``engine_death`` bundle embedding the dead
             worker's mirrored events and the worker respawned under a
             new pid; then a prefill + decode worker pair: every request
             handed off across processes and served on the decode worker
             from the imported pages (blocks x 16 tokens cached), the same
             tokens.  Per worker, read over the wire (``describe``): ragged
             launches = its unified steps x layers on the simple route.
``procfleet``  the serve model (seed 1, bf16) cut to 4 layers (32 until
             PR 15) built in each worker: ``CompletionServer`` with the supervisor over
             ``--workers`` fleets of 2 unified workers and of 2 legacy
             workers with bursts of 8, each on the server phase's two
             rounds (the second drained in flight): every completion
             whole, ``/readyz`` ``dp=2``, ``/metrics`` with both replicas'
             merged series, ``/v1/debug/wire`` enabled with its host /
             wire / engine shares, zero restarts, respawns and heartbeat
             timeouts, the launch rule per worker (unified: ragged on tma
             and no decode launch; legacy: decode on mma and no ragged
             launch); tokens/s, TTFT and ITL beside the server phase's,
             each worker's boot seconds and ``PADDLE_TPU_COMPILE_CACHE``
             counts (every fleet boots on the one kernel directory the
             identity fleet filled first).  Then one 2048-token hand-off
             from a prefill worker to a decode worker, by part.
``flash_kernels``  the three flash kernels (forward, dQ, dK/dV) against
             their twins on the same inputs by ``flash.rowwise_error``,
             each output row against its twin row (fp32 within 1e-4; bf16
             within 2e-2 of the twins run in fp32 on the same bf16 inputs;
             lse within 1e-4), at the CPU tests' shapes, at the edges of
             the bf16 TMA kernels' tiles (S = 130 and 4000, GQA groups of
             1, 2, 4 and 8 heads, head dims 64 and 128, and groups of 7 and
             3 heads, which fill 126 of a block's 128 rows), on unaligned
             bf16 views that must take the counted copy route (3 copies,
             results bit-equal to contiguous inputs), and at Llama-3-8B's
             training shape (H=32, Hkv=8, D=128, causal, B=2, S=4096),
             where each output with its last tile zeroed must fail the
             same check; timed there like the other kernels, with the
             achieved TFLOP/s and the bound's share of the time; the
             library yardsticks are ``scaled_dot_product_attention``
             (causal, GQA) and its autograd backward, which computes dQ,
             dK and dV in one.
``train_identity``  Llama-3-8B widths cut to 2 layers, fp32, B=1, S=1024:
             4 AdamW steps with the kernels and with
             ``use_flash_attention=False``; the losses agree within 1e-4
             relative and each kernel launched 4 x 2 times.
``train``    the training path at full Llama-3-8B width cut to 4 layers
             (full depth needs ~128 GB of weights, gradients and AdamW
             state), bf16 with fp32 master weights, AdamW under a cosine
             schedule, B=2, S=4096 on examples/pretrain_llama.py's
             synthetic corpus: 2 warm-up and 8 timed steps of
             ``model(ids) -> criterion -> backward -> step -> clear_grad``;
             losses (finite, falling), ms a step, tokens/s, MFU against
             989 TFLOP/s with PaLM's count (and without the input
             embedding in N), peak memory, and launches =
             steps x layers for each kernel.
``train_profile``  torch.profiler over 2 more train steps: each flash
             kernel's and the matrix products' share of device time, each
             flash kernel's device time a launch, the top kernels and the
             idle share; on a line before it (``train_clocks``), the card's
             SM clock, power draw and temperature sampled by nvidia-smi
             before and after the window.  The ``kernels`` line's flash
             rows take their ``device_ms`` from this window.
``gpt_train_identity``  GPT-3 6.7B widths (``GPTConfig()``: vocab 50304,
             hidden 4096, 32 heads of 128, MHA) cut to 2 layers, fp32,
             B=1, S=1024: 4 AdamW steps through the flash kernels, 4
             with GPT's attention pinned to the composite paths
             (``use_pallas=False``, patched in this script only) and 4
             through the kernels with a planted fault (the attention
             output's last 64 rows zeroed); the kernel run's losses agree
             with the composite's within 1e-4 relative and its first
             step's attention gradients within 1e-4 of their largest
             entry, the planted run fails that gate, and each kernel
             launched 4 x 2 times.
``gpt_train``  first the three flash kernels against their twins at
             GPT's shape and layout in bf16 (B=4, S=2048, 32 heads of 128,
             causal, q/k/v as views of one [B, S, 3, H, D] buffer): TMA
             reads them in place (no copy), every row within 2e-2, each
             planted fault fails.  Then the GPT training path at full
             6.7B width cut to 4 layers (the full depth's weights,
             gradients and AdamW state need ~107 GB), bf16 with fp32
             master weights, AdamW under LinearWarmup ->
             CosineAnnealingDecay, B=4, S=2048 on the synthetic corpus: 2
             warm-up and 8 timed steps with no sync inside the loop;
             losses (finite, falling), ms a step, tokens/s, MFU against
             989 TFLOP/s through the port's ``TrainStepTelemetry`` (each
             step's CUDA-event time; its Prometheus text must hold
             ``train_mfu``), the optimizer step's share of the steps'
             CUDA-event time, peak memory and launches = 10 steps x 4
             layers for each flash kernel, none through a copy; then
             ``gpt_train_clocks`` and ``gpt_train_profile``, the profile
             window of ``train_profile`` over 2 more steps.
``bert_finetune``  BERT-base SQuAD fine-tuning
             (``BertForQuestionAnswering(BertConfig())``, 12 layers) on
             examples/finetune_bert_squad.py's synthetic split (spans
             bracketed by sentinel tokens), S=384, B=32, dropout 0.1 from
             an explicit generator, bf16 with fp32 masters, AdamW under
             LinearWarmup -> PolynomialDecay, 60 steps with no sync
             inside the loop: losses (finite, falling), span accuracy on
             a held-out split (reported, not gated), ms a step, tokens/s,
             the optimizer's share of the steps' CUDA-event time, peak
             memory, a 2-step profile; no flash kernel launches.  Then
             ``ErnieForSequenceClassification(ErnieConfig())``, 10 steps
             at S=512, B=32 on one batch whose class shows in every token
             (losses finite and falling, ms a step).
``train_checkpoint``  the gpt_train_identity model: 2 steps,
             ``framework.save`` of model, optimizer and scheduler, a fresh
             model and optimizer ``load`` them and train 2 more; the 4
             losses equal an uninterrupted run's, bit for bit where two
             uninterrupted runs are (else within their gap); a bf16 model
             saved and loaded back bit-equal.
``vision_identity``  image classification in fp32 with cuDNN
             deterministic: ``resnet18`` at 64x64, B=8, 5
             ``jit.to_static`` Momentum steps (the first eager, the second
             captured into a CUDA graph and replayed, then replays)
             against 5 eager steps from the same weights: losses,
             parameters and BatchNorm buffers within 1e-5 (bit-equal is
             reported); a planted fault, a first call that applies two
             steps, must miss that gate; a step reading ``float(loss)``
             falls back to eager with one warning and one graph break; a
             ViT at ViT-B widths cut to 2 layers (224x224, B=8, fp32,
             AdamW, captured) through the flash kernels against the same
             steps through the composite (``use_pallas=False``), losses
             within 1e-5 relative, 3 x 2 launches of each kernel; then
             the three flash kernels at ViT-B/16's attention shape (B=64,
             S=197, 12 heads of 64, non-causal) against their twins row
             by row in fp32 and bf16, each output's last 64 rows zeroed
             as a planted fault that must fail, and in bf16 the kernels',
             twins' and library's (SDPA and its backward) CUDA-event
             times beside the bound.
``resnet50_train``  ``resnet50(num_classes=1000)`` at 224x224, B=64,
             Momentum (lr 0.025, the one-card share of ResNet50.yaml's
             0.1 at a global batch of 256), ``CrossEntropyLoss``, one
             ``to_static`` step: 10 steps in fp32 (TF32 off), then a
             fresh model 10 steps under ``auto_cast(level="O1",
             dtype="bfloat16")``; each: losses falling, ms a step and
             images/s by CUDA events, 1 capture and 0 graph breaks, peak
             memory, the eager step's time and its optimizer share on
             the same weights, a 2-step profile (idle share; conv,
             BatchNorm statistics, elementwise and matrix-product
             shares).
``vit_train``  ``vit_base_patch16_224(class_num=1000)``, B=64, AdamW, AMP
             O1 bf16, one ``to_static`` step, 10 steps: losses falling,
             ms a step, images/s, achieved TFLOP/s (3 x
             ``vit_flops_per_image`` an image), peak memory, 12 x 10
             launches of each flash kernel, a 2-step profile (idle share,
             each flash kernel's device time a launch).
``loader_identity``  LeNet on the synthetic MNIST through ``Model.fit``
             (1024 images, B=64, Adam) and ``evaluate``: the port's CPU
             run, then the card with ``num_workers`` 0 and 2 (the
             shared-memory ring) from the same weights and
             ``np.random.seed``, losses within 1e-4 relative; then
             ``Model.save`` / ``load`` into a fresh model and optimizer,
             weights and slots bit-equal, the next step's loss equal.
``imagenet_fit``  ResNet-50 (fp32, B=64, 224x224, Momentum, 31 steps, one
             epoch) and ViT-B/16 (fp32, AdamW, 8 steps) through
             ``Model.fit`` over an ImageNet-shaped ``DatasetFolder`` of
             ``.npy`` files written from a seed (1000 classes x 2 images
             at 256x256, ~494 MB, removed after), PaddleClas's train
             transforms in 4 forked workers over the ring; ``evaluate``
             on 512 images; beside each, eager steps on a device-resident
             batch; the starved share, a profiled window's idle share, the
             copy's GB/s pinned and pageable, one batch's collate here.
             Gates: the sampler's indices each served once, labels in its
             order, 4-worker batches bit-equal to in-process ones, finite
             losses, a planted worker fault raising within 30 s, no worker
             or ring segment left, 12 x 8 launches of each flash kernel.

Then a line ``{"kernels": [...]}`` summarising each kernel at its main
path's shapes (the ragged kernel at the unified serve step, the decode
kernel at B=16 bf16, the flash kernels at the train shape in bf16, the
scale kernel at [8192, 4096] bf16, with the launches of the serve, the
burst-free serve_legacy, the train and the custom_op runs; the flash rows
add ``gpt_train_launches``, ``vit_train_launches``,
``imagenet_fit_launches``, ``vit_train_device_ms`` and ``vit_shape``, their times and errors at ViT-B/16's shape), the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.  Any
failure raises and the script exits nonzero without that last line; so
does a machine without a CUDA device, and a directory that holds this
script without the package.
"""

from __future__ import annotations

import contextlib
import gc
import http.client
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12                                  # H100 SXM HBM3
KERNEL_NAME = "ragged_paged_attention"
DECODE_NAME = "paged_decode_attention"
FLASH_NAME = "flash_attention"
SCALED_NAME = "scaled"
# the device functions of each kernel, as a profiler names them
KERNEL_MARKS = ("ragged_",)   # work list, chunk, decode, combine, simple
DECODE_MARKS = ("paged_decode_",)   # the walks (simple, mma), the combine
# (flash_fwd_kernel for fp32 inputs, flash_fwd_tma_kernel for bf16, ...)
FLASH_MARKS = {"fwd": ("flash_fwd_",), "dq": ("flash_bwd_dq_",),
               "dkv": ("flash_bwd_dkv_",)}
MATMUL_MARKS = ("gemm", "xmma", "cutlass", "nvjet", "matmul")


_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, with the script's wall seconds so far."""
    print(json.dumps({"phase": phase, **fields,
                      "script_s": time.perf_counter() - _START}), flush=True)


def gpu_sample() -> dict:
    """The card's SM clock, power draw and temperature, as nvidia-smi reads
    them now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    clock, power, temp = (x.strip() for x in
                          out.stdout.strip().splitlines()[0].split(","))
    return {"clocks_sm": clock, "power_draw": power, "temperature": temp}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# --- kernel phase -------------------------------------------------------------

def packing(rng, Tb, n_decode, chunks, W, bs, num_blocks):
    """Packed metadata as the engine builds it: ``n_decode`` decode rows and
    one prefill chunk row per entry of ``chunks`` (its token count), with
    random KV lengths up to ``W * bs`` over distinct random pages; tokens
    past the real ones are pads routed to a pad row."""
    rows = []
    for n in [1] * n_decode + list(chunks):
        kv = int(rng.integers(n, W * bs + 1))
        pages = rng.choice(np.arange(1, num_blocks), -(-kv // bs),
                           replace=False)
        rows.append((pages, kv, list(range(kv - n, kv))))
    return pack_rows(rows, Tb, W)


def tiny_packings():
    """The decode-only / chunk-only / mixed / padded packings of
    tests/test_torch_ragged_paged.py (H=4, Hkv=2, bs=4)."""
    return {
        "decode_only": ([([1 + 2 * i, 2 + 2 * i][:max(1, -(-L // 4))], L,
                          [L - 1]) for i, L in enumerate((3, 6, 8, 5))], 4),
        "chunk_only": ([([3, 7], 7, [4, 5, 6]),
                        ([5, 9], 5, [0, 1, 2, 3, 4])], 8),
        "mixed": ([([3, 7], 6, [5]), ([5, 9], 5, [2, 3, 4]),
                   ([2, 11], 8, [7])], 8),
        "padded": ([([3], 2, [1]), ([5, 9], 5, [3, 4])], 8),
    }


def pack_rows(rows, Tb, W):
    """Packed metadata from ``rows`` = [(pages, kv_len, q_positions)], with
    the row arrays padded to ``Tb`` rows."""
    tables = np.zeros((Tb, W), np.int32)
    lens = np.ones((Tb,), np.int32)
    seg = np.full((Tb,), min(len(rows), Tb - 1), np.int32)
    pos = np.zeros((Tb,), np.int32)
    cursor = 0
    for i, (pages, kv, positions) in enumerate(rows):
        tables[i, :len(pages)] = pages
        lens[i] = kv
        seg[cursor:cursor + len(positions)] = i
        pos[cursor:cursor + len(positions)] = positions
        cursor += len(positions)
    if cursor > Tb:
        raise ValueError(f"{cursor} tokens do not fit a bucket of {Tb}")
    return tables, lens, seg, pos


def work(q, k_cache, tables, lens, seg, pos):
    """Operations and unique bytes the function needs on these inputs:
    4 * limit_t * H * D flops per token; q and out once, each used row's
    K/V pages once, and the routing arrays."""
    T, H, D = q.shape
    bs, Hkv = k_cache.shape[1], k_cache.shape[2]
    limit = np.minimum(lens[seg], pos + 1)
    flops = float(4 * limit.sum() * H * D)
    row_limit = {}
    for r, lim in zip(seg.tolist(), limit.tolist()):
        row_limit[r] = max(row_limit.get(r, 0), lim)
    pages = sum(-(-lim // bs) for lim in row_limit.values())
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * pages * bs * Hkv * D * k_cache.element_size()
              + 4 * (tables.size + lens.size + seg.size + pos.size))
    return flops, nbytes


def time_ms(fn, iters, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_times(fn, iters, marks):
    """Device time per call of ``fn`` in each kernel whose name holds one of
    ``marks``, from torch.profiler: {function name: ms}.  Unlike
    :func:`time_ms` it leaves out the host's cost of issuing each call,
    which sets the pace of back-to-back calls when the kernels are shorter
    than that cost.  A profile that recorded none of those kernels is taken
    again, twice at most (a profiler session of a long process sometimes
    records no device activity); then it raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times = {}
        for k, us in device_kernels(prof).items():
            if any(m in k.lower() for m in marks):
                name = re.search(r"(\w+)(<[^>(]*>)?\(", k.split("::")[-1])
                key = name.group(0)[:-1] if name else k[:60]
                times[key] = times.get(key, 0.0) + us / iters / 1e3
        if times:
            return times
    raise AssertionError(f"the profiler recorded no device time in kernels "
                         f"named {marks} in three profiles")


def device_ms(fn, iters, marks):
    """The device time per call of ``fn`` summed over the kernels whose
    names hold one of ``marks`` (:func:`device_times`)."""
    return sum(device_times(fn, iters, marks).values())


def library_call(q, k_cache, v_cache, tables, seg, lens, pos):
    """scaled_dot_product_attention over each token's pages gathered to a
    dense masked context beforehand: returns the timed call (the gather
    stays outside it)."""
    import torch
    import torch.nn.functional as F

    T, H, D = q.shape
    bs, Hkv = k_cache.shape[1], k_cache.shape[2]
    W = tables.shape[1]
    bt = tables.long()[seg.long()]
    k = k_cache[bt].reshape(T, W * bs, Hkv, D).transpose(1, 2).contiguous()
    v = v_cache[bt].reshape(T, W * bs, Hkv, D).transpose(1, 2).contiguous()
    limit = torch.minimum(lens.long()[seg.long()], pos.long() + 1)
    mask = (torch.arange(W * bs, device=q.device)[None, :]
            < limit[:, None])[:, None, None, :]
    qd = q[:, :, None, :].to(k.dtype)
    major, minor = (int(x) for x in torch.__version__.split(".")[:2])
    if (major, minor) >= (2, 5):
        return lambda: F.scaled_dot_product_attention(
            qd, k, v, attn_mask=mask, enable_gqa=True)
    k, v = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))
    return lambda: F.scaled_dot_product_attention(qd, k, v, attn_mask=mask)


def dropped_last_page(pos, seg, rows, bs):
    """q_pos with the last page of each walk of the tokens of ``rows``
    dropped: each such token then attends up to the start of the page that
    holds its own position (the row's last tokens lose the row's last
    page); tokens of a row's first page keep their walk.  What a kernel
    that skipped each walk's last page would compute."""
    pos = pos.copy()
    for t in np.flatnonzero(np.isin(seg, list(rows))):
        if pos[t] >= bs:
            pos[t] = pos[t] // bs * bs - 1
    return pos


def kernel_phase(torch, rp, flash):
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    checks = []
    rp.simple_launches = rp.tma_launches = 0

    def check(label, q32, k32, v32, meta, dtype, route):
        q, k, v = q32.to(dtype), k32.to(dtype), v32.to(dtype)
        out = rp.ragged_kernel(q, k, v, *meta)
        torch.cuda.synchronize()
        ref = rp.ragged_reference(q.float(), k.float(), v.float(), *meta)
        err = float((out.float() - ref).abs().max())
        row = flash.rowwise_error(out, ref)
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        if not (err <= tol and row <= tol and torch.isfinite(out).all()
                and rp.last_route == route):
            raise AssertionError(f"ragged kernel disagrees with the plain "
                                 f"version on {label} {dtype}: max abs err "
                                 f"{err}, row err {row} (tol {tol}), route "
                                 f"{rp.last_route} (due {route})")
        checks.append({"case": label, "dtype": str(dtype).split(".")[-1],
                       "route": route, "max_abs_err": err,
                       "max_row_err": row, "tol": tol})
        return q, k, v, err, row, ref

    for D in (8, 16):
        for name, (rows, Tb) in tiny_packings().items():
            meta = [torch.from_numpy(a).to(dev)
                    for a in pack_rows(rows, Tb, 4)]
            q = torch.randn(Tb, 4, D, device=dev)
            k = torch.randn(16, 4, 2, D, device=dev)
            v = torch.randn(16, 4, 2, D, device=dev)
            for dtype in (torch.float32, torch.bfloat16):
                check(f"tiny {name} D={D}", q, k, v, meta, dtype, "simple")

    H, Hkv, D, bs, W, num_blocks = 32, 8, 128, 16, 64, 4096
    shapes = {8: (8, []), 64: (32, [29]), 256: (16, [120, 119]),
              512: (16, [248, 247])}   # Tb: (decode rows, chunk sizes)
    timings = []
    summary = None
    work_lists = {}
    planted = None
    k32 = torch.randn(num_blocks, bs, Hkv, D, device=dev)
    v32 = torch.randn(num_blocks, bs, Hkv, D, device=dev)
    for Tb, (n_decode, chunks) in shapes.items():
        arrays = packing(rng, Tb, n_decode, chunks, W, bs, num_blocks)
        meta = [torch.from_numpy(a).to(dev) for a in arrays]
        q32 = torch.randn(Tb, H, D, device=dev)
        # the device work list against its plain twin
        per = rp.tokens_per_item(Tb, H, Hkv)
        items = rp.worklist_kernel(meta[2], per)
        if items != rp.work_items(arrays[2], per):
            raise AssertionError(f"ragged work list at T={Tb} differs from "
                                 f"its twin")
        work_lists[Tb] = {"chunk_items": len(items[0]),
                          "decode_items": len(items[1]), "per": per}
        for dtype in (torch.float32, torch.bfloat16):
            label = f"8b T={Tb} decode={n_decode} chunks={chunks}"
            route = "tma" if dtype == torch.bfloat16 else "simple"
            q, k, v, err, row_err, ref = check(label, q32, k32, v32, meta,
                                               dtype, route)
            flops, nbytes = work(q, k, *arrays)
            name = str(dtype).split(".")[-1]
            library = library_call(q, k, v, *[meta[i] for i in (0, 2, 1, 3)])
            library_err = float((library()[:, :, 0].float() - ref).abs().max())
            if not library_err <= 2e-2:
                raise AssertionError(f"the library yardstick computes another "
                                     f"function: max abs err {library_err}")
            if Tb == 512 and dtype == torch.bfloat16:
                # the planted fault: the last page of each chunk token's
                # walk dropped must fail the row check
                pos = dropped_last_page(
                    arrays[3], arrays[2],
                    range(n_decode, n_decode + len(chunks)), bs)
                bad = rp.ragged_kernel(q, k, v, *meta[:3],
                                       torch.from_numpy(pos).to(dev))
                planted = {"row": flash.rowwise_error(bad, ref),
                           "abs": float((bad.float() - ref).abs().max()),
                           "tol": 2e-2}
                if not planted["row"] > 2e-2:
                    raise AssertionError(f"ragged: the dropped last pages "
                                         f"passed the row check: {planted}")
                del bad
            del ref
            t_flops = flops / PEAK_FLOPS[name] * 1e3
            t_bytes = nbytes / PEAK_BYTES * 1e3
            row = {
                "T": Tb, "dtype": name, "route": route,
                "decode_rows": n_decode, "chunks": chunks,
                "max_abs_err": err, "max_row_err": row_err,
                "ms": time_ms(lambda: rp.ragged_kernel(q, k, v, *meta), 20),
                "plain_ms": time_ms(
                    lambda: rp.ragged_reference(q, k, v, *meta), 5, 1),
                "library_ms": time_ms(library, 10),
                "library_max_abs_err": library_err,
                "bound_ms": max(t_flops, t_bytes),
                "bound_by": "operations" if t_flops > t_bytes else "bytes",
                "flops": flops, "bytes": nbytes,
            }
            if Tb == 512 and dtype == torch.bfloat16:
                parts = device_times(
                    lambda: rp.ragged_kernel(q, k, v, *meta), 20,
                    KERNEL_MARKS)
                row["device_ms"] = sum(parts.values())
                row["device_ms_by_kernel"] = parts
                summary = row   # the serve phase's step shape and types
            timings.append(row)
            del library
            torch.cuda.empty_cache()
    del k32, v32
    torch.cuda.empty_cache()

    # the tma route at GQA 7:1, a chunk starting mid-page, decode-only steps
    extra = {
        "gqa 7:1 T=256": (28, 4, 256, 16, [120, 119], None),
        "chunks from mid-page T=128": (32, 8, 128, 3, [37, 50, 19],
                                       [bs + 5, 3 * bs - 1, 7]),
        "decode only T=16": (32, 8, 16, 16, [], None),
        "gqa 7:1 decode only T=8": (28, 4, 8, 8, [], None),
    }
    for label, (h, hkv, Tb, n_decode, chunks, starts) in extra.items():
        rows = []
        for i, n in enumerate([1] * n_decode + chunks):
            kv = int(rng.integers(n, W * bs + 1))
            if starts is not None and i >= n_decode:
                kv = starts[i - n_decode] + n
            pages = rng.choice(np.arange(1, 1024), -(-kv // bs),
                               replace=False)
            rows.append((pages, kv, list(range(kv - n, kv))))
        meta = [torch.from_numpy(a).to(dev)
                for a in pack_rows(rows, Tb, W)]
        check(label, torch.randn(Tb, h, D, device=dev),
              torch.randn(1024, bs, hkv, D, device=dev),
              torch.randn(1024, bs, hkv, D, device=dev), meta,
              torch.bfloat16, "tma")
    spec = spec_packing(torch, rp, rng, check)
    routes = {"simple": rp.simple_launches, "tma": rp.tma_launches}
    emit("kernels", name=KERNEL_NAME, checks=len(checks),
         worst=max(checks, key=lambda c: max(c["max_abs_err"],
                                             c["max_row_err"]) / c["tol"]),
         planted_dropped_pages=planted, work_lists=work_lists,
         route_launches=routes, timings=timings, spec_packing=spec,
         note="max_row_err is flash.rowwise_error over (token, head) rows; "
              "planted: the kernel's output at T=512 bf16 with the last "
              "page of each chunk token's walk dropped, read by it (must "
              "exceed tol) and absolutely; route_launches counts every "
              "launch of this phase, checks and timing loops included")
    return summary


def spec_packing(torch, rp, rng, check):
    """The packing speculative decoding gives the ragged kernel at
    Llama-3-8B's attention shapes (H=32, Hkv=8, D=128, bs=16): 16 verify
    rows of 2-5 tokens, each starting mid-page at a random position up to
    2048 (a work item of more than one token: the tma route's chunk path),
    4 decode rows and one 128-token chunk, in a T=256 bucket.  Each
    (token, head) row is checked against its twin row in bf16 (tma route)
    and fp32 (simple route); the kernel, its plain version and the library
    call are timed, with the bound and the launches of each route."""
    dev = torch.device("cuda")
    H, Hkv, D, bs, Tb, num_blocks = 32, 8, 128, 16, 256, 4096
    rows = []
    for n in [int(rng.integers(2, 6)) for _ in range(16)] + [1] * 4 + [128]:
        if 1 < n < 6:   # a verify row: starts mid-page
            start = int(rng.integers(1, 2048 // bs)) * bs \
                + int(rng.integers(1, bs))
        else:
            start = int(rng.integers(0, 2048 - n + 1))
        kv = start + n
        pages = rng.choice(np.arange(1, num_blocks), -(-kv // bs),
                           replace=False)
        rows.append((pages, kv, list(range(start, kv))))
    W = 1 << int(np.ceil(np.log2(max(len(r[0]) for r in rows))))
    arrays = pack_rows(rows, Tb, W)
    meta = [torch.from_numpy(a).to(dev) for a in arrays]
    q32 = torch.randn(Tb, H, D, device=dev)
    k32 = torch.randn(num_blocks, bs, Hkv, D, device=dev)
    v32 = torch.randn(num_blocks, bs, Hkv, D, device=dev)
    out = {"T": Tb, "table_width": W,
           "verify_rows": [len(r[2]) for r in rows[:16]],
           "verify_starts": [r[2][0] for r in rows[:16]],
           "decode_rows": 4, "chunk": 128,
           "tokens": sum(len(r[2]) for r in rows)}
    for dtype, route in ((torch.bfloat16, "tma"), (torch.float32, "simple")):
        name = str(dtype).split(".")[-1]
        before = (rp.simple_launches, rp.tma_launches)
        q, k, v, err, row_err, ref = check("spec packing T=256", q32, k32,
                                           v32, meta, dtype, route)
        flops, nbytes = work(q, k, *arrays)
        library = library_call(q, k, v, *[meta[i] for i in (0, 2, 1, 3)])
        t_flops = flops / PEAK_FLOPS[name] * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        out[name] = {
            "route": route, "max_abs_err": err, "max_row_err": row_err,
            "ms": time_ms(lambda: rp.ragged_kernel(q, k, v, *meta), 20),
            "plain_ms": time_ms(
                lambda: rp.ragged_reference(q, k, v, *meta), 5, 1),
            "library_ms": time_ms(library, 10),
            "bound_ms": max(t_flops, t_bytes),
            "bound_by": "operations" if t_flops > t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}
        if route == "tma":
            out[name]["device_ms"] = device_ms(
                lambda: rp.ragged_kernel(q, k, v, *meta), 20, KERNEL_MARKS)
        out[name]["route_launches"] = {
            "simple": rp.simple_launches - before[0],
            "tma": rp.tma_launches - before[1]}
        del q, k, v, ref, library
    del k32, v32
    torch.cuda.empty_cache()
    return out


# --- decode kernel phase ------------------------------------------------------

def decode_bucket_case(rng, B, W, bs=4, Hkv=2, H=4, D=16):
    """tests/test_torch_paged_decode.py's decode bucket: each row owns 1..W
    distinct pages, 0-padded, with a random length inside them."""
    num_blocks = W * B + 2
    k = rng.standard_normal((num_blocks, bs, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((num_blocks, bs, Hkv, D)).astype(np.float32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    tables = np.zeros((B, W), np.int32)
    lens = np.zeros((B,), np.int32)
    blocks = iter(range(1, num_blocks))
    for i in range(B):
        owned = rng.integers(1, W + 1)
        tables[i, :owned] = [next(blocks) for _ in range(owned)]
        lens[i] = rng.integers(1, owned * bs + 1)
    return q, k, v, tables, lens


def decode_tables(rng, lens, W, bs, num_blocks):
    """A [B, W] table over distinct random pages, live pages only."""
    need = [-(-int(n) // bs) for n in lens]
    pages = rng.choice(np.arange(1, num_blocks), sum(need), replace=False)
    tables = np.zeros((len(lens), W), np.int32)
    at = 0
    for i, n in enumerate(need):
        tables[i, :n] = pages[at:at + n]
        at += n
    return tables


def decode_kernel_phase(torch, pd, flash):
    """The decode kernel against decode_reference, each (row, head) against
    its twin row: the CPU tests' bucket lattice, then Llama-3-8B's decode
    shapes with times.  At the 8B shapes each timed launch takes the next of
    several table sets over distinct pages of a large pool, so the pages
    come from device memory and not from L2, as they do for a decode step
    that walks all the layers."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    checks = []
    pd.launches = pd.simple_launches = pd.mma_launches = 0

    def check(label, q, k, v, tables, lens):
        out = pd.decode_kernel(q, k, v, tables, lens)
        torch.cuda.synchronize()
        ref = pd.decode_reference(q.float(), k.float(), v.float(), tables,
                                  lens)
        err = float((out.float() - ref).abs().max())
        row = flash.rowwise_error(out, ref)
        tol = 1e-4 if q.dtype == torch.float32 else 2e-2
        way = pd.route("cuda", q.dtype, k.dtype, q.shape[2], k.shape[1])
        if not (err <= tol and row <= tol and pd.last_route == way
                and torch.isfinite(out.float()).all()):
            raise AssertionError(f"decode kernel disagrees with the plain "
                                 f"version on {label} {q.dtype}: max abs "
                                 f"err {err}, row err {row} (tol {tol}), "
                                 f"route {pd.last_route} (due {way})")
        checks.append({"case": label, "dtype": str(q.dtype).split(".")[-1],
                       "route": way, "max_abs_err": err, "max_row_err": row,
                       "tol": tol})
        return out, ref, err

    for B in (1, 2, 4, 8):
        for W in (1, 2, 4, 8):
            arrays = [torch.from_numpy(a).to(dev)
                      for a in decode_bucket_case(rng, B, W)]
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = (t.to(dtype) for t in arrays[:3])
                check(f"tiny B={B} W={W}", q, k, v, *arrays[3:])

    H, Hkv, D, bs, W, max_len, n_sets = 32, 8, 128, 16, 256, 2112, 12
    span = pd.span_tokens(bs)
    num_blocks = n_sets * 16 * (max_len // bs) + 1
    k32 = torch.randn(num_blocks, bs, Hkv, D, device=dev)
    v32 = torch.randn(num_blocks, bs, Hkv, D, device=dev)
    timings = []
    summary = planted = None
    bit_equal = {}
    for B in (1, 4, 16):
        lens = rng.integers(1, max_len + 1, B).astype(np.int32)
        sets = [decode_tables(rng, lens, W, bs, num_blocks)
                for _ in range(n_sets)]
        lens_t = torch.from_numpy(lens).to(dev)
        tables = [torch.from_numpy(t).to(dev) for t in sets]
        q32 = torch.randn(B, H, D, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = q32.to(dtype), k32.to(dtype), v32.to(dtype)
            name = str(dtype).split(".")[-1]
            label = f"8b B={B}"
            out, ref, err = check(label, q, k, v, tables[0], lens_t)
            err = max(err, check(label, q, k, v, tables[1], lens_t)[2])
            tol = 1e-4 if dtype == torch.float32 else 2e-2
            if B == 16:
                # the planted fault: each row's walk without its last span
                # (the twin with the last span dropped) must fail the check
                cut = torch.clamp((lens_t - 1) // span * span, min=0).int()
                bad = pd.decode_split_reference(q.float(), k.float(),
                                                v.float(), tables[0], cut)
                planted = {"dtype": name, "tol": tol,
                           "row": flash.rowwise_error(bad, ref),
                           "abs": float((bad - ref).abs().max())}
                if not planted["row"] > tol:
                    raise AssertionError(f"decode: each row without its last "
                                         f"span passed the row check: "
                                         f"{planted}")
                # a row's bits alone (B=1), inside B=16 and at width 2W
                wide = torch.zeros(B, 2 * W, dtype=torch.int32, device=dev)
                wide[:, :W] = tables[0]
                doubled = pd.decode_kernel(q, k, v, wide, lens_t)
                alone = [pd.decode_kernel(q[i:i + 1].contiguous(), k, v,
                                          tables[0][i:i + 1].contiguous(),
                                          lens_t[i:i + 1].contiguous())[0]
                         for i in range(B)]
                again = pd.decode_kernel(q, k, v, tables[0], lens_t)
                torch.cuda.synchronize()
                bit_equal[name] = {
                    "width_2W": bool(torch.equal(doubled, out)),
                    "alone_B1": all(torch.equal(a, out[i])
                                    for i, a in enumerate(alone)),
                    "rerun": bool(torch.equal(again, out))}
                if not all(bit_equal[name].values()):
                    raise AssertionError(f"decode: rows moved across B, W or "
                                         f"runs: {bit_equal[name]}")
                del bad, wide, doubled, alone, again
            del out, ref
            flops, nbytes = work(q, k, sets[0], lens, np.arange(B),
                                 lens - 1)
            # one query token per row, at position len - 1
            rows = torch.arange(B, device=dev)
            library = [library_call(q, k, v, t, rows, lens_t, lens_t - 1)
                       for t in tables]
            ref = pd.decode_reference(q.float(), k.float(), v.float(),
                                      tables[0], lens_t)
            library_err = float((library[0]()[:, :, 0].float() - ref)
                                .abs().max())
            if not library_err <= 2e-2:
                raise AssertionError(f"the library yardstick computes another "
                                     f"function: max abs err {library_err}")
            del ref

            def cycle(fn):
                state = {"i": 0}

                def call():
                    fn(state["i"] % n_sets)
                    state["i"] += 1
                return call

            t_flops = flops / PEAK_FLOPS[name] * 1e3
            t_bytes = nbytes / PEAK_BYTES * 1e3
            kernel = cycle(lambda i: pd.decode_kernel(q, k, v, tables[i],
                                                      lens_t))
            ms = time_ms(kernel, 4 * n_sets)
            parts = device_times(kernel, 2 * n_sets, DECODE_MARKS)
            device = sum(parts.values())
            row = {
                "B": B, "dtype": name, "lens": lens.tolist(), "W": W,
                "max_abs_err": err,
                "ms": ms, "device_ms": device,
                "device_ms_by_kernel": parts,   # the walk and the combine
                # the host's cost of a call that the device does not hide:
                # CUDA-event time of back-to-back calls minus device time
                "host_gap_ms": ms - device,
                # the wrapper's own CPU time a call, its launch included
                "wrapper_cpu_ms": wrapper_cpu_ms(torch, kernel, 200),
                "plain_ms": time_ms(cycle(lambda i: pd.decode_reference(
                    q, k, v, tables[i], lens_t)), n_sets, 1),
                "library_ms": time_ms(cycle(lambda i: library[i]()),
                                      2 * n_sets),
                "library_max_abs_err": library_err,
                "bound_ms": max(t_flops, t_bytes),
                "bound_by": "operations" if t_flops > t_bytes else "bytes",
                "flops": flops, "bytes": nbytes,
                "route": pd.last_route, "span": span,
                # work items: (row, head group, span)
                "items": len(pd.span_plan(lens, span))
                * pd.head_groups(H, Hkv, pd.last_route)[0],
            }
            if dtype == torch.bfloat16 and B in (1, 16):
                # the span's choice: device time at shorter spans
                row["device_ms_by_span"] = {}
                for sp in (32, 64, pd.SPAN_TOKENS):
                    chosen, pd.SPAN_TOKENS = pd.SPAN_TOKENS, sp
                    try:
                        row["device_ms_by_span"][str(sp)] = device_ms(
                            kernel, 2 * n_sets, DECODE_MARKS)
                    finally:
                        pd.SPAN_TOKENS = chosen
            timings.append(row)
            if B == 16 and dtype == torch.bfloat16:
                summary = row   # the serve_legacy decode step's shape
            del library, q, k, v
            torch.cuda.empty_cache()
    del k32, v32
    torch.cuda.empty_cache()
    emit("decode_kernels", name=DECODE_NAME, checks=len(checks),
         worst=max(checks, key=lambda c: max(c["max_abs_err"],
                                             c["max_row_err"]) / c["tol"]),
         planted_dropped_span=planted, bit_equal=bit_equal,
         launches=pd.launches,
         route_launches={"simple": pd.simple_launches,
                         "mma": pd.mma_launches},
         timings=timings,
         note="max_row_err is flash.rowwise_error over (row, head) rows; "
              "planted: the twin with each row's last span dropped at B=16, "
              "read by the row check (must exceed tol); launches and "
              "route_launches count every launch of this phase, checks and "
              "timing loops included")
    return summary


def wrapper_cpu_ms(torch, fn, n):
    """The host's time a call of ``fn`` by time.perf_counter over ``n``
    calls, with no synchronisation inside (the device runs behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e3


# --- engine phases ------------------------------------------------------------

def prompts_with_prefix(rng, n, lo, hi, prefix_len, vocab):
    prefix = rng.integers(0, vocab, prefix_len).tolist()
    return [prefix + rng.integers(0, vocab, int(rng.integers(lo, hi + 1))
                                  - prefix_len).tolist() for _ in range(n)]


SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9)


def sampling(serving, n, new_tokens, sampled):
    """One SamplingParams a prompt: greedy, or seeded sampling (seed 100 +
    the prompt's index)."""
    return [serving.SamplingParams(max_new_tokens=new_tokens,
                                   **(dict(SAMPLED, seed=100 + i)
                                      if sampled else {}))
            for i in range(n)]


def graph_counts(eng):
    """The captures of each graphed family (the JAX engine's trace
    counters) and the step-program cache's totals."""
    g = eng.graphs
    return {"prefill": eng.prefill_trace_count,
            "decode": eng.decode_trace_count,
            "burst": eng.burst_trace_count,
            "ragged": eng.ragged_trace_count, "captures": g.captures,
            "capture_s": g.capture_seconds, "replays": g.replays}


def check_traces(label, eng, families):
    """On a greedy or all-sampled run each family in ``families`` was
    captured once per bucket of its set (and ran), and its *_jit_traces
    metric says so; any other family (all of them in an eager run) was
    never captured."""
    sets = {"decode": eng.decode_buckets, "burst": eng.burst_buckets,
            "ragged": eng.ragged_buckets}
    for family, buckets in sets.items():
        count = getattr(eng, f"{family}_trace_count")
        want = len(buckets) if family in families else 0
        if (count != want or (family in families and not count)
                or eng.metrics.counters[f"{family}_jit_traces"] != count):
            raise AssertionError(
                f"{label}: {count} {family} captures for {len(buckets)} "
                f"buckets (graphed families here: {families})")


@contextlib.contextmanager
def stale_inputs(graphs):
    """A planted fault: replays whose static inputs are never refreshed."""
    fill = graphs.StepGraphs._fill
    graphs.StepGraphs._fill = lambda *a: None
    try:
        yield
    finally:
        graphs.StepGraphs._fill = fill


def identity_phase(torch, rp, serving, graphs, LlamaConfig,
                   LlamaForCausalLM):
    """The unified engine at 8B widths cut to 2 layers: the ragged kernel
    against its plain version, graphs against eager (greedy and seeded
    sampled, fp32 on the simple route and bf16 on the tma route), and the
    planted stale-input fault."""
    layers = 2
    cfg = LlamaConfig.llama3_8b(num_hidden_layers=layers)
    models = {}
    for dtype, seed in ((torch.float32, 0), (torch.bfloat16, 4)):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        models[dtype] = LlamaForCausalLM(cfg, device="cuda", dtype=dtype,
                                         generator=gen)
    rng = np.random.default_rng(1)
    prompts = prompts_with_prefix(rng, 8, 100, 700, 64, cfg.vocab_size)
    need = sum(-(-(len(p) + 16) // 16) for p in prompts) + 1
    runs = {   # name: (dtype, kernel route, eager, sampled, stale inputs)
        "kernel": (torch.float32, None, False, False, False),
        "plain": (torch.float32, False, False, False, False),
        "eager": (torch.float32, None, True, False, False),
        "sampled": (torch.float32, None, False, True, False),
        "sampled_eager": (torch.float32, None, True, True, False),
        "bf16": (torch.bfloat16, None, False, False, False),
        "bf16_eager": (torch.bfloat16, None, True, False, False),
        "stale": (torch.float32, None, False, False, True),
    }
    results = {}
    for name, (dtype, route, eager, sampled, stale) in runs.items():
        eng = serving.EngineCore(models[dtype], config=serving.EngineConfig(
            num_blocks=need + 16, block_size=16, dtype=dtype,
            unified_step=True, use_pallas_paged=route,
            scheduler=serving.SchedulerConfig(max_num_seqs=8,
                                              max_tokens_per_step=256)))
        rp.launches = rp.simple_launches = rp.tma_launches = 0
        reqs = [eng.add_request(p, sp) for p, sp in zip(
            prompts, sampling(serving, len(prompts), 16, sampled))]
        t0 = time.perf_counter()
        with graphs.disable_graphs() if eager else \
                stale_inputs(graphs) if stale else contextlib.nullcontext():
            eng.run(max_steps=2000)
        torch.cuda.synchronize()
        results[name] = {
            "tokens": [list(r.output_tokens) for r in reqs],
            "launches": rp.launches, "steps": eng.ragged_launches,
            "route_launches": {"simple": rp.simple_launches,
                               "tma": rp.tma_launches},
            "seconds": time.perf_counter() - t0,
            "prefix_hit_tokens": eng.metrics.counters[
                "prefix_cache_hit_tokens"],
            "buckets": sorted(eng.ragged_buckets),
            "graphs": graph_counts(eng)}
        if eng.kv.occupancy() != 0.0:
            raise AssertionError(f"identity {name}: the pool is not empty "
                                 f"at the end")
        if not stale:
            check_traces(f"identity {name}", eng,
                         () if eager else ("ragged",))
        del eng
    r = results
    for a, b in (("kernel", "plain"), ("kernel", "eager"),
                 ("sampled", "sampled_eager"), ("bf16", "bf16_eager")):
        if r[a]["tokens"] != r[b]["tokens"]:
            raise AssertionError(f"identity: the {a} and {b} engines "
                                 f"emitted different tokens")
    if r["sampled"]["tokens"] == r["kernel"]["tokens"]:
        raise AssertionError("identity: seeded sampling gave the greedy "
                             "tokens")
    if r["stale"]["tokens"] == r["kernel"]["tokens"]:
        raise AssertionError("identity: replays on stale static inputs gave "
                             "the right tokens: the identity check does not "
                             "bite")
    for name in ("kernel", "eager", "sampled", "sampled_eager", "bf16",
                 "bf16_eager"):
        x = r[name]
        route = "tma" if name.startswith("bf16") else "simple"
        if (x["launches"] != x["steps"] * layers
                or x["route_launches"][route] != x["launches"]):
            raise AssertionError(
                f"identity {name}: {x['launches']} kernel launches for "
                f"{x['steps']} steps x {layers} layers, by route "
                f"{x['route_launches']} (all due on the {route} route)")
    if r["plain"]["launches"]:
        raise AssertionError(f"identity: the plain run launched the kernel "
                             f"{r['plain']['launches']} times")
    kern = r["kernel"]
    if kern["prefix_hit_tokens"] <= 0:
        raise AssertionError("identity: no prefix fork happened")
    if any(len(t) != 16 or not all(0 <= x < cfg.vocab_size for x in t)
           for x in r.values() for t in x["tokens"]):
        raise AssertionError("identity: malformed token streams")
    model = models.pop(torch.float32)
    del models
    stale_diff = sum(a != b for ta, tb in zip(r["stale"]["tokens"],
                                              kern["tokens"])
                     for a, b in zip(ta, tb))
    emit("identity", layers=layers, dtype="float32 (bf16 runs: bfloat16)",
         prompt_lens=[len(p) for p in prompts],
         greedy_identical=True, graphs_identical=True,
         sampled_graphs_identical=True, bf16_graphs_identical=True,
         stale_tokens_differing=stale_diff,
         kernel_launches=kern["launches"],
         route_launches=kern["route_launches"],
         ragged_launches=kern["steps"], plain_launches=r["plain"]["launches"],
         prefix_hit_tokens=kern["prefix_hit_tokens"],
         buckets=kern["buckets"], first_tokens=kern["tokens"][0][:8],
         **{name: {k: v for k, v in x.items()
                   if k not in ("tokens", "buckets")}
            for name, x in r.items()})
    gc.collect()
    torch.cuda.empty_cache()
    return model, prompts, kern["tokens"]


def legacy_counts(eng):
    """Steps of each legacy family, bursts and decode-kernel launches due
    so far: the decode kernel runs once per layer per decode step and per
    burst iteration."""
    m = eng.metrics
    chunks = m.counters["chunked_prefill_steps"]
    decode_steps = m.histogram("decode_step").count
    burst_iters = int(eng._burst_counters["length"].sum)
    return {"prefill_steps": m.histogram("prefill_step").count - chunks,
            "chunk_steps": chunks, "decode_steps": decode_steps,
            "bursts": int(eng._burst_counters["launches"].value),
            "burst_iterations": burst_iters,
            "roundtrips": int(eng._burst_counters["roundtrips"].value),
            "decode_launches_due": (decode_steps + burst_iters)
            * eng.model.config.num_hidden_layers}


def identity_legacy_phase(torch, pd, serving, graphs, model, prompts,
                          unified_tokens):
    """The identity model and prompts through the JAX package's default
    serving call, the keyword form of LLM, which builds the legacy
    families, and through an LLM with decode bursts of 8: the decode kernel
    against its plain version, and graphs against eager (greedy and seeded
    sampled, with and without bursts).  Its prefill budget is set on the
    scheduler's config: the keyword form takes max_num_seqs only."""
    layers = model.config.num_hidden_layers
    need = sum(-(-(len(p) + 16) // 16) for p in prompts) + 1
    budget = 256
    runs = {   # name: (bursts, kernel route, eager, sampled)
        "kernel": (False, None, False, False),
        "plain": (False, False, False, False),
        "burst": (True, None, False, False),
        "eager": (False, None, True, False),
        "burst_eager": (True, None, True, False),
        "sampled": (False, None, False, True),
        "sampled_eager": (False, None, True, True),
        "burst_sampled": (True, None, False, True),
        "burst_sampled_eager": (True, None, True, True),
    }
    results = {}
    for name, (burst, route, eager, sampled) in runs.items():
        if burst:
            llm = serving.LLM(model, config=serving.EngineConfig(
                num_blocks=need + 16, block_size=16, burst_steps=8,
                scheduler=serving.SchedulerConfig(
                    max_num_seqs=8, max_prefill_tokens_per_step=budget)))
        else:
            llm = serving.LLM(model, num_blocks=need + 16, block_size=16,
                              max_num_seqs=8, use_pallas_paged=route)
            llm.engine.scheduler.config.max_prefill_tokens_per_step = budget
        eng = llm.engine
        if eng._unified:
            raise AssertionError("identity_legacy: LLM(model, ...) did not "
                                 "build the legacy families")
        pd.launches = pd.simple_launches = pd.mma_launches = 0
        t0 = time.perf_counter()
        with graphs.disable_graphs() if eager else contextlib.nullcontext():
            outs = llm.generate(prompts, sampling(serving, len(prompts), 16,
                                                  sampled))
        torch.cuda.synchronize()
        counts = legacy_counts(eng)
        results[name] = dict(
            counts, tokens=[o.token_ids for o in outs],
            launches=pd.launches, seconds=time.perf_counter() - t0,
            route_launches={"simple": pd.simple_launches,
                            "mma": pd.mma_launches},
            prefix_hit_tokens=eng.metrics.counters["prefix_cache_hit_tokens"],
            buckets={"decode": sorted(eng.decode_buckets),
                     "prefill": sorted(eng.prefill_buckets),
                     "burst": sorted(eng.burst_buckets)},
            graphs=graph_counts(eng))
        if eng.kv.occupancy() != 0.0:
            raise AssertionError(f"identity_legacy {name}: the pool is not "
                                 f"empty at the end")
        check_traces(f"identity_legacy {name}", eng,
                     () if eager else ("decode", "burst") if burst
                     else ("decode",))
        del llm, eng
    r = results
    kern, burst = r["kernel"], r["burst"]
    for a, b in (("kernel", "plain"), ("kernel", "burst"),
                 ("kernel", "eager"), ("burst", "burst_eager"),
                 ("sampled", "sampled_eager"), ("sampled", "burst_sampled"),
                 ("burst_sampled", "burst_sampled_eager")):
        if r[a]["tokens"] != r[b]["tokens"]:
            raise AssertionError(f"identity_legacy: the {a} and {b} engines "
                                 f"emitted different tokens")
    if r["sampled"]["tokens"] == kern["tokens"]:
        raise AssertionError("identity_legacy: seeded sampling gave the "
                             "greedy tokens")
    for name in ("burst", "burst_eager", "burst_sampled",
                 "burst_sampled_eager"):
        if not r[name]["roundtrips"] < kern["roundtrips"] or \
                r[name]["bursts"] == 0:
            raise AssertionError(
                f"identity_legacy {name}: {r[name]['bursts']} bursts, "
                f"{r[name]['roundtrips']} round trips against "
                f"{kern['roundtrips']} without bursts")
    for name, x in r.items():
        if name == "plain":
            continue
        if (x["launches"] != x["decode_launches_due"]
                or x["route_launches"]["simple"] != x["launches"]):
            raise AssertionError(
                f"identity_legacy {name}: {x['launches']} decode-kernel "
                f"launches, not (decode steps {x['decode_steps']} + burst "
                f"iterations {x['burst_iterations']}) x {layers} layers, or "
                f"not all on the simple route (fp32): "
                f"{x['route_launches']}")
    if r["plain"]["launches"]:
        raise AssertionError("identity_legacy: the plain run launched the "
                             "decode kernel")
    if kern["chunk_steps"] <= 0 or kern["prefix_hit_tokens"] <= 0:
        raise AssertionError("identity_legacy: the chunk family or the "
                             "prefix fork did not run")
    if any(len(t) != 16 or not all(0 <= v < model.config.vocab_size
                                   for v in t)
           for x in r.values() for t in x["tokens"]):
        raise AssertionError("identity_legacy: malformed token streams")
    agree = sum(a == b for ta, tb in zip(kern["tokens"], unified_tokens)
                for a, b in zip(ta, tb))
    emit("identity_legacy", layers=layers, dtype="float32",
         prefill_budget=budget, greedy_identical=True,
         burst_identical=True, graphs_identical=True,
         sampled_graphs_identical=True,
         tokens_agreeing_with_unified=agree,
         tokens_total=sum(map(len, unified_tokens)),
         **{name: {k: v for k, v in x.items() if k != "tokens"}
            for name, x in r.items()})


def prefill_identity_phase(torch, serving, graphs, model, prompts):
    """The legacy prefill families as step programs, on the identity model
    (fp32): the identity prompts and two fresh prompts of 150 and 230
    tokens (one one-shot bucket, 256, for two lengths: a last position
    baked into its graph would give the second the first's token) through
    a legacy LLM with a 256-token prefill budget and the prefix cache off,
    with the step graphs and under ``disable_graphs()``: the same tokens;
    ``prefill_trace_count`` (and its metric) equal to the prefill and
    chunk keys in use, each captured once; a second pass of the same
    prompts captures nothing and gives the same tokens."""
    vocab = model.config.vocab_size
    rng = np.random.default_rng(21)
    pair = [rng.integers(0, vocab, n).tolist() for n in (150, 230)]
    batch = list(prompts) + pair
    need = sum(-(-(len(p) + 16) // 16) for p in batch) + 1

    def llm():
        return serving.LLM(model, config=serving.EngineConfig(
            num_blocks=need + 16, block_size=16, prefix_cache=False,
            scheduler=serving.SchedulerConfig(
                max_num_seqs=8, max_prefill_tokens_per_step=256)))

    runs = {}
    for name, eager in (("graphs", False), ("eager", True)):
        lm = llm()
        eng = lm.engine
        t0 = time.perf_counter()
        with graphs.disable_graphs() if eager else contextlib.nullcontext():
            outs = lm.generate(batch, sampling(serving, len(batch), 16,
                                               False))
        torch.cuda.synchronize()
        runs[name] = {"tokens": [o.token_ids for o in outs],
                      "seconds": time.perf_counter() - t0,
                      "graphs": graph_counts(eng), "llm": lm}
    if runs["graphs"]["tokens"] != runs["eager"]["tokens"]:
        raise AssertionError("prefill_identity: the graphed prefill "
                             "families and disable_graphs() gave different "
                             "tokens")
    lm = runs["graphs"].pop("llm")
    runs["eager"].pop("llm")
    eng = lm.engine
    keys = sorted(k for k in eng.graphs.programs
                  if k[0] in ("prefill", "chunk"))
    families = {k[0] for k in keys}
    count = eng.prefill_trace_count
    if (count != len(keys) or count != len(eng.prefill_buckets)
            or families != {"prefill", "chunk"}
            or eng.metrics.counters["prefill_jit_traces"] != count
            or runs["eager"]["graphs"]["prefill"] != 0):
        raise AssertionError(
            f"prefill_identity: {count} prefill captures for {len(keys)} "
            f"keys of {families} and {len(eng.prefill_buckets)} buckets")
    oneshot = {r["bucket"]: r["launches"]
               for r in eng.stepprof.program_table()
               if r["program"] == "prefill"}
    if oneshot.get("256", 0) < 2:
        raise AssertionError(f"prefill_identity: the two prompts did not "
                             f"share the 256 bucket: {oneshot}")
    c0 = eng.graphs.captures
    t0 = time.perf_counter()
    again = lm.generate(batch, sampling(serving, len(batch), 16, False))
    torch.cuda.synchronize()
    second_s = time.perf_counter() - t0
    if eng.graphs.captures != c0 or \
            [o.token_ids for o in again] != runs["graphs"]["tokens"]:
        raise AssertionError(
            f"prefill_identity: the second pass captured "
            f"{eng.graphs.captures - c0} step programs or changed tokens")
    for r in runs.values():
        r.pop("tokens")
    emit("prefill_identity", layers=model.config.num_hidden_layers,
         dtype="float32", prompts=len(batch), prefill_budget=256,
         identical=True, prefill_keys=len(keys),
         keys={f: sum(k[0] == f for k in keys) for f in ("prefill",
                                                         "chunk")},
         oneshot_launches_by_bucket=oneshot, second_pass_captures=0,
         second_pass_s=second_s, **runs)


def aot_identity_phase(torch, rp, pd, serving, model, prompts):
    """AOT artifacts on the identity model (fp32, the simple routes): a
    legacy engine with decode bursts of 8 and a unified one (16 sequences,
    512 tokens a step), each saved at max_seq_len 1024 from a saving
    engine, loaded, bound and warmed on a fresh engine: the lattice's
    keys, 2 captures a saved (program, bucket) at the warm and none while
    serving, the tokens of the same engine without an artifact, every
    trace counter 0, the launch rule, an oversize request aborted at
    admission.  Then the legacy artifact with its device capability
    edited, and with its kernel's hash edited: each refuses to load."""
    AotArtifact = serving.AotArtifact
    need = sum(-(-(len(p) + 16) // 16) for p in prompts) + 1
    num_blocks = max(need, 1024 // 16 + 1) + 16
    configs = {
        "legacy_burst8": (dict(burst_steps=8), (None, "simple")),
        "unified": (dict(unified_step=True), ("simple", None)),
    }
    rows = {}
    for name, (fields, routes) in configs.items():
        def engine(aot=None):
            budget = 512 if fields.get("unified_step") else None
            return serving.EngineCore(model, config=serving.EngineConfig(
                num_blocks=num_blocks, block_size=16, aot=aot,
                scheduler=serving.SchedulerConfig(
                    max_num_seqs=16, max_tokens_per_step=budget),
                **fields))

        def serve(eng):
            reqs = [eng.add_request(p, serving.SamplingParams(
                max_new_tokens=16)) for p in prompts]
            eng.run(max_steps=20000)
            return [list(r.output_tokens) for r in reqs]

        ref = engine()
        want = serve(ref)
        del ref
        path = tempfile.mkdtemp(prefix=f"aot_{name}_")
        t0 = time.perf_counter()
        AotArtifact.save(engine(), path, max_seq_len=1024)
        save_s = time.perf_counter() - t0
        art = AotArtifact.load(path, device="cuda")
        eng = engine(aot=art)
        warm_s = art.warm(eng)
        warm_captures = eng.graphs.captures
        if warm_captures != 2 * art.program_count:
            raise AssertionError(f"aot_identity {name}: {warm_captures} "
                                 f"captures at the warm for "
                                 f"{art.program_count} saved buckets")
        reset_launches(rp, pd)
        t0 = time.perf_counter()
        got = serve(eng)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        traces = {f: getattr(eng, f"{f}_trace_count")
                  for f in ("prefill", "decode", "burst", "ragged")}
        if got != want or any(traces.values()) or \
                eng.graphs.captures != warm_captures:
            raise AssertionError(
                f"aot_identity {name}: tokens identical {got == want}, "
                f"traces {traces}, serving captured "
                f"{eng.graphs.captures - warm_captures}")
        rule = launch_rule(f"aot_identity {name}", rp, pd, [eng],
                           routes[0] or "tma", routes[1] or "mma")
        big = eng.add_request(list(range(1000)), serving.SamplingParams(
            max_new_tokens=100))
        eng.run(max_steps=100)
        if big.finish_reason is None or big.finish_reason.value != "abort" \
                or "max_seq_len=1024" not in (big.error or ""):
            raise AssertionError(f"aot_identity {name}: an oversize "
                                 f"request was not rejected at admission "
                                 f"({big.finish_reason}, {big.error})")
        snap = eng.stepprof.aot_snapshot()
        rows[name] = dict(
            families={f: len(v) for f, v in art.bucket_sets.items()},
            program_count=art.program_count, save_s=save_s,
            load_s=art.load_seconds, warm_s=warm_s,
            warm_captures=warm_captures, serve_s=serve_s,
            serving_captures=0, hits=snap["hits"],
            kernels=sorted(art.manifest["kernels"]), **rule)
        del eng
        if name == "legacy_burst8":
            fams = rows[name]["families"]
            if fams != {"prefill": 11, "chunk": 77, "decode": 35,
                        "burst": 15}:
                raise AssertionError(f"aot_identity: the legacy lattice "
                                     f"is {fams}")
            rows["refusals"] = refusals(serving, path)
        shutil.rmtree(path, ignore_errors=True)
    emit("aot_identity", layers=model.config.num_hidden_layers,
         dtype="float32", prompts=len(prompts), max_seq_len=1024,
         identical=True, traces=0, **rows)


def refusals(serving, path):
    """The artifact at ``path`` with its device capability edited, and with
    its kernel's hash edited: each must refuse to load, naming it."""
    out = {}
    for what, edit, match in (
            ("device_capability",
             lambda m: m.update(device_capability="sm_80"),
             "device capability"),
            ("kernel_hash",
             lambda m: [k.update(hash="0" * 16)
                        for k in m["kernels"].values()], "kernel")):
        copy = tempfile.mkdtemp(prefix="aot_edit_")
        shutil.rmtree(copy)
        shutil.copytree(path, copy)
        mpath = os.path.join(copy, "manifest.json")
        with open(mpath) as f:
            m = json.load(f)
        if what == "kernel_hash" and not m["kernels"]:
            raise AssertionError("aot_identity: the artifact holds no "
                                 "kernel")
        edit(m)
        with open(mpath, "w") as f:
            json.dump(m, f)
        try:
            serving.AotArtifact.load(copy, device="cuda")
        except serving.AotManifestMismatch as e:
            if match not in str(e):
                raise AssertionError(f"aot_identity: the {what} edit was "
                                     f"refused for another reason: {e}")
            out[what] = str(e).splitlines()[-1].strip()
        else:
            raise AssertionError(f"aot_identity: an artifact with its "
                                 f"{what} edited loaded")
        finally:
            shutil.rmtree(copy, ignore_errors=True)
    return out


def serve_pass(torch, serving, graphs, llm, prompts, new_tokens,
               eager=False):
    """One timed ``LLM.generate`` of greedy requests on a warm engine, with
    the step graphs or eagerly (``disable_graphs``).  Returns the pass's
    numbers — means over its own observations only — and its outputs."""
    eng = llm.engine
    names = ("time_to_first_token", "inter_token_latency", "prefill_step",
             "decode_step", "burst_step", "unified_step")
    hists = {n: eng.metrics.histogram(n) for n in names}
    seen = {n: (h.count, h.sum) for n, h in hists.items()}
    g0 = graph_counts(eng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with graphs.disable_graphs() if eager else contextlib.nullcontext():
        outs = llm.generate(prompts, serving.SamplingParams(
            max_new_tokens=new_tokens))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    g1 = graph_counts(eng)
    mean = {n: (h.sum - seen[n][1]) / (h.count - seen[n][0])
            for n, h in hists.items() if h.count > seen[n][0]}
    out_tokens = sum(len(o.token_ids) for o in outs)
    if out_tokens != len(prompts) * new_tokens or not all(
            0 <= t < eng.model.config.vocab_size
            for o in outs for t in o.token_ids):
        raise AssertionError("serve: malformed token streams")
    if eng.kv.occupancy() != 0.0:
        raise AssertionError("serve: the pool is not empty at the end")
    return {
        "graphs": not eager, "seconds": wall,
        "output_tokens_per_s": out_tokens / wall,
        "total_tokens_per_s": (out_tokens + sum(map(len, prompts))) / wall,
        "mean_ttft_s": mean["time_to_first_token"],
        "mean_itl_s": mean["inter_token_latency"],
        # mean wall time of one launch of each family (the host's work
        # included: each ends when its tokens reach the host)
        "mean_step_ms": {n: mean[n] * 1e3 for n in names[2:] if n in mean},
        "captures": g1["captures"] - g0["captures"],
        "capture_s": g1["capture_s"] - g0["capture_s"],
        "replays": g1["replays"] - g0["replays"],
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "max_memory_reserved": torch.cuda.max_memory_reserved()}, outs


def same_lengths(rng, prompts, vocab):
    """Fresh prompts of the same lengths: the same schedule and buckets, no
    prefix-cache hit on the earlier ones."""
    return [rng.integers(0, vocab, len(p)).tolist() for p in prompts]


def serve_phase(torch, rp, serving, graphs, LlamaConfig, LlamaForCausalLM):
    """Llama-3-8B, bf16, through the unified LLM: a cold pass with the step
    graphs (the captures inside it), a warm pass on fresh prompts of the
    same lengths (replays only), and an eager pass."""
    cfg = LlamaConfig.llama3_8b()
    layers = cfg.num_hidden_layers
    gen = torch.Generator(device="cuda").manual_seed(1)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             generator=gen)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size,
                            int(rng.integers(256, 2049))).tolist()
               for _ in range(16)]
    new_tokens = 64
    warm = [rng.integers(0, cfg.vocab_size, 48).tolist()]
    need = sum(-(-(len(p) + new_tokens) // 16) for p in prompts + warm) + 1
    llm = serving.LLM(model, config=serving.EngineConfig(
        num_blocks=need + 16, block_size=16, dtype=torch.bfloat16,
        unified_step=True,
        scheduler=serving.SchedulerConfig(max_num_seqs=16,
                                          max_tokens_per_step=512)))
    eng = llm.engine
    llm.generate(warm, serving.SamplingParams(max_new_tokens=2))
    passes = {}
    for name, batch, eager in (
            ("cold", prompts, False),
            ("warm", same_lengths(rng, prompts, cfg.vocab_size), False),
            ("eager", same_lengths(rng, prompts, cfg.vocab_size), True)):
        steps0 = eng.ragged_launches
        rp.launches = rp.simple_launches = rp.tma_launches = 0
        passes[name], _ = serve_pass(torch, serving, graphs, llm, batch,
                                     new_tokens, eager)
        steps = eng.ragged_launches - steps0
        routes = {"simple": rp.simple_launches, "tma": rp.tma_launches}
        if rp.launches != steps * layers or routes["tma"] != rp.launches:
            raise AssertionError(
                f"serve {name}: {rp.launches} kernel launches for {steps} "
                f"steps x {layers} layers, by route {routes} (every one "
                f"due on the tma route)")
        passes[name].update(engine_steps=steps, kernel_launches=rp.launches,
                            route_launches=routes)
    cold = passes.pop("cold")
    check_traces("serve", eng, ("ragged",))
    emit("serve", model="llama3_8b", layers=layers, dtype="bfloat16",
         prompts=len(prompts), prompt_tokens=sum(map(len, prompts)),
         new_tokens_each=new_tokens, **cold, **passes,
         trace_counts=graph_counts(eng),
         buckets=sorted(eng.ragged_buckets),
         preemptions=eng.metrics.counters["preemptions"],
         model_build_s=build_s, num_blocks=eng.num_blocks)
    return cold["kernel_launches"], llm, prompts, warm, new_tokens, \
        passes["warm"]


def program_walls(eng):
    """{program: (launches, wall seconds)} of the step profiler so far."""
    out = {}
    for r in eng.stepprof.program_table():
        n, w = out.get(r["program"], (0, 0.0))
        out[r["program"]] = (n + r["launches"], w + r["wall_s"])
    return out


def serve_legacy_phase(torch, pd, serving, graphs, model, prompts, warm,
                       new_tokens):
    """The serve model and prompts through the legacy LLM in bf16, without
    and with decode bursts of 8, each as a cold pass with the step graphs,
    a warm pass on fresh prompts of the same lengths and an eager pass.
    Returns the decode-kernel launches of the burst-free cold pass and the
    two LLMs."""
    layers = model.config.num_hidden_layers
    vocab = model.config.vocab_size
    need = sum(-(-(len(p) + new_tokens) // 16) for p in prompts + warm) + 1
    rng = np.random.default_rng(5)
    rows, llms = {}, {}
    for name, burst in (("legacy", 0), ("legacy_burst", 8)):
        kw = {}
        if burst:
            kw["config"] = serving.EngineConfig(
                num_blocks=need + 16, block_size=16, dtype=torch.bfloat16,
                burst_steps=burst,
                scheduler=serving.SchedulerConfig(max_num_seqs=16))
        llm = serving.LLM(model, num_blocks=need + 16, block_size=16,
                          dtype=torch.bfloat16, max_num_seqs=16, **kw)
        eng = llm.engine
        llm.generate(warm, serving.SamplingParams(max_new_tokens=2))
        passes, tokens = {}, None
        for label, batch, eager in (
                ("cold", prompts, False),
                ("warm", same_lengths(rng, prompts, vocab), False),
                ("eager", same_lengths(rng, prompts, vocab), True)):
            before = legacy_counts(eng)
            walls = program_walls(eng)
            pd.launches = pd.simple_launches = pd.mma_launches = 0
            passes[label], outs = serve_pass(torch, serving, graphs, llm,
                                             batch, new_tokens, eager)
            after = legacy_counts(eng)
            passes[label]["program_ms"] = {
                prog: (w - walls.get(prog, (0, 0.0))[1]) * 1e3
                / (n - walls.get(prog, (0, 0.0))[0])
                for prog, (n, w) in program_walls(eng).items()
                if n > walls.get(prog, (0, 0.0))[0]}
            steps = {k: after[k] - before[k] for k in after}
            routes = {"simple": pd.simple_launches, "mma": pd.mma_launches}
            if pd.launches != steps["decode_launches_due"] or \
                    routes["mma"] != pd.launches:
                raise AssertionError(
                    f"serve_legacy {name} {label}: {pd.launches} "
                    f"decode-kernel launches, not (decode steps "
                    f"{steps['decode_steps']} + burst iterations "
                    f"{steps['burst_iterations']}) x {layers} layers, or "
                    f"not all on the mma route (bf16): {routes}")
            if burst and steps["bursts"] == 0:
                raise AssertionError(f"serve_legacy {label}: no burst "
                                     f"launched")
            passes[label].update(decode_kernel_launches=pd.launches,
                                 route_launches=routes, **steps)
            if label == "cold":
                tokens = [o.token_ids for o in outs]
        check_traces(f"serve_legacy {name}", eng,
                     ("decode", "burst") if burst else ("decode",))
        passes["stepprof"] = check_stepprof(f"serve_legacy {name}", eng)
        passes["pool"] = check_pool_rows(f"serve_legacy {name}", eng)
        cold = passes.pop("cold")
        rows[name] = dict(
            cold, burst_steps=burst, tokens=tokens,
            trace_counts=graph_counts(eng),
            preemptions=eng.metrics.counters["preemptions"],
            num_blocks=eng.num_blocks,
            buckets={"decode": sorted(eng.decode_buckets),
                     "prefill": sorted(eng.prefill_buckets),
                     "burst": sorted(eng.burst_buckets)}, **passes)
        llms[name] = llm
    legacy, bursty = rows["legacy"], rows["legacy_burst"]
    if not bursty["roundtrips"] < legacy["roundtrips"]:
        raise AssertionError("serve_legacy: bursts did not cut the host "
                             "round trips")
    agree = sum(a == b for ta, tb in zip(legacy.pop("tokens"),
                                         bursty.pop("tokens"))
                for a, b in zip(ta, tb))
    emit("serve_legacy", model="llama3_8b", layers=layers, dtype="bfloat16",
         prompts=len(prompts), prompt_tokens=sum(map(len, prompts)),
         new_tokens_each=new_tokens, burst_tokens_agreeing=agree, **rows)
    return legacy["decode_kernel_launches"], llms


FAMILIES = ("prefill_step", "decode_step", "burst_step", "unified_step")


@contextlib.contextmanager
def host_split(graphs, eng, out):
    """Time the host's parts of every engine step inside the block (by
    time.perf_counter, no synchronisation added): the whole step, the
    scheduler, each family's call (the StepTimer histograms: for a graphed
    family the copy into its static buffers, the replay's enqueue and the
    wait for its tokens), the copies and the replays alone, and the
    telemetry hooks (``TELEMETRY_HOOKS``: the step profiler, the pool
    tracker, the lifecycle tracker, the auditor, the history; the
    auditor's calls inside a family's StepTimer are counted there too);
    what is left of a step outside its families is the host's packing of
    the step's arrays and its emission bookkeeping, telemetry included.
    Fills ``out`` with ms per step."""
    acc = dict.fromkeys(("step", "schedule", "copy_in", "replay_enqueue",
                         "telemetry"), 0.0)

    def timed(fn, part):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                acc[part] += time.perf_counter() - t0
        return wrapper

    sums = {n: eng.metrics.histogram(n).sum for n in FAMILIES}
    steps0 = eng.step_seq
    fill, replay = graphs.StepGraphs._fill, graphs.StepGraphs._replay
    eng.step = timed(eng.step, "step")
    eng.scheduler.schedule = timed(eng.scheduler.schedule, "schedule")
    graphs.StepGraphs._fill = timed(fill, "copy_in")
    graphs.StepGraphs._replay = timed(replay, "replay_enqueue")
    hooked = [(obj, name) for attr, names in TELEMETRY_HOOKS
              for obj in [getattr(eng, attr)] if obj is not None
              for name in names]
    for obj, name in hooked:
        setattr(obj, name, timed(getattr(obj, name), "telemetry"))
    try:
        yield
    finally:
        graphs.StepGraphs._fill, graphs.StepGraphs._replay = fill, replay
        del eng.step, eng.scheduler.schedule
        for obj, name in hooked:
            delattr(obj, name)
    n = eng.step_seq - steps0
    fam = {f: (eng.metrics.histogram(f).sum - sums[f]) for f in FAMILIES}
    in_families = sum(fam.values())
    ms = {k: v / n * 1e3 for k, v in acc.items()}
    ms.update({f: v / n * 1e3 for f, v in fam.items() if v})
    ms["outside_families"] = (acc["step"] - acc["schedule"]
                              - in_families) / n * 1e3
    out.update(steps=n, host_ms_per_step=ms)


def profile_phase(torch, serving, graphs, llm, vocab, window_name="unified",
                  label="ragged", marks=KERNEL_MARKS, new_tokens=8):
    """torch.profiler over a short window of a warm serve engine (4
    prompts of 1024 tokens, ``new_tokens`` new tokens each): device time by
    kernel and the shares of the attention kernel and of the matrix
    products, with the step graphs and (``eager``) without.  A first
    window captures the keys new to it; then each mode's window runs once
    without the profiler, timing the host's parts of a step
    (:func:`host_split`), and its wall time against the profiled device
    time gives the device's idle share (the profiler's own host cost would
    inflate it)."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(3)
    eng = llm.engine

    def window():
        # fresh prompts each time: no prefix-cache hits
        prompts = [rng.integers(0, vocab, 1024).tolist() for _ in range(4)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        llm.generate(prompts, serving.SamplingParams(
            max_new_tokens=new_tokens))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6

    rows = {}
    window()   # captures any key new to this window before it is timed
    for mode in ("graphs", "eager"):
        row = {}
        with graphs.disable_graphs() if mode == "eager" \
                else contextlib.nullcontext():
            g0 = graph_counts(eng)
            with host_split(graphs, eng, row):
                wall_us = window()
            g1 = graph_counts(eng)
            # a window whose profile holds no attention kernel is profiled
            # again, twice at most, as in device_times; a kernel replayed
            # inside a graph must show in the trace
            for attempt in range(3):
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    profiled_us = window()
                kernels = device_kernels(prof)
                kernel_share = share(kernels, marks)
                if kernel_share:
                    break
            g2 = graph_counts(eng)
        if not kernel_share:
            raise AssertionError(
                f"profile {window_name} {mode}: no {label} kernel in the "
                f"device traces of three windows ({len(kernels)} kernels, "
                f"{g2['replays'] - g1['replays']} replays)")
        busy = sum(kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
        rows[mode] = dict(
            row, window_wall_us=wall_us, profiled_wall_us=profiled_us,
            device_busy_us=busy,
            idle_share=(1 - busy / wall_us) if busy else None,
            **{f"{label}_kernel_share": kernel_share},
            matmul_share=share(kernels, MATMUL_MARKS),
            captures={"unprofiled": g1["captures"] - g0["captures"],
                      "profiled": g2["captures"] - g1["captures"]},
            replays={"unprofiled": g1["replays"] - g0["replays"],
                     "profiled": g2["replays"] - g1["replays"]},
            profiled_windows=attempt + 1,
            top_kernels=[{"name": k[:120], "us": us} for k, us in top])
    emit("profile", window=window_name, new_tokens=new_tokens,
         **rows["graphs"], eager=rows["eager"])


def device_kernels(prof):
    """Device microseconds by kernel name in a profile.  Device rows only:
    an operator row also carries the device time of the kernels it
    launched, which would count them twice."""
    from torch.autograd import DeviceType

    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            kernels[e.key] = kernels.get(e.key, 0.0) + e.self_device_time_total
    return kernels


def share(kernels, marks):
    """The share of device time in kernels whose names hold a mark."""
    busy = sum(kernels.values())
    return (sum(us for k, us in kernels.items()
                if any(m in k.lower() for m in marks)) / busy
            if busy else None)


# --- observability phases -----------------------------------------------------

# the category of a device kernel's events in torch.profiler's chrome trace
TRACE_KERNEL_CAT = "kernel"
# every telemetry field of EngineConfig off (the auditor is off by default)
TELEMETRY_OFF = dict(lifecycle_events=False, step_profile=False,
                     cache_stats=False, history=False)


def telemetry_on(obs, eng, dump_dir):
    """Everything on beyond the defaults: a metrics history with the
    default alert rules, and a flight recorder bound to the engine's
    lifecycle, step profiler, pool tracker and auditor."""
    reg = eng.metrics.registry
    hist = obs.HistoryStore(reg)
    alerts = obs.AlertEngine(hist, registry=reg)
    eng.set_history(hist)
    fr = obs.FlightRecorder(registry=reg, lifecycle=eng.lifecycle,
                            config=obs.FlightConfig(dump_dir=dump_dir))
    fr.bind_step_profilers({"0": eng.stepprof})
    fr.bind_cache_trackers({"0": eng.cachestat})
    eng.audit.bind_flight(fr)
    return hist, alerts, fr


def bucket_strs(eng):
    """The engine's bucket sets as the step profiler names them."""
    out = {p: set() for p in ("prefill", "chunk", "decode", "ragged",
                              "burst")}
    for b in (eng.prefill_buckets | eng.decode_buckets | eng.ragged_buckets
              | eng.burst_buckets):
        out[b[0]].add("x".join(str(int(v)) for v in b[1:]))
    return out


def check_stepprof(label, eng):
    """The step profiler's scheduled tokens equal the scheduler's planned
    tokens, and its bucket set of each family is the engine's."""
    sp = eng.stepprof
    if sp.scheduled_tokens() != eng.scheduler.tokens_planned:
        raise AssertionError(
            f"{label}: the step profiler scheduled {sp.scheduled_tokens()} "
            f"tokens, the scheduler planned {eng.scheduler.tokens_planned}")
    want = bucket_strs(eng)
    for program, buckets in want.items():
        if sp.bucket_set(program) != buckets:
            raise AssertionError(
                f"{label}: step-profiler buckets of {program} "
                f"{sorted(sp.bucket_set(program))} against the engine's "
                f"{sorted(buckets)}")
    return {"scheduled_tokens": sp.scheduled_tokens(),
            "tokens_planned": eng.scheduler.tokens_planned,
            "bucket_sets": {p: sorted(b) for p, b in want.items() if b},
            "compiles": sp.compile_totals()}


def check_pool_rows(label, eng):
    """Every row of the pool timeline has free + reuse + allocated ==
    num_blocks (sample_pool checks it at every step and raises; the ring
    keeps the last 256 rows, which are checked again here)."""
    rows = eng.cachestat.timeline()
    bad = [r for r in rows
           if r["free"] + r["reuse"] + r["allocated"] != eng.num_blocks]
    if not rows or bad or len(rows) != min(eng.step_seq, 256):
        raise AssertionError(f"{label}: pool timeline of {len(rows)} rows "
                             f"for {eng.step_seq} steps, {len(bad)} broken")
    return {"steps_sampled": eng.step_seq, "rows_rechecked": len(rows),
            "free_min": min(r["free"] for r in rows),
            "allocated_max": max(r["allocated"] for r in rows)}


def obs_engine(serving, model, need, family, **fields):
    """An engine of the observability checks over ``need`` + 16 pages:
    ``unified`` (a 256-token step budget), ``legacy`` (decode bursts of 8)
    or ``decode`` (the legacy families without bursts), prefills budgeted
    at 256 tokens."""
    sched = (serving.SchedulerConfig(max_num_seqs=8, max_tokens_per_step=256)
             if family == "unified" else
             serving.SchedulerConfig(max_num_seqs=8,
                                     max_prefill_tokens_per_step=256))
    fam = {"unified": dict(unified_step=True),
           "legacy": dict(burst_steps=8), "decode": {}}[family]
    dtype = next(model.parameters()).dtype
    return serving.EngineCore(model, config=serving.EngineConfig(
        num_blocks=need + 16, block_size=16, dtype=dtype, scheduler=sched,
        **fam, **fields))


def launch_counts(rp, pd, eng, family):
    """The kernel launches of a run and those due: the ragged kernel once
    per layer per unified step, the decode kernel once per layer per
    decode step or burst iteration."""
    layers = eng.model.config.num_hidden_layers
    if family == "unified":
        return rp.launches, eng.ragged_launches * layers, {
            "simple": rp.simple_launches, "tma": rp.tma_launches}
    return pd.launches, legacy_counts(eng)["decode_launches_due"], {
        "simple": pd.simple_launches, "mma": pd.mma_launches}


def reset_launches(rp, pd):
    rp.launches = rp.simple_launches = rp.tma_launches = 0
    pd.launches = pd.simple_launches = pd.mma_launches = 0


def identity_telemetry_phase(torch, rp, pd, serving, obs, model, prompts,
                             LlamaForCausalLM):
    """The identity model (fp32, simple route) and a bf16 model of the same
    widths (tma and mma routes), unified and legacy with bursts of 8, each
    with every telemetry hook on (the defaults, the auditor at
    sample_every=1, a metrics history with alert rules, a flight recorder)
    and with every one off: greedy tokens and captures equal, and launches
    = steps x layers either way.  The fp32 runs must audit clean at
    AuditConfig's default 1e-4 tolerance."""
    cfg = model.config
    layers = cfg.num_hidden_layers
    gen = torch.Generator(device="cuda").manual_seed(4)
    bf16 = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                            generator=gen)
    need = sum(-(-(len(p) + 16) // 16) for p in prompts) + 1
    routes = {("float32", "unified"): "simple",
              ("float32", "legacy"): "simple",
              ("bfloat16", "unified"): "tma", ("bfloat16", "legacy"): "mma"}
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dtype, m in (("float32", model), ("bfloat16", bf16)):
            for family in ("unified", "legacy"):
                runs = {}
                for tele in ("on", "off"):
                    fields = (dict(audit=obs.AuditConfig(
                        enabled=True, sample_every=1)) if tele == "on"
                        else TELEMETRY_OFF)
                    eng = obs_engine(serving, m, need, family, **fields)
                    if tele == "on":
                        telemetry_on(obs, eng, tmp)
                    reset_launches(rp, pd)
                    t0 = time.perf_counter()
                    reqs = [eng.add_request(p, serving.SamplingParams(
                        max_new_tokens=16)) for p in prompts]
                    eng.run(max_steps=2000)
                    torch.cuda.synchronize()
                    launches, due, by_route = launch_counts(rp, pd, eng,
                                                            family)
                    route = routes[dtype, family]
                    if launches != due or by_route[route] != launches \
                            or not launches:
                        raise AssertionError(
                            f"identity_telemetry {dtype} {family} {tele}: "
                            f"{launches} kernel launches, {due} due (steps "
                            f"x {layers} layers), by route {by_route} (all "
                            f"due on the {route} route)")
                    g = graph_counts(eng)
                    runs[tele] = {
                        "tokens": [list(r.output_tokens) for r in reqs],
                        "seconds": time.perf_counter() - t0,
                        "kernel_launches": launches,
                        "captures": {k: v for k, v in g.items()
                                     if k not in ("capture_s", "replays")},
                        "replays": g["replays"]}
                    if tele == "on":
                        snap = eng.audit.snapshot()
                        runs[tele].update(
                            audit={k: snap[k] for k in (
                                "status", "steps", "audited_launches",
                                "divergences", "oracle_failures")},
                            max_logit_gap=eng.audit.max_abs_diff,
                            stepprof=check_stepprof(
                                f"identity_telemetry {dtype} {family}",
                                eng),
                            pool=check_pool_rows(
                                f"identity_telemetry {dtype} {family}",
                                eng),
                            history_samples=eng.history.stats()["samples"],
                            lifecycle_events=int(eng.metrics.registry
                                                 .counter(
                                "serving_lifecycle_events_total").value))
                        if snap["oracle_failures"]:
                            raise AssertionError(
                                f"identity_telemetry {dtype} {family}: "
                                f"{snap['oracle_failures']} shadow "
                                f"re-executions failed")
                        if sum(snap["audited_launches"].values()) == 0:
                            raise AssertionError(
                                f"identity_telemetry {dtype} {family}: "
                                f"nothing was audited")
                        if dtype == "float32" and (
                                snap["status"] != "ok"
                                or sum(snap["divergences"].values())):
                            raise AssertionError(
                                f"identity_telemetry {dtype} {family}: the "
                                f"audit is {snap['status']} with "
                                f"{snap['divergences']} (largest logit gap "
                                f"{eng.audit.max_abs_diff})")
                    del eng
                on, off = runs["on"], runs["off"]
                if on["tokens"] != off["tokens"]:
                    raise AssertionError(
                        f"identity_telemetry {dtype} {family}: telemetry "
                        f"on and off gave different tokens")
                if on["captures"] != off["captures"]:
                    raise AssertionError(
                        f"identity_telemetry {dtype} {family}: captures "
                        f"{on['captures']} with telemetry on, "
                        f"{off['captures']} off")
                for r in runs.values():
                    del r["tokens"]
                rows[f"{dtype}_{family}"] = runs
    del bf16
    gc.collect()
    torch.cuda.empty_cache()
    emit("identity_telemetry", layers=layers, prompts=len(prompts),
         tokens_identical=True, captures_equal=True,
         launches_equal_steps_x_layers=True,
         fp32_audit_clean=True,
         max_logit_gap_fp32={
             f: rows[f"float32_{f}"]["on"]["max_logit_gap"]
             for f in ("unified", "legacy")},
         **rows)


@contextlib.contextmanager
def corrupted_wrappers(rp, pd, torch):
    """A planted fault: the decode and ragged wrappers' output negated,
    except where a call pins the plain twin (the oracle's
    ``use_pallas=False``)."""
    saved = (rp.ragged_paged_attention, pd.paged_attention_decode)

    def corrupt(real):
        def wrapper(*args, use_pallas=None):
            out = real(*args, use_pallas=use_pallas)
            return out if use_pallas is False else torch.neg(out)
        return wrapper

    rp.ragged_paged_attention = corrupt(saved[0])
    pd.paged_attention_decode = corrupt(saved[1])
    try:
        yield
    finally:
        rp.ragged_paged_attention, pd.paged_attention_decode = saved


def audit_fault_phase(torch, rp, pd, serving, obs, model):
    """The auditor must refuse a planted fault: with the kernels' output
    negated, an fp32 unified and an fp32 legacy engine (one 20-token prompt,
    4 new tokens, every step audited) go degraded with exactly one repro
    under max_repro_bytes each, and replay_repro of it on a clean engine
    on the card re-executes the step and reproduces the divergence.  (The
    legacy engine runs without bursts here: a burst is not audited, in
    either package.)"""
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, model.config.vocab_size, 20).tolist()
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        for family, program in (("unified", "ragged"),
                                ("decode", "decode")):
            cfg = obs.AuditConfig(enabled=True, sample_every=1,
                                  repro_dir=f"{tmp}/{family}")
            with corrupted_wrappers(rp, pd, torch):
                eng = obs_engine(serving, model, 8, family, audit=cfg)
                req = eng.add_request(prompt, serving.SamplingParams(
                    max_new_tokens=4))
                eng.run(max_steps=100)
                torch.cuda.synchronize()
            snap = eng.audit.snapshot()
            repros = snap["repros"]
            if snap["status"] != "degraded" or len(repros) != 1 \
                    or snap["divergences"]["token"] == 0 \
                    or snap["oracle_failures"]:
                raise AssertionError(
                    f"audit_fault {family}: status {snap['status']}, "
                    f"{len(repros)} repros, divergences "
                    f"{snap['divergences']}, oracle failures "
                    f"{snap['oracle_failures']}")
            size = os.path.getsize(repros[0])
            meta = obs.load_repro(repros[0])["meta"]
            if size > cfg.max_repro_bytes or meta["dropped"] \
                    or meta["program"] != program:
                raise AssertionError(
                    f"audit_fault {family}: a repro of {size} bytes "
                    f"(cap {cfg.max_repro_bytes}), program "
                    f"{meta['program']}, dropped {meta['dropped']}")
            clean = obs_engine(serving, model, 8, family)
            verdict = obs.replay_repro(repros[0], clean)
            if not (verdict["reproduced"] and verdict["replayed"]):
                raise AssertionError(f"audit_fault {family}: the replay "
                                     f"did not reproduce: {verdict}")
            rows[family] = {"program": program, "repro_bytes": size,
                            "divergences": snap["divergences"],
                            "audited_launches": snap["audited_launches"],
                            "replay": verdict,
                            "tokens_served": len(req.output_tokens)}
            del eng, clean
    emit("audit_fault", degraded=True, one_repro_each=True,
         replay_reproduced=True, **rows)


# the engine's telemetry hooks (object attribute, methods) timed as the
# host_split part "telemetry": the step profiler, the pool tracker, the
# lifecycle tracker, the auditor and the metrics history
TELEMETRY_HOOKS = (
    ("stepprof", ("begin_step", "record_program", "record_compile",
                  "end_step")),
    ("cachestat", ("sample_pool", "record_admission", "record_prefix_hit",
                   "close_request", "record_eviction", "record_revive")),
    ("lifecycle", ("event",)),
    ("audit", ("begin_step", "snapshot_pools", "observe_program")),
    ("history", ("on_step",)),
)


def scrape(port):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def serve_telemetry_phase(torch, rp, serving, graphs, obs, llm, prompts,
                          new_tokens, window_tokens=1024):
    """On the full-width unified serve engine (telemetry on by default):
    the pool invariant on its timeline, the step profiler against the
    scheduler and the bucket sets, a capture window of 4 steps with
    torch.profiler (over 4 prompts of ``window_tokens`` tokens) that must
    name the ragged kernel inside graph replays,
    and a scrape of /metrics.  Then the cost: warm passes with the
    defaults and with every telemetry field off, in turns (on, off, off,
    on), and a warm pass with the auditor at its default sample_every=16;
    tokens/s, mean ITL, warm step ms, the telemetry hooks' host ms a step,
    and the auditor's snapshot memory."""
    eng = llm.engine
    model = eng.model
    vocab = model.config.vocab_size
    out = {"pool": check_pool_rows("serve_telemetry", eng),
           "stepprof": check_stepprof("serve_telemetry", eng)}
    rng = np.random.default_rng(8)
    with tempfile.TemporaryDirectory() as tmp:
        for attempt in range(3):
            g0 = graph_counts(eng)
            window = eng.stepprof.arm_capture(4, device_trace=True,
                                              log_dir=f"{tmp}/{attempt}")
            llm.generate([rng.integers(0, vocab, window_tokens).tolist()
                          for _ in range(4)],
                         serving.SamplingParams(max_new_tokens=8))
            torch.cuda.synchronize()
            g1 = graph_counts(eng)
            res = window.result
            if res is None or "deviceTraceError" in res:
                raise AssertionError(f"serve_telemetry: capture window "
                                     f"{res and res['deviceTraceError']}")
            steps = [e for e in res["traceEvents"]
                     if e["name"] == "engine_step"]
            with open(res["deviceTraceFile"]) as f:
                trace = json.load(f)
            kernels = [e["name"] for e in trace["traceEvents"]
                       if e.get("cat") == TRACE_KERNEL_CAT]
            ragged = sorted({k for k in kernels
                             if any(m in k for m in KERNEL_MARKS)})
            if len(steps) != 4 or res["captureSteps"] != 4:
                raise AssertionError(f"serve_telemetry: the window holds "
                                     f"{len(steps)} engine_step spans")
            if ragged and g1["replays"] > g0["replays"]:
                break
        else:
            raise AssertionError(
                f"serve_telemetry: no ragged kernel in the profiler traces "
                f"of three capture windows ({len(kernels)} kernels, "
                f"{g1['replays'] - g0['replays']} replays)")
    out["capture_window"] = {
        "engine_step_spans": len(steps), "windows": attempt + 1,
        "replays": g1["replays"] - g0["replays"],
        "device_kernels": len(kernels), "ragged_kernels": ragged,
        "program_spans": sum(1 for e in res["traceEvents"]
                             if e.get("cat") == "stepprof"
                             and e["name"] != "engine_step")}
    reg = eng.metrics.registry
    srv = obs.start_metrics_server(reg, port=0)
    try:
        status, ctype, body = scrape(srv.port)
    finally:
        srv.close()
    text = body.decode()
    needed = ("serving_step_seconds_bucket", "serving_scheduled_tokens_total",
              "serving_compiles_total", "serving_pool_free_blocks",
              "serving_pool_allocated_blocks",
              "serving_prefix_cache_hit_tokens_total",
              "serving_lifecycle_events_total")
    missing = [n for n in needed if n not in text]
    if status != 200 or not ctype.startswith("text/plain; version=0.0.4") \
            or missing:
        raise AssertionError(f"serve_telemetry: /metrics answered {status} "
                             f"{ctype}, missing {missing}")
    out["scrape"] = {"status": status, "bytes": len(body),
                     "series_lines": sum(1 for ln in text.splitlines()
                                         if ln and not ln.startswith("#")),
                     "has": list(needed)}

    # the cost of telemetry: the same config with every field off, and
    # with the auditor on at its default schedule
    base = eng.engine_config
    llms = {"on": llm}
    for name, fields in (("off", TELEMETRY_OFF),
                         ("audit16", dict(audit=obs.AuditConfig(
                             enabled=True)))):
        llms[name] = serving.LLM(model, config=serving.EngineConfig(
            num_blocks=base.num_blocks, block_size=base.block_size,
            dtype=base.dtype, unified_step=True, scheduler=base.scheduler,
            **fields))
        # a cold pass captures this engine's buckets before it is timed
        serve_pass(torch, serving, graphs, llms[name],
                   same_lengths(rng, prompts, vocab), new_tokens)
    passes = []
    for name in ("on", "off", "off", "on", "audit16"):
        row = {}
        e = llms[name].engine
        steps0 = e.ragged_launches
        rp.launches = rp.simple_launches = rp.tma_launches = 0
        with host_split(graphs, e, row):
            res, _ = serve_pass(torch, serving, graphs, llms[name],
                                same_lengths(rng, prompts, vocab),
                                new_tokens)
        steps = e.ragged_launches - steps0
        if rp.launches != steps * model.config.num_hidden_layers:
            raise AssertionError(f"serve_telemetry {name}: {rp.launches} "
                                 f"launches for {steps} steps")
        passes.append({
            "telemetry": name,
            "output_tokens_per_s": res["output_tokens_per_s"],
            "mean_itl_s": res["mean_itl_s"],
            "mean_unified_step_ms": res["mean_step_ms"]["unified_step"],
            "max_memory_allocated": res["max_memory_allocated"],
            "captures": res["captures"], "engine_steps": steps,
            "host_ms_per_step": row["host_ms_per_step"]})
    a16 = llms["audit16"].engine
    snap = a16.audit.snapshot()
    if snap["oracle_failures"] or not sum(snap["audited_launches"].values()):
        raise AssertionError(f"serve_telemetry audit16: {snap}")
    out["cost"] = passes
    out["audit16"] = {
        "status": snap["status"], "steps": snap["steps"],
        "audited_launches": snap["audited_launches"],
        "divergences": snap["divergences"],
        "max_logit_gap": a16.audit.max_abs_diff,
        "snapshot_bytes_max": a16.audit.snapshot_bytes_max,
        "peak_allocated_over_on": passes[4]["max_memory_allocated"]
        - max(p["max_memory_allocated"] for p in passes
              if p["telemetry"] == "on")}
    del llms["off"], llms["audit16"]
    gc.collect()
    torch.cuda.empty_cache()
    emit("serve_telemetry", **out)


# --- training phases ----------------------------------------------------------

# (B, Sq, Sk, H, Hkv, D) of the flash checks at small shapes: those of
# tests/test_torch_flash_attention.py, on the card and against the Pallas
# kernels (ragged edges, one token, rectangular, GQA 8:1 / 4:1 / 2:1 / 1:1
# at head dims 64 and 128, S up to 512), the edges of the TMA kernels'
# 64- and 128-row tiles (S = 130 and 4000), and GQA 7:1 and 3:1, groups
# that fill 126 of a block's 128 rows
FLASH_TINY = [(1, 128, 128, 4, 1, 128), (2, 100, 100, 4, 2, 64),
              (1, 70, 70, 2, 2, 128), (1, 1, 1, 2, 1, 64),
              (2, 200, 200, 8, 2, 128), (1, 96, 160, 4, 2, 64),
              (1, 256, 256, 4, 1, 128), (2, 128, 128, 2, 2, 64),
              (1, 512, 512, 2, 1, 64), (1, 130, 130, 8, 1, 128),
              (1, 200, 200, 16, 2, 64), (1, 130, 130, 2, 2, 64),
              (1, 4000, 4000, 4, 1, 64), (1, 4000, 4000, 8, 2, 128),
              (1, 200, 200, 28, 4, 128), (1, 130, 130, 6, 2, 64)]
TRAIN_B, TRAIN_S = 2, 4096     # the train phase's batch and sequence


def flash_counts(flash):
    return {"fwd": flash.fwd_launches, "dq": flash.dq_launches,
            "dkv": flash.dkv_launches}


def reset_flash_counts(flash):
    flash.fwd_launches = flash.dq_launches = flash.dkv_launches = 0


def flash_work(q, k, causal):
    """Operations of each flash kernel on these shapes (an S x Sk x D
    product is 2·S·Sk·D per head, halved under the causal mask: forward 2,
    dQ 3, dK/dV 4 products) and the bytes each must move, each input read
    once and each output written once."""
    B, S, H, D = q.shape
    Sk = k.shape[1]
    unit = 2.0 * B * H * S * Sk * D * (0.5 if causal else 1.0)
    qb, kb = q.numel() * q.element_size(), k.numel() * k.element_size()
    stat = B * H * S * 4          # lse or delta, fp32
    return {"fwd": (2 * unit, 2 * qb + 2 * kb + stat),
            "dq": (3 * unit, 3 * qb + 2 * kb + 2 * stat),
            "dkv": (4 * unit, 2 * qb + 4 * kb + 2 * stat)}


def tensor_wide_err(got, want):
    """Max abs error over the twin's largest value, floored at 1: the
    measure these checks used before flash.rowwise_error, read beside it on
    the planted faults."""
    return (float((got.float() - want).abs().max())
            / max(float(want.abs().max()), 1.0))


def tail_zeroed(t, rows=64):
    """``t`` with its last tile of rows along dim 1 (queries or keys)
    zeroed: what a kernel that skipped its last tile would write."""
    t = t.clone()
    t[:, -rows:] = 0
    return t


def flash_check(torch, flash, label, q, k, v, do, causal, plant=False):
    """The three kernels in the order of a training step, each against its
    twin run in fp32 on the same inputs (the backward twins take the
    kernel's lse and delta), by flash.rowwise_error: each row of out, dQ,
    dK and dV is held to its own twin row, so that a wrong tail of a causal
    sequence, where the rows are small, shows.  With ``plant``, the measure
    is also read on each output with its last 64-row tile zeroed, and must
    fail there.  Returns a record of the errors (per row and absolute), the
    twin's largest value and smallest row, the planted reads, the
    tolerance, and the kernel's lse and delta; raises on a disagreement."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    out, lse = flash.fwd_kernel(q, k, v, causal)
    delta = torch.einsum("bshd,bshd->bhs", do.float(),
                         out.float()).contiguous()
    dq = flash.bwd_dq_kernel(q, k, v, do, lse, delta, causal)
    dk, dv = flash.bwd_dkv_kernel(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    f32 = [t.float() for t in (q, k, v, do)]
    rec = {"row": {}, "abs": {}, "twin_max": {}, "twin_least_row": {},
           "planted": {}}

    def hold(name, got, want):
        rec["row"][name] = flash.rowwise_error(got, want)
        rec["abs"][name] = float((got.float() - want).abs().max())
        rec["twin_max"][name] = float(want.abs().max())
        rec["twin_least_row"][name] = float(want.abs().amax(-1).min())
        if plant:
            bad = tail_zeroed(got)
            rec["planted"][name] = {
                "row": flash.rowwise_error(bad, want),
                "tensor_wide": tensor_wide_err(bad, want)}

    ref_out, ref_lse = flash.fwd_reference(*f32[:3], scale, causal)
    hold("out", out, ref_out)
    rec["lse"] = float((lse - ref_lse).abs().max())
    del ref_out, ref_lse
    hold("dq", dq, flash.bwd_dq_reference(*f32, lse, delta, scale, causal))
    ref_dk, ref_dv = flash.bwd_dkv_reference(*f32, lse, delta, scale, causal)
    hold("dk", dk, ref_dk)
    hold("dv", dv, ref_dv)
    del ref_dk, ref_dv, f32
    tol = 1e-4 if q.dtype == torch.float32 else 2e-2
    rec["tol"] = tol
    finite = all(bool(torch.isfinite(t.float()).all())
                 for t in (out, lse, dq, dk, dv))
    bad = {n: e for n, e in rec["row"].items() if not e <= tol}
    if not rec["lse"] <= 1e-4:
        bad["lse"] = rec["lse"]
    unseen = {n: r["row"] for n, r in rec["planted"].items()
              if not r["row"] > tol}
    if bad or not finite or unseen:
        raise AssertionError(f"flash kernels disagree with their twins on "
                             f"{label} {q.dtype}: {bad} (tol {tol}), "
                             f"finite={finite}; planted faults read within "
                             f"tolerance: {unseen}")
    return rec, lse, delta


def kernel_err(rec, kind, key):
    """A kernel's error from a flash_check record: out for the forward, dQ,
    and the larger of dK and dV."""
    names = {"fwd": ("out",), "dq": ("dq",), "dkv": ("dk", "dv")}[key]
    return max(rec[kind][n] for n in names)


def flash_library(torch, q, k, v, do):
    """The yardsticks, which the port never calls: scaled_dot_product_
    attention (causal, GQA) on [B, H, S, D] copies made beforehand, and the
    autograd backward of that call, which computes dQ, dK and dV in one."""
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    g = do.transpose(1, 2).contiguous()

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)

    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True)

    def bwd():
        return torch.autograd.grad(out, (qt, kt, vt), g, retain_graph=True)

    return fwd, bwd


def flash_copy_route_check(torch, flash, checks):
    """bf16 q, k, v and dO as views whose rows start off 16 bytes (rows D + 1
    apart), which TMA cannot read: the three wrappers must copy them to
    contiguous tensors first (route "copy", counted once a launch), hold the
    twins, and give what contiguous inputs give, bit for bit."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    B, S, H, Hkv, D = 2, 130, 8, 2, 128
    bufs = [torch.randn(B, S, n, D + 1, device=dev, generator=gen)
            .bfloat16() for n in (H, Hkv, Hkv, H)]
    views = [t[..., 1:] for t in bufs]
    copies = flash.copy_launches
    rec, _, _ = flash_check(torch, flash, "unaligned views", *views, True)
    routed = {"copies": flash.copy_launches - copies,
              "route": flash.last_route}
    checks.append({"case": "unaligned views (2, 130, 130, 8, 2, 128) "
                           "causal=True", "dtype": "bfloat16", **rec})
    outs = []
    for q, k, v, do in (views, [t.contiguous() for t in views]):
        out, lse = flash.fwd_kernel(q, k, v, True)
        delta = torch.einsum("bshd,bshd->bhs", do.float(),
                             out.float()).contiguous()
        outs.append((out, lse,
                     flash.bwd_dq_kernel(q, k, v, do, lse, delta, True),
                     *flash.bwd_dkv_kernel(q, k, v, do, lse, delta, True)))
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(*outs))
    if routed != {"copies": 3, "route": "copy"} or not same:
        raise AssertionError(f"flash copy route: {routed} (due 3 copies on "
                             f"route 'copy'), bit-equal to contiguous: "
                             f"{same}")
    return {**routed, "bit_equal_to_contiguous": same}


def flash_kernel_phase(torch, flash):
    """The three flash kernels against their twins at the CPU tests' shapes
    and at Llama-3-8B's training shape (H=32, Hkv=8, D=128, causal, B=2,
    S=4096), fp32 and bf16; at the training shape the kernel's CUDA-event
    and profiler device times, the twin's, the library's and the bound."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    checks = []

    def inputs(B, Sq, Sk, H, Hkv, D):
        return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                .to(dev) for s in ((B, Sq, H, D), (B, Sk, Hkv, D),
                                   (B, Sk, Hkv, D), (B, Sq, H, D))]

    for case in FLASH_TINY:
        q32, k32, v32, do32 = inputs(*case)
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (False, True):
                rec, _, _ = flash_check(
                    torch, flash, f"tiny {case} causal={causal}",
                    *(t.to(dtype) for t in (q32, k32, v32, do32)), causal)
                checks.append({"case": f"tiny {case} causal={causal}",
                               "dtype": str(dtype).split(".")[-1], **rec})

    copy_route = flash_copy_route_check(torch, flash, checks)

    B, S, H, Hkv, D = TRAIN_B, TRAIN_S, 32, 8, 128
    q32, k32, v32, do32 = inputs(B, S, S, H, Hkv, D)
    timings, summary = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        q, k, v, do = (t.to(dtype) for t in (q32, k32, v32, do32))
        # the planted faults: each output with its last tile zeroed must
        # fail the check at the shape where rows are smallest
        rec, lse, delta = flash_check(torch, flash, "8b train shape",
                                      q, k, v, do, True, plant=True)
        checks.append({"case": "8b train shape", "dtype": name, **rec})
        scale = 1.0 / np.sqrt(D)
        kernels = {
            "fwd": lambda: flash.fwd_kernel(q, k, v, True),
            "dq": lambda: flash.bwd_dq_kernel(q, k, v, do, lse, delta, True),
            "dkv": lambda: flash.bwd_dkv_kernel(q, k, v, do, lse, delta,
                                                True)}
        plains = {
            "fwd": lambda: flash.fwd_reference(q, k, v, scale, True),
            "dq": lambda: flash.bwd_dq_reference(q, k, v, do, lse, delta,
                                                 scale, True),
            "dkv": lambda: flash.bwd_dkv_reference(q, k, v, do, lse, delta,
                                                   scale, True)}
        lib_fwd, lib_bwd = flash_library(torch, q, k, v, do)
        # the yardstick computes this function: its output against the
        # twin's (its gradients are the pair's yardstick, checked loosely:
        # it rounds elsewhere than the kernels do)
        ref_out, _ = flash.fwd_reference(*(t.float() for t in (q, k, v)),
                                         scale, True)
        lib_err = float((lib_fwd().transpose(1, 2).float() - ref_out)
                        .abs().max())
        del ref_out
        lib_grads = lib_bwd()
        ref_dk, ref_dv = flash.bwd_dkv_reference(
            *(t.float() for t in (q, k, v, do)), lse, delta, scale, True)
        lib_grad_err = max(tensor_wide_err(lib_grads[1].transpose(1, 2),
                                           ref_dk),
                           tensor_wide_err(lib_grads[2].transpose(1, 2),
                                           ref_dv))
        del ref_dk, ref_dv, lib_grads
        if not (lib_err <= 2e-2 and lib_grad_err <= 5e-2):
            raise AssertionError(f"the library yardstick computes another "
                                 f"function: forward err {lib_err}, "
                                 f"gradient err {lib_grad_err}")
        library = {"fwd": time_ms(lib_fwd, 5), "dq": time_ms(lib_bwd, 5)}
        library["dkv"] = library["dq"]
        for key, (flops, nbytes) in flash_work(q, k, True).items():
            t_flops = flops / PEAK_FLOPS[name] * 1e3
            t_bytes = nbytes / PEAK_BYTES * 1e3
            ms = time_ms(kernels[key], 5)
            row = {
                "kernel": key, "dtype": name, "B": B, "S": S, "H": H,
                "Hkv": Hkv, "D": D, "causal": True,
                "max_abs_err": kernel_err(rec, "abs", key),
                "max_row_err": kernel_err(rec, "row", key),
                "ms": ms, "tflops": flops / ms / 1e9,
                "plain_ms": time_ms(plains[key], 2, 1),
                "library_ms": library[key],
                "library_max_abs_err": lib_err if key == "fwd"
                else lib_grad_err,
                "bound_ms": max(t_flops, t_bytes),
                "bound_by": "operations" if t_flops > t_bytes else "bytes",
                "bound_share": max(t_flops, t_bytes) / ms,
                "flops": flops, "bytes": nbytes,
            }
            timings.append(row)
            if dtype == torch.bfloat16:
                summary[key] = row     # the train phase's shape and type
            torch.cuda.empty_cache()
        del q, k, v, do, lse, delta, kernels, plains, lib_fwd, lib_bwd
        torch.cuda.empty_cache()
    worst = max(checks, key=lambda c: max(max(c["row"].values()) / c["tol"],
                                          c["lse"] / 1e-4))
    emit("flash_kernels", name=FLASH_NAME, checks=len(checks), worst=worst,
         train_shape=[c for c in checks if c["planted"]], timings=timings,
         copy_route=copy_route,
         note="max_row_err is flash.rowwise_error (each row over its twin "
              "row's max, floored at 1e-2 of the twin's max and at 0.1); "
              "planted: the "
              "same outputs with their last 64-row tile zeroed, read by it "
              "and by the tensor-wide measure (error over the twin's max, "
              "floored at 1); library_ms of dq and dkv is one autograd "
              "backward of scaled_dot_product_attention, which computes "
              "both; library_max_abs_err of dq/dkv is tensor-wide")
    return summary


def corpus(rng, B, S):
    """examples/pretrain_llama.py's synthetic corpus: shifted arithmetic
    sequences mod 17, token ids [B, S]."""
    start = rng.integers(0, 17, (B, 1))
    return (start + np.arange(S)) % 17


def lm_loss(model, criterion):
    """A causal LM's step loss: ``criterion(model(ids), ids)``."""
    return lambda ids: criterion(model(ids), ids)


class StepClock:
    """CUDA events at a train loop's step boundaries, recorded with no sync:
    one before the first step, then one after each step's backward and one
    after its optimizer and scheduler step.  ``read()`` syncs once and
    gives each step's seconds and each optimizer step's (backward's end to
    the step's end) on the device's timeline, the host's gaps included."""

    def __init__(self, torch):
        self.torch, self.events = torch, []

    def mark(self):
        event = self.torch.cuda.Event(enable_timing=True)
        event.record()
        self.events.append(event)

    def read(self):
        self.torch.cuda.synchronize()
        ev = self.events
        ends = range(2, len(ev), 2)
        return ([ev[i - 2].elapsed_time(ev[i]) / 1e3 for i in ends],
                [ev[i - 1].elapsed_time(ev[i]) / 1e3 for i in ends])


def train_steps(step_loss, opt, batches, sched=None, after_backward=None,
                clock=None):
    """``step_loss(batch) -> backward -> step -> clear_grad`` (and the
    scheduler's step) for each batch, as a user's loop runs it: no sync
    inside the loop, the losses stay on the device, read after the run.
    ``after_backward(i)`` runs between step i's backward and its optimizer
    step; ``clock`` (a StepClock) marks the step boundaries."""
    losses = []
    if clock is not None:
        clock.mark()
    for i, batch in enumerate(batches):
        loss = step_loss(batch)
        loss.backward()
        if after_backward is not None:
            after_backward(i)
        if clock is not None:
            clock.mark()
        opt.step()
        opt.clear_grad()
        if sched is not None:
            sched.step()
        if clock is not None:
            clock.mark()
        losses.append(loss.detach())
    return losses


def train_identity_phase(torch, flash, fa, port):
    """Llama-3-8B widths cut to 2 layers, fp32, B=1, S=1024: 4 AdamW steps
    with the kernels and 4 with ``use_flash_attention=False`` (the composite
    paths), from the same seeded weights and batches.  The losses agree
    within 1e-4 relative and each kernel launched steps x layers times."""
    layers, S, steps = 2, 1024, 4
    rng = np.random.default_rng(6)
    batches = [torch.from_numpy(corpus(rng, 1, S)).cuda()
               for _ in range(steps)]
    runs = {}
    for use_flash in (True, False):
        cfg = port.LlamaConfig.llama3_8b(num_hidden_layers=layers,
                                         use_flash_attention=use_flash)
        gen = torch.Generator(device="cuda").manual_seed(3)
        model = port.LlamaForCausalLM(cfg, device="cuda",
                                      dtype=torch.float32, generator=gen)
        opt = port.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                         weight_decay=0.01)
        reset_flash_counts(flash)
        t0 = time.perf_counter()
        losses = train_steps(
            lm_loss(model, port.LlamaPretrainingCriterion(cfg)), opt,
            batches)
        torch.cuda.synchronize()
        runs[use_flash] = {"losses": [float(x) for x in losses],
                           "launches": flash_counts(flash),
                           "path": fa.last_path,
                           "seconds": time.perf_counter() - t0}
        del model, opt, losses
        gc.collect()
        torch.cuda.empty_cache()
    kern, plain = runs[True], runs[False]
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(kern["losses"], plain["losses"]))
    if not (np.isfinite(kern["losses"]).all() and rel <= 1e-4):
        raise AssertionError(f"train_identity: kernel losses "
                             f"{kern['losses']} against composite "
                             f"{plain['losses']} (rel {rel})")
    due = {k: steps * layers for k in FLASH_MARKS}
    if (kern["launches"] != due or any(plain["launches"].values())
            or kern["path"] != "cuda"):
        raise AssertionError(f"train_identity: launches {kern['launches']} "
                             f"(due {due}), composite run "
                             f"{plain['launches']}, path {kern['path']}")
    emit("train_identity", layers=layers, dtype="float32", batch=1, seq=S,
         steps=steps, max_rel_loss_diff=rel, kernel=kern, composite=plain)


def train_phase(torch, flash, fa, port):
    """The main path: Llama-3-8B at full width cut to 4 layers, bf16
    parameters, AdamW with fp32 master weights under a cosine schedule, B=2
    and S=4096 on the synthetic corpus; 2 warm-up steps, then 8 timed."""
    layers, warm, timed = 4, 2, 8
    B, S = TRAIN_B, TRAIN_S
    cfg = port.LlamaConfig.llama3_8b(num_hidden_layers=layers)
    gen = torch.Generator(device="cuda").manual_seed(4)
    t0 = time.perf_counter()
    model = port.LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                                  generator=gen)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    criterion = port.LlamaPretrainingCriterion(cfg)
    sched = port.CosineAnnealingDecay(1e-4, T_max=10)
    opt = port.AdamW(learning_rate=sched, parameters=model.parameters(),
                     weight_decay=0.01, multi_precision=True)
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(corpus(rng, B, S)).cuda()
               for _ in range(warm + timed)]
    reset_flash_counts(flash)
    step_loss = lm_loss(model, criterion)
    losses = train_steps(step_loss, opt, batches[:warm], sched)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses += train_steps(step_loss, opt, batches[warm:], sched)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_counts(flash)
    losses = [float(x) for x in losses]
    due = {k: (warm + timed) * layers for k in FLASH_MARKS}
    if launches != due or fa.last_path != "cuda":
        raise AssertionError(f"train: kernel launches {launches}, due {due} "
                             f"(path {fa.last_path})")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"train: losses {losses} are not finite or do "
                             f"not fall")
    n_params = sum(p.numel() for p in model.parameters())
    # PaLM's count, as bench.py's train_flops_per_token: 6N + 12·L·S·hidden
    attn_flops = 12.0 * layers * S * cfg.hidden_size
    flops_per_token = 6.0 * n_params + attn_flops
    # N holds the input embedding, a lookup with no product (27% of N at 4
    # layers): the count without it says how much that flatters the MFU
    lookup = (model.llama.embed_tokens.weight.numel()
              if model.lm_head is not None else 0)
    tokens_per_s = B * S * timed / wall
    emit("train", model="llama3_8b", layers=layers, dtype="bfloat16",
         batch=B, seq=S, warmup_steps=warm, timed_steps=timed,
         losses=losses, ms_per_step=wall / timed * 1e3,
         tokens_per_s=tokens_per_s, params=n_params,
         flops_per_token=flops_per_token,
         mfu=flops_per_token * tokens_per_s / PEAK_FLOPS["bfloat16"],
         embedding_params=lookup,
         mfu_without_embedding=(6.0 * (n_params - lookup) + attn_flops)
         * tokens_per_s / PEAK_FLOPS["bfloat16"],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         kernel_launches=launches, model_build_s=build_s)
    return launches, (model, criterion, opt, sched)


def profile_window(torch, run, steps):
    """``run()`` ``steps`` times unprofiled (the window's wall time), then
    ``steps`` times under torch.profiler: (device us by kernel, the
    window's wall us, nvidia-smi before and after the profiled calls)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        run()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    before = gpu_sample()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
    return device_kernels(prof), wall_us, (before, gpu_sample())


def window_summary(kernels, wall_us):
    """A profile window's idle share, matrix-product share and top
    kernels."""
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {"window_wall_us": wall_us, "device_busy_us": busy,
            "idle_share": (1 - busy / wall_us) if busy else None,
            "matmul_share": share(kernels, MATMUL_MARKS),
            "top_kernels": [{"name": k[:120], "us": us} for k, us in top]}


def train_profile_phase(torch, trainer, steps=2, label="train",
                        shape=(TRAIN_B, TRAIN_S), seed=9):
    """torch.profiler over 2 train steps: the device-time share of each
    flash kernel and its device time a launch, the matrix products' share,
    the top kernels, and the idle share against the wall time of 2
    unprofiled steps.  ``label`` names the phase's lines (``train`` for
    Llama, ``gpt_train`` for GPT)."""
    model, criterion, opt, sched = trainer
    rng = np.random.default_rng(seed)
    batches = iter([torch.from_numpy(corpus(rng, *shape)).cuda()
                    for _ in range(2 * steps)])
    kernels, wall_us, (before, after) = profile_window(
        torch, lambda: train_steps(lm_loss(model, criterion), opt,
                                   [next(batches)], sched), steps)
    emit(f"{label}_clocks", before=before, after=after,
         note="nvidia-smi before and after the profiled window")
    busy = sum(kernels.values())
    flash_shares = {key: share(kernels, marks)
                    for key, marks in FLASH_MARKS.items()}
    # each flash kernel launches once a layer a step
    launches = steps * model.config.num_hidden_layers
    flash_device_ms = {key: busy * s / launches / 1e3 if s else None
                       for key, s in flash_shares.items()}
    emit(f"{label}_profile", steps=steps, flash_shares=flash_shares,
         flash_device_ms=flash_device_ms,
         flash_share=sum(v or 0.0 for v in flash_shares.values()),
         **window_summary(kernels, wall_us))
    return flash_device_ms


# --- custom-op phase ----------------------------------------------------------

# tests/test_custom_op.py's host ops, built by cpp_extension.load
RELU6_SOURCE = """
#include <cstdint>
extern "C" void my_relu6(const float* x, float* y, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        float v = x[i] < 0.f ? 0.f : x[i];
        y[i] = v > 6.f ? 6.f : v;
    }
}
extern "C" void my_relu6_grad(const float* x, const float* gy, float* gx,
                              int64_t n) {
    for (int64_t i = 0; i < n; ++i)
        gx[i] = (x[i] > 0.f && x[i] < 6.f) ? gy[i] : 0.f;
}
"""
# a Llama-3-8B activation at the train phase's B=2, S=4096: [B*S, hidden]
SCALED_SHAPE = (TRAIN_B * TRAIN_S, 4096)


def scaled_sweep(torch, sc):
    """The kernel against its twin, bit for bit (torch.equal), over fp32,
    bf16 and fp16, alpha in {2, 3, 0.1, -3.5}, 1 to 1,000,003 elements,
    each aligned and as a view at storage offset 3 (not 16-byte aligned:
    the scalar path); then one planted fault, the twin with its last
    element changed, which the same check must refuse."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    checks, worst = 0, 0.0

    def same(out, ref):
        return out.shape == ref.shape and out.dtype == ref.dtype and \
            torch.equal(out, ref)

    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for alpha in (2.0, 3.0, 0.1, -3.5):
            for n in (1, 7, 4097, 1_000_003):
                base = torch.randn(n + 3, device=dev, generator=gen).to(dtype)
                for label, x in (("aligned", base[:n]), ("offset 3", base[3:])):
                    if (label == "offset 3") != bool(x.data_ptr() % 16):
                        raise AssertionError(f"custom_op: the {label} view "
                                             f"has the wrong alignment")
                    out = sc.scaled_kernel(x, alpha)
                    torch.cuda.synchronize()
                    ref = sc.scaled_reference(x, alpha)
                    worst = max(worst, float((out.float() - ref.float())
                                             .abs().max()))
                    if not same(out, ref):
                        raise AssertionError(
                            f"scaled kernel differs from its twin: {dtype}, "
                            f"alpha={alpha}, n={n}, {label}")
                    checks += 1
    x = torch.randn(4097, device=dev, generator=gen).bfloat16()
    out = sc.scaled_kernel(x, 0.1)
    planted = sc.scaled_reference(x, 0.1)
    planted[-1] = planted[-1] * 2 + 1
    if same(out, planted):
        raise AssertionError("custom_op: the planted fault passed the check")
    return checks, worst


def spread(values):
    """Median, 10th and 90th percentiles and extremes of ``values``."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    return {"n": int(v.size), "median": float(np.median(v)),
            "p10": float(np.percentile(v, 10)),
            "p90": float(np.percentile(v, 90)),
            "min": float(v[0]), "max": float(v[-1])}


def interleaved_times(torch, fns, rounds, calls):
    """The functions of ``fns`` ({name: (fn, kernel mark)}) timed in turns
    on one card, the order reversed every round (A B, B A, ...).  By CUDA
    events: ``calls`` back-to-back calls of each a turn, ms a call.  By the
    profiler, in a second pass of the same turns: each launch's device time
    in the kernels whose names hold the function's mark.  Returns each
    name's :func:`spread` by both clocks; raises when the profiler records
    no launch of one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = list(fns)
    for name in names:
        fns[name][0]()
    torch.cuda.synchronize()
    events = {name: [] for name in names}
    for r in range(rounds):
        for name in names if r % 2 == 0 else names[::-1]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fns[name][0]()
            end.record()
            end.synchronize()
            events[name].append(start.elapsed_time(end) / calls)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for r in range(rounds):
            for name in names if r % 2 == 0 else names[::-1]:
                for _ in range(calls):
                    fns[name][0]()
        torch.cuda.synchronize()
    device = {name: [] for name in names}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        for name in names:
            if fns[name][1] in e.name:
                device[name].append(e.time_range.elapsed_us() / 1e3)
    if not all(device.values()):
        raise AssertionError(f"interleaved timing: the profiler recorded "
                             f"{ {n: len(v) for n, v in device.items()} } "
                             f"launches")
    return {name: {"event_ms": spread(events[name]),
                   "device_ms": spread(device[name])} for name in names}


def custom_op_phase(torch, sc, cpp_extension, build_dir):
    """The custom-op path: the sweep, then the JAX docstring example as a
    user imports it, ``ops/scaled.py::my_scaled`` (``register_custom_op(
    scaled, name="my_scaled", vjp=(scaled_fwd, scaled_bwd),
    nondiff_argnames=("alpha",))``), called on a [8192, 4096] bf16 tensor on
    the card three times with its backward (launches counted from 0 over
    those calls), one call under torch.profiler, times at that shape (CUDA
    events and profiler device time, for the kernel and for torch.mul),
    and a g++ host op on a CUDA tensor."""
    import os

    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    checks, sweep_err = scaled_sweep(torch, sc)

    gen = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn(SCALED_SHAPE, device=dev, generator=gen) \
        .bfloat16().requires_grad_()
    calls = 3
    sc.launches = 0
    for _ in range(calls):
        y = sc.my_scaled(x, alpha=3.0)
        y.sum().backward()
    torch.cuda.synchronize()
    launches = sc.launches
    if launches != calls or sc.last_path != "cuda":
        raise AssertionError(f"custom_op: {launches} launches for {calls} "
                             f"calls (path {sc.last_path})")
    # the gradient of 3 calls, accumulated: 9 everywhere (exact in bf16),
    # which only 3 runs of the custom bwd (g * 3 each) give
    if not (torch.equal(x.grad, torch.full_like(x, 9.0))
            and torch.equal(y, sc.scaled_reference(x.detach(), 3.0))):
        raise AssertionError("custom_op: wrong output or gradient")
    x = x.detach()
    del y

    # a profile that recorded no scale kernel is taken again, twice at
    # most, as in device_times
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sc.my_scaled(x, alpha=3.0)
            torch.cuda.synchronize()
        kernel_names = [k for k in device_kernels(prof)
                        if "scaled_kernel" in k]
        if kernel_names:
            break

    def subtree(e):
        return [e] + [d for c in e.cpu_children for d in subtree(c)]

    # kernels launched inside the my_scaled range: those the profiler
    # attached to it or to an op under it, and the device events whose
    # correlation id is that of a runtime call under it (cudaLaunchKernel)
    from torch.autograd import DeviceType

    inside = [d for e in prof.events() if e.name == "my_scaled"
              for d in subtree(e)]
    ids = {d.id for d in inside}
    under = [k.name for d in inside for k in d.kernels] + [
        e.name for e in prof.events()
        if e.device_type == DeviceType.CUDA and e.id in ids]
    if not kernel_names or not set(kernel_names) & set(under):
        raise AssertionError(f"custom_op: the profile shows kernels "
                             f"{kernel_names}, and under my_scaled {under}")

    alpha = 3.0   # exact in bf16, so torch.mul computes the same function
    library = torch.mul(x, alpha)
    if not torch.equal(library, sc.scaled_kernel(x, alpha)):
        raise AssertionError("custom_op: torch.mul computes another function")
    del library
    nbytes = 2 * x.numel() * x.element_size()
    # one fp32 multiply an element, on the CUDA cores
    t_flops = x.numel() / PEAK_FLOPS["float32"] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    timing = {
        "shape": list(SCALED_SHAPE), "dtype": "bfloat16", "alpha": alpha,
        "max_abs_err": sweep_err,
        # CUDA events of back-to-back calls (the host's issue included)
        "ms": time_ms(lambda: sc.scaled_kernel(x, alpha), 50),
        "op_ms": time_ms(lambda: sc.my_scaled(x, alpha=alpha), 50),
        "plain_ms": time_ms(lambda: sc.scaled_reference(x, alpha), 20),
        "library_ms": time_ms(lambda: torch.mul(x, alpha), 50),
        # profiler device time a launch, the same for both
        "device_ms": device_ms(lambda: sc.scaled_kernel(x, alpha), 20,
                               ("scaled_kernel",)),
        "library_device_ms": device_ms(lambda: torch.mul(x, alpha), 20,
                                       ("elementwise_kernel",)),
        "bound_ms": max(t_flops, t_bytes),
        "bound_by": "operations" if t_flops > t_bytes else "bytes",
        "flops": float(x.numel()), "bytes": nbytes,
        # the kernel and torch.mul in turns, each call by both clocks
        "interleaved": interleaved_times(torch, {
            "kernel": (lambda: sc.scaled_kernel(x, alpha), "scaled_kernel"),
            "torch_mul": (lambda: torch.mul(x, alpha), "elementwise_kernel"),
        }, rounds=40, calls=5),
    }

    os.makedirs(build_dir, exist_ok=True)
    src = os.path.join(build_dir, "my_relu6.cc")
    with open(src, "w") as f:
        f.write(RELU6_SOURCE)
    ext = cpp_extension.load(name="my_relu6", sources=[src],
                             build_directory=build_dir)
    xh = torch.randn(4096, generator=torch.Generator().manual_seed(13)) * 5
    xd = xh.to(dev).requires_grad_()
    yd = ext.my_relu6(xd)
    yd.sum().backward()
    host_ok = (yd.device.type == "cuda" and xd.grad.device.type == "cuda"
               and torch.equal(yd.cpu(), ext.my_relu6(xh))
               and torch.equal(xd.grad.cpu(), ((xh > 0) & (xh < 6)).float()))
    if not host_ok:
        raise AssertionError("custom_op: the host op on a CUDA tensor gave "
                             "another result than on the CPU")
    emit("custom_op", name="scaled", sweep_checks=checks,
         sweep_bit_exact=True, planted_fault_caught=True, calls=calls,
         kernel_launches=launches, grad=9.0,
         profile_kernels=kernel_names, under_my_scaled=sorted(set(under)),
         host_op={"device": "cuda", "equal_to_cpu": True, "grad_ok": True},
         timing=timing)
    return launches, timing


# --- speculative decoding, disaggregation and the server ------------------------

SPEC_SAMPLED = dict(temperature=0.8, top_p=0.95)


def echo_prompts(torch, serving, model, rng, n, lo, hi, new_tokens, dtype):
    """Prompts ``R + S + O + S`` of ``lo``-``hi`` tokens: ``R`` and ``S``
    (16-64 tokens) seeded random texts, ``O`` the greedy continuation of
    ``R + S`` by :func:`spec_model` (``new_tokens`` long, one unified
    engine run).  After the second ``S`` the n-gram proposer finds ``O``
    inside its 256-token window and drafts it again."""
    vocab = model.config.vocab_size
    heads = []
    for _ in range(n):
        s = rng.integers(0, vocab, int(rng.integers(16, 65))).tolist()
        total = int(rng.integers(lo, hi + 1))
        r = rng.integers(0, vocab, max(0, total - 2 * len(s)
                                       - new_tokens)).tolist()
        heads.append((r, s))
    need = sum(-(-(len(r) + len(s) + new_tokens) // 16)
               for r, s in heads) + 1
    eng = spec_engine(serving, model, need + 16, dtype, False, 512, n)
    reqs = [eng.add_request(r + s, serving.SamplingParams(
        max_new_tokens=new_tokens)) for r, s in heads]
    with spec_model(model, False):
        eng.run(max_steps=20000)
    torch.cuda.synchronize()
    del eng
    return [r + s + list(q.output_tokens) + s
            for (r, s), q in zip(heads, reqs)]


def spec_sampling(serving, n, new_tokens, sampled):
    return [serving.SamplingParams(max_new_tokens=new_tokens,
                                   **(dict(SPEC_SAMPLED, seed=200 + i)
                                      if sampled else {}))
            for i in range(n)]


def pool_invariant(label, eng):
    """free + reuse + held + the null page == num_blocks, now."""
    kv = eng.kv
    if len(kv._free) + len(kv._reuse) + len(kv._ref) + 1 != kv.num_blocks:
        raise AssertionError(f"{label}: the pool invariant is broken")


def launch_rule(label, rp, pd, engines, ragged_route, decode_route):
    """The kernels' launches since the counters were reset, against the
    steps of ``engines`` (one engine, or the replicas of one fleet, each
    stepping on its own thread): the ragged kernel once per layer per
    unified step, the decode kernel once per layer per decode step and
    burst iteration, each all on its route.  The eager families (prefill,
    chunked prefill, the hand-off's gather and scatter) launch neither.
    Returns the counts for the phase's line."""
    got = {"ragged": {"all": rp.launches, "simple": rp.simple_launches,
                      "tma": rp.tma_launches},
           "decode": {"all": pd.launches, "simple": pd.simple_launches,
                      "mma": pd.mma_launches}}
    due = {"ragged": sum(e.ragged_launches
                         * e.model.config.num_hidden_layers
                         for e in engines),
           "decode": sum(legacy_counts(e)["decode_launches_due"]
                         for e in engines)}
    for kernel, route in (("ragged", ragged_route),
                          ("decode", decode_route)):
        if got[kernel]["all"] != due[kernel] or \
                got[kernel][route] != due[kernel]:
            raise AssertionError(
                f"{label}: {got[kernel]} {kernel} launches for "
                f"{due[kernel]} due (on {route})")
    return {"launches": got, "launches_due": due}


def spec_engine(serving, model, num_blocks, dtype, spec, budget, seqs,
                prefix_cache=True):
    return serving.EngineCore(model, config=serving.EngineConfig(
        num_blocks=num_blocks, block_size=16, dtype=dtype, unified_step=True,
        prefix_cache=prefix_cache,
        spec=serving.SpecConfig(k=4) if spec else None,
        scheduler=serving.SchedulerConfig(max_num_seqs=seqs,
                                          max_tokens_per_step=budget)))


# The spec runs' model: a random-weight model neither continues a pattern
# nor repeats its own continuation once its context changes, so no draft
# would ever be accepted.  Scaling the token embedding makes the residual
# stream follow the current token (the layers' outputs become small beside
# it), so the next token is mostly a function of the current one: the
# model is a first-order chain, and after an echo of its own earlier text
# it writes the same continuation again (R + S + O + S below).  bf16
# needs the larger scale: its coarse residual otherwise keeps enough of
# attention's context to flip near-ties.  Sampled runs also scale the LM
# head, so draws at temperature 0.8 are peaked as a trained model's are,
# not near uniform over 128k tokens.  Powers of two: undone exactly.
CHAIN = {"float32": 4096.0, "bfloat16": 65536.0}
SHARPEN = 8.0


def chain_scale(model):
    return CHAIN[str(model.lm_head.weight.dtype).split(".")[-1]]


@contextlib.contextmanager
def spec_model(model, sampled):
    weights = [(model.llama.embed_tokens.weight, chain_scale(model))]
    if sampled:
        weights.append((model.lm_head.weight, SHARPEN))
    for w, s in weights:
        w.data.mul_(s)
    try:
        yield
    finally:
        for w, s in weights:
            w.data.div_(s)


def spec_pass(torch, serving, eng, prompts, new_tokens, sampled, tag):
    """One timed pass of ``prompts`` through ``eng``: its tokens and its
    own numbers (counter and histogram changes over the pass; TTFT and
    ITL also from its request timelines)."""
    m = eng.metrics
    hists = {n: m.histogram(n)
             for n in ("time_to_first_token", "inter_token_latency")}
    seen = {n: (h.count, h.sum) for n, h in hists.items()}
    before = (m.counters["engine_steps"], eng.graphs.captures,
              eng.graphs.capture_seconds,
              eng.spec.drafted_total if eng.spec else 0,
              eng.spec.accepted_total if eng.spec else 0)
    reqs = [eng.add_request(p, sp, request_id=f"{tag}{i}")
            for i, (p, sp) in enumerate(zip(prompts, spec_sampling(
                serving, len(prompts), new_tokens, sampled)))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(max_steps=20000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = [list(r.output_tokens) for r in reqs]
    if any(len(t) != new_tokens or not all(
            0 <= x < eng.model.config.vocab_size for x in t)
           for t in tokens):
        raise AssertionError("spec: malformed token streams")
    after = (m.counters["engine_steps"], eng.graphs.captures,
             eng.graphs.capture_seconds,
             eng.spec.drafted_total if eng.spec else 0,
             eng.spec.accepted_total if eng.spec else 0)
    d = [b - a for a, b in zip(before, after)]
    row = {"steps": d[0], "seconds": wall,
           "output_tokens_per_s": len(prompts) * new_tokens / wall,
           **{f"mean_{k}_s": (h.sum - seen[n][1]) / (h.count - seen[n][0])
              for k, n, h in (("ttft", "time_to_first_token",
                               hists["time_to_first_token"]),
                              ("itl", "inter_token_latency",
                               hists["inter_token_latency"]))},
           **{"timeline_" + k: v for k, v in timeline_means(
               eng.lifecycle, [r.request_id for r in reqs],
               new_tokens).items()},
           "captures": d[1], "capture_s": d[2]}
    if eng.spec is not None:
        row.update(drafted=d[3], accepted=d[4],
                   accept_ratio=d[4] / d[3] if d[3] else 0.0)
    return tokens, row


def spec_run(torch, rp, pd, serving, model, prompts, new_tokens, sampled,
             spec, dtype, budget, seqs, chain=True, warm=False):
    """``prompts`` through a fresh unified engine (on :func:`spec_model`
    unless ``chain`` is False): one pass, or with ``warm`` a cold pass
    (the captures inside it) and a warm one on the same prompts, the
    prefix cache off so both do the same work.  Returns the engine, the
    tokens and the numbers (the warm pass's, the cold one's under
    ``cold``), with the engine's launch, capture and pool checks."""
    need = sum(-(-(len(p) + new_tokens + 8) // 16) for p in prompts) + 1
    eng = spec_engine(serving, model, need + 16, dtype, spec, budget, seqs,
                      prefix_cache=not warm)
    reset_launches(rp, pd)
    with spec_model(model, sampled) if chain else contextlib.nullcontext():
        tokens, row = spec_pass(torch, serving, eng, prompts, new_tokens,
                                sampled, "cold")
        if warm:
            again, warm_row = spec_pass(torch, serving, eng, prompts,
                                        new_tokens, sampled, "warm")
            if again != tokens:
                raise AssertionError("spec: the warm pass emitted other "
                                     "tokens than the cold one")
            row = dict(warm_row, cold=row)
    if eng.kv.occupancy() != 0.0:
        raise AssertionError("spec: the pool is not empty at the end")
    pool_invariant("spec", eng)
    check_traces("spec", eng, ("ragged",))
    if eng.graphs.captures != len(eng.graphs.programs):
        raise AssertionError("spec: a key was captured twice")
    row.update(keys=sorted(eng.graphs.programs, key=str),
               preemptions=eng.metrics.counters["preemptions"],
               launches=rp.launches)
    return eng, tokens, row


def spec_key_gate(label, serving, off, on, prompts, new_tokens, seqs, k,
                  budget):
    """Spec on's captures against spec off's (one capture per key is
    checked by :func:`spec_run`): the warm pass captures nothing; every
    key ``(ragged, Tb, TWb, sampled)`` is a point of the plain plan's
    lattice (Tb and TWb powers of two, Tb at most the step's token
    budget, TWb at most the bucket of the longest sequence's pages with
    ``k`` drafted slots); and the keys spec off lacks are at most what
    verify rows can add: a decode-only step of ``seqs`` rows holds up to
    ``seqs`` tokens spec off and ``seqs * (k + 1)`` spec on, so the Tb
    buckets between the two, at each table bucket spec on uses.  Returns
    the keys spec off lacks."""
    b = serving.bucket_size
    widest = b(-(-(max(map(len, prompts)) + new_tokens + k) // 16))
    for key in on["keys"]:
        _, tb, twb, _ = key
        if (key[0] != "ragged" or tb > budget or twb > widest
                or b(tb) != tb or b(twb) != twb):
            raise AssertionError(f"{label}: {key} is outside the unified "
                                 f"lattice (Tb <= {budget}, TWb <= "
                                 f"{widest})")
    if on["captures"]:
        raise AssertionError(f"{label}: the warm pass captured "
                             f"{on['captures']} keys")
    new_keys = sorted(set(map(tuple, on["keys"]))
                      - set(map(tuple, off["keys"])), key=str)
    verify_tbs = sum(1 for i in range(b(seqs).bit_length(),
                                      b(seqs * (k + 1)).bit_length()))
    bound = verify_tbs * len({key[2] for key in on["keys"]})
    if len(new_keys) > bound:
        raise AssertionError(f"{label}: {len(new_keys)} keys spec off "
                             f"lacks, more than the {bound} verify rows "
                             f"can add: {new_keys}")
    on["extra_keys_bound"] = bound
    return [list(key) for key in new_keys]


def top2_gap(torch, model, ids):
    """The gap between the two largest last-position logits of ``ids``
    (the model's no-cache forward, fp32 logits)."""
    with torch.no_grad():
        logits = model(torch.tensor([ids], device="cuda"))[0, -1].float()
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1]), int(logits.argmax())


def spec_identity_phase(torch, rp, pd, serving, model):
    """The identity model (Llama-3-8B widths, 2 layers, fp32, the simple
    route): spec on token-identical to spec off, greedy and seeded
    sampled, in strictly fewer steps (greedy), the ragged kernel launched
    once per layer per step through the replays."""
    rng = np.random.default_rng(11)
    prompts = echo_prompts(torch, serving, model, rng, 8, 100, 600, 32,
                           torch.float32)
    rows, toks = {}, {}
    for sampled in (False, True):
        for spec in (False, True):
            name = ("sampled" if sampled else "greedy") + \
                ("_spec" if spec else "")
            eng, toks[name], rows[name] = spec_run(
                torch, rp, pd, serving, model, prompts, 32, sampled,
                spec, torch.float32, 256, 8)
            launch_rule(f"spec_identity {name}", rp, pd, [eng], "simple",
                        "simple")
            rows[name].pop("keys")
            del eng
    for mode in ("greedy", "sampled"):
        if toks[mode] != toks[mode + "_spec"]:
            raise AssertionError(f"spec_identity: spec on and off emitted "
                                 f"different {mode} tokens (fp32)")
        if not rows[mode + "_spec"]["drafted"] > 0:
            raise AssertionError(f"spec_identity: nothing drafted ({mode})")
    if not rows["greedy_spec"]["accepted"] > 0:
        raise AssertionError("spec_identity: no greedy draft accepted")
    if not rows["greedy_spec"]["steps"] < rows["greedy"]["steps"]:
        raise AssertionError("spec_identity: spec on took no fewer steps")
    emit("spec_identity", layers=model.config.num_hidden_layers,
         dtype="float32", embedding_scale=chain_scale(model),
         sampled_head_scale=SHARPEN, prompts=len(prompts),
         prompt_lens=[len(p) for p in prompts], new_tokens_each=32,
         identical=True, **rows)
    gc.collect()
    torch.cuda.empty_cache()
    return prompts


def spec_phase(torch, rp, pd, serving, model):
    """Llama-3-8B, full depth, bf16, unified, 512 tokens a step, k=4: spec
    off and spec on over 16 R + S + O + S prompts of 256-2048 tokens, 128 new
    tokens each, greedy and seeded sampled."""
    layers = model.config.num_hidden_layers
    rng = np.random.default_rng(12)
    new_tokens = 128
    prompts = echo_prompts(torch, serving, model, rng, 16, 256, 2048,
                           new_tokens, torch.bfloat16)
    rows, toks, divergences = {}, {}, {}
    for sampled in (False, True):
        mode = "sampled" if sampled else "greedy"
        for spec in (False, True):
            name = mode + ("_spec" if spec else "")
            eng, toks[name], rows[name] = spec_run(
                torch, rp, pd, serving, model, prompts, new_tokens, sampled,
                spec, torch.bfloat16, 512, 16, warm=True)
            launch_rule(f"spec {name}", rp, pd, [eng], "tma", "mma")
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        off, on = rows[mode], rows[mode + "_spec"]
        # the step gate is the greedy run's; a sampled run's acceptance
        # depends on how peaked the draws are, and is reported
        if not sampled and not on["steps"] < off["steps"]:
            raise AssertionError(f"spec {mode}: spec on took {on['steps']} "
                                 f"steps, spec off {off['steps']}")
        on["keys_spec_off_lacks"] = spec_key_gate(
            f"spec {mode}", serving, off, on, prompts, new_tokens, seqs=16,
            k=4, budget=512)
        same = sum(a == b for ta, tb in zip(toks[mode], toks[mode + "_spec"])
                   for a, b in zip(ta, tb))
        gaps = []
        for p, ta, tb in zip(prompts, toks[mode], toks[mode + "_spec"]):
            j = next((i for i, (a, b) in enumerate(zip(ta, tb)) if a != b),
                     None)
            if j is not None:
                with spec_model(model, sampled):
                    gap, top = top2_gap(torch, model, p + ta[:j])
                gaps.append({"position": j, "top2_gap": gap,
                             "spec_off": ta[j], "spec_on": tb[j],
                             "forward_argmax": top})
        divergences[mode] = {"identical_tokens": same,
                             "tokens": len(prompts) * new_tokens,
                             "identical_share": same
                             / (len(prompts) * new_tokens),
                             "first_divergences": gaps}
        for r in (off, on):
            r["keys"] = [list(k) for k in r["keys"]]
    emit("spec", model="llama3_8b", layers=layers, dtype="bfloat16",
         embedding_scale=chain_scale(model), sampled_head_scale=SHARPEN,
         prompts=len(prompts), prompt_tokens=sum(map(len, prompts)),
         new_tokens_each=new_tokens, k=4, max_tokens_per_step=512,
         bf16=divergences, **rows,
         note="top2_gap: spec off's two largest logits at the first "
              "divergence, from a no-cache forward of prompt + spec off's "
              "tokens before it")
    return prompts


def timeline_means(lc, rids, new_tokens):
    """Mean TTFT (submission to the first token) and mean ITL (first token
    to finish over the tokens after it) over the timelines of ``rids``, as
    a client sees them: a hand-off's gap counts in the ITL."""
    ttft, itl = [], []
    for rid in rids:
        ev = lc.get(rid).to_dict()["events"]
        first = next(e["t"] for e in ev if e["name"] == "first_token")
        end = next(e["t"] for e in reversed(ev) if e["name"] == "finish")
        ttft.append(first - ev[0]["t"])
        itl.append((end - first) / (new_tokens - 1))
    return {"mean_ttft_s": float(np.mean(ttft)),
            "mean_itl_s": float(np.mean(itl))}


def role_fleet(serving, model, num_blocks, dtype, seqs, budget):
    roles = ["prefill", "decode"]

    def make(i, registry):
        return serving.EngineCore(model, config=serving.EngineConfig(
            num_blocks=num_blocks, block_size=16, dtype=dtype,
            unified_step=True, role=roles[i],
            scheduler=serving.SchedulerConfig(max_num_seqs=seqs,
                                              max_tokens_per_step=budget)),
            registry=registry, metrics_labels={"replica": str(i)})

    return serving.FleetRouter.build(
        make, dp=2, config=serving.FleetConfig(roles=roles))


def disagg_run(torch, rp, pd, serving, model, prompts, new_tokens, dtype,
               seqs, budget, route):
    """``prompts`` through a prefill and a decode replica, the kernels'
    counters set to 0 just before.  Gates: one hand-off per request, each
    served on the decode replica from the imported pages (its admission
    found every handed-off block cached) by graphs it replayed, both pools'
    invariant, one capture per key, and the launch rule over both
    replicas on ``route``."""
    need = sum(-(-(len(p) + new_tokens + 8) // 16) for p in prompts) + 1
    fleet = role_fleet(serving, model, need + 16, dtype, seqs, budget)
    reset_launches(rp, pd)
    fleet.start()
    try:
        t0 = time.perf_counter()
        hs = [fleet.submit_request(p, serving.SamplingParams(
            max_new_tokens=new_tokens), request_id=f"d{i}")
            for i, p in enumerate(prompts)]
        fleet.wait(hs, timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tokens = [h.output_tokens for h in hs]
        snap = fleet.registry.snapshot()
        handoffs = snap["serving_handoff_total"]["value"]
        if handoffs != len(prompts) or any(h.replica.index != 1 for h in hs):
            raise AssertionError(f"disagg: {handoffs} hand-offs for "
                                 f"{len(prompts)} requests")
        if any(h.finish_reason != "length" for h in hs):
            raise AssertionError("disagg: a request did not finish")
        events = {h.rid: e for h in hs for e in
                  fleet.lifecycle.get(h.rid).to_dict()["events"]
                  if e["name"] == "kv_handoff"}
    finally:
        fleet.shutdown(drain_timeout=60.0)
    if any(r.thread.is_alive() for r in fleet.replicas):
        raise AssertionError("disagg: a replica outlived the shutdown")
    decode = fleet.replicas[1].engine
    attribution = decode.cachestat.attribution()
    cached = {row["id"]: row["cached_tokens"] for row in
              attribution["active"] + attribution["recent"]}
    # a failed import degrades to a re-prefill on the decode replica: its
    # admission would find fewer cached tokens than the run carried
    short = {rid: (cached.get(str(rid)), e["blocks"] * 16)
             for rid, e in events.items()
             if not e["blocks"] or cached.get(str(rid), 0) < e["blocks"] * 16}
    if len(events) != len(prompts) or short:
        raise AssertionError(f"disagg: {len(events)} hand-off events; "
                             f"imports not served from the pages "
                             f"(cached, carried): {short}")
    if not decode.graphs.replays:
        raise AssertionError("disagg: the decode replica replayed no graph")
    for r in fleet.replicas:
        pool_invariant(f"disagg replica {r.index}", r.engine)
        check_pool_rows(f"disagg replica {r.index}", r.engine)
        # one capture per key: a hand-off captured nothing under a key the
        # replica had already seen
        if r.engine.graphs.captures != len(r.engine.graphs.programs):
            raise AssertionError("disagg: a key was captured twice")
    row = {"seconds": wall,
           "output_tokens_per_s": len(prompts) * new_tokens / wall,
           "handoffs": handoffs,
           "blocks_each": [e["blocks"] for e in events.values()],
           "bytes_each": [e["bytes"] for e in events.values()],
           "handoff_ms_each": [e["duration_ms"] for e in events.values()],
           "decode_cached_tokens_each": [cached[str(rid)] for rid in events],
           "captures": {r.index: r.engine.graphs.captures
                        for r in fleet.replicas},
           "replays": {r.index: r.engine.graphs.replays
                       for r in fleet.replicas},
           **launch_rule("disagg", rp, pd,
                               [r.engine for r in fleet.replicas], route,
                               "simple"),
           **timeline_means(fleet.lifecycle, [h.rid for h in hs],
                            new_tokens)}
    return fleet, tokens, row


def disagg_identity_phase(torch, rp, pd, serving, model, prompts):
    """The identity model (fp32): the prefill/decode fleet gives one
    unified engine's tokens, one hand-off per request."""
    eng, unified_tokens, _ = spec_run(torch, rp, pd, serving, model, prompts,
                                      32, False, False, torch.float32, 256,
                                      8, chain=False)
    del eng
    fleet, tokens, row = disagg_run(torch, rp, pd, serving, model, prompts,
                                    32, torch.float32, 8, 256, "simple")
    if tokens != unified_tokens:
        raise AssertionError("disagg_identity: the prefill/decode fleet "
                             "emitted other tokens than one engine (fp32)")
    emit("disagg_identity", layers=model.config.num_hidden_layers,
         dtype="float32", prompts=len(prompts), identical=True, **row)
    del fleet
    gc.collect()
    torch.cuda.empty_cache()


def handoff_parts(torch, serving, model, prompt):
    """The parts of one hand-off of ``prompt``'s prefill, each timed alone
    (synchronised): gather on the donor, the device-to-host copy, the
    digest, the recipient's verification (digest again), the pool import
    and the scatter into the recipient's pools."""
    from paddle_tpu_torch.serving import handoff

    blocks = -(-(len(prompt) + 16) // 16) + 4
    donor, recipient = (spec_engine(serving, model, blocks, torch.bfloat16,
                                    False, 512, 1) for _ in range(2))
    req = donor.add_request(prompt, serving.SamplingParams(max_new_tokens=2))
    while not req.output_tokens:
        donor.step()
    kv = donor.kv
    hashes = [kv.block_chain_hash(b) for b in kv.table(req.request_id)]
    records = kv.export_blocks([h for h in hashes if h is not None])
    ms = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        return out

    pages = timed("gather", lambda: handoff.gather_pages(
        donor, [r["block"] for r in records]))
    payload = timed("device_to_host", lambda: handoff.pages_to_host(pages))
    run = dict(handoff.pool_meta(donor), blocks=records, payload=payload,
               tokens_total=len(records) * 16)
    run["digest"] = timed("digest", lambda: handoff.payload_digest(payload))
    meta = handoff.check_header(recipient, run)
    timed("verify", lambda: handoff.check_payload(run, meta))
    placed = timed("import", lambda: recipient.kv.import_blocks(records))
    timed("scatter", lambda: handoff.scatter_pages(
        recipient, [placed[r["hash"]] for r in records], payload))
    dst = [placed[r["hash"]] for r in records]
    for a, b in zip(donor._k_pools + donor._v_pools,
                    recipient._k_pools + recipient._v_pools):
        if not torch.equal(a[[r["block"] for r in records]], b[dst]):
            raise AssertionError("disagg: the scattered pages differ")
    return {"prompt_tokens": len(prompt), "blocks": len(records),
            "bytes": int(payload.nbytes), "ms": ms,
            "total_ms": sum(ms.values())}


def disagg_phase(torch, rp, pd, serving, model, prompts):
    """Llama-3-8B, full depth, bf16: a prefill and a decode replica on one
    card, both on the unified step, sharing one model module; the spec
    phase's prompts, greedy, no spec.  Against one unified engine (dp=1)
    on the same prompts: tokens, TTFT and ITL.  Then one 2048-token
    hand-off taken apart and timed."""
    eng, unified_tokens, unified = spec_run(
        torch, rp, pd, serving, model, prompts, 128, False, False,
        torch.bfloat16, 512, 16, chain=False)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    fleet, tokens, row = disagg_run(torch, rp, pd, serving, model, prompts,
                                    128, torch.bfloat16, 16, 512, "tma")
    same = sum(a == b for ta, tb in zip(tokens, unified_tokens)
               for a, b in zip(ta, tb))
    del fleet
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(13)
    parts = handoff_parts(torch, serving, model, rng.integers(
        0, model.config.vocab_size, 2048).tolist())
    emit("disagg", model="llama3_8b", layers=model.config.num_hidden_layers,
         dtype="bfloat16", prompts=len(prompts), new_tokens_each=128,
         identical_tokens=same, tokens=len(prompts) * 128, **row,
         dp1_unified={k: unified[k] for k in (
             "timeline_mean_ttft_s", "timeline_mean_itl_s",
             "output_tokens_per_s")},
         handoff_2048=parts,
         note="TTFT and ITL are means over the request timelines (ITL: "
              "first token to finish, the hand-off's gap included); "
              "handoff_ms_each spans export + detach + resubmit on the "
              "donor's thread, the import runs on the decode replica's")
    gc.collect()
    torch.cuda.empty_cache()


def http_call(port, method, path, body=None, stream=False):
    """One loopback request: (status, headers, body bytes) or, streamed,
    (status, headers, tokens, saw [DONE])."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        payload = None if body is None else json.dumps(
            dict(body, stream=True) if stream else body)
        conn.request(method, path, payload,
                     {"Content-Type": "application/json"} if payload else {})
        resp = conn.getresponse()
        headers = {k.lower(): v for k, v in resp.getheaders()}
        data = resp.read()
    finally:
        conn.close()
    if not stream:
        return resp.status, headers, data
    tokens, done = [], False
    for line in data.split(b"\n"):
        if line == b"data: [DONE]":
            done = True
        elif line.startswith(b"data: "):
            tokens += json.loads(line[6:])["choices"][0]["token_ids"]
    return resp.status, headers, tokens, done


class ServerThread:
    """A CompletionServer (over a fleet with the supervisor on, as the
    CLI runs it) on an asyncio loop in a thread of its own."""

    def __init__(self, serving, fleet):
        import asyncio
        import threading

        from paddle_tpu_torch.serving.server import (CompletionServer,
                                                     ServerConfig)

        self.asyncio = asyncio
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self.fleet = fleet
        self.supervisor = serving.FleetSupervisor(
            fleet, config=serving.SupervisorConfig(max_restarts=5))
        self.server = CompletionServer(fleet, ServerConfig(
            max_queue=fleet.cfg.max_queue, drain_timeout_s=300.0))
        self.call(self.server.start())
        self.supervisor.start()
        self.port = self.server.port

    def call(self, coro, timeout=600):
        return self.asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def close(self):
        try:
            if not self.server._draining:
                self.call(self.server.shutdown())
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(60)
            self.loop.close()
        if self.thread.is_alive() or any(r.thread.is_alive()
                                         for r in self.fleet.replicas):
            raise AssertionError("server: a thread outlived the shutdown")


def fleet_of(serving, model, dp, num_blocks, dtype, unified, burst):
    def make(i, registry):
        return serving.EngineCore(model, config=serving.EngineConfig(
            num_blocks=num_blocks, block_size=16, dtype=dtype,
            unified_step=unified, burst_steps=burst,
            scheduler=serving.SchedulerConfig(
                max_num_seqs=16,
                max_tokens_per_step=512 if unified else None)),
            registry=registry, metrics_labels={"replica": str(i)})

    return serving.FleetRouter.build(make, dp=dp,
                                     config=serving.FleetConfig(max_queue=64))


def server_identity_phase(torch, rp, pd, serving, model, prompts):
    """The identity model (fp32): completions through the server over a
    dp=1 unified fleet, plain and streamed, equal LLM.generate on the same
    engine config; the launch rule on the simple route."""
    need = sum(-(-(len(p) + 40) // 16) for p in prompts) + 1
    llm = serving.LLM(model, config=serving.EngineConfig(
        num_blocks=need + 16, block_size=16, dtype=torch.float32,
        unified_step=True, scheduler=serving.SchedulerConfig(
            max_num_seqs=16, max_tokens_per_step=512)))
    want = [o.token_ids for o in llm.generate(
        prompts, serving.SamplingParams(max_new_tokens=24))]
    del llm
    srv = ServerThread(serving, fleet_of(serving, model, 1, need + 16,
                                         torch.float32, True, 0))
    reset_launches(rp, pd)
    try:
        got = []
        for i, p in enumerate(prompts):
            body = {"prompt": p, "max_tokens": 24}
            if i % 2:
                status, _, toks, done = http_call(
                    srv.port, "POST", "/v1/completions", body, stream=True)
                if not done:
                    raise AssertionError("server_identity: SSE without "
                                         "[DONE]")
            else:
                status, _, data = http_call(srv.port, "POST",
                                            "/v1/completions", body)
                toks = json.loads(data)["choices"][0]["token_ids"]
            if status != 200:
                raise AssertionError(f"server_identity: status {status}")
            got.append(toks)
    finally:
        srv.close()
    if got != want:
        raise AssertionError("server_identity: the server's completions "
                             "differ from LLM.generate (fp32)")
    counts = launch_rule("server_identity", rp, pd,
                               [r.engine for r in srv.fleet.replicas],
                               "simple", "simple")
    emit("server_identity", layers=model.config.num_hidden_layers,
         dtype="float32", completions=len(prompts), identical=True,
         **counts)
    gc.collect()
    torch.cuda.empty_cache()


def server_round(srv, bodies, new_tokens, drain,
                 routes=("/readyz", "/metrics", "/v1/debug/compiles")):
    """``bodies`` (``(body, streamed)``) posted concurrently to ``srv``;
    with ``drain``, a drain begins once all are in flight (after reading
    ``routes``).  Returns the round's numbers, its request ids and what
    the routes answered."""
    from concurrent.futures import ThreadPoolExecutor

    seen = {}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(bodies)) as pool:
        futs = [pool.submit(http_call, srv.port, "POST", "/v1/completions",
                            b, stream=s) for b, s in bodies]
        if drain:
            deadline = time.monotonic() + 120
            while (len(srv.server._handles) < len(bodies)
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            seen["in_flight_at_drain"] = len(srv.server._handles)
            for route in routes:
                seen[route] = http_call(srv.port, "GET", route)
            stop = srv.asyncio.run_coroutine_threadsafe(
                srv.server.shutdown(), srv.loop)
        results = [f.result(timeout=600) for f in futs]
        if drain:
            stop.result(timeout=600)
    wall = time.perf_counter() - t0
    rids, out_tokens = [], 0
    for (body, s), res in zip(bodies, results):
        if res[0] != 200:
            raise AssertionError(f"server: status {res[0]}")
        if s:
            toks, done = res[2], res[3]
            if not done:
                raise AssertionError("server: SSE without [DONE]")
        else:
            toks = json.loads(res[2])["choices"][0]["token_ids"]
        if len(toks) != new_tokens:
            raise AssertionError(f"server: a completion was cut "
                                 f"({len(toks)} tokens)")
        rids.append(res[1]["x-request-id"])
        out_tokens += len(toks)
    return {"seconds": wall, "output_tokens_per_s": out_tokens / wall,
            **timeline_means(srv.fleet.lifecycle, rids, new_tokens)}, \
        rids, seen


def server_bodies(rng, prompts, vocab, new_tokens):
    """One round of 24 completions: 8 streamed and 8 plain over fresh
    prompts of ``prompts``' lengths, and 8 sharing a 256-token prefix."""
    batch = same_lengths(rng, prompts, vocab)
    prefix = rng.integers(0, vocab, 256).tolist()
    shared = [prefix + rng.integers(0, vocab, int(rng.integers(
        16, 257))).tolist() for _ in range(8)]
    return [({"prompt": p, "max_tokens": new_tokens}, i % 2 == 0)
            for i, p in enumerate(batch)] + [
        ({"prompt": p, "max_tokens": new_tokens}, False) for p in shared]


def server_phase(torch, rp, pd, serving, model, prompts, serve_warm):
    """Llama-3-8B, full depth, bf16: the CompletionServer on loopback over
    a dp=1 unified fleet and over a dp=2 legacy fleet with bursts of 8
    (the two replicas share the one model module), the supervisor on.
    Two rounds of 24 concurrent completions: 8 streamed and 8 plain over
    the serve phase's prompt lengths, and 8 sharing a 256-token prefix;
    the first round takes the captures, the second (fresh prompts of the
    same lengths) is measured, and a drain begins while all its
    completions are in flight and must finish every one."""
    vocab = model.config.vocab_size
    rng = np.random.default_rng(14)
    new_tokens = 64
    rounds = [server_bodies(rng, prompts, vocab, new_tokens)
              for _ in range(2)]
    need = max(sum(-(-(len(b["prompt"]) + new_tokens) // 16)
                   for b, _ in bodies) for bodies in rounds) + 1
    rows = {}
    for name, dp, unified, burst in (("dp1_unified", 1, True, 0),
                                     ("dp2_legacy_burst8", 2, False, 8)):
        fleet = fleet_of(serving, model, dp, need + 16, torch.bfloat16,
                         unified, burst)
        srv = ServerThread(serving, fleet)
        reset_launches(rp, pd)
        try:
            cold, _, _ = server_round(srv, rounds[0], new_tokens, False)
            row, rids, seen = server_round(srv, rounds[1], new_tokens, True)
            lc = fleet.lifecycle
            replicas = [lc.get(r).summary()["replica"] for r in rids]
            if len(set(replicas[16:])) != 1:
                raise AssertionError(f"server {name}: the prefix-sharing "
                                     f"requests split over {replicas[16:]}")
            tl = lc.get(rids[0]).to_dict()
            if not tl["events"] or tl["summary"]["generated_tokens"] \
                    != new_tokens:
                raise AssertionError(f"server {name}: no timeline")
            status, _, ready = seen["/readyz"]
            page = seen["/metrics"][2]
            want = [b"serving_fleet_replicas", b"serving_fleet_in_flight",
                    b'serving_fleet_replica_alive{replica="0"}',
                    b"serving_handoff_total", b"serving_handoff_seconds",
                    b'serving_engine_steps_total{replica="0"}',
                    b"serving_replica_restarts_total"]
            missing = [w.decode() for w in want if w not in page]
            captures = json.loads(seen["/v1/debug/compiles"][2])["data"]
            if status != 200 or missing or not captures:
                raise AssertionError(f"server {name}: /readyz {status}, "
                                     f"/metrics missing {missing}, "
                                     f"{len(captures)} captures listed")
            # each replica captured its own graphs from its own engine
            # thread (at its own moments) and both completed
            by_replica = {str(r.index): r.engine.graphs.captures
                          for r in fleet.replicas}
            if not all(by_replica.values()):
                raise AssertionError(f"server {name}: a replica captured "
                                     f"nothing: {by_replica}")
            rows[name] = dict(
                row, cold=cold, captures_by_replica=by_replica,
                in_flight_at_drain=seen["in_flight_at_drain"],
                readyz=ready.decode().strip(),
                prefix_replica=replicas[16], captures_listed=len(captures),
                replica_of_each=replicas)
        finally:
            srv.close()
        # both rounds: the ragged kernel (tma) on the unified replica, the
        # decode kernel (mma) per decode step and burst iteration on the
        # legacy ones (a supervisor restart would have replaced an engine
        # and its step counts with it, and fails the rule)
        rows[name].update(launch_rule(
            f"server {name}", rp, pd, [r.engine for r in fleet.replicas],
            "tma", "mma"))
        del fleet, srv
        gc.collect()
        torch.cuda.empty_cache()
    emit("server", model="llama3_8b", layers=model.config.num_hidden_layers,
         dtype="bfloat16", completions=len(rounds[1]), streamed=8,
         new_tokens_each=new_tokens, **rows,
         serve_warm_in_process={k: serve_warm[k] for k in (
             "output_tokens_per_s", "mean_ttft_s", "mean_itl_s")},
         note="the measured round's numbers (the first round, 'cold', "
              "takes the captures); TTFT and ITL are means over the "
              "server's request timelines; every completion was in flight "
              "when the drain began and finished with all its tokens")
    return rows


# --- the cross-process fleet --------------------------------------------------

def process_fleet(serving, model, dp, num_blocks, unified, burst=0,
                  roles=None, compile_cache=None, flight_dir=None, seqs=16,
                  budget=512, aot_path=None):
    """A ``ProcessFleet`` of ``dp`` worker processes (``python -m
    paddle_tpu_torch.serving.worker``), each building the model ``model``
    names (``preset``, ``layers``, ``dtype``, ``seed``; the card unless
    ``device`` says otherwise) on the serve phases' engine shape, with the
    default heartbeats (every 0.25 s, dead after 2 s of silence); with
    ``aot_path``, each boots off that artifact and warms it
    (``--aot-path --warm``)."""
    return serving.ProcessFleet(serving.ProcessFleetConfig(
        dp=dp, num_blocks=num_blocks, block_size=16, max_num_seqs=seqs,
        max_prefill_tokens_per_step=None,
        max_tokens_per_step=budget if unified else None,
        unified=unified, burst_steps=burst, roles=roles,
        compile_cache=compile_cache, aot_path=aot_path,
        warm_boot=aot_path is not None, **model,
        fleet=serving.FleetConfig(max_queue=64, flight_dir=flight_dir,
                                  roles=roles)))


def child_gone(pid) -> bool:
    """True once the worker process ``pid`` has exited and been reaped."""
    try:
        done, _ = os.waitpid(pid, os.WNOHANG)
    except ChildProcessError:
        return True
    return done == pid


def stop_process_fleet(label, pf, pids=()):
    """Stop ``pf``; no worker process (the live ones and ``pids``) and no
    replica or heartbeat thread may outlive it."""
    proxies = list(pf.shared.active.values())
    pids = {p.pid for p in proxies if p.pid} | set(pids)
    pf.stop()
    for p in proxies:
        if p._hb_thread is not None:
            p._hb_thread.join(10)
    deadline = time.monotonic() + 30
    while not all(child_gone(pid) for pid in pids) \
            and time.monotonic() < deadline:
        time.sleep(0.05)
    if not all(child_gone(pid) for pid in pids) or any(
            r.thread is not None and r.thread.is_alive()
            for r in pf.router.replicas) or any(
            p._hb_thread is not None and p._hb_thread.is_alive()
            for p in proxies):
        raise AssertionError(f"{label}: a worker process or thread "
                             "outlived the fleet's stop")


def series_sum(registry, name):
    return sum(m.value for m in registry.series() if m.name == name)


def boot_rows(pf):
    """Each worker's boot: its own boot seconds (engine build and kernel
    load), launch to ready line on the parent's clock, and its
    ``PADDLE_TPU_COMPILE_CACHE`` counts."""
    return {str(i): {"pid": p.pid, "boot_s": p.worker.boot_s,
                     "ready_s": p.worker.ready_s,
                     "compile_cache": p.worker.compile_cache}
            for i, p in sorted(pf.shared.active.items())}


def warm_seconds(pf):
    """Each worker's warm seconds and the capturing part of them (the
    rest is the captures' eager first runs), from the line its ``--warm``
    printed before the ready line."""
    out = {}
    for i, p in sorted(pf.shared.active.items()):
        for line in p.worker.log_tail:
            m = re.search(r"warmed .* in ([0-9.]+)s, of which ([0-9.]+)s "
                          "capturing", line)
            if m:
                out[str(i)] = {"warm_s": float(m.group(1)),
                               "capturing_s": float(m.group(2))}
    return out


def worker_launch_rule(label, pf, ragged_route, decode_route):
    """The launch rule per worker process, read over the wire
    (``describe``): each worker's kernel launches since its ready line equal
    those its engine's steps call for (the ragged kernel once per layer
    per unified step, the decode kernel once per layer per decode step
    and burst iteration), each all on its route; a kernel whose route is
    ``None`` launched nothing."""
    rows = {}
    for r in pf.router.replicas:
        desc = pf.proxy(r.index).debug_fetch("describe")
        if desc is None:
            raise AssertionError(f"{label}: worker {r.index} did not "
                                 "answer describe")
        got = desc["launches"]
        for kernel, route in (("ragged", ragged_route),
                              ("decode", decode_route)):
            due = got["due"][kernel] if route else 0
            if got[kernel]["all"] != due or (
                    route and got[kernel][route] != due):
                raise AssertionError(
                    f"{label} worker {r.index}: {got[kernel]} {kernel} "
                    f"launches for {due} due (on {route})")
        rows[str(r.index)] = {"pid": desc["pid"], **got}
    return rows


def procfleet_identity_phase(torch, serving, model, prompts, spec,
                             cache_dir):
    """The identity model (fp32, the simple route) in worker processes
    built from ``spec`` (``preset``/``layers``/``dtype``/``seed``, which
    draw the same weights as ``model``): a ProcessFleet of 2 unified
    workers gives one in-process engine's greedy tokens on ``prompts``;
    a second wave with the stream's worker killed by SIGKILL mid-stream
    loses nothing and gives the same tokens, with one ``engine_death``
    bundle embedding the dead worker's mirrored events and a respawned
    worker under a new pid; then a prefill + decode worker pair hands
    every request off across processes, each served on the decode worker
    from the imported pages.  The launch rule per worker, over the wire."""
    new_tokens = 32
    dtype = getattr(torch, spec["dtype"])
    need = sum(-(-(len(p) + new_tokens) // 16) for p in prompts) + 1
    eng = serving.EngineCore(model, config=serving.EngineConfig(
        num_blocks=need + 16, block_size=16, dtype=dtype, unified_step=True,
        scheduler=serving.SchedulerConfig(max_num_seqs=16,
                                          max_tokens_per_step=512)))
    reqs = [eng.add_request(p, serving.SamplingParams(
        max_new_tokens=new_tokens)) for p in prompts]
    eng.run(max_steps=20000)
    want = [list(r.output_tokens) for r in reqs]
    del eng, reqs
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    flight_dir = tempfile.mkdtemp(prefix="procfleet_flight_")
    out = {}

    def wave(router, tag):
        return [router.submit_request(p, serving.SamplingParams(
            max_new_tokens=new_tokens), request_id=f"{tag}{i}",
            retryable=True) for i, p in enumerate(prompts)]

    pf = process_fleet(serving, spec, 2, need + 16, True,
                       compile_cache=cache_dir, flight_dir=flight_dir)
    pf.supervise(serving.SupervisorConfig(max_restarts=5))
    pf.start()
    router = pf.router
    out["boot"] = boot_rows(pf)
    pids = {pf.worker_pid(i) for i in range(2)}
    try:
        t0 = time.perf_counter()
        hs = wave(router, "a")
        router.wait(hs, timeout=600)
        out["fault_free_s"] = time.perf_counter() - t0
        if [list(h.output_tokens) for h in hs] != want or any(
                h.finish_reason != "length" for h in hs):
            raise AssertionError("procfleet_identity: the worker fleet's "
                                 "tokens differ from one in-process "
                                 "engine's (fp32)")
        out["served_by"] = [h.replica.index for h in hs]
        out["launch_rule"] = worker_launch_rule(
            "procfleet_identity", pf, "simple", None)
        quiet = (series_sum(pf.registry, "serving_replica_restarts_total"),
                 series_sum(pf.registry,
                            "serving_fleet_worker_respawns_total"))
        if quiet != (0, 0):
            raise AssertionError(f"procfleet_identity: restarts and "
                                 f"respawns {quiet} in a fault-free run")
        # --- kill -9 the worker holding the stream, mid-stream
        hs = wave(router, "b")
        deadline = time.monotonic() + 300
        while not any(h.output_tokens for h in hs) \
                and time.monotonic() < deadline:
            time.sleep(0.002)
        victim = next((r.index for r in router.replicas if r.in_flight),
                      None)
        if victim is None:
            raise AssertionError("procfleet_identity: nothing in flight to "
                                 "kill")
        vpid = pf.worker_pid(victim)
        tokens_at_kill = sum(len(h.output_tokens) for h in hs)
        os.kill(vpid, signal.SIGKILL)
        t_kill = time.perf_counter()
        router.wait(hs, timeout=600)
        lost = [h.rid for h in hs if h.finish_reason != "length"]
        if lost or [list(h.output_tokens) for h in hs] != want:
            raise AssertionError(f"procfleet_identity: kill -9 lost {lost} "
                                 "or changed the tokens")
        deadline = time.monotonic() + 300
        while not (all(r.healthy for r in router.replicas)
                   and pf.worker_pid(victim) != vpid) \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        healed_s = time.perf_counter() - t_kill
        new_pid = pf.worker_pid(victim)
        pids.add(new_pid)
        if new_pid == vpid or not all(r.healthy for r in router.replicas):
            raise AssertionError("procfleet_identity: the killed worker "
                                 "was not respawned")
        bundles = [b for b in router.flight.bundles if "engine_death" in b]
        if len(bundles) != 1:
            raise AssertionError(f"procfleet_identity: {len(bundles)} "
                                 "engine_death bundles for one kill")
        with open(bundles[0]) as f:
            dead = json.load(f)["distrib"][str(victim)]
        if dead["pid"] != vpid or not dead["mirror"]["events"]:
            raise AssertionError("procfleet_identity: the engine_death "
                                 "bundle holds no mirrored events of the "
                                 "dead worker")
        out["kill9"] = {
            "victim": victim, "pid": vpid, "new_pid": new_pid,
            "tokens_at_kill": tokens_at_kill, "healed_s": healed_s,
            "respawns": series_sum(pf.registry,
                                   "serving_fleet_worker_respawns_total"),
            "mirrored_events": len(dead["mirror"]["events"]),
            "respawn_boot": boot_rows(pf)[str(victim)],
            "launch_rule_after": worker_launch_rule(
                "procfleet_identity kill9", pf, "simple", None)}
    finally:
        stop_process_fleet("procfleet_identity", pf, pids)
        shutil.rmtree(flight_dir, ignore_errors=True)
    # --- the hand-off across processes
    roles = ["prefill", "decode"]
    pf = process_fleet(serving, spec, 2, need + 16, True, roles=roles,
                       compile_cache=cache_dir)
    pf.start()
    try:
        hs = wave(pf.router, "h")
        pf.router.wait(hs, timeout=600)
        if [list(h.output_tokens) for h in hs] != want or any(
                h.replica.index != 1 for h in hs):
            raise AssertionError("procfleet_identity: the prefill/decode "
                                 "workers' tokens differ from one engine's "
                                 "or a request did not finish on decode")
        events = {h.rid: e for h in hs for e in
                  pf.router.lifecycle.get(h.rid).to_dict()["events"]
                  if e["name"] == "kv_handoff"}
        att = pf.proxy(1).cachestat.snapshot()["attribution"]
        cached = {row["id"]: row["cached_tokens"]
                  for row in att["active"] + att["recent"]}
        short = {rid: (cached.get(str(rid)), e["blocks"] * 16)
                 for rid, e in events.items() if not e["blocks"]
                 or cached.get(str(rid), 0) < e["blocks"] * 16}
        if len(events) != len(prompts) or short:
            raise AssertionError(f"procfleet_identity: {len(events)} "
                                 f"hand-offs; not served from the imported "
                                 f"pages (cached, carried): {short}")
        out["handoff"] = {
            "handoffs": len(events),
            "blocks_each": [e["blocks"] for e in events.values()],
            "handoff_ms_each": [e["duration_ms"] for e in events.values()],
            "decode_cached_tokens_each": [cached[str(r)] for r in events],
            "launch_rule": worker_launch_rule(
                "procfleet_identity handoff", pf, "simple", None)}
    finally:
        stop_process_fleet("procfleet_identity handoff", pf)
    emit("procfleet_identity", model=spec["preset"], layers=spec["layers"],
         dtype=spec["dtype"], prompts=len(prompts),
         new_tokens_each=new_tokens, identical=True, lost=0, **out)


def procfleet_handoff(serving, spec, prompt, cache_dir):
    """One hand-off of ``prompt``'s prefill from a prefill worker to a
    decode worker over the wire, each part timed: the donor's gather,
    device-to-host copy, digest and framing (reported by the worker on
    its ``kv_run_begin`` frame), the rest of that round trip (each
    frame's JSON and the socket), the router's assembly, its framing for
    the recipient, and the recipient's receive, assembly, verification,
    pool import and scatter (reported on ``kv_import_ok``)."""
    from paddle_tpu_torch.serving import handoff

    blocks = -(-(len(prompt) + 16) // 16) + 4
    pf = process_fleet(serving, spec, 2, blocks + 16, True,
                       roles=["prefill", "decode"], compile_cache=cache_dir,
                       seqs=1)
    try:
        donor, recipient = pf.proxy(0), pf.proxy(1)
        donor.add_request(prompt, serving.SamplingParams(max_new_tokens=2),
                          request_id="handoff")
        while not donor.requests["handoff"].output_tokens:
            donor.step()
        conn = donor._engine_conn
        t0 = time.perf_counter()
        conn.send({"type": "kv_export", "rid": "handoff"})
        begin = conn.recv()
        chunks = [conn.recv() for _ in range(int(begin["chunks"]))]
        t1 = time.perf_counter()
        run = handoff.run_from_frames(begin, chunks)
        t2 = time.perf_counter()
        donor.detach_request("handoff")
        conn = recipient._engine_conn
        t3 = time.perf_counter()
        frames = handoff.run_to_frames(run)
        t4 = time.perf_counter()
        for f in frames:
            conn.send(f)
        reply = conn.recv()
        t5 = time.perf_counter()
        if reply.get("type") != "kv_import_ok" \
                or reply.get("placed") != len(run["blocks"]):
            raise AssertionError(f"procfleet handoff: import answered "
                                 f"{reply.get('type')} placing "
                                 f"{reply.get('placed')} of "
                                 f"{len(run['blocks'])} blocks")
        out_t, in_t = begin["t"], reply["t"]
        ms = {"gather": out_t["gather_s"],
              "device_to_host": out_t["device_to_host_s"],
              "digest": out_t["digest_s"], "framing": out_t["framing_s"],
              "socket_out": (t1 - t0) - sum(out_t.values()),
              "assemble": t2 - t1, "reframe": t4 - t3,
              "socket_in": in_t["receive_s"],
              "assemble_in": in_t["assemble_s"], "verify": in_t["verify_s"],
              "import": in_t["import_s"], "scatter": in_t["scatter_s"]}
        return {"prompt_tokens": len(prompt), "blocks": len(run["blocks"]),
                "bytes": int(begin["bytes"]), "frames": len(frames),
                "ms": {k: v * 1e3 for k, v in ms.items()},
                "total_ms": ((t2 - t0) + (t5 - t3)) * 1e3,
                "boot": boot_rows(pf)}
    finally:
        stop_process_fleet("procfleet handoff", pf)


def procfleet_phase(torch, serving, prompts, spec, cache_dir, in_process):
    """Llama-3-8B (bf16, cut to ``FLEET_LAYERS`` layers, built in each
    worker from ``spec``) through ``CompletionServer`` over ``--workers``
    fleets: 2 unified
    workers, then 2 legacy workers with bursts of 8, each on the server
    phase's two rounds of 24 completions (the second drained in flight),
    the supervisor on, kernels built in ``cache_dir``.  Gates: every
    completion whole, ``/readyz`` ``dp=2``, ``/metrics`` with both
    replicas' merged series, ``/v1/debug/wire`` enabled, zero restarts
    and respawns, the launch rule per worker (unified: ragged on tma, no
    decode launch; legacy: decode on mma, no ragged launch).  Then one
    2048-token hand-off between two worker processes, by part."""
    vocab = 128256 if spec["preset"] == "llama3_8b" else 256
    rng = np.random.default_rng(15)
    new_tokens = 64
    rounds = [server_bodies(rng, prompts, vocab, new_tokens)
              for _ in range(2)]
    need = max(sum(-(-(len(b["prompt"]) + new_tokens) // 16)
                   for b, _ in bodies) for bodies in rounds) + 1
    rows = {}
    for name, unified, burst, routes in (
            ("workers2_unified", True, 0, ("tma", None)),
            ("workers2_legacy_burst8", False, 8, (None, "mma"))):
        pf = process_fleet(serving, spec, 2, need + 16, unified, burst,
                           compile_cache=cache_dir)
        boots = boot_rows(pf)
        pids = {b["pid"] for b in boots.values()}
        srv = ServerThread(serving, pf.router)
        try:
            cold, _, _ = server_round(srv, rounds[0], new_tokens, False)
            row, rids, seen = server_round(
                srv, rounds[1], new_tokens, True,
                routes=("/readyz", "/metrics", "/v1/debug/wire"))
            status, _, ready = seen["/readyz"]
            page = seen["/metrics"][2]
            want = [b'serving_engine_steps_total{replica="0"}',
                    b'serving_engine_steps_total{replica="1"}',
                    b"serving_wire_frames_total",
                    b"serving_distrib_events_streamed_total",
                    b"serving_fleet_active_workers 2"]
            missing = [w.decode() for w in want if w not in page]
            wire = json.loads(seen["/v1/debug/wire"][2])
            if status != 200 or b"dp=2" not in ready or missing \
                    or not wire.get("enabled") or not wire.get("steps"):
                raise AssertionError(
                    f"procfleet {name}: /readyz {status} {ready!r}, "
                    f"/metrics missing {missing}, /v1/debug/wire "
                    f"{wire.get('enabled')} with {wire.get('steps')} steps")
            launches = worker_launch_rule(f"procfleet {name}", pf, *routes)
            restarts = (
                series_sum(pf.registry, "serving_replica_restarts_total"),
                series_sum(pf.registry,
                           "serving_fleet_worker_respawns_total"),
                series_sum(pf.registry,
                           "serving_fleet_heartbeat_timeouts_total"))
            if restarts != (0, 0, 0) or {pf.worker_pid(i)
                                         for i in range(2)} != pids:
                raise AssertionError(f"procfleet {name}: restarts, "
                                     f"respawns, heartbeat timeouts "
                                     f"{restarts} in a fault-free run")
            rows[name] = dict(
                row, cold=cold, boot=boots,
                in_flight_at_drain=seen["in_flight_at_drain"],
                readyz=ready.decode().strip(),
                wire={k: wire[k] for k in ("shares", "steps")},
                wire_per_worker={
                    i: {"shares": st["wire"]["shares"],
                        "steps": st["wire"]["steps"],
                        "clock": st["clock"]}
                    for i, st in wire["replicas"].items()},
                launch_rule=launches, restarts=0)
        finally:
            srv.close()
            stop_process_fleet(f"procfleet {name}", pf, pids)
    parts = procfleet_handoff(serving, spec, np.random.default_rng(13)
                              .integers(0, vocab, 2048).tolist(), cache_dir)
    emit("procfleet", model=spec["preset"], layers=spec["layers"],
         dtype=spec["dtype"], completions=len(rounds[1]),
         new_tokens_each=new_tokens, **rows,
         in_process={k: {f: v[f] for f in ("output_tokens_per_s",
                                           "mean_ttft_s", "mean_itl_s")}
                     for k, v in in_process.items()},
         handoff_2048=parts,
         note="the measured round's numbers (the first round, 'cold', "
              "takes the captures in each worker); TTFT and ITL are means "
              "over the router's request timelines, into which the "
              "workers' events are merged; in_process is this run's "
              "server phase on the same rounds' shapes; boot_s is the "
              "worker's own (engine build + kernel load), ready_s launch "
              "to ready line on the parent's clock")


FLEET_LAYERS = 4    # aot_boot's and procfleet's depth (32 until PR 15)


def aot_boot_save(torch, serving, model, prompts, spec):
    """The artifact ``aot_boot_phase`` boots its workers off, saved from
    an in-process saving engine over ``model`` (the workers'
    architecture; weights are not hashed) with the legacy families and
    decode bursts of 8 at the max_seq_len the server rounds need (the
    longest serve prompt plus the new tokens), and those rounds.  Saved
    before the phase so the caller can free ``model``: two workers
    warming the 2112-token universe need the card to themselves."""
    vocab = 128256 if spec["preset"] == "llama3_8b" else 256
    rng = np.random.default_rng(17)
    new_tokens = 64
    max_seq_len = max(len(p) for p in prompts) + new_tokens
    rounds = [server_bodies(rng, prompts, vocab, new_tokens)
              for _ in range(2)]
    need = max(sum(-(-(len(b["prompt"]) + new_tokens) // 16)
                   for b, _ in bodies) for bodies in rounds) + 1
    num_blocks = need + 16
    path = tempfile.mkdtemp(prefix="aot_boot_")
    shutil.rmtree(path)
    t0 = time.perf_counter()
    saver = serving.EngineCore(model, config=serving.EngineConfig(
        num_blocks=num_blocks, block_size=16,
        dtype=getattr(torch, spec["dtype"]), burst_steps=8,
        scheduler=serving.SchedulerConfig(max_num_seqs=16)))
    art = serving.AotArtifact.save(saver, path, max_seq_len=max_seq_len)
    return {"art": art, "path": path,
            "save_s": time.perf_counter() - t0, "rounds": rounds,
            "new_tokens": new_tokens, "num_blocks": num_blocks,
            "max_seq_len": max_seq_len}


def aot_boot_phase(serving, saved, spec):
    """Llama-3-8B (bf16, cut to ``FLEET_LAYERS`` layers) worker processes
    booted off the AOT artifact ``aot_boot_save`` saved in this run (legacy families,
    bursts of 8, the max_seq_len the server rounds need, up to 2112),
    then 2 workers with ``--aot-path --warm`` and a fresh, empty
    ``--compile-cache``: no ``nvcc`` (the directory stays empty), 0 trace
    counts, each worker's warm captures = 2 x the saved
    buckets; the server phase's round shape (the full serve prompts)
    through ``CompletionServer`` captures nothing after the ready lines
    and keeps the launch rule; a ``kill -9`` of a worker heals off the
    artifact (respawn with ``--warm``), and a second round captures
    nothing either.  Each worker's warm seconds are read from the line it
    printed before its ready line."""
    art, path, rounds = saved["art"], saved["path"], saved["rounds"]
    new_tokens, num_blocks = saved["new_tokens"], saved["num_blocks"]
    cache = tempfile.mkdtemp(prefix="aot_boot_kernels_")
    t0 = time.perf_counter()
    pf = process_fleet(serving, spec, 2, num_blocks, False, 8,
                       compile_cache=cache, aot_path=path)
    fleet_s = time.perf_counter() - t0
    boots = boot_rows(pf)
    pids = {b["pid"] for b in boots.values()}
    srv = ServerThread(serving, pf.router)
    out = {"warm_s": warm_seconds(pf)}

    def describe(label):
        rows = {}
        for r in pf.router.replicas:
            d = pf.proxy(r.index).debug_fetch("describe")
            aot = pf.proxy(r.index).debug_fetch("aot")
            if d is None or any(d["traces"].values()) or \
                    not aot.get("loaded"):
                raise AssertionError(f"aot_boot {label}: worker {r.index} "
                                     f"traces {d and d['traces']}, aot "
                                     f"{aot}")
            rows[str(r.index)] = {"pid": d["pid"], "captures": d["captures"],
                                  "hits": aot["hits"]}
        return rows

    try:
        first = describe("boot")
        if any(w["captures"] != 2 * art.program_count
               for w in first.values()):
            raise AssertionError(f"aot_boot: warm captures {first} for "
                                 f"{art.program_count} saved buckets")
        row, _, _ = server_round(srv, rounds[0], new_tokens, False)
        after = describe("round")
        if any(after[i]["captures"] != first[i]["captures"]
               for i in after):
            raise AssertionError(f"aot_boot: the round captured: {first} "
                                 f"-> {after}")
        out["round"] = row
        out["launch_rule"] = worker_launch_rule("aot_boot", pf, None,
                                                "mma")
        victim = 0
        vpid = pf.worker_pid(victim)
        os.kill(vpid, signal.SIGKILL)
        t_kill = time.perf_counter()
        deadline = time.monotonic() + 300
        while not (all(r.healthy for r in pf.router.replicas)
                   and pf.worker_pid(victim) not in (None, vpid)) \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        healed_s = time.perf_counter() - t_kill
        new_pid = pf.worker_pid(victim)
        pids.add(new_pid)
        if new_pid in (None, vpid):
            raise AssertionError("aot_boot: the killed worker was not "
                                 "respawned")
        respawned = describe("respawn")
        row2, _, _ = server_round(srv, rounds[1], new_tokens, False)
        again = describe("round after the heal")
        if pf.worker_pid(victim) != new_pid or any(
                again[i]["captures"] != respawned[i]["captures"]
                for i in again):
            raise AssertionError(f"aot_boot: after the heal the round "
                                 f"captured or the worker died: "
                                 f"{respawned} -> {again}")
        out["kill9"] = {"pid": vpid, "new_pid": new_pid,
                        "healed_s": healed_s,
                        "respawn_boot": boot_rows(pf)[str(victim)],
                        "respawn_warm_s": warm_seconds(pf).get(str(victim)),
                        "respawn_captures": respawned[str(victim)][
                            "captures"]}
        out["round_after_heal"] = row2
    finally:
        srv.close()
        stop_process_fleet("aot_boot", pf, pids)
    leftovers = os.listdir(cache)
    if leftovers:
        raise AssertionError(f"aot_boot: the workers built kernels into "
                             f"their --compile-cache: {leftovers}")
    shutil.rmtree(cache, ignore_errors=True)
    shutil.rmtree(path, ignore_errors=True)
    emit("aot_boot", model=spec["preset"], layers=spec["layers"],
         dtype=spec["dtype"], max_seq_len=saved["max_seq_len"],
         families={f: len(v) for f, v in art.bucket_sets.items()},
         program_count=art.program_count, save_s=saved["save_s"],
         kernels=sorted(art.manifest["kernels"]), fleet_build_s=fleet_s,
         boot=boots, workers_at_boot=first, compile_cache_entries=0,
         **out,
         note="boot_s is the worker's own (engine build, artifact load, "
              "kernel load, warm); ready_s launch to ready line on the "
              "parent's clock; captures per worker read over the wire "
              "(describe)")


# --- GPT, BERT and ERNIE training phases --------------------------------------

GPT_B, GPT_S = 4, 2048          # the gpt_train phase's batch and sequence
BERT_B, BERT_S = 32, 384        # bert_finetune: BERT-base SQuAD
ERNIE_S, ERNIE_STEPS = 512, 10  # and ERNIE-3.0-base classification
SENT_L, SENT_R = 2, 3           # the sentinel tokens around an answer span


@contextlib.contextmanager
def gpt_attention(gpt_mod, run):
    """GPT's attention for one run of gpt_train_identity, patched for this
    script's comparison only (the model has no such switch): ``kernel`` as
    it is; ``composite`` pinned to the plain composite paths
    (``use_pallas=False``); ``planted`` through the kernels with the
    output's last 64 query rows zeroed, what a forward kernel that skipped
    its last tile would give."""
    real = gpt_mod.ring_flash_attention

    def composite(q, k, v, causal=True):
        return real(q, k, v, causal=causal, use_pallas=False)

    def planted(q, k, v, causal=True):
        return tail_zeroed(real(q, k, v, causal=causal))

    gpt_mod.ring_flash_attention = {"kernel": real, "composite": composite,
                                    "planted": planted}[run]
    try:
        yield
    finally:
        gpt_mod.ring_flash_attention = real


def gpt_model(torch, port, layers, dtype, seed):
    cfg = port.GPTConfig(num_hidden_layers=layers)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return port.GPTForCausalLM(cfg, device="cuda", dtype=dtype,
                               generator=gen)


def gpt_trainer(torch, port, model, lr=1e-4, multi_precision=False):
    sched = port.LinearWarmup(port.CosineAnnealingDecay(lr, T_max=10), 2,
                              lr / 10, lr)
    opt = port.AdamW(learning_rate=sched, parameters=model.parameters(),
                     weight_decay=0.01, multi_precision=multi_precision)
    return opt, sched


def gpt_losses(torch, port, model, opt, sched, batches,
               after_backward=None):
    return [float(x) for x in train_steps(
        lm_loss(model, port.GPTPretrainingCriterion()), opt, batches, sched,
        after_backward)]


def free(torch):
    gc.collect()
    torch.cuda.empty_cache()


def identity_gaps(run, ref):
    """The gaps gpt_train_identity gates: the largest relative gap between
    two runs' losses, and between their first step's attention gradients
    (each tensor's largest gap over the reference's largest entry)."""
    loss = max(abs(a - b) / abs(b)
               for a, b in zip(run["losses"], ref["losses"]))
    grad = max(float((g - ref["grads"][n]).abs().max()
                     / ref["grads"][n].abs().max())
               for n, g in run["grads"].items())
    return {"loss": loss, "grad": grad}


def gpt_train_identity_phase(torch, flash, fa, port):
    """GPT-3 6.7B widths (``GPTConfig()``) cut to 2 layers, fp32, B=1,
    S=1024: 4 AdamW steps through the flash kernels (MHA, a group of 1, at
    head dim 128), 4 with GPT's attention pinned to the composite paths,
    and 4 through the kernels with a planted fault (the attention output's
    last 64 rows zeroed), from the same seeded weights and batches.  The
    kernel run's losses agree with the composite's within 1e-4 relative and
    its first step's attention gradients (every layer's qkv_proj and
    o_proj) within 1e-4 of their largest entry; the planted run must fail
    that gate.  Each kernel launched 4 x 2 times (none in the pinned
    run)."""
    layers, S, steps, tol = 2, 1024, 4, 1e-4
    rng = np.random.default_rng(12)
    batches = [torch.from_numpy(corpus(rng, 1, S)).cuda()
               for _ in range(steps)]
    runs = {}
    for run in ("kernel", "composite", "planted"):
        model = gpt_model(torch, port, layers, torch.float32, seed=5)
        opt, sched = gpt_trainer(torch, port, model)
        attn = {n: p for n, p in model.named_parameters() if ".attn." in n}
        grads = {}

        def first_grads(i):
            if i == 0:
                grads.update({n: p.grad.detach().clone()
                              for n, p in attn.items()})

        reset_flash_counts(flash)
        t0 = time.perf_counter()
        with gpt_attention(port.gpt_mod, run):
            losses = gpt_losses(torch, port, model, opt, sched, batches,
                                first_grads)
        runs[run] = {"losses": losses, "grads": grads,
                     "launches": flash_counts(flash), "path": fa.last_path,
                     "seconds": time.perf_counter() - t0}
        del model, opt, attn
        free(torch)
    kern, plain, bad = runs["kernel"], runs["composite"], runs["planted"]
    gaps, planted = identity_gaps(kern, plain), identity_gaps(bad, plain)
    if not (np.isfinite(kern["losses"]).all()
            and max(gaps.values()) <= tol):
        raise AssertionError(f"gpt_train_identity: kernel losses "
                             f"{kern['losses']} against composite "
                             f"{plain['losses']}, gaps {gaps} (tol {tol})")
    if not max(planted.values()) > tol:
        raise AssertionError(f"gpt_train_identity: the planted fault passes "
                             f"the gate: gaps {planted} (tol {tol})")
    due = {k: steps * layers for k in FLASH_MARKS}
    if (kern["launches"] != due or any(plain["launches"].values())
            or kern["path"] != "cuda" or plain["path"] == "cuda"):
        raise AssertionError(f"gpt_train_identity: launches "
                             f"{kern['launches']} (due {due}), composite "
                             f"run {plain['launches']}, paths "
                             f"{kern['path']} / {plain['path']}")
    for r in runs.values():
        del r["grads"]
    emit("gpt_train_identity", layers=layers, dtype="float32", batch=1,
         seq=S, steps=steps, tol=tol, gaps=gaps, planted_gaps=planted,
         max_rel_loss_diff=gaps["loss"], kernel=kern, composite=plain,
         planted=bad)


def gpt_shape_flash_check(torch, flash):
    """The three kernels against their twins at gpt_train's shape and
    layout in bf16: B=4, S=2048, 32 heads of 128, causal, q, k and v as
    views into one [B, S, 3, H, D] buffer, as GPTAttention slices its fused
    projection (rows 3·H·D apart), and dO contiguous, as autograd hands it
    over.  TMA must read them in place (no copy), every row must hold the
    bf16 tolerance and each planted fault must fail."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(18)
    B, S, H, D = GPT_B, GPT_S, 32, 128
    qkv = torch.randn(B, S, 3, H, D, device=dev, generator=gen).bfloat16()
    do = torch.randn(B, S, H, D, device=dev, generator=gen).bfloat16()
    copies = flash.copy_launches
    rec, _, _ = flash_check(torch, flash, "gpt train shape (fused qkv)",
                            qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], do,
                            True, plant=True)
    routed = {"copies": flash.copy_launches - copies,
              "route": flash.last_route}
    if routed != {"copies": 0, "route": "tma"}:
        raise AssertionError(f"gpt_train: the fused-QKV views took {routed}, "
                             f"due 0 copies on route 'tma'")
    del qkv, do
    free(torch)
    return {"case": f"gpt train shape {(B, S, S, H, H, D)} causal=True, "
                    f"q/k/v views of [B, S, 3, H, D]", "dtype": "bfloat16",
            **routed, **rec}


def gpt_train_phase(torch, flash, fa, port, obs):
    """GPT-3 6.7B at full width (vocab 50304, hidden 4096, 32 heads of
    128, FFN 16384, 2048 positions) cut to 4 layers, bf16 with fp32 master
    weights, AdamW under LinearWarmup -> CosineAnnealingDecay, B=4, S=2048
    on the synthetic corpus: first the kernels at this shape and layout
    (gpt_shape_flash_check), then 2 warm-up and 8 timed steps of
    ``model(ids) -> criterion -> backward -> step -> clear_grad`` with no
    sync inside the loop, each timed step recorded by the port's
    TrainStepTelemetry (MFU against 989 TFLOP/s) from its CUDA-event
    time."""
    layers, warm, timed = 4, 2, 8
    B, S = GPT_B, GPT_S
    shape_check = gpt_shape_flash_check(torch, flash)
    t0 = time.perf_counter()
    model = gpt_model(torch, port, layers, torch.bfloat16, seed=7)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    criterion = port.GPTPretrainingCriterion()
    opt, sched = gpt_trainer(torch, port, model, multi_precision=True)
    rng = np.random.default_rng(13)
    batches = [torch.from_numpy(corpus(rng, B, S)).cuda()
               for _ in range(warm + timed)]
    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    tel = port.TrainStepTelemetry(
        n_params=n_params, num_layers=layers, seq_len=S,
        hidden=cfg.hidden_size, peak_flops=PEAK_FLOPS["bfloat16"],
        registry=obs.MetricsRegistry(), tracer=obs.SpanTracer())
    reset_flash_counts(flash)
    copies = flash.copy_launches
    step_loss = lm_loss(model, criterion)
    losses = train_steps(step_loss, opt, batches[:warm], sched)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    clock = StepClock(torch)
    t0 = time.perf_counter()
    losses += train_steps(step_loss, opt, batches[warm:], sched, clock=clock)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_s, opt_s = clock.read()
    for seconds in step_s:
        tel.step(tokens=B * S, seconds=seconds)
    launches = flash_counts(flash)
    route = {"copies": flash.copy_launches - copies,
             "route": flash.last_route}
    losses = [float(x) for x in losses]
    due = {k: (warm + timed) * layers for k in FLASH_MARKS}
    if (launches != due or fa.last_path != "cuda"
            or route != {"copies": 0, "route": "tma"}):
        raise AssertionError(f"gpt_train: kernel launches {launches}, due "
                             f"{due} (path {fa.last_path}, {route}; due 0 "
                             f"copies on route 'tma')")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"gpt_train: losses {losses} are not finite or "
                             f"do not fall")
    text = tel.registry.prometheus_text()
    if "train_mfu" not in text or tel.steps != timed:
        raise AssertionError(f"gpt_train: telemetry recorded {tel.steps} "
                             f"steps; its text:\n{text}")
    tokens_per_s = B * S * timed / wall
    emit("gpt_train", model="gpt3_6.7b", layers=layers, dtype="bfloat16",
         batch=B, seq=S, warmup_steps=warm, timed_steps=timed,
         losses=losses, ms_per_step=wall / timed * 1e3,
         tokens_per_s=tokens_per_s, params=n_params,
         flops_per_token=tel.flops_per_token,
         mfu=tel.flops_per_token * tokens_per_s / PEAK_FLOPS["bfloat16"],
         telemetry=tel.registry.snapshot(),
         step_ms=[x * 1e3 for x in step_s],
         optimizer_ms_per_step=sum(opt_s) / timed * 1e3,
         optimizer_share=sum(opt_s) / sum(step_s),
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         kernel_launches=launches, kernel_route=route,
         model_build_s=build_s, telemetry_text_bytes=len(text),
         shape_check=shape_check)
    return launches, (model, criterion, opt, sched)


def squad_split(rng, n, S, vocab):
    """examples/finetune_bert_squad.py's SQuAD-shaped synthetic split: a
    random context whose answer span is bracketed by sentinel tokens, so
    span-pointing is learnable (copied here: the example imports the JAX
    package)."""
    ids = rng.integers(4, vocab, (n, S))
    start = rng.integers(1, S - 4, (n,))
    length = rng.integers(1, 3, (n,))
    end = np.minimum(start + length, S - 2)
    ids[np.arange(n), start] = SENT_L   # span starts AT the marker
    ids[np.arange(n), end] = SENT_R
    return ids.astype(np.int64), start.astype(np.int64), end.astype(np.int64)


def finetune_trainer(torch, port, model, lr, warmup, steps):
    sched = port.LinearWarmup(
        port.PolynomialDecay(learning_rate=lr, decay_steps=steps,
                             end_lr=0.0),
        warmup_steps=warmup, start_lr=0.0, end_lr=lr)
    opt = port.AdamW(learning_rate=sched, parameters=model.parameters(),
                     weight_decay=0.01, multi_precision=True)
    return opt, sched


def bert_finetune_phase(torch, flash, port):
    """BERT-base SQuAD fine-tuning (``BertForQuestionAnswering(
    BertConfig())``, 12 layers), bf16 with fp32 masters, dropout 0.1 from
    an explicit generator, AdamW under LinearWarmup -> PolynomialDecay, 60
    steps of B=32, S=384 on the example's synthetic split in epochs; span
    accuracy on a held-out split (reported, not gated); then
    ``ErnieForSequenceClassification(ErnieConfig())`` for 10 steps at
    S=512, B=32.  Neither reaches a flash kernel: BERT's attention is
    plain torch ops, as it is XLA code in the JAX package."""
    steps, warmup, lr = 60, 6, 1e-4
    B, S = BERT_B, BERT_S
    cfg = port.BertConfig()
    gen = torch.Generator(device="cuda").manual_seed(8)
    dgen = torch.Generator(device="cuda").manual_seed(9)
    t0 = time.perf_counter()
    model = port.BertForQuestionAnswering(cfg, device="cuda",
                                          dtype=torch.bfloat16,
                                          generator=gen,
                                          dropout_generator=dgen)
    build_s = time.perf_counter() - t0
    opt, sched = finetune_trainer(torch, port, model, lr, warmup, steps)
    rng = np.random.default_rng(14)
    train = [torch.from_numpy(a).cuda()
             for a in squad_split(rng, B * 16, S, cfg.vocab_size)]
    dev = [torch.from_numpy(a).cuda()
           for a in squad_split(rng, B, S, cfg.vocab_size)]
    batches = []
    while len(batches) < steps:
        perm = torch.from_numpy(rng.permutation(B * 16)).cuda()
        batches += [perm[lo:lo + B] for lo in range(0, B * 16, B)]
    batches = batches[:steps]

    def step_loss(sel):
        ids, start, end = (a[sel] for a in train)
        s_logits, e_logits = model(ids)
        return (port.cross_entropy(s_logits, start)
                + port.cross_entropy(e_logits, end)) / 2.0

    model.train()
    reset_flash_counts(flash)
    skip = 10                 # the first steps warm cuBLAS and the caches
    losses = train_steps(step_loss, opt, batches[:skip], sched)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    clock = StepClock(torch)
    t0 = time.perf_counter()
    losses += train_steps(step_loss, opt, batches[skip:], sched, clock=clock)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_s, opt_s = clock.read()
    losses = [float(x) for x in losses]
    timed = steps - skip
    if not (np.isfinite(losses).all()
            and np.mean(losses[-5:]) < np.mean(losses[:5])):
        raise AssertionError(f"bert_finetune: losses {losses} are not "
                             f"finite or do not fall")
    if any(flash_counts(flash).values()):
        raise AssertionError(f"bert_finetune: a flash kernel launched "
                             f"({flash_counts(flash)})")
    kernels, wall_us, _ = profile_window(
        torch, lambda: train_steps(step_loss, opt, batches[:1], sched), 2)
    model.eval()
    with torch.no_grad():
        s_logits, e_logits = model(dev[0])
    s_ok = s_logits.argmax(-1) == dev[1]
    e_ok = e_logits.argmax(-1) == dev[2]
    bert = {"model": "bert-base", "layers": cfg.num_hidden_layers,
            "dtype": "bfloat16", "batch": B, "seq": S, "steps": steps,
            "losses": losses, "timed_steps": timed,
            "ms_per_step": wall / timed * 1e3,
            "tokens_per_s": B * S * timed / wall,
            "optimizer_ms_per_step": sum(opt_s) / timed * 1e3,
            "optimizer_share": sum(opt_s) / sum(step_s),
            "start_acc": s_ok.float().mean().item(),
            "end_acc": e_ok.float().mean().item(),
            "exact_match": (s_ok & e_ok).float().mean().item(),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "model_build_s": build_s,
            "profile": window_summary(kernels, wall_us)}
    del model, opt, train, dev, batches
    free(torch)

    ecfg = port.ErnieConfig()
    model = port.ErnieForSequenceClassification(
        ecfg, device="cuda", dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(10),
        dropout_generator=torch.Generator(device="cuda").manual_seed(11))
    # half the steps warm up: with 2, the first steps at the full rate
    # threw the loss up (to 2.5 on an H100) before it fell
    opt, sched = finetune_trainer(torch, port, model, lr, ERNIE_STEPS // 2,
                                  ERNIE_STEPS)
    # one fixed batch whose class shows in every token: a class-1 text
    # draws its tokens from the upper half of the vocabulary
    half = ecfg.vocab_size // 2
    labels = rng.integers(0, 2, (B,))
    ids = rng.integers(1, half, (B, ERNIE_S)) + labels[:, None] * half
    labels = torch.from_numpy(labels).cuda()
    ids = torch.from_numpy(ids).cuda()
    model.train()

    def eloss(_):
        return port.cross_entropy(model(ids), labels)

    elosses = train_steps(eloss, opt, range(2), sched)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    elosses += train_steps(eloss, opt, range(2, ERNIE_STEPS), sched)
    torch.cuda.synchronize()
    ewall = time.perf_counter() - t0
    elosses = [float(x) for x in elosses]
    if not (np.isfinite(elosses).all() and elosses[-1] < elosses[0]):
        raise AssertionError(f"bert_finetune: ERNIE losses {elosses} are "
                             f"not finite or do not fall")
    ernie = {"model": "ernie-3.0-base", "layers": ecfg.num_hidden_layers,
             "dtype": "bfloat16", "batch": B, "seq": ERNIE_S,
             "steps": ERNIE_STEPS, "losses": elosses,
             "ms_per_step": ewall / (ERNIE_STEPS - 2) * 1e3,
             "tokens_per_s": B * ERNIE_S * (ERNIE_STEPS - 2) / ewall,
             "max_memory_allocated": torch.cuda.max_memory_allocated()}
    del model, opt
    free(torch)
    emit("bert_finetune", bert=bert, ernie=ernie)


def train_checkpoint_phase(torch, port):
    """The gpt_train_identity model (fp32, 2 layers): 2 steps, then
    ``framework.save`` of model, optimizer and scheduler to a temporary
    directory; a fresh model and optimizer ``load`` them and train 2 more.
    The 4 losses must equal an uninterrupted 4-step run's: bit for bit
    where two uninterrupted runs are, else within the gap between those
    two.  Then a bf16 model saved and loaded back bit-equal."""
    layers, S, steps = 2, 1024, 4
    rng = np.random.default_rng(15)
    batches = [torch.from_numpy(corpus(rng, 1, S)).cuda()
               for _ in range(steps)]

    def fresh():
        model = gpt_model(torch, port, layers, torch.float32, seed=5)
        return (model, *gpt_trainer(torch, port, model))

    whole = []
    for _ in range(2):
        model, opt, sched = fresh()
        whole.append(gpt_losses(torch, port, model, opt, sched, batches))
        del model, opt
        free(torch)
    model, opt, sched = fresh()
    resumed = gpt_losses(torch, port, model, opt, sched, batches[:2])
    tmp = tempfile.mkdtemp(prefix="train_checkpoint_")
    try:
        path = os.path.join(tmp, "gpt.pdparams")
        t0 = time.perf_counter()
        port.framework.save({"model": model.state_dict(),
                             "opt": opt.state_dict()}, path)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        del model, opt, sched
        free(torch)
        model, opt, sched = fresh()
        t0 = time.perf_counter()
        ck = port.framework.load(path, device="cuda")
        model.load_state_dict(ck["model"])
        opt.set_state_dict(ck["opt"])
        del ck
        load_s = time.perf_counter() - t0
        resumed += gpt_losses(torch, port, model, opt, sched, batches[2:])
        del model, opt
        free(torch)

        bf16 = gpt_model(torch, port, layers, torch.bfloat16, seed=6)
        bpath = os.path.join(tmp, "gpt_bf16.pdparams")
        port.framework.save(bf16.state_dict(), bpath)
        other = gpt_model(torch, port, layers, torch.bfloat16, seed=16)
        other.load_state_dict(port.framework.load(bpath, device="cuda"))
        bf16_equal = all(torch.equal(a, b) for a, b in
                         zip(bf16.state_dict().values(),
                             other.state_dict().values()))
        del bf16, other
        free(torch)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    run_gap = max(abs(a - b) for a, b in zip(*whole))
    gap = max(abs(a - b) for a, b in zip(resumed, whole[0]))
    ok = (resumed == whole[0]) if whole[0] == whole[1] else gap <= run_gap
    if not (ok and bf16_equal):
        raise AssertionError(f"train_checkpoint: resumed {resumed} against "
                             f"uninterrupted {whole} (gap {gap}, between "
                             f"runs {run_gap}); bf16 equal {bf16_equal}")
    emit("train_checkpoint", layers=layers, dtype="float32", seq=S,
         steps=steps, uninterrupted=whole, resumed=resumed,
         bit_equal=resumed == whole[0], runs_bit_equal=whole[0] == whole[1],
         max_gap=gap, file_bytes=size, save_s=save_s, load_s=load_s,
         bf16_round_trip_equal=bf16_equal)



# --- image classification: ResNet and ViT under to_static ----------------------

VIT_B, VIT_S, VIT_H, VIT_D = 64, 197, 12, 64    # ViT-B/16 at 224, B=64
RESNET_B = 64       # PaddleClas ResNet50.yaml's batch a card
RESNET_LR = 0.1 * RESNET_B / 256    # its lr, for a global batch of 256
CONV_MARKS = ("conv", "xmma", "cudnn", "implicit", "dgrad", "wgrad",
              "fprop", "nchw", "nhwc")
WELFORD_MARKS = ("welford", "batch_norm", "batchnorm")
ELEMENTWISE_MARKS = ("elementwise", "vectorized", "unrolled")


def stripe_batches(torch, rng, n, B, S, classes=10):
    """examples/train_resnet.py's synthetic batches: noise (std 0.1) with a
    bright row at a height set by the label, labels among ``classes``."""
    out = []
    for _ in range(n):
        y = rng.integers(0, classes, B)
        x = rng.standard_normal((B, 3, S, S)) * 0.1
        for b, lab in enumerate(y):
            x[b, 0, (lab * S // classes) % S] += 1.0
        out.append((torch.from_numpy(x.astype(np.float32)).cuda(),
                    torch.from_numpy(y).cuda()))
    return out


def classifier_step(model, opt, loss_fn, amp_ctx=None):
    """examples/train_resnet.py's step: loss, backward, step, clear."""
    def step(x, y):
        with (amp_ctx() if amp_ctx else contextlib.nullcontext()):
            loss = loss_fn(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return step


def state_gap(a, b):
    """The largest gap between two models' parameters and buffers, each
    over its tensor's largest value, and whether every tensor is
    bit-equal."""
    worst, equal = 0.0, True
    for (name, x), (_, y) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        equal = equal and bool((x == y).all())
        scale = max(float(y.float().abs().max()), 1e-30)
        worst = max(worst, float((x.float() - y.float()).abs().max())
                    / scale)
    return worst, equal


def vit_shape_flash(torch, flash):
    """The three flash kernels at ViT-B/16's attention shape (B=64, S=197:
    a tail of 69 rows past the first 128-row block, 12 heads of 64,
    non-causal), fp32 and bf16, against their twins row by row, with the
    planted fault (each output's last 64 rows zeroed) that must fail; for
    bf16 (the O1 path) the kernels', twins', library's (SDPA and its
    backward) CUDA-event times and the bound.  Each kernel's device time
    a launch is read inside vit_train's steps: a back-to-back profile
    window of a long process can record no flash kernel."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    shape = (VIT_B, VIT_S, VIT_H, VIT_D)
    q32, k32, v32, do32 = (torch.randn(shape, device=dev, generator=gen)
                           for _ in range(4))
    checks, summary = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        q, k, v, do = (t.to(dtype) for t in (q32, k32, v32, do32))
        rec, lse, delta = flash_check(torch, flash, "vit shape", q, k, v,
                                      do, False, plant=True)
        checks.append({"dtype": name, **rec})
        if dtype != torch.bfloat16:
            continue
        scale = 1.0 / np.sqrt(VIT_D)
        kernels = {
            "fwd": lambda: flash.fwd_kernel(q, k, v, False),
            "dq": lambda: flash.bwd_dq_kernel(q, k, v, do, lse, delta,
                                              False),
            "dkv": lambda: flash.bwd_dkv_kernel(q, k, v, do, lse, delta,
                                                False)}
        plains = {
            "fwd": lambda: flash.fwd_reference(q, k, v, scale, False),
            "dq": lambda: flash.bwd_dq_reference(q, k, v, do, lse, delta,
                                                 scale, False),
            "dkv": lambda: flash.bwd_dkv_reference(q, k, v, do, lse, delta,
                                                   scale, False)}
        import torch.nn.functional as TF

        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        g = do.transpose(1, 2).contiguous()
        lib_out = TF.scaled_dot_product_attention(qt, kt, vt)

        def lib_fwd():
            with torch.no_grad():
                return TF.scaled_dot_product_attention(qt, kt, vt)

        def lib_bwd():
            return torch.autograd.grad(lib_out, (qt, kt, vt), g,
                                       retain_graph=True)

        library = {"fwd": time_ms(lib_fwd, 10), "dq": time_ms(lib_bwd, 10)}
        library["dkv"] = library["dq"]
        for key, (flops, nbytes) in flash_work(q, k, False).items():
            t_flops = flops / PEAK_FLOPS[name] * 1e3
            t_bytes = nbytes / PEAK_BYTES * 1e3
            ms = time_ms(kernels[key], 10)
            summary[key] = {
                "B": VIT_B, "S": VIT_S, "H": VIT_H, "D": VIT_D,
                "dtype": name, "causal": False,
                "max_abs_err": kernel_err(rec, "abs", key),
                "max_row_err": kernel_err(rec, "row", key),
                "ms": ms, "tflops": flops / ms / 1e9,
                "plain_ms": time_ms(plains[key], 2, 1),
                "library_ms": library[key],
                "bound_ms": max(t_flops, t_bytes),
                "bound_by": "operations" if t_flops > t_bytes else "bytes"}
        del qt, kt, vt, lib_out
    return checks, summary


def vision_identity_phase(torch, flash, port):
    """fp32 gates of the image-classification path (cuDNN deterministic):
    resnet18 at 64x64, B=8, 5 to_static steps against 5 eager steps from
    the same weights (losses, parameters and BatchNorm buffers; the planted
    fault, a first call that applies two steps, must fail the gate); a
    step that reads float(loss) falls back to eager with one warning and
    one graph break; a ViT at ViT-B widths cut to 2 layers, 224x224, B=8,
    3 to_static AdamW steps through the flash kernels against the same
    steps through the composite (``use_pallas=False``), losses within 1e-5
    relative and each kernel launched steps x layers times; and the flash
    kernels at ViT-B/16's attention shape against their twins."""
    import warnings

    from paddle_tpu_torch.nn.functional import attention as attn_mod

    torch.backends.cudnn.deterministic = True
    rng = np.random.default_rng(30)
    batches = stripe_batches(torch, rng, 5, 8, 64)

    def resnet(seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return port.vision.resnet18(num_classes=10, device="cuda",
                                    generator=gen)

    def trainer(model):
        opt = port.Momentum(learning_rate=0.1, momentum=0.9,
                            parameters=model.parameters(),
                            weight_decay=1e-4)
        return classifier_step(model, opt, port.nn.CrossEntropyLoss())

    runs = {}
    for mode in ("static", "eager", "planted"):
        model = resnet(5)
        step = trainer(model)
        if mode == "static":
            step = port.jit.to_static(step)
        todo = batches if mode != "planted" else batches[:1] + batches
        losses = [step(x, y) for x, y in todo]
        if mode == "planted":
            losses = losses[1:]
        runs[mode] = (model, [float(l) for l in losses], step)
    static, eager, planted = runs["static"], runs["eager"], runs["planted"]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(static[1], eager[1]))
    gap, bit_equal = state_gap(static[0], eager[0])
    planted_gap, _ = state_gap(planted[0], eager[0])
    planted_loss = max(abs(a - b) / abs(b)
                       for a, b in zip(planted[1], eager[1]))
    tol = 1e-5
    if not (loss_gap <= tol and gap <= tol and static[2].captures == 1
            and static[2].replays == 4):
        raise AssertionError(f"vision_identity: to_static against eager: "
                             f"losses {loss_gap}, state {gap} (tol {tol}), "
                             f"captures {static[2].captures}, replays "
                             f"{static[2].replays}")
    if not (planted_gap > tol or planted_loss > tol):
        raise AssertionError(f"vision_identity: a first call taking two "
                             f"steps passed the gate ({planted_gap}, "
                             f"{planted_loss})")
    resnet_row = {"losses": static[1], "eager_losses": eager[1],
                  "max_rel_loss_gap": loss_gap, "max_state_gap": gap,
                  "bit_equal": bit_equal, "tol": tol,
                  "planted_state_gap": planted_gap,
                  "planted_loss_gap": planted_loss,
                  "captures": static[2].captures,
                  "replays": static[2].replays}
    del runs, static, eager, planted

    # a host read inside the step: one warning, one break, eager results
    model = resnet(6)
    ref = resnet(6)
    opt = port.Momentum(learning_rate=0.1, momentum=0.9,
                        parameters=model.parameters(), weight_decay=1e-4)
    ce = port.nn.CrossEntropyLoss()

    def reading_step(x, y):
        loss = ce(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        reading_step.seen.append(float(loss))
        return loss

    reading_step.seen = []
    counter = port.registry().counter("jit_graph_breaks_total", "")
    before = counter.value
    fn = port.jit.to_static(reading_step)
    ref_step = trainer(ref)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        for x, y in batches[:3]:
            fn(x, y)
            ref_step(x, y)
    breaks = counter.value - before
    warned = sum("graph break" in str(w.message) for w in seen)
    break_gap, _ = state_gap(model, ref)
    if not (breaks == 1 and warned == 1 and fn.captures == 0
            and break_gap <= tol and len(reading_step.seen) == 3):
        raise AssertionError(f"vision_identity: graph break: {breaks} "
                             f"breaks, {warned} warnings, captures "
                             f"{fn.captures}, state gap {break_gap}")
    del model, ref, opt, fn
    torch.backends.cudnn.deterministic = False

    # the ViT through the flash kernels against the composite
    vit_runs = {}
    vbatches = stripe_batches(torch, rng, 3, 8, 224)
    kernel_fwd = attn_mod.flash_attention_fwd
    for pinned in (False, True):
        gen = torch.Generator(device="cuda").manual_seed(7)
        model = port.vision.VisionTransformer(depth=2, class_num=1000,
                                              device="cuda", generator=gen)
        opt = port.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                         weight_decay=0.01)
        step = port.jit.to_static(classifier_step(
            model, opt, port.nn.CrossEntropyLoss()))
        if pinned:
            attn_mod.flash_attention_fwd = (
                lambda q, k, v, causal=False: kernel_fwd(
                    q, k, v, causal, use_pallas=False))
        reset_flash_counts(flash)
        try:
            losses = [float(step(x, y)) for x, y in vbatches]
        finally:
            attn_mod.flash_attention_fwd = kernel_fwd
        vit_runs[pinned] = {"losses": losses,
                            "launches": flash_counts(flash),
                            "captures": step.captures}
        del model, opt, step
    kern, comp = vit_runs[False], vit_runs[True]
    vit_gap = max(abs(a - b) / abs(b)
                  for a, b in zip(kern["losses"], comp["losses"]))
    due = {k: len(vbatches) * 2 for k in FLASH_MARKS}
    if not (vit_gap <= 1e-5 and kern["launches"] == due
            and not any(comp["launches"].values())):
        raise AssertionError(f"vision_identity: ViT kernels against the "
                             f"composite: losses {vit_gap} (tol 1e-5), "
                             f"launches {kern['launches']} (due {due}), "
                             f"composite {comp['launches']}")
    checks, vit_flash = vit_shape_flash(torch, flash)
    gc.collect()
    torch.cuda.empty_cache()
    emit("vision_identity", resnet18=resnet_row,
         graph_break={"breaks": breaks, "warnings": warned,
                      "captures": 0, "state_gap": break_gap},
         vit={"layers": 2, "batch": 8, "dtype": "float32",
              "max_rel_loss_gap": vit_gap, "kernel": kern,
              "composite": comp},
         vit_shape_checks=checks, vit_shape_flash=vit_flash)
    return vit_flash


def kernel_shares(kernels):
    return {"conv": share(kernels, CONV_MARKS),
            "batch_norm_stats": share(kernels, WELFORD_MARKS),
            "elementwise": share(kernels, ELEMENTWISE_MARKS),
            "matmul": share(kernels, MATMUL_MARKS)}


def timed_steps(torch, step, batches):
    """Run ``step`` on each batch with CUDA events at the boundaries and no
    sync inside; returns (losses, ms of each step)."""
    events = [torch.cuda.Event(enable_timing=True)]
    events[0].record()
    losses = []
    for x, y in batches:
        losses.append(step(x, y))
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
    torch.cuda.synchronize()
    return ([float(l) for l in losses],
            [a.elapsed_time(b) for a, b in zip(events, events[1:])])


def resnet50_train_phase(torch, port):
    """PaddleClas ResNet-50 (``resnet50(num_classes=1000)``, 224x224, B=64
    a card), ``Momentum(0.025, 0.9, weight_decay=1e-4)`` and
    ``CrossEntropyLoss`` in one ``to_static`` step (examples/
    train_resnet.py's loop), synthetic stripe batches.  ResNet50.yaml's
    lr of 0.1 is for its global batch of 256 (4 cards of 64), after a
    warm-up; one card's 64 scales it to 0.025 (at 0.1 with no warm-up the
    loss rose from 7.1 to 28.8 in 10 steps).  10 steps in fp32
    (TF32 off), then 10 under ``auto_cast(level="O1", dtype="bfloat16")``
    on the same model.  Each: images/s and ms a step by CUDA events (the
    first, eager call and the capturing call apart), captures, graph
    breaks (0), peak memory, 3 eager steps of the same step function on
    the same weights (with the optimizer's share by CUDA events), and a
    profiler window over 2 captured steps (idle share; convolution,
    BatchNorm-statistics, elementwise and matrix-product shares).  Losses
    must fall.  Each run builds the model afresh from one seed."""
    rng = np.random.default_rng(40)
    ce = port.nn.CrossEntropyLoss()
    breaks = port.registry().counter("jit_graph_breaks_total", "")
    rows = {}
    for name, amp_ctx in (("fp32", None),
                          ("amp_o1_bf16", lambda: port.amp.auto_cast(
                              level="O1", dtype="bfloat16"))):
        gen = torch.Generator(device="cuda").manual_seed(41)
        model = port.vision.resnet50(num_classes=1000, device="cuda",
                                     generator=gen)
        params = sum(p.numel() for p in model.parameters())
        opt = port.Momentum(learning_rate=RESNET_LR, momentum=0.9,
                            parameters=model.parameters(),
                            weight_decay=1e-4)
        batches = stripe_batches(torch, rng, 12, RESNET_B, 224)
        step = port.jit.to_static(classifier_step(model, opt, ce, amp_ctx))
        before = breaks.value
        torch.cuda.reset_peak_memory_stats()
        losses, ms = timed_steps(torch, step, batches[:10])
        peak = torch.cuda.max_memory_allocated()
        steady = ms[2:]
        if not (np.isfinite(losses).all()
                and np.mean(losses[-3:]) < np.mean(losses[:3])):
            raise AssertionError(f"resnet50_train {name}: losses {losses} "
                                 f"are not finite or do not fall")
        if breaks.value != before or step.captures != 1:
            raise AssertionError(f"resnet50_train {name}: "
                                 f"{breaks.value - before} graph breaks, "
                                 f"{step.captures} captures")
        kernels, wall_us, _ = profile_window(
            torch, lambda: step(*batches[10]), 2)
        # the same step eagerly, with the optimizer's share by events
        eager = classifier_step(model, opt, ce, amp_ctx)
        eager(*batches[11])
        clock = StepClock(torch)
        clock.mark()
        for x, y in batches[10:12]:
            with (amp_ctx() if amp_ctx else contextlib.nullcontext()):
                loss = ce(model(x), y)
            loss.backward()
            clock.mark()
            opt.step()
            opt.clear_grad()
            clock.mark()
        eager_s, opt_s = clock.read()
        rows[name] = {
            "losses": losses, "first_call_ms": ms[0], "capture_call_ms":
            ms[1], "ms_per_step": float(np.mean(steady)),
            "ms_steps": steady,
            "images_per_s": RESNET_B / (np.mean(steady) / 1e3),
            "captures": step.captures, "graph_breaks": 0,
            "max_memory_allocated": peak,
            "eager_ms_per_step": float(np.mean(eager_s)) * 1e3,
            "eager_optimizer_ms": float(np.mean(opt_s)) * 1e3,
            "eager_optimizer_share": float(np.sum(opt_s) / np.sum(eager_s)),
            **window_summary(kernels, wall_us),
            "shares": kernel_shares(kernels)}
        del step, eager, batches, model, opt
        gc.collect()
        torch.cuda.empty_cache()
    emit("resnet50_train", model="resnet50", classes=1000, image=224,
         batch=RESNET_B,
         optimizer=f"Momentum({RESNET_LR}, 0.9, weight_decay=1e-4)",
         params=params, **rows)


def vit_flops_per_image(embed=768, depth=12, heads=12, tokens=197,
                        patches=196, patch_dim=768, classes=1000, mlp=4):
    """Forward FLOPs of one image through ViT-B/16 (2 a multiply-add): the
    patch conv, each block's QKV, scores, mix, output and MLP products, and
    the head; a training step is 3 times that."""
    block = (2 * tokens * embed * 3 * embed          # q, k, v
             + 2 * 2 * tokens * tokens * embed       # scores and mix
             + 2 * tokens * embed * embed            # output projection
             + 2 * 2 * tokens * embed * mlp * embed)  # the MLP
    return (2 * patches * patch_dim * embed + depth * block
            + 2 * embed * classes)


def vit_train_phase(torch, flash, port):
    """``vit_base_patch16_224(class_num=1000)``, B=64, AdamW (lr 1e-4, wd
    0.05), AMP O1 bf16, one ``to_static`` step, synthetic stripe batches:
    10 steps; images/s, ms a step (CUDA events), achieved TFLOP/s (3 x
    ``vit_flops_per_image`` an image), peak memory, the flash kernels'
    launches (12 layers x steps each), then a profiler window over 2
    steps: the idle share and each flash kernel's device time a launch.
    Losses must fall."""
    rng = np.random.default_rng(50)
    gen = torch.Generator(device="cuda").manual_seed(51)
    model = port.vision.vit_base_patch16_224(class_num=1000, device="cuda",
                                             generator=gen)
    opt = port.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                     weight_decay=0.05)
    step = port.jit.to_static(classifier_step(
        model, opt, port.nn.CrossEntropyLoss(),
        lambda: port.amp.auto_cast(level="O1", dtype="bfloat16")))
    batches = stripe_batches(torch, rng, 12, VIT_B, 224)
    breaks = port.registry().counter("jit_graph_breaks_total", "")
    before = breaks.value
    reset_flash_counts(flash)
    torch.cuda.reset_peak_memory_stats()
    losses, ms = timed_steps(torch, step, batches[:10])
    peak = torch.cuda.max_memory_allocated()
    launches = flash_counts(flash)
    due = {k: 12 * 10 for k in FLASH_MARKS}
    if launches != due or breaks.value != before or step.captures != 1:
        raise AssertionError(f"vit_train: launches {launches} (due {due}), "
                             f"{breaks.value - before} breaks, "
                             f"{step.captures} captures")
    if not (np.isfinite(losses).all()
            and np.mean(losses[-3:]) < np.mean(losses[:3])):
        raise AssertionError(f"vit_train: losses {losses} are not finite "
                             f"or do not fall")
    steady = float(np.mean(ms[2:]))
    flops = 3 * vit_flops_per_image() * VIT_B
    kernels, wall_us, _ = profile_window(torch, lambda: step(*batches[10]),
                                         2)
    busy = sum(kernels.values())
    flash_device_ms = {
        key: busy * (share(kernels, marks) or 0.0) / (2 * 12) / 1e3
        for key, marks in FLASH_MARKS.items()}
    emit("vit_train", model="vit_base_patch16_224", classes=1000,
         batch=VIT_B, dtype="amp_o1_bfloat16", losses=losses,
         first_call_ms=ms[0], capture_call_ms=ms[1], ms_per_step=steady,
         images_per_s=VIT_B / (steady / 1e3),
         tflops=flops / (steady / 1e3) / 1e12,
         flops_per_step=flops,
         flops_formula="3 x vit_flops_per_image x B (2 a multiply-add: "
                       "patch conv, QKV, scores, mix, out proj, MLP, head)",
         mfu=flops / (steady / 1e3) / PEAK_FLOPS["bfloat16"],
         max_memory_allocated=peak, kernel_launches=launches,
         captures=step.captures, graph_breaks=0,
         flash_device_ms=flash_device_ms,
         **window_summary(kernels, wall_us))
    del model, opt, step, batches
    gc.collect()
    torch.cuda.empty_cache()
    return launches, flash_device_ms


# --- the input pipeline and the high-level trainer -----------------------------

IMAGENET_MEAN = [0.485, 0.456, 0.406]   # ResNet50.yaml's NormalizeImage
IMAGENET_STD = [0.229, 0.224, 0.225]
FIT_B = 64                  # ResNet50.yaml's batch a card
FIT_CLASSES = 1000
FIT_PER_CLASS = 2           # images a class folder: 2000 in all
FIT_EVAL = 512              # images of the evaluate folder
FIT_IMAGE, FIT_CROP = 256, 224
FIT_VIT_STEPS = 8
FIT_WINDOW = (20, 4)        # the profiled steps of the ResNet epoch


def loader_children():
    """Live forked loader workers and this process's ring segments in
    /dev/shm (the port's rings are named ``ptt_dl_<pid>_<n>``)."""
    import multiprocessing as mp

    rings = [f for f in os.listdir("/dev/shm")
             if f.startswith(f"ptt_dl_{os.getpid()}_")]
    return [p.pid for p in mp.active_children()], rings


def loss_recorder(port):
    class Recorder(port.Callback):
        """Each step's loss and accuracy as ``fit`` logs them."""

        def __init__(self):
            super().__init__()
            self.losses, self.accs = [], []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])
            self.accs.append(logs.get("acc"))

    return Recorder()


def rel_gaps(got, want):
    return [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got, want)]


def loader_identity_phase(torch, port, dev="cuda"):
    """LeNet on the synthetic MNIST through ``Model.fit`` (1024 images, B=64,
    Adam 1e-3, shuffled, one epoch) and ``evaluate`` (256 test images):
    the port's CPU run, then the card with ``num_workers=0`` and
    ``num_workers=2`` (the ring), each from the same weights and the same
    ``np.random.seed``.  Every card loss within 1e-4 relative of the CPU
    run's, the evaluate loss too, accuracy in [0, 1].  Then
    ``Model.save`` / ``load`` into a fresh model and optimizer: every
    weight and slot bit-equal, and the next ``train_batch`` loss equal to
    the saved model's."""
    train = port.io.Subset(port.datasets.MNIST(mode="train"), range(1024))
    test = port.io.Subset(port.datasets.MNIST(mode="test"), range(256))
    state = port.models.LeNet(device="cpu", generator=torch.Generator()
                              .manual_seed(61)).state_dict()

    def run(device, workers):
        net = port.models.LeNet(device=device)
        net.load_state_dict(state)
        model = port.Model(net).prepare(
            port.Adam(learning_rate=1e-3, parameters=net.parameters()),
            port.nn.CrossEntropyLoss(), port.metric.Accuracy())
        rec = loss_recorder(port)
        np.random.seed(62)
        t0 = time.perf_counter()
        model.fit(train, batch_size=64, epochs=1, verbose=0, shuffle=True,
                  num_workers=workers, callbacks=[rec])
        fit_s = time.perf_counter() - t0
        ev = model.evaluate(test, batch_size=64, verbose=0,
                            num_workers=workers)
        return model, rec, ev, fit_s

    _, cpu, cpu_ev, _ = run("cpu", 0)
    rows, card = {}, None
    for workers in (0, 2):
        card, rec, ev, fit_s = run(dev, workers)
        gaps = rel_gaps(rec.losses, cpu.losses)
        ev_gap = rel_gaps(ev["loss"], cpu_ev["loss"])[0]
        if (len(rec.losses) != len(cpu.losses) or max(gaps) > 1e-4
                or ev_gap > 1e-4 or not 0.0 <= ev["acc"] <= 1.0):
            raise AssertionError(
                f"loader_identity workers={workers}: card losses "
                f"{rec.losses} against the CPU's {cpu.losses} (largest "
                f"gap {max(gaps, default=None)}), evaluate {ev} against "
                f"{cpu_ev}")
        rows[f"workers_{workers}"] = {
            "max_rel_loss_gap": max(gaps), "eval_rel_loss_gap": ev_gap,
            "eval": ev, "accs": rec.accs, "fit_s": fit_s}
    # save and load back into a fresh model and optimizer
    path = os.path.join(tempfile.mkdtemp(prefix="loader_identity_"), "lenet")
    try:
        card.save(path)
        net = port.models.LeNet(device=dev, generator=torch.Generator(
            device=dev).manual_seed(63))
        fresh = port.Model(net).prepare(
            port.Adam(learning_rate=1e-3, parameters=net.parameters()),
            port.nn.CrossEntropyLoss(), port.metric.Accuracy())
        fresh.load(path)
        saved_bytes = sum(os.path.getsize(path + ext)
                          for ext in (".pdparams", ".pdopt"))
    finally:
        shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    weights_equal = all(torch.equal(a, b) for a, b in zip(
        card.network.state_dict().values(), net.state_dict().values()))
    slots_a = card._optimizer.state_dict()
    slots_b = fresh._optimizer.state_dict()
    slots_equal = slots_a.keys() == slots_b.keys() and all(
        torch.equal(torch.as_tensor(slots_a[k]).cpu(),
                    torch.as_tensor(slots_b[k]).cpu())
        for k in slots_a if k != "LR_Scheduler")
    x, y = (torch.from_numpy(t).to(dev) for t in
            port.default_collate_fn([test[i] for i in range(64)]))
    next_a = card.train_batch([x], [y])[0][0]
    next_b = fresh.train_batch([x], [y])[0][0]
    if not (weights_equal and slots_equal and next_a == next_b):
        raise AssertionError(
            f"loader_identity: Model.save/load: weights equal "
            f"{weights_equal}, optimizer slots equal {slots_equal}, next "
            f"losses {next_a} and {next_b}")
    children, rings = loader_children()
    if children or rings:
        raise AssertionError(f"loader_identity: workers {children} or "
                             f"rings {rings} outlived the loaders")
    emit("loader_identity", model="LeNet", dataset="MNIST (synthetic)",
         images=len(train), batch=64, cpu_losses=cpu.losses,
         cpu_eval=cpu_ev, **rows, save_load={
             "bytes": saved_bytes, "weights_equal": weights_equal,
             "slots_equal": slots_equal, "next_loss": next_a})


def write_folder(root, rng, classes, per_class, size=256):
    """A ``DatasetFolder``: ``classes`` folders of ``per_class`` HWC uint8
    images as ``.npy``, drawn from ``rng``; returns the bytes written."""
    total = 0
    for c in range(classes):
        d = os.path.join(root, f"n{c:05d}")
        os.makedirs(d)
        imgs = rng.integers(0, 256, (per_class, size, size, 3), np.uint8)
        for i, img in enumerate(imgs):
            p = os.path.join(d, f"{i}.npy")
            np.save(p, img)
            total += os.path.getsize(p)
    return total


def counted(port, ds, counts):
    """``ds`` counting each index it serves in ``counts`` (a shared
    memory map, so the forked workers' counts reach the parent)."""
    class Counted(port.io.Dataset):
        def __len__(self):
            return len(ds)

        def __getitem__(self, i):
            counts[i] += 1
            return ds[i]

    return Counted()


def faulty(port, ds, bad):
    class Faulty(port.io.Dataset):
        def __len__(self):
            return len(ds)

        def __getitem__(self, i):
            if i in bad:
                raise ValueError(f"planted fault at sample {i}")
            return ds[i]

    return Faulty()


def fit_probe(torch, port, window=None):
    """A callback reading ``dataloader_queue_depth`` as each step begins
    (the depth the loader left when ``fit`` took the batch), the host
    clock as each step ends (``fit`` syncs on the loss), and optionally a
    torch.profiler window over steps ``window = (first, n)``."""
    from torch.profiler import ProfilerActivity, profile

    depth = port.registry().gauge("dataloader_queue_depth", "")

    class Probe(port.Callback):
        def __init__(self):
            super().__init__()
            self.depths, self.ends, self.kernels = [], [], None
            self.prof = None

        def on_train_begin(self, logs=None):
            self.start = time.perf_counter()

        def on_train_batch_begin(self, step, logs=None):
            self.depths.append(depth.value)
            if window and step == window[0]:
                torch.cuda.synchronize()
                self.prof = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
                self.prof.start()

        def on_train_batch_end(self, step, logs=None):
            self.ends.append(time.perf_counter())
            if window and step == window[0] + window[1] - 1:
                torch.cuda.synchronize()
                self.prof.stop()
                self.kernels = device_kernels(self.prof)
                self.prof = None
                self.ends[-1] = time.perf_counter()

    return Probe()


def step_ms(probe, skip=2, window=None):
    """ms of each step after the first ``skip``, the profiled ones out."""
    ends = [probe.start] + probe.ends
    ms = [(b - a) * 1e3 for a, b in zip(ends, ends[1:])]
    out = []
    for i, v in enumerate(ms):
        if i < skip or (window and window[0] <= i < window[0] + window[1]):
            continue
        out.append(v)
    return out


def copy_times(torch, batch, reps=10):
    """ms and GB/s of one batch's host-to-device copy, pinned
    (``non_blocking``) and pageable, by CUDA events."""
    out = {}
    for name, host in (("pinned", batch.pin_memory()),
                       ("pageable", batch.clone())):
        host.cuda(non_blocking=True)
        torch.cuda.synchronize()
        ms = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            host.cuda(non_blocking=True)
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        med = float(np.median(ms))
        out[name] = {"ms": med, "gb_per_s": batch.nbytes / med / 1e6}
    out["bytes"] = batch.nbytes
    return out


def resident_steps(model, x, y, n, skip=2):
    """ms of ``n - skip`` eager ``train_batch`` steps on a batch already
    on the device, after ``skip`` unmeasured (``train_batch`` syncs on its
    loss)."""
    out = []
    for i in range(n):
        t0 = time.perf_counter()
        model.train_batch([x], [y])
        if i >= skip:
            out.append((time.perf_counter() - t0) * 1e3)
    return out


def imagenet_fit_phase(torch, flash, port, dev="cuda"):
    """ResNet-50 and ViT-B/16 through ``paddle.Model.fit`` fed by the
    multi-process DataLoader over the shared-memory ring.

    An ImageNet-shaped ``DatasetFolder`` is written from a seed into a
    temporary directory (removed at the end): 1000 class folders of 2
    HWC uint8 256x256 ``.npy`` images, and a 512-image folder for
    ``evaluate``.  Train transforms are PaddleClas ResNet50.yaml's:
    ``ToTensor``, ``RandomResizedCrop(224)``, ``RandomHorizontalFlip``,
    ``Normalize`` (ImageNet's mean and std); evaluate's ``Resize(256)``,
    ``CenterCrop(224)``, ``Normalize``.  ``resnet50(num_classes=1000)``,
    ``Momentum(0.025, 0.9, weight_decay=1e-4)``, ``CrossEntropyLoss``,
    ``Accuracy``: one epoch (31 steps, B=64, fp32, eager) with
    ``num_workers=4``, ``shuffle=True``, ``drop_last=True``, then
    ``evaluate``; 6 eager ``train_batch`` steps of the same model on a
    device-resident batch beside it; ``vit_base_patch16_224`` (fp32,
    AdamW) through the same ``fit`` for 8 steps, and 3 device-resident
    steps beside it.

    Reported: images/s and ms a step of each ``fit``, the device-resident
    steps, the idle share over 4 profiled ``fit`` steps, the share of
    steps at which ``dataloader_queue_depth`` read 0, one batch's fetch
    and collate in this process, one batch's host-to-device copy
    (pinned and pageable), ``os.cpu_count()`` and ``/dev/shm``'s size.
    Gates: each index the epoch's sampler drew served exactly once and
    no other, the batches' labels in the sampler's order; ``num_workers=4``
    batches bit-equal to ``num_workers=0`` ones under the deterministic
    evaluate transforms; losses finite and evaluate's accuracy in [0, 1];
    a planted fault (a dataset raising in a worker) makes ``fit`` raise
    within 30 s; no worker process or ring segment left; 12 x 8 launches
    of each flash kernel in the ViT's ``fit``."""
    T = port.transforms
    rng = np.random.default_rng(70)
    root = tempfile.mkdtemp(prefix="imagenet_fit_")
    try:
        t0 = time.perf_counter()
        written = write_folder(os.path.join(root, "train"), rng,
                               FIT_CLASSES, FIT_PER_CLASS, FIT_IMAGE)
        written += write_folder(os.path.join(root, "eval"), rng, FIT_EVAL, 1,
                                FIT_IMAGE)
        write_s = time.perf_counter() - t0
        train_tf = T.Compose([T.ToTensor(), T.RandomResizedCrop(FIT_CROP),
                              T.RandomHorizontalFlip(),
                              T.Normalize(IMAGENET_MEAN, IMAGENET_STD)])
        eval_tf = T.Compose([T.ToTensor(), T.Resize(FIT_IMAGE),
                             T.CenterCrop(FIT_CROP),
                             T.Normalize(IMAGENET_MEAN, IMAGENET_STD)])
        train = port.datasets.DatasetFolder(os.path.join(root, "train"),
                                            transform=train_tf)
        evalset = port.datasets.DatasetFolder(os.path.join(root, "eval"),
                                              transform=eval_tf)
        row = imagenet_fit_run(torch, flash, port, root, train, evalset,
                               dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    shm = os.statvfs("/dev/shm")
    children, rings = loader_children()
    if children or rings:
        raise AssertionError(f"imagenet_fit: workers {children} or rings "
                             f"{rings} outlived the phase")
    emit("imagenet_fit", written_bytes=written, write_s=write_s,
         cpu_count=os.cpu_count(),
         dev_shm_bytes=shm.f_blocks * shm.f_frsize,
         nvidia_smi=nvidia_smi_line(), **row)
    return row["vit"]["launches"]


def imagenet_fit_run(torch, flash, port, root, train, evalset, dev):
    n = len(train)
    steps = n // FIT_B
    # the identity of the batches: the deterministic evaluate transforms
    # through 4 workers against this process, bit for bit, on the card
    same = []
    loaders = [port.io.DataLoader(evalset, batch_size=FIT_B, num_workers=w,
                                  places=dev) for w in (4, 0)]
    for a, b in zip(*loaders):
        same.append(all(torch.equal(x, y) for x, y in zip(a, b)))
    del loaders
    if len(same) != FIT_EVAL // FIT_B or not all(same):
        raise AssertionError(f"imagenet_fit: num_workers=4 batches equal to "
                             f"num_workers=0 ones: {same}")
    # one batch fetched and collated here, and its copy to the card
    np.random.seed(71)
    t0 = time.perf_counter()
    x, y = port.default_collate_fn([train[i] for i in range(FIT_B)])
    collate_ms = (time.perf_counter() - t0) * 1e3
    copy = copy_times(torch, torch.from_numpy(x))

    counts = np.memmap(os.path.join(root, "counts"), np.int32, "w+",
                       shape=(n,))
    gen = torch.Generator(device=dev).manual_seed(72)
    net = port.models.resnet50(num_classes=FIT_CLASSES, device=dev,
                               generator=gen)
    labels = []
    ce = port.nn.CrossEntropyLoss()

    def loss_fn(pred, label):
        labels.append(label)
        return ce(pred, label)

    model = port.Model(net).prepare(
        port.Momentum(learning_rate=RESNET_LR, momentum=0.9,
                      parameters=net.parameters(), weight_decay=1e-4),
        loss_fn, port.metric.Accuracy())
    probe = fit_probe(torch, port, FIT_WINDOW)
    rec = loss_recorder(port)
    np.random.seed(73)
    drawn = np.random.get_state()
    torch.cuda.reset_peak_memory_stats()
    model.fit(counted(port, train, counts), batch_size=FIT_B, epochs=1,
              num_workers=4, shuffle=True, drop_last=True, verbose=0,
              callbacks=[probe, rec])
    peak = torch.cuda.max_memory_allocated()
    # the sampler's permutation, drawn from the seeded global generator
    np.random.set_state(drawn)
    perm = np.random.permutation(n)[:steps * FIT_B]
    want = np.zeros(n, np.int32)
    want[perm] = 1
    targets = np.asarray([t for _, t in train.samples])
    got_labels = np.concatenate([t.cpu().numpy() for t in labels])
    if not (np.array_equal(np.asarray(counts), want)
            and np.array_equal(got_labels, targets[perm])):
        raise AssertionError(
            f"imagenet_fit: indices served {int(counts.sum())} times over "
            f"{int((counts > 0).sum())} samples (want each of "
            f"{steps * FIT_B} once), labels in the sampler's order: "
            f"{np.array_equal(got_labels, targets[perm])}")
    del counts
    ev = model.evaluate(evalset, batch_size=FIT_B, verbose=0, num_workers=4)
    if not (len(rec.losses) == steps and np.isfinite(rec.losses).all()
            and 0.0 <= ev["acc"] <= 1.0 and np.isfinite(ev["loss"]).all()):
        raise AssertionError(f"imagenet_fit: {len(rec.losses)} losses "
                             f"{rec.losses}, evaluate {ev}")
    fit_ms = step_ms(probe, window=FIT_WINDOW)
    starved = [d == 0 for d in probe.depths[1:]]
    busy = sum(probe.kernels.values())
    window_wall_us = float(np.mean(fit_ms)) * FIT_WINDOW[1] * 1e3
    # the same model's eager steps on a batch already on the card
    resident = resident_steps(model, torch.from_numpy(x).to(dev),
                              torch.from_numpy(y).to(dev), 8)
    resnet = {
        "model": "resnet50", "classes": FIT_CLASSES, "image": FIT_CROP,
        "batch": FIT_B,
        "optimizer": f"Momentum({RESNET_LR}, 0.9, weight_decay=1e-4)",
        "steps": steps, "losses": rec.losses, "evaluate": ev,
        "fit_ms_per_step": float(np.mean(fit_ms)), "fit_ms_steps": fit_ms,
        "fit_images_per_s": FIT_B / (np.mean(fit_ms) / 1e3),
        "resident_ms_per_step": float(np.mean(resident)),
        "resident_ms_steps": resident,
        "resident_images_per_s": FIT_B / (np.mean(resident) / 1e3),
        "loader_ms_per_step": float(np.mean(fit_ms) - np.mean(resident)),
        "starved_share": float(np.mean(starved)),
        "queue_depths": probe.depths,
        "profiled_steps": list(FIT_WINDOW),
        "window_wall_us": window_wall_us, "device_busy_us": busy,
        "idle_share": 1 - busy / window_wall_us,
        "max_memory_allocated": peak,
        "collate_ms": collate_ms, "collate_threads": torch.get_num_threads(),
        "h2d_copy": copy}
    del model, net, labels
    gc.collect()
    torch.cuda.empty_cache()
    # a planted fault: a dataset raising in a worker must fail fit fast
    bad = set(range(0, n, 50))
    net = port.models.resnet50(num_classes=FIT_CLASSES, device=dev)
    model = port.Model(net).prepare(
        port.Momentum(learning_rate=RESNET_LR, momentum=0.9,
                      parameters=net.parameters()), ce)
    t0 = time.perf_counter()
    try:
        model.fit(faulty(port, train, bad), batch_size=FIT_B, epochs=1,
                  num_workers=4, shuffle=True, drop_last=True, verbose=0)
        raised = None
    except ValueError as e:
        raised = str(e)
    fault_s = time.perf_counter() - t0
    if raised is None or "planted fault" not in raised or fault_s > 30:
        raise AssertionError(f"imagenet_fit: the planted fault raised "
                             f"{raised!r} after {fault_s} s")
    del model, net
    gc.collect()
    torch.cuda.empty_cache()
    # ViT-B/16 through the same fit, fp32, the flash kernels at D=64
    gen = torch.Generator(device=dev).manual_seed(74)
    net = port.models.vit_base_patch16_224(class_num=FIT_CLASSES, device=dev,
                                           generator=gen)
    model = port.Model(net).prepare(
        port.AdamW(learning_rate=1e-4, parameters=net.parameters(),
                   weight_decay=0.05), ce, port.metric.Accuracy())
    probe = fit_probe(torch, port)
    rec = loss_recorder(port)
    reset_flash_counts(flash)
    np.random.seed(75)
    model.fit(port.io.Subset(train, range(FIT_VIT_STEPS * FIT_B)),
              batch_size=FIT_B, epochs=1, num_workers=4, shuffle=True,
              drop_last=True, verbose=0, callbacks=[probe, rec])
    launches = flash_counts(flash)
    due = {k: 12 * FIT_VIT_STEPS for k in FLASH_MARKS}
    if launches != due or not np.isfinite(rec.losses).all():
        raise AssertionError(f"imagenet_fit vit: launches {launches} (due "
                             f"{due}), losses {rec.losses}")
    vit_ms = step_ms(probe)
    resident = resident_steps(model, torch.from_numpy(x).to(dev),
                              torch.from_numpy(y).to(dev), 5)
    vit = {"model": "vit_base_patch16_224", "dtype": "float32",
           "batch": FIT_B, "steps": FIT_VIT_STEPS, "losses": rec.losses,
           "fit_ms_per_step": float(np.mean(vit_ms)), "fit_ms_steps": vit_ms,
           "fit_images_per_s": FIT_B / (np.mean(vit_ms) / 1e3),
           "resident_ms_per_step": float(np.mean(resident)),
           "resident_ms_steps": resident,
           "starved_share": float(np.mean([d == 0
                                           for d in probe.depths[1:]])),
           "launches": launches}
    del model, net
    gc.collect()
    torch.cuda.empty_cache()
    return {"resnet50": resnet, "vit": vit,
            "batches_equal": len(same),
            "planted_fault": {"raised": raised, "seconds": fault_s}}


def main() -> int:
    try:
        import torch

        from paddle_tpu_torch import framework
        from paddle_tpu_torch import observability as obs
        from paddle_tpu_torch import serving
        from paddle_tpu_torch.serving import graphs
        from paddle_tpu_torch.models import (
            BertConfig,
            BertForQuestionAnswering,
            ErnieConfig,
            ErnieForSequenceClassification,
            GPTConfig,
            GPTForCausalLM,
            GPTPretrainingCriterion,
            LlamaConfig,
            LlamaForCausalLM,
            LlamaPretrainingCriterion,
        )
        from paddle_tpu_torch.models import gpt as gpt_mod
        from paddle_tpu_torch.nn.functional import cross_entropy
        from paddle_tpu_torch.ops import _build, flash
        from paddle_tpu_torch.ops import flash_attention as fa
        from paddle_tpu_torch.ops import paged_decode as pd
        from paddle_tpu_torch.ops import ragged_paged as rp
        from paddle_tpu_torch.ops import scaled as sc
        from paddle_tpu_torch import amp, jit
        from paddle_tpu_torch import nn as port_nn
        from paddle_tpu_torch.optimizer import Adam, AdamW, Momentum
        from paddle_tpu_torch.vision import models as vision_models
        from paddle_tpu_torch import io as port_io
        from paddle_tpu_torch import metric as port_metric
        from paddle_tpu_torch.hapi import Model
        from paddle_tpu_torch.hapi.callbacks import Callback
        from paddle_tpu_torch.io.dataloader import default_collate_fn
        from paddle_tpu_torch.vision import datasets as vision_datasets
        from paddle_tpu_torch.vision import transforms as vision_transforms
        from paddle_tpu_torch.optimizer.lr import (
            CosineAnnealingDecay,
            LinearWarmup,
            PolynomialDecay,
        )
        from paddle_tpu_torch.utils import cpp_extension
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package is not here ({e}); "
              "run from the root of a checkout", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 2
    # the plain versions are references: full fp32 products, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi_line()
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.perf_counter()
    built = [KERNEL_NAME, DECODE_NAME, FLASH_NAME, SCALED_NAME]
    # the worker processes' kernel directory (their --compile-cache): the
    # decode kernel is built there beside this build, so no fleet boot
    # waits on it; the first fleet's two workers race for the ragged
    # kernel there (one nvcc under the directory lock)
    procfleet_cache = tempfile.mkdtemp(prefix="procfleet_kernels_")
    prebuild = subprocess.Popen(
        [sys.executable, "-c",
         "import sys; from paddle_tpu_torch.ops import _build; "
         "_build.set_build_dir(sys.argv[1]); _build.build([sys.argv[2]])",
         procfleet_cache, DECODE_NAME],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    _build.build(built)
    _, prebuild_err = prebuild.communicate(timeout=900)
    if prebuild.returncode != 0:
        raise AssertionError(f"build: the decode kernel did not build in "
                             f"the workers' directory:\n{prebuild_err}")
    for name, log in _build.build_logs.items():
        print(f"--- nvcc {name} ---\n{log}", file=sys.stderr)
    # the data loader's shared-memory ring, a host library (g++)
    t1 = time.perf_counter()
    _build.load_host("shm_ring")
    emit("build", kernels=built, seconds=time.perf_counter() - t0,
         worker_directory=_build.count_libraries(procfleet_cache),
         host_libraries={"shm_ring": str(_build.host_library_path(
             "shm_ring").relative_to(_build.PACKAGE_DIR.parent)),
             "seconds": time.perf_counter() - t1})

    scaled_launches, scaled_summary = custom_op_phase(
        torch, sc, cpp_extension,
        str(_build.BUILD_DIR / "extensions"))

    summary = kernel_phase(torch, rp, flash)
    decode_summary = decode_kernel_phase(torch, pd, flash)
    model, prompts, unified_tokens = identity_phase(
        torch, rp, serving, graphs, LlamaConfig, LlamaForCausalLM)
    identity_legacy_phase(torch, pd, serving, graphs, model, prompts,
                          unified_tokens)
    # the prefill families as step programs, and AOT artifacts, on the
    # identity model
    prefill_identity_phase(torch, serving, graphs, model, prompts)
    aot_identity_phase(torch, rp, pd, serving, model, prompts)
    identity_telemetry_phase(torch, rp, pd, serving, obs, model, prompts,
                             LlamaForCausalLM)
    audit_fault_phase(torch, rp, pd, serving, obs, model)
    # the fp32 identity gates of speculative decoding, the prefill/decode
    # fleet and the server, on the identity model
    spec_prompts = spec_identity_phase(torch, rp, pd, serving, model)
    disagg_identity_phase(torch, rp, pd, serving, model, spec_prompts)
    server_identity_phase(torch, rp, pd, serving, model, spec_prompts)
    # the cross-process fleet: worker processes build the same seeded
    # model and load their kernels from one directory shared by every
    # fleet
    procfleet_identity_phase(torch, serving, model, spec_prompts, {
        "preset": "llama3_8b", "layers": model.config.num_hidden_layers,
        "dtype": "float32", "seed": 0}, procfleet_cache)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    launches, llm, prompts, warm, new_tokens, serve_warm = serve_phase(
        torch, rp, serving, graphs, LlamaConfig, LlamaForCausalLM)
    model = llm.engine.model
    vocab = model.config.vocab_size
    profile_phase(torch, serving, graphs, llm, vocab)
    serve_telemetry_phase(torch, rp, serving, graphs, obs, llm, prompts,
                          new_tokens)
    del llm   # frees the unified engine's pools; the model stays
    torch.cuda.empty_cache()
    decode_launches, llms = serve_legacy_phase(
        torch, pd, serving, graphs, model, prompts, warm, new_tokens)
    for name in llms:
        profile_phase(torch, serving, graphs, llms[name], vocab,
                      window_name=name,
                      label="decode", marks=DECODE_MARKS, new_tokens=32)
    del llms
    gc.collect()
    torch.cuda.empty_cache()
    spec_prompts = spec_phase(torch, rp, pd, serving, model)
    disagg_phase(torch, rp, pd, serving, model, spec_prompts)
    server_rows = server_phase(torch, rp, pd, serving, model, prompts,
                               serve_warm)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    # worker processes booted off an AOT artifact, and the --workers
    # fleets: the serve model's widths (seed 1, bf16) cut to FLEET_LAYERS
    # layers, the script's time limit; the artifact is saved over a model
    # of that depth, freed before the workers boot
    fleet_spec = {"preset": "llama3_8b", "layers": FLEET_LAYERS,
                  "dtype": "bfloat16", "seed": 1}
    saver = LlamaForCausalLM(
        LlamaConfig.llama3_8b(num_hidden_layers=FLEET_LAYERS),
        device="cuda", dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(1))
    saved = aot_boot_save(torch, serving, saver, prompts, fleet_spec)
    del saver
    gc.collect()
    torch.cuda.empty_cache()
    aot_boot_phase(serving, saved, fleet_spec)
    procfleet_phase(torch, serving, prompts, fleet_spec, procfleet_cache,
                    server_rows)
    shutil.rmtree(procfleet_cache, ignore_errors=True)

    flash_summary = flash_kernel_phase(torch, flash)
    port = SimpleNamespace(
        LlamaConfig=LlamaConfig, LlamaForCausalLM=LlamaForCausalLM,
        LlamaPretrainingCriterion=LlamaPretrainingCriterion, AdamW=AdamW,
        CosineAnnealingDecay=CosineAnnealingDecay)
    train_identity_phase(torch, flash, fa, port)
    train_launches, trainer = train_phase(torch, flash, fa, port)
    # the flash kernels' device time a launch, read by the profiler inside
    # a training step (a back-to-back window of the flash phase recorded
    # no flash kernel: PERF.md section 7)
    flash_device = train_profile_phase(torch, trainer)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    # GPT pre-training (MHA through the flash kernels), BERT/ERNIE
    # fine-tuning and checkpoints
    port = SimpleNamespace(
        GPTConfig=GPTConfig, GPTForCausalLM=GPTForCausalLM,
        GPTPretrainingCriterion=GPTPretrainingCriterion, gpt_mod=gpt_mod,
        BertConfig=BertConfig,
        BertForQuestionAnswering=BertForQuestionAnswering,
        ErnieConfig=ErnieConfig,
        ErnieForSequenceClassification=ErnieForSequenceClassification,
        AdamW=AdamW, LinearWarmup=LinearWarmup,
        CosineAnnealingDecay=CosineAnnealingDecay,
        PolynomialDecay=PolynomialDecay, cross_entropy=cross_entropy,
        TrainStepTelemetry=obs.TrainStepTelemetry, framework=framework)
    gpt_train_identity_phase(torch, flash, fa, port)
    gpt_launches, gpt_trainer_state = gpt_train_phase(torch, flash, fa,
                                                      port, obs)
    train_profile_phase(torch, gpt_trainer_state, label="gpt_train",
                        shape=(GPT_B, GPT_S), seed=17)
    del gpt_trainer_state
    gc.collect()
    torch.cuda.empty_cache()
    bert_finetune_phase(torch, flash, port)
    train_checkpoint_phase(torch, port)
    gc.collect()
    torch.cuda.empty_cache()
    # image classification: ResNet and ViT under jit.to_static and AMP O1
    port = SimpleNamespace(
        vision=vision_models, nn=port_nn, jit=jit, amp=amp,
        Momentum=Momentum, AdamW=AdamW, registry=obs.get_registry)
    vit_flash = vision_identity_phase(torch, flash, port)
    resnet50_train_phase(torch, port)
    vit_launches, vit_device = vit_train_phase(torch, flash, port)
    # the input pipeline and the high-level trainer: LeNet through
    # Model.fit on the card against the CPU, then ResNet-50 and ViT-B/16
    # fed by the multi-process DataLoader over the shared-memory ring
    port = SimpleNamespace(
        io=port_io, datasets=vision_datasets, transforms=vision_transforms,
        models=vision_models, Model=Model, Callback=Callback,
        metric=port_metric, nn=port_nn, Adam=Adam, AdamW=AdamW,
        Momentum=Momentum, registry=obs.get_registry,
        default_collate_fn=default_collate_fn)
    loader_identity_phase(torch, port)
    fit_launches = imagenet_fit_phase(torch, flash, port)
    flash_rows = [{
        "name": f"flash_attention_{key}", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attention.cu",
        "replaces": f"paddle_tpu/ops/pallas_flash.py:{line}",
        "launches": train_launches[key],
        "gpt_train_launches": gpt_launches[key],
        "vit_train_launches": vit_launches[key],
        "imagenet_fit_launches": fit_launches[key],
        "device_ms": flash_device[key],
        "vit_train_device_ms": vit_device[key],
        "vit_shape": vit_flash[key],
        **{f: flash_summary[key][f] for f in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}}
        for key, line in (("fwd", 52), ("dq", 153), ("dkv", 195))]

    print(json.dumps({"kernels": [{
        "name": KERNEL_NAME, "route": "cuda",
        "source": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "paddle_tpu/ops/ragged_paged.py:111",
        "launches": launches, "max_abs_err": summary["max_abs_err"],
        "ms": summary["ms"], "device_ms": summary["device_ms"],
        "plain_ms": summary["plain_ms"],
        "bound_ms": summary["bound_ms"], "bound_by": summary["bound_by"],
        "library_ms": summary["library_ms"]}, {
        "name": DECODE_NAME, "route": "cuda",
        "source": "paddle_tpu_torch/csrc/paged_decode_attention.cu",
        "replaces": "paddle_tpu/ops/pallas_paged.py:45",
        "launches": decode_launches,
        "max_abs_err": decode_summary["max_abs_err"],
        "ms": decode_summary["ms"], "device_ms": decode_summary["device_ms"],
        "plain_ms": decode_summary["plain_ms"],
        "bound_ms": decode_summary["bound_ms"],
        "bound_by": decode_summary["bound_by"],
        "library_ms": decode_summary["library_ms"]}, *flash_rows, {
        "name": SCALED_NAME, "route": "cuda",
        "source": "paddle_tpu_torch/csrc/scaled.cu",
        "replaces": "paddle_tpu/utils/extension.py:18",
        "launches": scaled_launches,
        **{f: scaled_summary[f] for f in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "device_ms", "library_device_ms")}}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
