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
             auditor at ``sample_every=1`` in fp32 and 4 in bf16, a
             metrics history with the
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
             invariant.  Then a profile window (16 new tokens) on the
             burst-free engine: the decode kernel's, the matrix products'
             and the idle shares.
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
             the max_seq_len the server rounds need; the rounds take the
             serve prompts of at most 1024 tokens): 2
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
``mp_collectives``  the first of three phases run by rank processes that
             the port's ``distributed.spawn`` starts (each loads the flash
             kernels this process built; none runs nvcc): 2 ranks at
             mp=2, or 4 at dp2 x mp2 where 4 cards are present; each rank
             takes its own card over NCCL where the cards number at least
             the ranks, else the ranks share ``cuda:0`` over gloo, chosen
             explicitly (each line prints ``backend`` and ``cards``).
             Every collective the mp layers and DataParallel issue
             (all_reduce sum and max, async, bf16, all_gather,
             broadcast) on the rank's card against values worked out on
             the CPU from every rank's seeded inputs, then each timed at
             the mp_train activation's shape ([2*4096, 4096] bf16).
``mp_identity``  ``train_identity``'s model (Llama-3-8B widths, 2 layers,
             fp32, B=1, S=1024) run here at mp=1 and by the ranks at mp=2
             from the same seeded full weights: 3 AdamW steps with
             global-norm clipping; the losses within 1e-4 relative, the
             gathered first-step logits within 1e-4 of their largest
             entry, each rank's flash kernels launched steps x layers
             times on its own 16 query and 4 KV heads.
``mp_train``  the train phase's model, seed and batches (Llama-3-8B full
             width cut to 4 layers, bf16, B=2, S=4096) at mp=2 (dp2 x mp2
             on 4 cards), each rank building only its slices: 1 warm-up
             and 2 timed steps, then one step with every collective
             synchronised and timed: ms a step, tokens/s, each rank's
             peak memory, the collectives' calls and bytes a step and
             their share of the timed step, each rank's flash launches
             (steps x layers, on the tma route); the first loss within 1%
             of the train phase's.
``mp_serve_shape``  B1 and B2 against their twins row by row at a rank's
             shapes at mp=2 (16 query and 4 KV heads of 128, 16-token
             pages): the kernels phase's packings (T = 8 .. 512) and the
             decode_kernels phase's batches (B = 1, 4, 16 of up to 2112
             tokens), bf16 on the tma / mma routes and fp32 on the simple
             ones, each with a planted fault run through the kernel (B1
             short of each chunk walk's last page, B2 of each row's last
             span) that must read above tolerance; B1's grids
             (``launch_shape``) at 16 / 4 heads.
``mp_serve_identity``  tensor-parallel serving in 2 rank processes
             (the port's ``spawn``, gloo on this card; rank 0 the
             controller, rank 1 its follower): the identity model (fp32)
             and its 8 prompts at mp=2 through the unified step, the legacy
             families and the legacy families with bursts of 8: tokens
             equal to this process's mp=1 ``identity`` / ``identity_legacy``
             tokens, bucket sets equal to theirs, no capture, each launch's
             sampled tokens equal on both ranks, each rank's launches =
             its steps x layers on the simple routes and 2L+1 all-reduces
             and one all-gather a forward; the prompts' top-2 logit gaps;
             then rank 1 is killed with SIGKILL mid-run and the
             controller's next step must raise within the group's
             timeout.
``mp_serve``  Llama-3-8B widths cut to ``FLEET_LAYERS`` layers, bf16, the
             serve phase's 16 prompts and 64 greedy tokens, unified, at
             mp=2 on the same ranks: tokens/s, mean TTFT and ITL, each
             rank's peak memory, the launch and collective rules (ragged on
             tma), the collectives' share of a short window with each
             synchronised and timed, a legacy pass with bursts of 8
             (decode on mma); the first prompt's first 512 tokens through
             the dense-cache route within 2e-2 of their largest logit
             against rank 0's whole model of the same weights, and the
             tokens matching that whole model's mp=1 run before their
             first divergence.
``mp_server``  ``python -m paddle_tpu_torch.serving.server --mp 2`` (the
             CLI's toy model): ``/readyz`` ``ok dp=1 mp=2``, completions
             token-equal to the same engine at mp=2 in the ranks,
             ``/metrics`` with ``serving_mp_shards 2`` and the collective
             series, SIGTERM to exit 0 (the controller joins its follower).
``mp_fleet_identity``  dp x mp in the same 2 ranks: two replicas of the
             identity model, each on an mp group and a gloo control group
             of its own (``serving.tp.replica_groups``), rank 0 the
             controller of both behind one ``FleetRouter`` (a replica cap
             of 4, so the 8 prompts that share one affinity key reach
             both), rank 1 following each replica on a thread of its
             own: tokens equal to mp=1's, each rank's ragged launches =
             both replicas' forwards x layers (simple route), 2L+1
             all-reduces and one all-gather a forward, the pool invariant
             on every rank of every replica, no capture.
``mp_disagg_identity``  a prefill and a decode replica at mp=2: one
             hand-off a request, each served from its run (0 recomputed
             tokens), tokens equal to mp=1's, the launch rule on every
             rank; one 1024-token hand-off by part (gather, copy, the
             follower's slice gathered, digest; verify, pool import, the
             slices scattered, the pools), beside the same hand-off
             between two mp=1 engines; a run with a flipped byte refused
             before any pool changes; the mp=2 run imported into an mp=1
             engine on rank 0 after the world, continuing
             token-identically with every block served from it.
``mp_procfleet``  ``--workers 2 --mp 2``: two worker processes, each the
             controller of a world of 2 ranks over gloo on this card,
             Llama-3-8B widths cut to ``FLEET_LAYERS`` layers, bf16, the
             serve prompts behind the router with the supervisor on:
             tokens/s, mean TTFT and ITL, each worker's boot, each rank's
             peak memory and launch rule over the wire (``describe``);
             then one worker's follower killed by SIGKILL mid-wave: the
             worker fails, the supervisor respawns a fresh world, no
             request is lost, no process of the killed world is left.
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
``rnn_identity``  fp32, TF32 off, the card against the port's CPU run:
             2-layer bidirectional ``LSTM``, ``GRU``, ``SimpleRNN`` at H=64
             (outputs within 1e-5, gradients within 1e-5 of their largest
             entries); PaddleNLP's seq2seq attention model at H=64, B=8 on
             ``text.WMT16``, 5 Adam steps under
             ``ClipGradByGlobalNorm(0.5)``, each step's global norm above
             0.5 (it clips), losses within 1e-4 relative, then beam search
             (K=4) token-identical, and on a table cell with ties (K = 1,
             3, 4); the step under ``jit.to_static``
             against eager within 1e-5, 1 capture, 0 graph breaks; a
             planted failed capture falls back to eager within 1e-5.
``seq2seq_train``  the seq2seq model at its README's widths (512, 2
             layers, B=128, dropout 0.2, init_scale 0.1, Adam 1e-3,
             ``ClipGradByGlobalNorm(5.0)``), fp32, fed ``text.WMT16``
             (vocabularies 4000, length 16) through the port's
             ``DataLoader``: eager steps (the clip-plus-optimizer share
             by CUDA events), then ``to_static`` (1 capture, 0 breaks),
             ms a step and target tokens/s for both, peak memory, a
             profiled window's idle share, the global norms; beside it the
             encoder's forward and backward through ``torch.nn.LSTM``
             (cuDNN), which the port never calls.
``seq2seq_decode``  the trained model, ``BeamSearchDecoder(beam_size=10)``
             through ``dynamic_decode`` (32 steps at most) over 128 test
             sentences: ms a decode, steps, sentences/s, host reads (the
             synchronising calls ``set_sync_debug_mode("warn")`` reports:
             one a step); again with the model's initial weights, whose
             beams run all 32 steps.  Each decode's first 32 sentences
             held on the CPU: every beam's score against its
             teacher-forced log-probability (within 4e-6 of its size),
             tokens after an end token, beams in order, each best beam
             no worse than the CPU search's.  These three phases reach no
             kernel of the repo: every kernel's launch count must be
             unchanged across them.
``jit_export``  ``jit.save`` of ViT-B/16 (224, bf16, eval) and
             MobileNetV3-Large (224, fp32, eval) at ``InputSpec([64, 3,
             224, 224])``; a fresh process loads both with ``jit.load``
             alone (no model class) and runs each 23 times: outputs
             against the saving process's eager ones (fp32 within 1e-5,
             bf16 within 2e-2 of the largest logit; bit equality
             reported), the loaded ViT's flash forward launches = calls x
             12 and its graph's 12 ``paddle_tpu_torch::flash_fwd`` ops, no
             call of the twin; save and load seconds, the files' bytes, ms
             a batch and images/s loaded, eager and captured.
``jit_partial``  ``to_static`` over MobileNetV3-Large eval (B=64) behind
             ``if float(x.max()) > 1.0: x = x / 255.0``: one graph break
             naming its line, one trace of two segments, each a captured
             CUDA graph, the Python body run once in 4 calls, outputs equal
             to eager; a batch in [0, 1] records a second trace; a train
             step with ``backward`` and a host read goes eager with the
             warning; the same function over ViT-B/16 launches the flash
             forward calls x 12 times across replays; ms a call replayed,
             eager and captured whole.
``vision_zoo``  the model zoo's other families at full width (VGG-11-BN,
             MobileNetV1/V2/V3-Large/V3-Small, AlexNet, SqueezeNet 1.1,
             DenseNet-121, GoogLeNet, InceptionV3, ShuffleNetV2 x1.0), one
             forward and backward at B=2, 224, eval, on the card against
             the CPU from the same weights (outputs 1e-4 of the largest,
             gradients 1e-2 in norm); a captured Momentum train step of
             VGG-16 and MobileNetV2 at B=64 fp32: ms a step, images/s.
             These three phases launch no kernel but the flash forward.
``amp_o2_identity``  GPT at 6.7B widths cut to 2 layers, built in fp32
             from one seed and put through ``amp.decorate(level="O2")``,
             B=1, S=1024, 3 AdamW steps under ``auto_cast(level="O2")``
             through the kernels, with attention pinned to the composite,
             and with a planted fault (the attention output's last 64 rows
             zeroed): the kernel run's losses within 2 bf16 ulps of the
             composite's and its first step's attention outputs row by row
             within 2e-2 (the planted run must fail that gate), B3-B5 3 x 2
             launches each (none pinned), ``low_precision_op_list`` equal on
             all three runs and to the CPU test's dict at this depth.
``amp_o2``   gpt_train's configuration built in fp32 and trained at O2:
             ms a step, tokens/s, MFU, peak memory, the optimizer's share,
             beside the bf16-built gpt_train of the same run; B3-B5 (warm +
             timed) x layers launches on route tma with no copy; falling
             losses.  ResNet-50 at O2 in one ``to_static`` step: 10
             captured steps beside resnet50_train's O1, the profiler
             window's shares (fp32 elementwise among them), the BatchNorm
             output dtype (bf16, the JAX O2 rule), 0 graph breaks.
``tensor_api``  every case of the CPU parity test
             (``tests/torch_tensor_cases.py``) on the card against the
             port's own CPU call (TF32 off; rtol 1e-5 / atol 1e-6, integer
             and bool exact); the op bus on the card (a subscriber sees
             every op, a planted NaN raises naming its op, the NaN check in
             a captured ``to_static`` step neither syncs nor raises,
             ``low_precision_op_list`` at O1 and O2 as on the CPU); the
             bus's host cost, the median of 10^4 calls, of
             ``paddle_tpu_torch.add`` against ``torch.add``.
``profile_ops``  a 2-layer bf16 unified engine with ``profile_ops=True``
             and without on the same prompts: "Host operator summary" in
             ``eng.metrics.summary()``, the op timer released after each
             step, the same tokens and ragged-kernel launches.
``budget``   the sequence-model phases' and the later phases' seconds
             (the three mp phases', the mp_serve phases' and
             mp_procfleet's too) beside the script's.

Then a line ``{"kernels": [...]}`` summarising each kernel at its main
path's shapes (the ragged kernel at the unified serve step, the decode
kernel at B=16 bf16, the flash kernels at the train shape in bf16, the
scale kernel at [8192, 4096] bf16, with the launches of the serve, the
burst-free serve_legacy, the train and the custom_op runs; the flash rows
add ``gpt_train_launches``, ``vit_train_launches``,
``imagenet_fit_launches``, ``vit_train_device_ms`` and ``vit_shape``, their times and errors at ViT-B/16's shape, and the
forward row ``jit_export_launches`` (the loaded ViT's, in its own
process) and ``jit_partial_launches``, ``amp_o2_launches``, and each
rank's ``mp_identity_launches`` and ``mp_train_launches``; the ragged
and decode rows each rank's ``mp_serve_identity_launches``,
``mp_serve_launches``, ``mp_fleet_identity_launches`` and
``mp_disagg_identity_launches`` (both replicas on the rank), each worker
rank's ``mp_procfleet_launches`` and their ``mp_shape`` errors; the ragged row
``profile_ops_launches``; every row adds ``seq2seq_launches``
and ``vision_zoo_launches``, 0), the
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
    return model, prompts, kern["tokens"], [list(b) for b in kern["buckets"]]


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
    mp1 = {name: (r[run]["tokens"], sorted(
        list(b) for sets in r[run]["buckets"].values() for b in sets))
        for name, run in (("legacy", "kernel"), ("legacy_burst8", "burst"))}
    emit("identity_legacy", layers=layers, dtype="float32",
         prefill_budget=budget, greedy_identical=True,
         burst_identical=True, graphs_identical=True,
         sampled_graphs_identical=True,
         tokens_agreeing_with_unified=agree,
         tokens_total=sum(map(len, unified_tokens)),
         **{name: {k: v for k, v in x.items() if k != "tokens"}
            for name, x in r.items()})
    return mp1


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


def serve_prompts(vocab):
    """The serve phases' 16 prompts of 256-2048 tokens, and the generator
    that drew them (the serve phase draws on from it)."""
    rng = np.random.default_rng(2)
    return rng, [rng.integers(0, vocab, int(rng.integers(256, 2049)))
                 .tolist() for _ in range(16)]


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
    rng, prompts = serve_prompts(cfg.vocab_size)
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
# identity_telemetry's auditor: every step in fp32, every 4th in bf16
AUDIT_EVERY = {"float32": 1, "bfloat16": 4}
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
                    # the bf16 runs audit every 4th step: the shadow
                    # re-execution of every step cost 15-18 s a run there
                    fields = (dict(audit=obs.AuditConfig(
                        enabled=True, sample_every=AUDIT_EVERY[dtype]))
                        if tele == "on" else TELEMETRY_OFF)
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


TRAIN_LAYERS, TRAIN_SEED = 4, 4   # the train phase's depth and weights


def llama_model(torch, port, layers, dtype, seed):
    """Llama-3-8B's widths cut to ``layers``, drawn from a generator seeded
    ``seed`` on this process's card: at mp > 1 each rank keeps its slices
    of the same full tensors (one full tensor at a time)."""
    device = torch.device("cuda", torch.cuda.current_device())
    cfg = port.LlamaConfig.llama3_8b(num_hidden_layers=layers)
    gen = torch.Generator(device=device).manual_seed(seed)
    return cfg, port.LlamaForCausalLM(cfg, device=device, dtype=dtype,
                                      generator=gen)


def train_batches(torch, n):
    """The train phase's first ``n`` batches of the synthetic corpus
    (B=2, S=4096), on this process's card."""
    rng = np.random.default_rng(0)
    return [torch.from_numpy(corpus(rng, TRAIN_B, TRAIN_S)).cuda()
            for _ in range(n)]


def train_optimizer(port, model):
    """The train phase's AdamW with fp32 master weights under its cosine
    schedule: (schedule, optimizer)."""
    sched = port.CosineAnnealingDecay(1e-4, T_max=10)
    return sched, port.AdamW(learning_rate=sched,
                             parameters=model.parameters(),
                             weight_decay=0.01, multi_precision=True)


def train_first_loss(torch, port):
    """The train phase's first loss (its model on its first batch, before
    any update) computed alone: what mp_train's first loss is held to when
    the mp phases run without the train phase."""
    cfg, model = llama_model(torch, port, TRAIN_LAYERS, torch.bfloat16,
                             TRAIN_SEED)
    ids, = train_batches(torch, 1)
    with torch.no_grad():
        loss = float(port.LlamaPretrainingCriterion(cfg)(model(ids), ids))
    del model
    free(torch)
    return loss


def train_phase(torch, flash, fa, port):
    """The main path: Llama-3-8B at full width cut to 4 layers, bf16
    parameters, AdamW with fp32 master weights under a cosine schedule, B=2
    and S=4096 on the synthetic corpus; 2 warm-up steps, then 8 timed."""
    layers, warm, timed = TRAIN_LAYERS, 2, 8
    B, S = TRAIN_B, TRAIN_S
    t0 = time.perf_counter()
    cfg, model = llama_model(torch, port, layers, torch.bfloat16, TRAIN_SEED)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    criterion = port.LlamaPretrainingCriterion(cfg)
    sched, opt = train_optimizer(port, model)
    batches = train_batches(torch, warm + timed)
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
    return launches, (model, criterion, opt, sched), losses


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


# --- tensor- and data-parallel training (mp_collectives, mp_identity,
# --- mp_train) -----------------------------------------------------------------

# mp_identity's run, and mp_train's steps at the train phase's model,
# seed and batches (2 warm-up, then 2 timed)
MP_IDENTITY = dict(layers=2, B=1, S=1024, steps=3, seed=3, clip=1.0)
MP_TRAIN = dict(warm=1, timed=2)
MP_DEGREE = 2
# the Llama-3-8B activation of the train phase's batch: [B*S, hidden]
MP_ACTIVATION = (TRAIN_B * TRAIN_S, 4096)


def mp_identity_reference(torch, port, ref_path):
    """mp_identity's mp=1 run in this process: fp32, 3 AdamW steps with
    global-norm clipping from the seeded weights; the first step's logits
    go to ``ref_path`` for the ranks."""
    p = MP_IDENTITY
    cfg, model = llama_model(torch, port, p["layers"], torch.float32,
                             p["seed"])
    opt = port.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                     weight_decay=0.01,
                     grad_clip=port.ClipGradByGlobalNorm(p["clip"]))
    crit = port.LlamaPretrainingCriterion(cfg)
    rng = np.random.default_rng(6)
    batches = [torch.from_numpy(corpus(rng, p["B"], p["S"])).cuda()
               for _ in range(p["steps"])]
    losses, norm = [], None
    for i, ids in enumerate(batches):
        logits = model(ids)
        loss = crit(logits, ids)
        loss.backward()
        if i == 0:
            np.save(ref_path, logits.detach().float().cpu().numpy())
            norm = float(torch.sqrt(sum(
                torch.sum(q.grad.float() ** 2) for q in model.parameters())))
        del logits
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    del model, opt
    free(torch)
    return {"losses": losses, "first_grad_norm": norm,
            "clip_norm": p["clip"]}


def mp_collectives_rank(torch, dist):
    """Every collective the mp layers and DataParallel issue, on the rank's
    device at the world's size, against values worked out on the CPU from
    every rank's seeded inputs; then each timed at the mp_train
    activation's shape (``[B*S, hidden]`` bf16)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    dev = dist.env.rank_device()
    shape = (256, 128)

    def inputs(r):
        g = np.random.default_rng(1000 + r)
        return g.standard_normal(shape).astype(np.float32)

    every = np.stack([inputs(r) for r in range(world)])
    mine = torch.from_numpy(every[rank]).to(dev)
    checks = {}

    def check(name, got, want):
        err = float(np.abs(got.float().cpu().numpy() - want).max())
        if err > 1e-5 * max(1.0, float(np.abs(want).max())):
            raise AssertionError(f"mp_collectives: {name} on rank {rank} "
                                 f"is off by {err}")
        checks[name] = err

    t = mine.clone()
    dist.all_reduce(t)
    check("all_reduce_sum", t, every.sum(0))
    t = mine.clone()
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    check("all_reduce_max", t, every.max(0))
    t = mine.clone()
    dist.all_reduce(t, sync_op=False).wait()     # DataParallel's buckets
    check("all_reduce_async", t, every.sum(0))
    parts = []
    dist.all_gather(parts, mine)
    check("all_gather", torch.cat(parts, -1), np.concatenate(every, -1))
    t = mine.clone()
    dist.broadcast(t, src=world - 1)
    check("broadcast", t, every[-1])
    b16 = mine.to(torch.bfloat16)
    t = b16.clone()
    dist.all_reduce(t)
    want = sum(e.astype(np.float32) for e in
               (torch.from_numpy(x).to(torch.bfloat16).float().numpy()
                for x in every))
    err = float(np.abs(t.float().cpu().numpy() - want).max())
    if err > 2e-2 * float(np.abs(want).max()):
        raise AssertionError(f"mp_collectives: bf16 all_reduce off by {err}")
    checks["all_reduce_bf16"] = err
    # each at the mp_train activation's shape, bf16
    big = torch.ones(MP_ACTIVATION, dtype=torch.bfloat16, device=dev)
    times = {}
    for name, run in (("all_reduce", lambda: dist.all_reduce(big.clone())),
                      ("all_gather", lambda: dist.all_gather([], big)),
                      ("broadcast", lambda: dist.broadcast(big, 0))):
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) / 3 * 1e3
    return {"checks": checks, "ms": times,
            "bytes": big.numel() * big.element_size()}


def mp_flash_launches(flash):
    return {"fwd": flash.fwd_launches, "dq": flash.dq_launches,
            "dkv": flash.dkv_launches, "copy": flash.copy_launches,
            "route": flash.last_route}


def mp_reset_flash(flash):
    reset_flash_counts(flash)
    flash.copy_launches = 0
    flash.last_route = None


def mp_dp_half(ids, hcg):
    """This dp rank's rows of a global batch."""
    dp, n = hcg.get_data_parallel_rank(), hcg.get_data_parallel_world_size()
    per = ids.shape[0] // n
    return ids[dp * per:(dp + 1) * per]


def mp_mean_loss(torch, dist, loss, hcg):
    """The loss over the global batch: the mean of the dp ranks' means."""
    t = loss.detach().float().clone()
    dist.all_reduce(t, group=hcg.get_data_parallel_group())
    return float(t) / hcg.get_data_parallel_world_size()


def mp_identity_rank(torch, dist, port, flash, spec):
    """mp_identity on this rank: the mp=1 run's model, weights and batches
    at mp=2 (each dp replica the same batch), 3 AdamW steps with the clip;
    rank 0 holds the gathered first-step logits to the mp=1 ones."""
    p = MP_IDENTITY
    hcg = port.topology.get_hybrid_communicate_group()
    cfg, model = llama_model(torch, port, p["layers"], torch.float32,
                             p["seed"])
    heads = (model.llama.layers[0].self_attn.num_heads,
             model.llama.layers[0].self_attn.num_kv_heads)
    net = (port.DataParallel(model) if hcg.get_data_parallel_world_size() > 1
           else model)
    opt = port.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                     weight_decay=0.01,
                     grad_clip=port.ClipGradByGlobalNorm(p["clip"]))
    crit = port.LlamaPretrainingCriterion(cfg)
    rng = np.random.default_rng(6)
    batches = [torch.from_numpy(corpus(rng, p["B"], p["S"])).cuda()
               for _ in range(p["steps"])]
    mp_reset_flash(flash)
    losses, logit_err, step_s = [], None, []
    t0 = time.perf_counter()
    for i, ids in enumerate(batches):
        t1 = time.perf_counter()
        logits = net(ids)
        loss = crit(logits, ids)
        loss.backward()
        if i == 0 and dist.get_rank() == 0:
            ref = np.load(spec["ref_logits"], mmap_mode="r")
            got = logits.detach().float().cpu().numpy()
            logit_err = float(np.abs(got - ref).max() / np.abs(ref).max())
        del logits
        opt.step()
        opt.clear_grad()
        losses.append(mp_mean_loss(torch, dist, loss, hcg))
        step_s.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = mp_flash_launches(flash)
    del net, model, opt
    free(torch)
    return {"losses": losses, "logit_err": logit_err, "launches": launches,
            "local_heads": heads, "seconds": seconds, "step_s": step_s}


def mp_train_rank(torch, dist, port, flash, collective):
    """mp_train on this rank: the train phase's model, seed and batches at
    mp=2 (dp2 x mp2 on 4 cards), bf16 with fp32 masters, AdamW under the
    cosine schedule; warm-up steps, timed steps, then one step with every
    collective synchronised and timed (the collectives' share)."""
    p = MP_TRAIN
    hcg = port.topology.get_hybrid_communicate_group()
    t0 = time.perf_counter()
    cfg, model = llama_model(torch, port, TRAIN_LAYERS, torch.bfloat16,
                             TRAIN_SEED)
    build_s = time.perf_counter() - t0
    net = (port.DataParallel(model) if hcg.get_data_parallel_world_size() > 1
           else model)
    sched, opt = train_optimizer(port, model)
    crit = port.LlamaPretrainingCriterion(cfg)
    steps = p["warm"] + p["timed"] + 1
    batches = [mp_dp_half(ids, hcg) for ids in train_batches(torch, steps)]

    def step(ids):
        loss = crit(net(ids), ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        return loss

    sync = torch.cuda.synchronize
    mp_reset_flash(flash)
    losses = [step(ids) for ids in batches[:p["warm"]]]
    sync()
    torch.cuda.reset_peak_memory_stats()
    collective.reset_stats()
    t0 = time.perf_counter()
    losses += [step(ids) for ids in batches[p["warm"]:-1]]
    sync()
    wall = time.perf_counter() - t0
    per_step = {k: {op: v / p["timed"] for op, v in c.items()}
                for k, c in collective.stats.items() if k != "seconds"}
    collective.reset_stats()
    sync()
    t0 = time.perf_counter()
    with collective.timed():
        losses.append(step(batches[-1]))
        sync()
    profiled = time.perf_counter() - t0
    coll_s = sum(collective.stats["seconds"].values())
    launches = mp_flash_launches(flash)
    losses = [mp_mean_loss(torch, dist, x, hcg) for x in losses]
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(q.numel() for q in model.parameters())
    del net, model, opt
    free(torch)
    tokens = TRAIN_B * TRAIN_S * p["timed"]
    return {"losses": losses, "ms_per_step": wall / p["timed"] * 1e3,
            "tokens_per_s": tokens / wall, "launches": launches,
            "peak_memory_allocated": peak, "model_build_s": build_s,
            "local_params": n_params, "collectives_per_step": per_step,
            "profiled_step_ms": profiled * 1e3,
            "collective_ms": {k: v * 1e3 for k, v in
                              collective.stats["seconds"].items()},
            "collective_share": coll_s / profiled, "steps": steps}


def mp_rank_main(spec):
    """One rank of the three mp phases, started by the port's ``spawn``:
    it joins the process group on the backend the parent chose, lays the
    ranks out at dp x mp=2, loads the flash kernels the parent built
    (``_build`` finds their libraries; no nvcc runs here) and writes its
    results to ``{out}/rank{r}.json``."""
    t_entry = time.perf_counter()
    import torch

    from paddle_tpu_torch import convert, distributed as dist
    from paddle_tpu_torch.distributed import collective, topology
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM, \
        LlamaPretrainingCriterion
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops import _build, flash
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import CosineAnnealingDecay

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_parallel_env(backend=spec["backend"])
    rank = dist.get_rank()
    prebuilt = _build.library_path(FLASH_NAME).exists()
    port = SimpleNamespace(
        LlamaConfig=LlamaConfig, LlamaForCausalLM=LlamaForCausalLM,
        LlamaPretrainingCriterion=LlamaPretrainingCriterion, AdamW=AdamW,
        CosineAnnealingDecay=CosineAnnealingDecay,
        ClipGradByGlobalNorm=ClipGradByGlobalNorm, topology=topology,
        DataParallel=dist.DataParallel, convert=convert)
    out = {"rank": rank, "backend": dist.get_backend(),
           "device": str(dist.env.rank_device()), "prebuilt": prebuilt,
           "start_s": time.perf_counter() - t_entry}
    t0 = time.perf_counter()
    out["collectives"] = mp_collectives_rank(torch, dist)
    out["collectives"]["seconds"] = time.perf_counter() - t0
    topology.init_mesh(dp=dist.get_world_size() // MP_DEGREE, mp=MP_DEGREE)
    t0 = time.perf_counter()
    out["identity"] = mp_identity_rank(torch, dist, port, flash, spec)
    out["identity"]["phase_s"] = time.perf_counter() - t0
    dist.barrier()
    t0 = time.perf_counter()
    out["train"] = mp_train_rank(torch, dist, port, flash, collective)
    out["train"]["phase_s"] = time.perf_counter() - t0
    out["built_here"] = sorted(_build.build_logs)
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def mp_shape_flash_check(torch, flash):
    """The three flash kernels against their twins at the shapes an mp=2
    rank gives them: its 16 query and 4 KV heads of 128, causal, at
    mp_train's (B=2, S=4096, bf16, on the tma route; dp2 x mp2 gives a rank
    B=1 of the same rows) and at mp_identity's (B=1, S=1024, fp32, on the
    fma route).  Every row must hold its tolerance and the planted fault
    (each output's last 64-row tile zeroed) must fail.  Returns each
    kernel's errors by dtype."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    H, Hkv, D = 32 // MP_DEGREE, 8 // MP_DEGREE, 128
    checks, errors = [], {k: {} for k in FLASH_MARKS}
    for dtype, B, S, route in ((torch.bfloat16, TRAIN_B, TRAIN_S, "tma"),
                               (torch.float32, MP_IDENTITY["B"],
                                MP_IDENTITY["S"], "fma")):
        q, k, v, do = (torch.randn(B, S, n, D, device=dev, generator=gen)
                       .to(dtype) for n in (H, Hkv, Hkv, H))
        copies = flash.copy_launches
        rec, _, _ = flash_check(torch, flash,
                                f"mp rank shape {(B, S, H, Hkv)}", q, k, v,
                                do, True, plant=True)
        routed = {"copies": flash.copy_launches - copies,
                  "route": flash.last_route}
        if routed != {"copies": 0, "route": route}:
            raise AssertionError(f"mp_shape_flash: {dtype} took {routed}, "
                                 f"due 0 copies on route {route!r}")
        name = str(dtype).split(".")[-1]
        checks.append({"case": f"mp rank shape {(B, S, S, H, Hkv, D)} "
                               f"causal=True", "dtype": name, **routed,
                       **{f: rec[f] for f in ("row", "abs", "lse", "tol",
                                              "planted")}})
        for key in errors:
            errors[key][name] = {"max_abs_err": kernel_err(rec, "abs", key),
                                 "max_row_err": kernel_err(rec, "row", key)}
        del q, k, v, do, rec
        free(torch)
    emit("mp_shape_flash", checks=checks)
    return errors


def mp_phases(torch, flash, port, train_loss0):
    """mp_collectives, mp_identity and mp_train: the flash kernels against
    their twins at a rank's shapes and the mp=1 identity run here, then one
    world of ranks through the port's ``spawn`` running the three phases;
    each phase's line from the ranks' results.  Where the cards number at
    least the world, each rank takes its own card over NCCL; otherwise the
    ranks share ``cuda:0`` over gloo, chosen explicitly.  Returns each
    rank's flash launches of each phase, and the kernels' errors at the
    rank's shapes."""
    from paddle_tpu_torch.distributed.spawn import spawn

    shape_errors = mp_shape_flash_check(torch, flash)
    cards = torch.cuda.device_count()
    world = 2 * MP_DEGREE if cards >= 2 * MP_DEGREE else MP_DEGREE
    backend = "nccl" if cards >= world else "gloo"
    dp = world // MP_DEGREE
    out = tempfile.mkdtemp(prefix="mp_phases_")
    try:
        t0 = time.perf_counter()
        ref = mp_identity_reference(torch, port,
                                    os.path.join(out, "ref_logits.npy"))
        ref_s = time.perf_counter() - t0
        spec = {"out": out, "backend": backend,
                "ref_logits": os.path.join(out, "ref_logits.npy")}
        t0 = time.perf_counter()
        spawn(mp_rank_main, args=(spec,), nprocs=world, backend=backend,
              pg_timeout=300, timeout=900)
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(world):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    where = dict(backend=backend, cards=cards, world=world, dp=dp,
                 mp=MP_DEGREE, devices=[r["device"] for r in ranks])
    if any(r["backend"] != backend for r in ranks) or not all(
            r["prebuilt"] and not r["built_here"] for r in ranks):
        raise AssertionError(f"mp: the ranks ran "
                             f"{[r['backend'] for r in ranks]}"
                             f" (chose {backend}) or built kernels "
                             f"themselves: {ranks}")
    emit("mp_collectives", **where,
         checks={r["rank"]: r["collectives"]["checks"] for r in ranks},
         ms={r["rank"]: r["collectives"]["ms"] for r in ranks},
         timed_bytes=ranks[0]["collectives"]["bytes"],
         seconds=ranks[0]["collectives"]["seconds"],
         rank_start_s={r["rank"]: r["start_s"] for r in ranks})

    p = MP_IDENTITY
    due = p["steps"] * p["layers"]
    for r in ranks:
        got = r["identity"]
        rel = max(abs(a - b) / abs(b) for a, b in
                  zip(got["losses"], ref["losses"]))
        kern = {k: got["launches"][k] for k in ("fwd", "dq", "dkv")}
        if not (np.isfinite(got["losses"]).all() and rel <= 1e-4):
            raise AssertionError(f"mp_identity: rank {r['rank']} losses "
                                 f"{got['losses']} against mp=1 "
                                 f"{ref['losses']} (rel {rel})")
        if kern != {k: due for k in kern}:
            raise AssertionError(f"mp_identity: rank {r['rank']} launched "
                                 f"{kern}, due {due} each")
        got["max_rel_loss_diff"] = rel
    err = ranks[0]["identity"]["logit_err"]
    if not err <= 1e-4:
        raise AssertionError(f"mp_identity: gathered logits off by {err} of "
                             f"their largest entry")
    emit("mp_identity", **where, layers=p["layers"], dtype="float32",
         batch=p["B"], seq=p["S"], steps=p["steps"], clip_norm=p["clip"],
         mp1=dict(ref, seconds=ref_s), logit_err=err,
         ranks={r["rank"]: r["identity"] for r in ranks})

    p = MP_TRAIN
    due = ranks[0]["train"]["steps"] * TRAIN_LAYERS
    for r in ranks:
        got = r["train"]
        kern = {k: got["launches"][k] for k in ("fwd", "dq", "dkv")}
        route_ok = (got["launches"]["route"] == "tma"
                    and got["launches"]["copy"] == 0)
        if kern != {k: due for k in kern} or not route_ok:
            raise AssertionError(f"mp_train: rank {r['rank']} launched "
                                 f"{got['launches']}, due {due} each on "
                                 f"the tma route")
    first = ranks[0]["train"]["losses"][0]
    rel = abs(first - train_loss0) / abs(train_loss0)
    if not (np.isfinite(ranks[0]["train"]["losses"]).all() and rel <= 0.01):
        raise AssertionError(f"mp_train: first loss {first} against the "
                             f"train phase's {train_loss0} (rel {rel})")
    emit("mp_train", **where, model="llama3_8b", layers=TRAIN_LAYERS,
         dtype="bfloat16", batch=TRAIN_B, seq=TRAIN_S,
         warmup_steps=p["warm"], timed_steps=p["timed"],
         profiled_steps=1, first_loss_vs_train=rel,
         train_first_loss=train_loss0,
         ranks={r["rank"]: r["train"] for r in ranks},
         spawn_s=spawn_s,
         note="collective_share: one more step with every collective "
              "synchronised before and after and timed on the host clock, "
              "over that step's wall time")
    return {"identity": {r["rank"]: r["identity"]["launches"]
                         for r in ranks},
            "train": {r["rank"]: r["train"]["launches"] for r in ranks},
            "shape": shape_errors}


# --- tensor-parallel serving: mp=2 ranks over gloo on one card ---------------

# a rank's query heads, KV heads and head dim at Llama-3-8B widths and mp=2
MP_SERVE_HEADS = (32 // MP_DEGREE, 8 // MP_DEGREE, 128)
MP_SERVE_TIMEOUT = 120     # seconds a collective of the serving ranks waits
MP_SERVE_SHORT = (4, 256, 8)   # the share window: prompts, tokens, new tokens
# the CLI's completions of mp_server (its toy model: tests' tiny Llama)
MP_SERVER_BODIES = [([5, 9, 23, 7], 8), ([1, 2, 3, 4, 5, 6, 7, 8, 9], 8),
                    ([200, 17, 64], 8)]


def mp_serve_shape_phase(torch, rp, pd, flash):
    """B1 and B2 against their twins row by row at a rank's shapes at mp=2
    (16 query and 4 KV heads of 128): the kernels phase's packings (T = 8
    .. 512 tokens, decode rows and chunks, 16-token pages) and the
    decode_kernels phase's batches (B = 1, 4, 16 rows of up to 2112
    tokens), bf16 on the tma / mma routes and fp32 on the simple routes.
    Each kernel also runs a planted fault that must read above tolerance:
    B1 with each chunk token's walk short of its last page, B2 with each
    row's walk short of its last span.  Returns each kernel's errors by
    dtype and the B1 grids ``launch_shape`` gave."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(21)
    H, Hkv, D = MP_SERVE_HEADS
    bs = 16
    checks, grids = [], {}
    errors = {"ragged": {}, "decode": {}}

    def hold(kernel, label, out, ref, dtype, route, last_route,
             planted=None):
        torch.cuda.synchronize()
        err = float((out.float() - ref).abs().max())
        row = flash.rowwise_error(out, ref)
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        name = str(dtype).split(".")[-1]
        if not (err <= tol and row <= tol and last_route == route
                and torch.isfinite(out.float()).all()):
            raise AssertionError(f"mp_serve_shape: {kernel} {label} {name}: "
                                 f"max abs err {err}, row err {row} (tol "
                                 f"{tol}), route {last_route} (due {route})")
        rec = {"kernel": kernel, "case": label, "dtype": name, "route": route,
               "max_abs_err": err, "max_row_err": row, "tol": tol}
        if planted is not None:
            rec["planted_row_err"] = flash.rowwise_error(planted, ref)
            if not rec["planted_row_err"] > tol:
                raise AssertionError(f"mp_serve_shape: the planted {kernel} "
                                     f"fault passed at {label} {name}: "
                                     f"{rec}")
        checks.append(rec)
        e = errors[kernel].setdefault(name, {"max_abs_err": 0.0,
                                             "max_row_err": 0.0})
        e["max_abs_err"] = max(e["max_abs_err"], err)
        e["max_row_err"] = max(e["max_row_err"], row)

    W, num_blocks = 64, 4096
    k32 = torch.randn(num_blocks, bs, Hkv, D, device=dev)
    v32 = torch.randn(num_blocks, bs, Hkv, D, device=dev)
    shapes = {8: (8, []), 64: (32, [29]), 256: (16, [120, 119]),
              512: (16, [248, 247])}   # Tb: (decode rows, chunk sizes)
    for Tb, (n_decode, chunks) in shapes.items():
        arrays = packing(rng, Tb, n_decode, chunks, W, bs, num_blocks)
        meta = [torch.from_numpy(a).to(dev) for a in arrays]
        q32 = torch.randn(Tb, H, D, device=dev)
        grids[Tb] = rp.launch_shape(Tb, H, Hkv, D, pd.sm_count(dev))
        for dtype, route in ((torch.bfloat16, "tma"),
                             (torch.float32, "simple")):
            q, k, v = (t.to(dtype) for t in (q32, k32, v32))
            out = rp.ragged_kernel(q, k, v, *meta)
            way = rp.last_route
            ref = rp.ragged_reference(q.float(), k.float(), v.float(), *meta)
            bad = None
            if chunks:
                pos = dropped_last_page(
                    arrays[3], arrays[2],
                    range(n_decode, n_decode + len(chunks)), bs)
                bad = rp.ragged_kernel(q, k, v, *meta[:3],
                                       torch.from_numpy(pos).to(dev))
            hold("ragged", f"T={Tb} decode={n_decode} chunks={chunks}", out,
                 ref, dtype, route, way, bad)
            del q, k, v, out, ref, bad
    del k32, v32
    W, max_len = 256, 2112
    span = pd.span_tokens(bs)
    num_blocks = 16 * (max_len // bs) + 1
    k32 = torch.randn(num_blocks, bs, Hkv, D, device=dev)
    v32 = torch.randn(num_blocks, bs, Hkv, D, device=dev)
    for B in (1, 4, 16):
        lens = rng.integers(1, max_len + 1, B).astype(np.int32)
        tables = torch.from_numpy(decode_tables(rng, lens, W, bs,
                                                num_blocks)).to(dev)
        lens_t = torch.from_numpy(lens).to(dev)
        cut = torch.clamp((lens_t - 1) // span * span, min=1).int()
        q32 = torch.randn(B, H, D, device=dev)
        for dtype, route in ((torch.bfloat16, "mma"),
                             (torch.float32, "simple")):
            q, k, v = (t.to(dtype) for t in (q32, k32, v32))
            out = pd.decode_kernel(q, k, v, tables, lens_t)
            way = pd.last_route
            ref = pd.decode_reference(q.float(), k.float(), v.float(),
                                      tables, lens_t)
            # rows of one span have nothing to drop
            bad = (pd.decode_kernel(q, k, v, tables, cut)
                   if int(lens.max()) > span else None)
            hold("decode", f"B={B} lens<={max_len}", out, ref, dtype, route,
                 way, bad)
            del q, k, v, out, ref, bad
    del k32, v32
    free(torch)
    emit("mp_serve_shape", heads={"q": H, "kv": Hkv, "head_dim": D},
         block_size=bs, checks=checks,
         ragged_launch_shape={str(t): g for t, g in grids.items()},
         note="each output row against its twin's row "
              "(flash.rowwise_error); the planted faults run the kernels "
              "on shortened walks and must read above tolerance")
    return errors


def mp_serve_counts(rp, pd, collective):
    """Zero the kernel wrappers' and the collectives' counters."""
    rp.launches = rp.simple_launches = rp.tma_launches = 0
    pd.launches = pd.simple_launches = pd.mma_launches = 0
    collective.reset_stats()


def mp_serve_rule(label, eng, layers, rp, pd, collective, ragged_route,
                  decode_route):
    """This rank's launches and collectives of the run since
    :func:`mp_serve_counts`, held to its forwards: the ragged kernel once a
    layer a ragged step, the decode kernel once a layer a decode step or
    burst iteration, each on its route; 2L+1 all-reduces and one
    all-gather a forward."""
    prog = eng.tp.programs
    due = {"ragged": prog["ragged"] * layers,
           "decode": (prog["decode"] + prog["burst"]) * layers}
    got = {"ragged": rp.launches, "decode": pd.launches,
           "ragged_routes": {"simple": rp.simple_launches,
                             "tma": rp.tma_launches},
           "decode_routes": {"simple": pd.simple_launches,
                             "mma": pd.mma_launches}}
    calls = dict(collective.stats["calls"])
    fwd = eng.tp.forwards
    want_calls = {"all_reduce": fwd * (2 * layers + 1), "all_gather": fwd}
    ok = (got["ragged"] == due["ragged"] and got["decode"] == due["decode"]
          and (not due["ragged"]
               or got["ragged_routes"][ragged_route] == due["ragged"])
          and (not due["decode"]
               or got["decode_routes"][decode_route] == due["decode"])
          and calls == want_calls and fwd > 0)
    if not ok:
        raise AssertionError(f"{label}: launches {got}, due {due} (routes "
                             f"{ragged_route} / {decode_route}); collectives "
                             f"{calls}, due {want_calls}")
    return {"launches": {"ragged": got["ragged"], "decode": got["decode"]},
            "programs": dict(prog), "collectives": calls}


def mp_serve_record(eng, sampled):
    """Read each of ``eng``'s launches' sampled tokens back into
    ``sampled``."""
    run = eng.graphs.run

    def recorded(*args, **kw):
        out = run(*args, **kw)
        sampled.append(out[0].cpu().tolist())
        return out

    eng.graphs.run = recorded


def mp_serve_follow(eng, sampled=None):
    """A follower's side of one run: launch the controller's steps, each
    launch's sampled tokens read back into ``sampled`` when given."""
    from paddle_tpu_torch.serving.tp import follow

    if sampled is not None:
        mp_serve_record(eng, sampled)
    follow(eng)


def mp_serve_identity_rank(torch, port, rp, pd, collective, spec, rank):
    """mp_serve_identity on this rank: the identity model at mp=2 through
    the unified step, the legacy families and the legacy families with
    bursts of 8, each launch's sampled tokens kept on both ranks; then the
    top-2 gaps of the prompts' first tokens."""
    serving = port.serving
    cfg = port.LlamaConfig.llama3_8b(num_hidden_layers=2)
    layers = cfg.num_hidden_layers
    model = port.LlamaForCausalLM(
        cfg, device="cuda", dtype=torch.float32,
        generator=torch.Generator(device="cuda").manual_seed(0))
    prompts = spec["identity_prompts"]
    need = sum(-(-(len(p) + 16) // 16) for p in prompts) + 1
    sched = dict(max_num_seqs=8)
    configs = {
        "unified": dict(unified_step=True, scheduler=serving.SchedulerConfig(
            max_tokens_per_step=256, **sched)),
        "legacy": dict(scheduler=serving.SchedulerConfig(
            max_prefill_tokens_per_step=256, **sched)),
        "legacy_burst8": dict(burst_steps=8, scheduler=serving.SchedulerConfig(
            max_prefill_tokens_per_step=256, **sched)),
    }
    out = {}
    for name, fields in configs.items():
        eng = serving.EngineCore(model, config=serving.EngineConfig(
            num_blocks=need + 16, block_size=16, **fields))
        mp_serve_counts(rp, pd, collective)
        sampled = []
        t0 = time.perf_counter()
        row = {}
        if eng.tp.is_controller:
            mp_serve_record(eng, sampled)
            reqs = [eng.add_request(p, serving.SamplingParams(
                max_new_tokens=16)) for p in prompts]
            eng.run(max_steps=2000)
            eng.tp.release()
            row.update(
                tokens=[list(r.output_tokens) for r in reqs],
                buckets=sorted(list(b) for b in (
                    eng.ragged_buckets | eng.decode_buckets
                    | eng.prefill_buckets | eng.burst_buckets)),
                traces=(eng.prefill_trace_count + eng.decode_trace_count
                        + eng.ragged_trace_count + eng.burst_trace_count),
                bursts=int(eng._burst_counters["launches"].value),
                occupancy=eng.kv.occupancy(),
                metrics=eng.metrics.prometheus_text())
        else:
            mp_serve_follow(eng, sampled)
        torch.cuda.synchronize()
        route = "simple"   # fp32
        row.update(mp_serve_rule(f"mp_serve_identity {name} rank {rank}",
                                 eng, layers, rp, pd, collective, route,
                                 route),
                   seconds=time.perf_counter() - t0, sampled=sampled,
                   captures=eng.graphs.captures,
                   eager_reason=eng.graphs.eager_reason,
                   pool_shape=list(eng._k_pools[0].shape))
        out[name] = row
        del eng
    gaps = []
    for p in prompts:
        with torch.no_grad():
            logits = model(torch.tensor([p], device="cuda"))[0, -1].float()
        top = torch.topk(logits, 2).values
        gaps.append(float(top[0] - top[1]))
    out["top2_gap_first_tokens"] = gaps
    del model
    free(torch)
    return out


def mp_serve_rank(torch, port, rp, pd, collective, spec, rank,
                  layers=None):
    """mp_serve on this rank: Llama-3-8B widths at ``layers`` (default
    FLEET_LAYERS), bf16, the
    serve phase's prompts through the unified step (timed), a window with
    every collective synchronised and timed, a legacy pass with bursts of
    8 (the decode kernel's mma route at mp=2), and the first prompt's
    first 512 tokens through the dense-cache route (kept on rank 0)."""
    serving = port.serving
    layers = layers or FLEET_LAYERS
    cfg = port.LlamaConfig.llama3_8b(num_hidden_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    model = port.LlamaForCausalLM(
        cfg, device="cuda", dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(1))
    prompts = spec["serve_prompts"]
    new_tokens = 64
    need = sum(-(-(len(p) + new_tokens) // 16) for p in prompts) + 1
    llm = serving.LLM(model, config=serving.EngineConfig(
        num_blocks=need + 16, block_size=16, dtype=torch.bfloat16,
        unified_step=True, scheduler=serving.SchedulerConfig(
            max_num_seqs=16, max_tokens_per_step=512)))
    eng = llm.engine
    mp_serve_counts(rp, pd, collective)
    m = eng.metrics
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = llm.generate(prompts, serving.SamplingParams(
        max_new_tokens=new_tokens))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {"seconds": wall,
           "output_tokens_per_s": sum(len(o.token_ids) for o in outs) / wall,
           "rule": mp_serve_rule(f"mp_serve rank {rank}", eng, layers, rp,
                                 pd, collective, "tma", "mma"),
           "steps": eng.tp.forwards}
    if eng.tp.is_controller:
        ttft, itl = (m.histogram(n) for n in ("time_to_first_token",
                                              "inter_token_latency"))
        out.update(tokens=[o.token_ids for o in outs],
                   mean_ttft_s=ttft.sum / ttft.count,
                   mean_itl_s=itl.sum / itl.count,
                   unified_step_mean_ms=1e3 * m.histogram(
                       "unified_step").sum / m.histogram("unified_step").count,
                   collective_seconds_count=m._collective["ragged"].count)
    # the collectives' share: a short window with each collective
    # synchronised before and after and timed on the host clock
    n, length, short_new = MP_SERVE_SHORT
    short = [p[:length] for p in prompts[:n]]
    s0 = sum(collective.stats["seconds"].values())
    with collective.timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        llm.generate(short, serving.SamplingParams(max_new_tokens=short_new))
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    coll = sum(collective.stats["seconds"].values()) - s0
    out["share_window"] = {"seconds": window, "collective_seconds": coll,
                           "collective_share": coll / window,
                           "prompts": n, "prompt_tokens": length,
                           "new_tokens": short_new}
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    del llm, eng
    # the legacy families with bursts of 8: the decode kernel on the
    # rank's heads on its mma route
    legacy = serving.LLM(model, config=serving.EngineConfig(
        num_blocks=need + 16, block_size=16, dtype=torch.bfloat16,
        burst_steps=8, scheduler=serving.SchedulerConfig(
            max_num_seqs=4, max_prefill_tokens_per_step=512)))
    mp_serve_counts(rp, pd, collective)
    louts = legacy.generate(short, serving.SamplingParams(max_new_tokens=32))
    torch.cuda.synchronize()
    out["legacy_burst8"] = {
        "rule": mp_serve_rule(f"mp_serve legacy_burst8 rank {rank}",
                              legacy.engine, layers, rp, pd, collective,
                              "tma", "mma"),
        "tokens": [o.token_ids for o in louts]}
    del legacy
    # the first step's logits through the dense-cache route
    ids = torch.tensor([prompts[0][:512]], device="cuda")
    heads = model.llama.layers[0].self_attn.num_kv_heads
    shape = (1, ids.shape[1], heads, cfg.head_dim)
    caches = [(torch.zeros(shape, dtype=torch.bfloat16, device="cuda"),
               torch.zeros(shape, dtype=torch.bfloat16, device="cuda"))
              for _ in range(layers)]
    with torch.no_grad():
        logits = model(ids, caches=caches, pos=0)[0].float()
    del model, caches
    free(torch)
    return out, logits


def mp_serve_whole(torch, port, spec, logits):
    """Rank 0 alone after the world: the same seeded weights whole (mp=1)
    on this card, its dense-cache logits of mp_serve's first step against
    the ranks' (held within 2e-2 of their largest entry), the serve
    prompts through an mp=1 unified engine for the token comparison (its
    tokens/s: that pass takes the captures), and a pass over fresh prompts
    of the same lengths (replays only)."""
    serving = port.serving
    cfg = port.LlamaConfig.llama3_8b(num_hidden_layers=FLEET_LAYERS)
    model = port.LlamaForCausalLM(
        cfg, device="cuda", dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(1))
    prompts = spec["serve_prompts"]
    ids = torch.tensor([prompts[0][:512]], device="cuda")
    shape = (1, ids.shape[1], cfg.num_key_value_heads, cfg.head_dim)
    caches = [(torch.zeros(shape, dtype=torch.bfloat16, device="cuda"),
               torch.zeros(shape, dtype=torch.bfloat16, device="cuda"))
              for _ in range(cfg.num_hidden_layers)]
    with torch.no_grad():
        ref = model(ids, caches=caches, pos=0)[0].float()
    err = float((logits - ref).abs().max() / ref.abs().max())
    del caches, ref
    need = sum(-(-(len(p) + 64) // 16) for p in prompts) + 1
    llm = serving.LLM(model, config=serving.EngineConfig(
        num_blocks=need + 16, block_size=16, dtype=torch.bfloat16,
        unified_step=True, scheduler=serving.SchedulerConfig(
            max_num_seqs=16, max_tokens_per_step=512)))
    rates = {}
    for name, batch in (("cold", prompts), ("warm", same_lengths(
            np.random.default_rng(5), prompts, cfg.vocab_size))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = llm.generate(batch, serving.SamplingParams(max_new_tokens=64))
        torch.cuda.synchronize()
        rates[name] = sum(len(o.token_ids) for o in outs) / (
            time.perf_counter() - t0)
        if name == "cold":
            tokens = [o.token_ids for o in outs]
    del llm, model
    free(torch)
    return {"first_step_logit_err": err, "tokens": tokens,
            "mp1_output_tokens_per_s": rates}


def mp_serve_toy(port, spec):
    """The CLI's model and engine (``serving.server._toy_model`` /
    ``_toy_engine`` at the CLI's --layers 2 --blocks 64 --unified) at
    mp=2, the mp_server completions one after another."""
    from paddle_tpu_torch.serving.server import _toy_engine, _toy_model

    eng = _toy_engine(_toy_model(2), num_blocks=64, unified=True)
    tokens = None
    if eng.tp.is_controller:
        tokens = []
        for prompt, n in MP_SERVER_BODIES:
            req = eng.add_request(prompt, port.serving.SamplingParams(
                max_new_tokens=n))
            eng.run(max_steps=1000)
            tokens.append(list(req.output_tokens))
        eng.tp.release()
    else:
        mp_serve_follow(eng)
    return eng, tokens


# --- dp x mp serving: replicas spanning the 2 ranks, over gloo on one card ---

MP_FLEET_REPLICAS = 2
MP_FLEET_QUEUE = 4        # per-replica in-flight cap: the 8 identity prompts
                          # share one affinity key, the cap spills 4 over
MP_HANDOFF_TOKENS = 1024  # the timed hand-off's prompt (64 pages of 16)
MP_HANDOFF_NEW = 16


def mp_fleet_models(torch, port, groups):
    """The identity model (seed 0, fp32, 2 layers at Llama-3-8B widths), one
    a replica, each built inside its replica's groups: the fleet's and the
    prefill/decode fleet's replicas serve these two."""
    from paddle_tpu_torch.serving import tp

    cfg = port.LlamaConfig.llama3_8b(num_hidden_layers=2)
    models = []
    for g in groups:
        with tp.replica(g):
            models.append(port.LlamaForCausalLM(
                cfg, device="cuda", dtype=torch.float32,
                generator=torch.Generator(device="cuda").manual_seed(0)))
    return models


def mp_fleet_factory(serving, groups, models, roles, need):
    """The replicas' ``ReplicaFactory``: replica ``i`` an identity engine on
    ``models[i]`` in role ``roles[i]`` (the identity phase's engine), on
    ``groups[i]``."""
    from paddle_tpu_torch.serving import tp

    def build(i, registry=None):
        return serving.EngineCore(models[i], config=serving.EngineConfig(
            num_blocks=need + 16, block_size=16, unified_step=True,
            role=roles[i], scheduler=serving.SchedulerConfig(
                max_num_seqs=8, max_tokens_per_step=256)),
            registry=registry, metrics_labels={"replica": str(i)})

    return tp.ReplicaFactory(groups, build)


def mp_fleet_rule(label, engines, rp, pd, collective):
    """A rank's launches and collectives since :func:`mp_serve_counts`,
    held to the forwards of every replica on it: the ragged kernel once a
    layer a unified step (all on the simple route, fp32), no decode
    launch, 2L+1 all-reduces and one all-gather a forward."""
    layers = engines[0].model.config.num_hidden_layers
    fwd = sum(e.tp.forwards for e in engines)
    due = sum(e.tp.programs["ragged"] for e in engines) * layers
    calls = dict(collective.stats["calls"])
    want = {"all_reduce": fwd * (2 * layers + 1), "all_gather": fwd}
    if not (rp.launches == rp.simple_launches == due and due > 0
            and pd.launches == 0 and calls == want):
        raise AssertionError(
            f"{label}: ragged {rp.launches} (simple {rp.simple_launches}), "
            f"decode {pd.launches} for {due} ragged due; collectives "
            f"{calls}, due {want}")
    return {"launches": {"ragged": rp.launches, "decode": pd.launches},
            "forwards": [e.tp.forwards for e in engines],
            "collectives": calls}


def mp_fleet_pools(label, engines):
    """Each replica's pool invariant on this rank, and no capture."""
    for i, e in enumerate(engines):
        pool_invariant(f"{label} replica {i}", e)
        if e.graphs.captures:
            raise AssertionError(f"{label}: replica {i} captured")


def mp_fleet_serve(serving, factory, prompts, roles, max_queue):
    """The controller's fleet of the factory's replicas on ``prompts``
    (16 greedy tokens each); returns the finished handles, the router and
    the engines (released: their followers' loops ended)."""
    fleet = serving.FleetRouter.build(
        factory, dp=MP_FLEET_REPLICAS, config=serving.FleetConfig(
            max_queue=max_queue, roles=roles))
    fleet.start()
    try:
        hs = [fleet.submit_request(p, serving.SamplingParams(
            max_new_tokens=16), request_id=f"m{i}")
            for i, p in enumerate(prompts)]
        fleet.wait(hs, timeout=600)
    finally:
        fleet.shutdown(drain_timeout=60.0)
    for e in fleet.engines:
        e.tp.release()
    return hs, fleet


def mp_handoff_timed(torch, serving, donor, recipient, prompt):
    """One hand-off of ``prompt``'s prefill from ``donor`` to ``recipient``
    by part (the parts' seconds from ``handoff``'s timings, the device
    synchronised after each); then the donor's request decoded to
    MP_HANDOFF_NEW tokens.  Returns the run, the first token, the
    donor's tokens and the parts' ms."""
    from paddle_tpu_torch.serving import handoff

    req = donor.add_request(prompt, serving.SamplingParams(
        max_new_tokens=MP_HANDOFF_NEW), request_id="timed")
    while not req.output_tokens:
        donor.step()
    torch.cuda.synchronize()
    export, imported = {}, {}
    run = handoff.export_request_run(donor, "timed", timings=export)
    resume = [int(t) for t in req.output_tokens]
    placed = handoff.import_run(recipient, run, timings=imported)
    donor.run(max_steps=2000)
    if placed != len(run["blocks"]):
        raise AssertionError(f"mp hand-off: {placed} of "
                             f"{len(run['blocks'])} blocks placed")
    ms = {f"export_{k[:-2]}": 1e3 * v for k, v in export.items()}
    ms.update({f"import_{k[:-2]}": 1e3 * v for k, v in imported.items()})
    return run, resume, [int(t) for t in req.output_tokens], {
        "prompt_tokens": len(prompt), "blocks": len(run["blocks"]),
        "bytes": int(run["payload"].nbytes), "ms": ms,
        "total_ms": sum(ms.values())}


def mp_fleet_rank(torch, port, rp, pd, collective, spec, rank):
    """mp_fleet_identity and mp_disagg_identity on this rank of the mp=2
    world: two replicas of the identity model spanning both ranks, rank 0
    the controller of both and rank 1 following each on its own thread;
    first a fleet of two unified replicas on the identity prompts, then a
    prefill and a decode replica (every request handed off), then one
    timed hand-off of a 1024-token prompt between the replicas' engines
    and a run with a flipped byte refused.  Returns this rank's rows and,
    on rank 0, the timed run for the mp=1 import."""
    from paddle_tpu_torch.serving import handoff, tp

    serving = port.serving
    prompts = spec["identity_prompts"]
    need = sum(-(-(len(p) + 16) // 16) for p in prompts) + 1
    need += -(-(MP_HANDOFF_TOKENS + MP_HANDOFF_NEW) // 16) * 2
    groups = tp.replica_groups(MP_FLEET_REPLICAS)
    models = mp_fleet_models(torch, port, groups)
    out, keep = {}, {}
    for name, roles, cap in (
            ("fleet", ["unified", "unified"], MP_FLEET_QUEUE),
            ("disagg", ["prefill", "decode"], 64)):
        factory = mp_fleet_factory(serving, groups, models, roles, need)
        mp_serve_counts(rp, pd, collective)
        t0 = time.perf_counter()
        row = {}
        if rank == 0:
            hs, fleet = mp_fleet_serve(serving, factory, prompts, roles,
                                       cap)
            engines = fleet.engines
            row.update(tokens=[list(h.output_tokens) for h in hs],
                       finish=[h.finish_reason for h in hs],
                       replicas=[h.replica.index for h in hs],
                       occupancy=[e.kv.occupancy() for e in engines])
            if name == "disagg":
                snap = fleet.registry.snapshot()
                events = {h.rid: e for h in hs for e in
                          fleet.lifecycle.get(h.rid).to_dict()["events"]
                          if e["name"] == "kv_handoff"}
                att = engines[1].cachestat.attribution()
                cached = {r["id"]: r["cached_tokens"]
                          for r in att["active"] + att["recent"]}
                row.update(
                    handoffs=snap["serving_handoff_total"]["value"],
                    blocks_each=[e["blocks"] for e in events.values()],
                    cached_each=[cached.get(str(rid), 0)
                                 for rid in events])
        else:
            tp.follow_replicas([factory(i) for i in
                                range(MP_FLEET_REPLICAS)], factory)
            engines = [factory.built[i] for i in range(MP_FLEET_REPLICAS)]
        torch.cuda.synchronize()
        row["seconds"] = time.perf_counter() - t0
        row["rule"] = mp_fleet_rule(f"mp_{name} rank {rank}", engines, rp,
                                    pd, collective)
        mp_fleet_pools(f"mp_{name} rank {rank}", engines)
        out[name] = row
        if name == "fleet":
            del engines, factory
            continue
        # the replicas' engines, each rank's control loop alive again: a
        # timed hand-off, then a flipped byte refused before any pool
        # changes, then the same run imported
        factory = mp_fleet_factory(serving, groups, models, roles, need)
        if rank:
            tp.follow_replicas([factory(i) for i in
                                range(MP_FLEET_REPLICAS)], factory)
        else:
            donor, recipient = (factory(i) for i in range(2))
            prompt = np.random.default_rng(23).integers(
                0, donor.model.config.vocab_size,
                MP_HANDOFF_TOKENS).tolist()
            run, resume, tokens, parts = mp_handoff_timed(
                torch, serving, donor, recipient, prompt)
            keep.update(run=run, resume=resume, tokens=tokens, prompt=prompt)
            req = donor.add_request(prompt[:512][::-1], serving.SamplingParams(
                max_new_tokens=2), request_id="bad")
            while not req.output_tokens:
                donor.step()
            bad = handoff.export_request_run(donor, "bad")
            donor.run(max_steps=2000)
            before = mp_pool_sum(recipient)
            payload = np.array(bad["payload"])
            payload.reshape(-1).view(np.uint8)[11] ^= 0x20
            try:
                recipient.import_kv_run(dict(bad, payload=payload))
                refused = None
            except handoff.HandoffError as e:
                refused = str(e)
            unchanged = mp_pool_sum(recipient) == before
            placed = recipient.import_kv_run(bad)
            out["handoff"] = dict(parts, refused=refused,
                                  unchanged=unchanged,
                                  placed_after=placed, tokens=tokens)
            for e in (donor, recipient):
                e.tp.release()
            del donor, recipient
        torch.cuda.synchronize()
        del engines, factory
    del models
    free(torch)
    return out, keep


def mp_pool_sum(eng):
    """A checksum of this rank's pools of ``eng``."""
    return float(sum(p.double().abs().sum() for p in
                     eng._k_pools + eng._v_pools))


def mp_fleet_mp1(torch, port, keep):
    """Rank 0 alone after the world: the timed run (exported at mp=2)
    imported into an mp=1 engine of the identity model, continuing from
    its first token; and the same hand-off at mp=1, by part."""
    serving = port.serving
    cfg = port.LlamaConfig.llama3_8b(num_hidden_layers=2)
    model = port.LlamaForCausalLM(
        cfg, device="cuda", dtype=torch.float32,
        generator=torch.Generator(device="cuda").manual_seed(0))
    blocks = -(-(MP_HANDOFF_TOKENS + MP_HANDOFF_NEW) // 16) * 2 + 2

    def engine():
        return serving.EngineCore(model, config=serving.EngineConfig(
            num_blocks=blocks, block_size=16, unified_step=True,
            scheduler=serving.SchedulerConfig(max_num_seqs=8,
                                              max_tokens_per_step=256)))

    eng = engine()
    placed = eng.import_kv_run(keep["run"])
    req = eng.add_request(keep["prompt"], serving.SamplingParams(
        max_new_tokens=MP_HANDOFF_NEW), request_id="imported",
        resume_tokens=keep["resume"])
    eng.run(max_steps=2000)
    att = eng.cachestat.attribution()
    cached = [r["cached_tokens"] for r in att["active"] + att["recent"]
              if r["id"] == "imported"]
    row = {"placed": placed, "blocks": len(keep["run"]["blocks"]),
           "cached_tokens": cached[0] if cached else 0,
           "tokens_equal_mp2_donor": [int(t) for t in req.output_tokens]
           == keep["tokens"]}
    _, _, _, row["mp1_parts"] = mp_handoff_timed(torch, serving, engine(),
                                                 engine(), keep["prompt"])
    del eng, model
    free(torch)
    return row


def mp_serve_rank_main(spec):
    """One rank of the tensor-parallel serving phases, started by the
    port's ``spawn`` (2 ranks over gloo on one card): it loads the kernels
    the parent built, runs mp_serve_identity, mp_serve, the dp x mp
    replicas (mp_fleet_rank) and the CLI model, writes
    ``{out}/serve_rank{r}.json``, and ends with the follower-death check:
    rank 1 launches three of the controller's steps and kills itself;
    rank 0 times how long its next step takes to raise, then runs the
    whole model alone (mp_serve_whole, and the mp=2 run's import at mp=1)
    and writes its results again."""
    t_entry = time.perf_counter()
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.distributed import collective, topology
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import paged_decode as pd
    from paddle_tpu_torch.ops import ragged_paged as rp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_parallel_env(backend="gloo")
    rank = dist.get_rank()
    topology.init_mesh(mp=MP_DEGREE)
    prebuilt = all(_build.library_path(n).exists()
                   for n in (KERNEL_NAME, DECODE_NAME))
    port = SimpleNamespace(serving=serving, LlamaConfig=LlamaConfig,
                           LlamaForCausalLM=LlamaForCausalLM)
    res = {"rank": rank, "backend": dist.get_backend(),
           "device": str(dist.env.rank_device()), "prebuilt": prebuilt,
           "start_s": time.perf_counter() - t_entry}
    path = os.path.join(spec["out"], f"serve_rank{rank}.json")
    t0 = time.perf_counter()
    res["identity"] = mp_serve_identity_rank(torch, port, rp, pd,
                                             collective, spec, rank)
    res["identity_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["serve"], logits = mp_serve_rank(torch, port, rp, pd, collective,
                                         spec, rank)
    res["serve_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["fleet"], fleet_keep = mp_fleet_rank(torch, port, rp, pd,
                                             collective, spec, rank)
    res["fleet_s"] = time.perf_counter() - t0
    toy, res["toy_tokens"] = mp_serve_toy(port, spec)
    res["built_here"] = sorted(_build.build_logs)
    with open(path, "w") as f:
        json.dump(res, f)
    if rank:
        del logits
        for _ in range(3):
            msg = toy.tp.receive()
            toy.follow_step(*msg[1:])
        torch.cuda.synchronize()
        os.kill(os.getpid(), signal.SIGKILL)
    toy.add_request([3, 1, 4, 1, 5], serving.SamplingParams(
        max_new_tokens=40))
    t0 = time.perf_counter()
    try:
        toy.run(max_steps=1000)
        res["follower_death"] = {"raised": None}
    except Exception as e:   # the check reads what the controller raised
        res["follower_death"] = {"raised": f"{type(e).__name__}: "
                                           f"{str(e)[:300]}"}
    res["follower_death"]["seconds"] = time.perf_counter() - t0
    del toy
    topology.set_hybrid_communicate_group(None)
    t0 = time.perf_counter()
    res["whole"] = mp_serve_whole(torch, port, spec, logits)
    res["whole_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["fleet_mp1"] = mp_fleet_mp1(torch, port, fleet_keep)
    res["fleet_mp1_s"] = time.perf_counter() - t0
    with open(path, "w") as f:
        json.dump(res, f)
    # the world's process group lost a rank: leave without tearing it down
    os._exit(0)


def matched_prefix(a, b):
    """Tokens of ``a`` equal to ``b`` before their first difference."""
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def mp_serve_phases(torch, rp, pd, flash, ref):
    """mp_serve_shape here, then one world of 2 ranks over gloo on this
    card (``mp_serve_rank_main``) for mp_serve_identity and mp_serve, then
    mp_server (``server --mp 2``).  ``ref`` holds this process's mp=1
    identity tokens and bucket sets and the prompts.  Returns each rank's
    kernel launches of each phase and the kernels' errors at a rank's
    shapes."""
    from paddle_tpu_torch.distributed.spawn import spawn

    shape_errors = mp_serve_shape_phase(torch, rp, pd, flash)
    out = tempfile.mkdtemp(prefix="mp_serve_")
    try:
        spec = {"out": out, "identity_prompts": ref["identity_prompts"],
                "serve_prompts": ref["serve_prompts"]}
        t0 = time.perf_counter()
        ctx = spawn(mp_serve_rank_main, args=(spec,), nprocs=MP_DEGREE,
                    backend="gloo", pg_timeout=MP_SERVE_TIMEOUT, join=False)
        for p in ctx.processes:
            p.join(900)
        codes = [p.exitcode for p in ctx.processes]
        if codes != [0, -9]:
            ctx.stop()
            raise AssertionError(f"mp_serve: the ranks exited with {codes}, "
                                 f"due [0, -9] (rank 1 kills itself)")
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(MP_DEGREE):
            with open(os.path.join(out, f"serve_rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    where = dict(backend="gloo", cards=torch.cuda.device_count(),
                 world=MP_DEGREE, mp=MP_DEGREE,
                 devices=[r["device"] for r in ranks],
                 rank_start_s={r["rank"]: r["start_s"] for r in ranks})
    if not all(r["prebuilt"] and not r["built_here"]
               and r["backend"] == "gloo" for r in ranks):
        raise AssertionError(f"mp_serve: a rank built kernels itself or ran "
                             f"another backend: {ranks}")
    r0, r1 = ranks
    ident = {}
    for name in ("unified", "legacy", "legacy_burst8"):
        a, b = r0["identity"][name], r1["identity"][name]
        want_tokens, want_buckets = ref[name]
        if a["tokens"] != want_tokens:
            raise AssertionError(f"mp_serve_identity {name}: mp=2 tokens "
                                 f"differ from mp=1's")
        if a["buckets"] != want_buckets or a["traces"] or a["captures"] \
                or b["captures"]:
            raise AssertionError(
                f"mp_serve_identity {name}: buckets {a['buckets']} against "
                f"mp=1's {want_buckets}, traces {a['traces']}, captures "
                f"{a['captures']} / {b['captures']} (due 0)")
        if a["sampled"] != b["sampled"]:
            raise AssertionError(f"mp_serve_identity {name}: the ranks "
                                 f"sampled different tokens")
        if name == "legacy_burst8" and not a["bursts"]:
            raise AssertionError("mp_serve_identity: no burst ran")
        if a["occupancy"] != 0.0 or "serving_mp_shards 2" not in a[
                "metrics"] or "ROADMAP A11 item 7" not in a["eager_reason"]:
            raise AssertionError(f"mp_serve_identity {name}: pool, "
                                 f"serving_mp_shards or eager reason wrong")
        ident[name] = {
            "tokens_identical_to_mp1": True, "buckets": len(a["buckets"]),
            "bursts": a["bursts"], "pool_shape": a["pool_shape"],
            "ranks": {r["rank"]: {k: r["identity"][name][k] for k in (
                "launches", "programs", "collectives", "seconds")}
                for r in ranks}}
    death = r0["follower_death"]
    if death["raised"] is None or not death["seconds"] < MP_SERVE_TIMEOUT:
        raise AssertionError(f"mp_serve_identity: with its follower killed "
                             f"the controller {death}")
    emit("mp_serve_identity", **where, layers=2, dtype="float32",
         prompts=len(ref["identity_prompts"]), new_tokens_each=16,
         both_ranks_sampled_equal=True, captures=0,
         buckets_equal_mp1=True,
         min_top2_gap=min(r0["identity"]["top2_gap_first_tokens"]),
         follower_killed=death, **ident)
    s0, s1 = r0["serve"], r1["serve"]
    whole = r0["whole"]
    if not whole["first_step_logit_err"] <= 2e-2:
        raise AssertionError(f"mp_serve: first-step logits off by "
                             f"{whole['first_step_logit_err']} of their "
                             f"largest entry against the whole model")
    toks = s0["tokens"]
    if any(len(t) != 64 for t in toks):
        raise AssertionError("mp_serve: malformed token streams")
    matched = [matched_prefix(a, b) for a, b in zip(toks, whole["tokens"])]
    emit("mp_serve", **where, model="llama3_8b", layers=FLEET_LAYERS,
         dtype="bfloat16", prompts=len(ref["serve_prompts"]),
         prompt_tokens=sum(map(len, ref["serve_prompts"])),
         new_tokens_each=64, seconds=s0["seconds"],
         output_tokens_per_s=s0["output_tokens_per_s"],
         mean_ttft_s=s0["mean_ttft_s"], mean_itl_s=s0["mean_itl_s"],
         unified_step_mean_ms=s0["unified_step_mean_ms"],
         engine_steps=s0["steps"],
         peak_memory_bytes={r["rank"]: r["serve"]["peak_memory_bytes"]
                            for r in ranks},
         share_window={r["rank"]: r["serve"]["share_window"]
                       for r in ranks},
         first_step_logit_err=whole["first_step_logit_err"],
         mp1_output_tokens_per_s=whole["mp1_output_tokens_per_s"],
         tokens_matching_mp1_before_divergence={
             "sum": sum(matched), "of": 64 * len(toks), "min": min(matched),
             "identical_streams": sum(m == 64 for m in matched)},
         rules={r["rank"]: r["serve"]["rule"] for r in ranks},
         legacy_burst8={r["rank"]: r["serve"]["legacy_burst8"]["rule"]
                        for r in ranks},
         phase_s={"spawn": spawn_s, "identity": r0["identity_s"],
                  "serve": r0["serve_s"], "whole": r0["whole_s"]},
         note="tokens/s, TTFT and ITL of one unified pass at mp=2 (eager, "
              "the step's collectives over gloo through the host); "
              "share_window: a short pass with every collective "
              "synchronised before and after, collective seconds over its "
              "wall; the mp=1 tokens are rank 0's whole model")
    mp_fleet_gates(ref, ranks, where)
    mp_server_phase(torch, r0["toy_tokens"])
    return {"fleet": {r["rank"]: {
                n: r["fleet"][n]["rule"]["launches"]
                for n in ("fleet", "disagg")} for r in ranks},
            "identity": {r["rank"]: {
                "ragged": sum(r["identity"][n]["launches"]["ragged"]
                              for n in ("unified", "legacy",
                                        "legacy_burst8")),
                "decode": sum(r["identity"][n]["launches"]["decode"]
                              for n in ("unified", "legacy",
                                        "legacy_burst8"))}
                for r in ranks},
            "serve": {r["rank"]: {
                "ragged": r["serve"]["rule"]["launches"]["ragged"]
                + r["serve"]["legacy_burst8"]["rule"]["launches"]["ragged"],
                "decode": r["serve"]["rule"]["launches"]["decode"]
                + r["serve"]["legacy_burst8"]["rule"]["launches"]["decode"]}
                for r in ranks},
            "shape": shape_errors}


def mp_fleet_gates(ref, ranks, where):
    """mp_fleet_identity's and mp_disagg_identity's gates on the ranks'
    rows (each rank already held its launches, collectives and pools to
    its replicas' forwards) and their lines."""
    want = ref["unified"][0]
    r0 = ranks[0]
    fleet, disagg = r0["fleet"]["fleet"], r0["fleet"]["disagg"]
    n = len(ref["identity_prompts"])
    if fleet["tokens"] != want or fleet["finish"] != ["length"] * n:
        raise AssertionError("mp_fleet_identity: the dp=2 x mp=2 fleet's "
                             "tokens differ from one mp=1 engine's")
    if set(fleet["replicas"]) != {0, 1} or fleet["occupancy"] != [0.0, 0.0]:
        raise AssertionError(f"mp_fleet_identity: replicas served "
                             f"{fleet['replicas']}, occupancy "
                             f"{fleet['occupancy']}")
    emit("mp_fleet_identity", **where, dp=MP_FLEET_REPLICAS, layers=2,
         dtype="float32", prompts=n, new_tokens_each=16,
         tokens_identical_to_mp1=True, served_by=fleet["replicas"],
         max_queue=MP_FLEET_QUEUE, captures=0, seconds=fleet["seconds"],
         ranks={r["rank"]: r["fleet"]["fleet"]["rule"] for r in ranks},
         note="each rank's ragged launches (simple route, fp32) equal the "
              "forwards of both replicas on it x layers, with 2L+1 "
              "all-reduces and one all-gather a forward; the pool "
              "invariant held on every rank of every replica")
    short = [(b * 16, c) for b, c in zip(disagg["blocks_each"],
                                         disagg["cached_each"])
             if not b or c < b * 16]
    if disagg["tokens"] != want or disagg["replicas"] != [1] * n \
            or disagg["handoffs"] != n or len(disagg["blocks_each"]) != n \
            or short:
        raise AssertionError(
            f"mp_disagg_identity: tokens equal {disagg['tokens'] == want}, "
            f"replicas {disagg['replicas']}, {disagg['handoffs']} hand-offs, "
            f"imports not served from the run (carried, cached): {short}")
    ho, mp1 = r0["fleet"]["handoff"], r0["fleet_mp1"]
    if not (ho["refused"] and "digest" in ho["refused"] and ho["unchanged"]
            and ho["placed_after"]):
        raise AssertionError(f"mp_disagg_identity: a flipped byte was not "
                             f"refused before the pools changed: {ho}")
    if not (mp1["placed"] == mp1["blocks"] and mp1["cached_tokens"]
            >= mp1["blocks"] * 16 and mp1["tokens_equal_mp2_donor"]):
        raise AssertionError(f"mp_disagg_identity: the mp=2 run imported "
                             f"at mp=1: {mp1}")
    emit("mp_disagg_identity", **where, layers=2, dtype="float32",
         prompts=n, new_tokens_each=16, tokens_identical_to_mp1=True,
         handoffs=disagg["handoffs"], recomputed_tokens=0,
         blocks_each=disagg["blocks_each"],
         cached_tokens_each=disagg["cached_each"],
         seconds=disagg["seconds"],
         ranks={r["rank"]: r["fleet"]["disagg"]["rule"] for r in ranks},
         handoff_mp2={k: ho[k] for k in ("prompt_tokens", "blocks", "bytes",
                                         "ms", "total_ms")},
         handoff_mp1=mp1["mp1_parts"],
         mp2_run_into_mp1={k: mp1[k] for k in (
             "placed", "blocks", "cached_tokens", "tokens_equal_mp2_donor")},
         flipped_byte_refused=ho["refused"][:120],
         note="hand-off ms by part, each synchronised: export gather (this "
              "rank's pages), device_to_host, ranks (the follower's head "
              "slice gathered over the control group), digest; import "
              "verify, import (the pool), ranks (the slices scattered), "
              "scatter (this rank's pools); handoff_mp1 is the same "
              "1024-token hand-off between two mp=1 engines in this run")


def mp_server_phase(torch, toy_tokens):
    """``python -m paddle_tpu_torch.serving.server --mp 2`` on this card
    (the CLI's toy model, 2 layers, unified): its banner, ``/readyz`` ``ok
    dp=1 mp=2``, completions token-equal to the same engine at mp=2 in the
    ranks, ``/metrics`` with the mp gauge and the collective series, then
    SIGTERM: the controller drains, stops its follower (which exits 0 or
    fails the controller's join) and exits 0."""
    t0 = time.perf_counter()
    err = tempfile.NamedTemporaryFile("w+", suffix=".err", delete=False)
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.server", "--mp",
         "2", "--layers", "2", "--blocks", "64", "--unified"],
        stdout=subprocess.PIPE, stderr=err, text=True)
    try:
        port, seen = None, []
        deadline = time.monotonic() + 300
        while port is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            seen.append(line.strip())
            found = re.search(r"serving on http://[\d.]+:(\d+) dp=1 mp=2",
                              line)
            port = int(found.group(1)) if found else None
        if port is None:
            err.seek(0)
            raise AssertionError(f"mp_server: no banner: {seen} "
                                 f"{err.read()[-3000:]}")
        boot_s = time.perf_counter() - t0
        status, _, ready = http_call(port, "GET", "/readyz")
        tokens = []
        for prompt, n in MP_SERVER_BODIES:
            status_c, _, data = http_call(port, "POST", "/v1/completions",
                                          {"prompt": prompt,
                                           "max_tokens": n})
            if status_c != 200:
                raise AssertionError(f"mp_server: completion {status_c} "
                                     f"{data[:300]!r}")
            tokens.append(json.loads(data)["choices"][0]["token_ids"])
        _, _, page = http_call(port, "GET", "/metrics")
        want = [b"serving_mp_shards 2",
                b'serving_collective_seconds_count{phase="ragged"}']
        if status != 200 or ready != b"ok dp=1 mp=2\n" or any(
                w not in page for w in want) or tokens != toy_tokens:
            raise AssertionError(f"mp_server: /readyz {status} {ready!r}, "
                                 f"metrics {[w in page for w in want]}, "
                                 f"tokens {tokens} against the ranks' "
                                 f"{toy_tokens}")
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=120)
        stop_s = time.perf_counter() - t1
        if code != 0:
            err.seek(0)
            raise AssertionError(f"mp_server: exit {code} after SIGTERM: "
                                 f"{err.read()[-3000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        err.close()
        os.unlink(err.name)
    emit("mp_server", readyz=ready.decode().strip(), completions=len(tokens),
         tokens_equal_in_process_mp2=True, sigterm_exit=0, boot_s=boot_s,
         stop_s=stop_s, banner=[s for s in seen if s.startswith("mp:")],
         note="the CLI serves its toy model (LlamaConfig.tiny, 2 layers, "
              "fp32, simple routes); the follower's exit 0 is checked by "
              "the controller's join, whose failure fails its exit code")


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


def proc_running(pid) -> bool:
    """``pid`` exists and is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def worker_rank_rule(label, pf, route, served=True):
    """The launch rule of each worker at mp > 1, over the wire: every
    rank's ragged launches equal its forwards x layers, all on ``route``
    (and some, with ``served``), and no decode launch; their sums are the
    worker's."""
    rows = worker_launch_rule(label, pf, route, None)
    for i, row in rows.items():
        for r, rank in enumerate(row["ranks"]):
            due = rank["due"]["ragged"]
            if not (rank["ragged"]["all"] == rank["ragged"][route] == due
                    and (due > 0 or not served)
                    and rank["decode"]["all"] == 0):
                raise AssertionError(f"{label} worker {i} rank {r}: {rank}")
    return rows


def mp_procfleet_phase(torch, serving, prompts, cache_dir):
    """``--workers 2 --mp 2``: two worker processes, each the controller
    of a world of 2 ranks over gloo on this card, Llama-3-8B widths at
    FLEET_LAYERS layers, bf16, the serve prompts (64 greedy tokens each)
    through the router with the supervisor on: output tokens/s, mean TTFT
    and ITL, each worker's boot, each rank's peak memory and launch rule
    over the wire.  Then a second wave with one worker's follower killed
    by SIGKILL mid-run: the worker fails, the supervisor respawns it (a
    fresh world), no request is lost, no process of the killed world is
    left."""
    new_tokens = 64
    spec = {"preset": "llama3_8b", "layers": FLEET_LAYERS,
            "dtype": "bfloat16", "seed": 1}
    need = sum(-(-(len(p) + new_tokens) // 16) for p in prompts) + 1
    pf = serving.ProcessFleet(serving.ProcessFleetConfig(
        dp=2, mp=MP_DEGREE, num_blocks=need + 16, block_size=16,
        max_num_seqs=16, max_prefill_tokens_per_step=None,
        max_tokens_per_step=512, unified=True, compile_cache=cache_dir,
        heartbeat_timeout_s=10.0, **spec,
        fleet=serving.FleetConfig(max_queue=64)))
    pf.supervise(serving.SupervisorConfig(max_restarts=3))
    pf.start()
    router = pf.router
    boots = boot_rows(pf)
    pids = {pf.worker_pid(i) for i in range(2)}
    out = {}
    try:
        t0 = time.perf_counter()
        hs = [router.submit_request(p, serving.SamplingParams(
            max_new_tokens=new_tokens), request_id=f"a{i}", retryable=True)
            for i, p in enumerate(prompts)]
        router.wait(hs, timeout=600)
        wall = time.perf_counter() - t0
        if any(h.finish_reason != "length" or len(h.output_tokens)
               != new_tokens for h in hs):
            raise AssertionError("mp_procfleet: a request did not finish")
        out.update(seconds=wall,
                   output_tokens_per_s=len(prompts) * new_tokens / wall,
                   served_by=[h.replica.index for h in hs],
                   **timeline_means(router.lifecycle, [h.rid for h in hs],
                                    new_tokens))
        out["launch_rule"] = worker_rank_rule("mp_procfleet", pf, "tma")
        out["peak_memory_bytes"] = {
            i: [r["peak_memory_bytes"] for r in row["ranks"]]
            for i, row in out["launch_rule"].items()}
        # --- kill -9 one worker's follower, mid-run
        wave = prompts[:8]
        hs = [router.submit_request(p, serving.SamplingParams(
            max_new_tokens=new_tokens), request_id=f"b{i}", retryable=True)
            for i, p in enumerate(wave)]
        deadline = time.monotonic() + 300
        while not any(h.output_tokens for h in hs) \
                and time.monotonic() < deadline:
            time.sleep(0.002)
        victim = next((r.index for r in router.replicas if r.in_flight),
                      None)
        if victim is None:
            raise AssertionError("mp_procfleet: nothing in flight to kill")
        vpid = pf.worker_pid(victim)
        ranks = pf.proxy(victim).debug_fetch("describe")["launches"]["ranks"]
        world = [r["pid"] for r in ranks]
        follower = world[1:]
        if world[0] != vpid or len(follower) != MP_DEGREE - 1 or not all(
                proc_running(p) for p in world):
            raise AssertionError(f"mp_procfleet: worker {vpid}'s world "
                                 f"{world}")
        os.kill(follower[0], signal.SIGKILL)
        t_kill = time.perf_counter()
        router.wait(hs, timeout=600)
        lost = [h.rid for h in hs if h.finish_reason != "length"
                or len(h.output_tokens) != new_tokens]
        if lost:
            raise AssertionError(f"mp_procfleet: the follower's death lost "
                                 f"{lost}")
        deadline = time.monotonic() + 300
        while not (all(r.healthy for r in router.replicas)
                   and pf.worker_pid(victim) != vpid) \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        healed_s = time.perf_counter() - t_kill
        new_pid = pf.worker_pid(victim)
        pids.add(new_pid)
        if new_pid == vpid or not all(r.healthy for r in router.replicas):
            raise AssertionError("mp_procfleet: the failed worker was not "
                                 "respawned")
        deadline = time.monotonic() + 30
        while any(proc_running(p) for p in world) \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        left = [p for p in world if proc_running(p)]
        if left:
            raise AssertionError(f"mp_procfleet: processes {left} of the "
                                 f"killed world outlived it")
        out["kill9_follower"] = {
            "victim": victim, "worker_pid": vpid, "follower_pid": follower[0],
            "new_pid": new_pid, "healed_s": healed_s, "lost": 0,
            "killed_world": world, "left": left,
            "respawns": series_sum(pf.registry,
                                   "serving_fleet_worker_respawns_total"),
            "respawn_boot": boot_rows(pf)[str(victim)]}
        # the respawned worker counts from its ready line
        out["launch_rule_after"] = worker_rank_rule("mp_procfleet kill9",
                                                    pf, "tma", served=False)
    finally:
        stop_process_fleet("mp_procfleet", pf, pids)
    emit("mp_procfleet", workers=2, mp=MP_DEGREE, backend="gloo",
         model=spec["preset"], layers=spec["layers"], dtype=spec["dtype"],
         prompts=len(prompts), new_tokens_each=new_tokens, boot=boots,
         **out,
         note="two worker processes, each the controller of its own world "
              "of 2 ranks over gloo on this card; TTFT and ITL are means "
              "over the router's request timelines; boot ready_s is launch "
              "to ready line (the follower's start included); each rank's "
              "launches read over the wire (describe)")
    return {i: [r["ragged"]["all"] for r in row["ranks"]]
            for i, row in out["launch_rule"].items()}


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
    record = dict(
        model="gpt3_6.7b", layers=layers, dtype="bfloat16",
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
    emit("gpt_train", **record)
    return launches, (model, criterion, opt, sched), record


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
    return rows


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


# --- sequence models ----------------------------------------------------------

# PaddleNLP examples/machine_translation/seq2seq, its README's training
# command (--num_layers 2 --hidden_size 512 --batch_size 128 --dropout 0.2
# --init_scale 0.1 --max_grad_norm 5.0 --learning_rate 0.001) and predict's
# --beam_size 10; fed text.WMT16, whose vocabularies (4000) and length (16)
# stand in for IWSLT'15 en-vi's (17191 / 7709 words, up to 50 tokens)
S2S_BOS, S2S_EOS = 0, 1        # text.WMT16's start and end tokens
S2S_VOCAB = 4000
S2S_LEN = 16
S2S_HIDDEN = 512               # embedding and hidden
S2S_LAYERS = 2
S2S_B = 128
S2S_LR = 1e-3
S2S_DROPOUT = 0.2
S2S_INIT = 0.1
S2S_CLIP = 5.0
S2S_BEAM = 10
S2S_MAX_OUT = 32               # dynamic_decode's steps at most
S2S_HELD = 32                  # decoded sentences held to the CPU
S2S_EAGER_STEPS = 6            # timed eager steps (after 2 untimed)
S2S_CAPTURED_STEPS = 10        # to_static calls: eager, capture, 8 replays
S2S_WINDOW = 2                 # profiled captured steps (after as many)


def seq2seq_model(torch, nn, F, vocab, hidden, layers, dropout=0.0,
                  device=None, generator=None):
    """PaddleNLP's ``Seq2SeqAttnModel`` (examples/machine_translation/
    seq2seq/seq2seq_attn.py) over the port's ``nn`` (``F`` its
    functional): an embedding and an ``nn.LSTM`` encoder; a decoder
    ``nn.RNN`` over a cell of stacked ``nn.LSTMCell``s fed the previous
    attention output, ``nn.Dropout`` between them, and Luong attention
    (two matrix products and a softmax masked by -1e9 at the source's end
    tokens, between two bias-free projections); a bias-free output layer.
    Embeddings and projections are ``Uniform(-S2S_INIT, S2S_INIT)``,
    the LSTMs their default.  The encoder's ``dropout`` and
    ``sequence_length`` reach ``nn.LSTM``, which ignores them (ROADMAP
    C6).  The cell's states are flat, ``(h_0, c_0, ..., h_{L-1}, c_{L-1},
    input_feed)``, and the encoder's output and padding mask its
    ``memory``, set before a run and cleared after a training forward
    (PaddleNLP passes them as keyword
    arguments, which the JAX package's ``RNN`` and ``BeamSearchDecoder``
    do not forward), so the same cell steps the training ``RNN`` and
    ``BeamSearchDecoder``.  ``encode`` gives the encoder's output, the
    mask and the decoder's initial states."""
    init = nn.initializer.Uniform(-S2S_INIT, S2S_INIT)
    kw = dict(device=device, generator=generator)

    class AttentionLayer(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.input_proj = nn.Linear(hidden, hidden, weight_attr=init,
                                        bias_attr=False, **kw)
            self.output_proj = nn.Linear(2 * hidden, hidden,
                                         weight_attr=init, bias_attr=False,
                                         **kw)

        def forward(self, hidden_state, encoder_output, padding_mask):
            enc = self.input_proj(encoder_output)
            scores = torch.matmul(hidden_state.unsqueeze(1),
                                  enc.transpose(1, 2)) + padding_mask
            attn = F.softmax(scores, axis=-1)
            out = torch.matmul(attn, enc).squeeze(1)
            return self.output_proj(torch.cat([out, hidden_state], 1))

    class DecoderCell(nn.RNNCellBase):
        def __init__(self):
            super().__init__()
            self.hidden_size = hidden
            self.dropout = nn.Dropout(dropout)
            self.lstm_cells = nn.LayerList([
                nn.LSTMCell(2 * hidden if i == 0 else hidden, hidden, **kw)
                for i in range(layers)])
            self.attention_layer = AttentionLayer()
            self.memory = None

        def forward(self, step_input, states):
            step_input = torch.cat([step_input, states[-1]], 1)
            new = []
            for i, cell in enumerate(self.lstm_cells):
                out, (h, c) = cell(step_input, (states[2 * i],
                                                states[2 * i + 1]))
                step_input = self.dropout(out)
                new += [h, c]
            out = self.attention_layer(step_input, *self.memory)
            return out, (*new, out)

    class Encoder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.embedder = nn.Embedding(vocab, hidden, weight_attr=init,
                                         **kw)
            self.lstm = nn.LSTM(hidden, hidden, num_layers=layers,
                                dropout=dropout if layers > 1 else 0.0, **kw)

        def forward(self, sequence, sequence_length):
            return self.lstm(self.embedder(sequence),
                             sequence_length=sequence_length)

    class Decoder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.embedder = nn.Embedding(vocab, hidden, weight_attr=init,
                                         **kw)
            self.lstm_attention = nn.RNN(DecoderCell())
            self.output_layer = nn.Linear(hidden, vocab, weight_attr=init,
                                          bias_attr=False, **kw)

        def forward(self, trg, states):
            out, _ = self.lstm_attention(self.embedder(trg),
                                         initial_states=states)
            return self.output_layer(out)

    class Seq2SeqAttnModel(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.encoder = Encoder()
            self.decoder = Decoder()

        def encode(self, src, src_length):
            enc_out, (h, c) = self.encoder(src, src_length)
            cell = self.decoder.lstm_attention.cell
            states = tuple(t for i in range(layers) for t in (h[i], c[i]))
            states += (cell.get_initial_states(enc_out),)
            mask = ((src != S2S_EOS).to(torch.float32) - 1.0) * 1e9
            return enc_out, mask.unsqueeze(1), states

        def forward(self, src, src_length, trg):
            enc_out, mask, states = self.encode(src, src_length)
            cell = self.decoder.lstm_attention.cell
            cell.memory = (enc_out, mask)
            logits = self.decoder(trg, states)
            # a memory kept past the step would keep its autograd graph
            # alive: the next step's gradients would then accumulate
            # through nodes made on the last step's stream, which breaks a
            # to_static capture (it runs on a side stream)
            cell.memory = None
            return logits

    return Seq2SeqAttnModel()


def seq2seq_loss(torch, F):
    """PaddleNLP's ``CrossEntropyCriterion``: token cross-entropies masked
    to the target (its tokens and the end token after them, the positions
    up to the count of non-end tokens), averaged over the batch and summed
    over time; ``loss(logits, label)``."""
    def loss(logits, label):
        n = (label != S2S_EOS).sum(1, keepdim=True)
        mask = (torch.arange(label.shape[1], device=label.device) <= n).to(
            torch.float32)
        cost = F.cross_entropy(logits, label.unsqueeze(-1), reduction="none")
        return (cost * mask).mean(0).sum()
    return loss


def seq2seq_beam_search(nn, model, src, src_length, beam_size, max_len):
    """PaddleNLP's ``Seq2SeqAttnInferModel.forward``: the encoder, the
    memory repeated ``beam_size`` times along the batch, then
    ``BeamSearchDecoder`` over the decoder's cell through
    ``dynamic_decode``: (sequences ``[B, beam, T]``, lengths, scores
    ``[B, beam]``, best first)."""
    enc_out, mask, states = model.encode(src, src_length)
    cell = model.decoder.lstm_attention.cell
    tile = nn.BeamSearchDecoder.tile_beam_merge_with_batch
    cell.memory = (tile(enc_out, beam_size), tile(mask, beam_size))
    dec = nn.BeamSearchDecoder(cell, S2S_BOS, S2S_EOS, beam_size,
                               embedding_fn=model.decoder.embedder,
                               output_fn=model.decoder.output_layer)
    seqs, (_, scores, _), lengths = nn.dynamic_decode(
        dec, inits=states, max_step_num=max_len, return_length=True)
    return seqs, lengths, scores


def beam_scores(torch, model, src, src_len, seqs):
    """Each beam's log-probability under ``model``, teacher-forced through
    its training forward (the decoder ``RNN`` over the whole sequence, no
    search, no regathering): ``seqs`` ``[B, beam, T]``; the tokens up to
    and including the first end token count, as the search scores a beam
    (a finished beam adds 0).  Log-probabilities in the model's dtype,
    summed in float64: ``[B, beam]``."""
    B, K, T = seqs.shape
    flat = seqs.reshape(B * K, T)
    trg = torch.cat([torch.full_like(flat[:, :1], S2S_BOS), flat[:, :-1]],
                    1)
    logits = model(src.repeat_interleave(K, 0),
                   src_len.repeat_interleave(K, 0), trg)
    lp = torch.log_softmax(logits, -1).gather(-1, flat[..., None])[..., 0]
    is_end = (flat == S2S_EOS).to(torch.int64)
    counted = (is_end.cumsum(1) - is_end) == 0
    return torch.where(counted, lp.double(), 0.0).sum(1).reshape(B, K)


# tests/test_nn.py's beam-search table: the next token's logits by the
# current one, -10.0 elsewhere (ties); greedy takes 1, beams find 2, 3, end
TABLE_START, TABLE_END = 0, 5
TABLE = np.full((6, 6), -10.0, np.float32)
TABLE[[0, 0, 1, 1, 2, 3, 4], [1, 2, 4, 5, 3, 5, 5]] = np.log(
    [0.5, 0.4, 0.5, 0.5, 0.99, 0.99, 0.9])


def table_cell(torch, table, device):
    """A step cell whose logits are ``table``'s row of the input token."""
    class TableCell(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.table = torch.from_numpy(table).to(device)

        def forward(self, tok, state):
            return self.table[tok], state

    return TableCell()


def seq2seq_batches(torch, port, mode, batch, n, device, shuffle=False):
    """The first ``n`` batches of ``text.WMT16(mode)`` through the port's
    ``DataLoader``, epoch after epoch (2000 pairs make 15 batches of 128):
    ``(src, src_len, tgt_in, tgt_out)`` on ``device``."""
    loader = port.io.DataLoader(port.text.WMT16(mode=mode),
                                batch_size=batch, shuffle=shuffle,
                                drop_last=True, places=device)
    out = []
    while len(out) < n:
        for src, src_len, tgt_in, tgt_out, _ in loader:
            out.append((src, src_len, tgt_in, tgt_out))
            if len(out) == n:
                break
    return out


def global_norm(torch, params):
    return float(torch.sqrt(sum(torch.sum(p.grad.float() ** 2)
                                for p in params if p.grad is not None)))


def seq2seq_step(model, loss_fn, opt):
    def step(src, src_len, tgt_in, tgt_out):
        loss = loss_fn(model(src, src_len, tgt_in), tgt_out)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return step


def rnn_gaps(torch, run, ref):
    """``run`` and ``ref``'s (outputs, gradients) lists: the largest
    output gap and the largest gradient gap over each gradient's largest
    entry."""
    out_gap = max(float((a.cpu() - b).abs().max()) for a, b in
                  zip(run[0], ref[0]))
    grad_gap = max(float((a.cpu() - b).abs().max())
                   / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(run[1], ref[1]))
    return out_gap, grad_gap


def rnn_identity_phase(torch, port, dev="cuda"):
    """fp32, TF32 off, the card against the port's own CPU run, from the
    same weights and inputs.  (1) 2-layer bidirectional ``LSTM``, ``GRU``
    and ``SimpleRNN`` at H=64 (input 64, B=8, T=16): outputs and final
    states within 1e-5, the input's and every weight's gradient within
    1e-5 of its largest entry.  (2) The seq2seq model at H=64, 2 layers,
    B=8, no dropout, on ``text.WMT16``: 5 Adam steps under
    ``ClipGradByGlobalNorm(0.5)`` (below every step's global norm: each
    clips), losses within 1e-4 relative; then beam search with K=4 (16
    steps at most) on 8 test sentences, and on ``tests/test_nn.py``'s
    table cell (logits equal on both devices, ties included) with K = 1,
    3 and 4, sequences and lengths identical.  (The initial weights'
    beams are not compared across devices: on the CPU their kept and
    first dropped candidates lie 0 to 2e-5 apart, within the devices'
    fp32 rounding of log-probabilities near -8.)  (3) The same train step
    under ``jit.to_static`` on the card against eager: losses within 1e-5
    relative, 1 capture, 0 graph breaks; then a planted failed capture
    (the step keeps its loss, and so its autograd graph, alive into the
    next call): 1 graph break, no capture, the eager fallback's losses
    finite and within 1e-5 of eager, the caller's stream current."""
    import warnings

    t0 = time.perf_counter()
    nn, F = port.nn, port.F
    rng = np.random.default_rng(70)
    rows = {}
    for name in ("LSTM", "GRU", "SimpleRNN"):
        cpu = getattr(nn, name)(64, 64, num_layers=2, direction="bidirect",
                                generator=torch.Generator().manual_seed(71))
        card = getattr(nn, name)(64, 64, num_layers=2, direction="bidirect",
                                 device=dev)
        card.load_state_dict(cpu.state_dict())
        x = torch.from_numpy(rng.standard_normal((8, 16, 64)).astype(
            np.float32))

        def run(layer, x, dev):
            xi = x.to(dev).requires_grad_()
            out, states = layer(xi)
            outs = [out] + list(states if isinstance(states, tuple)
                                else (states,))
            sum((o * (k + 1)).sin().sum() for k, o in enumerate(outs)
                ).backward()
            grads = [xi.grad] + [p.grad for p in layer.parameters()]
            return [o.detach() for o in outs], grads

        out_gap, grad_gap = rnn_gaps(torch, run(card, x, dev),
                                     run(cpu, x, "cpu"))
        if out_gap > 1e-5 or grad_gap > 1e-5:
            raise AssertionError(f"rnn_identity {name}: outputs {out_gap}, "
                                 f"gradients {grad_gap} (gates 1e-5)")
        rows[name] = {"max_abs_gap": out_gap, "max_rel_grad_gap": grad_gap}

    # the seq2seq model, card against CPU
    clip = 0.5
    state = seq2seq_model(torch, nn, F, S2S_VOCAB, 64, 2,
                          generator=torch.Generator().manual_seed(72)
                          ).state_dict()
    batches = seq2seq_batches(torch, port, "train", 8, 5, "cpu")
    test = seq2seq_batches(torch, port, "test", 8, 1, "cpu")[0]
    loss_fn = seq2seq_loss(torch, F)

    def train(where, captured=False, keep=False):
        model = seq2seq_model(torch, nn, F, S2S_VOCAB, 64, 2, device=where)
        model.load_state_dict(state)
        opt = port.Adam(learning_rate=S2S_LR, parameters=model.parameters(),
                        grad_clip=nn.ClipGradByGlobalNorm(clip))
        losses, norms = [], []
        step = seq2seq_step(model, loss_fn, opt)
        if keep:
            inner = step

            def step(*batch):
                # the loss, and so its step's autograd graph, kept alive
                # into the next call: the capture fails
                model.kept = inner(*batch)
                return model.kept
        if captured:
            step = port.jit.to_static(step)
            for b in batches:
                losses.append(float(step(*(t.to(where) for t in b))))
            return model, losses, step
        for b in batches:
            src, src_len, tgt_in, tgt_out = (t.to(where) for t in b)
            loss = loss_fn(model(src, src_len, tgt_in), tgt_out)
            loss.backward()
            norms.append(global_norm(torch, model.parameters()))
            opt.step()
            opt.clear_grad()
            losses.append(loss.item())
        return model, losses, norms

    cpu_model, cpu_losses, cpu_norms = train("cpu")
    card_model, card_losses, card_norms = train(dev)
    gaps = rel_gaps(card_losses, cpu_losses)
    if max(gaps) > 1e-4 or min(card_norms) <= clip:
        raise AssertionError(
            f"rnn_identity seq2seq: card losses {card_losses} against the "
            f"CPU's {cpu_losses} (gate 1e-4 relative), global norms "
            f"{card_norms} (each must exceed the clip norm {clip})")
    beams = {}
    with torch.no_grad():
        found = []
        for model in (cpu_model, card_model):
            model.eval()
            src, src_len = (t.to(next(model.parameters()).device)
                            for t in test[:2])
            seqs, lengths, _ = seq2seq_beam_search(nn, model, src,
                                                   src_len, 4, S2S_LEN)
            found.append((seqs.cpu(), lengths.cpu()))
        # the search alone on logits equal on both devices, ties included
        # (tests/test_nn.py's table: a row of equal -10.0 logits)
        for K in (1, 3, 4):
            for where in ("cpu", dev):
                dec = nn.BeamSearchDecoder(
                    table_cell(torch, TABLE, where), TABLE_START, TABLE_END,
                    K)
                seqs, _, lengths = nn.dynamic_decode(
                    dec, inits=torch.zeros(2, 8, device=where),
                    max_step_num=6, return_length=True)
                found.append((seqs.cpu(), lengths.cpu()))
            beams[f"table_k{K}"] = found[-1][0][0].tolist()
    for i in range(0, len(found), 2):
        (cpu_seqs, cpu_lens), (seqs, lengths) = found[i], found[i + 1]
        if not (torch.equal(cpu_seqs, seqs)
                and torch.equal(cpu_lens, lengths)):
            raise AssertionError(
                f"rnn_identity beam search: the card's sequences {seqs} "
                f"and lengths {lengths} differ from the CPU's {cpu_seqs}, "
                f"{cpu_lens}")
    beams["seq2seq_lengths"] = found[1][1].tolist()
    # the captured step against eager on the card
    breaks = port.registry().counter("jit_graph_breaks_total", "")
    before = breaks.value
    _, captured_losses, step = train(dev, captured=True)
    eager_gaps = rel_gaps(captured_losses, card_losses)
    if (max(eager_gaps) > 1e-5 or breaks.value != before
            or step.captures != 1):
        raise AssertionError(
            f"rnn_identity to_static: losses {captured_losses} against "
            f"eager {card_losses} (gate 1e-5 relative), "
            f"{breaks.value - before} graph breaks, {step.captures} "
            f"captures")
    # a capture that fails falls back to eager soundly: the same losses
    stream = torch.cuda.current_stream()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, fallback_losses, step = train(dev, captured=True, keep=True)
    fallback_gaps = rel_gaps(fallback_losses, card_losses)
    if (not np.isfinite(fallback_losses).all() or max(fallback_gaps) > 1e-5
            or breaks.value != before + 1 or step.captures != 0
            or torch.cuda.current_stream() != stream):
        raise AssertionError(
            f"rnn_identity to_static fallback: losses {fallback_losses} "
            f"against eager {card_losses} (gate 1e-5 relative), "
            f"{breaks.value - before} graph breaks (1 planted), "
            f"{step.captures} captures, or another stream left current")
    emit("rnn_identity", layers=rows, seq2seq={
        "hidden": 64, "layers": 2, "batch": 8, "vocab": S2S_VOCAB,
        "clip_norm": clip, "global_norms": card_norms,
        "cpu_global_norms": cpu_norms, "cpu_losses": cpu_losses,
        "card_losses": card_losses, "max_rel_loss_gap": max(gaps),
        "beam": {"size": 4, "sentences": 8, "sequences_equal": True,
                 **beams},
        "to_static": {"losses": captured_losses,
                      "max_rel_gap_to_eager": max(eager_gaps),
                      "captures": 1, "graph_breaks": 0,
                      "failed_capture": {
                          "losses": fallback_losses,
                          "max_rel_gap_to_eager": max(fallback_gaps),
                          "graph_breaks": 1}}},
        seconds=time.perf_counter() - t0)


def seq2seq_train_phase(torch, port, dev="cuda"):
    """The seq2seq model at its README's widths (hidden and embedding 512,
    2 layers, dropout 0.2, init_scale 0.1) on the card, fp32, fed
    ``text.WMT16`` (shuffled, B=128) through the port's ``DataLoader``;
    ``Adam(1e-3)`` under ``ClipGradByGlobalNorm(5.0)``.  Two untimed eager
    steps read the global norm (whether the clip acts at 5.0), then 6
    eager steps timed by CUDA events (the clip-plus-optimizer share:
    backward's end to the step's end), then the step under
    ``jit.to_static``: 10 calls (the eager first call, the capture, 8
    replays), 1 capture, 0 graph breaks, a 2-step profiled window (idle
    share).  ms a step and target tokens/s (the tokens the loss counts)
    for both, peak memory; losses finite, and falling a target token.
    Beside it, for later speed work only, the encoder's forward and
    backward at the same shape through the port's ``nn.LSTM`` and through
    ``torch.nn.LSTM`` (cuDNN), which the port never calls.  Returns the
    trained model and its initial weights."""
    t0 = time.perf_counter()
    nn, F = port.nn, port.F
    model = seq2seq_model(torch, nn, F, S2S_VOCAB, S2S_HIDDEN, S2S_LAYERS,
                          dropout=S2S_DROPOUT, device=dev,
                          generator=torch.Generator(device=dev)
                          .manual_seed(73))
    params = sum(p.numel() for p in model.parameters())
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    opt = port.Adam(learning_rate=S2S_LR, parameters=model.parameters(),
                    grad_clip=nn.ClipGradByGlobalNorm(S2S_CLIP))
    loss_fn = seq2seq_loss(torch, F)
    np.random.seed(74)       # the loader's shuffle
    n = 2 + S2S_EAGER_STEPS + S2S_CAPTURED_STEPS + 2 * S2S_WINDOW
    batches = seq2seq_batches(torch, port, "train", S2S_B, n, dev,
                              shuffle=True)
    tokens = [int(((b[3] != S2S_EOS).sum(1) + 1).clamp_max(S2S_LEN).sum())
              for b in batches]
    torch.cuda.reset_peak_memory_stats()
    norms, losses = [], []
    for src, src_len, tgt_in, tgt_out in batches[:2]:
        loss = loss_fn(model(src, src_len, tgt_in), tgt_out)
        loss.backward()
        norms.append(global_norm(torch, model.parameters()))
        opt.step()
        opt.clear_grad()
        losses.append(loss.detach())
    # a live loss keeps its graph's AccumulateGrad nodes, made on this
    # stream: the capture (on a side stream) would then sync with it
    del loss
    clock = StepClock(torch)
    eager = batches[2:2 + S2S_EAGER_STEPS]
    losses += train_steps(lambda b: loss_fn(model(*b[:3]), b[3]), opt,
                          eager, clock=clock)
    eager_s, opt_s = clock.read()
    step = port.jit.to_static(seq2seq_step(model, loss_fn, opt))
    breaks = port.registry().counter("jit_graph_breaks_total", "")
    before = breaks.value
    captured = batches[2 + S2S_EAGER_STEPS:n - 2 * S2S_WINDOW]
    events = [torch.cuda.Event(enable_timing=True)]
    events[0].record()
    for b in captured:
        losses.append(step(*b))
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    losses = [float(x) for x in losses]
    if breaks.value != before or step.captures != 1:
        raise AssertionError(f"seq2seq_train: {breaks.value - before} graph "
                             f"breaks, {step.captures} captures")
    # the loss sums over time: per target token it is comparable across
    # batches of other lengths
    per_token = [x * S2S_B / t for x, t in zip(losses, tokens)]
    if not (np.isfinite(losses).all()
            and np.mean(per_token[-3:]) < np.mean(per_token[:3])):
        raise AssertionError(f"seq2seq_train: losses a target token "
                             f"{per_token} are not finite or do not fall")
    peak = torch.cuda.max_memory_allocated()
    window = iter(batches[n - 2 * S2S_WINDOW:])
    kernels, wall_us, _ = profile_window(torch, lambda: step(*next(window)),
                                         S2S_WINDOW)
    steady = ms[2:]
    eager_tokens = tokens[2:2 + S2S_EAGER_STEPS]
    captured_tokens = tokens[4 + S2S_EAGER_STEPS:n - 2 * S2S_WINDOW]
    encoder = seq2seq_encoder_times(torch, model, batches[0][0])
    emit("seq2seq_train", model="Seq2SeqAttnModel (PaddleNLP seq2seq)",
         dataset="text.WMT16 (synthetic)", vocab=S2S_VOCAB, length=S2S_LEN,
         hidden=S2S_HIDDEN, layers=S2S_LAYERS, batch=S2S_B,
         dropout=S2S_DROPOUT, optimizer=f"Adam({S2S_LR})",
         grad_clip=f"ClipGradByGlobalNorm({S2S_CLIP})", params=params,
         global_norms=norms, clipped=[g > S2S_CLIP for g in norms],
         losses=losses, token_losses=per_token, eager={
             "ms_per_step": float(np.mean(eager_s)) * 1e3,
             "ms_steps": [s * 1e3 for s in eager_s],
             "target_tokens_per_s": sum(eager_tokens) / sum(eager_s),
             "clip_optimizer_ms": float(np.mean(opt_s)) * 1e3,
             "clip_optimizer_share": float(np.sum(opt_s) / np.sum(eager_s))},
         captured={
             "first_call_ms": ms[0], "capture_call_ms": ms[1],
             "ms_per_step": float(np.mean(steady)), "ms_steps": steady,
             "target_tokens_per_s": sum(captured_tokens)
             / (sum(steady) / 1e3),
             "captures": step.captures, "graph_breaks": 0},
         max_memory_allocated=peak, encoder_lstm=encoder,
         **window_summary(kernels, wall_us),
         seconds=time.perf_counter() - t0)
    return model, initial


def seq2seq_encoder_times(torch, model, src):
    """ms of the encoder's forward and backward ([B, T] tokens, 2 layers of
    512) through the port's ``nn.LSTM`` and through ``torch.nn.LSTM``
    (cuDNN) on the same weights and embeddings: CUDA events around 10
    calls after 2 untimed."""
    lstm = model.encoder.lstm
    x = model.encoder.embedder(src).detach()
    ref = torch.nn.LSTM(S2S_HIDDEN, S2S_HIDDEN, num_layers=S2S_LAYERS,
                        batch_first=True, device=src.device)
    with torch.no_grad():
        for name, p in ref.named_parameters():
            p.copy_(getattr(lstm, name))
    g = torch.ones(x.shape[0], x.shape[1], S2S_HIDDEN, device=src.device)

    def port_call():
        xi = x.detach().requires_grad_()
        out, _ = lstm(xi)
        out.backward(g)

    def cudnn_call():
        xi = x.detach().requires_grad_()
        out, _ = ref(xi)
        out.backward(g)

    with torch.no_grad():
        gap = float((lstm(x)[0] - ref(x)[0]).abs().max())
    out = {"max_abs_gap": gap}
    for name, fn in (("port_ms", port_call), ("cudnn_ms", cudnn_call)):
        out[name] = time_ms(fn, 10)
    model.zero_grad(set_to_none=True)
    return out


def timed_decodes(torch, nn, model, src, src_len, n):
    """``n`` beam searches of ``src`` (host clock around a synchronised
    run): [(seconds, sequences, lengths, host reads, scores)], the host
    reads
    counted as the synchronising calls ``torch.cuda.set_sync_debug_mode
    ("warn")`` reports."""
    import warnings

    runs = []
    with torch.no_grad():
        for _ in range(n):
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                start = time.perf_counter()
                try:
                    seqs, lengths, scores = seq2seq_beam_search(
                        nn, model, src, src_len, S2S_BEAM, S2S_MAX_OUT)
                    torch.cuda.synchronize()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                seconds = time.perf_counter() - start
            reads = sum("synchroniz" in str(w.message) for w in caught)
            runs.append((seconds, seqs, lengths, reads, scores))
    return runs


def decode_row(runs, src):
    """A decode's figures from its runs (the first untimed), gated: valid
    tokens on the input's device, lengths within the steps run, the same
    output every run."""
    _, seqs, lengths, reads, scores = runs[-1]
    steps = seqs.shape[-1]
    if not (all(r[1].equal(seqs) and r[2].equal(lengths)
                and r[4].equal(scores) for r in runs)
            and seqs.device == src.device and int(seqs.min()) >= 0
            and int(seqs.max()) < S2S_VOCAB and int(lengths.min()) >= 1
            and int(lengths.max()) <= steps):
        raise AssertionError(f"seq2seq_decode: sequences {seqs.shape} on "
                             f"{seqs.device}, lengths {lengths} over "
                             f"{steps} steps, or runs that differ")
    timed = [r[0] for r in runs[1:]]
    mean = float(np.mean(timed))
    return {"steps": steps, "ms_per_decode": mean * 1e3,
            "ms_decodes": [t * 1e3 for t in timed],
            "sentences_per_s": src.shape[0] / mean,
            "ms_per_step": mean * 1e3 / steps, "host_reads": reads,
            "first_decode_ms": runs[0][0] * 1e3,
            "mean_length": float(lengths.float().mean()),
            "ended_share": float((seqs == S2S_EOS).any(-1).float().mean())}


def hold_beams(torch, nn, cpu_model, src, src_len, run):
    """The card's beams of the first ``S2S_HELD`` sentences of a decode
    (``run``, one of ``timed_decodes``') held on the CPU, by ``cpu_model``
    (the decoded weights, eval mode).  Gates: each beam's score equals its
    teacher-forced log-probability (``beam_scores``) within 4e-6 of its
    size, twice the most that fp32's rounding of 32 summed steps can move
    it (32 * 2^-24 = 1.9e-6), which holds the per-step regathering of the
    states by parent and the end-token masking; tokens after a beam's
    first end token are end tokens; beams are ranked best first; each
    sentence's best beam scores no worse than the CPU's own search's best
    less that tolerance.  Reports the sentences whose beams equal the CPU
    search's token for token: the two may part where candidates lie within
    fp32 rounding of each other."""
    _, seqs, _, _, scores = run
    src, src_len, seqs, scores = (t[:S2S_HELD].cpu() for t in
                                  (src, src_len, seqs, scores))
    with torch.no_grad():
        forced = beam_scores(torch, cpu_model, src, src_len, seqs)
        ref_seqs, _, ref_scores = seq2seq_beam_search(
            nn, cpu_model, src, src_len, S2S_BEAM, S2S_MAX_OUT)
    size = forced.abs().clamp_min(1.0)
    gap = float(((scores.double() - forced).abs() / size).max())
    # how far each best beam falls below the CPU's, over its size
    below = float(((ref_scores[:, 0] - scores[:, 0]).double()
                   / size[:, 0]).max())
    is_end = (seqs == S2S_EOS).to(torch.int64)
    after_end = (is_end.cumsum(-1) - is_end) > 0
    same = int(sum(torch.equal(a, b) for a, b in zip(seqs, ref_seqs)))
    if not (gap <= 4e-6 and below <= 4e-6
            and bool((seqs[after_end] == S2S_EOS).all())
            and bool((scores[:, :-1] >= scores[:, 1:]).all())):
        raise AssertionError(
            f"seq2seq_decode: the card's beam scores lie {gap} (of their "
            f"size; gate 4e-6) from their teacher-forced log-probabilities "
            f"on the CPU, a best beam falls {below} (gate 4e-6) below the "
            f"CPU search's, tokens follow an end token, or beams are out "
            f"of order")
    return {"sentences": S2S_HELD, "max_rel_score_gap": gap,
            "max_rel_best_below_cpu": below, "same_as_cpu_search": same}


def seq2seq_decode_phase(torch, port, model, initial, dev="cuda"):
    """The trained model in eval mode: ``BeamSearchDecoder(beam_size=10)``
    through ``dynamic_decode`` (32 steps at most) over the first 128
    sentences of ``text.WMT16``'s test split, on the card.  One untimed
    decode, then two timed ones: ms a decode, steps, sentences/s, host
    reads (one a step: the loop's ``finished.all()``).  The beams of a
    briefly trained model end as soon as the end token, the targets'
    commonest, enters them; so the same search with the model's initial
    weights (``initial``), whose beams run all 32 steps, gives the cost of
    a full-length decode.  Gates: sequences of valid tokens, lengths
    within the steps run, the same output each run, and each decode's
    first beams held on the CPU (``hold_beams``)."""
    t0 = time.perf_counter()
    src, src_len = seq2seq_batches(torch, port, "test", S2S_B, 1, dev)[0][:2]
    cpu_model = seq2seq_model(torch, port.nn, port.F, S2S_VOCAB, S2S_HIDDEN,
                              S2S_LAYERS, dropout=S2S_DROPOUT, device="cpu")
    cpu_model.eval()
    model.eval()
    runs = timed_decodes(torch, port.nn, model, src, src_len, 3)
    trained = decode_row(runs, src)
    cpu_model.load_state_dict(model.state_dict())
    trained["held"] = hold_beams(torch, port.nn, cpu_model, src, src_len,
                                 runs[-1])
    model.load_state_dict(initial)
    runs = timed_decodes(torch, port.nn, model, src, src_len, 2)
    full = decode_row(runs, src)
    cpu_model.load_state_dict(initial)
    full["held"] = hold_beams(torch, port.nn, cpu_model, src, src_len,
                              runs[-1])
    emit("seq2seq_decode", beam_size=S2S_BEAM, max_steps=S2S_MAX_OUT,
         sentences=S2S_B, trained=trained, initial_weights=full,
         seconds=time.perf_counter() - t0)


# --- export, the partial graph, the model zoo ----------------------------------

EXPORT_B = 64        # InputSpec([64, 3, 224, 224]): PaddleClas's batch a card
EXPORT_CALLS = 10    # timed calls of each program
IMAGE = 224          # the image side of the three phases
ZOO_B = 64           # PaddleClas's batch a card
ZOO_LR = 0.01        # Momentum(0.01, 0.9, weight_decay=1e-4): no warm-up
ZOO_FAMILIES = (
    ("vgg11", {"batch_norm": True}), ("mobilenet_v1", {}),
    ("mobilenet_v2", {}), ("mobilenet_v3_large", {}),
    ("mobilenet_v3_small", {}), ("alexnet", {}), ("squeezenet1_1", {}),
    ("densenet121", {}), ("googlenet", {}), ("inception_v3", {}),
    ("shufflenet_v2_x1_0", {}))

# A fresh process loading the saved programs with ``jit.load`` alone (no
# model class): argv = directory, timed calls, the programs' names.  The
# flash twin is wrapped to count its calls; each program's first output is
# written beside it.  Each is timed as ``jit.load`` runs it and through
# ``ExportedProgram.module()``, which checks every input at each call.
EXPORT_CHILD = r"""
import json, sys, time
import torch
from paddle_tpu_torch import jit
from paddle_tpu_torch.ops import flash

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
twin = {"calls": 0}
reference = flash.fwd_reference

def counted(*args, **kwargs):
    twin["calls"] += 1
    return reference(*args, **kwargs)

flash.fwd_reference = counted
root, calls = sys.argv[1], int(sys.argv[2])
rows = {}
for name in sys.argv[3:]:
    t0 = time.perf_counter()
    loaded = jit.load(f"{root}/{name}")
    load_s = time.perf_counter() - t0
    x = torch.load(f"{root}/{name}.x.pt").to(loaded.device)
    flash.fwd_launches = 0
    t0 = time.perf_counter()
    out = loaded(x)
    if x.is_cuda:
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    torch.save(out.cpu(), f"{root}/{name}.out.pt")
    for _ in range(2):
        loaded(x)
    ms = {}
    module = loaded.program.module()    # checks every input each call
    for how, run in (("direct", lambda: loaded(x)),
                     ("module", lambda: module(loaded._state, x))):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            run()
        end.record()
        torch.cuda.synchronize()
        ms[how] = start.elapsed_time(end) / calls
    rows[name] = {
        "load_s": load_s, "first_call_s": first_s, "calls": 2 * calls + 3,
        "ms": ms["direct"], "module_ms": ms["module"],
        "fwd_launches": flash.fwd_launches, "twin_calls": twin["calls"],
        "flash_ops": sum(str(n.target) == "paddle_tpu_torch.flash_fwd.default"
                         for n in loaded.program.graph.nodes),
        "device": str(out.device)}
print(json.dumps(rows))
"""


def output_gap(torch, got, want):
    """``got`` against ``want``: the largest gap over the largest value,
    and bit equality."""
    got, want = got.float().cpu(), want.float().cpu()
    scale = max(float(want.abs().max()), 1e-30)
    return {"max_abs_err": float((got - want).abs().max()),
            "rel_err": float((got - want).abs().max()) / scale,
            "bit_equal": bool(torch.equal(got, want))}


def eval_ms(torch, fn, x):
    with torch.no_grad():
        return time_ms(lambda: fn(x), EXPORT_CALLS)


def jit_export_phase(torch, flash, port, dev="cuda"):
    """``jit.save`` of ViT-B/16 (224, bf16, eval; the flash forward as the
    registered ``paddle_tpu_torch::flash_fwd``) and MobileNetV3-Large
    (224, fp32, eval), each with ``InputSpec([64, 3, 224, 224])``; a fresh
    process (``EXPORT_CHILD``) loads both with ``jit.load`` and runs each
    3 + 2 x 10 times.  Gates: the loaded outputs against the saving process's
    eager outputs (fp32 within 1e-5 of the largest logit, bf16 within
    2e-2: two bf16 steps; bit equality reported), the loaded ViT's
    forward launches = calls x 12 and MobileNetV3's 0, no call of the
    flash twin, 12 flash ops in the ViT's graph.  Prints save s, load s,
    the two files' bytes, and ms a batch and images/s of the loaded
    program beside the eager module and a ``to_static`` capture."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(70)
    vit = port.vision.vit_base_patch16_224(
        class_num=1000, device=dev, dtype=torch.bfloat16,
        generator=gen).eval()
    mbv3 = port.vision.mobilenet_v3_large(num_classes=1000, device=dev,
                                          generator=gen).eval()
    root = tempfile.mkdtemp(prefix="jit_export_")
    rows, wants = {}, {}
    try:
        for name, model, dtype in (("vit", vit, "bfloat16"),
                                   ("mbv3", mbv3, "float32")):
            x = torch.rand(EXPORT_B, 3, IMAGE, IMAGE, device=dev,
                           generator=gen).to(getattr(torch, dtype))
            with torch.no_grad():
                wants[name] = model(x).cpu()
            torch.save(x.cpu(), f"{root}/{name}.x.pt")
            t0 = time.perf_counter()
            port.jit.save(model, f"{root}/{name}", input_spec=[
                port.InputSpec([EXPORT_B, 3, IMAGE, IMAGE], dtype)])
            save_s = time.perf_counter() - t0
            captured = port.jit.to_static(lambda v, model=model: model(v))
            rows[name] = {
                "dtype": dtype, "save_s": save_s,
                "pt2_bytes": os.path.getsize(f"{root}/{name}.pt2"),
                "pdiparams_bytes": os.path.getsize(
                    f"{root}/{name}.pdiparams"),
                "eager_ms": eval_ms(torch, model, x),
                "to_static_ms": eval_ms(torch, captured, x),
                "to_static_captures": captured.captures}
        child = subprocess.run(
            [sys.executable, "-c", EXPORT_CHILD, root, str(EXPORT_CALLS),
             "vit", "mbv3"], capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        if child.returncode != 0:
            raise AssertionError(f"jit_export: the loading process failed:"
                                 f"\n{child.stderr[-4000:]}")
        loaded = json.loads(child.stdout.strip().splitlines()[-1])
        for name, want in wants.items():
            row = rows[name]
            row.update(loaded[name])
            row.update(output_gap(torch, torch.load(f"{root}/{name}.out.pt"),
                                  want))
            row["images_per_s"] = EXPORT_B / (row["ms"] / 1e3)
            row["eager_images_per_s"] = EXPORT_B / (row["eager_ms"] / 1e3)
            row["to_static_images_per_s"] = EXPORT_B / (
                row["to_static_ms"] / 1e3)
            tol = 2e-2 if row["dtype"] == "bfloat16" else 1e-5
            flash_due = 12 if name == "vit" else 0
            if (row["rel_err"] > tol or row["twin_calls"]
                    or row["fwd_launches"] != row["calls"] * flash_due
                    or row["flash_ops"] != flash_due
                    or row["device"].split(":")[0] != dev
                    or row["to_static_captures"] != (dev == "cuda")):
                raise AssertionError(f"jit_export {name}: {row}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit("jit_export", batch=EXPORT_B, image=IMAGE, calls=EXPORT_CALLS,
         tolerance={"float32": 1e-5, "bfloat16": 2e-2},
         vit_b16=rows["vit"], mobilenet_v3_large=rows["mbv3"],
         seconds=time.perf_counter() - t_phase)
    return vit, mbv3, rows["vit"]["fwd_launches"]


def scale_idiom(model, runs):
    """The input-scale idiom in front of ``model``: a host read of the
    batch's largest value decides whether to divide by 255."""
    def predict(x):
        runs.append(1)
        if float(x.max()) > 1.0:
            x = x / 255.0
        return model(x)
    return predict


def jit_partial_phase(torch, flash, port, vit, mbv3, dev="cuda"):
    """``to_static`` over MobileNetV3-Large eval at B=64 behind the
    input-scale idiom (``scale_idiom``), on 0-255 batches, under
    ``no_grad``.  Gates: one graph break (its warning names the line);
    one trace of two segments, each a captured CUDA graph after the
    second call; the Python body run by the first call only; outputs
    equal to eager (bit equality reported, 1e-5 of the largest logit the
    gate); a batch already in [0, 1] fails the guard and records a second
    trace with the eager result; a train step with ``backward`` and a
    host read goes eager with the warning naming the autograd tape, and
    trains.  The same function over ViT-B/16 (bf16) puts the flash
    forward inside a segment: launches = calls x 12 across the replays.
    Prints ms a call replayed, eager, and a break-free ``to_static`` (the
    same forward without the host read, captured whole)."""
    import warnings

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(71)
    breaks = port.registry().counter("jit_graph_breaks_total", "")
    row = {}
    with torch.no_grad():
        batches = [torch.randint(0, 256, (EXPORT_B, 3, IMAGE, IMAGE),
                                 device=dev, generator=gen).float()
                   for _ in range(4)]
        want = [mbv3(b / 255.0) for b in batches]
        runs = []
        fn = port.jit.to_static(scale_idiom(mbv3, runs))
        before = breaks.value
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            got = [fn(b) for b in batches]
        store = fn._partial[next(iter(fn._partial))]
        trace = store.traces[0]
        messages = [str(w.message) for w in seen]
        gaps = [output_gap(torch, g, w) for g, w in zip(got, want)]
        row.update(
            graph_breaks=breaks.value - before,
            break_warning=next(m for m in messages if "graph break" in m),
            traces=len(store.traces), segments=len(trace.segments),
            segment_graphs=sum(s.graph is not None for s in trace.segments),
            segment_ops=[len(s.nodes) for s in trace.segments],
            segment_captures=fn.segment_captures, python_runs=len(runs),
            calls=len(batches), max_rel_err=max(g["rel_err"] for g in gaps),
            bit_equal=all(g["bit_equal"] for g in gaps))
        graphs = 2 if dev == "cuda" else 0       # the CPU replays op lists
        if (row["graph_breaks"] != 1 or row["traces"] != 1
                or row["segments"] != 2 or row["segment_graphs"] != graphs
                or row["python_runs"] != 1 or row["max_rel_err"] > 1e-5
                or "chip_smoke.py:" not in row["break_warning"]):
            raise AssertionError(f"jit_partial: {row}")
        row["replay_ms"] = time_ms(lambda: fn(batches[1]), EXPORT_CALLS)
        row["eager_ms"] = time_ms(
            lambda: scale_idiom(mbv3, [])(batches[1]), EXPORT_CALLS)
        whole = port.jit.to_static(lambda x: mbv3(x / 255.0))
        row["whole_to_static_ms"] = time_ms(lambda: whole(batches[1]),
                                            EXPORT_CALLS)
        unit = batches[2] / 255.0
        gap = output_gap(torch, fn(unit), mbv3(unit))
        row["guard_mismatch"] = {"traces": len(store.traces),
                                 "python_runs": len(runs), **gap}
        if len(store.traces) != 2 or len(runs) != 2 or gap["rel_err"] > 1e-5:
            raise AssertionError(f"jit_partial guard: {row}")
        # the flash forward inside a segment
        vruns = []
        vfn = port.jit.to_static(scale_idiom(vit, vruns))
        vx = batches[3].to(torch.bfloat16)
        vwant = vit(vx / 255.0)
        flash.fwd_launches = 0
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            vout = [vfn(vx) for _ in range(EXPORT_CALLS)]
        row["vit"] = {"calls": EXPORT_CALLS,
                      "fwd_launches": flash.fwd_launches,
                      "python_runs": len(vruns),
                      **output_gap(torch, vout[-1], vwant)}
        if (row["vit"]["fwd_launches"] != 12 * EXPORT_CALLS
                or len(vruns) != 1 or row["vit"]["rel_err"] > 2e-2):
            raise AssertionError(f"jit_partial vit: {row['vit']}")
    vit_launches = flash.fwd_launches
    # a train step with a backward and a host read: eager, with a warning
    mbv3.train()
    opt = port.Momentum(learning_rate=ZOO_LR, momentum=0.9,
                        parameters=mbv3.parameters())
    ce = port.nn.CrossEntropyLoss()
    truns = []

    def train_step(x, y):
        truns.append(1)
        loss = ce(mbv3(x), y)
        if float(loss) > 1e9:
            return loss
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    step = port.jit.to_static(train_step)
    x, y = stripe_batches(torch, np.random.default_rng(72), 1, 8, IMAGE)[0]
    x, y = x.to(dev), y.to(dev)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        losses = [float(step(x, y)) for _ in range(3)]
    dead = step._partial[next(iter(step._partial))].dead
    row["train_step"] = {"losses": losses, "python_runs": len(truns),
                         "dead": dead, "warnings": len(seen)}
    if (not dead or "autograd" not in dead or len(truns) != 3
            or not np.isfinite(losses).all() or losses[-1] >= losses[0]):
        raise AssertionError(f"jit_partial train step: {row['train_step']}")
    mbv3.eval()
    del opt, step
    emit("jit_partial", model="mobilenet_v3_large", batch=EXPORT_B,
         image=IMAGE, **row, seconds=time.perf_counter() - t_phase)
    return vit_launches


def zoo_gaps(torch, cpu, card):
    """Each parameter's gradient on the card against the CPU's, as the
    norm of the difference over the CPU gradient's norm: the worst tensor
    and its ratio.  An activation that rounds to the other side of a
    ReLU's 0 on one device drops one term of the sum over the batch and
    positions (2 x 224 x 224 for a first convolution) that makes a weight's
    gradient: about 1/sqrt(2 x 224 x 224), 2e-3, of its norm each; a
    first run saw 2.0e-3 at VGG-11-BN's first convolution.  The gate,
    1e-2, holds a few such flips and catches a wrong layer, whose error
    is of the order of the gradient itself."""
    grads = {n: p.grad for n, p in cpu.named_parameters()}
    worst = ("", 0.0)
    for n, p in card.named_parameters():
        want = grads[n]
        err = float((p.grad.cpu() - want).norm()) / max(
            float(want.norm()), 1e-30)
        worst = max(worst, (n, err), key=lambda w: w[1])
    return worst


def vision_zoo_phase(torch, port, dev="cuda"):
    """Each family of the JAX package's model zoo that the port added
    (``ZOO_FAMILIES``: full widths, 1000 classes, 224x224, eval) runs one
    forward and backward of the outputs' sum at B=2 on the card and on
    the CPU from the same weights (TF32 off): outputs within 1e-4 of the
    largest CPU output, each gradient within 1e-2 of its CPU norm
    (``zoo_gaps`` says why).  Then a captured ``Momentum`` train step (``to_static``,
    fp32, B=64, 224, stripe batches, 10 steps) of VGG-16 and MobileNetV2,
    PaddleClas's one-card configurations: ms a step and images/s by CUDA
    events (the first, eager call and the capturing call apart), peak
    memory, 1 capture and 0 breaks, finite losses."""
    import copy

    t_phase = time.perf_counter()
    families = {}
    x = torch.randn(2, 3, IMAGE, IMAGE,
                    generator=torch.Generator().manual_seed(80))
    for i, (name, kwargs) in enumerate(ZOO_FAMILIES):
        cpu = getattr(port.vision, name)(
            num_classes=1000, device="cpu",
            generator=torch.Generator().manual_seed(81 + i), **kwargs).eval()
        card = copy.deepcopy(cpu).to(dev)
        outs = []
        for model, inp in ((cpu, x), (card, x.to(dev))):
            out = model(inp)
            out = list(out) if isinstance(out, (list, tuple)) else [out]
            sum(o.sum() for o in out).backward()
            outs.append(out)
        out_err = max(float((c.detach().cpu() - w.detach()).abs().max())
                      / float(w.detach().abs().max())
                      for w, c in zip(*outs))
        grad_tensor, grad_err = zoo_gaps(torch, cpu, card)
        families[name] = {
            "params": sum(p.numel() for p in cpu.parameters()),
            "outputs": len(outs[0]), "out_rel_err": out_err,
            "grad_rel_l2_err": grad_err, "grad_worst": grad_tensor}
        if out_err > 1e-4 or grad_err > 1e-2:
            raise AssertionError(f"vision_zoo {name}: card against CPU "
                                 f"{families[name]}")
        del cpu, card, outs
    rng = np.random.default_rng(82)
    ce = port.nn.CrossEntropyLoss()
    breaks = port.registry().counter("jit_graph_breaks_total", "")
    steps = {}
    for name in ("vgg16", "mobilenet_v2"):
        gen = torch.Generator(device=dev).manual_seed(83)
        model = getattr(port.vision, name)(num_classes=1000, device=dev,
                                           generator=gen)
        opt = port.Momentum(learning_rate=ZOO_LR, momentum=0.9,
                            parameters=model.parameters(),
                            weight_decay=1e-4)
        step = port.jit.to_static(classifier_step(model, opt, ce))
        batches = [(x.to(dev), y.to(dev)) for x, y in
                   stripe_batches(torch, rng, 10, ZOO_B, IMAGE)]
        before = breaks.value
        torch.cuda.reset_peak_memory_stats()
        losses, ms = timed_steps(torch, step, batches)
        steady = float(np.mean(ms[2:]))
        steps[name] = {
            "losses": losses, "first_call_ms": ms[0],
            "capture_call_ms": ms[1], "ms_per_step": steady,
            "ms_steps": ms[2:], "images_per_s": ZOO_B / (steady / 1e3),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "captures": step.captures, "graph_breaks": breaks.value - before}
        if (not np.isfinite(losses).all()
                or step.captures != (dev == "cuda")
                or breaks.value != before):
            raise AssertionError(f"vision_zoo {name} steps: {steps[name]}")
        del model, opt, step, batches
        gc.collect()
        torch.cuda.empty_cache()
    emit("vision_zoo", image=IMAGE, batch_card_cpu=2, families=families,
         tolerance={"outputs": "1e-4 of the largest CPU output",
                    "gradients": "1e-2: each tensor's difference norm "
                                 "over its CPU norm"},
         train_steps={"batch": ZOO_B, "dtype": "float32",
                      "optimizer": f"Momentum({ZOO_LR}, 0.9, "
                                   f"weight_decay=1e-4)", **steps},
         seconds=time.perf_counter() - t_phase)


# --- the op bus, AMP O2 and the tensor API -------------------------------------

O2_LAYERS, O2_S, O2_STEPS = 2, 1024, 3    # amp_o2_identity's cut
ROW_TOL = 2e-2                           # the flash checks' bf16 row bound
FP32_MARKS = ("float",)                  # fp32 operands in a kernel's name


def bf16_ulp(v):
    """The spacing of bf16 values around ``v`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(abs(v))) - 7)


def o2_gpt(torch, port, layers, seed):
    """GPT at 6.7B widths built in fp32 from one seed, as a Paddle user
    builds it, with its AdamW, put through ``amp.decorate(level="O2")``:
    every parameter cast to bf16 in place, fp32 masters in the
    optimizer."""
    model = gpt_model(torch, port, layers, torch.float32, seed)
    opt, sched = gpt_trainer(torch, port, model)
    model, opt = port.amp.decorate(model, opt, level="O2")
    if not (opt._use_master_weights and all(
            p.dtype == torch.bfloat16 for p in model.parameters())):
        raise AssertionError("amp_o2: decorate left an fp32 parameter or no "
                             "master weights")
    return model, opt, sched


def o2_loss(port, model, criterion):
    """The step loss under ``auto_cast(level="O2")``."""
    def step_loss(ids):
        with port.amp.auto_cast(level="O2"):
            return criterion(model(ids), ids)
    return step_loss


def o2_op_counts(layers, steps):
    """The ops GPT's O2 steps run in bf16, as the JAX package counts them
    (tests/test_torch_amp_o2.py holds the tiny GPT's dict equal to
    JAX's): per step an embedding, the position add, four linears, the
    qkv split, the attention, the head merge, two residual adds and the
    GELU a layer, the tied head, and the criterion's two slices."""
    per_layer = {"linear": 4, "split_qkv": 1, "ring_attention_fallback": 1,
                 "merge_heads": 1, "add": 2, "gelu": 1}
    out = {"embedding": steps, "add_pos_embed": steps, "tied_head": steps,
           "getitem": 2 * steps}
    out.update({k: v * layers * steps for k, v in per_layer.items()})
    return out


def counted_ops(port, run):
    """``run()`` with the flag ``low_precision_op_list`` on; returns its
    result and the ops AMP ran in low precision."""
    port.amp.debugging.clear_low_precision_op_list()
    port.set_flags({"low_precision_op_list": True})
    try:
        out = run()
    finally:
        port.set_flags({"low_precision_op_list": False})
    return out, port.amp.debugging.low_precision_op_list()


def amp_o2_identity_phase(torch, flash, fa, port):
    """GPT at 6.7B widths cut to 2 layers, built in fp32 from one seed and
    put through O2, B=1, S=1024, 3 AdamW steps under
    ``auto_cast(level="O2")``, three ways from the same weights and
    batches: through the kernels, with attention pinned to the composite,
    and with a planted fault (the attention output's last 64 rows zeroed).
    Gates: the kernel run's losses within 2 bf16 ulps of the composite
    run's (the CPU test's tolerance against the JAX package) and its first
    step's attention outputs, each row within 2e-2 of the composite's row
    (the flash checks' bf16 bound); the planted run fails that gate; B3-B5
    each launch 3 x 2 times (the pinned run none); the
    ``low_precision_op_list`` equal on all three runs and to the CPU
    test's dict at this depth."""
    layers, S, steps = O2_LAYERS, O2_S, O2_STEPS
    rng = np.random.default_rng(14)
    batches = [torch.from_numpy(corpus(rng, 1, S)).cuda()
               for _ in range(steps)]
    runs = {}
    for run in ("kernel", "composite", "planted"):
        model, opt, sched = o2_gpt(torch, port, layers, seed=6)
        outs = []
        reset_flash_counts(flash)
        t0 = time.perf_counter()
        with gpt_attention(port.gpt_mod, run):
            patched = port.gpt_mod.ring_flash_attention

            def recording(q, k, v, causal=True):
                out = patched(q, k, v, causal=causal)
                if len(outs) < layers:      # the first step's, a layer each
                    outs.append(out.detach().float().clone())
                return out

            port.gpt_mod.ring_flash_attention = recording
            losses, ops = counted_ops(port, lambda: train_steps(
                o2_loss(port, model, port.GPTPretrainingCriterion()), opt,
                batches, sched))
        runs[run] = {"losses": [float(x) for x in losses], "outs": outs,
                     "ops": ops, "launches": flash_counts(flash),
                     "path": fa.last_path,
                     "seconds": time.perf_counter() - t0}
        del model, opt
        free(torch)
    ref = runs["composite"]

    def gaps(r):
        return {"loss_ulps": max(abs(a - b) / bf16_ulp(b) for a, b in zip(
                    r["losses"], ref["losses"])),
                "attention_rows": max(flash.rowwise_error(o, w) for o, w in
                                      zip(r["outs"], ref["outs"]))}

    def holds(g):
        return g["loss_ulps"] <= 2 and g["attention_rows"] <= ROW_TOL

    kern, bad = runs["kernel"], runs["planted"]
    kg, pg = gaps(kern), gaps(bad)
    if not (np.isfinite(kern["losses"]).all() and holds(kg)):
        raise AssertionError(f"amp_o2_identity: kernel losses "
                             f"{kern['losses']} against composite "
                             f"{ref['losses']}, gaps {kg}")
    if holds(pg):
        raise AssertionError(f"amp_o2_identity: the planted fault passes "
                             f"the gate: gaps {pg}")
    due = {k: steps * layers for k in FLASH_MARKS}
    if (kern["launches"] != due or bad["launches"] != due
            or any(ref["launches"].values()) or kern["path"] != "cuda"):
        raise AssertionError(f"amp_o2_identity: launches {kern['launches']} "
                             f"/ planted {bad['launches']} (due {due}), "
                             f"composite {ref['launches']}, path "
                             f"{kern['path']}")
    want_ops = o2_op_counts(layers, steps)
    if any(r["ops"] != want_ops for r in runs.values()):
        raise AssertionError(f"amp_o2_identity: low_precision_op_list "
                             f"{ {k: r['ops'] for k, r in runs.items()} }, "
                             f"due {want_ops}")
    for r in runs.values():
        del r["outs"]
    emit("amp_o2_identity", layers=layers, batch=1, seq=S, steps=steps,
         built="float32", level="O2", tol={"loss_ulps": 2,
                                           "attention_rows": ROW_TOL},
         gaps=kg, planted_gaps=pg, low_precision_op_list=want_ops,
         kernel=kern, composite=ref, planted=bad)


def fp32_elementwise_share(kernels):
    """The device-time share of elementwise kernels on fp32 operands (a
    kernel name holding an elementwise mark and ``float`` but not
    ``bfloat``)."""
    busy = sum(kernels.values())
    return (sum(us for k, us in kernels.items()
                if any(m in k.lower() for m in ELEMENTWISE_MARKS)
                and "float" in k.lower() and "bfloat" not in k.lower())
            / busy if busy else None)


def amp_o2_phase(torch, flash, fa, port, obs, bf16_built, resnet_o1):
    """GPT-3 6.7B at the gpt_train configuration (4 layers, B=4, S=2048,
    AdamW under LinearWarmup -> CosineAnnealingDecay, 2 warm-up and 8
    timed steps), built in fp32 and put through AMP O2: ms a step,
    tokens/s, MFU (989 TFLOP/s), peak memory and the optimizer's share,
    beside the bf16-built gpt_train of this run; B3-B5 launch (warm +
    timed) x layers times on route tma with no copy; the losses finite
    and falling.  Then ResNet-50 (B=64, 224x224, Momentum, one
    ``to_static`` step) built in fp32 and put through O2: 10 captured
    steps (ms a step, images/s) beside resnet50_train's O1 figures of this
    run, the profiler window's shares (fp32 elementwise among them), the
    BatchNorm output dtype (bf16: the JAX package's O2 rule on a bf16 conv
    output with bf16 weights), 0 graph breaks, one capture, falling
    losses."""
    layers, warm, timed = 4, 2, 8
    B, S = GPT_B, GPT_S
    model, opt, sched = o2_gpt(torch, port, layers, seed=7)
    rng = np.random.default_rng(13)
    batches = [torch.from_numpy(corpus(rng, B, S)).cuda()
               for _ in range(warm + timed)]
    n_params = sum(p.numel() for p in model.parameters())
    tel = port.TrainStepTelemetry(
        n_params=n_params, num_layers=layers, seq_len=S,
        hidden=model.config.hidden_size, peak_flops=PEAK_FLOPS["bfloat16"],
        registry=obs.MetricsRegistry(), tracer=obs.SpanTracer())
    reset_flash_counts(flash)
    copies = flash.copy_launches
    step_loss = o2_loss(port, model, port.GPTPretrainingCriterion())
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
        raise AssertionError(f"amp_o2: kernel launches {launches}, due {due} "
                             f"(path {fa.last_path}, {route}; due 0 copies "
                             f"on route 'tma')")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"amp_o2: losses {losses} are not finite or do "
                             f"not fall")
    tokens_per_s = B * S * timed / wall
    gpt = {"layers": layers, "batch": B, "seq": S, "warmup_steps": warm,
           "timed_steps": timed, "losses": losses,
           "ms_per_step": wall / timed * 1e3, "tokens_per_s": tokens_per_s,
           "mfu": tel.flops_per_token * tokens_per_s
           / PEAK_FLOPS["bfloat16"], "step_ms": [x * 1e3 for x in step_s],
           "optimizer_ms_per_step": sum(opt_s) / timed * 1e3,
           "optimizer_share": sum(opt_s) / sum(step_s),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "kernel_launches": launches, "kernel_route": route,
           "bf16_built": {k: bf16_built[k] for k in (
               "ms_per_step", "tokens_per_s", "mfu", "optimizer_share",
               "max_memory_allocated")}}
    del model, opt, sched, batches, step_loss
    free(torch)

    # ResNet-50 at O2 under to_static
    rng = np.random.default_rng(40)
    ce = port.nn.CrossEntropyLoss()
    breaks = port.registry().counter("jit_graph_breaks_total", "")
    gen = torch.Generator(device="cuda").manual_seed(41)
    model = port.vision.resnet50(num_classes=1000, device="cuda",
                                 generator=gen)
    opt = port.Momentum(learning_rate=RESNET_LR, momentum=0.9,
                        parameters=model.parameters(), weight_decay=1e-4)
    model, opt = port.amp.decorate(model, opt, level="O2")
    batches = stripe_batches(torch, rng, 11, RESNET_B, 224)
    bn_dtype = []
    hook = model.bn1.register_forward_hook(
        lambda m, i, out: bn_dtype.append(str(out.dtype)))
    with port.amp.auto_cast(level="O2"), torch.no_grad():
        model(batches[0][0][:2])
    hook.remove()
    step = port.jit.to_static(classifier_step(
        model, opt, ce, lambda: port.amp.auto_cast(level="O2")))
    before = breaks.value
    torch.cuda.reset_peak_memory_stats()
    rlosses, ms = timed_steps(torch, step, batches[:10])
    peak = torch.cuda.max_memory_allocated()
    steady = ms[2:]
    if not (np.isfinite(rlosses).all()
            and np.mean(rlosses[-3:]) < np.mean(rlosses[:3])):
        raise AssertionError(f"amp_o2 resnet50: losses {rlosses} are not "
                             f"finite or do not fall")
    if breaks.value != before or step.captures != 1:
        raise AssertionError(f"amp_o2 resnet50: {breaks.value - before} "
                             f"graph breaks, {step.captures} captures")
    if bn_dtype != ["torch.bfloat16"]:
        raise AssertionError(f"amp_o2 resnet50: BatchNorm gave {bn_dtype}, "
                             f"due bf16 (the JAX O2 rule)")
    kernels, wall_us, _ = profile_window(torch, lambda: step(*batches[10]),
                                         2)
    resnet = {
        "losses": rlosses, "first_call_ms": ms[0], "capture_call_ms": ms[1],
        "ms_per_step": float(np.mean(steady)), "ms_steps": steady,
        "images_per_s": RESNET_B / (np.mean(steady) / 1e3),
        "captures": step.captures, "graph_breaks": 0,
        "max_memory_allocated": peak, "batch_norm_dtype": bn_dtype[0],
        **window_summary(kernels, wall_us), "shares": {
            **kernel_shares(kernels),
            "fp32_elementwise": fp32_elementwise_share(kernels)},
        "o1": {k: resnet_o1[k] for k in ("ms_per_step", "images_per_s",
                                         "idle_share", "shares")}}
    del step, model, opt, batches
    free(torch)
    emit("amp_o2", model="gpt3_6.7b", built="float32", level="O2",
         gpt=gpt, resnet50=resnet)
    return launches


def load_tensor_cases():
    """tests/torch_tensor_cases.py, the CPU parity test's table (numpy
    only), from this checkout."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "torch_tensor_cases.py")
    spec = importlib.util.spec_from_file_location("torch_tensor_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tensor_args(torch, cases, args, device):
    out = []
    for a in args:
        if isinstance(a, cases.T):
            out.append(torch.tensor(a.a, device=device))
        elif isinstance(a, list) and a and isinstance(a[0], cases.T):
            out.append(tensor_args(torch, cases, a, device))
        else:
            out.append(a)
    return out


def flat_results(res):
    if isinstance(res, (list, tuple)):
        return [x for r in res for x in flat_results(r)]
    return [res]


def host_value(x, torch):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().resolve_conj().numpy()
    return np.asarray(x)


def median_call_us(torch, fn, n=10_000):
    """The median host time of ``n`` calls of ``fn`` (launches only: the
    device is synchronized once after)."""
    times = np.empty(n)
    for i in range(n):
        t0 = time.perf_counter_ns()
        fn()
        times[i] = time.perf_counter_ns() - t0
    torch.cuda.synchronize()
    return float(np.median(times)) / 1e3


def bus_ops(pt, x):
    """A few ops of the bus in a fixed order (the CPU test's stream)."""
    a = x
    for _ in range(3):
        a = pt.add(a, a)
    a = pt.matmul(a, a, transpose_y=True)
    return pt.tensor.sum(pt.nn.functional.relu(a))


def tensor_api_phase(torch, pt, dispatch, obs):
    """Every case of the CPU parity test (tests/torch_tensor_cases.py) on
    the card against the port's own CPU call, TF32 off: floating results
    within rtol 1e-5 / atol 1e-6, integer and bool ones exact, the same
    dtypes.  Then the bus on the card: a subscriber sees every op; a
    planted NaN raises naming its op; the NaN check inside a captured
    ``to_static`` step neither syncs (no graph break, one capture) nor
    raises; ``low_precision_op_list`` counts the same at O1 and O2 as on
    the CPU.  Last the bus's host cost, the median of 10^4 calls, of
    ``paddle_tpu_torch.add`` against ``torch.add`` with nothing attached,
    under O2 (bf16 inputs: the decision only; fp32 inputs: with the two
    casts) and with one subscriber."""
    cases = load_tensor_cases()
    t0 = time.perf_counter()
    table = {**cases.CASES, **cases.FACTORIES}
    worst, failed = {}, {}
    for name, (fname, args, kwargs) in sorted(table.items()):
        fn = getattr(pt.tensor, fname)
        res = {}
        for dev in ("cuda", "cpu"):
            pt.set_device(dev)
            try:
                res[dev] = flat_results(fn(*tensor_args(
                    torch, cases, args, dev), **kwargs))
            finally:
                pt.set_device(None)
        for g, w in zip(*(map(lambda r: host_value(r, torch), res[d])
                          for d in ("cuda", "cpu"))):
            if g.shape != w.shape or g.dtype != w.dtype:
                failed[name] = f"{g.shape} {g.dtype} vs {w.shape} {w.dtype}"
                continue
            if np.issubdtype(w.dtype, np.inexact):
                err = float(np.max(np.abs(g - w) - 1e-5 * np.abs(w),
                                   initial=0.0))
                worst[name] = max(worst.get(name, 0.0), err)
                if not err <= 1e-6:
                    failed[name] = f"abs err over rtol {err}"
            elif not np.array_equal(g, w):
                failed[name] = "integer/bool results differ"
        if len(res["cuda"]) != len(res["cpu"]):
            failed[name] = "result counts differ"
    if failed:
        raise AssertionError(f"tensor_api: {len(failed)} of {len(table)} "
                             f"cases differ on the card: {failed}")
    table_s = time.perf_counter() - t0

    x = torch.ones(4, 4, device="cuda")
    seen = []
    remove = obs.subscribe_ops(lambda n, dt: seen.append(n))
    try:
        bus_ops(pt, x)
    finally:
        remove()
    want = ["add"] * 3 + ["matmul", "relu", "sum"]
    if seen != want or dispatch._op_timer is not None:
        raise AssertionError(f"tensor_api: the subscriber saw {seen}, due "
                             f"{want}")
    neg = torch.tensor([1.0, -1.0], device="cuda")
    pt.set_flags({"check_nan_inf": True})
    try:
        try:
            pt.tensor.log(neg)
            raise AssertionError("tensor_api: a planted NaN did not raise")
        except FloatingPointError as e:
            nan_msg = str(e)
        if "'log'" not in nan_msg:
            raise AssertionError(f"tensor_api: the NaN error {nan_msg!r} "
                                 f"does not name the op")
        breaks = obs.get_registry().counter(
            "jit_graph_breaks_total", "")
        before = breaks.value
        step = pt.jit.to_static(lambda t: pt.tensor.log(t) * 2.0)
        for _ in range(3):
            out = step(neg)
        captured_nan = bool(torch.isnan(out).any())
        if (breaks.value != before or step.captures != 1
                or not captured_nan):
            raise AssertionError(f"tensor_api: the NaN check in a captured "
                                 f"step: {breaks.value - before} breaks, "
                                 f"{step.captures} captures")
    finally:
        pt.set_flags({"check_nan_inf": False})
    counts = {}
    for dev in ("cuda", "cpu"):
        xd = torch.ones(4, 4, device=dev)
        for level in ("O1", "O2"):
            def run():
                with pt.amp.auto_cast(level=level):
                    return bus_ops(pt, xd)
            counts[f"{dev}_{level}"] = counted_ops(pt, run)[1]
    if (counts["cuda_O1"] != counts["cpu_O1"]
            or counts["cuda_O2"] != counts["cpu_O2"]
            or counts["cuda_O2"] != {"add": 3, "matmul": 1, "relu": 1}):
        raise AssertionError(f"tensor_api: low_precision_op_list {counts}")

    y = torch.ones(8, device="cuda")
    yb = y.bfloat16()
    cost = {"torch_add": median_call_us(torch, lambda: torch.add(y, y)),
            "bus_add": median_call_us(torch, lambda: pt.add(y, y))}
    with pt.amp.auto_cast(level="O2"):
        cost["bus_add_o2_bf16"] = median_call_us(torch,
                                                 lambda: pt.add(yb, yb))
        cost["bus_add_o2_fp32_casts"] = median_call_us(
            torch, lambda: pt.add(y, y))
    remove = obs.subscribe_ops(lambda n, dt: None)
    try:
        cost["bus_add_one_subscriber"] = median_call_us(
            torch, lambda: pt.add(y, y))
    finally:
        remove()
    emit("tensor_api", cases=len(table), table_seconds=table_s,
         worst_err_over_rtol=max(worst.values()), nan_error=nan_msg,
         captured_nan_step={"captures": 1, "graph_breaks": 0},
         low_precision_op_list=counts, host_us_per_call=cost)


def profile_ops_phase(torch, rp, serving, dispatch, LlamaConfig,
                      LlamaForCausalLM):
    """The unified engine at 8B widths cut to 2 layers (bf16, the tma
    route) serves the same prompts with ``profile_ops=True`` and without:
    "Host operator summary" in ``eng.metrics.summary()``, the op timer
    released after each step, the same tokens and the same ragged-kernel
    launches with profiling as without."""
    cfg = LlamaConfig.llama3_8b(num_hidden_layers=2)
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             generator=torch.Generator(
                                 device="cuda").manual_seed(4))
    rng = np.random.default_rng(19)
    prompts = prompts_with_prefix(rng, 4, 50, 300, 32, cfg.vocab_size)
    need = sum(-(-(len(p) + 16) // 16) for p in prompts) + 1
    rows = {}
    for profile in (False, True):
        eng = serving.EngineCore(model, config=serving.EngineConfig(
            num_blocks=need + 16, block_size=16, dtype=torch.bfloat16,
            unified_step=True, profile_ops=profile,
            scheduler=serving.SchedulerConfig(max_num_seqs=4,
                                              max_tokens_per_step=256)))
        rp.launches = rp.simple_launches = rp.tma_launches = 0
        reqs = [eng.add_request(p, sp) for p, sp in zip(
            prompts, sampling(serving, len(prompts), 16, False))]
        released = True
        t0 = time.perf_counter()
        while eng.scheduler.has_work():
            eng.step()
            released &= dispatch._op_timer is None
        torch.cuda.synchronize()
        summary = eng.metrics.summary()
        host = eng.metrics._host_ops
        rows[profile] = {
            "tokens": [list(r.output_tokens) for r in reqs],
            "launches": rp.launches, "tma_launches": rp.tma_launches,
            "steps": eng.ragged_launches, "released": released,
            "seconds": time.perf_counter() - t0,
            "host_summary": "Host operator summary" in summary,
            "host_ops": ({n: {"calls": s.calls, "total_ms": s.total * 1e3}
                          for n, s in sorted(host.stats.items())}
                         if host is not None else {})}
        del eng
    on, off = rows[True], rows[False]
    if not (on["host_summary"] and on["released"] and on["host_ops"]
            and not off["host_summary"]):
        raise AssertionError(f"profile_ops: summary {on['host_summary']} "
                             f"(off: {off['host_summary']}), released "
                             f"{on['released']}, rows {on['host_ops']}")
    if (on["tokens"] != off["tokens"] or on["launches"] != off["launches"]
            or on["launches"] != on["steps"] * cfg.num_hidden_layers
            or on["tma_launches"] != on["launches"]):
        raise AssertionError(f"profile_ops: with profiling {on['launches']} "
                             f"launches ({on['tma_launches']} tma, steps "
                             f"{on['steps']}), without {off['launches']}; "
                             f"tokens equal: {on['tokens'] == off['tokens']}")
    for r in rows.values():
        del r["tokens"]
    emit("profile_ops", layers=2, dtype="bfloat16", prompts=len(prompts),
         profiled=on, unprofiled=off)
    del model
    free(torch)
    return on["launches"]


def mp_serve_row(out, key):
    """The mp_serve fields of B1's or B2's row of the kernels line: each
    rank's launches in mp_serve_identity, mp_serve, mp_fleet_identity and
    mp_disagg_identity (both replicas on the rank), each worker rank's in
    mp_procfleet's first wave (B1 only: the unified step), and the errors
    at a rank's shapes."""
    return {"mp_serve_identity_launches": {r: n[key] for r, n in
                                           out["identity"].items()},
            "mp_serve_launches": {r: n[key] for r, n in
                                  out["serve"].items()},
            "mp_fleet_identity_launches": {r: n["fleet"][key] for r, n in
                                           out["fleet"].items()},
            "mp_disagg_identity_launches": {r: n["disagg"][key] for r, n in
                                            out["fleet"].items()},
            "mp_procfleet_launches": {
                w: (ranks if key == "ragged" else [0] * len(ranks))
                for w, ranks in out["procfleet"].items()},
            "mp_shape": out["shape"][key]}


def kernel_launches(rp, pd, flash, sc):
    """Every kernel's launch count now."""
    return {"ragged": rp.launches, "decode": pd.launches,
            **flash_counts(flash), "scaled": sc.launches}


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
        from paddle_tpu_torch import text as port_text
        from paddle_tpu_torch.nn import functional as port_F
        from paddle_tpu_torch.static import InputSpec
        import paddle_tpu_torch as pt
        from paddle_tpu_torch.core import dispatch
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
    model, prompts, unified_tokens, unified_buckets = identity_phase(
        torch, rp, serving, graphs, LlamaConfig, LlamaForCausalLM)
    mp_serve_ref = identity_legacy_phase(torch, pd, serving, graphs, model,
                                         prompts, unified_tokens)
    mp_serve_ref.update(unified=(unified_tokens, sorted(unified_buckets)),
                        identity_prompts=prompts)
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
    # the legacy families' window only (serve_legacy gates the bursts'
    # launches), 16 new tokens: most of a window's time is the profiler's
    # processing of its events
    profile_phase(torch, serving, graphs, llms["legacy"], vocab,
                  window_name="legacy", label="decode", marks=DECODE_MARKS,
                  new_tokens=16)
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
    # the serve prompts of at most 1024 tokens: the artifact's universe,
    # which each worker warms at boot and again at its respawn, is bounded
    # by the longest
    saved = aot_boot_save(torch, serving, saver,
                          [p for p in prompts if len(p) <= 1024], fleet_spec)
    del saver
    gc.collect()
    torch.cuda.empty_cache()
    aot_boot_phase(serving, saved, fleet_spec)
    procfleet_phase(torch, serving, prompts, fleet_spec, procfleet_cache,
                    server_rows)

    flash_summary = flash_kernel_phase(torch, flash)
    port = SimpleNamespace(
        LlamaConfig=LlamaConfig, LlamaForCausalLM=LlamaForCausalLM,
        LlamaPretrainingCriterion=LlamaPretrainingCriterion, AdamW=AdamW,
        CosineAnnealingDecay=CosineAnnealingDecay)
    train_identity_phase(torch, flash, fa, port)
    train_launches, trainer, train_losses = train_phase(torch, flash, fa,
                                                        port)
    # the flash kernels' device time a launch, read by the profiler inside
    # a training step (a back-to-back window of the flash phase recorded
    # no flash kernel: PERF.md section 7)
    flash_device = train_profile_phase(torch, trainer)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    # tensor- and data-parallel training: the collectives, the mp=2
    # identity against mp=1 and the train phase's model at mp=2, in rank
    # processes started by the port's spawn
    mp_start = time.perf_counter()
    mp_out = mp_phases(torch, flash, SimpleNamespace(
        LlamaConfig=LlamaConfig, LlamaForCausalLM=LlamaForCausalLM,
        LlamaPretrainingCriterion=LlamaPretrainingCriterion, AdamW=AdamW,
        ClipGradByGlobalNorm=port_nn.ClipGradByGlobalNorm),
        train_losses[0])
    mp_seconds = time.perf_counter() - mp_start
    # tensor-parallel serving: B1 and B2 at a rank's shapes, the mp=2
    # identity and serve runs in 2 rank processes over gloo on this card,
    # and server --mp 2
    mp_serve_start = time.perf_counter()
    mp_serve_ref["serve_prompts"] = prompts
    mp_serve_out = mp_serve_phases(torch, rp, pd, flash, mp_serve_ref)
    mp_serve_seconds = time.perf_counter() - mp_serve_start
    # --workers 2 --mp 2: worker processes each the controller of a world
    # of its own, a follower killed and its world respawned
    mp_procfleet_start = time.perf_counter()
    mp_serve_out["procfleet"] = mp_procfleet_phase(torch, serving, prompts,
                                                   procfleet_cache)
    shutil.rmtree(procfleet_cache, ignore_errors=True)
    mp_procfleet_seconds = time.perf_counter() - mp_procfleet_start
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
    gpt_launches, gpt_trainer_state, gpt_record = gpt_train_phase(
        torch, flash, fa, port, obs)
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
    resnet_rows = resnet50_train_phase(torch, port)
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
    gc.collect()
    torch.cuda.empty_cache()
    # sequence models: the RNNs, gradient clipping and beam search through
    # PaddleNLP's seq2seq attention model; it reaches no kernel of the repo
    port = SimpleNamespace(
        nn=port_nn, F=port_F, io=port_io, text=port_text, jit=jit, Adam=Adam,
        registry=obs.get_registry)
    before = kernel_launches(rp, pd, flash, sc)
    seq_start = time.perf_counter()
    rnn_identity_phase(torch, port)
    s2s_model, s2s_initial = seq2seq_train_phase(torch, port)
    seq2seq_decode_phase(torch, port, s2s_model, s2s_initial)
    seq_seconds = time.perf_counter() - seq_start
    del s2s_model, s2s_initial
    after = kernel_launches(rp, pd, flash, sc)
    seq_launches = {k: after[k] - before[k] for k in after}
    if any(seq_launches.values()):
        raise AssertionError(f"the sequence-model phases launched kernels "
                             f"of the repo: {seq_launches}")
    gc.collect()
    torch.cuda.empty_cache()
    # jit.save / jit.load (the flash forward as a registered op), the
    # partial graph around a host read, and the rest of the model zoo
    port = SimpleNamespace(
        vision=vision_models, nn=port_nn, jit=jit, InputSpec=InputSpec,
        Momentum=Momentum, registry=obs.get_registry)
    new_start = time.perf_counter()
    before = kernel_launches(rp, pd, flash, sc)
    vit, mbv3, export_launches = jit_export_phase(torch, flash, port)
    partial_launches = jit_partial_phase(torch, flash, port, vit, mbv3)
    del vit, mbv3
    after = kernel_launches(rp, pd, flash, sc)
    others = {k: after[k] - before[k] for k in after if k != "fwd"}
    if any(others.values()):
        raise AssertionError(f"the export and partial-graph phases "
                             f"launched kernels other than the flash "
                             f"forward: {others}")
    gc.collect()
    torch.cuda.empty_cache()
    before = kernel_launches(rp, pd, flash, sc)
    vision_zoo_phase(torch, port)
    after = kernel_launches(rp, pd, flash, sc)
    zoo_launches = {k: after[k] - before[k] for k in after}
    if any(zoo_launches.values()):
        raise AssertionError(f"vision_zoo launched kernels of the repo: "
                             f"{zoo_launches}")
    new_seconds = time.perf_counter() - new_start
    gc.collect()
    torch.cuda.empty_cache()
    # the op bus, AMP O2 and the eager Paddle API: GPT built in fp32 and
    # trained at O2 through the flash kernels, ResNet-50 at O2, the tensor
    # ops on the card, the serving engine's per-op host table
    o2_start = time.perf_counter()
    port = SimpleNamespace(
        GPTConfig=GPTConfig, GPTForCausalLM=GPTForCausalLM,
        GPTPretrainingCriterion=GPTPretrainingCriterion, gpt_mod=gpt_mod,
        AdamW=AdamW, LinearWarmup=LinearWarmup,
        CosineAnnealingDecay=CosineAnnealingDecay, amp=amp,
        set_flags=pt.set_flags, TrainStepTelemetry=obs.TrainStepTelemetry,
        vision=vision_models, nn=port_nn, jit=jit, Momentum=Momentum,
        registry=obs.get_registry)
    amp_o2_identity_phase(torch, flash, fa, port)
    o2_launches = amp_o2_phase(torch, flash, fa, port, obs, gpt_record,
                               resnet_rows["amp_o1_bf16"])
    tensor_api_phase(torch, pt, dispatch, obs)
    profile_launches = profile_ops_phase(torch, rp, serving, dispatch,
                                         LlamaConfig, LlamaForCausalLM)
    o2_seconds = time.perf_counter() - o2_start
    flash_rows = [{
        "name": f"flash_attention_{key}", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attention.cu",
        "replaces": f"paddle_tpu/ops/pallas_flash.py:{line}",
        "launches": train_launches[key],
        "gpt_train_launches": gpt_launches[key],
        "vit_train_launches": vit_launches[key],
        "imagenet_fit_launches": fit_launches[key],
        "seq2seq_launches": seq_launches[key],
        "jit_export_launches": export_launches if key == "fwd" else 0,
        "jit_partial_launches": partial_launches if key == "fwd" else 0,
        "vision_zoo_launches": zoo_launches[key],
        "amp_o2_launches": o2_launches[key],
        "mp_identity_launches": {r: n[key] for r, n in
                                 mp_out["identity"].items()},
        "mp_train_launches": {r: n[key] for r, n in
                              mp_out["train"].items()},
        "mp_shape": mp_out["shape"][key],
        "device_ms": flash_device[key],
        "vit_train_device_ms": vit_device[key],
        "vit_shape": vit_flash[key],
        **{f: flash_summary[key][f] for f in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}}
        for key, line in (("fwd", 52), ("dq", 153), ("dkv", 195))]

    # the time budget: the sequence-model phases and the whole script
    emit("budget", sequence_phases_s=seq_seconds,
         export_partial_zoo_s=new_seconds, bus_amp_o2_s=o2_seconds,
         mp_phases_s=mp_seconds, mp_serve_s=mp_serve_seconds,
         mp_procfleet_s=mp_procfleet_seconds, limit_s=1200)
    print(json.dumps({"kernels": [{
        "name": KERNEL_NAME, "route": "cuda",
        "source": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "paddle_tpu/ops/ragged_paged.py:111",
        "launches": launches, "seq2seq_launches": seq_launches["ragged"],
        **mp_serve_row(mp_serve_out, "ragged"),
        "profile_ops_launches": profile_launches,
        "vision_zoo_launches": zoo_launches["ragged"],
        "max_abs_err": summary["max_abs_err"],
        "ms": summary["ms"], "device_ms": summary["device_ms"],
        "plain_ms": summary["plain_ms"],
        "bound_ms": summary["bound_ms"], "bound_by": summary["bound_by"],
        "library_ms": summary["library_ms"]}, {
        "name": DECODE_NAME, "route": "cuda",
        "source": "paddle_tpu_torch/csrc/paged_decode_attention.cu",
        "replaces": "paddle_tpu/ops/pallas_paged.py:45",
        "launches": decode_launches,
        "seq2seq_launches": seq_launches["decode"],
        **mp_serve_row(mp_serve_out, "decode"),
        "vision_zoo_launches": zoo_launches["decode"],
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
        "seq2seq_launches": seq_launches["scaled"],
        "vision_zoo_launches": zoo_launches["scaled"],
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
