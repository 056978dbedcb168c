"""Rank bodies of the port's distributed CPU tests.

``tests/test_torch_collective.py``, ``tests/test_torch_mp_layers.py`` and
``tests/test_torch_tp_training.py`` each start one world of 4 ranks
(``tests/test_torch_tp_serving.py`` one of 2) with
``paddle_tpu_torch.distributed.spawn`` (gloo on the CPU) running one
function of this module; each rank writes what it computed to
``{out}/{name}_rank{r}.npz`` and the test holds it against the JAX package
run in the test's own process.  This module imports torch and the port
only: a spawned rank never imports JAX.

The inputs every side computes from are made here too
(``collective_inputs``), so the ranks and the JAX side read the same
numbers.
"""

from __future__ import annotations

import os

import numpy as np
import torch

WORLD = 4
PG_TIMEOUT = 90      # seconds a collective may wait for a peer
JOIN_TIMEOUT = 240   # seconds the test waits for the whole world


def start_world(func, *args, nprocs=WORLD):
    """Start ``func(*args)`` on ``nprocs`` (4) gloo ranks through the port's
    ``spawn``, with the process group's and the join's own timeouts;
    ``join()`` the returned context."""
    from paddle_tpu_torch.distributed.spawn import spawn

    return spawn(func, args=args, nprocs=nprocs, backend="gloo",
                 pg_timeout=PG_TIMEOUT, timeout=JOIN_TIMEOUT, join=False)


def spawn_world(func, *args):
    """``func(*args)`` on 4 gloo ranks, waited for."""
    start_world(func, *args).join()


def load(out, name, rank):
    with np.load(os.path.join(out, f"{name}_rank{rank}.npz")) as f:
        return {k: f[k] for k in f.files}


def _init():
    torch.set_num_threads(1)
    from paddle_tpu_torch import distributed as dist

    dist.init_parallel_env()
    return dist


def _save(out, name, **arrays):
    from paddle_tpu_torch import distributed as dist

    np.savez(os.path.join(out, f"{name}_rank{dist.get_rank()}.npz"),
             **{k: np.asarray(v) for k, v in arrays.items()})


def _np(t):
    return t.detach().cpu().numpy().copy()     # never a view of the tensor


# --- collectives --------------------------------------------------------------

def collective_inputs(rank: int) -> dict:
    """Rank ``rank``'s inputs of every collective case."""
    rng = np.random.default_rng(100 + rank)
    return {"x": rng.standard_normal((3, 4)).astype(np.float32),
            "pos": rng.uniform(0.5, 1.5, (3, 4)).astype(np.float32),
            "blocks": rng.standard_normal((WORLD * 2, 4)).astype(np.float32),
            "parts": rng.standard_normal((WORLD, 2)).astype(np.float32),
            "scatter": rng.standard_normal((WORLD, 3)).astype(np.float32)}


def collectives_rank(out):
    dist = _init()
    from paddle_tpu_torch.distributed import collective, topology
    from paddle_tpu_torch.distributed.communication import stream

    rank = dist.get_rank()
    inp = {k: torch.from_numpy(v) for k, v in collective_inputs(rank).items()}
    res = {"rank": rank, "world": dist.get_world_size()}
    R = dist.ReduceOp
    for name, op, key in (("sum", R.SUM, "x"), ("max", R.MAX, "x"),
                          ("min", R.MIN, "x"), ("prod", R.PROD, "pos"),
                          ("avg", R.AVG, "x")):
        t = inp[key].clone()
        task = dist.all_reduce(t, op=op)
        assert task.is_completed()
        res[f"all_reduce_{name}"] = _np(t)
    gathered = []
    dist.all_gather(gathered, inp["x"])
    res["all_gather"] = np.stack([_np(g) for g in gathered])
    # a full output list is written in place, element by element
    full = [torch.zeros(3, 4) for _ in range(WORLD)]
    ids = [id(t) for t in full]
    dist.all_gather(full, inp["x"])
    assert [id(t) for t in full] == ids
    res["all_gather_inplace"] = np.stack([_np(g) for g in full])
    rs = torch.zeros(2, 4)
    dist.reduce_scatter(rs, inp["blocks"])
    res["reduce_scatter"] = _np(rs)
    rs_list = torch.zeros(2, 4)
    dist.reduce_scatter(rs_list, list(inp["blocks"].chunk(WORLD)))
    res["reduce_scatter_list"] = _np(rs_list)
    b = inp["x"].clone()
    dist.broadcast(b, src=2)
    res["broadcast"] = _np(b)
    sc = torch.zeros(3)
    dist.scatter(sc, list(inp["scatter"]) if rank == 1 else None, src=1)
    res["scatter"] = _np(sc)
    red = inp["x"].clone()
    dist.reduce(red, dst=3)
    res["reduce"] = _np(red)
    a2a = []
    dist.alltoall(a2a, list(inp["parts"]))
    res["alltoall"] = np.stack([_np(t) for t in a2a])
    single = torch.zeros(WORLD * 2, 4)
    dist.alltoall_single(single, inp["blocks"])
    res["alltoall_single"] = _np(single)
    # the ring: each rank sends x to the next, receives from the previous
    got = torch.zeros(3, 4)
    send = dist.isend(inp["x"], dst=(rank + 1) % WORLD)
    recv = dist.irecv(got, src=(rank - 1) % WORLD)
    send.wait()
    recv.wait()
    res["ring"] = _np(got)
    # sync_op=False: the tensor and the list hold the result after wait()
    t = inp["x"].clone()
    task = dist.all_reduce(t, sync_op=False)
    task.wait()
    assert task.is_completed()
    res["async_all_reduce"] = _np(t)
    lst = []
    task = dist.all_gather(lst, inp["x"], sync_op=False)
    task.wait()
    res["async_all_gather"] = np.stack([_np(g) for g in lst])
    t = inp["x"].clone()
    stream.all_reduce(t, sync_op=False, use_calc_stream=True)
    res["stream_all_reduce"] = _np(t)
    # a group of ranks 1 and 3; the others are not members
    sub = dist.new_group([1, 3])
    t = inp["x"].clone()
    dist.all_reduce(t, group=sub)
    res["subgroup"] = _np(t)
    res["subgroup_rank"] = sub.rank
    dist.barrier()
    # the backend's refusal names the backend
    real = collective.dist.all_reduce

    def refuse(*args, **kwargs):
        raise RuntimeError("ProcessGroupGloo::allreduce: unsupported device "
                           "type")

    collective.dist.all_reduce = refuse
    try:
        dist.all_reduce(inp["x"].clone())
    except NotImplementedError as e:
        res["refusal"] = str(e)
    finally:
        collective.dist.all_reduce = real
    # the topology at dp2 x mp2
    mesh = topology.init_mesh(dp=2, mp=2)
    hcg = topology.get_hybrid_communicate_group()
    res["hcg"] = np.array([hcg.get_data_parallel_rank(),
                           hcg.get_model_parallel_rank(),
                           hcg.get_data_parallel_world_size(),
                           hcg.get_model_parallel_world_size()])
    res["mp_group"] = np.array(hcg.get_model_parallel_group().ranks)
    res["dp_group"] = np.array(hcg.get_data_parallel_group().ranks)
    res["mesh"] = mesh.ranks
    t = inp["x"].clone()
    dist.all_reduce(t, group=hcg.get_model_parallel_group())
    res["mp_all_reduce"] = _np(t)
    res["calls"] = np.array([collective.stats["calls"]["all_reduce"],
                             collective.stats["calls"]["all_gather"]])
    _save(out, "collectives", **res)
    dist.destroy_process_group()


def failing_rank(out):
    """Rank 2 raises; the others wait in a collective for it."""
    dist = _init()
    if dist.get_rank() == 2:
        raise ValueError("rank 2 fails on purpose")
    dist.all_reduce(torch.ones(2))


def hanging_rank(out, seconds):
    """Rank 1 sleeps ``seconds`` before the all-reduce the others wait in."""
    import time

    dist = _init()
    if dist.get_rank() == 1:
        time.sleep(seconds)
    dist.all_reduce(torch.ones(2))


# --- the tensor-parallel layers, clipping, the RNG tracker, SyncBatchNorm,
# --- DataParallel ---------------------------------------------------------------

def unshard(local, param, group):
    """The full tensor of ``param``'s slices ``local`` (a gradient) over
    ``group``: each rank's slice of every block, in rank order."""
    from paddle_tpu_torch.distributed import collective

    if getattr(param, "mp_group", None) is None:
        return local
    parts = []
    collective.all_gather(parts, local.contiguous(), group=group)
    dim, blocks = param.split_axis, param.split_blocks
    chunks = [p.chunk(blocks, dim) for p in parts]
    return torch.cat([c[b] for b in range(blocks) for c in chunks], dim)


def _load_weight(layer, arrays, prefix, linear=True):
    """Set ``layer``'s parameters from the JAX layout's full arrays."""
    from paddle_tpu_torch.parallel.utils import param_shard

    with torch.no_grad():
        for name, p in layer.named_parameters():
            full = torch.from_numpy(arrays[f"{prefix}.{name}"])
            if linear and name == "weight":
                full = full.T
            p.copy_(param_shard(p, full.contiguous()))


def _grads(layer, group, prefix, res, linear=True):
    for name, p in layer.named_parameters():
        g = unshard(p.grad, p, group)
        if linear and name == "weight":
            g = g.T
        res[f"{prefix}.{name}.grad"] = _np(g)


def mp_layers_rank(out, arrays_path):
    dist = _init()
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import topology
    from paddle_tpu_torch.parallel import (
        ColumnParallelLinear,
        ParallelCrossEntropy,
        RowParallelLinear,
        VocabParallelEmbedding,
        random as mp_random,
    )

    a = dict(np.load(arrays_path))
    topology.init_mesh(mp=WORLD)
    group = topology.get_hybrid_communicate_group().get_model_parallel_group()
    res = {}
    # tests/test_parallel.py::test_column_row_pair_matches_dense
    col = ColumnParallelLinear(16, 32, gather_output=False)
    row = RowParallelLinear(32, 16, input_is_parallel=True)
    _load_weight(col, a, "pair.col")
    _load_weight(row, a, "pair.row")
    x = torch.from_numpy(a["pair.x"]).requires_grad_()
    y = row(col(x))
    (y * torch.from_numpy(a["pair.dy"])).sum().backward()
    res["pair.out"] = _np(y)
    res["pair.x.grad"] = _np(x.grad)
    _grads(col, group, "pair.col", res)
    _grads(row, group, "pair.row", res)
    # the global-norm clip over the pair's gradients: sliced and whole ones
    pairs = [(p, p.grad) for p in list(col.parameters()) +
             list(row.parameters())]
    clipped = nn.ClipGradByGlobalNorm(float(a["clip_norm"]))(pairs)
    for (p, g), name in zip(clipped, ["col.weight", "col.bias", "row.weight",
                                      "row.bias"]):
        g = unshard(g, p, group)
        res[f"clip.{name}"] = _np(g.T if name.endswith("weight") else g)
    # test_column_parallel_grads
    col = ColumnParallelLinear(8, 16, gather_output=True)
    _load_weight(col, a, "gather.col")
    x = torch.from_numpy(a["gather.x"])
    y = col(x)
    y.sum().backward()
    res["gather.out"] = _np(y)
    _grads(col, group, "gather.col", res)
    # test_vocab_parallel_embedding
    emb = VocabParallelEmbedding(32, 16)
    _load_weight(emb, a, "emb", linear=False)
    y = emb(torch.from_numpy(a["emb.ids"]))
    (y * torch.from_numpy(a["emb.dy"])).sum().backward()
    res["emb.out"] = _np(y)
    _grads(emb, group, "emb", res, linear=False)
    # test_2d_input_tp_layers, and a row layer slicing a full input
    col = ColumnParallelLinear(16, 8, gather_output=False)
    row = RowParallelLinear(8, 16, input_is_parallel=True)
    _load_weight(col, a, "flat.col")
    _load_weight(row, a, "flat.row")
    y = row(col(torch.from_numpy(a["flat.x"])))
    y.sum().backward()
    res["flat.out"] = _np(y)
    _grads(col, group, "flat.col", res)
    _grads(row, group, "flat.row", res)
    row = RowParallelLinear(16, 8, input_is_parallel=False)
    _load_weight(row, a, "split.row")
    x = torch.from_numpy(a["split.x"]).requires_grad_()
    y = row(x)
    (y * torch.from_numpy(a["split.dy"])).sum().backward()
    res["split.out"] = _np(y)
    res["split.x.grad"] = _np(x.grad)
    _grads(row, group, "split.row", res)
    # ParallelCrossEntropy over the rank's vocab slice
    logits = torch.from_numpy(a["ce.logits"])
    per = logits.shape[-1] // WORLD
    r = group.rank
    local = logits[:, r * per:(r + 1) * per].clone().requires_grad_()
    loss = ParallelCrossEntropy()(local, torch.from_numpy(a["ce.labels"]))
    loss.backward()
    res["ce.loss"] = _np(loss)
    parts = []
    dist.all_gather(parts, local.grad, group=group)
    res["ce.grad"] = _np(torch.cat(parts, -1))
    # the RNG tracker at dp2 x mp2: mp ranks differ inside, agree outside
    topology.init_mesh(dp=2, mp=2)
    mp_random.model_parallel_random_seed(1234)
    outside = torch.rand(4)
    with mp_random.dropout_state():
        inside = torch.rand(4)
        dropped = nn.functional.dropout(torch.ones(8), 0.5)
    after = torch.rand(4)
    with mp_random.dropout_state():
        inside2 = torch.rand(4)
    res.update(rng_outside=_np(outside), rng_inside=_np(inside),
               rng_dropout=_np(dropped), rng_after=_np(after),
               rng_inside2=_np(inside2))
    # SyncBatchNorm over a dp group of 4: each rank a quarter of the batch
    topology.init_mesh(dp=WORLD)
    bn = nn.SyncBatchNorm(3, device="cpu")
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(a["bn.weight"]))
        bn.bias.copy_(torch.from_numpy(a["bn.bias"]))
    rank = dist.get_rank()
    q = a["bn.x"].shape[0] // WORLD
    x = torch.from_numpy(a["bn.x"][rank * q:(rank + 1) * q]).requires_grad_()
    y = bn(x)
    (y * torch.from_numpy(a["bn.dy"][rank * q:(rank + 1) * q])).sum() \
        .backward()
    res.update({"bn.out": _np(y), "bn.x.grad": _np(x.grad),
                "bn.weight.grad": _np(bn.weight.grad),
                "bn.bias.grad": _np(bn.bias.grad),
                "bn.mean": _np(bn._mean), "bn.variance": _np(bn._variance)})
    converted = nn.SyncBatchNorm.convert_sync_batchnorm(
        torch.nn.Sequential(nn.BatchNorm2D(3), torch.nn.ReLU()))
    res["bn.converted"] = type(converted[0]).__name__
    # DataParallel over the 4 ranks: small buckets, then no_sync
    model = torch.nn.Sequential(nn.Linear(6, 5), torch.nn.Tanh(),
                                nn.Linear(5, 3))
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(a[f"dp.{name}"]))
    ddp = dist.DataParallel(model, comm_buffer_size=0.00005)
    q = a["dp.x"].shape[0] // WORLD
    xs = torch.from_numpy(a["dp.x"][rank * q:(rank + 1) * q])
    ddp(xs).square().mean().backward()
    for name, p in model.named_parameters():
        res[f"dp.{name}.grad"] = _np(p.grad)
        p.grad = None
    with ddp.no_sync():
        ddp(xs).square().mean().backward()
    res["dp.local.0.weight.grad"] = _np(model[0].weight.grad)
    ddp(xs).square().mean().backward()
    for name, p in model.named_parameters():
        res[f"dp.accum.{name}.grad"] = _np(p.grad)
    # the buckets torch's reducer settled on after the first backward
    sizes = ddp._ddp._get_ddp_logging_data()["rebuilt_bucket_sizes"]
    res["dp.buckets"] = len(sizes.split(","))
    _save(out, "mp_layers", **res)
    dist.destroy_process_group()


# --- tensor- and data-parallel training -----------------------------------------

def tp_training_rank(out, path):
    """Tiny Llama at dp2 x mp2 through ``fleet``: 3 clipped AdamW steps on
    the JAX weights; then tiny GPT at mp=4: its logits on the JAX
    weights."""
    dist = _init()
    from paddle_tpu_torch import convert, nn
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import (
        GPTConfig,
        LlamaConfig,
        LlamaForCausalLM,
        LlamaPretrainingCriterion,
    )
    from paddle_tpu_torch.optimizer import AdamW

    a = dict(np.load(path))
    res = {}
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 2}
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    dp, mp = hcg.get_data_parallel_rank(), hcg.get_model_parallel_rank()
    mp_group, dp_group = (hcg.get_model_parallel_group(),
                          hcg.get_data_parallel_group())
    state = {k[6:]: v for k, v in a.items() if k.startswith("llama.")}
    cfg = LlamaConfig.tiny(num_hidden_layers=2)
    model = convert.llama_from_paddle_tpu(state, cfg, device="cpu",
                                          mp_rank=mp, mp_degree=2)
    try:
        convert.shard_paddle_tpu_state(state, model, mp_rank=1 - mp,
                                       mp_degree=2)
    except ValueError as e:
        res["wrong_rank"] = str(e)
    res["local_heads"] = np.array([model.llama.layers[0].self_attn.num_heads,
                                   model.llama.layers[0].self_attn
                                   .num_kv_heads])
    ddp = fleet.distributed_model(model)
    res["wrapped"] = type(ddp).__name__
    crit = LlamaPretrainingCriterion(cfg)
    opt = fleet.distributed_optimizer(AdamW(
        learning_rate=1e-3, parameters=model.parameters(), weight_decay=0.01,
        grad_clip=nn.ClipGradByGlobalNorm(float(a["clip_norm"]))))
    ids = torch.from_numpy(a["ids"])
    half = ids.shape[0] // 2
    local = ids[dp * half:(dp + 1) * half]
    linear = convert.linear_weights(model)
    losses = []
    for step in range(3):
        logits = ddp(local)
        loss = crit(logits, local)
        loss.backward()
        if step == 0:
            res["logits0"] = _np(logits)
            for name, p in model.named_parameters():
                g = unshard(p.grad, p, mp_group)
                res[f"grad.{name}"] = _np(g.T if name in linear else g)
        opt.step()
        opt.clear_grad()
        mean = loss.detach().clone()
        dist.all_reduce(mean, group=dp_group)
        losses.append(float(mean) / dp_group.nranks)
    res["losses"] = np.array(losses)
    pipeline = fleet.DistributedStrategy()
    pipeline.hybrid_configs = {"dp_degree": 2, "pp_degree": 2}
    try:
        fleet.init(is_collective=True, strategy=pipeline)
    except NotImplementedError as e:
        res["pp_error"] = str(e)
    mp4 = fleet.DistributedStrategy()
    mp4.hybrid_configs = {"mp_degree": WORLD}     # dp inferred: 1
    fleet.init(is_collective=True, strategy=mp4)
    res["mp4_topology"] = np.array(
        [fleet.get_hybrid_communicate_group().topology()[k]
         for k in ("dp", "mp")])
    try:
        LlamaForCausalLM(cfg, device="cpu")
    except ValueError as e:
        res["mp4_error"] = str(e)
    gstate = {k[4:]: v for k, v in a.items() if k.startswith("gpt.")}
    gcfg = GPTConfig.tiny()
    gpt = convert.gpt_from_paddle_tpu(gstate, gcfg, device="cpu")
    res["gpt_wrapped"] = type(fleet.distributed_model(gpt)).__name__
    gids = torch.from_numpy(a["gpt_ids"])
    glogits = gpt(gids)
    gloss = LlamaPretrainingCriterion()(glogits, gids)
    gloss.backward()
    res["gpt_logits"] = _np(glogits)
    res["gpt_loss"] = _np(gloss)
    qkv = gpt.gpt.layers[0].attn.qkv_proj.weight
    res["gpt_qkv_grad"] = _np(unshard(qkv.grad, qkv, qkv.mp_group).T)
    _save(out, "tp_training", **res)
    dist.destroy_process_group()


# --- tensor-parallel serving ----------------------------------------------------

TP = 2
_TP_RNG = np.random.default_rng(7)
TP_PREFIX = _TP_RNG.integers(0, 256, 8).tolist()
TP_PROMPTS = [TP_PREFIX + _TP_RNG.integers(0, 256, 8).tolist()
              for _ in range(5)]
# tests/test_serving_mp.py's scenarios and test_zzzzzzzzz_burst.py's mp=2
# burst run: the engine's fields and its waves of (prompts, new tokens)
TP_SCENARIOS = {
    "plain": (dict(num_blocks=64), [(TP_PROMPTS, 6)]),
    "preemption": (dict(num_blocks=12), [(TP_PROMPTS, 8)]),
    "warm_prefix": (dict(num_blocks=64), [
        ([TP_PREFIX + [3, 1, 4, 1]], 4),
        ([TP_PREFIX + t for t in ([9, 2, 6], [5, 3, 5], [8, 9, 7])], 6)]),
    "chunked": (dict(num_blocks=64, budget=8), [(TP_PROMPTS, 6)]),
    "burst": (dict(num_blocks=64, burst=8), [(TP_PROMPTS, 8)]),
}
TP_FAMILIES = ("unified", "legacy")
TP_GENERATE = dict(temperature=0.0)
TP_GENERATE_IDS = np.random.default_rng(11).integers(0, 256, (2, 6))


def tp_config(serving, family, num_blocks, budget=None, burst=0, **kw):
    """One scenario's ``EngineConfig`` in ``serving`` (the port's or the
    JAX package's: the same names)."""
    return serving.EngineConfig(
        num_blocks=num_blocks, block_size=4,
        unified_step=family == "unified", burst_steps=burst,
        scheduler=serving.SchedulerConfig(
            max_num_seqs=4, max_prefill_tokens_per_step=budget), **kw)


def tp_waves(eng, SamplingParams, waves):
    """Run the waves to their end; every request's greedy tokens."""
    outs = []
    for prompts, max_new in waves:
        reqs = [eng.add_request(p, SamplingParams(max_new_tokens=max_new))
                for p in prompts]
        eng.run(max_steps=4000)
        assert all(r.finished for r in reqs)
        outs += [[int(t) for t in r.output_tokens] for r in reqs]
    return outs


def tp_buckets(eng):
    return sorted(list(b) for b in (eng.prefill_buckets | eng.decode_buckets
                                    | eng.ragged_buckets | eng.burst_buckets))


def tp_traces(eng):
    return (eng.prefill_trace_count + eng.decode_trace_count
            + eng.ragged_trace_count + eng.burst_trace_count)


def tp_pool_invariant(eng):
    kv = eng.kv
    return len(kv._free) + len(kv._reuse) + len(kv._ref) + 1 == kv.num_blocks


def tp_metric(text, name, phase=None):
    """The value of one sample line of a Prometheus page."""
    key = name + ("" if phase is None else '{phase="%s"}' % phase)
    for line in text.splitlines():
        if line.startswith(key + " "):
            return float(line.split()[-1])
    raise KeyError(key)


def _raises(fn):
    try:
        fn()
    except Exception as e:     # the test reads the type and the message
        return f"{type(e).__name__}: {e}"
    return "no error"


def tp_scenario_row(eng, text):
    """What the controller reports of one scenario's engine."""
    return dict(
        buckets=tp_buckets(eng), traces=tp_traces(eng),
        counters={k: eng.metrics.counters[k] for k in (
            "preemptions", "prefix_cache_hit_tokens",
            "chunked_prefill_steps")},
        burst_launches=eng._burst_counters["launches"].value,
        occupancy=eng.kv.occupancy(),
        mp_shards=tp_metric(text, "serving_mp_shards"),
        collective={ph: tp_metric(text, "serving_collective_seconds_count",
                                  ph)
                    for ph in ("prefill", "decode", "ragged", "burst")})


def _save_pools(out, name, eng):
    np.savez(os.path.join(out, f"{name}.npz"),
             **{f"k{i}": _np(k) for i, k in enumerate(eng._k_pools)})


def tp_serving_rank(out, path):
    """Every scenario of tests/test_torch_tp_serving.py on this rank of an
    mp=2 world, on the JAX weights: rank 0 is the controller, rank 1
    follows.  Then rank 0 alone runs every scenario at mp=1 on the whole
    model.  Writes ``tp_serving_rank{r}.json`` (and the plain unified
    runs' K pools to ``tp_pools_rank{r}.npz`` and ``tp_pools_mp1.npz``)."""
    import json

    dist = _init()
    from paddle_tpu_torch import convert, serving
    from paddle_tpu_torch.distributed import collective, topology
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import tp

    rank = dist.get_rank()
    a = dict(np.load(path))
    topology.init_mesh(mp=TP)
    cfg = LlamaConfig.tiny(num_hidden_layers=2)
    model = convert.llama_from_paddle_tpu(a, cfg, device="cpu",
                                          mp_rank=rank, mp_degree=TP)
    res = {"rank": rank, "scenarios": {}}
    for name, (fields, waves) in TP_SCENARIOS.items():
        for family in TP_FAMILIES:
            eng = serving.EngineCore(model, config=tp_config(
                serving, family, **fields))
            collective.reset_stats()
            row = {"sampled": []}
            run = eng.graphs.run

            def recorded(*args, run=run, row=row, **kw):
                out = run(*args, **kw)
                row["sampled"].append(_np(out[0]).tolist())
                return out

            eng.graphs.run = recorded
            if eng.tp.is_controller:
                row["tokens"] = tp_waves(eng, serving.SamplingParams, waves)
                eng.tp.release()
                row.update(tp_scenario_row(eng, eng.metrics.prometheus_text()))
            else:
                row["launches"] = tp.follow(eng)
                row["step_error"] = _raises(eng.step)
            row.update(captures=eng.graphs.captures,
                       eager_reason=eng.graphs.eager_reason,
                       forwards=eng.tp.forwards,
                       calls=dict(collective.stats["calls"]),
                       pool_invariant=tp_pool_invariant(eng),
                       pool_shape=list(eng._k_pools[0].shape))
            if name == "plain" and family == "unified":
                _save_pools(out, f"tp_pools_rank{rank}", eng)
            res["scenarios"][f"{name}.{family}"] = row
            del eng
    # LLM.generate as SPMD: every rank calls it, every rank returns the
    # controller's outputs
    llm = serving.LLM(model, num_blocks=64, block_size=4, max_num_seqs=4)
    res["llm"] = [o.token_ids for o in llm.generate(
        TP_PROMPTS, serving.SamplingParams(max_new_tokens=6))]
    del llm
    # generate and the dense-cache route on this rank's heads
    ids = torch.from_numpy(TP_GENERATE_IDS)
    res["generate"] = model.generate(ids, max_new_tokens=6,
                                     **TP_GENERATE).tolist()
    shape = (2, 7, model.llama.layers[0].self_attn.num_kv_heads,
             cfg.head_dim)
    caches = [(torch.zeros(shape), torch.zeros(shape)) for _ in range(2)]
    with torch.no_grad():
        pre = model(ids, caches=caches, pos=0)[:, -1]
        dec = model(ids[:, :1], caches=caches, pos=6)[:, -1]
    res["logits"] = {"prefill": _np(pre).tolist(),
                     "decode": _np(dec).tolist()}
    # C13: the legacy families take the kernel flag at mp > 1
    res["c13"] = _raises(lambda: serving.EngineCore(
        model, num_blocks=16, block_size=4, use_pallas_paged=True))
    # the engine's own checks: a model of mp=1 and heads mp cannot split
    hcg = topology.get_hybrid_communicate_group()
    topology.set_hybrid_communicate_group(None)
    whole = LlamaForCausalLM(cfg, device="cpu")
    one_kv = LlamaForCausalLM(LlamaConfig.tiny(
        num_hidden_layers=1, num_key_value_heads=1), device="cpu")
    topology.set_hybrid_communicate_group(hcg)
    res["errors"] = {
        "whole_model": _raises(lambda: serving.EngineCore(whole)),
        "one_kv_head": _raises(lambda: serving.EngineCore(one_kv)),
        "mismatch": _raises(lambda: serving.EngineCore(
            model, config=serving.EngineConfig(mp=4))),
    }
    if rank == 0:
        # mp=1: the whole model, no topology
        topology.set_hybrid_communicate_group(None)
        whole = convert.llama_from_paddle_tpu(a, cfg, device="cpu")
        res["mp1"] = {}
        for name, (fields, waves) in TP_SCENARIOS.items():
            for family in TP_FAMILIES:
                eng = serving.EngineCore(whole, config=tp_config(
                    serving, family, **fields))
                row = {"tokens": tp_waves(eng, serving.SamplingParams,
                                          waves)}
                row.update(tp_scenario_row(eng, eng.metrics.prometheus_text()))
                res["mp1"][f"{name}.{family}"] = row
                if name == "plain" and family == "unified":
                    _save_pools(out, "tp_pools_mp1", eng)
    with open(os.path.join(out, f"tp_serving_rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


# --- tensor-parallel serving at dp x mp: the fleet and the KV hand-off ----------

_FLEET_RNG = np.random.default_rng(13)
# prompts with no common prefix, so that the affinity ring spreads them
FLEET_PROMPTS = [_FLEET_RNG.integers(0, 256, 12).tolist() for _ in range(6)]
FLEET_NEW = 6
FLEET_REPLICAS = 2
# the hand-off's request: exported after HANDOFF_AT tokens of HANDOFF_NEW
HANDOFF_PROMPT = TP_PROMPTS[2]
HANDOFF_NEW, HANDOFF_AT = 10, 3
# the first step's logits of the bf16 comparison
BF16_IDS = np.random.default_rng(3).integers(0, 256, (1, 32))


def fleet_config(serving, **kw):
    """The dp x mp tests' engines (the port's or the JAX package's)."""
    return tp_config(serving, "unified", num_blocks=64, **kw)


def handoff_donor(eng, SamplingParams, rid="donor"):
    """Run the hand-off's request on ``eng`` to its HANDOFF_AT-th token,
    export its run, then run it to its end: ``(run, resume, tokens)``."""
    req = eng.add_request(HANDOFF_PROMPT, SamplingParams(
        max_new_tokens=HANDOFF_NEW), request_id=rid)
    while len(req.output_tokens) < HANDOFF_AT:
        eng.step()
    run = eng.export_kv_run(rid)
    resume = [int(t) for t in req.output_tokens]
    eng.run(max_steps=2000)
    return run, resume, [int(t) for t in req.output_tokens]


def handoff_recipient(eng, SamplingParams, run, resume, rid="recipient"):
    """Import ``run`` into ``eng`` and continue the request from
    ``resume``: ``(placed, tokens, cached tokens at its admission)``."""
    placed = eng.import_kv_run(run)
    req = eng.add_request(HANDOFF_PROMPT, SamplingParams(
        max_new_tokens=HANDOFF_NEW), request_id=rid, resume_tokens=resume)
    eng.run(max_steps=2000)
    attr = eng.cachestat.attribution()
    row = [r for r in attr["active"] + attr["recent"] if r["id"] == rid]
    return placed, [int(t) for t in req.output_tokens], row[0][
        "cached_tokens"]


def run_arrays(run) -> dict:
    """A hand-off run as npz arrays (its header as JSON)."""
    import json

    head = {k: run[k] for k in ("version", "block_size", "layers",
                                "kv_heads", "head_dim", "dtype",
                                "tokens_total")}
    head["blocks"] = [[r["hash"].hex(), int(r["depth"]),
                       [int(t) for t in r["tokens"]]] for r in run["blocks"]]
    return {"header": np.array(json.dumps(head)),
            "payload": np.asarray(run["payload"]),
            "digest": np.frombuffer(run["digest"], np.uint8)}


def run_from_arrays(arrays) -> dict:
    """The inverse of :func:`run_arrays`."""
    import json

    head = json.loads(str(arrays["header"]))
    blocks = head.pop("blocks")
    return dict(head, payload=arrays["payload"],
                digest=arrays["digest"].tobytes(),
                blocks=[{"hash": bytes.fromhex(h), "depth": d,
                         "tokens": tuple(t)} for h, d, t in blocks])


def _fleet_run(serving, factory):
    """The controller's dp=2 x mp=2 fleet: a wave of FLEET_PROMPTS, then
    replica 1 killed at the second step of a second wave and rebuilt by
    the supervisor on both ranks, the wave finishing token-identically."""
    from paddle_tpu_torch.serving import (
        FaultInjector,
        FaultPlan,
        FaultSpec,
        FleetSupervisor,
        SupervisorConfig,
    )

    fleet = serving.FleetRouter.build(factory, dp=FLEET_REPLICAS)
    sup = FleetSupervisor(fleet, config=SupervisorConfig(
        backoff_initial_s=0.01, backoff_max_s=0.2, poll_interval_s=0.01))
    sup.start()
    fleet.start()
    row = {}
    try:
        for wave in ("first", "killed"):
            if wave == "killed":
                eng = fleet.engines[1]
                eng.set_fault_injector(FaultInjector(FaultPlan(faults=(
                    FaultSpec(point="engine_step_raise",
                              step=eng.step_seq + 1, replica="1"),)),
                    replica="1"))
            hs = [fleet.submit_request(
                p, serving.SamplingParams(max_new_tokens=FLEET_NEW),
                request_id=f"{wave}{i}", retryable=True)
                for i, p in enumerate(FLEET_PROMPTS)]
            fleet.wait(hs, timeout=120)
            row[wave] = {"tokens": [list(h.output_tokens) for h in hs],
                         "finish": [h.finish_reason for h in hs],
                         "replicas": [h.replica.index for h in hs]}
        row["restarts"] = int(sup._restarts["engine_death"].value)
        row["predicted"] = [fleet.predict_replica(p) for p in FLEET_PROMPTS]
        row["metrics"] = fleet.registry.prometheus_text()
    finally:
        fleet.shutdown(drain_timeout=5.0)
    for e in fleet.engines:
        e.tp.release()
    row["occupancy"] = [e.kv.occupancy() for e in fleet.engines]
    return row


def _save_replica_pools(out, name, engines):
    np.savez(os.path.join(out, f"{name}.npz"),
             **{f"r{i}_{kv}{layer}": _np(p)
                for i, e in enumerate(engines)
                for kv, pools in (("k", e._k_pools), ("v", e._v_pools))
                for layer, p in enumerate(pools)})


def _pool_sum(eng):
    return float(sum(p.double().abs().sum() for p in
                     eng._k_pools + eng._v_pools))


def tp_fleet_rank(out, path):
    """tests/test_torch_tp_fleet.py on this rank of an mp=2 world, on the
    JAX weights: the in-process fleet at dp=2 x mp=2 (rank 0 its
    controller, rank 1 following both replicas on two threads), the
    hand-off at mp=2 (exported, imported from mp=1 and from the JAX
    package, a corrupted run refused), bf16 first-step logits, what waits
    for A11; then rank 0 alone at mp=1.  Writes ``tp_fleet_rank{r}.json``
    and each rank's replica pools."""
    import json
    import time

    dist = _init()
    from paddle_tpu_torch import convert, serving
    from paddle_tpu_torch.distributed import topology
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.serving import handoff, tp

    rank = dist.get_rank()
    a = dict(np.load(path))
    topology.init_mesh(mp=TP)
    cfg = LlamaConfig.tiny(num_hidden_layers=2)
    SP = serving.SamplingParams
    res = {"rank": rank}

    def shard(dtype=None):
        return convert.llama_from_paddle_tpu(a, cfg, device="cpu",
                                             dtype=dtype, mp_rank=rank,
                                             mp_degree=TP)

    # --- the in-process fleet ---------------------------------------------
    groups = tp.replica_groups(FLEET_REPLICAS)

    def build(i, registry=None):
        return serving.EngineCore(shard(), config=fleet_config(serving),
                                  registry=registry,
                                  metrics_labels={"replica": str(i)})

    factory = tp.ReplicaFactory(groups, build)
    if rank == 0:
        res["fleet"] = _fleet_run(serving, factory)
    else:
        tp.follow_replicas([factory(i) for i in range(FLEET_REPLICAS)],
                           factory)
    engines = [factory.built[i] for i in range(FLEET_REPLICAS)]
    res["fleet_invariant"] = [tp_pool_invariant(e) for e in engines]
    res["fleet_forwards"] = [e.tp.forwards for e in engines]
    res["fleet_groups"] = [[g.ranks, g.process_group is not None]
                           for g in groups]
    if rank == 0:
        res["fleet_hashes"] = [{str(b): h.hex()
                                for b, h in e.kv._block_hash.items()}
                               for e in engines]
    _save_replica_pools(out, f"fleet_pools_rank{rank}", engines)
    del engines, factory
    # --- the hand-off at mp=2 ---------------------------------------------
    eng = serving.EngineCore(shard(), config=fleet_config(serving))
    ho = {}
    if eng.tp.is_controller:
        run, resume, tokens = handoff_donor(eng, SP)
        np.savez(os.path.join(out, "run_mp2.npz"), **run_arrays(run))
        ho["donor"] = {"resume": resume, "tokens": tokens}
        eng.tp.release()
    else:
        tp.follow(eng)
    # an mp=1 donor on rank 0 (the whole model, no topology), its run into
    # a fresh mp=2 engine
    if rank == 0:
        hcg = topology.get_hybrid_communicate_group()
        topology.set_hybrid_communicate_group(None)
        whole = convert.llama_from_paddle_tpu(a, cfg, device="cpu")
        run1, resume1, tokens1 = handoff_donor(serving.EngineCore(
            whole, config=fleet_config(serving)), SP)
        topology.set_hybrid_communicate_group(hcg)
        ho["mp1_donor"] = {"resume": resume1, "tokens": tokens1}
    eng = serving.EngineCore(shard(), config=fleet_config(serving))
    if eng.tp.is_controller:
        placed, tokens, cached = handoff_recipient(eng, SP, run1, resume1)
        ho["from_mp1"] = {"placed": placed, "tokens": tokens,
                          "cached": cached, "blocks": len(run1["blocks"])}
        eng.tp.release()
    else:
        tp.follow(eng)
    # the JAX package's run (written by the test's process) into mp=2
    eng = serving.EngineCore(shard(), config=fleet_config(serving))
    if eng.tp.is_controller:
        jax_path = os.path.join(out, "run_jax.npz")
        deadline = time.monotonic() + 300
        while not os.path.exists(jax_path + ".done"):
            if time.monotonic() > deadline:
                raise TimeoutError("the JAX run never came")
            time.sleep(0.05)
        with np.load(jax_path) as f:
            jrun = run_from_arrays({k: f[k] for k in f.files})
        with open(os.path.join(out, "run_jax.json")) as f:
            jresume = json.load(f)["resume"]
        placed, tokens, cached = handoff_recipient(eng, SP, jrun, jresume)
        ho["from_jax"] = {"placed": placed, "tokens": tokens,
                          "cached": cached, "blocks": len(jrun["blocks"])}
        eng.tp.release()
    else:
        tp.follow(eng)
    # a corrupted run is refused before any rank's pool changes
    before = _pool_sum(eng)
    if eng.tp.is_controller:
        with np.load(os.path.join(out, "run_mp2.npz")) as f:
            bad = run_from_arrays({k: f[k] for k in f.files})
        payload = np.array(bad["payload"])
        payload.reshape(-1).view(np.uint8)[7] ^= 0x10
        bad["payload"] = payload
        ho["corrupt"] = _raises(lambda: eng.import_kv_run(bad))
        ho["corrupt_occupancy"] = eng.kv.occupancy()
        eng.tp.release()
    else:
        tp.follow(eng)
    ho["pool_sum"] = [before, _pool_sum(eng)]
    ho["invariant"] = tp_pool_invariant(eng)
    res["handoff"] = ho
    # --- bf16: the first step's logits through the dense-cache route --------
    bf = shard(torch.bfloat16)
    res["bf16_mp2"] = _dense_logits(bf, cfg, torch.bfloat16).tolist()
    # --- what waits for the rest of A11 -----------------------------------
    eng = serving.EngineCore(shard(), config=fleet_config(serving))
    res["waiting"] = {
        "aot": _raises(lambda: serving.AotArtifact.save(eng, out)),
        "spec": _raises(lambda: serving.EngineCore(
            eng.model, config=fleet_config(
                serving, spec=serving.SpecConfig(k=2)))),
    }
    if rank == 0:
        topology.set_hybrid_communicate_group(None)
        whole = convert.llama_from_paddle_tpu(a, cfg, device="cpu")
        ref = serving.EngineCore(whole, config=fleet_config(serving))
        res["mp1_tokens"] = tp_waves(ref, SP, [(FLEET_PROMPTS, FLEET_NEW)])
        res["mp1_hashes"] = {h.hex(): b for b, h in
                             ref.kv._block_hash.items()}
        _save_replica_pools(out, "fleet_pools_mp1", [ref])
        eng = serving.EngineCore(whole, config=fleet_config(serving))
        with np.load(os.path.join(out, "run_mp2.npz")) as f:
            run2 = run_from_arrays({k: f[k] for k in f.files})
        placed, tokens, cached = handoff_recipient(
            eng, SP, run2, ho["donor"]["resume"])
        ho["to_mp1"] = {"placed": placed, "tokens": tokens,
                        "cached": cached, "blocks": len(run2["blocks"])}
        res["bf16_mp1"] = _dense_logits(convert.llama_from_paddle_tpu(
            a, cfg, device="cpu", dtype=torch.bfloat16), cfg,
            torch.bfloat16).tolist()
    with open(os.path.join(out, f"tp_fleet_rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def _dense_logits(model, cfg, dtype):
    """``model``'s logits of BF16_IDS's last token, through the dense-cache
    route (chip_smoke.py's first-step logits)."""
    ids = torch.from_numpy(BF16_IDS)
    heads = model.llama.layers[0].self_attn.num_kv_heads
    shape = (1, ids.shape[1], heads, cfg.head_dim)
    caches = [(torch.zeros(shape, dtype=dtype), torch.zeros(shape,
                                                            dtype=dtype))
              for _ in range(cfg.num_hidden_layers)]
    with torch.no_grad():
        return _np(model(ids, caches=caches, pos=0)[0, -1].float())
