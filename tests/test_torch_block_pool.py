"""Block-pool bookkeeping of the PyTorch port, held to the JAX package.

The prefix-chain hashes must be byte-identical (routing and KV hand-off
key on them), and one script of allocations, forks, hash registrations,
frees, prefix forks and evictions must leave both pools with the same
tables, free lists, reuse LRU and refcounts, with
free + reuse + allocated == num_blocks after every step (allocated counts
the reserved null page).
"""

import numpy as np
import pytest

from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu_torch.ops import paged_attention as tpa


@pytest.mark.parametrize("block_size", [1, 4, 16])
@pytest.mark.parametrize("max_blocks", [None, 3])
def test_prefix_chain_hashes_byte_identical(block_size, max_blocks):
    rng = np.random.default_rng(block_size)
    tokens = rng.integers(-2**40, 2**40, size=70).tolist()
    ours = tpa.prefix_chain_hashes(tokens, block_size, max_blocks)
    ref = jpa.prefix_chain_hashes(tokens, block_size, max_blocks)
    assert ours == ref
    assert tpa._HASH_ROOT == jpa._HASH_ROOT
    assert tpa._hash_block(ref[-1], tokens[:5]) == \
        jpa._hash_block(ref[-1], tokens[:5])


def _state(pool):
    return (dict(pool._tables), list(pool._free), list(pool._reuse),
            dict(pool._ref), dict(pool._lens), pool.cache_epoch,
            pool.reuse_evictions, pool.reuse_hits)


def _invariant(pool):
    allocated = 1 + len(pool._ref)   # + the reserved null page
    assert len(pool._free) + len(pool._reuse) + allocated == pool.num_blocks


def test_same_script_same_pool_state():
    bs, num_blocks = 4, 12
    pools = [jpa.BlockPool(num_blocks, bs, enable_prefix_cache=True),
             tpa.BlockPool(num_blocks, bs, enable_prefix_cache=True)]
    evictions = [[], []]
    for p, log in zip(pools, evictions):
        p.on_evict = lambda b, d, lt, cause, log=log: log.append((b, d, cause))
    prefix = list(range(100, 108))
    a_ids, b_ids = prefix + [1, 2, 3, 4, 5], prefix + [9, 9, 9]

    script = [
        ("allocate", "a", len(a_ids)),
        ("record", "a", a_ids),
        ("fork", "a", "a2"),
        ("allocate", "a2", 6),
        ("free", "a"),
        ("free", "a2"),
        ("fork_prefix", "b", b_ids),
        ("allocate", "b", len(b_ids) - 8),
        ("record", "b", b_ids),
        ("allocate", "c", 32),        # drains the free list, evicts LRU
        ("free", "b"),
        ("allocate", "d", 8),
        ("free", "c"),
        ("fork_prefix", "e", a_ids),
        ("allocate", "e", 20),
        ("free", "d"),
        ("free", "e"),
    ]
    for op, *args in script:
        results = []
        for p in pools:
            if op == "allocate":
                results.append(p.allocate(args[0], args[1]))
                if results[-1]:
                    p._lens[args[0]] = p._lens.get(args[0], 0) + args[1]
            elif op == "record":
                results.append(p.record_block_hashes(args[0], args[1]))
            elif op == "fork":
                results.append(p.fork(args[0], args[1]))
            elif op == "free":
                results.append(p.free(args[0]))
            else:
                results.append(p.fork_prefix(args[0], args[1]))
            _invariant(p)
        assert results[0] == results[1], (op, args, results)
        assert _state(pools[0]) == _state(pools[1]), (op, args)
    assert evictions[0] == evictions[1]
    assert evictions[0], "the script must exercise an eviction"
    assert pools[1].reuse_hits > 0
