"""In-step sampling of the PyTorch port, held to the JAX package.

The Gumbel noise is keyed by the raw u32 pair (seed, draw index); its hash
bits must equal the JAX package's exactly, including seeds and draws at
the edges of the signed and unsigned 32-bit ranges.  The noise values
themselves agree to within 2e-6: the two frameworks' float32 ``log`` differ
in the last bit for some inputs.  Tokens are compared on greedy rows and on
seeded top-k / top-p rows fed the same logits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import sampling as jsampling
from paddle_tpu_torch.ops import sampling as tsampling

EDGE_KEYS = np.array(
    [[0, 0], [1, 1], [2**31 - 1, 2**31 - 1], [2**31, 2**31],
     [2**31 + 1, 7], [2**32 - 1, 2**32 - 1], [2**32 - 2, 0],
     [0, 2**32 - 1], [0x9E3779B9, 12345], [123456789, 2**31 - 2]],
    dtype=np.uint32)


def _jax_hash_bits(keys, V):
    """The u32 bits ``paddle_tpu.ops.sampling._gumbel_from_keys`` hashes."""
    f = jsampling._fmix32
    k = jnp.asarray(keys)
    lane = jnp.arange(V, dtype=jnp.uint32)[None, :]
    h = f(lane ^ f(k[:, 1:2] ^ f(k[:, 0:1] ^ jnp.uint32(0x9E3779B9))))
    return np.asarray(h).astype(np.int64)


@pytest.mark.parametrize("V", [1, 257, 128256])
def test_hash_bits_equal_jax(V):
    ours = tsampling._hash_bits(torch.from_numpy(EDGE_KEYS.astype(np.int64)),
                                V).numpy()
    np.testing.assert_array_equal(ours, _jax_hash_bits(EDGE_KEYS, V))
    assert ours.min() >= 0 and ours.max() <= 0xFFFFFFFF


def test_gumbel_noise_matches_jax():
    V = 4096
    ours = tsampling._gumbel_from_keys(
        torch.from_numpy(EDGE_KEYS.astype(np.int64)), V).numpy()
    ref = np.asarray(jsampling._gumbel_from_keys(jnp.asarray(EDGE_KEYS), V))
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=2e-6)


def test_make_keys_equal():
    pairs = [(2**32 + 5, 3), (-1, 2**31), (7, 2**33 - 1)]
    np.testing.assert_array_equal(tsampling.make_keys(pairs),
                                  jsampling.make_keys(pairs))


def _rows(n, V, seed):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(n, V)) * 3).astype(np.float32)
    temps = rng.choice([0.0, 0.3, 0.8, 1.0, 1.7], size=n).astype(np.float32)
    top_ks = rng.choice([0, 1, 5, 40, V + 10], size=n).astype(np.int32)
    top_ps = rng.choice([1.0, 0.95, 0.7, 0.2], size=n).astype(np.float32)
    keys = np.stack([rng.integers(0, 2**32, size=n),
                     rng.integers(0, 2**32, size=n)], 1).astype(np.uint32)
    return logits, temps, top_ks, top_ps, keys


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_tokens_equal_jax(seed):
    logits, temps, top_ks, top_ps, keys = _rows(64, 300, seed)
    ref = np.asarray(jsampling.sample_tokens(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_ks),
        jnp.asarray(top_ps), jnp.asarray(keys)))
    ours = tsampling.sample_tokens(
        torch.from_numpy(logits), torch.from_numpy(temps),
        torch.from_numpy(top_ks), torch.from_numpy(top_ps),
        torch.from_numpy(keys.astype(np.int64))).numpy()
    assert ours.dtype == np.int32
    np.testing.assert_array_equal(ours, ref)
    greedy = temps <= 0
    assert greedy.any() and (~greedy).any()
    np.testing.assert_array_equal(ours[greedy],
                                  logits[greedy].argmax(-1))


def test_seeded_draws_follow_the_key():
    logits, temps, top_ks, top_ps, keys = _rows(8, 50, 3)
    temps[:] = 1.0
    top_ks[:] = 0
    top_ps[:] = 1.0
    args = [torch.from_numpy(a) for a in (logits, temps, top_ks, top_ps)]
    a = tsampling.sample_tokens(*args, torch.from_numpy(keys.astype(np.int64)))
    b = tsampling.sample_tokens(*args, torch.from_numpy(keys.astype(np.int64)))
    keys[:, 1] += 1   # the next output position
    c = tsampling.sample_tokens(*args, torch.from_numpy(keys.astype(np.int64)))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
