"""Tests for data-parallel primitives (ops/) vs numpy oracles — the
prefix-sum-vs-np.cumsum pattern of /root/reference/prefix_sum.py:39-54."""
import jax
import jax.numpy as jnp
import numpy as np

from mitsuba3_experiments_tpu import ops


def test_prefix_sum(rng_np):
    x = jnp.asarray(rng_np.normal(size=1000).astype(np.float32))
    np.testing.assert_allclose(
        np.asarray(ops.prefix_sum(x)), np.cumsum(np.asarray(x)),
        rtol=1e-4, atol=1e-5,
    )
    ex = np.asarray(ops.prefix_sum(x, exclusive=True))
    np.testing.assert_allclose(
        ex[1:], np.cumsum(np.asarray(x))[:-1], rtol=1e-4, atol=1e-5
    )
    assert ex[0] == 0


def test_scatter_reduce_builtin(rng_np):
    v = jnp.asarray(rng_np.normal(size=100).astype(np.float32))
    idx = jnp.asarray(rng_np.integers(0, 10, size=100))
    tgt = jnp.zeros(10, jnp.float32)
    got = ops.scatter_reduce("add", tgt, v, idx)
    ref = np.zeros(10, np.float32)
    np.add.at(ref, np.asarray(idx), np.asarray(v))
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-5, atol=1e-5)


def test_scatter_reduce_with_max(rng_np):
    # arbitrary-combiner path vs numpy maximum.at
    v = jnp.asarray(rng_np.normal(size=200).astype(np.float32))
    idx = jnp.asarray(rng_np.integers(0, 16, size=200))
    tgt = jnp.full((16,), -np.inf, jnp.float32)
    got = ops.scatter_reduce_with(jnp.maximum, tgt, v, idx)
    ref = np.full(16, -np.inf, np.float32)
    np.maximum.at(ref, np.asarray(idx), np.asarray(v))
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-5)


def test_scatter_reduce_with_noncommutative_last_wins(rng_np):
    # combiner that keeps b (second arg): equals "last write in sorted order";
    # with stable sort this is the highest original index per bucket.
    v = jnp.arange(50, dtype=jnp.float32)
    idx = jnp.asarray(rng_np.integers(0, 5, size=50))
    tgt = jnp.full((5,), -1.0, jnp.float32)
    got = np.asarray(ops.scatter_reduce_with(lambda a, b: b, tgt, v, idx))
    idx_np = np.asarray(idx)
    for b in range(5):
        where = np.nonzero(idx_np == b)[0]
        expect = float(where[-1]) if len(where) else -1.0
        assert got[b] == expect


def test_segment_and_block_sum(rng_np):
    v = jnp.asarray(rng_np.normal(size=(64, 3)).astype(np.float32))
    bs = np.asarray(ops.block_sum(v, 8))
    ref = np.asarray(v).reshape(8, 8, 3).sum(axis=1)
    np.testing.assert_allclose(bs, ref, rtol=1e-5, atol=1e-5)


def test_compress_and_permutation(rng_np):
    mask = jnp.asarray(rng_np.random(100) < 0.3)
    perm, count = ops.compress_indices(mask)
    mask_np = np.asarray(mask)
    assert int(count) == mask_np.sum()
    packed = mask_np[np.asarray(perm)]
    assert packed[: int(count)].all() and not packed[int(count):].any()
    # stable: active indices in increasing order
    active = np.asarray(perm)[: int(count)]
    assert (np.diff(active) > 0).all()

    key = jnp.asarray(rng_np.integers(0, 7, size=100))
    p = ops.partition_by_key(key)
    assert (np.diff(np.asarray(key)[np.asarray(p)]) >= 0).all()
    inv = ops.invert_permutation(p)
    np.testing.assert_array_equal(np.asarray(p)[np.asarray(inv)], np.arange(100))


def test_concat(rng_np):
    a = jnp.asarray(rng_np.normal(size=10).astype(np.float32))
    b = jnp.asarray(rng_np.normal(size=7).astype(np.float32))
    ref = np.concatenate([np.asarray(a), np.asarray(b)])
    np.testing.assert_array_equal(np.asarray(ops.concat_gather([a, b])), ref)
    np.testing.assert_array_equal(np.asarray(ops.concat_scatter([a, b])), ref)
