import numpy as np
import jax.numpy as jnp
import pytest

from bundleadjustment_tpu.ops.matching import (
    hamming_distance_matrix,
    l2_distance_matrix,
    match_descriptors,
)


def test_l2_distance_matrix(rng):
    a = rng.normal(size=(20, 16)).astype(np.float32)
    b = rng.normal(size=(30, 16)).astype(np.float32)
    d = np.asarray(l2_distance_matrix(jnp.asarray(a), jnp.asarray(b)))
    ref = ((a[:, None] - b[None]) ** 2).sum(-1)
    np.testing.assert_allclose(d, ref, atol=1e-3)


def test_hamming_distance_matrix(rng):
    a = rng.integers(0, 2**32, size=(10, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(12, 8), dtype=np.uint32)
    d = np.asarray(hamming_distance_matrix(jnp.asarray(a), jnp.asarray(b)))
    ref = np.zeros((10, 12))
    for i in range(10):
        for j in range(12):
            ref[i, j] = bin(int.from_bytes(a[i].tobytes(), "little") ^ int.from_bytes(b[j].tobytes(), "little")).count("1")
    np.testing.assert_array_equal(d, ref)


def test_match_recovers_permutation(rng):
    """Descriptors of B are a shuffled, lightly-noised copy of A."""
    m = 60
    a = rng.normal(size=(m, 32)).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    perm = rng.permutation(m)
    b = a[perm] + rng.normal(0, 0.01, (m, 32)).astype(np.float32)
    idx, dist = match_descriptors(jnp.asarray(a), jnp.asarray(b), metric="l2")
    idx = np.asarray(idx)
    matched = idx >= 0
    assert matched.mean() > 0.9
    inv = np.argsort(perm)
    np.testing.assert_array_equal(idx[matched], inv[np.nonzero(matched)[0]])


def test_ratio_test_rejects_ambiguous(rng):
    # two identical train descriptors -> ratio ~1 -> reject
    a = rng.normal(size=(5, 16)).astype(np.float32)
    b = np.concatenate([a[:1], a[:1], a[1:] + 10.0])  # queries 0 ambiguous
    idx, _ = match_descriptors(jnp.asarray(a), jnp.asarray(b), metric="l2")
    assert int(idx[0]) == -1


def test_uniqueness_cross_check(rng):
    # two queries both closest to train 0; only the closer one keeps it
    b = rng.normal(size=(4, 16)).astype(np.float32) * 10
    a = np.stack([b[0] + 0.001, b[0] + 0.01, b[2], b[3]]).astype(np.float32)
    idx, _ = match_descriptors(jnp.asarray(a), jnp.asarray(b), metric="l2")
    idx = np.asarray(idx)
    assert idx[0] == 0
    assert idx[1] == -1


def test_validity_masks(rng):
    a = rng.normal(size=(6, 8)).astype(np.float32)
    b = a.copy()
    va = np.array([True, True, False, True, True, True])
    vb = np.array([True, False, True, True, True, True])
    idx, _ = match_descriptors(
        jnp.asarray(a), jnp.asarray(b), valid_a=jnp.asarray(va), valid_b=jnp.asarray(vb), metric="l2"
    )
    idx = np.asarray(idx)
    assert idx[2] == -1  # invalid query
    assert 1 not in idx.tolist()  # invalid train never matched


def test_max_dist_gate(rng):
    a = rng.normal(size=(4, 8)).astype(np.float32)
    b = a + 5.0
    idx, _ = match_descriptors(jnp.asarray(a), jnp.asarray(b), metric="l2", max_dist=0.5)
    assert (np.asarray(idx) == -1).all()


@pytest.mark.parametrize("m1, m2", [(255, 256), (256, 257), (1000, 1024)])
def test_hamming_top2_matches_brute_force(m1, m2):
    """The XLA matcher's top-2 against a numpy brute force at sizes around
    power-of-two tile boundaries, with valid-masked train rows."""
    from bundleadjustment_tpu.ops.matching import (
        _top2_rows,
        hamming_distance_matrix,
    )

    rng = np.random.default_rng(m1 + m2)
    a = rng.integers(0, 2**32, (m1, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (m2, 8), dtype=np.uint32)
    b[: m1 // 2] = a[: m1 // 2] ^ rng.integers(0, 16, (m1 // 2, 8),
                                               dtype=np.uint32)
    vb = rng.random(m2) > 0.1
    d = np.unpackbits((a[:, None, :] ^ b[None, :, :]).view(np.uint8),
                      axis=-1).sum(-1).astype(np.float32)
    d[:, ~vb] = np.inf
    best, idx, second = (np.asarray(x) for x in _top2_rows(
        hamming_distance_matrix(jnp.asarray(a), jnp.asarray(b),
                                valid_b=jnp.asarray(vb))))
    ref = np.sort(d, axis=1)
    np.testing.assert_array_equal(best, ref[:, 0])
    np.testing.assert_array_equal(second, ref[:, 1])
    np.testing.assert_array_equal(idx, np.argmin(d, axis=1))
