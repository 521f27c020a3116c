"""The port's hashing against the JAX package bit for bit, and against the
canonical smhasher vectors."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import hashing as H
from repro_torch.core import hashing as TH


def test_murmur3_bytes_known_vectors():
    # canonical smhasher vectors (tests/test_hashing.py)
    assert TH.murmur3_32_bytes(b"", 0) == 0
    assert TH.murmur3_32_bytes(b"hello", 0) == 0x248BFA47
    assert TH.murmur3_32_bytes(b"hello, world", 0) == 0x149BBB7F
    assert TH.murmur3_32_bytes(b"The quick brown fox jumps over the lazy dog",
                               0x9747B28C) == 0x2FA826CD


@pytest.mark.parametrize("seed", [0, int(H.DEFAULT_SEED)])
def test_murmur3_u32_matches_reference(rng, seed):
    """32-bit keys, extremes included: the split 16-bit products give the
    reference's wrapped uint32 arithmetic exactly."""
    ks = rng.integers(0, 2**32, size=4096, dtype=np.uint32)
    ks[:3] = [0, 1, 2**32 - 1]
    want = np.asarray(H.murmur3_32(jnp.asarray(ks), np.uint32(seed)))
    got = TH.murmur3_32(TH.keys_tensor(ks), seed).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    # int32 keys are the same bit patterns
    got_i32 = TH.murmur3_32(TH.keys_tensor(ks.view(np.int32)), seed).numpy()
    np.testing.assert_array_equal(got_i32, got)


def test_murmur3_u64_matches_reference_and_bytes(rng):
    """64-bit keys hash as two little-endian blocks: equal to the reference
    (under 64-bit JAX types) and to the scalar bytes hash."""
    ks = rng.integers(0, 2**64, size=256, dtype=np.uint64)
    ks[:2] = [0, 2**64 - 1]
    with jax.enable_x64(True):
        want = np.asarray(H.murmur3_32(jnp.asarray(ks), np.uint32(0)))
    got = TH.murmur3_32(TH.keys_tensor(ks), 0).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    scalar = [TH.murmur3_32_bytes(int(k).to_bytes(8, "little"), 0)
              for k in ks[:32]]
    np.testing.assert_array_equal(got[:32], scalar)


def test_fibonacci_unit_and_sentinels_match_reference(rng):
    kh = rng.integers(0, 2**32, size=2048, dtype=np.uint32)
    # the two reserved preimages: the sentinel and the inverse of the
    # Fibonacci multiplier times the sentinel
    inv = pow(int(H.FIBONACCI_MULTIPLIER), -1, 2**32)
    s = int(H.SENTINEL_HASH)
    kh[:2] = [s, (s * inv) % 2**32]
    t = TH.from_pattern(TH.keys_tensor(kh))
    j = jnp.asarray(kh)
    np.testing.assert_array_equal(TH.fibonacci_u32(t).numpy(),
                                  np.asarray(H.fibonacci_u32(j)).astype(np.int64))
    np.testing.assert_array_equal(TH.fibonacci_unit(t).numpy(),
                                  np.asarray(H.fibonacci_unit(j)))
    np.testing.assert_array_equal(
        TH.unit_interval(TH.fibonacci_u32(t)).numpy(),
        np.asarray(H.unit_interval(H.fibonacci_u32(j))))
    safe = TH.sentinel_safe(t).numpy()
    np.testing.assert_array_equal(safe, np.asarray(H.sentinel_safe(j)))
    assert not safe[0] and not safe[1] and safe[2:].all()


def test_pattern_roundtrip(rng):
    kh = rng.integers(0, 2**32, size=512, dtype=np.uint32)
    t = TH.from_pattern(TH.keys_tensor(kh))
    p = TH.to_pattern(t)
    np.testing.assert_array_equal(p.numpy(), kh.view(np.int32))
    np.testing.assert_array_equal(TH.from_pattern(p).numpy(), t.numpy())


def test_string_keys_match_reference():
    keys = ["2021-01", "2021-02", b"raw", ""]
    np.testing.assert_array_equal(TH.hash_string_keys(keys),
                                  H.hash_string_keys(keys))
