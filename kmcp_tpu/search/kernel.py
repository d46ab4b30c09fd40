"""Match-count kernels: batched (reads x k-mers x targets) containment.

The computational heart of search — the reference spends ~6,000 lines of
unrolled Go + SIMD assembly here (pospop positional popcount + pand
vectorized AND, /root/reference/kmcp/cmd/util-db-search.go:6512-7408).
On the device the same computation is a dense contraction:

    counts[b, t] = sum_k  AND_h bits[ loc(hash[b,k],h) , t ]

expressed as a row gather from the bit matrix, an AND-reduce over the
``h`` hash functions, a bit-unpack along the word axis, and a sum over the
k-mer axis.  Backends:

- ``numpy``  — host reference implementation (correctness oracle)
- ``jax``    — jitted XLA version (gather + shifts fuse on device)

Both operate on a padded [B, K] uint64 hash-location batch with a validity
mask; padded lanes contribute nothing.
"""

from __future__ import annotations

import numpy as np

_U32_1 = np.uint32(1)


def derive_locations(
    hashes: np.ndarray, num_hashes: int, num_sigs: int
) -> np.ndarray:
    """[B, K] uint64 -> [B, K, h] int64 Bloom row positions.

    Multi-hash derivation with uint32 wraparound (util-hash.go:61-82):
    ``loc_i = uint32(hi32 + lo32*i) mod num_sigs``.
    """
    if num_hashes <= 1:
        return (hashes % np.uint64(num_sigs)).astype(np.int64)[..., None]
    a = (hashes >> np.uint64(32)).astype(np.uint32)
    b = (hashes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    i = np.arange(num_hashes, dtype=np.uint32)
    vals = a[..., None] + b[..., None] * i  # uint32 wrap
    return (vals.astype(np.uint64) % np.uint64(num_sigs)).astype(np.int64)


def count_matches_numpy(
    bits: np.ndarray,      # [num_sigs, W] uint32
    hashes: np.ndarray,    # [B, K] uint64 (padded)
    mask: np.ndarray,      # [B, K] bool, True = real k-mer
    num_hashes: int,
) -> np.ndarray:
    """Returns [B, W*32] int32 match counts per target."""
    num_sigs = bits.shape[0]
    loc = derive_locations(hashes, num_hashes, num_sigs)  # [B,K,h]
    rows = bits[loc]  # [B,K,h,W]
    if num_hashes > 1:
        acc = rows[..., 0, :]
        for j in range(1, num_hashes):
            acc = acc & rows[..., j, :]
        rows = acc  # [B,K,W]
    else:
        rows = rows[..., 0, :]
    rows = np.where(mask[..., None], rows, np.uint32(0))
    # unpack words -> bits (little-endian within the uint32 word)
    by = rows.view(np.uint8)  # [B,K,4W] (little-endian platform)
    b_, k_, w4 = by.shape
    unpacked = np.unpackbits(by.reshape(b_ * k_, w4), axis=1, bitorder="little")
    counts = unpacked.reshape(b_, k_, w4 * 8).sum(axis=1, dtype=np.int32)
    return counts


# ---------------------------------------------------------------------------
# JAX backend


import functools


@functools.lru_cache(maxsize=None)
def make_jax_counter(num_hashes: int):
    """Build a jitted counts function: (bits_u32[S,W], loc_i32[B,K,h],
    mask[B,K]) -> [B, W*32] int32.

    The gather rides XLA's native dynamic-gather; the bit-unpack is a
    broadcast shift+mask that XLA fuses into the K-axis reduction, so the
    [B,K,T] bit tensor never materializes in HBM.
    """
    import jax
    import jax.numpy as jnp

    def counts_fn(bits, loc, mask):
        rows = jnp.take(bits, loc, axis=0)  # [B,K,h,W] uint32
        acc = rows[..., 0, :]
        for j in range(1, num_hashes):
            acc = acc & rows[..., j, :]
        acc = jnp.where(mask[..., None], acc, jnp.uint32(0))  # [B,K,W]
        shifts = jnp.arange(32, dtype=jnp.uint32)
        bit = (acc[..., None] >> shifts) & jnp.uint32(1)  # [B,K,W,32]
        counts = bit.astype(jnp.int32).sum(axis=1)  # [B,W,32]
        return counts.reshape(counts.shape[0], -1)

    return jax.jit(counts_fn)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


GENOME_SUPER_CHUNK = 64  # scan steps per fixed-shape call


@functools.lru_cache(maxsize=None)
def make_jax_counter_genome(num_hashes: int, k_chunk: int = 32768):
    """Chunked-accumulation counter for GENOME-SCALE containment queries
    (`search -g`, /root/reference/kmcp/cmd/search.go:885-937): one query
    carries millions of k-mers, which breaks the padded [B, K] batch
    model (SURVEY §7 lists this k-mer-axis chunking as a hard part).
    (bits_u32[S,W], carry[W*32] i32, loc_i32[C, Kc, h], mask[C, Kc]) ->
    [W*32] int32: a lax.scan accumulates per-chunk positional popcounts,
    so the live gather intermediate stays [Kc, W] regardless of query
    size.  C is FIXED at GENOME_SUPER_CHUNK (the caller loops over
    fixed-shape super-chunks, threading the carry): the chunk count
    must not be an input shape, or every distinct genome length would
    recompile."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    def counts_fn(bits, carry0, loc, mask):
        def chunk(carry, xs):
            loc_c, m_c = xs
            rows = jnp.take(bits, loc_c[..., 0], axis=0)  # [Kc, W]
            for j in range(1, num_hashes):
                rows = rows & jnp.take(bits, loc_c[..., j], axis=0)
            rows = jnp.where(m_c[:, None], rows, jnp.uint32(0))
            shifts = jnp.arange(32, dtype=jnp.uint32)
            bit = (rows[..., None] >> shifts) & jnp.uint32(1)  # [Kc,W,32]
            return carry + bit.astype(jnp.int32).sum(axis=0).reshape(-1), None

        counts, _ = lax.scan(chunk, carry0, (loc, mask))
        return counts

    return jax.jit(counts_fn)


class JaxBlockCounter:
    """Per-block device counter with resident bit matrix.

    Inputs are padded to shape buckets (batch to a multiple of 1024,
    k-mer axis to a multiple of 32) so XLA compiles once per bucket
    rather than once per batch.
    """

    def __init__(self, bits: np.ndarray, num_hashes: int, device=None):
        import jax
        import jax.numpy as jnp

        self.num_sigs, self.num_words = bits.shape
        self.num_hashes = num_hashes
        dev = device or jax.devices()[0]
        self.bits = jax.device_put(jnp.asarray(bits), dev)
        self._fn = make_jax_counter(num_hashes)

    def __call__(self, hashes: np.ndarray, mask: np.ndarray) -> np.ndarray:
        import jax.numpy as jnp

        B, K = hashes.shape
        if K >= 262144:
            # genome-scale containment queries (`search -g`): the padded
            # [B -> 1024, K] batch model would allocate K * 8 KB; chunk
            # the k-mer axis per query instead (make_jax_counter_genome)
            return np.stack(
                [
                    self._call_genome(hashes[b], mask[b])
                    for b in range(B)
                ]
            )
        Bp, Kp = _round_up(max(B, 1), 1024), _round_up(max(K, 1), 32)
        if (Bp, Kp) != (B, K):
            h2 = np.zeros((Bp, Kp), dtype=np.uint64)
            m2 = np.zeros((Bp, Kp), dtype=bool)
            h2[:B, :K] = hashes
            m2[:B, :K] = mask
            hashes, mask = h2, m2
        loc = self._locations(hashes)
        out = self._fn(self.bits, jnp.asarray(loc), jnp.asarray(mask))
        return np.asarray(out)[:B]

    def _call_genome(self, hashes: np.ndarray, mask: np.ndarray):
        """One genome-scale query row -> [T] counts via the chunked
        scan; locations derive on the host C++ path as usual.  The jit
        sees only the FIXED [GENOME_SUPER_CHUNK, KC] shape (one compile
        serves every genome size; persistent-cached across processes)
        and the [W*32] carry threads across super-chunk calls."""
        import jax.numpy as jnp

        from .device import enable_compilation_cache

        enable_compilation_cache()
        KC = 32768
        SC = GENOME_SUPER_CHUNK
        (K,) = hashes.shape
        n_super = max(1, -(-K // (KC * SC)))
        Kp = n_super * SC * KC
        h2 = np.zeros((1, Kp), dtype=np.uint64)
        m2 = np.zeros((1, Kp), dtype=bool)
        h2[0, :K] = hashes
        m2[0, :K] = mask
        loc = self._locations(h2).reshape(n_super, SC, KC, self.num_hashes)
        m3 = m2.reshape(n_super, SC, KC)
        fn = make_jax_counter_genome(self.num_hashes)
        carry = jnp.zeros((self.num_words * 32,), jnp.int32)
        for i in range(n_super):
            carry = fn(
                self.bits, carry, jnp.asarray(loc[i]), jnp.asarray(m3[i])
            )
        return np.asarray(carry)

    def _locations(self, hashes: np.ndarray) -> np.ndarray:
        """int32 Bloom positions; C++ fast path (NumPy uint64 modulo is
        ~400 ns/element on this host, the native loop ~3 ns)."""
        assert self.num_sigs < 2**31, "block too large for int32 gather"
        from ..kmer import native

        loc = native.locations(hashes, self.num_hashes, self.num_sigs)
        if loc is None:
            loc = derive_locations(
                hashes, self.num_hashes, self.num_sigs
            ).astype(np.int32)
        return loc
