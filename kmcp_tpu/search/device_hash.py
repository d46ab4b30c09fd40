"""Device ntHash1: read bytes -> Bloom row location planes, in plain
XLA over the whole ``[L, B]`` batch: the prefix-XOR formulation of
kmer/nthash.py (`_window_hashes`) as a ``lax.associative_scan`` along
positions.  The same program runs on the GPU and on the CPU.

`hash_planes` (and the jitted `make_hash_fn`) return
``(*loc planes, nk, *value planes)``:

- loc planes: int32 ``[K, B]`` (K = lmax - k + 1 windows), one per
  hash function, then the screen plane when ``screen_sigs`` > 0
  (``h mod screen_sigs``, sentinel = screen_sigs); invalid windows
  (non-ACGT base, h == 0, h > max_hash) hold the sentinel row
  ``num_sigs``;
- nk: int32 ``[1, B]`` valid windows per read;
- with ``emit_values`` the (hi, lo) uint32 ``[K, B]`` halves of each
  valid window's canonical hash (0 for invalid windows; h == 0 is
  itself invalid) — the dedup key of paired streaming and the input of
  sketch selection (sketch_device.py).

64-bit values are carried as uint32 (hi, lo) pairs, so nothing needs
``jax_enable_x64``; bit-identical to kmer/nthash.py and
native/nthash.cpp.  For num_hashes > 1 the Bloom locations follow the
reference's ``uint32(hi + lo*j) mod S`` derivation
(util-hash.go:61-142).
"""

from __future__ import annotations

import functools

import numpy as np

from ..kmer.nthash import SEEDS, SEEDS_COMP


def _split64(v: int) -> tuple[int, int]:
    return (int(v) >> 32) & 0xFFFFFFFF, int(v) & 0xFFFFFFFF


def seeds_of(bases):
    """ASCII bases (int32, any shape) -> (seed_hi, seed_lo, comp_hi,
    comp_lo, ok): four arithmetic selects on the uppercased byte."""
    import jax.numpy as jnp

    up = bases & jnp.int32(0xDF)
    is_b = [up == jnp.int32(ord(c)) for c in "ACGT"]
    ok = is_b[0] | is_b[1] | is_b[2] | is_b[3]

    def pick(vals):
        v = jnp.zeros_like(up, dtype=jnp.uint32)
        for sel, x in zip(is_b, vals):
            v = jnp.where(sel, jnp.uint32(x), v)
        return v

    fw = [_split64(s) for s in SEEDS[:4]]
    rc = [_split64(s) for s in SEEDS_COMP[:4]]
    return (
        pick([s[0] for s in fw]), pick([s[1] for s in fw]),
        pick([s[0] for s in rc]), pick([s[1] for s in rc]), ok,
    )


def make_mod_pair(sigs: int):
    """fn(hi, lo) -> (hi*2^32 + lo) mod sigs, exactly, in uint32
    arithmetic.  Three lowerings by modulus shape:

    - power of two: 2^32 mod sigs == 0, so one AND on the low word;
    - sigs <= 65536: (hi mod M)*(2^32 mod M) + (lo mod M) stays below
      2^32, so one multiply and three remainders by a constant (which
      XLA lowers to multiply-shift);
    - otherwise: an exact fold of the high word's contribution through
      16-bit splits and modular doubling."""
    import jax.numpy as jnp
    from jax import lax

    if sigs & (sigs - 1) == 0:
        mask = np.uint32(sigs - 1)
        return lambda hi, lo: lo & mask
    M = np.uint32(sigs)
    if sigs <= 65536:
        P = np.uint32((1 << 32) % sigs)
        return lambda hi, lo: lax.rem(
            lax.rem(hi, M) * P + lax.rem(lo, M), M
        )
    pow32 = (1 << 32) % sigs

    def sub_if(v):
        return jnp.where(v >= M, v - M, v)

    def dbl16(v):
        for _ in range(16):
            v = sub_if(v << jnp.uint32(1))
        return v

    def mod_pair(hi, lo):
        r_hi = lax.rem(hi, M)
        a1, a0 = r_hi >> jnp.uint32(16), r_hi & jnp.uint32(0xFFFF)
        b1, b0 = np.uint32(pow32 >> 16), np.uint32(pow32 & 0xFFFF)
        t = dbl16(dbl16(lax.rem(a1 * b1, M)))
        t = sub_if(t + dbl16(sub_if(lax.rem(a1 * b0, M) + lax.rem(a0 * b1, M))))
        t = sub_if(t + lax.rem(a0 * b0, M))
        return sub_if(t + lax.rem(lo, M))

    return mod_pair


def _rotate_rows(hi, lo, r: np.ndarray):
    """Rotate-left each row i of [L, B] pairs by the static r[i]."""
    import jax.numpy as jnp

    r = np.asarray(r, dtype=np.int64) % 64
    swap = (r >= 32)[:, None]
    a = jnp.where(swap, lo, hi)
    b = jnp.where(swap, hi, lo)
    s = r % 32
    keep = (s == 0)[:, None]
    sh = s.astype(np.uint32)[:, None]
    inv = ((32 - s) % 32).astype(np.uint32)[:, None]
    return (
        jnp.where(keep, a, (a << sh) | (b >> inv)),
        jnp.where(keep, b, (b << sh) | (a >> inv)),
    )


def hash_planes(bases, k: int, num_sigs: int, max_hash: int,
                num_hashes: int = 1, screen_sigs: int = 0,
                emit_values: bool = False):
    """ASCII bases [L, B] int32 (pad 0) -> (*loc planes, nk, *value
    planes) (module docstring): the prefix-XOR of position-derotated
    seeds, then one rotation per window (kmer/nthash.py::_window_hashes,
    transposed)."""
    import jax.numpy as jnp
    from jax import lax

    L, B = bases.shape
    K = L - k + 1
    s_hi, s_lo, c_hi, c_lo, ok = seeds_of(bases)
    pos = np.arange(L)
    f_hi, f_lo = _rotate_rows(s_hi, s_lo, -pos)  # ror(seed, i)
    r_hi, r_lo = _rotate_rows(c_hi, c_lo, pos)  # rol(seedc, i)

    def xor2(a, b):
        return a[0] ^ b[0], a[1] ^ b[1]

    cf = lax.associative_scan(xor2, (f_hi, f_lo), axis=0)
    cr = lax.associative_scan(xor2, (r_hi, r_lo), axis=0)

    def window(c):
        zero = jnp.zeros((1, B), jnp.uint32)
        prev = [jnp.concatenate([zero, x[: K - 1]]) for x in c]
        return c[0][k - 1 :] ^ prev[0], c[1][k - 1 :] ^ prev[1]

    w = np.arange(K)
    fh_hi, fh_lo = _rotate_rows(*window(cf), w + k - 1)
    rh_hi, rh_lo = _rotate_rows(*window(cr), -w)
    use_r = (rh_hi < fh_hi) | ((rh_hi == fh_hi) & (rh_lo < fh_lo))
    h_hi = jnp.where(use_r, rh_hi, fh_hi)  # canonical: min(fh, rh)
    h_lo = jnp.where(use_r, rh_lo, fh_lo)

    bad = jnp.cumsum((~ok).astype(jnp.int32), axis=0)
    bad_prev = jnp.concatenate(
        [jnp.zeros((1, B), jnp.int32), bad[: K - 1]]
    )
    mh_hi, mh_lo = (np.uint32(x) for x in _split64(max_hash))
    valid = (
        ((bad[k - 1 :] - bad_prev) == 0)
        & ~((h_hi == 0) & (h_lo == 0))
        & ((h_hi < mh_hi) | ((h_hi == mh_hi) & (h_lo <= mh_lo)))
    )
    if num_hashes == 1:
        raw = [make_mod_pair(num_sigs)(h_hi, h_lo)]
    else:
        raw = [
            lax.rem(h_hi + h_lo * jnp.uint32(j), np.uint32(num_sigs))
            for j in range(num_hashes)
        ]
    locs = [
        jnp.where(valid, r.astype(jnp.int32), jnp.int32(num_sigs))
        for r in raw
    ]
    if screen_sigs:
        locs.append(jnp.where(
            valid, make_mod_pair(screen_sigs)(h_hi, h_lo).astype(jnp.int32),
            jnp.int32(screen_sigs),
        ))
    vals = []
    if emit_values:
        z = jnp.uint32(0)
        vals = [jnp.where(valid, h_hi, z), jnp.where(valid, h_lo, z)]
    nk = valid.sum(axis=0, dtype=jnp.int32)[None, :]
    return (*locs, nk, *vals)


# 4-bit codes (A=1 C=2 G=3 T=4, invalid 0) and 2-bit codes -> ASCII
_LUT4 = np.zeros(16, dtype=np.int32)
_LUT4[1:5] = [ord(c) for c in "ACGT"]
_LUT2 = np.array([ord(c) for c in "ACGT"], dtype=np.int32)


def unpack_reads(reads, nmask, lmax: int, packed4: bool, packed2: bool):
    """Wire format -> ASCII bases [L, B] int32 (plain XLA):

    - ASCII: [B, lmax] uint8 (native.pack_rows);
    - ``packed4``: [B, lmax//2] uint8, two 4-bit codes per byte, low
      nibble first (native.pack_rows_4bit);
    - ``packed2``: codes [B, lmax//4] uint8, four 2-bit codes per byte,
      low pair first, plus ``nmask`` [B, lmax//8] uint8 with bit i%8 of
      byte i//8 set for an invalid base (native.pack_rows_2bit)."""
    import jax.numpy as jnp

    B = reads.shape[0]
    if packed2:
        codes = jnp.stack(
            [(reads >> jnp.uint8(2 * j)) & jnp.uint8(3) for j in range(4)],
            axis=-1,
        ).reshape(B, lmax)
        inv = jnp.stack(
            [(nmask >> jnp.uint8(j)) & jnp.uint8(1) for j in range(8)],
            axis=-1,
        ).reshape(B, lmax)
        return jnp.where(
            inv == 1, jnp.int32(0),
            jnp.take(jnp.asarray(_LUT2), codes.astype(jnp.int32)),
        ).T
    if packed4:
        codes = jnp.stack(
            [reads & jnp.uint8(15), reads >> jnp.uint8(4)], axis=-1
        ).reshape(B, lmax)
        return jnp.take(jnp.asarray(_LUT4), codes.T.astype(jnp.int32))
    return reads.T.astype(jnp.int32)


@functools.lru_cache(maxsize=None)
def make_hash_fn(
    k: int,
    lmax: int,
    num_sigs: int,
    max_hash: int,
    num_hashes: int = 1,
    screen_sigs: int = 0,
    emit_values: bool = False,
    packed4: bool = False,
    packed2: bool = False,
):
    """Build fn(reads) -> (*loc planes, nk, *value planes) (module
    docstring).  ``reads`` is the wire format of `unpack_reads` (a
    (codes, nmask) tuple with ``packed2``)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(reads, nmask=None):
        bases = unpack_reads(reads, nmask, lmax, packed4, packed2)
        return hash_planes(bases, k, num_sigs, max_hash, num_hashes,
                           screen_sigs, emit_values)

    def call(reads):
        if packed2:
            codes, nmask = reads
            if codes.shape[1] * 4 != lmax:
                raise ValueError("packed2 codes width != lmax // 4")
            return run(jnp.asarray(codes), jnp.asarray(nmask))
        width = lmax // 2 if packed4 else lmax
        if reads.shape[1] != width:
            raise ValueError(f"read matrix width {reads.shape[1]} != {width}")
        return run(jnp.asarray(reads))

    return call
