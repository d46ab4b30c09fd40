"""On-device minimizer / closed-syncmer window selection.

Sketch queries previously fell back off the jax backend: selection
streamed only through the host C++ deque path
(/root/reference/kmcp/cmd/util-db-search.go:1050-1106 is the
reference's in-engine sketch branch).  The device hash
(device_hash.py) emits each window's canonical 64-bit value as (hi, lo)
uint32 planes (for paired dedup), so selection becomes pure XLA over
[K, B] planes:

- minimizer: lexicographic (value, position) sliding-window minimum by
  log-doubling span composition; a position is selected when ANY
  in-range window's first-argmin lands on it — identical to the host's
  `_sliding_min` + one-emission-per-distinct-position rule
  (kmer/sketches.py:44-100), including the short-read (< w windows)
  single-window case with its all-valid guard.
- closed syncmer: s-mer window minimum (values only) compared against
  the first and last s-mer of each k-mer (sketches.py:102-131, the
  Edgar 2021 value rule — the reference's private deviation is
  documented in PARITY.md §1 and applies equally to every backend).

Invalid windows ride as (0, 0) value pairs (h == 0 is itself defined
invalid) and are remapped to u64::MAX so they never win a minimum; the
FracMinHash scale filter applies AFTER selection, exactly like the
host (`mins = scale_filter(mins); mins[mins > 0]`).  The one knowing
deviation: a window whose canonical hash is exactly 0 (probability
2^-64 per window) is treated as invalid here but participates in host
minima before being dropped — unobservable in practice.
"""

from __future__ import annotations


def _shift_up(x, d: int, fill):
    """x[i] <- x[i + d] along axis 0, tail filled."""
    import jax.numpy as jnp

    if d == 0:
        return x
    return jnp.concatenate(
        [x[d:], jnp.full((d,) + x.shape[1:], fill, x.dtype)]
    )


def _shift_down(x, d: int, fill):
    """x[i] <- x[i - d] along axis 0, head filled."""
    import jax.numpy as jnp

    if d == 0:
        return x
    return jnp.concatenate(
        [jnp.full((d,) + x.shape[1:], fill, x.dtype), x[:-d]]
    )


def _lex_take(ah, al, ap, bh, bl, bp):
    """Elementwise lexicographic min of (hi, lo, pos) triples."""
    import jax.numpy as jnp

    tb = (bh < ah) | ((bh == ah) & ((bl < al) | ((bl == al) & (bp < ap))))
    return (
        jnp.where(tb, bh, ah),
        jnp.where(tb, bl, al),
        jnp.where(tb, bp, ap),
    )


def _window_lexmin(vh, vl, w: int):
    """(mh, ml, mp)[i] = lexicographic min of (value, pos) over window
    [i, i+w) along axis 0 (log-doubling span composition)."""
    import jax.numpy as jnp

    K = vh.shape[0]
    U = jnp.uint32(0xFFFFFFFF)
    mp = jnp.broadcast_to(
        jnp.arange(K, dtype=jnp.int32)[:, None], vh.shape
    )
    mh, ml = vh, vl
    span = 1
    while span < w:
        d = min(span, w - span)
        mh, ml, mp = _lex_take(
            mh, ml, mp,
            _shift_up(mh, d, U), _shift_up(ml, d, U),
            _shift_up(mp, d, jnp.int32(2**30)),
        )
        span += d
    return mh, ml, mp


def _mask_invalid(vhi, vlo):
    """(hi, lo) with the hash's (0, 0) invalid encoding remapped to
    u64::MAX, plus the invalid mask itself."""
    import jax.numpy as jnp

    inv = (vhi == 0) & (vlo == 0)
    U = jnp.uint32(0xFFFFFFFF)
    return jnp.where(inv, U, vhi), jnp.where(inv, U, vlo), inv


def minimizer_selected(vhi, vlo, lens, k: int, w: int):
    """[K, B] value planes + read lengths -> selected bool [K, B]
    (device twin of sketches.minimizer_sketch; scale applies later)."""
    import jax.numpy as jnp

    K = vhi.shape[0]
    vh, vl, inv = _mask_invalid(vhi, vlo)
    n = jnp.maximum(lens - (k - 1), 0)[None, :]  # windows per read
    pos = jnp.arange(K, dtype=jnp.int32)[:, None]

    # ---- normal case: windows i in [0, n-w]
    mh, ml, mp = _window_lexmin(vh, vl, w)
    U = jnp.uint32(0xFFFFFFFF)
    # a window whose min is MAX was entirely invalid — the host drops
    # it (`ok = mn != U64_MAX`, sketches.py:95)
    wv = (pos <= n - w) & ~((mh == U) & (ml == U))
    sel = jnp.zeros(vh.shape, bool)
    for d in range(w):
        mp_d = _shift_down(mp, d, jnp.int32(-1))
        wv_d = _shift_down(wv, d, False)
        sel = sel | (wv_d & (mp_d == pos))

    # ---- short-read case (n < w): one window over [0, n), selected
    # only when every window of the read is valid
    n_inv = (inv & (pos < n)).sum(axis=0)  # invalid windows in range
    gh = jnp.where(pos < n, vh, jnp.uint32(0xFFFFFFFF))
    gl = jnp.where(pos < n, vl, jnp.uint32(0xFFFFFFFF))
    sh, sl, sp = _window_lexmin(gh, gl, K) if K > 1 else (gh, gl,
                                                         pos * 0)
    # row 0 of the K-wide window min = global first-argmin
    g_p = sp[0]
    sel_short = (
        (pos == g_p[None, :]) & (n_inv == 0)[None, :] & (n > 0)
    )
    return jnp.where(n >= w, sel, sel_short)


def syncmer_selected(vhi, vlo, s_vhi, s_vlo, lens, k: int, s: int):
    """[K, B] k-mer value planes + [K_s, B] s-mer value planes ->
    selected bool [K, B] (device twin of
    sketches.closed_syncmer_sketch)."""
    import jax.numpy as jnp

    K = vhi.shape[0]
    w = k - s + 1
    _, _, inv_k = _mask_invalid(vhi, vlo)
    sh, sl, _si = _mask_invalid(s_vhi, s_vlo)
    mh, ml, _mp = _window_lexmin(sh, sl, w)
    first_h, first_l = sh[:K], sl[:K]
    last_h = _shift_up(sh, w - 1, jnp.uint32(0xFFFFFFFF))[:K]
    last_l = _shift_up(sl, w - 1, jnp.uint32(0xFFFFFFFF))[:K]
    mh, ml = mh[:K], ml[:K]
    sel = (~inv_k) & (
        ((mh == first_h) & (ml == first_l))
        | ((mh == last_h) & (ml == last_l))
    )
    n = jnp.maximum(lens - (k - 1), 0)[None, :]
    pos = jnp.arange(K, dtype=jnp.int32)[:, None]
    return sel & (pos < n)


def apply_selection(selected, vhi, vlo, loc_planes, num_sigs: int,
                    max_hash: int):
    """Selected mask + scale filter -> (masked loc planes, new nk).
    Non-selected / over-scale windows point at the sentinel row and
    stop counting toward nkmers — the device query then carries exactly
    the host's sketch multiset (sketches.py: scale_filter + nonzero
    run after selection)."""
    import jax.numpy as jnp

    hi_t = jnp.uint32((max_hash >> 32) & 0xFFFFFFFF)
    lo_t = jnp.uint32(max_hash & 0xFFFFFFFF)
    in_scale = (vhi < hi_t) | ((vhi == hi_t) & (vlo <= lo_t))
    keep = selected & in_scale
    out = [
        jnp.where(keep, lp, jnp.int32(num_sigs)) for lp in loc_planes
    ]
    nk = keep.astype(jnp.int32).sum(axis=0)[None, :]
    return out, nk, keep


import functools


@functools.lru_cache(maxsize=None)
def make_sketch_transform(kind: str, k: int, param: int, num_sigs: int,
                          max_hash: int):
    """Jitted (loc_planes, vhi, vlo, s_planes, lens) ->
    (loc_planes', nk', vhi', vlo'): window selection + scale filter +
    sentinel masking for the device streaming path.  ``param`` = w
    (minimizer) or s (closed syncmer); unselected windows' values zero
    out so the in-step >threshold dedup never sees them."""
    import jax
    import jax.numpy as jnp

    def fn(loc_planes, vhi, vlo, s_planes, lens):
        if kind == "minimizer":
            sel = minimizer_selected(vhi, vlo, lens, k, param)
        else:
            sel = syncmer_selected(
                vhi, vlo, s_planes[0], s_planes[1], lens, k, param
            )
        locs, nk, keep = apply_selection(
            sel, vhi, vlo, loc_planes, num_sigs, max_hash
        )
        z = jnp.uint32(0)
        return (
            tuple(locs), nk,
            jnp.where(keep, vhi, z), jnp.where(keep, vlo, z),
        )

    return jax.jit(fn)
