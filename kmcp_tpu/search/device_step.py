"""Device search-step construction: the XLA building blocks shared by
every jax-backend tail — carry-save positional popcount
(`_unpack_count`, the pospop/pand replacement contraction,
/root/reference/kmcp/cmd/util-db-search.go:6728,6639), on-device sparse
candidate compaction, the dense per-batch read-search step
(`_make_read_search_step`), the count tails (`_make_count_tail`), the
sharded dense step (`_make_search_step`) and block stacking.

All names re-export through `kmcp_tpu.search.device`.
"""

from __future__ import annotations

import functools

import numpy as np


def _csa(a, b, c):
    """Carry-save adder on 32 independent bit-lanes per uint32 element:
    returns (sum, carry) with a+b+c == sum + 2*carry per bit-column."""
    u = a ^ b
    return u ^ c, (a & b) | (u & c)


def _unpack_sum(planes):
    """Naive positional popcount of [G, N] uint32 -> [N, 32] int32
    (bit j of each word, summed over the leading axis)."""
    import jax.numpy as jnp

    shifts = jnp.arange(32, dtype=jnp.uint32)
    bit = (planes[..., None] >> shifts) & jnp.uint32(1)
    return bit.astype(jnp.int32).sum(axis=0)


def _unpack_count(rows):
    """Positional popcount over the k-mer axis: uint32 rows [K, P, W]
    (k-MAJOR — the device hash emits [K, B] location planes, so the
    gather produces this layout for free) -> int32 per-target counts
    [P, W*32] (bit j of word w = target w*32 + j) — the pospop/pand
    replacement contraction shared by every device tail.

    Algorithm: the Harley-Seal carry-save-adder tree — the same scheme
    as the reference's pospop AVX2/AVX512 assembly
    (/root/reference/kmcp/cmd/util-db-search.go:6728 calls
    shenwei356/pospop.Count8) — mapped onto 32-bit lanes, where
    each uint32 element already carries 32 independent bit-columns.
    Groups of 16 k-mer planes collapse into one `sixteens` plane via 15
    CSAs (~75 lane-ops) while ones/twos/fours/eights chain across
    groups; only the per-group sixteens (K/16 planes) and the four
    residue planes pay the 32-shift bit-unpack.  ~11 lane-ops per
    (k-mer, word) vs ~96 for unpacking every plane (the round-1 form),
    and the k-major layout keeps (P, W) as one huge minor axis.
    K < 24 falls back to the naive unpack (the CSA residue
    unpacks dominate at tiny K)."""
    import jax.numpy as jnp

    K, Pp, W = rows.shape
    flat = rows.reshape(K, Pp * W)
    if K < 24:
        return _unpack_sum(flat).reshape(Pp, W * 32)

    G = K // 16
    tail = flat[G * 16 :]  # leftover planes: naive unpack below
    zero = jnp.zeros_like(flat[0])
    ones = twos = fours = eights = zero
    sixteens = []
    for g in range(G):
        x = [flat[16 * g + i] for i in range(16)]
        ones, t2a = _csa(ones, x[0], x[1])
        ones, t2b = _csa(ones, x[2], x[3])
        twos, f4a = _csa(twos, t2a, t2b)
        ones, t2a = _csa(ones, x[4], x[5])
        ones, t2b = _csa(ones, x[6], x[7])
        twos, f4b = _csa(twos, t2a, t2b)
        fours, e8a = _csa(fours, f4a, f4b)
        ones, t2a = _csa(ones, x[8], x[9])
        ones, t2b = _csa(ones, x[10], x[11])
        twos, f4a = _csa(twos, t2a, t2b)
        ones, t2a = _csa(ones, x[12], x[13])
        ones, t2b = _csa(ones, x[14], x[15])
        twos, f4b = _csa(twos, t2a, t2b)
        fours, e8b = _csa(fours, f4a, f4b)
        eights, s16 = _csa(eights, e8a, e8b)
        sixteens.append(s16)
    counts = _unpack_sum(jnp.stack(sixteens)) * 16
    counts += _unpack_sum(eights[None]) * 8
    counts += _unpack_sum(fours[None]) * 4
    counts += _unpack_sum(twos[None]) * 2
    counts += _unpack_sum(ones[None])
    if tail.shape[0]:
        counts += _unpack_sum(tail)
    return counts.reshape(Pp, W * 32)


def _nonzero_asc(flat_ok, budget: int, fill):
    """Ascending indices of the set lanes of a flat bool vector, padded
    with ``fill``: equivalent to ``jnp.nonzero(flat_ok, size=budget,
    fill_value=fill)`` but lowered as cumsum + vectorized binary search.

    Returns (idx int32 [budget], n_set int32) where n_set is the true
    set-lane count (callers retry with a larger budget when it exceeds
    the budget)."""
    import jax.numpy as jnp

    c = jnp.cumsum(flat_ok.astype(jnp.int32))
    j = jnp.arange(1, budget + 1, dtype=jnp.int32)
    idx = jnp.searchsorted(c, j, side="left").astype(jnp.int32)
    n = c[-1]
    return jnp.where(j <= n, idx, jnp.int32(fill)), n


def _compact_candidates(ok, counts, budget: int, cnt_fill):
    """Global candidate compaction of a [B, T] threshold mask: ascending
    flat indices + their counts + the EXACT candidate total (callers
    retry with a larger budget when it exceeds the budget).

    Always the flat ``_nonzero_asc`` cumsum+search, which is exact by
    construction: a per-read slot cap poisons every batch whose per-read
    hit tail exceeds it."""
    import jax.numpy as jnp

    B, T = ok.shape
    idx, n = _nonzero_asc(ok.reshape(-1), budget, B * T)
    cnt = jnp.take(counts.reshape(-1), jnp.minimum(idx, B * T - 1))
    cnt = jnp.where(idx < B * T, cnt, cnt_fill).astype(jnp.int32)
    return idx, cnt, n


@functools.lru_cache(maxsize=None)
def _make_read_search_step(
    k: int,
    num_hashes: int,
    cand_budget: int,
    max_hash: int,
    min_len: int,
    dedup_threshold: int,
    mesh=None,
    paired_dedup: bool = False,
):
    """Fully-fused device search: raw read bytes -> ntHash1 -> Bloom
    locations -> gather -> AND -> count -> threshold -> compaction, as
    one program (with ``mesh``, one shard_map program over the (d, t)
    mesh).

    The hash is device_hash.hash_planes.  Only the raw
    ASCII reads cross host->device and only the packed candidate list
    crosses back.

    With ``paired_dedup`` reads whose raw window count exceeds the dedup
    threshold are uniqued over the 64-bit k-mer values in-step instead
    of excluded (the reference's >256-k-mer dedup,
    util-db-search.go:874-908): the paired streaming mode, where joined
    mate rows routinely exceed 256 k-mers.
    """
    import jax
    import jax.numpy as jnp

    from .device_hash import hash_planes

    def hash_reads(reads, S):
        """reads [B, L] uint8 ASCII (pad 0) -> Bloom locations
        [B, n_win, h] int32 (invalid windows -> sentinel row S) and
        per-read valid-k-mer counts; shared by the single-device and
        shard_map paths."""
        outs = hash_planes(
            reads.T.astype(jnp.int32), k, S, max_hash, num_hashes,
            emit_values=paired_dedup,
        )
        locs, nkmers = list(outs[:num_hashes]), outs[num_hashes][0]
        if paired_dedup:
            locs, nkmers = _dedup_value_planes(
                outs[-2], outs[-1], locs, nkmers, dedup_threshold, S
            )
        return jnp.stack(locs, axis=-1).transpose(1, 0, 2), nkmers

    def count_reads(bits_ext, loc):
        """gather -> AND -> positional popcount: [B, T_local]."""
        rows = jnp.take(bits_ext, loc, axis=0)  # [B,K,h,W]
        acc = rows[..., 0, :]
        for jj in range(1, num_hashes):
            acc = acc & rows[..., jj, :]
        return _unpack_count(acc.transpose(1, 0, 2))

    def read_ok(counts, nkmers, lens, cmin, tmin_c, spos_c):
        c_thresh = jnp.take(
            cmin, jnp.minimum(nkmers, cmin.shape[0] - 1), axis=0
        )[:, None]
        ok = (
            (counts >= c_thresh)
            & (counts >= tmin_c[None, :])
            & spos_c[None, :]
            & (lens >= min_len)[:, None]
        )
        if not paired_dedup:
            ok &= (nkmers <= dedup_threshold)[:, None]
        return ok

    def step(bits_ext, reads, lens, cmin, tmin, sizes_pos):
        """reads [B, L] uint8 ASCII (pad 0); lens [B] int32."""
        B = reads.shape[0]
        loc, nkmers = hash_reads(reads, bits_ext.shape[0] - 1)
        counts = count_reads(bits_ext, loc)
        ok = read_ok(counts, nkmers, lens, cmin, tmin, sizes_pos)
        cidx, cnt, n_cand = _compact_candidates(
            ok, counts, cand_budget, -1
        )
        return jnp.concatenate([n_cand[None], cidx, cnt, nkmers])

    if mesh is None:
        return jax.jit(step)
    # shard_map: per-shard compaction, tiny all-gathered segments
    # (see _sharded_compact) instead of GSPMD's dense all-gather
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    d_size = mesh.shape["d"]
    t_size = mesh.shape["t"]

    def local(bits_l, reads_l, lens_l, bval_l, cmin, tmin, spos):
        loc, nkmers = hash_reads(reads_l, bits_l.shape[0] - 1)
        counts = count_reads(bits_l, loc)  # [B_d, T_l]
        B_d, W_t = counts.shape[0], counts.shape[1] // 32
        ti = jax.lax.axis_index("t")
        tg = _global_target_ids(1, W_t, t_size, ti)
        ok = read_ok(
            counts, nkmers, lens_l, cmin,
            jnp.take(tmin, tg), jnp.take(spos, tg),
        ) & bval_l[:, None]
        T = W_t * t_size * 32
        out = _sharded_compact(
            counts, ok, tg, T, B_d * d_size, B_d,
            jax.lax.axis_index("d"), cand_budget,
        )
        nk_full = jax.lax.all_gather(nkmers, "d").reshape(-1)
        return jnp.concatenate([out, nk_full])

    sharded = shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(None, "t"), P("d", None), P("d"), P("d"),
            P(), P(), P(),
        ),
        out_specs=P(),
        check_vma=False,
    )

    def wrapper(bits_ext, reads, lens, cmin, tmin, sizes_pos):
        B = reads.shape[0]
        B_pad = -(-B // d_size) * d_size
        bval = jnp.arange(B_pad) < B
        if B_pad != B:
            reads = jnp.pad(reads, ((0, B_pad - B), (0, 0)))
            lens = jnp.pad(lens, (0, B_pad - B))
        out = sharded(
            bits_ext, reads, lens, bval, cmin, tmin, sizes_pos
        )
        head = 1 + 2 * cand_budget
        return jnp.concatenate([out[:head], out[head : head + B]])

    return jax.jit(wrapper)


def _sharded_compact(counts, ok, tg, T, B, B_d, di, cand_budget):
    """Per-shard candidate compaction + cross-shard merge (runs INSIDE a
    shard_map body; every array is shard-local).

    The naive GSPMD lowering of ``jnp.nonzero`` over a (d, t)-sharded
    [B, T] count matrix all-gathers the whole dense matrix.  Instead
    each shard compacts its own candidates (budget-bounded) and only
    the packed segments cross the interconnect — the
    SPMD analog of the reference's per-node search + offline merge
    (/root/reference/kmcp/cmd/merge.go:333-367).  The merged list is
    re-sorted by global flat index, so the output is byte-identical to
    the dense single-device path whenever total <= cand_budget.

    counts [B_d, T_l] int32; ok [B_d, T_l] bool; tg [T_l] int32 global
    target ids; di = this shard's 'd' index.  Returns
    concat([total, idx_sorted, cnt_sorted]) — replicated after the
    all-gathers."""
    import jax.numpy as jnp
    from jax import lax

    T_l = counts.shape[1]
    flat_ok = ok.reshape(-1)
    pos, n_cand_l = _nonzero_asc(flat_ok, cand_budget, B_d * T_l)
    b_l = (pos // T_l).astype(jnp.int32)
    t_l = (pos % T_l).astype(jnp.int32)
    idx = (di.astype(jnp.int32) * B_d + b_l) * T + jnp.take(
        tg, jnp.minimum(t_l, T_l - 1)
    )
    idx = jnp.where(
        pos < B_d * T_l, idx, min(B * T, 2**31 - 1)
    ).astype(jnp.int32)
    cnt = jnp.take(counts.reshape(-1), jnp.minimum(pos, B_d * T_l - 1))
    cnt = jnp.where(pos < B_d * T_l, cnt, -1).astype(jnp.int32)
    return _merge_segments(n_cand_l, idx, cnt, cand_budget, B * T)


def _merge_segments(n_cand_l, idx, cnt, cand_budget, sent):
    """All-gather each shard's packed candidate segment over ('t', 'd')
    and splice + re-sort by global flat index (runs INSIDE a shard_map
    body).  Returns concat([total, idx_sorted, cnt_sorted]),
    replicated."""
    import jax.numpy as jnp
    from jax import lax

    sent = min(sent, 2**31 - 1)
    seg = jnp.concatenate([n_cand_l[None], idx, cnt])
    segs = lax.all_gather(seg, "t")
    segs = lax.all_gather(segs, "d").reshape(-1, seg.shape[0])
    total = segs[:, 0].sum()
    n_i = jnp.minimum(segs[:, 0], cand_budget)
    offs = jnp.cumsum(n_i) - n_i
    lane = jnp.arange(cand_budget, dtype=jnp.int32)
    po = jnp.where(
        lane[None, :] < n_i[:, None],
        offs[:, None] + lane[None, :],
        cand_budget,
    ).reshape(-1)
    idx_all = segs[:, 1 : 1 + cand_budget].reshape(-1)
    cnt_all = segs[:, 1 + cand_budget :].reshape(-1)
    out_idx = (
        jnp.full((cand_budget,), sent, jnp.int32).at[po]
        .set(idx_all, mode="drop")
    )
    out_cnt = (
        jnp.full((cand_budget,), -1, jnp.int32).at[po]
        .set(cnt_all, mode="drop")
    )
    order = jnp.argsort(out_idx)  # sentinel sorts last
    return jnp.concatenate(
        [total[None], jnp.take(out_idx, order), jnp.take(out_cnt, order)]
    )


def _global_target_ids(nb, W_t, t_size, ti):
    """Global target ids of this 't' shard's [nb, W_t, 32] local targets
    (blocks stacked on the word axis before sharding)."""
    import jax.numpy as jnp

    W = W_t * t_size
    return (
        (
            jnp.arange(nb, dtype=jnp.int32)[:, None, None] * W
            + ti.astype(jnp.int32) * W_t
            + jnp.arange(W_t, dtype=jnp.int32)[None, :, None]
        )
        * 32
        + jnp.arange(32, dtype=jnp.int32)[None, None, :]
    ).reshape(-1)


def _dedup_value_planes(vhi, vlo, locs, nk, threshold: int, sentinel: int):
    """Per-read unique over 64-bit k-mer values — the reference's
    >256-k-mer dedup (util-db-search.go:874-908), on device, for reads
    whose RAW window count exceeds ``threshold`` (smaller sets keep
    duplicates, reproducing the reference quirk).  Duplicate windows
    beyond the first are re-pointed at the sentinel row in every
    location plane and the read's k-mer count drops to its unique count.

    vhi/vlo: [K, B] uint32 halves of the window's ntHash value, 0 for
    invalid windows (the hash zeroes them; a valid window can never
    hash to 0 — h==0 is defined invalid).  locs: list of [K, B] int32
    planes.  ``sentinel`` is one int for all planes or a sequence of
    per-plane sentinels (the screened path's Bloom and union planes
    live in different modulus spaces).  Window order within a plane is
    irrelevant downstream (the count tail sums over K), so planes are
    returned value-sorted.

    ONE multi-operand lax.sort (num_keys=2, the location planes riding
    as payloads) replaces two chained stable argsorts + per-plane
    take_along_axis gathers: duplicates only need to land ADJACENT,
    and every copy of a duplicated window carries identical locations,
    so neither stability nor which copy survives matters."""
    import jax.numpy as jnp
    from jax import lax

    sents = (
        list(sentinel)
        if isinstance(sentinel, (tuple, list))
        else [sentinel] * len(locs)
    )

    sorted_ops = lax.sort(
        (vhi, vlo, *locs), dimension=0, num_keys=2, is_stable=False
    )
    hi_s, lo_s = sorted_ops[0], sorted_ops[1]
    valid = (hi_s != 0) | (lo_s != 0)
    prev_same = jnp.zeros_like(valid).at[1:].set(
        (hi_s[1:] == hi_s[:-1]) & (lo_s[1:] == lo_s[:-1])
    )
    dup = prev_same & valid
    apply = nk > threshold
    drop = dup & apply[None, :]
    nk_eff = jnp.where(apply, nk - dup.sum(axis=0, dtype=nk.dtype), nk)
    out = [
        jnp.where(drop, jnp.int32(s), loc_s)
        for loc_s, s in zip(sorted_ops[2:], sents)
    ]
    return out, nk_eff


def aux_dtype(dedup_threshold: int):
    """dtype of the per-candidate counts and per-read k-mer counts a
    device tail returns: uint16 while every counted read has at most
    ``dedup_threshold`` < 65535 k-mers (half the device->host bytes of
    int32), else int32."""
    import jax.numpy as jnp

    return jnp.uint16 if dedup_threshold < 65535 else jnp.int32


def clip_aux(x, dtype):
    import jax.numpy as jnp

    if dtype == jnp.uint16:
        x = jnp.clip(x, 0, 65535)
    return x.astype(dtype)


@functools.lru_cache(maxsize=None)
def _make_count_tail(
    cand_budget: int,
    min_len: int,
    dedup_threshold: int,
    n_chunks: int = 1,
    in_dedup: bool = False,
):
    """Jitted tail after device hashing: gather -> AND -> count ->
    threshold -> compaction.  Location planes arrive [K, B], one per
    hash function (device_hash.make_hash_fn).

    Returns (meta int32 [1 + budget] = [n_cand, idx...],
    aux [budget + B] = [cnt..., nkmers...], dtype `aux_dtype`).

    With ``n_chunks`` > 1 the batch is processed in B/n_chunks-read
    chunks under ``lax.map`` so the [K, B_c, W] gathered-rows
    intermediate stays bounded (at T = 131k targets, W = 4096 words, a
    full 16k-read gather would be 37 GB).  Per-chunk compactions are
    spliced into the same global (meta, aux) layout (chunk-major order
    preserves the ascending flat-index order); if any chunk overflows
    its budget share, the reported n_cand exceeds the global budget so
    the caller's standard 4x retry kicks in.

    With ``in_dedup`` the tail call takes ``vplanes`` = (vhi, vlo)
    [K, B] window values and over-threshold reads are uniqued here
    (_dedup_value_planes); nkmers and the reported qKmers become unique
    counts, matching the host path's in-kernel dedup."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    adt = aux_dtype(dedup_threshold)

    def count(bits_ext, loc_hkb):
        """[h, K, B?] location planes -> [B?, T] counts (rows AND
        across the h planes)."""
        acc = None
        for j in range(loc_hkb.shape[0]):
            rows = jnp.take(bits_ext, loc_hkb[j], axis=0)  # [K, B?, W]
            acc = rows if acc is None else acc & rows
        return _unpack_count(acc)

    def passing(counts, nk, lens, cmin, tmin, sizes_pos):
        c_thresh = jnp.take(
            cmin, jnp.minimum(nk, cmin.shape[0] - 1), axis=0
        )[:, None]
        ok = (
            (counts >= c_thresh)
            & (counts >= tmin[None, :])
            & sizes_pos[None, :]
            & (lens >= min_len)[:, None]
        )
        if not in_dedup:
            ok &= (nk <= dedup_threshold)[:, None]
        return ok

    def chunk_tail(bits_ext, loc_hkb, nk_c, lens_c, cmin, tmin, sizes_pos,
                   budget_c):
        counts = count(bits_ext, loc_hkb)
        B_c, T = counts.shape
        ok = passing(counts, nk_c, lens_c, cmin, tmin, sizes_pos)
        cidx, n_cand = _nonzero_asc(ok.reshape(-1), budget_c, B_c * T)
        cnt = jnp.take(counts.reshape(-1), jnp.minimum(cidx, B_c * T - 1))
        cnt = jnp.where(cidx < B_c * T, cnt, 0)
        return n_cand, cidx, clip_aux(cnt, adt)

    def tail(bits_ext, loc_ts, nk, lens, cmin, tmin, sizes_pos,
             vplanes=()):
        nkmers = nk[0]
        if in_dedup:
            loc_ts, nkmers = _dedup_value_planes(
                vplanes[0], vplanes[1], list(loc_ts), nkmers,
                dedup_threshold, bits_ext.shape[0] - 1,
            )
        aux_nk = clip_aux(nkmers, adt)
        loc_st = jnp.stack(loc_ts)  # [h, K, B]

        if n_chunks == 1:
            counts = count(bits_ext, loc_st)
            ok = passing(counts, nkmers, lens, cmin, tmin, sizes_pos)
            cidx, cnt, n_cand = _compact_candidates(
                ok, counts, cand_budget, 0
            )
            meta = jnp.concatenate([n_cand[None], cidx])
            aux = jnp.concatenate([clip_aux(cnt, adt), aux_nk])
            return meta, aux

        h_pl, K, B = loc_st.shape
        C = n_chunks
        B_c = B // C
        T = bits_ext.shape[1] * 32
        budget_c = -(-cand_budget // C)

        loc_chunks = loc_st.reshape(h_pl, K, C, B_c).transpose(2, 0, 1, 3)
        n_c, idx_c, cnt_c = lax.map(
            lambda args: chunk_tail(
                bits_ext, args[0], args[1], args[2],
                cmin, tmin, sizes_pos, budget_c,
            ),
            (loc_chunks, nkmers.reshape(C, B_c), lens.reshape(C, B_c)),
        )
        total = n_c.sum()
        overflowed = (n_c > budget_c).any()
        # global flat index: chunk i's read b_local is read i*B_c+b_local
        idx_g = idx_c + (
            jnp.arange(C, dtype=jnp.int32) * (B_c * T)
        )[:, None]
        n_eff = jnp.minimum(n_c, budget_c)
        offs = jnp.cumsum(n_eff) - n_eff
        lane = jnp.arange(budget_c, dtype=jnp.int32)
        po = jnp.where(
            lane[None, :] < n_eff[:, None],
            offs[:, None] + lane[None, :],
            cand_budget,  # dropped by the scatter
        ).reshape(-1)
        out_idx = (
            # sentinel clamped to int32 (B*T can reach 2^31; lanes beyond
            # meta[0] are never read)
            jnp.full((cand_budget,), min(B * T, 2**31 - 1), jnp.int32)
            .at[po].set(idx_g.reshape(-1), mode="drop")
        )
        out_cnt = (
            jnp.zeros((cand_budget,), adt)
            .at[po].set(cnt_c.reshape(-1), mode="drop")
        )
        # any per-chunk overflow must trigger the caller's global retry
        n_rep = jnp.where(
            overflowed, jnp.int32(cand_budget) + jnp.int32(1),
            total.astype(jnp.int32),
        )
        meta = jnp.concatenate([n_rep[None], out_idx])
        aux = jnp.concatenate([out_cnt, aux_nk])
        return meta, aux

    return jax.jit(tail)


@functools.lru_cache(maxsize=None)
def _make_search_step(num_hashes: int, cand_budget: int, mesh=None):
    """Jitted search step; with ``mesh`` (axes 'd', 't') the bit matrix is
    sharded over target words on 't', the read batch over 'd', and the
    whole body runs under shard_map: the gather stays shard-local and
    each shard compacts its own candidates before the tiny packed
    segments are all-gathered and merged on device (_sharded_compact) —
    the SPMD analog of the reference's per-node search + offline merge
    (SURVEY §2.9 P3/P7)."""
    import jax
    import jax.numpy as jnp

    def step(bits_ext, loc, nkmers, cmin, tmin, sizes_pos):
        """bits_ext [S_total+1, W] uint32 (last row all-zero sentinel);
        loc [B, K, nb, h] int32 (padding lanes point at the sentinel;
        blocks stacked row-wise with offsets already added);
        nkmers [B] int32; cmin [n_max+1] int32; tmin [T] int32;
        sizes_pos [T] bool (real targets).  T = nb * W * 32.
        Returns concat([n_cand, idx[C], cnt[C]]) int32."""
        rows = jnp.take(bits_ext, loc, axis=0)  # [B,K,nb,h,W]
        acc = rows[..., 0, :]
        for j in range(1, num_hashes):
            acc = acc & rows[..., j, :]
        # acc: [B,K,nb,W] -> k-major [K, B, nb*W] for the CSA contraction
        B, K, nb, W = acc.shape
        counts = _unpack_count(
            acc.transpose(1, 0, 2, 3).reshape(K, B, nb * W)
        )  # [B, nb*W*32] == [B,T]
        c_thresh = jnp.take(cmin, nkmers, axis=0)[:, None]  # [B,1]
        ok = (
            (counts >= c_thresh)
            & (counts >= tmin[None, :])
            & sizes_pos[None, :]
        )
        idx, cnt, n_cand = _compact_candidates(ok, counts, cand_budget, -1)
        out = jnp.concatenate([n_cand[None], idx, cnt])
        return out

    if mesh is None:
        return jax.jit(step)

    from jax import lax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    d_size = mesh.shape["d"]
    t_size = mesh.shape["t"]

    def local(bits_l, loc_l, nk_l, bval_l, cmin, tmin, sizes_pos):
        rows = jnp.take(bits_l, loc_l, axis=0)  # [B_d,K,nb,h,W_t]
        acc = rows[..., 0, :]
        for j in range(1, num_hashes):
            acc = acc & rows[..., j, :]
        B_d, K, nb, W_t = acc.shape
        counts = _unpack_count(
            acc.transpose(1, 0, 2, 3).reshape(K, B_d, nb * W_t)
        )  # [B_d,T_l]
        di = lax.axis_index("d")
        tg = _global_target_ids(nb, W_t, t_size, lax.axis_index("t"))
        c_thresh = jnp.take(cmin, nk_l, axis=0)[:, None]
        ok = (
            (counts >= c_thresh)
            & (counts >= jnp.take(tmin, tg)[None, :])
            & jnp.take(sizes_pos, tg)[None, :]
            & bval_l[:, None]
        )
        T = nb * W_t * t_size * 32
        return _sharded_compact(
            counts, ok, tg, T, B_d * d_size, B_d, di, cand_budget
        )

    sharded = shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(None, "t"), P("d", None, None, None), P("d"), P("d"),
            P(), P(), P(),
        ),
        out_specs=P(),
        check_vma=False,
    )

    def wrapper(bits_ext, loc, nkmers, cmin, tmin, sizes_pos):
        B = loc.shape[0]
        B_pad = -(-B // d_size) * d_size
        bval = jnp.arange(B_pad) < B
        if B_pad != B:
            # pad lanes point at the sentinel row; bval masks them out
            sent = bits_ext.shape[0] - 1
            loc = jnp.pad(
                loc, ((0, B_pad - B), (0, 0), (0, 0), (0, 0)),
                constant_values=sent,
            )
            nkmers = jnp.pad(nkmers, (0, B_pad - B))
        return sharded(bits_ext, loc, nkmers, bval, cmin, tmin, sizes_pos)

    return jax.jit(wrapper)


def _stack_blocks(db):
    """Stack a DB's blocks into one [S_total+1, W] matrix (+ sentinel row)
    with flattened per-target metadata; returns
    (stacked_ext, names, indices, gsizes, sizes, total_rows, w)."""
    blocks = db.blocks
    w_max = max(b.bits.shape[1] for b in blocks)
    mats = []
    names: list[str] = []
    indices: list[int] = []
    gsizes: list[int] = []
    sizes: list[int] = []
    row_offsets: list[int] = []
    row_off = 0
    for b in blocks:
        row_offsets.append(row_off)
        m = np.asarray(b.bits)
        if m.shape[1] < w_max:
            m = np.pad(m, ((0, 0), (0, w_max - m.shape[1])))
        mats.append(m)
        row_off += m.shape[0]
        names.extend(b.meta.names)
        indices.extend(b.meta.indices)
        gsizes.extend(b.meta.gsizes)
        sizes.extend(b.meta.sizes)
        pad = w_max * 32 - b.meta.num_targets
        if pad:
            names.extend([""] * pad)
            indices.extend([0] * pad)
            gsizes.extend([0] * pad)
            sizes.extend([0] * pad)
    stacked = np.concatenate(mats, axis=0)
    stacked = np.concatenate(
        [stacked, np.zeros((1, w_max), dtype=np.uint32)], axis=0
    )
    return stacked, names, indices, gsizes, sizes, row_off, w_max, row_offsets


