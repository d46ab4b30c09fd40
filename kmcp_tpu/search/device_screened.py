"""The two-pass screened device search: pass 1 counts a packed
per-block union screen (one 32-block word per k-mer), pass 2 gathers
and counts only each read's active blocks.  This is the
wide-target-count regime — the device analog of `index --block-screen`
union screens (/root/reference/kmcp/cmd/util-db-search.go:939-964 fans
queries to block indices; here the screen prunes the fan-out on the
device).

All names re-export through `kmcp_tpu.search.device`.
"""

from __future__ import annotations

import functools

import numpy as np

from .device_step import (
    _dedup_value_planes,
    _merge_segments,
    _nonzero_asc,
    _unpack_count,
    aux_dtype,
    clip_aux,
)

def _screen_geometry(db):
    """Shared union num_bits when a multi-block DB can run the device
    two-pass screened search, else None: single-hash, every block
    carries a union screen (index --block-screen) of one shared size,
    and the blocks share a Bloom ROW count so one location plane serves
    every block (widths may be ragged — they pad to w_max; a padded
    word's bits are zero and never count).  `index --uniform-sigs`
    forces both conditions on heterogeneous inputs; uniformly-chunked
    databases satisfy them by construction.  Reads only union headers."""
    if db.info.num_hashes != 1 or len(db.blocks) <= 1:
        return None
    from ..index.format import read_block_union_header

    n_bits = set()
    for b in range(len(db.blocks)):
        h = read_block_union_header(db.path, b)
        if h is None:
            return None
        n_bits.add(h[0])
    if len(n_bits) != 1:
        return None
    if len({blk.bits.shape[0] for blk in db.blocks}) != 1:
        return None
    return n_bits.pop()


def two_pass_ready(db) -> bool:
    """True when the device two-pass screened search can serve this DB
    (see _screen_geometry)."""
    return _screen_geometry(db) is not None


def build_packed_union(db, n_blocks: int):
    """(U_ext uint32 [num_bits+1, ceil(nb/32)], num_bits, fprs f64[nb])
    or None: bit g of row r = row r set in block g's union Bloom — ONE
    location plane probes every block's screen at once (the host's
    per-block union_count does nb u64-mods per k-mer; this does one).
    Requires the shared geometry of _screen_geometry."""
    from ..index.format import read_block_union

    nb_u = _screen_geometry(db)
    if nb_u is None:
        return None
    us = [read_block_union(db.path, b) for b in range(n_blocks)]
    Wu = -(-n_blocks // 32)
    U = np.zeros((nb_u + 1, Wu), np.uint32)
    fprs = []
    for g, (words, _nb, fpr) in enumerate(us):
        fprs.append(float(fpr))
        bits = np.unpackbits(
            words.view(np.uint8), bitorder="little", count=nb_u
        ).astype(np.uint32)
        U[:nb_u, g // 32] |= bits << np.uint32(g % 32)
    return U, nb_u, np.asarray(fprs, dtype=np.float64)


@functools.lru_cache(maxsize=None)
def _make_screened_tail(
    cand_budget: int,
    pair_budget: int,
    min_len: int,
    dedup_threshold: int,
    n_blocks: int,
    t_block: int,
    s_block: int,
    n_pair_chunks: int,
    in_dedup: bool = False,
):
    """Two-pass wide-T tail (single-hash): per-block union screen, then a
    dense count of ONLY the active (read, block) pairs.

    The reference's production regime counts every target for every read
    (util-db-search.go:939-964 broadcasts each query to every block); at
    GTDB scale that is ~131k target columns per read, of which a
    metagenomic read's true matches live in ~1 block.  Pass 1 gathers one
    word per k-mer from a packed block-union table (bit g of row r = row
    r set in block g's union Bloom, built by ``index --block-screen``)
    and keeps (read, block) pairs whose union-hit count clears the
    junk-FP band theta (same float64 host math as HostDB.screen_active);
    pass 2 gathers and counts only those pairs' rows — a ~n_blocks-fold
    cut of gather+count work.  Candidate order (ascending global flat
    index) and the (meta, aux) result layout match _make_count_tail, so
    the caller cannot tell which tail produced a result.

    Pairs are processed in ``n_pair_chunks`` chunks under lax.map so the
    [P_c, K, W_b] gathered-rows intermediate stays bounded; chunk-major
    splicing preserves pair order.  Overflow of either the pair budget or
    any chunk's candidate share reports n_cand = cand_budget + 1 so the
    caller's standard 4x retry (which scales both budgets) kicks in.

    With ``in_dedup`` the tail call takes ``vplanes`` = (vhi, vlo)
    [K, B] uint32 window values and reads over the dedup threshold are
    uniqued on device before BOTH passes (_dedup_value_planes over the
    Bloom and union planes, per-plane sentinels) instead of excluded —
    the paired streaming mode on multi-block screened DBs
    (util-db-search.go:800-805,874-908): the union theta, cmin and the
    reported qKmers all use the unique count, matching the host
    backend's dedup-then-screen order."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    adt = aux_dtype(dedup_threshold)

    def pair_chunk(bits_ext, loc_t, nkmers, pb_c, pg_c, pv_c, cmin, tmin2,
                   spos2, budget_c):
        """One chunk of pairs: pb_c/pg_c/pv_c [P_c].  Pairs are
        front-loaded, so trailing chunks are often ALL padding — a
        lax.cond skips their gather+count entirely (the pair budget's
        generosity then costs nothing at runtime)."""
        P_c = pb_c.shape[0]

        def heavy(_):
            sent = bits_ext.shape[0] - 1
            locp = jnp.take(loc_t, pb_c, axis=1)  # [K, P_c]
            r = jnp.where(
                locp == jnp.int32(s_block),
                jnp.int32(sent),
                locp + pg_c[None, :] * jnp.int32(s_block),
            )
            rows = jnp.take(bits_ext, r, axis=0)  # [K, P_c, W_b]
            counts = _unpack_count(rows)
            nk_c = jnp.take(nkmers, pb_c)
            c_thr = jnp.take(
                cmin, jnp.minimum(nk_c, cmin.shape[0] - 1)
            )[:, None]
            ok = (
                (counts >= c_thr)
                & (counts >= jnp.take(tmin2, pg_c, axis=0))
                & jnp.take(spos2, pg_c, axis=0)
                & pv_c[:, None]
            )
            cidx, n_c = _nonzero_asc(
                ok.reshape(-1), budget_c, P_c * t_block
            )
            cnt = jnp.take(
                counts.reshape(-1), jnp.minimum(cidx, P_c * t_block - 1)
            )
            cnt = jnp.where(cidx < P_c * t_block, cnt, 0)
            return n_c, cidx, clip_aux(cnt, adt)

        def empty(_):
            return (
                jnp.int32(0),
                jnp.full((budget_c,), P_c * t_block, jnp.int32),
                jnp.zeros((budget_c,), adt),
            )

        return lax.cond(pv_c.any(), heavy, empty, None)

    def tail(bits_ext, u_ext, loc_t, locu_t, nk, lens, cmin, theta_tab,
             tmin, sizes_pos, vplanes=()):
        nkmers = nk[0]
        B = nkmers.shape[0]
        if in_dedup:
            # paired joined rows: unique the >threshold window sets over
            # BOTH location planes (Bloom rows sentinel = s_block, union
            # rows sentinel = the table's zero row) before either pass
            (loc_t, locu_t), nkmers = _dedup_value_planes(
                vplanes[0], vplanes[1], [loc_t, locu_t], nkmers,
                dedup_threshold, (s_block, u_ext.shape[0] - 1),
            )

        # ---- pass 1: per-block union-hit counts + screen threshold
        urows = jnp.take(u_ext, locu_t, axis=0)  # [K, B, Wu] k-major
        ucnt = _unpack_count(urows)[:, :n_blocks]  # [B, nb]
        theta = jnp.take(
            theta_tab, jnp.minimum(nkmers, theta_tab.shape[1] - 1), axis=1
        ).T  # [B, nb]
        read_ok = (
            (lens >= min_len)
            if in_dedup
            else (lens >= min_len) & (nkmers <= dedup_threshold)
        )
        active = (ucnt >= theta) & read_ok[:, None]
        pairs, n_pairs = _nonzero_asc(
            active.reshape(-1), pair_budget, B * n_blocks
        )
        pv = pairs < B * n_blocks
        pidx = jnp.minimum(pairs, B * n_blocks - 1)
        pb = pidx // n_blocks
        pg = pidx % n_blocks

        # ---- pass 2: dense count of active pairs only (chunked)
        C = n_pair_chunks
        P_c = pair_budget // C
        # pairs are front-loaded (ascending compaction fills chunk 0
        # first), so every chunk gets the FULL candidate budget; the
        # splice scatter drops lanes beyond it and total>budget retries
        budget_c = cand_budget
        tmin2 = tmin.reshape(n_blocks, t_block)
        spos2 = sizes_pos.reshape(n_blocks, t_block)
        n_c, idx_c, cnt_c = lax.map(
            lambda a: pair_chunk(
                bits_ext, loc_t, nkmers, a[0], a[1], a[2],
                cmin, tmin2, spos2, budget_c,
            ),
            (pb.reshape(C, P_c), pg.reshape(C, P_c), pv.reshape(C, P_c)),
        )
        total = n_c.sum()
        overflowed = (n_c > budget_c).any() | (n_pairs > pair_budget)

        # split (read, target) ids of chunk i's local cidx: pair p =
        # i*P_c + cidx//t_block, read = pb[p], target = pg[p]*t_block +
        # cidx%t_block.  Split int32 ids carry no B*T < 2^31 limit (the
        # flat dense-tail encoding does), so huge-T DBs keep big
        # batches.  Pairs ascend by (b, g), t ascends within a pair, so
        # chunk-major splicing keeps the dense path's ascending order.
        p_loc = idx_c // t_block + (
            jnp.arange(C, dtype=jnp.int32) * P_c
        )[:, None]
        p_cap = jnp.minimum(p_loc, pair_budget - 1)
        valid_c = idx_c < P_c * t_block
        q_g = jnp.where(valid_c, jnp.take(pb, p_cap), B)
        t_g = jnp.where(
            valid_c, jnp.take(pg, p_cap) * t_block + idx_c % t_block, 0
        )
        n_eff = jnp.minimum(n_c, budget_c)
        offs = jnp.cumsum(n_eff) - n_eff
        lane = jnp.arange(budget_c, dtype=jnp.int32)
        po = jnp.where(
            lane[None, :] < n_eff[:, None],
            offs[:, None] + lane[None, :],
            cand_budget,  # dropped by the scatter
        ).reshape(-1)
        out_q = (
            jnp.full((cand_budget,), B, jnp.int32)
            .at[po].set(q_g.reshape(-1), mode="drop")
        )
        out_t = (
            jnp.zeros((cand_budget,), jnp.int32)
            .at[po].set(t_g.reshape(-1), mode="drop")
        )
        out_cnt = (
            jnp.zeros((cand_budget,), adt)
            .at[po].set(cnt_c.reshape(-1), mode="drop")
        )
        n_rep = jnp.where(
            overflowed, jnp.int32(cand_budget) + jnp.int32(1),
            total.astype(jnp.int32),
        )
        meta = jnp.concatenate([n_rep[None], out_q, out_t])
        aux = jnp.concatenate([out_cnt, clip_aux(nkmers, adt)])
        return meta, aux

    return jax.jit(tail)


@functools.lru_cache(maxsize=None)
def _make_screened_step_sharded(
    cand_budget: int,
    pair_budget_l: int,
    min_len: int,
    dedup_threshold: int,
    n_blocks: int,
    t_block: int,
    s_block: int,
    mesh,
):
    """Sharded two-pass screened search: blocks shard over mesh axis 't'
    (column-stacked uniform geometry, DeviceDB multi-block mesh layout),
    reads over 'd' — the screened composition of SURVEY P3 (index
    sharded by target) at GTDB scale.  Every shard runs pass 1 (the
    cheap one-word-per-k-mer union count) over ALL blocks but keeps
    only pairs of its OWN blocks, densely counts those, compacts
    locally, and the packed segments merge on device
    (_merge_segments) — collective volume stays O(budget), independent
    of T, like the dense sharded step.

    Inputs are host-computed location planes (loc/loc_u [B, K] int32,
    sentinels = the respective moduli).  Output: the legacy
    packed int32 array [1 + C + C + B] (idx ascending by global flat
    index — byte-identical to the single-device paths whenever no
    budget overflows)."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    d_size = mesh.shape["d"]
    t_size = mesh.shape["t"]
    nb_l = n_blocks // t_size
    T = n_blocks * t_block

    def local(bits_l, u_ext, loc_l, locu_l, nk_l, lens_l, bval_l,
              cmin, theta_tab, tmin2, spos2):
        ti = lax.axis_index("t")
        di = lax.axis_index("d")
        B_d = loc_l.shape[0]
        B = B_d * d_size

        # ---- pass 1: union screen (replicated table, all blocks)
        urows = jnp.take(u_ext, locu_l.T, axis=0)  # [K, B_d, Wu]
        ucnt = _unpack_count(urows)[:, :n_blocks]
        theta = jnp.take(
            theta_tab, jnp.minimum(nk_l, theta_tab.shape[1] - 1), axis=1
        ).T
        read_ok = (
            (lens_l >= min_len) & (nk_l <= dedup_threshold) & bval_l
        )
        g = jnp.arange(n_blocks, dtype=jnp.int32)
        mine = (g >= ti * nb_l) & (g < (ti + 1) * nb_l)
        active = (ucnt >= theta) & read_ok[:, None] & mine[None, :]
        pairs, n_pairs_l = _nonzero_asc(
            active.reshape(-1), pair_budget_l, B_d * n_blocks
        )
        pv = pairs < B_d * n_blocks
        pidx = jnp.minimum(pairs, B_d * n_blocks - 1)
        pb = pidx // n_blocks
        pg = pidx % n_blocks
        pg_l = jnp.clip(pg - ti * nb_l, 0, nb_l - 1)

        # ---- pass 2: dense count of this shard's active pairs
        # bits_l [S_b+1, nb_l*W_b] -> flat [(S_b+1)*nb_l, W_b]; the
        # sentinel row's slices are all-zero for any block, so the
        # sentinel location maps to row s_block*nb_l + pg_l safely
        W_b = bits_l.shape[1] // nb_l
        bits3 = bits_l.reshape((s_block + 1) * nb_l, W_b)
        locp = jnp.take(loc_l, pb, axis=0)  # [P_l, K]
        r = (locp * nb_l + pg_l[:, None]).T  # [K, P_l]
        rows = jnp.take(bits3, r, axis=0)  # [K, P_l, W_b]
        counts = _unpack_count(rows)
        P_l = counts.shape[0]
        nk_p = jnp.take(nk_l, pb)
        c_thr = jnp.take(
            cmin, jnp.minimum(nk_p, cmin.shape[0] - 1)
        )[:, None]
        ok = (
            (counts >= c_thr)
            & (counts >= jnp.take(tmin2, pg, axis=0))
            & jnp.take(spos2, pg, axis=0)
            & pv[:, None]
        )
        cidx, n_c = _nonzero_asc(ok.reshape(-1), cand_budget, P_l * t_block)
        cnt = jnp.take(
            counts.reshape(-1), jnp.minimum(cidx, P_l * t_block - 1)
        )
        cnt = jnp.where(cidx < P_l * t_block, cnt, -1).astype(jnp.int32)
        p_of = jnp.minimum(cidx // t_block, P_l - 1)
        sent = min(B * T, 2**31 - 1)
        gidx = (
            (di.astype(jnp.int32) * B_d + jnp.take(pb, p_of)) * T
            + jnp.take(pg, p_of) * t_block
            + cidx % t_block
        )
        gidx = jnp.where(cidx < P_l * t_block, gidx, sent).astype(jnp.int32)
        # a pair-budget overflow must poison the global total so the
        # caller's 4x retry fires
        n_rep = jnp.where(
            n_pairs_l > pair_budget_l,
            jnp.int32(cand_budget) + jnp.int32(1),
            n_c,
        )
        out = _merge_segments(n_rep, gidx, cnt, cand_budget, B * T)
        nk_full = lax.all_gather(nk_l, "d").reshape(-1)
        return jnp.concatenate([out, nk_full])

    sharded = shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(None, "t"), P(), P("d", None), P("d", None), P("d"),
            P("d"), P("d"), P(), P(), P(), P(),
        ),
        out_specs=P(),
        check_vma=False,
    )

    def wrapper(bits_ext, u_ext, loc, locu, nkmers, lens,
                cmin, theta_tab, tmin, sizes_pos):
        B = loc.shape[0]
        B_pad = -(-B // d_size) * d_size
        bval = jnp.arange(B_pad) < B
        if B_pad != B:
            pad = B_pad - B
            loc = jnp.pad(loc, ((0, pad), (0, 0)),
                          constant_values=s_block)
            locu = jnp.pad(locu, ((0, pad), (0, 0)),
                           constant_values=u_ext.shape[0] - 1)
            nkmers = jnp.pad(nkmers, (0, pad))
            lens = jnp.pad(lens, (0, pad))
        tmin2 = tmin.reshape(n_blocks, t_block)
        spos2 = sizes_pos.reshape(n_blocks, t_block)
        out = sharded(
            bits_ext, u_ext, loc, locu, nkmers, lens, bval,
            cmin, theta_tab, tmin2, spos2,
        )
        head = 1 + 2 * cand_budget
        return jnp.concatenate([out[:head], out[head : head + B]])

    return jax.jit(wrapper)

