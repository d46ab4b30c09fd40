"""Full-device search pipeline: hash -> gather -> AND -> count ->
threshold -> sparse compaction, one dispatch per read batch.

Instead of pulling the dense [B, T] count matrix (~40 MB per 64k-read
batch), all match thresholds are applied ON DEVICE and only the packed
sparse candidates (~20 B/read) cross back.

Threshold exactness: the reference compares float64 quantities
(count > nKmers*minQcov, queryFPR(n,count) <= maxFPR, count/targetKmers >=
minTcov; util-db-search.go:7466-7493).  All three are monotone in count,
so we precompute, in float64 on the host, the smallest passing count:

    cmin[n]  = max(min_kmers,
                   min{c : c > n*min_qcov},
                   min{c : queryFPR(n, c) <= max_fpr})        (per query n)
    tmin[t]  = min{c : c/size_t >= min_tcov}                  (per target)

and the device applies pure integer comparisons — bit-identical decisions
to the host reference path.
"""

from __future__ import annotations

import functools
import os

import numpy as np

from .fpr import QueryFPRCache

# the compile cache's fixed place when JAX_COMPILATION_CACHE_DIR is
# unset: inside the checkout (gitignored), because the path is part of
# the cache key and must not move between runs
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def compile_cache_dir() -> str:
    """Where compiled programs persist across processes."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def enable_compilation_cache():
    """Persist compiled programs across processes.  Where
    JAX_COMPILATION_CACHE_DIR is set JAX reads it itself and nothing is
    set here; otherwise the cache goes to REPO_CACHE_DIR."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    if jax.config.jax_compilation_cache_dir != REPO_CACHE_DIR:
        jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def build_cmin_table(
    n_max: int,
    min_kmers: int,
    min_qcov: float,
    max_fpr: float,
    fpr_cache: QueryFPRCache,
) -> np.ndarray:
    """cmin[n] for n in 0..n_max (int32); cmin > n means 'cannot pass'."""
    out = np.empty(n_max + 1, dtype=np.int32)
    for n in range(n_max + 1):
        # smallest c with c > n*min_qcov (exact float64 compare)
        c_q = int(np.floor(n * min_qcov)) + 1
        while not (float(c_q) > n * min_qcov):
            c_q += 1
        c = max(min_kmers, c_q)
        # FPR is decreasing in c: advance until it passes (or exceeds n)
        while c <= n and fpr_cache(n, c) > max_fpr:
            c += 1
        out[n] = c if c <= n else n + 1  # n+1 == impossible
    return out


def build_tmin_table(sizes: np.ndarray, min_tcov: float) -> np.ndarray:
    """tmin[t]: smallest count with count/size >= min_tcov (float64)."""
    if min_tcov <= 0:
        return np.ones(len(sizes), dtype=np.int32)
    out = np.empty(len(sizes), dtype=np.int32)
    for i, s in enumerate(sizes):
        c = int(np.ceil(float(s) * min_tcov))
        while c / float(s) < min_tcov:
            c += 1
        while c > 0 and (c - 1) / float(s) >= min_tcov:
            c -= 1
        out[i] = max(c, 0)
    return out


# The step-construction and screened-two-pass machinery lives in sibling
# modules; every public-in-practice name still imports from this module.
from .device_step import (  # noqa: F401,E402
    _compact_candidates,
    _csa,
    _dedup_value_planes,
    _global_target_ids,
    _make_count_tail,
    _make_read_search_step,
    _make_search_step,
    _merge_segments,
    _nonzero_asc,
    _sharded_compact,
    _stack_blocks,
    _unpack_count,
    _unpack_sum,
)
from .device_screened import (  # noqa: F401,E402
    _make_screened_step_sharded,
    _make_screened_tail,
    _screen_geometry,
    build_packed_union,
    two_pass_ready,
)

class HostDB:
    """Pure-host backend with the DeviceDB interface: C++ hashing + C++
    sparse-bit match counting + exact integer thresholds: the plain
    reference the device backend is compared with byte for byte; output
    layout matches the device step so the streaming writer is shared."""

    def __init__(self, db, opt):
        from ..kmer import native

        if native.get_lib() is None:
            raise RuntimeError("host backend requires the native library")
        self.db = db
        self.opt = opt
        self.mesh = None
        (stacked, names, indices, gsizes, sizes, rows, w, row_offsets) = (
            _stack_blocks(db)
        )
        self.n_blocks = len(db.blocks)
        self.block_row_offset = row_offsets
        self.block_num_sigs = [b.meta.num_sigs for b in db.blocks]
        self.bits_ext_np = stacked
        self.total_rows = rows
        self.sentinel = rows
        self.w = w
        self.t_per_block = w * 32
        self.names = names
        self.indices = np.asarray(indices, dtype=np.int64)
        self.gsizes = np.asarray(gsizes, dtype=np.int64)
        self.sizes = np.asarray(sizes, dtype=np.int64)
        self.sizes_pos_np = self.sizes > 0
        self._tmin_np = build_tmin_table(
            self.sizes.astype(np.float64), opt.min_target_cov
        )
        self._cmin_np: dict[int, np.ndarray] = {}
        # per-block union screens (large-T block skip; native extension);
        # KMCP_TPU_NO_SCREEN=1 ignores them (A/B benchmarking)
        from ..index.format import read_block_union

        if os.environ.get("KMCP_TPU_NO_SCREEN"):
            self.block_unions = [None] * self.n_blocks
        else:
            self.block_unions = [
                read_block_union(db.path, b) for b in range(self.n_blocks)
            ]
        self.has_screen = any(u is not None for u in self.block_unions)
        # packed union table (uniform geometry): ONE u64 mod per k-mer
        # probes every block's screen via the AVX2 count kernel instead
        # of n_blocks mod+test passes — isolated probe cost 0.55 s vs
        # 0.03 s per 8k reads at 256 blocks (1M targets)
        self.packed_union = (
            build_packed_union(db, self.n_blocks)
            if self.has_screen and self.n_blocks > 1
            else None
        )

    def _cmin(self, n_max: int) -> np.ndarray:
        n_max = max(64, -(-n_max // 64) * 64)
        t = self._cmin_np.get(n_max)
        if t is None:
            t = build_cmin_table(
                n_max, self.opt.min_kmers, self.opt.min_query_cov,
                self.opt.max_fpr, self.db.query_fpr,
            )
            self._cmin_np[n_max] = t
        return t

    def _hash_batch(self, seqs, k, kmax, dedup_threshold=0, minimizer_w=0,
                    syncmer_s=0):
        from ..kmer import native

        out, counts = native.hash_reads_padded(
            seqs, k, kmax, canonical=self.db.info.canonical,
            max_hash=self.db.max_hash, dedup_threshold=dedup_threshold,
            minimizer_w=minimizer_w, syncmer_s=syncmer_s,
        )
        return out, None, counts

    def search_reads_async(self, reads_u8, lens, cand_budget, seqs=None,
                           dedup_threshold=0, eff_lens=None, mates=None):
        """Synchronous host implementation returning the device-compatible
        packed int32 array [1 + C + C + B].

        ``dedup_threshold`` > 0 enables in-kernel per-read deduplication
        of large k-mer sets (reference util-db-search.go:874-908), so
        such reads need no slow-path fallback.  ``eff_lens`` overrides
        the per-read lengths used for the min-query-length filter (for
        paired reads: max(len1, len2), while ``lens`` sizes the joined
        hash rows).  ``mates`` (an interleaved [m1_0, m2_0, m1_1, ...]
        list of 2B sequences) hashes each mate as its own row — sketch
        selection windows must not cross the mate junction
        (engine.py:408-414) — and merges row pairs by reshape; the
        combined k-mer multiset then matches the reference's
        concatenation of per-mate sketches (util-db-search.go:800-805).
        Callers pass dedup_threshold=0 with mates (per-row in-kernel
        dedup cannot deduplicate across a pair)."""
        from ..kmer import native

        opt = self.opt
        db = self.db
        k = sorted(db.info.ks)[-1]
        B, L = reads_u8 if isinstance(reads_u8, tuple) else reads_u8.shape
        kmax = L - k + 1
        if mates is not None:
            dedup_threshold = 0
            kmax_m = max(max(len(s) for s in mates) - k + 1, 1)
        if seqs is None:
            seqs = [bytes(reads_u8[i, : lens[i]]) for i in range(B)]
        h = db.info.num_hashes
        mw = db.info.minimizer_w if db.info.minimizer else 0
        ss = db.info.syncmer_s if db.info.syncmer else 0

        lib = native.get_lib()
        sparse = lib is not None and hasattr(lib, "kt_count_hashes_sparse")
        T_total = self.n_blocks * self.t_per_block

        # per-read / per-target integer thresholds (exact float64
        # pre-computation; see module docstring).  INT32_MAX marks
        # excluded reads / padding target lanes for the sparse kernel.
        def read_thresholds(nkmers):
            cmin = self._cmin(int(nkmers.max(initial=1)))
            cmin_r = cmin[np.minimum(nkmers, len(cmin) - 1)].astype(
                np.int32
            )
            len_ok = np.asarray(
                eff_lens if eff_lens is not None else lens
            ) >= opt.min_query_len
            excl = ~len_ok
            if dedup_threshold <= 0:
                # without in-kernel dedup, over-threshold reads fall
                # back to the object engine upstream
                excl |= nkmers > opt.kmer_dedup_threshold
            cmin_r[excl] = np.iinfo(np.int32).max
            return cmin_r, len_ok

        def tmin_eff():
            t = getattr(self, "_tmin_eff_np", None)
            if t is None:
                t = np.where(
                    self.sizes_pos_np,
                    np.maximum(self._tmin_np, 1),
                    np.iinfo(np.int32).max,
                ).astype(np.int32)
                self._tmin_eff_np = t
            return t

        ucnt_state: dict = {}

        def screen_active(b, hashes, nk):
            """Union-screen activity mask for block b, or None: a read
            passes only when its union-bloom hit count clears the
            junk-FP band (mean fpr_u*n + 3 sigma; index/build.py
            _write_union_screen).  With the packed union table, one
            hash+count pass computed lazily per batch serves every
            block."""
            u = self.block_unions[b]
            if u is None:
                return None
            words, num_bits, fpr_u = u
            uc = None
            if self.packed_union is not None:
                if "mat" not in ucnt_state:
                    U, nbits, _f = self.packed_union
                    loc_u = native.locations(hashes, 1, nbits)
                    if loc_u is None:
                        ucnt_state["mat"] = None
                    else:
                        loc_u[hashes[..., None] == 0] = np.int32(nbits)
                        ucnt_state["mat"] = native.count_block(
                            U, loc_u, 1
                        )
                if ucnt_state["mat"] is not None:
                    uc = ucnt_state["mat"][:, b]
            if uc is None:
                uc = native.union_count(words, num_bits, hashes)
            if uc is None:
                return None
            theta = np.maximum(
                opt.min_kmers,
                np.ceil(
                    fpr_u * nk + 3.0 * np.sqrt(nk * fpr_u * (1 - fpr_u))
                ),
            )
            return (uc >= theta).astype(np.uint8)

        if self.n_blocks == 1:
            if mates is not None:
                # [2B, kmax_m, h] -> [B, 2*kmax_m, h]: row pairs are
                # adjacent in memory, so the merge is a free reshape
                loc2, c2 = native.hash_reads_loc(
                    mates, k, kmax_m, self.total_rows, h,
                    canonical=db.info.canonical, max_hash=db.max_hash,
                    minimizer_w=mw, syncmer_s=ss,
                )
                loc = loc2.reshape(B, 2 * kmax_m, h)
                counts_per_read = c2.reshape(B, 2).sum(axis=1)
            else:
                loc, counts_per_read = native.hash_reads_loc(
                    seqs, k, kmax, self.total_rows, h,
                    canonical=db.info.canonical, max_hash=db.max_hash,
                    dedup_threshold=dedup_threshold, minimizer_w=mw,
                    syncmer_s=ss,
                )
            nkmers = counts_per_read.astype(np.int32)
            if sparse:
                cmin_r, _ = read_thresholds(nkmers)
                idx_out = np.empty(cand_budget, dtype=np.int64)
                cnt_out = np.empty(cand_budget, dtype=np.int32)
                n_cand = native.count_block_sparse(
                    self.bits_ext_np, loc, h, cmin_r, tmin_eff(),
                    0, T_total, cand_budget, idx_out, cnt_out, 0,
                )
                return self._pack_sparse(
                    n_cand, idx_out, cnt_out, nkmers, cand_budget, B
                )
            counts = native.count_block(self.bits_ext_np, loc, h)
        else:
            # multi-block: hash once, derive per-block row offsets, count
            # each block into its slice of the global target space
            if mates is not None:
                h2, _, c2 = self._hash_batch(
                    mates, k, kmax_m, minimizer_w=mw, syncmer_s=ss,
                )
                hashes = h2.reshape(B, 2 * kmax_m)
                counts_per_read = c2.reshape(B, 2).sum(axis=1)
            else:
                hashes, _, counts_per_read = self._hash_batch(
                    seqs, k, kmax, dedup_threshold=dedup_threshold,
                    minimizer_w=mw, syncmer_s=ss,
                )
            nkmers = counts_per_read.astype(np.int32)
            nk = counts_per_read.astype(np.float64)
            if sparse:
                # fused per-block count+threshold+compaction: the dense
                # [B, T] count/threshold arrays never materialize (the
                # NumPy pass over them dominated beyond ~10k targets)
                cmin_r, _ = read_thresholds(nkmers)
                idx_out = np.empty(cand_budget, dtype=np.int64)
                cnt_out = np.empty(cand_budget, dtype=np.int32)
                te = tmin_eff()
                hashes_c = np.ascontiguousarray(hashes, dtype=np.uint64)
                n_cand = 0
                for b in range(self.n_blocks):
                    # locations derive in-kernel (hash 0 = padding lane)
                    t_off = b * self.t_per_block
                    n_cand = native.count_hashes_sparse(
                        self.bits_ext_np, hashes_c, h,
                        self.block_num_sigs[b], self.block_row_offset[b],
                        cmin_r, te[t_off : t_off + self.t_per_block],
                        t_off, T_total, cand_budget, idx_out, cnt_out,
                        n_cand, active=screen_active(b, hashes_c, nk),
                    )
                return self._pack_sparse(
                    n_cand, idx_out, cnt_out, nkmers, cand_budget, B
                )
            if not self.has_screen and self.w <= 2:
                # fused single-call path: per-block locations derived
                # and counted in C++ (no per-block Python loop or
                # [B,K,h] intermediates).  Only for NARROW blocks (the
                # reference's 8/32-target layout, w <= 2 words): its
                # scalar per-word walk recomputes the location per word,
                # which loses to the AVX2 path on wide blocks
                counts = native.count_blocks(
                    self.bits_ext_np, hashes, h,
                    np.asarray(self.block_row_offset, dtype=np.int64),
                    np.asarray(self.block_num_sigs, dtype=np.uint64),
                )
            else:
                parts = []
                for b in range(self.n_blocks):
                    s_b = self.block_num_sigs[b]
                    loc_b = native.locations(hashes, h, s_b)
                    loc_b = loc_b + np.int32(self.block_row_offset[b])
                    loc_b[hashes == 0] = np.int32(self.sentinel)
                    parts.append(
                        native.count_block(
                            self.bits_ext_np, loc_b, h,
                            active=screen_active(b, hashes, nk),
                        )
                    )
                counts = np.concatenate(parts, axis=1)
        # dense fallback (old native builds without the sparse kernel)
        cmin = self._cmin(int(nkmers.max(initial=1)))
        c_thresh = cmin[np.minimum(nkmers, len(cmin) - 1)][:, None]
        len_ok = np.asarray(
            eff_lens if eff_lens is not None else lens
        ) >= opt.min_query_len
        ok = (
            (counts >= c_thresh)
            & (counts >= self._tmin_np[None, :])
            & self.sizes_pos_np[None, :]
            & len_ok[:, None]
        )
        if dedup_threshold <= 0:
            ok &= (nkmers <= opt.kmer_dedup_threshold)[:, None]
        flat = np.nonzero(ok.reshape(-1))[0]
        n_cand = len(flat)
        out = np.empty(1 + 2 * cand_budget + B, dtype=np.int64)
        out[0] = n_cand
        ncap = min(n_cand, cand_budget)
        out[1 : 1 + ncap] = flat[:ncap]
        out[1 + cand_budget : 1 + cand_budget + ncap] = counts.reshape(-1)[
            flat[:ncap]
        ]
        out[1 + 2 * cand_budget :] = nkmers
        return out

    @staticmethod
    def _pack_sparse(n_cand, idx_out, cnt_out, nkmers, cand_budget, B):
        out = np.empty(1 + 2 * cand_budget + B, dtype=np.int64)
        out[0] = n_cand
        ncap = min(n_cand, cand_budget)
        out[1 : 1 + ncap] = idx_out[:ncap]
        out[1 + cand_budget : 1 + cand_budget + ncap] = cnt_out[:ncap]
        out[1 + 2 * cand_budget :] = nkmers
        return out


class DeviceDB:
    """Device-resident single-group bit matrix for the fast path.

    Usable when the DB's blocks share one word-width after padding and the
    total rows fit HBM; blocks are stacked row-wise with per-block row
    offsets folded into the location computation by the C++ hasher (one
    block) or host code (few blocks)."""

    def __init__(self, db, opt, mesh=None):
        import jax
        import jax.numpy as jnp

        from .platform import device_route

        device_route()  # raises on a platform with no device route
        enable_compilation_cache()
        self.db = db
        self.opt = opt
        self.mesh = mesh
        blocks = db.blocks
        self.n_blocks = len(blocks)
        w_max = max(b.bits.shape[1] for b in blocks)
        mats = []
        names: list[str] = []
        indices: list[int] = []
        gsizes: list[int] = []
        sizes: list[int] = []
        self.block_row_offset = []
        self.block_t_offset = []
        row_off = 0
        for b in blocks:
            m = np.asarray(b.bits)
            if m.shape[1] < w_max:
                m = np.pad(m, ((0, 0), (0, w_max - m.shape[1])))
            mats.append(m)
            self.block_row_offset.append(row_off)
            row_off += m.shape[0]
            names.extend(b.meta.names)
            indices.extend(b.meta.indices)
            gsizes.extend(b.meta.gsizes)
            # per-block target list padded to w_max*32 lanes
            pad = w_max * 32 - b.meta.num_targets
            sizes.extend(b.meta.sizes)
            if pad:
                names.extend([""] * pad)
                indices.extend([0] * pad)
                gsizes.extend([0] * pad)
                sizes.extend([0] * pad)
        self.total_rows = row_off
        if mesh is not None and self.n_blocks > 1:
            # sharded multi-block layout: uniform-geometry blocks stack
            # COLUMN-wise so mesh axis 't' shards whole blocks and one
            # modulus (rows = S_b) serves every shard — the screened
            # composition of SURVEY P3 (_make_screened_step_sharded)
            if len({m.shape for m in mats}) != 1:
                raise ValueError(
                    "sharded multi-block DeviceDB needs uniform block "
                    "geometry (index --uniform-sigs)"
                )
            if self.n_blocks % mesh.shape["t"]:
                raise ValueError(
                    f"{self.n_blocks} blocks do not divide the 't' axis "
                    f"({mesh.shape['t']})"
                )
            stacked = np.concatenate(mats, axis=1)
            self.total_rows = mats[0].shape[0]
        else:
            stacked = np.concatenate(mats, axis=0)
        if mesh is not None and self.n_blocks == 1:
            # pad word axis so the 't' shard axis divides it evenly
            t_shards = mesh.shape["t"]
            pad_w = (-stacked.shape[1]) % t_shards
            if pad_w:
                stacked = np.pad(stacked, ((0, 0), (0, pad_w)))
                w_max += pad_w
                names.extend([""] * (pad_w * 32))
                indices.extend([0] * (pad_w * 32))
                gsizes.extend([0] * (pad_w * 32))
                sizes.extend([0] * (pad_w * 32))
        stacked = np.concatenate(
            [stacked, np.zeros((1, stacked.shape[1]), dtype=np.uint32)],
            axis=0,
        )  # sentinel row
        self.w = w_max
        self.t_per_block = w_max * 32
        self.sentinel = self.total_rows
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            dev = NamedSharding(mesh, P(None, "t"))
            repl = NamedSharding(mesh, P())
        else:
            dev = jax.devices()[0]
            repl = dev
        self.bits_ext = jax.device_put(jnp.asarray(stacked), dev)
        self.names = names
        self.indices = np.asarray(indices, dtype=np.int64)
        self.gsizes = np.asarray(gsizes, dtype=np.int64)
        self.sizes = np.asarray(sizes, dtype=np.int64)
        self.sizes_pos_np = self.sizes > 0
        self.sizes_pos = jax.device_put(jnp.asarray(self.sizes_pos_np), repl)
        self._tmin_np = build_tmin_table(
            self.sizes.astype(np.float64), opt.min_target_cov
        )
        self._tmin = jax.device_put(jnp.asarray(self._tmin_np), repl)
        self._cmin_cache: dict[int, object] = {}
        self._dev = repl
        # two-pass block screen (multi-block wide DBs; _make_screened_tail
        # single-device, _make_screened_step_sharded on a mesh)
        self.screen = None
        if self.n_blocks > 1 and db.info.num_hashes == 1:
            self.screen = self._load_screen(db)
        if mesh is not None and self.n_blocks > 1 and self.screen is None:
            raise ValueError(
                "sharded multi-block DeviceDB needs the block screen "
                "(index --block-screen --uniform-sigs)"
            )

    def _load_screen(self, db):
        """Packed block-union table for the device two-pass search, or
        None: U[r, g//32] bit g%32 = row r set in block g's union Bloom
        (index --block-screen artifacts; one shared modulus requires
        equal union sizes — uniformly-chunked DBs satisfy this)."""
        import jax
        import jax.numpy as jnp

        if os.environ.get("KMCP_TPU_NO_SCREEN"):
            return None
        packed = build_packed_union(db, self.n_blocks)
        if packed is None:
            return None
        U, nb_u, fprs = packed
        screen = {
            "num_bits": nb_u,
            "fprs": fprs,
            "theta": {},
            "s_block": int(db.blocks[0].bits.shape[0]),
        }
        screen["u_ext"] = jax.device_put(jnp.asarray(U), self._dev)
        return screen

    def _theta_for(self, n_max: int):
        """[nb, n_max+1] int32 screen thresholds — the same float64
        junk-FP band as HostDB.screen_active (mean + 3 sigma of the
        union Bloom's per-read false-positive count)."""
        import jax
        import jax.numpy as jnp

        n_max = max(64, -(-n_max // 64) * 64)
        t = self.screen["theta"].get(n_max)
        if t is None:
            n = np.arange(n_max + 1, dtype=np.float64)
            f = self.screen["fprs"][:, None]
            th = np.maximum(
                float(self.opt.min_kmers),
                np.ceil(f * n + 3.0 * np.sqrt(n * f * (1.0 - f))),
            ).astype(np.int32)
            t = jax.device_put(jnp.asarray(th), self._dev)
            self.screen["theta"][n_max] = t
        return t

    def cmin_for(self, n_max: int):
        import jax
        import jax.numpy as jnp

        # bucket n_max to limit table variants
        n_max = max(64, -(-n_max // 64) * 64)
        t = self._cmin_cache.get(n_max)
        if t is None:
            tbl = build_cmin_table(
                n_max,
                self.opt.min_kmers,
                self.opt.min_query_cov,
                self.opt.max_fpr,
                self.db.query_fpr,
            )
            t = jax.device_put(jnp.asarray(tbl), self._dev)
            self._cmin_cache[n_max] = t
        return t

    def _hash(self, reads, k, lmax, num_sigs, max_hash, packed4, packed2,
              **kw):
        from .device_hash import make_hash_fn

        return make_hash_fn(
            k, lmax, num_sigs, max_hash, packed4=packed4, packed2=packed2,
            **kw,
        )(reads)

    def search_reads(self, reads_u8, lens, cand_budget,
                     dedup_values: bool = False,
                     packed4: bool = False,
                     packed2: bool = False):
        """Device hash (device_hash.make_hash_fn) + jitted count tail.

        reads_u8: [B, lmax] uint8 ASCII, or the packed wire formats of
        device_hash.unpack_reads (``packed4``: [B, lmax//2]; ``packed2``:
        a (codes, nmask) tuple); B a multiple of 256.  Returns
        (meta int32, aux) — see _make_count_tail.

        With ``dedup_values`` the hash also emits the 64-bit window
        values and reads over the dedup threshold are uniqued on device
        (_dedup_value_planes) instead of excluded — the paired
        streaming mode, whose joined mate rows routinely exceed the
        256-k-mer threshold (util-db-search.go:800-805,874-908).  For
        paired reads callers pass max(len1, len2) as ``lens`` (it only
        feeds the min-query-length filter)."""
        import jax.numpy as jnp

        opt = self.opt
        db = self.db
        assert self.mesh is None
        h = db.info.num_hashes
        k = sorted(db.info.ks)[-1]
        if packed2:
            lmax = reads_u8[0].shape[1] * 4  # (codes, nmask) tuple
        else:
            lmax = reads_u8.shape[1] * (2 if packed4 else 1)
        max_hash = (
            int(db.max_hash) if db.max_hash is not None else (1 << 64) - 1
        )
        pk = {"packed4": packed4, "packed2": packed2}
        if isinstance(lens, np.ndarray) or not hasattr(lens, "dtype"):
            # one H2D per batch; callers re-stepping the same batch
            # (overflow retries) may pass a device array instead
            lens = jnp.asarray(np.asarray(lens).astype(np.int32))
        if self.n_blocks > 1:
            if self.screen is None:
                raise RuntimeError(
                    "multi-block device search needs the two-pass screen "
                    "(index --block-screen with uniform block geometry)"
                )
            return self._search_reads_screened(
                reads_u8, lens, cand_budget, k, lmax, max_hash,
                dedup_values, pk,
            )
        if db.is_sketch:
            # sketch DBs: hash unscaled with value planes, select the
            # minimizer/syncmer windows on device, THEN scale-filter —
            # the host's order (sketches.py; the reference's in-engine
            # sketch path is util-db-search.go:1050-1106)
            from .sketch_device import make_sketch_transform

            outs = self._hash(
                reads_u8, k, lmax, self.total_rows, (1 << 64) - 1,
                num_hashes=h, emit_values=True, **pk,
            )
            loc_ts, vhi, vlo = outs[:h], outs[h + 1], outs[h + 2]
            s_planes = ()
            if db.info.syncmer:
                s = db.info.syncmer_s
                s_outs = self._hash(
                    reads_u8, s, lmax, 1, (1 << 64) - 1, emit_values=True,
                    **pk,
                )
                s_planes = (s_outs[2], s_outs[3])
                kind, param = "syncmer", s
            else:
                kind, param = "minimizer", db.info.minimizer_w
            transform = make_sketch_transform(
                kind, k, param, self.total_rows, max_hash
            )
            loc_ts, nk, vhi, vlo = transform(
                tuple(loc_ts), vhi, vlo, s_planes, lens
            )
            vplanes = (vhi, vlo) if dedup_values else ()
        else:
            outs = self._hash(
                reads_u8, k, lmax, self.total_rows, max_hash,
                num_hashes=h, emit_values=dedup_values, **pk,
            )
            loc_ts, nk = outs[:h], outs[h]
            vplanes = tuple(outs[h + 1 : h + 3]) if dedup_values else ()
        B = (reads_u8[0] if packed2 else reads_u8).shape[0]
        K = lmax - k + 1
        # chunk wide-T batches so the [K, B_c, W] gathered rows stay
        # around 150 MB per hash plane
        n_chunks = 1
        while (
            (B // n_chunks) * K * self.w * h > 150_000_000
            and B % (n_chunks * 2) == 0
        ):
            n_chunks *= 2
        tail = _make_count_tail(
            cand_budget, opt.min_query_len, opt.kmer_dedup_threshold,
            n_chunks, in_dedup=dedup_values,
        )
        cmin = self.cmin_for(max(K, 1))
        return tail(
            self.bits_ext, tuple(loc_ts), nk, lens,
            cmin, self._tmin, self.sizes_pos, vplanes,
        )

    def _search_reads_screened(
        self, reads_u8, lens, cand_budget, k, lmax, max_hash,
        dedup_values, pk,
    ):
        """Two-pass screened search of a multi-block DB (the GTDB-scale
        wide-T regime); see _make_screened_tail.  ``dedup_values``: the
        paired streaming mode — window values ride along and over-
        threshold joined rows are uniqued in-step before both passes."""
        opt = self.opt
        screen = self.screen
        s_block = screen["s_block"]
        outs = self._hash(
            reads_u8, k, lmax, s_block, max_hash,
            screen_sigs=screen["num_bits"], emit_values=dedup_values, **pk,
        )
        loc_t, locu_t, nk = outs[:3]
        vplanes = tuple(outs[3:5]) if dedup_values else ()
        B = (reads_u8[0] if pk["packed2"] else reads_u8).shape[0]
        K = lmax - k + 1
        pair_budget = min(B * self.n_blocks, max(256, 2 * cand_budget))
        # chunk the pairs so the [K, P_c, W] gathered rows stay around
        # 150 MB
        n_chunks = 1
        while (
            (pair_budget // n_chunks) * K * self.w > 150_000_000
            and n_chunks < pair_budget
        ):
            n_chunks *= 2
        pair_budget = -(-pair_budget // n_chunks) * n_chunks
        tail = _make_screened_tail(
            cand_budget, pair_budget, opt.min_query_len,
            opt.kmer_dedup_threshold, self.n_blocks,
            self.t_per_block, s_block, n_chunks,
            in_dedup=dedup_values,
        )
        cmin = self.cmin_for(max(K, 1))
        theta = self._theta_for(max(K, 1))
        return tail(
            self.bits_ext, screen["u_ext"], loc_t, locu_t, nk, lens,
            cmin, theta, self._tmin, self.sizes_pos, vplanes,
        )

    def search_reads_async(
        self,
        reads_u8: np.ndarray,
        lens: np.ndarray,
        cand_budget: int,
        paired_dedup: bool = False,
    ):
        """Dispatch the fused reads->matches step (hashing on device).
        ``paired_dedup``: in-step >threshold k-mer dedup for joined
        paired rows (see _make_read_search_step); pass max(len1, len2)
        as ``lens`` then."""
        import jax.numpy as jnp

        opt = self.opt
        db = self.db
        k = sorted(db.info.ks)[-1]
        step = _make_read_search_step(
            k,
            db.info.num_hashes,
            cand_budget,
            int(db.max_hash) if db.max_hash is not None else (1 << 64) - 1,
            opt.min_query_len,
            opt.kmer_dedup_threshold,
            self.mesh,
            paired_dedup,
        )
        n_win_max = reads_u8.shape[1] - k + 1
        cmin = self.cmin_for(max(n_win_max, 1))
        return step(
            self.bits_ext,
            jnp.asarray(reads_u8),
            jnp.asarray(lens.astype(np.int32)),
            cmin,
            self._tmin,
            self.sizes_pos,
        )

    def search_screened_sharded(
        self,
        loc: np.ndarray,
        loc_u: np.ndarray,
        nkmers: np.ndarray,
        lens: np.ndarray,
        cand_budget: int,
    ):
        """Dispatch the sharded two-pass screened step (multi-block mesh
        layout).  loc/loc_u: [B, K] int32 host-computed location planes,
        sentinels = s_block / union num_bits."""
        import jax.numpy as jnp

        assert self.mesh is not None and self.screen is not None
        step = _make_screened_step_sharded(
            cand_budget,
            max(256, 2 * cand_budget),
            self.opt.min_query_len,
            self.opt.kmer_dedup_threshold,
            self.n_blocks,
            self.t_per_block,
            self.total_rows,
            self.mesh,
        )
        K = loc.shape[1]
        cmin = self.cmin_for(max(int(K), 1))
        theta = self._theta_for(max(int(K), 1))
        return step(
            self.bits_ext, self.screen["u_ext"],
            jnp.asarray(loc.astype(np.int32)),
            jnp.asarray(loc_u.astype(np.int32)),
            jnp.asarray(np.minimum(nkmers, 10**9).astype(np.int32)),
            jnp.asarray(np.asarray(lens).astype(np.int32)),
            cmin, theta, self._tmin, self.sizes_pos,
        )

    def search_async(self, loc: np.ndarray, nkmers: np.ndarray, cand_budget: int):
        """Dispatch one batch; returns the device array (pull later).

        loc: [B, K, h] (single block) or [B, K, nb, h] int32.
        """
        import jax.numpy as jnp

        num_hashes = self.db.info.num_hashes
        if loc.ndim == 3:
            loc = loc.reshape(loc.shape[0], loc.shape[1], 1, num_hashes)
        step = _make_search_step(num_hashes, cand_budget, self.mesh)
        cmin = self.cmin_for(int(nkmers.max(initial=1)))
        return step(
            self.bits_ext,
            jnp.asarray(loc),
            jnp.asarray(np.minimum(nkmers, 10**9).astype(np.int32)),
            cmin,
            self._tmin,
            self.sizes_pos,
        )
