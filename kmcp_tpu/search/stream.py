"""Streaming fast-path search: C++ hashing -> async device batches ->
array-based match extraction and TSV writing.

Used when one DB is searched with single-end or paired reads — the
metagenomic profiling workload (StreamSearcher.usable lists the
conditions).  The pipeline keeps several batches in flight so host
packing, H2D, device compute and D2H overlap; reads needing the general
machinery (k-mer counts above the dedup threshold, multi-k retries of
unmatched reads on multi-k DBs) are routed through the object-based
engine and merged back in order.

Output rows are byte-identical to the general path: float columns are
formatted from exact integer pairs via memoized tables.
"""

from __future__ import annotations

import os
from collections import deque

import numpy as np

from ..kmer import native
from .device import DeviceDB
from .engine import QueryResult, SearchEngine
from .tsv import write_results


_HOST_POOL = None


def _host_pool():
    """Single worker thread for the host backend's batch compute, so
    the next batch's hash+count (GIL-released C++) overlaps the current
    batch's row formatting."""
    global _HOST_POOL
    if _HOST_POOL is None:
        import concurrent.futures as cf

        _HOST_POOL = cf.ThreadPoolExecutor(max_workers=1)
    return _HOST_POOL


def _materialize(fut):
    """np.asarray for device arrays; .result() for host futures."""
    if hasattr(fut, "result") and not hasattr(fut, "__array__"):
        return np.asarray(fut.result())
    return np.asarray(fut)


def _copy_async(fut):
    """Start the device->host copy of a dispatched (meta, aux) result
    immediately, so the transfer of batch N overlaps batches N+1..'s
    compute and host prep instead of serializing at drain time."""
    for a in fut:
        a.copy_to_host_async()
    return fut


def _unpack_result(fut, budget, nb, T=None):
    """Normalize a search-step result to (n_cand, qi, t, cnt, nk).

    Three layouts:
    - tuple (meta int32 [1 + 2*budget], aux): SPLIT candidate ids —
      [n, read_idx..., target_idx...] — used by the screened wide-T
      tail so B*T may exceed int32 (device.py::_make_screened_tail);
    - tuple (meta int32 [1 + budget], aux): flat ids ``qi*T + t``
      (device.py::_make_count_tail); aux uint16 [budget + nb] =
      counts + nkmers in both tuple layouts;
    - plain array: legacy concatenated int32 [n, idx[budget],
      cnt[budget] (, nkmers[nb])].
    Flat layouts need ``T`` to split ids.  On budget overflow returns
    (n_cand, None, ...) — the caller retries with a larger budget."""
    if isinstance(fut, tuple):
        meta = np.asarray(fut[0])
        n = int(meta[0])
        if n > budget:
            return n, None, None, None, None
        aux = np.asarray(fut[1])
        cnt = aux[:n].astype(np.int64)
        nk = aux[budget : budget + nb].astype(np.int64)
        if meta.shape[0] >= 1 + 2 * budget:
            return n, meta[1 : 1 + n], meta[1 + budget : 1 + budget + n], cnt, nk
        idx = meta[1 : 1 + n]
        return n, idx // T, idx % T, cnt, nk
    arr = _materialize(fut)
    n = int(arr[0])
    if n > budget:
        return n, None, None, None, None
    nk = (
        arr[1 + 2 * budget : 1 + 2 * budget + nb].astype(np.int64)
        if arr.shape[0] > 1 + 2 * budget
        else None
    )
    idx = arr[1 : 1 + n]
    return n, idx // T, idx % T, arr[1 + budget : 1 + budget + n], nk


def _pack_reads_matrix(seqs, lens, lmax):
    """Zero-padded row-major [B, lmax] uint8 read matrix (C++ fast path;
    NumPy scatter fallback)."""
    mat = native.pack_rows(seqs, lens, lmax)
    if mat is not None:
        return mat
    B = len(seqs)
    mat = np.zeros((B, lmax), dtype=np.uint8)
    concat = np.frombuffer(b"".join(seqs), dtype=np.uint8)
    cols = np.arange(lmax)[None, :]
    mat[cols < lens[:, None]] = concat
    return mat


def _fmt_ratio_memo():
    memo: dict[tuple[int, int], str] = {}

    def fmt(a: int, b: int) -> str:
        key = (a, b)
        s = memo.get(key)
        if s is None:
            s = f"{a / b:.4f}"
            memo[key] = s
        return s

    return fmt


class StreamSearcher:
    def __init__(self, engine: SearchEngine):
        self.engine = engine
        self.opt = engine.opt
        self.db = engine.dbs[0]
        if engine.opt.backend == "host":
            from .device import HostDB

            self.dev = HostDB(self.db, self.opt)
        else:
            self.dev = DeviceDB(self.db, self.opt)
        self.k = self.db.ks_desc[0]
        self.multi_k = len(self.db.ks_desc) > 1
        self._fpr_tabs: dict[int, tuple] = {}
        self._tmeta_tab = None
        self._tname_tab = None

    def _target_tabs(self):
        if self._tmeta_tab is None:
            dev = self.dev
            name_map = self.opt.name_map
            names = [
                (name_map.get(n, n) if name_map else n).encode()
                for n in dev.names
            ]
            self._tname_tab = native.make_strtab(names)
            metas = [
                (
                    f"\t{int(ix) & 0xFFFF}\t{int(ix) >> 16}\t{int(g)}\t{self.k}\t"
                ).encode()
                for ix, g in zip(dev.indices, dev.gsizes)
            ]
            self._tmeta_tab = native.make_strtab(metas)
        return self._tname_tab, self._tmeta_tab

    def _fpr_tab(self, nmax: int, pairs: np.ndarray):
        """Flat (nmax+1)^2 string table of %.4e query-FPR values, filled
        lazily for the (n, c) pairs observed in the results (eagerly
        enumerating every pair up to cmin costs O(nmax^2 * n) Theorem-2
        evaluations — seconds for paired-read n ranges)."""
        ent = self._fpr_tabs.get(nmax)
        if ent is None:
            ent = {
                "strings": [b""] * ((nmax + 1) * (nmax + 1)),
                "have": set(),
                "tab": None,
            }
            self._fpr_tabs[nmax] = ent
        qf = self.db.query_fpr
        have = ent["have"]
        strings = ent["strings"]
        new = False
        for p in np.unique(pairs).tolist():
            if p in have:
                continue
            have.add(p)
            n, c = divmod(p, nmax + 1)
            strings[p] = f"{qf(n, c):.4e}".encode()
            new = True
        if new or ent["tab"] is None:
            ent["tab"] = native.make_strtab(strings)
        return ent["tab"]

    @classmethod
    def usable(cls, engine: SearchEngine, paired: bool = False) -> bool:
        if len(engine.dbs) != 1:
            return False
        db = engine.dbs[0]
        backend = engine.opt.backend
        if backend not in ("jax", "host"):
            return False
        if db.is_sketch and backend == "jax":
            # minimizer and closed-syncmer queries stream on the device
            # for SINGLE-BLOCK DBs (window selection over the hash's
            # value planes, search/sketch_device.py).  Paired sketch
            # mates hash as separate rows whose location lists merge per
            # pair (selection windows must not cross the mate junction —
            # engine.py:408-414 sketches each mate alone), which the
            # joined-row device path cannot express; the host backend
            # streams both.
            if paired or len(db.blocks) != 1:
                return False
            if db.info.syncmer and db.info.syncmer_s >= max(db.info.ks):
                return False
        if backend == "jax" and len(db.blocks) == 1:
            # the dense tail's int32 flat candidate ids need
            # B*T <= 2^31 with B >= 256 (the screened multi-block tail
            # emits split ids and carries no such limit)
            if db.blocks[0].bits.shape[1] * 32 > (2**31) // 256:
                return False
        if engine.opt.low_mem:
            # row-seek mode keeps the index on disk; the streaming
            # backends materialize the stacked matrix
            return False
        if engine.opt.sort_by != "qcov" or engine.opt.do_not_sort:
            return False
        if len(db.blocks) != 1 and backend == "jax":
            # multi-block DBs stream on the device through the two-pass
            # screened tail (device.py::_make_screened_tail): union
            # screens present with one shared block geometry
            from .device import two_pass_ready

            if not two_pass_ready(db):
                return False
            if os.environ.get("KMCP_TPU_NO_SCREEN"):
                return False
        if paired and engine.opt.try_se:
            # paired mates join into one hash row whose >256-k-mer sets
            # dedup in-kernel (host C++) or in-step (device value sort,
            # device.py::_dedup_value_planes); --try-se needs the object
            # engine's retry plan
            return False
        return native.get_lib() is not None

    # ------------------------------------------------------------------

    def run(
        self, queries, out, start_idx: int = 0, paired: bool = False,
        progress=None,
    ) -> tuple[int, int]:
        """queries: iterator of (id, seq, seq2).  Whole-file queries fall
        back upstream.  With ``paired``, mates hash as
        one joined row ``seq1 + N + seq2`` — the 'N' resets the rolling
        window so the k-mer multiset equals the reference's concatenation
        of both mates' k-mers (util-db-search.go:800-805), and in-kernel
        dedup reproduces its >256-k-mer unique step."""
        opt = self.opt
        db = self.db
        dev = self.dev
        batch_size = max(opt.batch_size, 16384)
        if opt.backend != "host":
            # the DENSE device tail encodes candidates as int32 flat
            # b*T + t: cap the batch so B*T <= 2^31.  The screened
            # multi-block tail emits split (read, target) ids and needs
            # no cap.  Round to 256 reads either way.
            if not (dev.n_blocks > 1 and getattr(dev, "screen", None)):
                T_all = dev.t_per_block * dev.n_blocks
                batch_size = min(batch_size, (2**31) // T_all)
            batch_size = max(batch_size // 256 * 256, 256)
        pending: deque = deque()
        total = matched = 0
        fmtq = _fmt_ratio_memo()
        fmtt = _fmt_ratio_memo()
        fpr_memo: dict[tuple[int, int], str] = {}
        name_map = opt.name_map

        sizes = dev.sizes
        gsizes = dev.gsizes
        indices = dev.indices
        names = list(dev.names)
        if name_map:
            names = [name_map.get(n, n) for n in names]
        chunk_idx_s = [str(int(ix) & 0xFFFF) for ix in indices]
        chunks_s = [str(int(ix) >> 16) for ix in indices]
        gsize_s = [str(int(g)) for g in gsizes]
        k_s = str(self.k)

        host_backend = opt.backend == "host"

        def flush_batch(batch):
            real_b = len(batch)
            ids = [q[0] for q in batch]
            if paired:
                seqs = [
                    q[1] + b"N" + q[2] if q[2] else q[1] for q in batch
                ]
                qlen_r = [
                    len(q[1]) + (len(q[2]) if q[2] else 0) for q in batch
                ]
                eff_r = [
                    max(len(q[1]), len(q[2]) if q[2] else 0) for q in batch
                ]
            else:
                seqs = [q[1] for q in batch]
            # pad to the fixed batch size so every device call shares one
            # compiled shape (empty reads gather only the sentinel row)
            if real_b < batch_size:
                seqs = seqs + [b""] * (batch_size - real_b)
            lens = np.array([len(s) for s in seqs], dtype=np.int64)
            if paired:
                qlen = np.zeros(len(seqs), dtype=np.int64)
                qlen[:real_b] = qlen_r
                eff = np.zeros(len(seqs), dtype=np.int64)
                eff[:real_b] = eff_r
            else:
                qlen = eff = lens
            # budget: overflow retries with 4x (recompile cached per
            # budget size), and a retry costs a FULL re-dispatch, so
            # budgets are sized for the real hit distributions:
            # single-end demo-shape reads average ~1.65 matches/read
            # (overlap chunks + Bloom FPs at fpr 0.3) and paired rows
            # carry two mates' matches — both get 2 slots/row on the
            # device; the host backend's generous 3 costs nothing.
            budget = 3 * batch_size if host_backend else 2 * batch_size
            state = {
                "real_b": real_b,
                "ids": ids,
                "queries": batch,
                "seqs": seqs,
                "lens": lens,
                "qlen": qlen,
                "eff": eff,
                "budget": budget,
            }
            lmax = max(-(-(int(lens.max())) // 32) * 32, self.k + 31)
            if host_backend:
                state["reads_u8"] = (len(seqs), lmax)
                state["seqs_pad"] = seqs
                if paired and db.is_sketch:
                    # sketch selection must not cross the mate junction
                    # (engine.py:408-414 sketches each mate alone): mates
                    # hash as separate interleaved rows whose location
                    # lists merge per pair in HostDB.  In-kernel dedup is
                    # per-row, so combined sets over the threshold fall
                    # back to the object engine (dedup_threshold=0).
                    mates = []
                    for q in batch:
                        mates.append(q[1])
                        mates.append(q[2] or b"")
                    mates.extend([b""] * (2 * (batch_size - real_b)))
                    state["host_extra"] = {
                        "dedup_threshold": 0,
                        "eff_lens": eff,
                        "mates": mates,
                    }
                else:
                    # in-kernel dedup of >threshold k-mer sets: no
                    # slow-path fallback for long or paired reads
                    state["host_extra"] = {
                        "dedup_threshold": opt.kmer_dedup_threshold,
                        "eff_lens": eff,
                    }
                # run on a worker thread (the C++ releases the GIL) so
                # batch N+1's hash+count overlaps batch N's row writing
                state["fut"] = _host_pool().submit(
                    dev.search_reads_async,
                    state["reads_u8"], lens, budget, seqs=seqs,
                    **state["host_extra"],
                )
            else:
                # KMCP_TPU_PACK picks the read wire format: 2 (default;
                # codes + invalid bitmap, 0.375x the ASCII bytes), 4 (two
                # nibbles per byte) or 0 (raw ASCII); KMCP_TPU_PACK4=0
                # also selects ASCII
                pm = os.environ.get("KMCP_TPU_PACK")
                if pm is None:
                    pm = (
                        "2"
                        if os.environ.get("KMCP_TPU_PACK4", "1") == "1"
                        else "0"
                    )
                if pm == "2":
                    mat = native.pack_rows_2bit(seqs, lens, lmax)
                elif pm == "4":
                    mat = native.pack_rows_4bit(seqs, lens, lmax)
                else:
                    mat = _pack_reads_matrix(seqs, lens, lmax)
                state["reads_bl"] = mat
                # paired: min-len filters on max(len1, len2); joined
                # rows dedup in-step past the >256-k-mer threshold
                state["dev_lens"] = eff if paired else lens
                state["dev_kwargs"] = {
                    "dedup_values": paired,
                    "packed4": pm == "4", "packed2": pm == "2",
                }
                state["fut"] = _copy_async(
                    dev.search_reads(
                        mat, state["dev_lens"], budget,
                        **state["dev_kwargs"],
                    )
                )
            return state

        def drain(state, idx0):
            nonlocal total, matched
            budget = state["budget"]
            nb = len(state["lens"])
            T = dev.t_per_block * dev.n_blocks
            n_cand, qi, t, cnt, nk = _unpack_result(
                state["fut"], budget, nb, T
            )
            while qi is None:  # budget overflow: retry with 4x
                budget *= 4
                if host_backend:
                    fut = dev.search_reads_async(
                        state["reads_u8"], state["lens"], budget,
                        seqs=state["seqs_pad"], **state["host_extra"],
                    )
                else:
                    fut = _copy_async(
                        dev.search_reads(
                            state["reads_bl"], state["dev_lens"], budget,
                            **state["dev_kwargs"],
                        )
                    )
                n_cand, qi, t, cnt, nk = _unpack_result(
                    fut, budget, nb, T
                )

            B = state["real_b"]
            # per-read k-mer counts ride along with the results
            state["counts"] = nk
            state["too_short"] = state["eff"] < opt.min_query_len
            if state.get("host_extra", {}).get("dedup_threshold") or (
                state.get("dev_kwargs", {}).get("dedup_values")
            ):
                # deduplicated in-kernel (host C++) or in-step (device
                # value sort); counts are unique — no slow-path fallback
                state["over_dedup"] = np.zeros(
                    len(state["counts"]), dtype=bool
                )
            else:
                state["over_dedup"] = (
                    state["counts"] > opt.kmer_dedup_threshold
                )
            state["counts"] = state["counts"][:B]
            state["lens"] = state["lens"][:B]
            state["qlen"] = state["qlen"][:B]
            state["too_short"] = state["too_short"][:B]
            state["over_dedup"] = state["over_dedup"][:B]
            counts_host = state["counts"]

            # rows needing the general engine
            slow_rows = np.nonzero(state["over_dedup"])[0]
            # multi-k retry: unmatched reads when the DB has smaller ks
            if self.multi_k:
                has_match = np.zeros(B, dtype=bool)
                has_match[qi] = True
                retry = ~has_match & ~state["too_short"] & (
                    counts_host >= opt.min_kmers
                )
                slow_rows = np.union1d(slow_rows, np.nonzero(retry)[0])
            slow_set = set(slow_rows.tolist())
            slow_results: dict[int, QueryResult] = {}
            if slow_set:
                subset = [state["queries"][r] for r in sorted(slow_set)]
                res = self.engine.search_batch(subset, 0)
                for r, qr in zip(sorted(slow_set), res):
                    slow_results[r] = qr
                # drop device candidates of slow rows
                keep = ~np.isin(qi, slow_rows)
                qi, t, cnt = qi[keep], t[keep], cnt[keep]

            # order: qi asc, qcov desc (== cnt desc within read), tcov desc
            # (== size asc for equal cnt), then target for determinism
            order = np.lexsort((t, sizes[t], -cnt, qi))
            qi, t, cnt = qi[order], t[order], cnt[order]
            hits = np.bincount(qi, minlength=B).astype(np.int32)

            total += B
            matched += int((hits > 0).sum()) + sum(
                1 for r in slow_set if slow_results[r].matches
            )

            top_n = opt.keep_top_scores
            use_native = top_n <= 0 and native.get_lib() is not None
            if use_native:
                self._write_native(
                    out, state, qi, t, cnt, hits, slow_set, slow_results,
                    idx0,
                )
            else:
                self._write_python(
                    out, state, qi, t, cnt, hits, slow_set, slow_results,
                    idx0, fmtq, fmtt, fpr_memo, names, chunk_idx_s,
                    chunks_s, gsize_s, k_s,
                )
            if progress is not None:
                progress(total)


        from itertools import islice

        idx0 = start_idx
        pending_meta: deque = deque()
        # in-flight depth: host work is CPU-bound (1 worker thread, so 2
        # suffices); device batches keep more in flight so H2D, compute
        # and D2H of neighbouring batches overlap
        depth = 2 if host_backend else 4
        it = iter(queries)
        while True:
            # islice instead of a per-read append/len loop
            batch = list(islice(it, batch_size))
            if not batch:
                break
            pending.append((flush_batch(batch), idx0))
            idx0 += len(batch)
            if len(pending) >= depth:
                st, i0 = pending.popleft()
                drain(st, i0)
        while pending:
            st, i0 = pending.popleft()
            drain(st, i0)
        return total, matched

    # ---------------------------------------------------------- writers

    def _write_native(
        self, out, state, qi, t, cnt, hits, slow_set, slow_results, idx0
    ):
        """One kt_write_rows call per run of fast reads; slow reads'
        pre-formatted rows interleave between runs."""
        B = len(state["ids"])
        flags = np.where(state["too_short"], 2, 0).astype(np.uint8)
        for r in slow_set:
            flags[r] = 1
        qlen = state["qlen"]
        nkmers = state["counts"]
        ku = self.opt.keep_unmatched
        tname_tab, tmeta_tab = self._target_tabs()
        nmax = max(64, -(-int(nkmers.max(initial=1)) // 64) * 64)
        pairs = nkmers[qi].astype(np.int64) * (nmax + 1) + cnt.astype(
            np.int64
        )
        fpr_tab = self._fpr_tab(nmax, pairs)
        qid_tab = native.make_strtab([s.encode() for s in state["ids"]])

        if not slow_set:
            data = native.write_rows(
                qi, t, cnt, qlen, nkmers, hits, flags,
                qid_tab, tname_tab, tmeta_tab,
                self.dev.sizes, fpr_tab, nmax, idx0,
                keep_unmatched=ku, k=self.k,
            )
            out.write(data.decode("utf-8", "surrogateescape"))
            return

        # segment at slow reads
        row_starts = np.zeros(B + 1, dtype=np.int64)
        np.cumsum(hits, out=row_starts[1:])
        bounds = sorted(slow_set)
        prev = 0
        for sr in bounds + [B]:
            if sr > prev:
                r0, r1 = prev, sr
                rows_lo, rows_hi = row_starts[r0], row_starts[r1]
                sub_qid = native.make_strtab(
                    [s.encode() for s in state["ids"][r0:r1]]
                )
                data = native.write_rows(
                    qi[rows_lo:rows_hi] - r0, t[rows_lo:rows_hi],
                    cnt[rows_lo:rows_hi],
                    qlen[r0:r1], nkmers[r0:r1], hits[r0:r1],
                    flags[r0:r1] & np.uint8(2),
                    sub_qid, self._tname_tab, self._tmeta_tab,
                    self.dev.sizes, fpr_tab, nmax, idx0 + r0,
                    keep_unmatched=ku, k=self.k,
                )
                out.write(data.decode("utf-8", "surrogateescape"))
            if sr < B:
                qr = slow_results[sr]
                qr.query_idx = idx0 + sr
                write_results(out, [qr], self.opt.keep_unmatched)
            prev = sr + 1

    def _write_python(
        self, out, state, qi, t, cnt, hits, slow_set, slow_results, idx0,
        fmtq, fmtt, fpr_memo, names, chunk_idx_s, chunks_s, gsize_s, k_s,
    ):
        opt = self.opt
        db = self.db
        sizes = self.dev.sizes
        counts_host = state["counts"]
        B = len(state["ids"])
        w = out.write
        pos = 0
        top_n = opt.keep_top_scores
        for r in range(B):
            qid = state["ids"][r]
            if r in slow_set:
                qr = slow_results[r]
                qr.query_idx = idx0 + r
                write_results(out, [qr], opt.keep_unmatched)
                continue
            h = int(hits[r])
            if h == 0:
                if opt.keep_unmatched:
                    nk = 0 if state["too_short"][r] else int(counts_host[r])
                    w(
                        f"{qid}\t{state['qlen'][r]}\t{nk}\t0\t0\t\t-1\t0"
                        f"\t0\t{k_s}\t0\t0\t0\t0\t{idx0 + r}\n"
                    )
                continue
            n = int(counts_host[r])
            lo, hi_ = pos, pos + h
            pos = hi_
            rows = range(lo, hi_)
            if top_n > 0:
                rows = self._apply_top_n(qi, cnt, lo, hi_, n, top_n)
            h_out = str(len(rows))
            prefix = f"{qid}\t{state['qlen'][r]}\t{n}\t"
            suffix = f"\t{idx0 + r}\n"
            for i in rows:
                ti = int(t[i])
                c = int(cnt[i])
                fk = (n, c)
                fs = fpr_memo.get(fk)
                if fs is None:
                    fs = f"{db.query_fpr(n, c):.4e}"
                    fpr_memo[fk] = fs
                size = int(sizes[ti])
                w(
                    prefix + fs + "\t" + h_out + "\t" + names[ti] + "\t"
                    + chunk_idx_s[ti] + "\t" + chunks_s[ti] + "\t"
                    + gsize_s[ti] + "\t" + k_s + "\t" + str(c) + "\t"
                    + fmtq(c, n) + "\t" + fmtt(c, size) + "\t"
                    + f"{c / (n + size - c):.4f}" + suffix
                )

    @staticmethod
    def _apply_top_n(qi, cnt, lo, hi, n, top_n):
        """keep-top-scores truncation on the sorted slice — the reference's
        exact loop (util-db-search.go:284-311)."""
        count = 0
        p = 1024.0
        i = lo
        for i in range(lo, hi):
            s = int(cnt[i]) / n
            if s < p:
                count += 1
                if count > top_n:
                    break
                p = s
        return range(lo, i + 1)
