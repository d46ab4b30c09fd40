"""``merge`` — k-way merge of search results from multiple databases.

Behavioral equivalent of /root/reference/kmcp/cmd/merge.go: results of the
same query (matched by the trailing ``queryIdx`` column) are merged across
files, re-sorted by score descending (qcov/tcov/jacc column), the ``hits``
column is rewritten, query-ID consistency and per-file query counts are
verified, and the '#' stat lines are regenerated.

This is the offline "reduce" of the reference's cluster sharding story;
the multi-device path does the same reduction with collectives
(kmcp_tpu/parallel/sharding.py), but the file-level merge remains for
pipeline compatibility.
"""

from __future__ import annotations

import heapq
import sys

import numpy as np

from ..seqio.fastx import xopen

HEADER = (
    "#query\tqLen\tqKmers\tFPR\thits\ttarget\tchunkIdx\tchunks\ttLen\t"
    "kSize\tmKmers\tqCov\ttCov\tjacc\tqueryIdx\n"
)

SCORE_FIELD = {"qcov": 11, "tcov": 12, "jacc": 13}


def _iter_results(path: str, score_field: int):
    """Yield (query_idx, query_id, [(score, fields)...]) groups plus a final
    ('stats', dict)."""
    stats: dict[str, str] = {}
    cur_idx = None
    cur_id = None
    rows: list[tuple[float, list[str]]] = []
    with xopen(path, "rt") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            if line[0] == "#":
                if ":" in line and line.startswith("# "):
                    key, _, val = line[2:].partition(": ")
                    stats[key] = val
                continue
            fields = line.split("\t")
            qidx = int(fields[-1])
            if cur_idx is not None and qidx != cur_idx:
                yield cur_idx, cur_id, rows
                rows = []
            cur_idx = qidx
            cur_id = fields[0]
            rows.append((float(fields[score_field]), fields))
    if cur_idx is not None:
        yield cur_idx, cur_id, rows
    yield None, None, stats


def _chunked_shard(path: str, score_field: int, chunk_bytes: int):
    """Generator streaming one shard in bounded blocks: yields
    (buf, scan_dict, eof) per block, each block cut at a line boundary
    and scanned once in C++ (inputs are queryIdx-sorted, as the search
    writer emits)."""
    from ..kmer import native

    with xopen(path, "rb") as f:
        carry = b""
        while True:
            data = f.read(chunk_bytes)
            block = carry + data
            if data:
                nl = block.rfind(b"\n")
                if nl < 0:
                    carry = block
                    continue
                carry = block[nl + 1 :]
                block = block[: nl + 1]
                eof = False
            else:
                carry = b""
                eof = True
            try:
                scan = native.merge_scan(block, score_field)
            except ValueError:
                raise SystemExit("invalid kmcp search result format")
            if not eof and len(scan["qidx"]):
                # the final queryIdx group may continue in the next
                # block: carry its bytes (and anything after) forward so
                # every yielded block holds only complete groups
                q = scan["qidx"]
                i0 = int(np.searchsorted(q, q[-1]))
                if i0 == 0:
                    # whole block is one giant group: force more input
                    carry = block + carry
                    continue
                cut = int(scan["row_off"][i0])
                carry = block[cut:] + carry
                block = block[:cut]
                scan = native.merge_scan(block, score_field)
            yield block, scan, eof
            if eof:
                return


class _ShardCursor:
    """Cursor over a shard's blocks with a queryIdx watermark."""

    def __init__(self, path: str, score_field: int, chunk_bytes: int):
        self._gen = _chunked_shard(path, score_field, chunk_bytes)
        self.buf = b""
        self.scan = {"qidx": np.empty(0, np.int64)}
        self.pos = 0
        self.eof = False
        self.total_queries = 0
        self._advance()

    def _advance(self):
        try:
            self.buf, self.scan, self.eof = next(self._gen)
            self.total_queries += self.scan["total_queries"]
            self.pos = 0
        except StopIteration:
            self.eof = True
            self.buf = b""
            self.scan = {"qidx": np.empty(0, np.int64)}
            self.pos = 0

    def exhausted(self) -> bool:
        return self.eof and self.pos >= len(self.scan["qidx"])

    def watermark(self) -> int | None:
        """Highest queryIdx in the current block (blocks only ever hold
        complete groups — the generator carries a trailing partial group
        into the next block)."""
        while self.pos >= len(self.scan["qidx"]):
            if self.eof:
                return None
            self._advance()
        return int(self.scan["qidx"][-1])

    def take(self, bound: int):
        """(buf, array-slices) for unconsumed rows with qidx <= bound."""
        q = self.scan["qidx"]
        end = int(np.searchsorted(q, bound, side="right"))
        lo = self.pos
        if end <= lo:
            return None
        self.pos = end
        d = self.scan
        return self.buf, {
            k: d[k][lo:end]
            for k in ("row_off", "row_len", "hits_off", "hits_len",
                      "qid_len", "qidx", "score")
        }


def _run_merge_native(
    files: list[str], out, score_field: int, chunk_bytes: int = 256 << 20,
) -> None:
    """Columnar merge in bounded memory: per round, every shard
    contributes its unconsumed rows up to the common queryIdx watermark;
    the round orders with one lexsort (queryIdx asc, score desc, stream
    order for ties — the heap merge's exact ordering for queryIdx-sorted
    inputs) and emits with the rewritten hits column spliced in C++.
    Small merges fit one round; huge ones hold ~chunk_bytes per shard."""
    from ..kmer import native

    shards = [_ShardCursor(p, score_field, chunk_bytes) for p in files]
    matched = 0
    while True:
        marks = [
            s.watermark() for s in shards if not s.exhausted()
        ]
        marks = [m for m in marks if m is not None]
        if not marks:
            break
        bound = min(marks)
        parts: list[bytes] = []
        chunks = []
        off = 0
        for s in shards:
            if s.exhausted():
                continue
            t = s.take(bound)
            if t is None:
                continue
            b, d = t
            d = dict(d)
            d["row_off"] = d["row_off"] + off
            d["hits_off"] = d["hits_off"] + off
            off += len(b)
            parts.append(b)
            chunks.append(d)
        if not chunks:
            continue  # watermark advanced without new rows
        buf = b"".join(parts)
        qidx = np.concatenate([d["qidx"] for d in chunks])
        score = np.concatenate([d["score"] for d in chunks])
        n = len(qidx)
        order = np.lexsort((np.arange(n), -score, qidx))
        qs = qidx[order]
        new_group = np.concatenate(([True], qs[1:] != qs[:-1]))
        group_id = np.cumsum(new_group) - 1
        counts = np.bincount(group_id).astype(np.int32)
        hits = counts[group_id]
        matched += len(counts)
        data = native.merge_emit(
            buf, order,
            np.concatenate([d["row_off"] for d in chunks]),
            np.concatenate([d["row_len"] for d in chunks]),
            np.concatenate([d["hits_off"] for d in chunks]),
            np.concatenate([d["hits_len"] for d in chunks]),
            np.concatenate([d["qid_len"] for d in chunks]),
            qidx, hits,
        )
        out.write(data.decode("utf-8", "surrogateescape"))

    totals = [s.total_queries for s in shards]
    nonzero = [t for t in totals if t != 0]
    total = nonzero[0] if nonzero else 0
    for t in nonzero[1:]:
        if t != total:
            raise SystemExit(
                f"different numbers of queries across input files "
                f"({total} vs {t}) — please make sure they come from "
                "the same input query"
            )
    out.write(f"# input queries: {total}\n")
    out.write(f"# matched queries: {matched}\n")
    pct = matched / total * 100 if total else 0.0
    out.write(f"# matched percentage: {pct:.4f}%\n")


def run_merge(
    files: list[str],
    out_file: str = "-",
    keep_top_scores: int = 0,
    sort_by: str = "qcov",
    do_not_sort: bool = False,
    no_header_row: bool = False,
) -> None:
    score_field = SCORE_FIELD[sort_by]
    out = sys.stdout if out_file == "-" else xopen(out_file, "wt")
    try:
        if not no_header_row:
            out.write(HEADER)

        if len(files) == 1:
            print("[merge] only one file given, copying", file=sys.stderr)
            with xopen(files[0], "rt") as f:
                for line in f:
                    if line.startswith("#query") or line.startswith("# "):
                        continue
                    out.write(line)
            return

        from ..kmer import native

        if native.get_lib() is not None:
            _run_merge_native(files, out, score_field)
            return

        iters = [_iter_results(f, score_field) for f in files]
        heap = []
        stats_list: list[dict] = [None] * len(files)

        def push(i):
            try:
                qidx, qid, rows = next(iters[i])
            except StopIteration:
                return
            if qidx is None:
                stats_list[i] = rows  # the stats dict
                return
            heapq.heappush(heap, (qidx, i, qid, rows))

        for i in range(len(files)):
            push(i)

        matched = 0
        while heap:
            qidx, i, qid, rows = heapq.heappop(heap)
            group = list(rows)
            gid = qid
            push(i)
            while heap and heap[0][0] == qidx:
                _, j, qid2, rows2 = heapq.heappop(heap)
                if qid2 != gid:
                    raise SystemExit(
                        f"[queryIdx: {qidx}] unmatched sequence Ids: "
                        f"'{qid2}' != '{gid}' — results must come from the "
                        "same query file"
                    )
                group.extend(rows2)
                push(j)
            matched += 1
            group.sort(key=lambda r: -r[0])
            hits = str(len(group))
            for _score, fields in group:
                fields[4] = hits
                out.write("\t".join(fields))
                out.write("\n")

        # verify + regenerate stats (merge.go:290-330,374-376)
        totals = [
            int(s.get("input queries", "0")) if s else 0 for s in stats_list
        ]
        nonzero = [t for t in totals if t != 0]
        total = nonzero[0] if nonzero else 0
        for i, t in enumerate(nonzero[1:], 1):
            if t != total:
                raise SystemExit(
                    f"different numbers of queries across input files "
                    f"({total} vs {t}) — please make sure they come from "
                    "the same input query"
                )
        out.write(f"# input queries: {total}\n")
        out.write(f"# matched queries: {matched}\n")
        pct = matched / total * 100 if total else 0.0
        out.write(f"# matched percentage: {pct:.4f}%\n")
    finally:
        if out is not sys.stdout:
            out.close()
