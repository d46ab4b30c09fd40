"""CLI-level byte-parity + e2e rate of the dense path: stream the
131k-target single-block wide DB (db-wide) through the FULL jax
streaming pipeline (device hash -> chunked dense count tail ->
compaction -> TSV) vs the host backend; every row of the TSV must
match bit-for-bit."""
import io
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main():
    from kmcp_tpu.search.engine import SearchEngine, SearchOptions
    from kmcp_tpu.search.stream import StreamSearcher
    from tools.bench_large_t import make_reads

    db = ".bench/large_t-131072/db-wide"
    reads = make_reads(".bench/large_t-131072/genomes", 40000, 10.0)
    outs = {}
    for backend in ("host", "jax"):
        opt = SearchOptions(backend=backend, batch_size=8192)
        eng = SearchEngine([db], opt)
        assert StreamSearcher.usable(eng), backend
        st = StreamSearcher(eng)
        buf = io.StringIO()
        st.run(iter(reads[:8192]), io.StringIO())  # warm/compile
        t0 = time.time()
        total, matched = st.run(iter(reads), buf)
        dt = time.time() - t0
        outs[backend] = buf.getvalue()
        print(f"{backend}: {total} reads, {matched} matched, "
              f"{total / dt:.0f} reads/s e2e", flush=True)
    same = outs["host"] == outs["jax"]
    print("byte-identical:", same)
    assert same


if __name__ == "__main__":
    main()
