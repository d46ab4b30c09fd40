"""Capture a jax.profiler device trace of the screened step on the
131k-target DB (.bench/large_t-131072, tools/bench_large_t.py) and print
the per-op device time breakdown.  The trace lands under
.bench/trace/ of the checkout.

    PROBE_B=16384 python tools/trace_screened_step.py
"""

import collections
import glob
import gzip
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax

    from kmcp_tpu.kmer import native
    from kmcp_tpu.search.device import DeviceDB, enable_compilation_cache
    from kmcp_tpu.search.engine import SearchEngine, SearchOptions
    from tools.bench_large_t import make_reads

    enable_compilation_cache()
    B = int(os.environ.get("PROBE_B", "4096"))
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".bench", "large_t-131072")
    eng = SearchEngine(
        [os.path.join(root, "db-uniform")],
        SearchOptions(backend="jax", batch_size=B),
    )
    dev = DeviceDB(eng.dbs[0], SearchOptions(backend="jax", batch_size=B))
    reads = make_reads(os.path.join(root, "genomes"), B, 10.0)
    seqs = [r[1] for r in reads]
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    lmax = max(-(-int(lens.max()) // 32) * 32, 52)
    codes, nmask = native.pack_rows_2bit(seqs, lens, lmax)
    mat = (jax.device_put(codes), jax.device_put(nmask))
    lent = jax.device_put(lens.astype(np.int32))
    m, a = dev.search_reads(mat, lent, 2 * B, packed2=True)
    jax.block_until_ready((m, a))
    trace_dir = os.path.join(root, os.pardir, "trace")
    with jax.profiler.trace(trace_dir):
        for _ in range(3):
            m, a = dev.search_reads(mat, lent, 2 * B, packed2=True)
        jax.block_until_ready((m, a))

    f = sorted(glob.glob(
        os.path.join(trace_dir, "plugins/profile/*/*.trace.json.gz")
    ))[-1]
    d = json.load(gzip.open(f))
    pids = {
        e["pid"]
        for e in d["traceEvents"]
        if e.get("ph") == "M" and e.get("name") == "process_name"
        and "GPU" in e["args"].get("name", "")
    }
    if not pids:
        names = [e["args"].get("name") for e in d["traceEvents"]
                 if e.get("ph") == "M" and e.get("name") == "process_name"]
        print(f"no GPU process in the trace; processes: {names}",
              file=sys.stderr)
    by = collections.defaultdict(float)
    src = {}
    for e in d["traceEvents"]:
        if e.get("ph") == "X" and e.get("pid") in pids:
            by[e["name"]] += e.get("dur", 0) / 1e3
            st = e.get("args", {}).get("source_stack") or ""
            if st and e["name"] not in src:
                src[e["name"]] = str(st).split("\n")[0][:70]
    for name, ms in sorted(by.items(), key=lambda kv: -kv[1])[:16]:
        print(f"{ms/3:8.3f} ms/step  {name[:28]:28} {src.get(name, '')}",
              file=sys.stderr)


if __name__ == "__main__":
    main()
