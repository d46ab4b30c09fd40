"""Search benchmark on one GPU: reads per second of the demo community.

One process on the card.  Builds (once, cached under .bench/) the
seeded synthetic demo community (tools/synth_data.py: 15 genomes of
1-5 Mb at KMCP demo-profiling's designed depths) and its database —
k=21, 10 chunks per genome, fpr 0.3, one hash, one 4096-target block —
then times ``StreamSearcher.run`` on the jax backend (FASTQ records in
memory -> TSV rows): single-end reads at 32k-read batches, pairs, the
profiler behind the device search TSV, and, when its cache exists, the
131k-target screened DB (tools/bench_large_t.py).  Fails unless JAX's
first device is a GPU.

Baseline: the reference's checked-in demo log (demo-profiling
mock.kmcp.gz.log): 14.671 million queries/minute = 244,517 reads/s on a
40-thread CPU server.

Prints ONE JSON line:
  {"metric": "search_reads_per_s", "value": N, "unit": "reads/s",
   "vs_baseline": N/244517, "device": {...}, ...extras}

Named cells with regression bounds are the next benchmark change
(ROADMAP Queue 1 item 1).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

BASELINE_READS_PER_S = 14.671e6 / 60.0  # mock.kmcp.gz.log
CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".bench")


def ensure_db(refs: str) -> str:
    db_dir = os.path.join(CACHE, "bench-demo", "k21n10.db")
    if os.path.isfile(os.path.join(db_dir, "db.json")):
        return db_dir
    from kmcp_tpu.commands.compute import ComputeOptions, run_compute
    from kmcp_tpu.index.build import run_index

    kdir = os.path.join(CACHE, "bench-demo", "k21n10")
    run_compute(out_dir=kdir, in_dir=refs,
                opt=ComputeOptions(ks=[21], split_number=10,
                                   split_overlap=150),
                force=True, verbose=False)
    run_index(in_dir=kdir, out_dir=db_dir, num_hashes=1, fpr=0.3,
              force=True, tpu_native=True, verbose=False)
    return db_dir


def timed_runs(st, queries, paired: bool, sink) -> float:
    """Best of two timed passes after one warm pass (compiles)."""
    st.run(iter(queries), sink, paired=paired)
    best = None
    for _ in range(2):
        t0 = time.perf_counter()
        st.run(iter(queries), sink, paired=paired)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best


def main() -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU, JAX's first device is {dev.platform}",
              file=sys.stderr)
        return 1

    from kmcp_tpu.profile.core import ProfileOptions
    from kmcp_tpu.profile.fast import FastProfiler, flat_from_files
    from kmcp_tpu.profile.taxonomy import Taxonomy, load_taxid_map
    from kmcp_tpu.search.engine import SearchEngine, SearchOptions
    from kmcp_tpu.search.stream import StreamSearcher
    from kmcp_tpu.seqio.fastx import read_fastx
    from tools.synth_data import make_demo

    d = make_demo(os.path.join(CACHE, "bench-demo", "data"))
    db = ensure_db(d["refs"])
    se = [(r.id, r.seq, None) for r in read_fastx(d["se"])]
    pe = [(a.id, a.seq, b.seq)
          for a, b in zip(read_fastx(d["r1"]), read_fastx(d["r2"]))]

    record = {
        "metric": "search_reads_per_s", "unit": "reads/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    with open(os.devnull, "w") as sink:
        st = StreamSearcher(SearchEngine(
            [db], SearchOptions(backend="jax", batch_size=32768)
        ))
        dt = timed_runs(st, se, False, sink)
        record["value"] = len(se) / dt
        record["vs_baseline"] = record["value"] / BASELINE_READS_PER_S
        record["reads"] = len(se)
        record["seconds"] = dt

        stp = StreamSearcher(SearchEngine(
            [db], SearchOptions(backend="jax", batch_size=16384)
        ))
        record["paired_pairs_per_s"] = len(pe) / timed_runs(
            stp, pe, True, sink
        )

    # profiling behind the device search: TSV of one device pass
    tsv = os.path.join(CACHE, "bench-demo", "se.jax.tsv")
    with open(tsv, "w") as f:
        st.run(iter(se), f)
    popt = ProfileOptions(mode=1)
    t0 = time.perf_counter()
    parsed = flat_from_files([tsv], popt.max_fpr, popt.min_qcov)
    prof = FastProfiler(popt, taxdb=Taxonomy(d["taxdump"]),
                        taxid_map=load_taxid_map([d["taxid_map"]]))
    targets = prof.run(parsed)
    record["profile_reads_per_s"] = len(se) / (time.perf_counter() - t0)
    record["profile_targets"] = len(targets)

    lt_db = os.path.join(CACHE, "large_t-131072", "db-uniform")
    if os.path.isfile(os.path.join(lt_db, "db.json")):
        from tools.bench_large_t import bench_device, make_reads

        lt = bench_device(
            lt_db,
            make_reads(os.path.join(CACHE, "large_t-131072", "genomes"),
                       65536, 10.0),
            batch=16384,
        )
        record["large_t_device_reads_per_s"] = lt["reads_per_s"]
        record["large_t_step_reads_per_s"] = lt["step_reads_per_s"]
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
