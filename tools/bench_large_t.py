"""Large-target-count search benchmark and its seeded synthetic DBs.

The reference's production regime is GTDB scale: ~48k genome targets for
the search benchmark, ~479k chunk targets for profiling DBs
(/root/reference/benchmarks/searching/README.md:186-229 — 1.2-1.4M reads
in 53-73 s on 40 threads against 47,894 genomes ~= 20k reads/s).

This tool builds a synthetic wide DB (--tpu-native 4096-target blocks)
at 100k+ chunk targets and measures host search throughput with and
without the per-block union screen, plus the jax device path.

Usage:
  python tools/bench_large_t.py [--targets 131072] [--reads 20000]
      [--junk-pct 10] [--backends host,host-noscreen[,jax]]

The DB is cached under .bench/large_t-<targets>/ across runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".bench"
)
CHUNKS_PER_GENOME = 64
CHUNK_BP = 1000  # ~1000 k-mers per chunk target
READ_LEN = 150


def prepare_ks(n_targets: int, force: bool = False) -> tuple[str, str]:
    """Synthetic genomes + the compute stage (chunk .kset files) every
    index layout at this target count shares.  Idempotent: skips when
    the compute stage's _info.tsv already exists."""
    from kmcp_tpu.commands.compute import ComputeOptions, run_compute

    root = os.path.join(CACHE, f"large_t-{n_targets}")
    gdir = os.path.join(root, "genomes")
    kdir = os.path.join(root, "ks")
    if os.path.isfile(os.path.join(kdir, "_info.tsv")) and not force:
        return kdir, gdir
    os.makedirs(gdir, exist_ok=True)
    n_genomes = n_targets // CHUNKS_PER_GENOME
    glen = CHUNK_BP * CHUNKS_PER_GENOME + 150 * (CHUNKS_PER_GENOME - 1)
    rng = np.random.default_rng(42)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    t0 = time.time()
    files = []
    for g in range(n_genomes):
        path = os.path.join(gdir, f"g{g:05d}.fa")
        files.append(path)
        if not os.path.isfile(path):
            seq = rng.choice(bases, size=glen).tobytes()
            with open(path, "w") as f:
                f.write(f">g{g:05d}\n{seq.decode()}\n")
        else:
            rng.choice(bases, size=glen)  # keep the stream aligned
    t1 = time.time()
    print(f"[large-t] {n_genomes} genomes x {glen} bp: {t1-t0:.1f}s",
          file=sys.stderr)
    run_compute(
        out_dir=kdir, files=files,
        opt=ComputeOptions(ks=[21], split_number=CHUNKS_PER_GENOME,
                           split_overlap=150),
        force=True,
    )
    print(f"[large-t] compute: {time.time()-t1:.1f}s", file=sys.stderr)
    return kdir, gdir


def build_db(n_targets: int, force: bool = False) -> tuple[str, str]:
    """Synthetic genomes -> kset -> screened wide DB.
    Returns (db_screen, genome_dir)."""
    from kmcp_tpu.index.build import run_index

    root = os.path.join(CACHE, f"large_t-{n_targets}")
    db = os.path.join(root, "db")
    gdir = os.path.join(root, "genomes")
    # Check db.json BEFORE invoking prepare_ks (matching build_wide_db /
    # build_uniform_db ordering) so a cached db survives a pruned ks/.
    if (os.path.isfile(os.path.join(db, "db.json")) and os.path.isdir(gdir)
            and not force):
        return db, gdir
    kdir, gdir = prepare_ks(n_targets, force=force)
    t2 = time.time()
    run_index(
        in_dir=kdir, out_dir=db, num_hashes=1, fpr=0.3, force=True,
        tpu_native=True, block_screen=True,
    )
    print(f"[large-t] index(+screen): {time.time()-t2:.1f}s",
          file=sys.stderr)
    return db, gdir


def make_reads(gdir: str, n: int, junk_pct: float) -> list:
    from kmcp_tpu.seqio.fastx import read_fastx

    rng = np.random.default_rng(7)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    files = sorted(os.listdir(gdir))
    # sample source genomes sparsely (a metagenome hits few references)
    pool = [files[i] for i in rng.choice(len(files), size=min(40, len(files)), replace=False)]
    genomes = []
    for f in pool:
        genomes.append(
            b"".join(r.seq for r in read_fastx(os.path.join(gdir, f)))
        )
    reads = []
    n_junk = int(n * junk_pct / 100)
    for i in range(n - n_junk):
        g = genomes[int(rng.integers(0, len(genomes)))]
        p = int(rng.integers(0, len(g) - READ_LEN))
        reads.append((f"r{i}", g[p : p + READ_LEN], None))
    for i in range(n_junk):
        reads.append(
            (f"j{i}", rng.choice(bases, size=READ_LEN).tobytes(), None)
        )
    rng.shuffle(reads)
    return reads


def make_pairs(gdir: str, n: int, insert: int = 350) -> list:
    """n mate pairs (150 bp mates, ``insert`` bp apart, mate 2 reverse
    complemented) from the same sparse genome pool as make_reads."""
    from kmcp_tpu.seqio.fastx import read_fastx

    rng = np.random.default_rng(11)
    files = sorted(os.listdir(gdir))
    pool = [files[i] for i in rng.choice(len(files), size=min(40, len(files)), replace=False)]
    genomes = [
        b"".join(r.seq for r in read_fastx(os.path.join(gdir, f)))
        for f in pool
    ]
    rc = bytes.maketrans(b"ACGT", b"TGCA")
    pairs = []
    for i in range(n):
        g = genomes[int(rng.integers(0, len(genomes)))]
        p = int(rng.integers(0, len(g) - insert))
        m2 = g[p + insert - READ_LEN : p + insert].translate(rc)[::-1]
        pairs.append((f"p{i}", g[p : p + READ_LEN], m2))
    return pairs


def bench_backend(db: str, reads, backend: str, batch: int = 16384):
    from kmcp_tpu.search.engine import SearchEngine, SearchOptions
    from kmcp_tpu.search.stream import StreamSearcher

    opt = SearchOptions(
        backend="host" if backend.startswith("host") else backend,
        batch_size=batch,
    )
    engine = SearchEngine([db], opt)
    st = StreamSearcher(engine)
    out = open(os.devnull, "w")
    st.run(iter(reads[:batch]), out)  # warm
    best = None
    for _ in range(2):
        t0 = time.time()
        total, matched = st.run(iter(reads), out)
        dt = time.time() - t0
        best = dt if best is None else min(best, dt)
    return {
        "backend": backend,
        "reads_per_s": round(len(reads) / best, 1),
        "matched_pct": round(matched / total * 100, 2),
        "seconds": round(best, 2),
    }


def build_wide_db(n_targets: int) -> str:
    """Single-block wide layout (all targets in ONE [S, T/32]-word block)
    for the dense device path: the fused on-device hash derives Bloom
    rows in one modulus space, and one gather row covers every target."""
    from kmcp_tpu.index.build import run_index

    root = os.path.join(CACHE, f"large_t-{n_targets}")
    db = os.path.join(root, "db-wide")
    if os.path.isfile(os.path.join(db, "db.json")):
        return db
    kdir, _ = prepare_ks(n_targets)
    run_index(
        in_dir=kdir, out_dir=db, num_hashes=1, fpr=0.3, force=True,
        tpu_native=True, native_block_targets=n_targets,
    )
    return db


def build_uniform_db(n_targets: int) -> str:
    """Multi-block screened uniform-geometry layout for the device
    two-pass path (device.py::_make_screened_tail)."""
    from kmcp_tpu.index.build import run_index

    root = os.path.join(CACHE, f"large_t-{n_targets}")
    db = os.path.join(root, "db-uniform")
    if os.path.isfile(os.path.join(db, "db.json")):
        return db
    kdir, _ = prepare_ks(n_targets)
    run_index(
        in_dir=kdir, out_dir=db, num_hashes=1, fpr=0.3, force=True,
        tpu_native=True, block_screen=True, uniform_sigs=True,
    )
    return db


def bench_device(db: str, reads, batch: int = 1024):
    """Direct DeviceDB drive of the search core (device hash + tail), no
    TSV formatting: the device-step rate (batches dispatched back to
    back, one barrier at the end) and the pipelined end-to-end rate
    (packing + H2D + step + D2H of the candidate lists, 4 in flight)."""
    import jax

    from kmcp_tpu.kmer import native
    from kmcp_tpu.search.device import DeviceDB
    from kmcp_tpu.search.engine import SearchEngine, SearchOptions

    opt = SearchOptions(backend="jax", batch_size=batch)
    engine = SearchEngine([db], opt)
    dev = DeviceDB(engine.dbs[0], opt)
    budget = 2 * batch
    n = len(reads) - len(reads) % batch
    seqs = [r[1] for r in reads[:n]]
    lens_all = np.array([len(s) for s in seqs], dtype=np.int64)
    lmax = max(-(-int(lens_all.max()) // 32) * 32, 21 + 31)
    mats = [
        (native.pack_rows_2bit(seqs[lo : lo + batch],
                               lens_all[lo : lo + batch], lmax),
         lens_all[lo : lo + batch])
        for lo in range(0, n, batch)
    ]
    jax.block_until_ready(
        dev.search_reads(mats[0][0], mats[0][1], budget, packed2=True)
    )

    t0 = time.perf_counter()
    for mat, lens in mats:
        m, _a = dev.search_reads(mat, lens, budget, packed2=True)
    jax.block_until_ready(m)
    step_rps = n / (time.perf_counter() - t0)

    from collections import deque

    got = 0
    t0 = time.perf_counter()
    pending = deque()
    for mat, lens in mats:
        meta, aux = dev.search_reads(mat, lens, budget, packed2=True)
        meta.copy_to_host_async()
        pending.append(meta)
        if len(pending) >= 4:
            got += min(int(np.asarray(pending.popleft())[0]), budget)
    while pending:
        got += min(int(np.asarray(pending.popleft())[0]), budget)
    dt = time.perf_counter() - t0
    return {
        "backend": "jax",
        "reads_per_s": n / dt,
        "step_reads_per_s": step_rps,
        "candidates": got,
        "seconds": dt,
        "batch": batch,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--targets", type=int, default=131072)
    ap.add_argument("--reads", type=int, default=20000)
    ap.add_argument("--junk-pct", type=float, default=10.0)
    ap.add_argument("--backends", default="host,host-noscreen")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--force-db", action="store_true")
    args = ap.parse_args()

    db, gdir = build_db(args.targets, force=args.force_db)
    reads = make_reads(gdir, args.reads, args.junk_pct)
    results = []
    for backend in args.backends.split(","):
        if backend in ("jax", "jax-dense", "jax-screened"):
            lt_db = (
                build_wide_db(args.targets)
                if backend == "jax-dense"
                else build_uniform_db(args.targets)
            )
            r = bench_device(lt_db, reads, batch=args.batch)
            r["backend"] = backend
            r["targets"] = args.targets
            r["reads"] = len(reads)
            print(json.dumps(r))
            results.append(r)
            continue
        if backend == "host-noscreen":
            os.environ["KMCP_TPU_NO_SCREEN"] = "1"
        else:
            os.environ.pop("KMCP_TPU_NO_SCREEN", None)
        r = bench_backend(db, reads, backend)
        r["targets"] = args.targets
        r["reads"] = len(reads)
        print(json.dumps(r))
        results.append(r)
    if len(results) >= 2:
        a, b = results[0], results[1]
        print(
            f"[large-t] screen speedup: "
            f"{a['reads_per_s'] / max(b['reads_per_s'], 1e-9):.2f}x",
            file=sys.stderr,
        )


if __name__ == "__main__":
    main()
