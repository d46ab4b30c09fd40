"""Proof that search -> profile runs on one NVIDIA GPU.

    python chip_smoke.py

Drives the normal CLI (``kmcp_tpu.cli.main``, in-process) on seeded
synthetic data (tools/synth_data.py, tools/bench_large_t.py) and checks
every device result against the host backend byte for byte:

1. environment — platform, device kind and count, the card's name and
   power limit, JAX version, XLA_FLAGS, compile cache; fails unless
   JAX's first device is a GPU;
2. demo — 15 genomes of 1-5 Mb, ``compute -k 21 -n 10 -l 150``,
   ``index -f 0.3 -n 1 --tpu-native``, single-end and paired ``search --backend
   jax`` vs ``--backend host`` (several full stream batches each), then
   ``profile`` (KMCP, CAMI and binning outputs) on the GPU TSV;
3. wide — the 131,072-target screened DB (32 blocks of 4096 targets),
   50k single-end reads and 25k pairs, jax vs host, plus the step's
   ``memory_analysis()``;
4. sketch and whole genome — a single-block minimizer sketch DB, and
   one ``search -g`` genome query, jax vs host;
5. the ``gpu``-marked tests, in-process (among them the device hash
   against the C++ and NumPy hashes at a real stream width).

Each phase prints one line with its times, rates and the device's
``peak_bytes_in_use``.  Data and outputs live under the gitignored
``.bench/`` of the checkout.  The last line is the JSON result; any
failure exits non-zero before it.
"""

from __future__ import annotations

import filecmp
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".bench", "smoke")

# full sizes: the demo community and the wide-target cell
FULL = {
    "demo_scale": 1.0, "demo_min_len": 1_000_000,
    "demo_max_len": 5_000_000, "wide_targets": 131072,
    "wide_reads": 50000, "wide_pairs": 25000,
}


def log(msg: str) -> None:
    print(msg, flush=True)


def peak_bytes() -> int:
    import jax

    return int(jax.devices()[0].memory_stats()["peak_bytes_in_use"])


def cli(*args: str) -> None:
    from kmcp_tpu.cli import main

    rc = main(["-q", *args])
    if rc:
        raise RuntimeError(f"kmcp-tpu {' '.join(args)} exited {rc}")


def count_fastq(path: str) -> int:
    with open(path, "rb") as f:
        return sum(1 for _ in f) // 4


class StreamRoute:
    """Records which backends the streaming path served, so a silent
    fall back to the object engine fails the phase."""

    def __init__(self):
        from kmcp_tpu.search import stream

        self.calls: list[tuple[str, str]] = []
        orig = stream.StreamSearcher.run
        route = self

        def run(st, *a, **kw):
            route.calls.append((st.opt.backend, type(st.dev).__name__))
            return orig(st, *a, **kw)

        stream.StreamSearcher.run = run

    def expect(self, n_jax: int) -> None:
        got = [c for c in self.calls if c == ("jax", "DeviceDB")]
        if len(got) != n_jax:
            raise RuntimeError(
                f"streaming device route ran {len(got)}x, expected "
                f"{n_jax}x: {self.calls}"
            )
        self.calls.clear()


def search_both(db: str, out: str, query: list[str], extra=()) -> dict:
    """search --backend jax and --backend host; the TSVs must be
    byte-identical.  Returns the wall times."""
    times = {}
    for backend in ("jax", "host"):
        t0 = time.perf_counter()
        cli("search", "-d", db, *query, *extra, "--backend", backend,
            "-o", f"{out}.{backend}.tsv")
        times[backend] = time.perf_counter() - t0
    if not filecmp.cmp(f"{out}.jax.tsv", f"{out}.host.tsv", shallow=False):
        raise RuntimeError(f"{out}: GPU and host TSVs differ")
    with open(f"{out}.jax.tsv") as f:
        rows = sum(1 for l in f if l and not l.startswith("#"))
    if rows == 0:
        raise RuntimeError(f"{out}: no matches")
    times["rows"] = rows
    return times


def phase_environment() -> dict:
    import jax

    from kmcp_tpu.search.device import compile_cache_dir

    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"JAX's first device is {dev.platform}, not a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    log(f"card: {card.stdout.strip() or card.stderr.strip()}")
    log(
        f"phase environment: platform={dev.platform} "
        f"kind={dev.device_kind} count={len(devs)} jax={jax.__version__} "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
        f"compile_cache={compile_cache_dir()}"
    )
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devs)}


def phase_demo(sz: dict, route: StreamRoute) -> dict:
    from tools.synth_data import make_demo

    t0 = time.perf_counter()
    d = make_demo(os.path.join(WORK, "demo-data"), seed=1,
                  scale=sz["demo_scale"], min_len=sz["demo_min_len"],
                  max_len=sz["demo_max_len"])
    out = os.path.join(WORK, "demo")
    os.makedirs(out, exist_ok=True)
    kdir, db = os.path.join(out, "k21n10"), os.path.join(out, "k21n10.db")
    cli("compute", "-I", d["refs"], "-k", "21", "-n", "10", "-l", "150",
        "-O", kdir, "--force")
    # one 4096-target block: the reference's own block layout has no
    # device route yet (ROADMAP Queue 2 item 4)
    cli("index", "-I", kdir, "-O", db, "-f", "0.3", "-n", "1",
        "--tpu-native", "--force")
    t_build = time.perf_counter() - t0
    n_se, n_pe = count_fastq(d["se"]), count_fastq(d["r1"])
    se = search_both(db, os.path.join(out, "se"), [d["se"]])
    pe = search_both(db, os.path.join(out, "pe"),
                     ["-1", d["r1"], "-2", d["r2"]])
    route.expect(2)
    prof = os.path.join(out, "profile")
    t0 = time.perf_counter()
    cli("profile", "-T", d["taxid_map"], "-X", d["taxdump"], "-m", "1",
        os.path.join(out, "se.jax.tsv"), "-o", prof + ".tsv",
        "-C", prof + ".cami", "-B", prof + ".binning.gz", "-s", "0")
    t_prof = time.perf_counter() - t0
    found = {}
    with open(prof + ".tsv") as f:
        f.readline()
        for line in f:
            parts = line.rstrip("\n").split("\t")
            found[parts[0]] = float(parts[1])
    truth = d["truth_pct"]
    major = [g for g, p in truth.items() if p > 1]
    bad = [g for g in major
           if g not in found or abs(found[g] - truth[g]) > 1.5]
    if bad or len(found) < 10:
        raise RuntimeError(f"profile off the design: {found} vs {truth}")
    log(
        f"phase demo: build {t_build:.1f}s | SE {n_se} reads "
        f"({-(-n_se // 16384)} stream batches) jax {se['jax']:.2f}s "
        f"= {n_se / se['jax']:.0f} reads/s, host {se['host']:.2f}s "
        f"= {n_se / se['host']:.0f} reads/s, {se['rows']} rows identical "
        f"| PE {n_pe} pairs jax {pe['jax']:.2f}s = "
        f"{n_pe / pe['jax']:.0f} pairs/s, host {pe['host']:.2f}s = "
        f"{n_pe / pe['host']:.0f} pairs/s, {pe['rows']} rows identical "
        f"(CLI wall times: DB load, upload and compile included) | profile "
        f"{t_prof:.2f}s, {len(found)}/15 genomes, major within 1.5 pts | "
        f"peak_bytes_in_use {peak_bytes()}"
    )
    return {"db": db, "data": d}


def _write_reads(path: str, reads) -> None:
    with open(path, "wb") as f:
        for name, seq in reads:
            f.write(b"@%s\n%s\n+\n%s\n" % (name.encode(), seq,
                                            b"I" * len(seq)))


def phase_wide(sz: dict, route: StreamRoute) -> None:
    import jax
    import numpy as np

    from tools import bench_large_t as blt

    t0 = time.perf_counter()
    db = blt.build_uniform_db(sz["wide_targets"])
    gdir = os.path.join(blt.CACHE, f"large_t-{sz['wide_targets']}",
                        "genomes")
    t_build = time.perf_counter() - t0
    out = os.path.join(WORK, "wide")
    os.makedirs(out, exist_ok=True)
    se = blt.make_reads(gdir, sz["wide_reads"], 10.0)
    _write_reads(os.path.join(out, "se.fq"), [(q, s) for q, s, _ in se])
    pairs = blt.make_pairs(gdir, sz["wide_pairs"])
    _write_reads(os.path.join(out, "r1.fq"), [(q, a) for q, a, _ in pairs])
    _write_reads(os.path.join(out, "r2.fq"), [(q, b) for q, _, b in pairs])
    t_se = search_both(db, os.path.join(out, "se"),
                       [os.path.join(out, "se.fq")])
    t_pe = search_both(db, os.path.join(out, "pe"),
                       ["-1", os.path.join(out, "r1.fq"),
                        "-2", os.path.join(out, "r2.fq")])
    route.expect(2)

    # the compiled step of one stream batch, and what it holds
    from kmcp_tpu.kmer import native
    from kmcp_tpu.search.device import DeviceDB
    from kmcp_tpu.search.engine import SearchEngine, SearchOptions

    opt = SearchOptions(backend="jax")
    dev = DeviceDB(SearchEngine([db], opt).dbs[0], opt)
    B, lmax = 16384, 160
    seqs = [s for _q, s, _ in se[:B]]
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    codes, nmask = native.pack_rows_2bit(seqs, lens, lmax)
    step = jax.jit(lambda c, m, ln: dev.search_reads(
        (c, m), ln, 2 * B, packed2=True))
    mem = step.lower(codes, nmask, lens.astype(np.int32)).compile(
    ).memory_analysis()
    index_mb = (dev.bits_ext.nbytes + dev.screen["u_ext"].nbytes) / 1e6
    log(
        f"phase wide: {dev.n_blocks} blocks x {dev.t_per_block} targets, "
        f"build {t_build:.1f}s | SE {len(se)} reads jax {t_se['jax']:.2f}s "
        f"= {len(se) / t_se['jax']:.0f} reads/s, host {t_se['host']:.2f}s, "
        f"{t_se['rows']} rows identical | PE {len(pairs)} pairs jax "
        f"{t_pe['jax']:.2f}s = {len(pairs) / t_pe['jax']:.0f} pairs/s, "
        f"host {t_pe['host']:.2f}s, {t_pe['rows']} rows identical "
        f"(CLI wall times: DB load, upload and compile included) | "
        f"index {index_mb:.0f} MB on the device (a few hundred MB: "
        f"deployment-size indexes are ROADMAP Queue 2 item 7) | "
        f"step memory_analysis: {mem} | peak_bytes_in_use {peak_bytes()}"
    )


def phase_sketch_genome(demo: dict, route: StreamRoute) -> None:
    d = demo["data"]
    out = os.path.join(WORK, "sketch")
    os.makedirs(out, exist_ok=True)
    kdir, db = os.path.join(out, "mm"), os.path.join(out, "mm.db")
    t0 = time.perf_counter()
    cli("compute", "-I", d["refs"], "-k", "21", "-W", "5", "-n", "10",
        "-l", "150", "-O", kdir, "--force")
    cli("index", "-I", kdir, "-O", db, "-f", "0.3", "-n", "1",
        "--tpu-native", "--force")
    t_build = time.perf_counter() - t0
    sk = search_both(db, os.path.join(out, "se"), [d["se"]],
                     extra=("-c", "3"))
    route.expect(1)
    # the genome query: the first chunk of the longest genome (over
    # 262,144 k-mers, so the device counter takes its chunked path);
    # its own chunk target covers it fully
    longest = max(
        (os.path.join(d["refs"], f) for f in os.listdir(d["refs"])),
        key=os.path.getsize,
    )
    with open(longest, "rb") as f:
        f.readline()
        seq = f.read().replace(b"\n", b"")
    genome = os.path.join(out, "genome.fa")
    with open(genome, "wb") as f:
        f.write(b">query\n" + seq[: len(seq) // 10] + b"\n")
    wg = search_both(demo["db"], os.path.join(out, "genome"), [genome],
                     extra=("-g",))
    log(
        f"phase sketch+genome: minimizer DB build {t_build:.1f}s, SE jax "
        f"{sk['jax']:.2f}s host {sk['host']:.2f}s, {sk['rows']} rows "
        f"identical | search -g jax {wg['jax']:.2f}s host "
        f"{wg['host']:.2f}s, {wg['rows']} rows identical | "
        f"peak_bytes_in_use {peak_bytes()}"
    )


def phase_gpu_tests() -> None:
    import pytest

    class Outcomes:
        def __init__(self):
            self.passed = 0
            self.other = []

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1
            elif report.failed or report.skipped:
                self.other.append(report.nodeid)

    out = Outcomes()
    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests")], plugins=[out])
    if rc != 0 or out.other or out.passed == 0:
        raise RuntimeError(
            f"gpu-marked tests: exit {rc}, {out.passed} passed, not "
            f"passed: {out.other}"
        )
    log(f"phase gpu tests: {out.passed} passed in "
        f"{time.perf_counter() - t0:.1f}s | "
        f"peak_bytes_in_use {peak_bytes()}")


def main() -> int:
    sys.path.insert(0, REPO)
    try:
        import kmcp_tpu  # noqa: F401
        from kmcp_tpu.kmer import native
        import tools.synth_data  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    if native.get_lib() is None:
        print("chip_smoke: the native library did not build",
              file=sys.stderr)
        return 2
    os.makedirs(WORK, exist_ok=True)
    t0 = time.perf_counter()
    device = phase_environment()
    route = StreamRoute()
    demo = phase_demo(FULL, route)
    phase_wide(FULL, route)
    phase_sketch_genome(demo, route)
    phase_gpu_tests()
    log(f"all phases passed in {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
