"""End-to-end profiling validation on the demo-profiling reference set.

The reference repo's mock reads are not checked in (generated with an
external simulator), so we simulate an equivalent mock community with the
same designed relative depths (demo-profiling/depth.tsv) and assert the
estimated abundances land near the ground truth — the same accuracy check
the reference README demonstrates (its own estimates deviate up to ~0.6
percentage points from truth)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from .conftest import REFERENCE_DIR, reference_available
from .test_golden_search import run_cli

REFS = os.path.join(REFERENCE_DIR, "demo-profiling", "refs")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAXDUMP = os.path.join(REFERENCE_DIR, "demo-profiling", "taxdump-custom")

# demo-profiling/depth.tsv
DEPTHS = {
    "GCF_003697165.2": 1, "GCF_002949675.1": 1, "GCF_002950215.1": 1,
    "GCF_000742135.1": 1, "GCF_000006945.2": 1,
    "GCF_001544255.1": 0.1, "GCF_000392875.1": 0.1,
    "GCF_001457655.1": 0.1, "GCF_900638025.1": 0.1,
    "GCF_001027105.1": 0.05, "GCF_006742205.1": 0.05,
    "GCF_000148585.2": 0.01, "GCF_001096185.1": 0.01,
    "GCF_000017205.1": 0.005, "GCF_009759685.1": 0.005,
}
SCALE = 0.6  # fraction of the demo read depth (low-abundance refs need >=5 reads/chunk)
READ_LEN = 150


def simulate_reads(tmp_path):
    from kmcp_tpu.seqio.fastx import read_fastx

    rng = np.random.default_rng(7)
    fq = tmp_path / "mock.fq"
    truth = {}
    total_depth = 0.0
    with open(fq, "w") as f:
        n = 0
        for acc, depth in DEPTHS.items():
            seqs = [
                r.seq
                for r in read_fastx(os.path.join(REFS, acc + ".fa.gz"))
                if "plasmid" not in r.name
            ]
            genome = b"".join(seqs)
            gsize = len(genome)
            n_reads = int(depth * SCALE * gsize / READ_LEN)
            for _ in range(n_reads):
                p = rng.integers(0, gsize - READ_LEN)
                read = genome[p : p + READ_LEN]
                f.write(f"@r{n}\n{read.decode()}\n+\n{'I'*READ_LEN}\n")
                n += 1
            truth[acc] = depth
            total_depth += depth
    truth = {k: v / total_depth * 100 for k, v in truth.items()}
    return str(fq), truth


@pytest.fixture(scope="module")
def taxid_map(tmp_path_factory):
    """The reference repo doesn't ship taxid.map (taxonkit output); rebuild
    it from the id/taxid columns of mock.gs.tsv."""
    d = tmp_path_factory.mktemp("taxmap")
    path = d / "taxid.map"
    # species name -> taxid from the shipped names.dmp
    name2taxid = {}
    with open(os.path.join(TAXDUMP, "names.dmp")) as f:
        for line in f:
            parts = [p.strip() for p in line.split("|")]
            if len(parts) >= 4 and parts[3] == "scientific name":
                name2taxid[parts[1]] = parts[0]
    src = os.path.join(REFERENCE_DIR, "demo-profiling", "taxonomy.tsv")
    with open(src) as f, open(path, "w") as out:
        header = f.readline().rstrip("\n").split("\t")
        i_id, i_sp = header.index("id"), header.index("species")
        for line in f:
            parts = line.rstrip("\n").split("\t")
            out.write(f"{parts[i_id]}\t{name2taxid[parts[i_sp]]}\n")
    return str(path)


@pytest.fixture(scope="module")
def demo_db(tmp_path_factory):
    d = tmp_path_factory.mktemp("profdb")
    kdir = d / "k21n10"
    db = d / "k21n10.db"
    run_cli(
        "compute", "--in-dir", REFS, "-k", "21", "-n", "10", "-l", "150",
        "-N", r"^([\w\.\_]+\.\d+)", "-B", "plasmid",
        "-O", str(kdir), "--force",
    )
    run_cli(
        "-j", "40", "index", "-I", str(kdir), "-O", str(db),
        "-n", "1", "-f", "0.3", "--force",
    )
    return str(db)


@pytest.mark.skipif(not reference_available(), reason="reference repo absent")
def test_profile_mock_community(demo_db, taxid_map, tmp_path):
    fq, truth = simulate_reads(tmp_path)
    tsv = tmp_path / "mock.tsv.gz"
    run_cli("-q", "search", "-d", demo_db, str(fq), "-o", str(tsv))

    kprofile = tmp_path / "mock.kmcp.profile"
    cami = tmp_path / "mock.cami"
    binning = tmp_path / "mock.binning.gz"
    run_cli(
        "-q", "profile",
        "-T", taxid_map,
        "-X", TAXDUMP,
        "-m", "1",
        str(tsv),
        "-o", str(kprofile),
        "-C", str(cami),
        "-B", str(binning),
        "-s", "0",
    )

    # ---- KMCP profile: all 15 refs detected, abundances near truth
    rows = {}
    with open(kprofile) as f:
        header = f.readline().rstrip("\n").split("\t")
        assert header[0] == "ref" and len(header) == 17
        for line in f:
            parts = line.rstrip("\n").split("\t")
            rows[parts[0]] = parts
    assert set(rows) == set(DEPTHS), (
        f"missing: {set(DEPTHS) - set(rows)}, extra: {set(rows) - set(DEPTHS)}"
    )
    for acc, expect_pct in truth.items():
        got = float(rows[acc][1])
        assert abs(got - expect_pct) < 1.5, (acc, got, expect_pct)
    # taxonomy columns present
    assert rows["GCF_003697165.2"][14] == "Escherichia coli"
    assert "Enterobacteriaceae" in rows["GCF_003697165.2"][15]

    # ---- CAMI report: header + percentages summing per rank
    with open(f"{cami}.profile") as f:
        lines = f.read().splitlines()
    assert lines[0] == "@SampleID:0"
    assert lines[4] == "@@TAXID\tRANK\tTAXPATH\tTAXPATHSN\tPERCENTAGE"
    ranks = {}
    for line in lines[5:]:
        taxid, rank, taxpath, names, pct = line.split("\t")
        ranks.setdefault(rank, 0.0)
        ranks[rank] += float(pct)
    for rank in ("superkingdom", "phylum", "species"):
        assert abs(ranks[rank] - 100.0) < 0.01, (rank, ranks[rank])

    # ---- binning: valid format, majority of reads assigned
    import gzip

    with gzip.open(binning, "rt") as f:
        blines = f.read().splitlines()
    assert blines[2] == "@Version:0.10.0"
    n_binned = sum(1 for l in blines if l and not l.startswith(("#", "@")))
    assert n_binned > 10000


@pytest.mark.skipif(not reference_available(), reason="reference repo absent")
def test_merge_two_shards(demo_db, tmp_path):
    """Search two DB shards separately + merge == semantics of the
    reference's cluster sharding story."""
    fq, _ = simulate_reads(tmp_path)
    # reuse the same db twice as two 'shards' (valid input for merge)
    t1 = tmp_path / "s1.tsv"
    t2 = tmp_path / "s2.tsv"
    run_cli("-q", "search", "-d", demo_db, str(fq), "-o", str(t1))
    run_cli("-q", "search", "-d", demo_db, str(fq), "-o", str(t2))
    merged = tmp_path / "merged.tsv"
    run_cli("-q", "merge", str(t1), str(t2), "-o", str(merged))
    with open(merged) as f:
        lines = f.read().splitlines()
    stats = [l for l in lines if l.startswith("# ")]
    assert any("input queries" in s for s in stats)
    # every merged group has doubled hits
    data = [l.split("\t") for l in lines if l and not l.startswith("#")]
    assert data, "no merged rows"
    from collections import Counter

    by_q = Counter(r[-1] for r in data)
    for row in data[:50]:
        assert int(row[4]) == by_q[row[-1]]


@pytest.mark.skipif(not reference_available(), reason="reference repo absent")
def test_cluster_shard_merge_profile(taxid_map, tmp_path):
    """The full cluster pipeline (BASELINE config 5 semantics, CPU): the
    reference collection split into TWO genuinely different DB shards,
    searched independently, merged, and profiled — all 15 refs recovered
    with abundances near truth, like the single-DB pipeline
    (/root/reference/kmcp/cmd/merge.go cluster story)."""
    from kmcp_tpu.commands.compute import ComputeOptions, run_compute
    from kmcp_tpu.index.build import run_index

    accs = sorted(DEPTHS)
    halves = [accs[::2], accs[1::2]]
    dbs = []
    for i, half in enumerate(halves):
        kdir = tmp_path / f"ks{i}"
        run_compute(
            out_dir=str(kdir),
            files=[os.path.join(REFS, a + ".fa.gz") for a in half],
            opt=ComputeOptions(
                ks=[21], split_number=10, split_overlap=150,
                ref_name_regexp=r"^([\w\.\_]+\.\d+)",
                seq_name_filter=["plasmid"],
            ),
            force=True, verbose=False,
        )
        db = tmp_path / f"shard{i}.db"
        run_index(in_dir=str(kdir), out_dir=str(db), num_hashes=1,
                  fpr=0.3, force=True, verbose=False)
        dbs.append(str(db))

    fq, truth = simulate_reads(tmp_path)
    shard_tsvs = []
    for i, db in enumerate(dbs):
        t = tmp_path / f"shard{i}.tsv"
        run_cli("-q", "search", "-d", db, str(fq), "-o", str(t))
        shard_tsvs.append(str(t))
    merged = tmp_path / "merged.tsv"
    run_cli("-q", "merge", *shard_tsvs, "-o", str(merged))

    kprofile = tmp_path / "cluster.kmcp.profile"
    run_cli(
        "-q", "profile", "-T", taxid_map, "-X", TAXDUMP, "-m", "1",
        str(merged), "-o", str(kprofile), "-s", "0",
    )
    rows = {}
    with open(kprofile) as f:
        f.readline()
        for line in f:
            parts = line.rstrip("\n").split("\t")
            rows[parts[0]] = float(parts[1])
    assert set(rows) == set(DEPTHS), (
        f"missing: {set(DEPTHS) - set(rows)}, extra: {set(rows) - set(DEPTHS)}"
    )
    for acc, expect_pct in truth.items():
        assert abs(rows[acc] - expect_pct) < 1.5, (acc, rows[acc], expect_pct)


@pytest.mark.skipif(not reference_available(), reason="reference repo absent")
def test_fast_profiler_equals_reference_engine(demo_db, taxid_map, tmp_path):
    """The vectorized profiler must reproduce the loop-based
    reference-faithful engine to float precision."""
    from kmcp_tpu.profile.core import Profiler, ProfileOptions, parse_search_tsv
    from kmcp_tpu.profile.fast import FastProfiler
    from kmcp_tpu.profile.taxonomy import Taxonomy, load_taxid_map

    fq, _ = simulate_reads(tmp_path)
    tsv = tmp_path / "m.tsv.gz"
    run_cli("-q", "search", "-d", demo_db, str(fq), "-o", str(tsv))

    taxmap = load_taxid_map([taxid_map])
    taxdb = Taxonomy(TAXDUMP)
    opt = ProfileOptions(mode=1)
    parsed = parse_search_tsv([str(tsv)], opt.max_fpr, opt.min_qcov)
    ref = Profiler(opt, taxdb, taxmap).run(parsed)
    fast = FastProfiler(opt, taxdb, taxmap).run(parsed)
    ra = {t.name: t for t in ref}
    fa = {t.name: t for t in fast}
    assert set(ra) == set(fa)
    for name in ra:
        r, f = ra[name], fa[name]
        for field in ("percentage", "coverage", "sum_match", "sum_uniq",
                      "sum_uniq_hic", "frags_prop", "rel_depth_std"):
            rv, fv = getattr(r, field), getattr(f, field)
            assert abs(rv - fv) <= 1e-9 * max(abs(rv), 1.0), (name, field)
        assert r.taxid == f.taxid
        assert [round(x, 9) for x in r.rel_depth] == pytest.approx(
            [round(x, 9) for x in f.rel_depth]
        )

    # the native columnar parser must feed the fast engine identically
    from kmcp_tpu.profile.fast import FlatInput, flat_from_files

    flat = flat_from_files([str(tsv)], opt.max_fpr, opt.min_qcov)
    if flat is not None:  # native lib available
        import numpy as np

        f2 = FlatInput(parsed)
        assert flat.target_names == f2.target_names
        for a in ("group", "target", "frag", "qlen", "qcov", "idx_num",
                  "gsize", "row_tf", "gt_msize"):
            assert np.array_equal(getattr(flat, a), getattr(f2, a)), a
        assert flat.total_queries == f2.total_queries
        nat = FastProfiler(opt, taxdb, taxmap).run(flat)
        na = {t.name: t for t in nat}
        assert set(na) == set(fa)
        for name in fa:
            assert na[name].percentage == fa[name].percentage

        # columnar binning == row-group binning
        flat_q = flat_from_files(
            [str(tsv)], opt.max_fpr, opt.min_qcov, keep_queries=True
        )
        fp = FastProfiler(opt, taxdb, taxmap)
        nat2 = fp.run(flat_q)
        bin_flat = list(fp.binning(flat_q, nat2))
        fp2 = FastProfiler(opt, taxdb, taxmap)
        fp2.run(parsed)
        bin_rows = list(fp2.binning(parsed, fast))
        assert bin_flat == bin_rows


@pytest.mark.skipif(not reference_available(), reason="reference repo absent")
@pytest.mark.parametrize(
    "optkw",
    [
        dict(mode=0),  # pathogen detection: keep_main=True (PRESETS[0])
        dict(mode=1, keep_perfect_matches=True),
        dict(mode=1, keep_top_qcovs=2),
        dict(mode=0, keep_top_qcovs=1, level="strain"),
    ],
    ids=["mode0-keep-main", "keep-perfect", "top-qcovs", "mode0-topn-strain"],
)
def test_fast_profiler_prefilters_equal_reference(
    demo_db, taxid_map, tmp_path, optkw
):
    """The vectorized prefix-cut pre-filters (keep-main / keep-perfect /
    keep-top-qcovs, profile.go:878-919) must reproduce the loop engine
    float-for-float — preset mode 0 included (VERDICT r1 item 6)."""
    from kmcp_tpu.profile.core import Profiler, ProfileOptions, parse_search_tsv
    from kmcp_tpu.profile.fast import FastProfiler
    from kmcp_tpu.profile.taxonomy import Taxonomy, load_taxid_map

    fq, _ = simulate_reads(tmp_path)
    tsv = tmp_path / "m.tsv.gz"
    run_cli("-q", "search", "-d", demo_db, str(fq), "-o", str(tsv))

    taxmap = load_taxid_map([taxid_map])
    taxdb = Taxonomy(TAXDUMP)
    opt = ProfileOptions(**optkw)
    parsed = parse_search_tsv([str(tsv)], opt.max_fpr, opt.min_qcov)
    ref = Profiler(opt, taxdb, taxmap).run(parsed)
    fast = FastProfiler(opt, taxdb, taxmap).run(parsed)
    assert ref, "reference engine found no targets (bad fixture)"
    ra = {t.name: t for t in ref}
    fa = {t.name: t for t in fast}
    assert set(ra) == set(fa)
    for name in ra:
        r, f = ra[name], fa[name]
        for field in ("percentage", "coverage", "sum_match", "sum_uniq",
                      "sum_uniq_hic", "frags_prop", "rel_depth_std",
                      "score"):
            rv, fv = getattr(r, field), getattr(f, field)
            assert abs(rv - fv) <= 1e-9 * max(abs(rv), 1.0), (name, field)
    # result order (the output sort) must agree too
    assert [t.name for t in ref] == [t.name for t in fast]

    # binning with pre-filters: flat path == object path
    from kmcp_tpu.profile.fast import flat_from_files

    flat_q = flat_from_files(
        [str(tsv)], opt.max_fpr, opt.min_qcov, keep_queries=True
    )
    if flat_q is not None:
        fp = FastProfiler(opt, taxdb, taxmap)
        nat = fp.run(flat_q)
        bin_flat = list(fp.binning(flat_q, nat))
        refp = Profiler(opt, taxdb, taxmap)
        refp.run(parsed)
        bin_ref = list(refp.binning(parsed, ref))
        assert bin_flat == bin_ref


@pytest.mark.skipif(not reference_available(), reason="reference repo absent")
def test_profile_debug_trace(demo_db, taxid_map, tmp_path):
    """--debug writes the reference's per-target rejection trace
    (profile.go:206-223, 1005-1095): round headers, failedN lines with
    reasons, per-iteration Abundance blocks."""
    fq, _ = simulate_reads(tmp_path)
    tsv = tmp_path / "m.tsv.gz"
    run_cli("-q", "search", "-d", demo_db, str(fq), "-o", str(tsv))
    kprofile = tmp_path / "m.profile"
    dbg = tmp_path / "m.debug"
    run_cli(
        "-q", "profile", "-T", taxid_map, "-X", TAXDUMP, "-m", "3",
        str(tsv), "-o", str(kprofile), "--debug", str(dbg),
    )
    text = open(dbg).read()
    assert "#------------------ round 1 ------------------" in text
    assert "#------------------ round 2 ------------------" in text
    assert ("#------------------ round 3: initialization step "
            "------------------") in text
    assert "Abundance:\n" in text
    # mode 3 rejects the low-abundance refs with reasoned lines
    import re

    failed = re.findall(r"^failed\d: (\S+) \(([^)]*)\), 90th percentile: "
                        r"\d+\.\d\d, (.+): ", text, flags=re.M)
    assert failed, "no rejection lines in debug trace"
    reasons = {f[2] for f in failed}
    assert reasons <= {
        "no enough unique match",
        "no enough high-confidence unique match",
        "no enough high-confidence unique match proportion",
        "low chunks fraction",
        "high FragsDepthStdev",
    }
    # the debug run must not change the profile itself (engine parity is
    # covered above; here: the file parses and contains the majors)
    with open(kprofile) as f:
        rows = [l.split("\t") for l in f.read().splitlines()[1:]]
    assert any(r[0] == "GCF_003697165.2" for r in rows)
    # convergence message appears when EM stopped early
    if "stop iterating" in text:
        assert "stop iterating after abundances being converged" in text


@pytest.mark.skipif(not reference_available(), reason="reference repo absent")
def test_spilled_profiler_identical(demo_db, taxid_map, tmp_path, monkeypatch):
    """--low-mem (profile/spill.py) must produce byte-identical profile +
    CAMI outputs to the in-memory engine, across many tiny chunks whose
    boundaries split query groups (the fuse path)."""
    from kmcp_tpu.kmer import native

    if native.get_lib() is None:
        pytest.skip("native library unavailable")
    fq, _ = simulate_reads(tmp_path)
    tsv = tmp_path / "m.tsv.gz"
    run_cli("-q", "search", "-d", demo_db, str(fq), "-o", str(tsv))

    outs = {}
    for mode in ("mem", "spill"):
        prof = tmp_path / f"{mode}.profile"
        cami = tmp_path / f"{mode}.cami"
        args = [
            "-q", "profile", "-T", taxid_map, "-X", TAXDUMP, "-m", "1",
            str(tsv), "-o", str(prof), "-C", str(cami), "-s", "s1",
        ]
        if mode == "spill":
            # 64 KB chunks: hundreds of chunks, many mid-group splits
            monkeypatch.setenv("KMCP_TPU_PARSE_CHUNK", str(64 << 10))
            args.append("--low-mem")
        else:
            monkeypatch.delenv("KMCP_TPU_PARSE_CHUNK", raising=False)
        run_cli(*args)
        # the command suffixes CAMI reports with .profile (reference
        # behavior)
        outs[mode] = (
            prof.read_text(),
            (tmp_path / f"{mode}.cami.profile").read_text(),
        )
    assert outs["mem"][0] == outs["spill"][0]
    assert outs["mem"][1] == outs["spill"][1]


def test_spilled_profiler_bounded_rss(tmp_path):
    """A synthetic wide input profiles under --low-mem with memory
    bounded by the chunk size, not the row count.  Peak is measured
    with tracemalloc (numpy allocations route through it), NOT
    ru_maxrss, which also counts whatever native libraries the
    interpreter loaded.  (2M rows here; the structural guarantee —
    only chunk-sized transients — is what scales to 1B rows.)"""
    import subprocess
    import sys as _sys

    from kmcp_tpu.kmer import native

    if native.get_lib() is None:
        pytest.skip("native library unavailable")
    tsv = tmp_path / "big.tsv"
    rng = np.random.default_rng(3)
    n_targets, chunks = 40, 10
    with open(tsv, "w") as f:
        f.write("#query\tqLen\tqKmers\tFPR\thits\ttarget\tchunkIdx\t"
                "chunks\ttLen\tkSize\tmKmers\tqCov\ttCov\tjacc\tqueryIdx\n")
        qi = 0
        for i in range(1_000_000):
            hits = 2 if i % 7 == 0 else 1
            for h in range(hits):
                t = int(rng.integers(0, n_targets))
                f.write(
                    f"r{qi}\t150\t130\t1.0e-10\t{hits}\tT{t:03d}\t"
                    f"{int(rng.integers(0, chunks))}\t{chunks}\t1000000\t"
                    f"21\t{int(rng.integers(80, 130))}\t"
                    f"0.{int(rng.integers(5600, 9999)):04d}\t0.0010\t"
                    f"0.0010\t{qi}\n"
                )
            qi += 1
        f.write(f"# input queries: {qi}\n")
        f.write(f"# matched queries: {qi}\n")
    child = (
        "import tracemalloc, sys\n"
        "sys.path.insert(0, %r)\n"
        "from kmcp_tpu.cli import main\n"
        "tracemalloc.start()\n"
        "sys.argv = ['kmcp-tpu', '-q', 'profile', '--level', 'strain',"
        " '-m', '1', '--low-mem', %r, '-o', %r]\n"
        "main()\n"
        "print('PEAK_KB', tracemalloc.get_traced_memory()[1] // 1024)\n"
    ) % (str(ROOT), str(tsv), str(tmp_path / "big.profile"))
    env = dict(os.environ, KMCP_TPU_PARSE_CHUNK=str(4 << 20))
    r = subprocess.run(
        [_sys.executable, "-c", child], env=env, capture_output=True,
        text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    peak_kb = int(r.stdout.split("PEAK_KB")[1].split()[0])
    # ~1.2M rows in 4 MB chunks: transients stay chunk-sized.  The
    # in-memory engine's columns + factorize transients alone exceed
    # this ceiling at these row counts; at 1B rows they'd need ~50 GB.
    assert peak_kb < 150_000, peak_kb
    assert (tmp_path / "big.profile").read_text().count("\n") > 1


def test_spilled_profiler_group_spanning_blocks(tmp_path):
    """A query group larger than the parse block must NOT split across
    spill chunks (it would double-count the group — caught by round-5
    self-review, reproduced before the fix: n_reads 5.0 vs 3.0)."""
    from kmcp_tpu.kmer import native

    if native.get_lib() is None:
        pytest.skip("native library unavailable")
    tsv = tmp_path / "wide.tsv"
    with open(tsv, "w") as f:
        f.write("#query\tqLen\tqKmers\tFPR\thits\ttarget\tchunkIdx\t"
                "chunks\ttLen\tkSize\tmKmers\tqCov\ttCov\tjacc\tqueryIdx\n")
        # q0: small; q1: 400 rows (spans many 8 KB parse blocks); q2: small
        rows = [("q0", 3), ("q1", 400), ("q2", 3)]
        for qi, (qid, n) in enumerate(rows):
            for j in range(n):
                f.write(
                    f"{qid}\t150\t130\t1.0e-10\t{n}\tT{j % 37:03d}\t"
                    f"{j % 10}\t10\t1000000\t21\t100\t0.9000\t0.0010\t"
                    f"0.0010\t{qi}\n"
                )
        f.write("# input queries: 3\n# matched queries: 3\n")

    outs = {}
    for mode, extra, env in (
        ("mem", [], {}),
        ("spill", ["--low-mem"], {"KMCP_TPU_PARSE_CHUNK": str(8 << 10)}),
    ):
        out = tmp_path / f"{mode}.profile"
        for k, v in env.items():
            os.environ[k] = v
        try:
            run_cli("-q", "profile", "--level", "strain", "-m", "1",
                    *extra, str(tsv), "-o", str(out))
        finally:
            for k in env:
                os.environ.pop(k, None)
        outs[mode] = out.read_text()
    assert outs["mem"] == outs["spill"]
