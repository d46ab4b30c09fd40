"""Unit tests: Bloom sizing/locations, FPR math, kset roundtrip, block
partitioning, count kernels (numpy vs jax vs brute force), engine
semantics (thresholds, sorting, top-N quirk, multi-DB intersection)."""

import math
import os

import numpy as np
import pytest

from kmcp_tpu.index.sizing import (
    calc_fpr,
    calc_signature_size,
    hash_locations,
    hash_values,
)
from kmcp_tpu.index.build import (
    build_block_bits,
    default_block_size,
    order_block_targets,
    partition_blocks,
)
from kmcp_tpu.kmer.kset import KsetFileInfo, KsetMeta, read_kset, write_kset
from kmcp_tpu.search.fpr import QueryFPRCache, binomial_coeff, query_fpr
from kmcp_tpu.search.kernel import (
    count_matches_numpy,
    derive_locations,
    make_jax_counter,
)
from kmcp_tpu.search.engine import Match, _top_n_scores, SearchEngine

RNG = np.random.default_rng(7)


# ------------------------------------------------------------------ sizing


def test_calc_signature_size_formula():
    # f = ceil(-h/ln(1-fpr^(1/h)) * n)  (util-hash.go:42-50)
    assert calc_signature_size(300000, 1, 0.25) == math.ceil(
        -1 / math.log(1 - 0.25) * 300000
    )
    assert calc_signature_size(1000, 3, 0.01) == math.ceil(
        -3 / math.log(1 - 0.01 ** (1 / 3)) * 1000
    )


def test_calc_fpr_monotone():
    s = calc_signature_size(1000, 1, 0.3)
    assert calc_fpr(1000, 1, s) <= 0.3 + 1e-9
    assert calc_fpr(500, 1, s) < calc_fpr(1000, 1, s)


def test_hash_values_uint32_wrap():
    h = np.array([0xFFFFFFFF_FFFFFFFE], dtype=np.uint64)
    v = hash_values(h, 3)
    a, b = 0xFFFFFFFF, 0xFFFFFFFE
    expect = [(a + b * i) & 0xFFFFFFFF for i in range(3)]
    assert v[0].tolist() == expect


def test_hash_locations_mod():
    h = RNG.integers(0, 2**63, 100, dtype=np.uint64)
    locs = hash_locations(h, 1, 12345)
    assert (locs[:, 0] == h % 12345).all()


# -------------------------------------------------------------------- fpr


def test_query_fpr_values():
    # closed forms: k=0 -> 1 - (1-p)^n
    p = 0.3
    for n in (10, 50):
        assert query_fpr(n, 0, p) == pytest.approx(1 - (1 - p) ** n, abs=1e-12)
    # k=n -> p^n (tail beyond all-matched)
    assert query_fpr(5, 5, p) == pytest.approx(0.0, abs=1e-12)
    # monotone decreasing in k
    vals = [query_fpr(100, k, p) for k in range(0, 100, 10)]
    assert all(a >= b - 1e-15 for a, b in zip(vals, vals[1:]))


def test_query_fpr_cache_matches_direct():
    c = QueryFPRCache(0.3, 249)
    for n, k in [(131, 70), (131, 80), (260, 150), (10, 3)]:
        assert c(n, k) == query_fpr(n, k, 0.3)


def test_binomial_coeff():
    assert binomial_coeff(10, 3) == 120.0
    assert binomial_coeff(100, 50) == pytest.approx(
        float(math.comb(100, 50)), rel=1e-12
    )


# -------------------------------------------------------------------- kset


def test_kset_roundtrip(tmp_path):
    h = np.unique(RNG.integers(1, 2**64 - 1, 1000, dtype=np.uint64))
    meta = KsetMeta(ks=[21], seq_id="x", frag_idx=3, genome_size=99)
    p = str(tmp_path / "a.kset")
    write_kset(p, h, meta)
    h2, meta2 = read_kset(p)
    assert (np.asarray(h2) == h).all()
    assert meta2.seq_id == "x" and meta2.frag_idx == 3 and meta2.genome_size == 99


# --------------------------------------------------------------- partition


def _infos(kmer_counts):
    return [
        KsetFileInfo(path=f"f{i}", name=f"n{i}", index=0, indexes=1,
                     kmers=c, genome_size=c)
        for i, c in enumerate(kmer_counts)
    ]


def test_default_block_size():
    assert default_block_size(150, 40) == 8
    assert default_block_size(9, 40) == 8
    assert default_block_size(9, 1) == 9
    assert default_block_size(1000, 16) == 64


def test_partition_simple():
    blocks = partition_blocks(_infos([10] * 150), threads=40)
    assert [len(b) for b in blocks] == [8] * 18 + [6]
    blocks = partition_blocks(_infos([10] * 9), threads=40)
    assert [len(b) for b in blocks] == [8, 1]


def test_partition_big_files_tiering():
    # 20 small + 2 above -x (10M) + 1 above -8 (20M) + 1 above -1 (200M)
    counts = [100] * 20 + [11_000_000, 12_000_000] + [30_000_000] + [300_000_000]
    blocks = partition_blocks(_infos(counts), block_size=16, block_size_x=4)
    sizes = [sorted(i.kmers for i in b) for b in blocks]
    # small files fill blocks of 16; the -x tier files in blocks of 4;
    # the -8 file in blocks of 8; the -1 file alone
    assert sizes[0] == [100] * 16
    assert sizes[1] == [100] * 4
    assert [11_000_000, 12_000_000] in sizes
    assert [30_000_000] in sizes
    assert [300_000_000] in sizes


def test_order_block_targets_name_sorted_per_8():
    infos = _infos([1] * 10)
    for i, inf in enumerate(infos):
        inf.name = f"z{9-i}"
    ordered = order_block_targets(infos)
    assert [o.name for o in ordered[:8]] == sorted(i.name for i in infos[:8])
    assert [o.name for o in ordered[8:]] == sorted(i.name for i in infos[8:])


# ------------------------------------------------------------------ kernel


def _brute_counts(bits, hashes, mask, num_hashes):
    S, W = bits.shape
    B, K = hashes.shape
    T = W * 32
    out = np.zeros((B, T), dtype=np.int32)
    locs = derive_locations(hashes, num_hashes, S)
    for b in range(B):
        for k in range(K):
            if not mask[b, k]:
                continue
            for t in range(T):
                hit = all(
                    (bits[locs[b, k, j], t // 32] >> (t % 32)) & 1
                    for j in range(num_hashes)
                )
                out[b, t] += hit
    return out


@pytest.mark.parametrize("num_hashes", [1, 3])
def test_count_kernel_vs_brute(num_hashes):
    S, W = 997, 2
    bits = RNG.integers(0, 2**32, (S, W), dtype=np.uint32)
    B, K = 4, 17
    hashes = RNG.integers(1, 2**63, (B, K), dtype=np.uint64)
    mask = RNG.random((B, K)) > 0.2
    got = count_matches_numpy(bits, hashes, mask, num_hashes)
    want = _brute_counts(bits, hashes, mask, num_hashes)
    assert (got == want).all()


@pytest.mark.parametrize("num_hashes", [1, 2])
def test_jax_kernel_matches_numpy(num_hashes):
    import jax.numpy as jnp

    S, W = 1543, 3
    bits = RNG.integers(0, 2**32, (S, W), dtype=np.uint32)
    B, K = 6, 33
    hashes = RNG.integers(1, 2**63, (B, K), dtype=np.uint64)
    mask = RNG.random((B, K)) > 0.3
    want = count_matches_numpy(bits, hashes, mask, num_hashes)
    fn = make_jax_counter(num_hashes)
    loc = derive_locations(hashes, num_hashes, S).astype(np.int32)
    got = np.asarray(fn(jnp.asarray(bits), jnp.asarray(loc), jnp.asarray(mask)))
    assert (got == want).all()


def test_build_block_bits_sets_expected_bits(tmp_path):
    h = np.array([5, 17, 100003], dtype=np.uint64)
    p = str(tmp_path / "t.kset")
    write_kset(p, h, KsetMeta(ks=[21]))
    info = KsetFileInfo(path=p, name="t", index=0, indexes=1, kmers=3,
                        genome_size=10)
    num_sigs = 101
    bits = build_block_bits([info, info], num_sigs, 1)
    locs = (h % np.uint64(num_sigs)).astype(int)
    for loc in locs:
        assert bits[loc, 0] & 1
        assert bits[loc, 0] & 2
    assert bits.sum() == len(set(locs.tolist())) * 3


# ------------------------------------------------------------------ engine


def _m(qcov, tcov=0.0, jacc=0.0, nk=0):
    return Match(target="t", chunk_idx=0, chunks=1, gsize=1,
                 num_kmers=nk, fpr=0.0, qcov=qcov, tcov=tcov, jacc=jacc)


def test_top_n_scores_quirk():
    ms = [_m(0.9), _m(0.8), _m(0.8), _m(0.7)]
    # n=1: keeps the 0.9 group plus the first element of the next distinct
    # score group — the reference's exact loop behavior
    assert [m.qcov for m in _top_n_scores(ms, 1, "qcov")] == [0.9, 0.8]
    # n=2: scanning hits 0.7 (3rd distinct) at index 3 -> keep [:4]
    assert len(_top_n_scores(ms, 2, "qcov")) == 4
    assert len(_top_n_scores(ms, 0, "qcov")) == 4
    assert len(_top_n_scores(ms, 5, "qcov")) == 4


def test_intersect_dbs():
    a = [Match("x", 0, 1, 10, 50, 1e-9, 0.9, 0.5, 0.4, ) if False else
         Match(target="x", chunk_idx=0, chunks=1, gsize=10, num_kmers=50,
               fpr=1e-9, qcov=0.9, tcov=0.5, jacc=0.4),
         Match(target="y", chunk_idx=1, chunks=2, gsize=10, num_kmers=30,
               fpr=1e-9, qcov=0.6, tcov=0.3, jacc=0.2)]
    b = [Match(target="x", chunk_idx=0, chunks=1, gsize=10, num_kmers=40,
               fpr=1e-8, qcov=0.8, tcov=0.45, jacc=0.35)]
    out = SearchEngine._intersect_dbs([a, b])
    assert len(out) == 1
    m = out[0]
    # qcov/tcov/jacc updated from the smaller-count DB; num_kmers/fpr kept
    assert m.qcov == 0.8 and m.num_kmers == 50 and m.fpr == 1e-9
    # no-match results arrive as None (never an empty list)
    assert SearchEngine._intersect_dbs([a, []]) is None
    assert SearchEngine._intersect_dbs([a, None]) is None


def test_sharded_device_search_matches_host(tmp_path):
    """Production sharded search step over the 8-CPU (d, t) mesh equals
    the host reference engine (full thresholds + compaction)."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "graft_entry",
        os.path.join(os.path.dirname(os.path.dirname(__file__)),
                     "__graft_entry__.py"),
    )
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    m.dryrun_multichip(8)


def test_stream_budget_overflow_retry(tmp_path):
    """The drain's 4x-budget retry loop must preserve byte parity when
    a batch's candidate count exceeds the device budget (2 slots/read).
    Eight near-identical genomes make every read match 8+ targets —
    forcing the overflow path that production reads only hit in the
    tail (stream.py::drain `while qi is None`)."""
    from kmcp_tpu.kmer import native as _nat

    if _nat.get_lib() is None:
        pytest.skip("native library unavailable (streaming needs it)")
    import io

    from kmcp_tpu.commands.compute import ComputeOptions, run_compute
    from kmcp_tpu.index.build import run_index
    from kmcp_tpu.search.engine import SearchEngine, SearchOptions
    from kmcp_tpu.search.stream import StreamSearcher
    from kmcp_tpu.search.tsv import write_results

    rng = np.random.default_rng(17)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    base_seq = bytearray(rng.choice(bases, size=20000).tobytes())
    files = []
    for g in range(8):
        seq = bytearray(base_seq)
        # a few point mutations so targets are distinct but every read
        # still matches all 8 copies
        for pos in rng.integers(0, len(seq), size=5):
            seq[pos] = bases[int(rng.integers(0, 4))]
        p = tmp_path / f"g{g}.fa"
        p.write_text(f">g{g}\n{bytes(seq).decode()}\n")
        files.append(str(p))
    run_compute(
        out_dir=str(tmp_path / "ks"), files=files,
        opt=ComputeOptions(ks=[21], split_number=2, split_overlap=100),
        force=True,
    )
    run_index(
        in_dir=str(tmp_path / "ks"), out_dir=str(tmp_path / "db"),
        num_hashes=1, fpr=0.3, force=True, tpu_native=True,
    )

    reads = []
    for i in range(200):
        p = int(rng.integers(0, len(base_seq) - 150))
        reads.append((f"r{i}", bytes(base_seq[p : p + 150]), None))

    opt_np = SearchOptions(backend="numpy")
    buf1 = io.StringIO()
    res = SearchEngine([str(tmp_path / "db")], opt_np).search_batch(
        reads, 0
    )
    # every read must indeed exceed the 2-slots/read device budget
    assert min(len(r.matches) for r in res) >= 8
    write_results(buf1, res, False)

    for backend in ("host", "jax"):
        opt = SearchOptions(backend=backend, batch_size=64)
        eng = SearchEngine([str(tmp_path / "db")], opt)
        assert StreamSearcher.usable(eng)
        buf2 = io.StringIO()
        total, _ = StreamSearcher(eng).run(iter(reads), buf2)
        assert total == 200
        assert buf1.getvalue() == buf2.getvalue(), backend


def test_stream_path_with_mixed_read_lengths(tmp_path):
    """Streaming device path (on CPU) must stay byte-identical to the
    general engine path, including >dedup-threshold reads routed through
    the slow path and interleaved by the segmented native writer."""
    from kmcp_tpu.kmer import native as _nat

    if _nat.get_lib() is None:
        pytest.skip("native library unavailable (streaming needs it)")
    import io

    from kmcp_tpu.commands.compute import ComputeOptions, run_compute
    from kmcp_tpu.index.build import run_index
    from kmcp_tpu.search.engine import SearchEngine, SearchOptions
    from kmcp_tpu.search.stream import StreamSearcher
    from kmcp_tpu.search.tsv import write_results

    rng = np.random.default_rng(11)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genomes = []
    for g in range(4):
        seq = rng.choice(bases, size=30000).tobytes()
        p = tmp_path / f"g{g}.fa"
        p.write_text(f">g{g}\n{seq.decode()}\n")
        genomes.append(seq)
    run_compute(out_dir=str(tmp_path / "ks"), files=[str(tmp_path / f"g{g}.fa") for g in range(4)],
                opt=ComputeOptions(ks=[21], split_number=3, split_overlap=100), force=True)
    run_index(in_dir=str(tmp_path / "ks"), out_dir=str(tmp_path / "db"),
              num_hashes=1, fpr=0.3, force=True, tpu_native=True)

    reads = []
    for i in range(300):
        g = genomes[int(rng.integers(0, 4))]
        if i % 37 == 0:  # long read > dedup threshold (256 k-mers)
            ln = 600
        elif i % 11 == 0:  # too-short read
            ln = 20
        else:
            ln = 150
        p = int(rng.integers(0, len(g) - ln))
        reads.append((f"r{i}", g[p : p + ln], None))

    opt_np = SearchOptions(backend="numpy", keep_unmatched=False)
    eng_np = SearchEngine([str(tmp_path / "db")], opt_np)
    buf1 = io.StringIO()
    write_results(buf1, eng_np.search_batch(reads, 0), False)

    opt_j = SearchOptions(backend="jax", batch_size=128)
    eng_j = SearchEngine([str(tmp_path / "db")], opt_j)
    assert StreamSearcher.usable(eng_j)
    st = StreamSearcher(eng_j)
    buf2 = io.StringIO()
    total, matched = st.run(iter(reads), buf2)
    assert total == 300
    assert buf1.getvalue() == buf2.getvalue()


def _tiny_db(tmp_path, ks, rng_seed=5, n_genomes=3, glen=20000, fpr=0.3):
    from kmcp_tpu.commands.compute import ComputeOptions, run_compute
    from kmcp_tpu.index.build import run_index

    rng = np.random.default_rng(rng_seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genomes = []
    for g in range(n_genomes):
        seq = rng.choice(bases, size=glen).tobytes()
        (tmp_path / f"g{g}.fa").write_text(f">g{g}\n{seq.decode()}\n")
        genomes.append(seq)
    run_compute(
        out_dir=str(tmp_path / "ks"),
        files=[str(tmp_path / f"g{g}.fa") for g in range(n_genomes)],
        opt=ComputeOptions(ks=ks, split_number=2, split_overlap=50),
        force=True,
    )
    run_index(in_dir=str(tmp_path / "ks"), out_dir=str(tmp_path / "db"),
              num_hashes=1, fpr=fpr, force=True)
    return str(tmp_path / "db"), genomes


def test_paired_end_and_try_se(tmp_path):
    """Paired mates hash into one k-mer set; --try-se retries failing
    pairs as single ends (util-db-search.go:800-868)."""
    from kmcp_tpu.search.engine import SearchEngine, SearchOptions

    db, genomes = _tiny_db(tmp_path, [21], fpr=0.01)
    g = genomes[0]
    r1, r2 = g[1000:1150], g[3000:3150]
    junk = bytes(np.random.default_rng(1).choice(
        np.frombuffer(b"ACGT", dtype=np.uint8), size=150))

    eng = SearchEngine([db], SearchOptions(paired_fpr_buf=True))
    res = eng.search_batch([("p", r1, r2)], 0)[0]
    assert res.matches
    # qKmers counts both mates' k-mers
    assert res.num_kmers == 260
    assert res.query_len == 300

    # read1 matches, read2 is junk: as a pair the combined qcov is diluted
    # below the threshold -> no hits without try-se
    eng2 = SearchEngine([db], SearchOptions())
    res = eng2.search_batch([("p", r1, junk)], 0)[0]
    assert not res.matches
    eng3 = SearchEngine([db], SearchOptions(try_se=True))
    res = eng3.search_batch([("p", r1, junk)], 0)[0]
    assert res.matches  # retried as read1-only
    assert res.query_len == 150  # reflects the single-end retry


def test_multi_k_fallback(tmp_path):
    """ks are tried in descending order; unmatched queries retry with the
    smaller k (util-db-search.go:755-764,1018-1024)."""
    from kmcp_tpu.search.engine import SearchEngine, SearchOptions

    db, genomes = _tiny_db(tmp_path, [21, 31])
    g = genomes[0]
    # a clean read matches at k=31 directly
    eng = SearchEngine([db], SearchOptions())
    res = eng.search_batch([("a", g[500:650], None)], 0)[0]
    assert res.matches and res.k == 31
    # mutate every ~25 bp: destroys most 31-mers, keeps some 21-mer runs
    read = bytearray(g[2000:2150])
    for p in range(5, 150, 25):
        read[p] = ord("A") if read[p] != ord("A") else ord("C")
    res = eng.search_batch([("b", bytes(read), None)], 0)[0]
    if res.matches:
        assert res.k in (21, 31)


@pytest.mark.parametrize("num_hashes", [1, 3])
def test_native_count_block_vs_oracle(num_hashes):
    from kmcp_tpu.kmer import native

    if native.get_lib() is None:
        pytest.skip("native lib unavailable")
    S, W = 997, 7
    bits = RNG.integers(0, 2**32, (S, W), dtype=np.uint32)
    bits_ext = np.concatenate([bits, np.zeros((1, W), np.uint32)])
    B, K = 17, 300  # K > 255 exercises the int8 widening chunks
    hashes = RNG.integers(1, 2**63, (B, K), dtype=np.uint64)
    mask = RNG.random((B, K)) > 0.25
    want = count_matches_numpy(bits, hashes, mask, num_hashes)
    loc = derive_locations(hashes, num_hashes, S).astype(np.int32)
    loc[~mask] = S
    got = native.count_block(bits_ext, loc, num_hashes)
    assert (got == want).all()


@pytest.mark.parametrize("S", [99991, 1400001, 4096, 3578, 65536])
def test_device_hash_matches_native(S):
    """The device ntHash (device_hash.make_hash_fn) is bit-identical to
    the C++ scanner for every modulus lowering (make_mod_pair: large
    generic fold, power of two, <= 65536 multiply, the 65536 edge),
    including N windows, lowercase and short reads; the screen plane
    follows the union modulus and the value planes equal the NumPy
    prefix-XOR oracle."""
    from kmcp_tpu.kmer import native
    from kmcp_tpu.kmer.nthash import _window_hashes, encode_seq
    from kmcp_tpu.search.device_hash import make_hash_fn

    if native.get_lib() is None:
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(13)
    bases = np.frombuffer(b"ACGTacgtN", dtype=np.uint8)
    B, L, k, S_u = 256, 64, 21, 1024
    reads = [
        rng.choice(bases, size=[64, 50, 25, 21][i % 4],
                   p=[0.118] * 8 + [0.056]).tobytes()
        for i in range(B)
    ]
    lens = np.array([len(r) for r in reads], dtype=np.int64)
    mat = native.pack_rows(reads, lens, L)
    loc_ref, counts_ref = native.hash_reads_loc(reads, k, L - k + 1, S, 1)
    locu_ref, _ = native.hash_reads_loc(reads, k, L - k + 1, S_u, 1)
    fn = make_hash_fn(k, L, S, (1 << 64) - 1, screen_sigs=S_u,
                      emit_values=True)
    loc_t, locu_t, nk, vhi, vlo = fn(mat)
    loc_p, locu_p = np.asarray(loc_t).T, np.asarray(locu_t).T
    nk = np.asarray(nk)[0]
    for i in range(B):
        for ref, got, sent in ((loc_ref, loc_p, S), (locu_ref, locu_p, S_u)):
            a = sorted(x for x in ref[i, :, 0].tolist() if x != sent)
            b = sorted(x for x in got[i].tolist() if x != sent)
            assert a == b, (i, sent)
        assert counts_ref[i] == nk[i], i
    got_v = (
        np.asarray(vhi).astype(np.uint64) << np.uint64(32)
    ) | np.asarray(vlo).astype(np.uint64)  # [K, B]
    for i in range(B):
        fh, rh, valid = _window_hashes(encode_seq(reads[i]), k)
        want = np.zeros(L - k + 1, dtype=np.uint64)
        h = np.minimum(fh, rh)
        want[: len(fh)][valid & (h != 0)] = h[valid & (h != 0)]
        np.testing.assert_array_equal(got_v[:, i], want, err_msg=str(i))

    # a 512-read batch: each half must equal the 256-read result
    loc512, nk512 = make_hash_fn(k, L, S, (1 << 64) - 1)(
        np.concatenate([mat, mat[::-1]])
    )
    np.testing.assert_array_equal(
        np.asarray(loc512),
        np.concatenate([np.asarray(loc_t), np.asarray(loc_t)[:, ::-1]], 1),
    )
    np.testing.assert_array_equal(
        np.asarray(nk512)[0], np.concatenate([nk, nk[::-1]])
    )


def test_stream_keep_top_scores_parity(tmp_path):
    """keep-top-scores in the stream python writer matches the engine's
    quirky truncation."""
    from kmcp_tpu.kmer import native as _nat

    if _nat.get_lib() is None:
        pytest.skip("native library unavailable (streaming needs it)")
    import io

    from kmcp_tpu.search.engine import SearchEngine, SearchOptions
    from kmcp_tpu.search.stream import StreamSearcher
    from kmcp_tpu.search.tsv import write_results

    db, genomes = _tiny_db(tmp_path, [21], n_genomes=4)
    rng = np.random.default_rng(2)
    reads = []
    for i in range(200):
        g = genomes[int(rng.integers(0, 4))]
        p = int(rng.integers(0, len(g) - 150))
        reads.append((f"r{i}", g[p : p + 150], None))

    opt_np = SearchOptions(backend="numpy", keep_top_scores=1)
    buf1 = io.StringIO()
    write_results(
        buf1, SearchEngine([db], opt_np).search_batch(reads, 0), False
    )
    opt_j = SearchOptions(backend="jax", keep_top_scores=1, batch_size=128)
    st = StreamSearcher(SearchEngine([db], opt_j))
    buf2 = io.StringIO()
    st.run(iter(reads), buf2)
    assert buf1.getvalue() == buf2.getvalue()


def test_stream_paired_parity(tmp_path):
    """Paired-end streaming (joined mate1+N+mate2 rows with in-kernel /
    in-step dedup of the >256-k-mer sets) must stay byte-identical to
    the object engine on BOTH streaming backends — host (C++ dedup) and
    the device path (value-sort dedup, device.py::_dedup_value_planes;
    exercised here through the CPU route, the same tail the GPU path
    shares) — including a junk mate, a
    short mate, and an empty mate (util-db-search.go:800-908
    semantics)."""
    from kmcp_tpu.kmer import native as _nat

    if _nat.get_lib() is None:
        pytest.skip("native library unavailable (streaming needs it)")
    import io

    from kmcp_tpu.search.engine import SearchEngine, SearchOptions
    from kmcp_tpu.search.stream import StreamSearcher
    from kmcp_tpu.search.tsv import write_results

    db, genomes = _tiny_db(tmp_path, [21], n_genomes=4, fpr=0.1)
    rng = np.random.default_rng(3)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    rc = bytes.maketrans(b"ACGT", b"TGCA")
    reads = []
    for i in range(300):
        g = genomes[int(rng.integers(0, 4))]
        p = int(rng.integers(0, len(g) - 500))
        r1 = g[p : p + 150]
        r2 = g[p + 200 : p + 350].translate(rc)[::-1]
        if i % 23 == 0:  # junk mate: random bases
            r2 = rng.choice(bases, size=150).tobytes()
        elif i % 31 == 0:  # short mate (< min_query_len but >= k)
            r2 = r2[:25]
        elif i % 41 == 0:  # empty mate
            r2 = b""
        reads.append((f"p{i}", r1, r2))

    opt_np = SearchOptions(backend="numpy")
    buf1 = io.StringIO()
    write_results(
        buf1, SearchEngine([db], opt_np).search_batch(reads, 0), False
    )

    opt_h = SearchOptions(backend="host", batch_size=128)
    eng_h = SearchEngine([db], opt_h)
    assert StreamSearcher.usable(eng_h, paired=True)
    st = StreamSearcher(eng_h)
    buf2 = io.StringIO()
    total, _ = st.run(iter(reads), buf2, paired=True)
    assert total == 300
    assert buf1.getvalue() == buf2.getvalue()

    # device backend: in-step value dedup
    opt_j = SearchOptions(backend="jax", batch_size=128)
    eng_j = SearchEngine([db], opt_j)
    assert StreamSearcher.usable(eng_j, paired=True)
    buf3 = io.StringIO()
    total, _ = StreamSearcher(eng_j).run(iter(reads), buf3, paired=True)
    assert total == 300
    assert buf1.getvalue() == buf3.getvalue()

    # try-se falls back to the object engine
    opt_se = SearchOptions(backend="host", try_se=True)
    assert not StreamSearcher.usable(SearchEngine([db], opt_se), paired=True)


def test_native_dedup_matches_numpy_unique(tmp_path):
    """In-kernel per-row dedup (hash_row sort+unique) equals np.unique of
    the raw hash multiset, for both the padded-hash and fused-loc paths."""
    from kmcp_tpu.kmer import native
    from kmcp_tpu.kmer.nthash import hash_reads_batch

    if native.get_lib() is None:
        import pytest

        pytest.skip("native library unavailable")

    rng = np.random.default_rng(9)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    # short repeated motif forces duplicate k-mers within one read
    motif = rng.choice(bases, size=40).tobytes()
    reads = [motif * 12, rng.choice(bases, size=500).tobytes(), b"ACGT" * 100]
    k = 21
    kmax = max(len(r) for r in reads) - k + 1

    H, M, counts = hash_reads_batch(reads, k, canonical=True)
    for thr in (0, 100):
        out, cnts = native.hash_reads_padded(
            reads, k, kmax, dedup_threshold=thr
        )
        for r in range(len(reads)):
            raw = H[r][M[r]]
            if thr and len(raw) > thr:
                want = np.unique(raw)
            else:
                want = raw
            assert cnts[r] == len(want)
            got = out[r, : cnts[r]]
            assert np.array_equal(np.sort(got), np.sort(want))

    S = 10007
    loc, cnts = native.hash_reads_loc(
        reads, k, kmax, S, 1, dedup_threshold=100
    )
    for r in range(len(reads)):
        raw = H[r][M[r]]
        want = np.unique(raw) if len(raw) > 100 else raw
        assert cnts[r] == len(want)
        got = loc[r, : cnts[r], 0]
        assert np.array_equal(
            np.sort(got), np.sort((want % S).astype(np.int32))
        )
        assert np.all(loc[r, cnts[r] :, :] == S)


def test_multihost_distributed_search():
    """Two real processes, each owning half the DB words, run the global
    (d, t) mesh step via jax.distributed + Gloo and match the
    single-process oracle (the reference's per-node sub-database +
    offline merge, as one SPMD program)."""
    import socket
    import subprocess
    import sys as _sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(repo, "tools", "multihost_worker.py")
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    procs = [
        subprocess.Popen(
            [_sys.executable, worker, str(i), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-2000:]}"
        assert f"proc {i}: OK" in out


def test_stream_minimizer_parity(tmp_path):
    """Minimizer-query streaming (host backend, C++ window-min selection)
    must stay byte-identical to the object engine's sketch path."""
    from kmcp_tpu.kmer import native as _nat

    if _nat.get_lib() is None:
        pytest.skip("native library unavailable (streaming needs it)")
    import io

    from kmcp_tpu.commands.compute import ComputeOptions, run_compute
    from kmcp_tpu.index.build import run_index
    from kmcp_tpu.search.engine import SearchEngine, SearchOptions
    from kmcp_tpu.search.stream import StreamSearcher
    from kmcp_tpu.search.tsv import write_results

    rng = np.random.default_rng(21)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genomes = []
    for g in range(3):
        seq = rng.choice(bases, size=40000).tobytes()
        p = tmp_path / f"g{g}.fa"
        p.write_text(f">g{g}\n{seq.decode()}\n")
        genomes.append(seq)
    run_compute(
        out_dir=str(tmp_path / "ks"),
        files=[str(tmp_path / f"g{g}.fa") for g in range(3)],
        opt=ComputeOptions(ks=[21], split_number=2, split_overlap=100,
                           minimizer_w=5),
        force=True,
    )
    run_index(in_dir=str(tmp_path / "ks"), out_dir=str(tmp_path / "db"),
              num_hashes=1, fpr=0.1, force=True)

    reads = []
    for i in range(250):
        g = genomes[int(rng.integers(0, 3))]
        ln = 500 if i % 17 == 0 else 150  # some longer reads
        p = int(rng.integers(0, len(g) - ln))
        r = bytearray(g[p : p + ln])
        if i % 29 == 0:
            r[len(r) // 2] = ord("N")
        reads.append((f"r{i}", bytes(r), None))

    opt_np = SearchOptions(backend="numpy", min_kmers=3)
    buf1 = io.StringIO()
    write_results(
        buf1, SearchEngine([str(tmp_path / "db")], opt_np).search_batch(
            reads, 0
        ), False,
    )

    opt_h = SearchOptions(backend="host", batch_size=128, min_kmers=3)
    eng = SearchEngine([str(tmp_path / "db")], opt_h)
    assert StreamSearcher.usable(eng)
    assert StreamSearcher.usable(eng, paired=True)  # per-mate rows
    st = StreamSearcher(eng)
    buf2 = io.StringIO()
    total, _ = st.run(iter(reads), buf2)
    assert total == 250
    assert buf1.getvalue() == buf2.getvalue()


def test_stream_syncmer_parity(tmp_path):
    """Closed-syncmer query streaming must stay byte-identical to the
    object engine's sketch path."""
    from kmcp_tpu.kmer import native as _nat

    if _nat.get_lib() is None:
        pytest.skip("native library unavailable (streaming needs it)")
    import io

    from kmcp_tpu.commands.compute import ComputeOptions, run_compute
    from kmcp_tpu.index.build import run_index
    from kmcp_tpu.search.engine import SearchEngine, SearchOptions
    from kmcp_tpu.search.stream import StreamSearcher
    from kmcp_tpu.search.tsv import write_results

    rng = np.random.default_rng(31)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genomes = []
    for g in range(3):
        seq = rng.choice(bases, size=40000).tobytes()
        p = tmp_path / f"g{g}.fa"
        p.write_text(f">g{g}\n{seq.decode()}\n")
        genomes.append(seq)
    run_compute(
        out_dir=str(tmp_path / "ks"),
        files=[str(tmp_path / f"g{g}.fa") for g in range(3)],
        opt=ComputeOptions(ks=[21], split_number=2, split_overlap=100,
                           syncmer_s=11),
        force=True,
    )
    run_index(in_dir=str(tmp_path / "ks"), out_dir=str(tmp_path / "db"),
              num_hashes=1, fpr=0.1, force=True)

    reads = []
    for i in range(200):
        g = genomes[int(rng.integers(0, 3))]
        p = int(rng.integers(0, len(g) - 150))
        r = bytearray(g[p : p + 150])
        if i % 23 == 0:
            r[70] = ord("N")
        reads.append((f"r{i}", bytes(r), None))

    opt_np = SearchOptions(backend="numpy", min_kmers=3)
    buf1 = io.StringIO()
    write_results(
        buf1, SearchEngine([str(tmp_path / "db")], opt_np).search_batch(
            reads, 0
        ), False,
    )
    opt_h = SearchOptions(backend="host", batch_size=128, min_kmers=3)
    eng = SearchEngine([str(tmp_path / "db")], opt_h)
    assert StreamSearcher.usable(eng)
    st = StreamSearcher(eng)
    buf2 = io.StringIO()
    st.run(iter(reads), buf2)
    assert buf1.getvalue() == buf2.getvalue()


@pytest.mark.parametrize("sketch", ["minimizer", "syncmer"])
def test_stream_paired_sketch_parity(tmp_path, sketch):
    """Paired sketch-query streaming (host backend, per-mate C++ sketch
    selection with row-pair merge) must stay byte-identical to the
    object engine's paired sketch path (engine.py:408-414 — each mate
    sketched alone, hash lists concatenated)."""
    from kmcp_tpu.kmer import native as _nat

    if _nat.get_lib() is None:
        pytest.skip("native library unavailable (streaming needs it)")
    import io

    from kmcp_tpu.commands.compute import ComputeOptions, run_compute
    from kmcp_tpu.index.build import run_index
    from kmcp_tpu.search.engine import SearchEngine, SearchOptions
    from kmcp_tpu.search.stream import StreamSearcher
    from kmcp_tpu.search.tsv import write_results

    rng = np.random.default_rng(47)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genomes = []
    for g in range(3):
        seq = rng.choice(bases, size=40000).tobytes()
        p = tmp_path / f"g{g}.fa"
        p.write_text(f">g{g}\n{seq.decode()}\n")
        genomes.append(seq)
    sk = (
        dict(minimizer_w=5) if sketch == "minimizer" else dict(syncmer_s=11)
    )
    run_compute(
        out_dir=str(tmp_path / "ks"),
        files=[str(tmp_path / f"g{g}.fa") for g in range(3)],
        opt=ComputeOptions(ks=[21], split_number=2, split_overlap=100, **sk),
        force=True,
    )
    run_index(in_dir=str(tmp_path / "ks"), out_dir=str(tmp_path / "db"),
              num_hashes=1, fpr=0.1, force=True)

    rc = bytes.maketrans(b"ACGT", b"TGCA")
    reads = []
    for i in range(250):
        g = genomes[int(rng.integers(0, 3))]
        p = int(rng.integers(0, len(g) - 500))
        r1 = g[p : p + 150]
        r2 = g[p + 200 : p + 350].translate(rc)[::-1]
        if i % 23 == 0:  # junk mate
            r2 = rng.choice(bases, size=150).tobytes()
        elif i % 31 == 0:  # short mate (< min_query_len but >= k)
            r2 = r2[:25]
        elif i % 41 == 0:  # empty mate
            r2 = b""
        elif i % 13 == 0:  # long pair: combined sketch may exceed dedup
            r1 = g[p : p + 450]
            r2 = g[p + 500 : p + 950].translate(rc)[::-1]
        reads.append((f"p{i}", r1, r2))

    opt_np = SearchOptions(
        backend="numpy", min_kmers=3, kmer_dedup_threshold=40,
        paired_fpr_buf=True,
    )
    buf1 = io.StringIO()
    write_results(
        buf1, SearchEngine([str(tmp_path / "db")], opt_np).search_batch(
            reads, 0
        ), False,
    )

    opt_h = SearchOptions(
        backend="host", batch_size=64, min_kmers=3,
        kmer_dedup_threshold=40, paired_fpr_buf=True,
    )
    eng = SearchEngine([str(tmp_path / "db")], opt_h)
    assert StreamSearcher.usable(eng, paired=True)
    st = StreamSearcher(eng)
    buf2 = io.StringIO()
    total, _ = st.run(iter(reads), buf2, paired=True)
    assert total == 250
    assert buf1.getvalue() == buf2.getvalue()


def test_device_two_pass_screen_matches_host(tmp_path):
    """The two-pass screened device search (device hash + the jitted
    screened tail) must produce exactly the host backend's candidate
    set on a multi-block screened DB — same (read, target, count)
    triples and the same per-read k-mer counts
    (device.py::_make_screened_tail) — and the CPU streams it."""
    from kmcp_tpu.kmer import native as _nat

    if _nat.get_lib() is None:
        pytest.skip("native library unavailable")

    from kmcp_tpu.commands.compute import ComputeOptions, run_compute
    from kmcp_tpu.index.build import run_index
    from kmcp_tpu.search.device import DeviceDB, HostDB, two_pass_ready
    from kmcp_tpu.search.engine import SearchEngine, SearchOptions
    from kmcp_tpu.search.stream import StreamSearcher, _unpack_result

    rng = np.random.default_rng(53)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genomes = []
    # unequal genome sizes: --uniform-sigs must still give one geometry
    for g, size in enumerate([30000, 42000, 36000, 30000]):
        seq = rng.choice(bases, size=size).tobytes()
        (tmp_path / f"g{g}.fa").write_text(f">g{g}\n{seq.decode()}\n")
        genomes.append(seq)
    run_compute(
        out_dir=str(tmp_path / "ks"),
        files=[str(tmp_path / f"g{g}.fa") for g in range(4)],
        opt=ComputeOptions(ks=[21], split_number=4, split_overlap=100),
        force=True,
    )
    db_dir = str(tmp_path / "db")
    run_index(
        in_dir=str(tmp_path / "ks"), out_dir=db_dir, num_hashes=1,
        fpr=0.3, force=True, tpu_native=True, native_block_targets=4,
        block_screen=True, uniform_sigs=True,
    )

    B = 256
    reads = []
    for i in range(B):
        if i % 5 == 4:  # junk read: tests the screen's skip path
            reads.append(rng.choice(bases, size=150).tobytes())
        elif i % 17 == 16:
            reads.append(b"ACGT")  # too short
        else:
            g = genomes[int(rng.integers(0, 4))]
            p = int(rng.integers(0, len(g) - 150))
            r = bytearray(g[p : p + 150])
            if i % 13 == 12:
                r[70] = ord("N")
            reads.append(bytes(r))
    lens = np.array([len(s) for s in reads], dtype=np.int64)
    lmax = 160
    mat = _nat.pack_rows(reads, lens, lmax)

    opt = SearchOptions(backend="jax", batch_size=B)
    eng = SearchEngine([db_dir], opt)
    db = eng.dbs[0]
    assert len(db.blocks) > 1
    assert two_pass_ready(db)
    assert StreamSearcher.usable(eng)

    budget = 8 * B
    T = None
    hd = HostDB(db, opt)
    T = hd.t_per_block * hd.n_blocks
    host_res = hd.search_reads_async(
        (B, lmax), lens, budget, seqs=reads,
        dedup_threshold=opt.kmer_dedup_threshold,
    )
    hn, hqi, ht, hcnt, hnk = _unpack_result(host_res, budget, B, T)
    hidx = np.asarray(hqi).astype(np.int64) * T + np.asarray(ht)

    dev = DeviceDB(db, opt)
    assert dev.screen is not None
    meta_aux = dev.search_reads(mat, lens, budget)
    dn, dqi, dt_, dcnt, dnk = _unpack_result(meta_aux, budget, B, T)
    didx = np.asarray(dqi).astype(np.int64) * T + np.asarray(dt_)

    assert dn == hn
    ho = np.argsort(hidx, kind="stable")
    do = np.argsort(didx, kind="stable")
    np.testing.assert_array_equal(didx[do], hidx[ho])
    np.testing.assert_array_equal(np.asarray(dcnt)[do], np.asarray(hcnt)[ho])
    np.testing.assert_array_equal(dnk, hnk)
    # the device path must also emit ascending ids (the stream writer's
    # order contract with the dense tail)
    assert np.all(np.diff(didx) >= 0) or dn <= 1


def test_screened_paired_dedup_matches_host(tmp_path):
    """Paired streaming on a MULTI-BLOCK screened DB — the flagship
    profiling workload at its production shape (paired reads x wide-T,
    util-db-search.go:800-805): the two-pass device tail's in-step
    dedup (BOTH location planes uniqued over the window values,
    device.py::_dedup_value_planes with per-plane sentinels) must
    produce exactly the host backend's candidates and unique k-mer
    counts for joined mate rows over the dedup threshold
    (util-db-search.go:874-908), including fully-duplicate mates,
    sub-threshold rows that keep duplicates, junk and empty mates."""
    from kmcp_tpu.kmer import native as _nat

    if _nat.get_lib() is None:
        pytest.skip("native library unavailable")

    from kmcp_tpu.commands.compute import ComputeOptions, run_compute
    from kmcp_tpu.index.build import run_index
    from kmcp_tpu.search.device import DeviceDB, HostDB, two_pass_ready
    from kmcp_tpu.search.engine import SearchEngine, SearchOptions
    from kmcp_tpu.search.stream import StreamSearcher, _unpack_result

    rng = np.random.default_rng(77)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genomes = []
    for g in range(4):
        seq = rng.choice(bases, size=30000).tobytes()
        (tmp_path / f"g{g}.fa").write_text(f">g{g}\n{seq.decode()}\n")
        genomes.append(seq)
    run_compute(
        out_dir=str(tmp_path / "ks"),
        files=[str(tmp_path / f"g{g}.fa") for g in range(4)],
        opt=ComputeOptions(ks=[21], split_number=4, split_overlap=100),
        force=True,
    )
    db_dir = str(tmp_path / "db")
    run_index(
        in_dir=str(tmp_path / "ks"), out_dir=db_dir, num_hashes=1,
        fpr=0.3, force=True, tpu_native=True, native_block_targets=4,
        block_screen=True, uniform_sigs=True,
    )

    rc = bytes.maketrans(b"ACGT", b"TGCA")
    B = 256
    pairs = []
    for i in range(B):
        g = genomes[int(rng.integers(0, 4))]
        p = int(rng.integers(0, len(g) - 500))
        r1 = g[p : p + 150]
        r2 = g[p + 200 : p + 350].translate(rc)[::-1]
        if i % 7 == 6:  # fully-duplicate mates: every window repeats
            r2 = r1
        elif i % 11 == 10:  # overlapping mates: partial duplication
            r2 = g[p + 50 : p + 200]
        elif i % 23 == 22:  # junk mate
            r2 = rng.choice(bases, size=150).tobytes()
        elif i % 31 == 30:  # empty mate
            r2 = b""
        elif i % 13 == 12:  # sub-threshold row WITH duplicate windows:
            # 40+40 bp joined = 60 windows <= threshold 70 -> the
            # duplicates must be KEPT (the reference quirk)
            r1 = g[p : p + 40] + g[p : p + 40]
            r2 = b""
        pairs.append((r1, r2))
    joined = [r1 + b"N" + r2 if r2 else r1 for r1, r2 in pairs]
    jlens = np.array([len(s) for s in joined], dtype=np.int64)
    eff = np.array(
        [max(len(r1), len(r2)) for r1, r2 in pairs], dtype=np.int64
    )
    lmax = -(-int(jlens.max()) // 32) * 32
    mat = _nat.pack_rows(joined, jlens, lmax)

    thr = 70
    opt = SearchOptions(
        backend="jax", batch_size=B, kmer_dedup_threshold=thr,
        paired_fpr_buf=True,
    )
    eng = SearchEngine([db_dir], opt)
    db = eng.dbs[0]
    assert len(db.blocks) > 1 and two_pass_ready(db)
    assert StreamSearcher.usable(eng, paired=True)

    budget = 8 * B
    hd = HostDB(db, opt)
    T = hd.t_per_block * hd.n_blocks
    host_res = hd.search_reads_async(
        (B, lmax), jlens, budget, seqs=joined, dedup_threshold=thr,
        eff_lens=eff,
    )
    hn, hqi, ht, hcnt, hnk = _unpack_result(host_res, budget, B, T)
    hidx = np.asarray(hqi).astype(np.int64) * T + np.asarray(ht)
    assert hn > 0
    # the dedup must have bitten: joined rows carry ~260 raw windows
    assert int(np.asarray(hnk).max()) > thr

    dev = DeviceDB(db, opt)
    assert dev.screen is not None
    meta_aux = dev.search_reads(mat, eff, budget, dedup_values=True)
    dn, dqi, dt_, dcnt, dnk = _unpack_result(meta_aux, budget, B, T)
    didx = np.asarray(dqi).astype(np.int64) * T + np.asarray(dt_)

    assert dn == hn
    ho = np.argsort(hidx, kind="stable")
    do = np.argsort(didx, kind="stable")
    np.testing.assert_array_equal(didx[do], hidx[ho])
    np.testing.assert_array_equal(
        np.asarray(dcnt)[do], np.asarray(hcnt)[ho]
    )
    # unique (post-dedup) k-mer counts, incl. kept-duplicate rows
    np.testing.assert_array_equal(dnk, hnk)


def test_screened_tail_chunked_pairs_match_unchunked(tmp_path):
    """The screened tail's pair chunking (lax.map + lax.cond skip of
    all-padding chunks) must produce the unchunked tail's exact output,
    including when trailing chunks are pure padding (pairs are
    front-loaded)."""
    from kmcp_tpu.kmer import native as _nat

    if _nat.get_lib() is None:
        pytest.skip("native library unavailable")
    import jax.numpy as jnp

    from kmcp_tpu.commands.compute import ComputeOptions, run_compute
    from kmcp_tpu.index.build import run_index
    from kmcp_tpu.search.device import DeviceDB, _make_screened_tail
    from kmcp_tpu.search.engine import SearchEngine, SearchOptions

    rng = np.random.default_rng(61)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genomes = []
    for g in range(4):
        seq = rng.choice(bases, size=30000).tobytes()
        (tmp_path / f"g{g}.fa").write_text(f">g{g}\n{seq.decode()}\n")
        genomes.append(seq)
    run_compute(
        out_dir=str(tmp_path / "ks"),
        files=[str(tmp_path / f"g{g}.fa") for g in range(4)],
        opt=ComputeOptions(ks=[21], split_number=4, split_overlap=100),
        force=True,
    )
    run_index(
        in_dir=str(tmp_path / "ks"), out_dir=str(tmp_path / "db"),
        num_hashes=1, fpr=0.3, force=True, tpu_native=True,
        native_block_targets=4, block_screen=True, uniform_sigs=True,
    )

    B = 64
    reads = []
    for i in range(B):
        g = genomes[int(rng.integers(0, 4))]
        p = int(rng.integers(0, len(g) - 150))
        reads.append(g[p : p + 150])
    lens = np.array([len(s) for s in reads], dtype=np.int64)

    opt = SearchOptions(backend="jax", batch_size=B)
    eng = SearchEngine([str(tmp_path / "db")], opt)
    db = eng.dbs[0]
    dev = DeviceDB(db, opt)
    scr = dev.screen
    k = 21
    kmax = 160 - k + 1
    hashes, counts = _nat.hash_reads_padded(reads, k, kmax)
    s_block = dev.total_rows
    loc = _nat.locations(hashes, 1, s_block)[..., 0]
    loc[hashes == 0] = s_block
    loc_u = _nat.locations(hashes, 1, scr["num_bits"])[..., 0]
    loc_u[hashes == 0] = scr["num_bits"]

    budget = 8 * B
    pair_budget = 8 * B  # >> active pairs: trailing chunks all padding
    cmin = dev.cmin_for(kmax)
    theta = dev._theta_for(kmax)
    args = (
        dev.bits_ext, scr["u_ext"],
        jnp.asarray(loc.T.copy()), jnp.asarray(loc_u.T.copy()),
        jnp.asarray(counts.astype(np.int32))[None, :],
        jnp.asarray(lens.astype(np.int32)),
        cmin, theta, dev._tmin, dev.sizes_pos,
    )
    outs = {}
    for C in (1, 4):
        tail = _make_screened_tail(
            budget, pair_budget, opt.min_query_len,
            opt.kmer_dedup_threshold, dev.n_blocks, dev.t_per_block,
            s_block, C,
        )
        meta, aux = tail(*args)
        outs[C] = (np.asarray(meta), np.asarray(aux))
    n = int(outs[1][0][0])
    assert n == int(outs[4][0][0]) and n > 0
    np.testing.assert_array_equal(
        outs[1][0][1 : 1 + n], outs[4][0][1 : 1 + n]
    )
    np.testing.assert_array_equal(
        outs[1][0][1 + budget : 1 + budget + n],
        outs[4][0][1 + budget : 1 + budget + n],
    )
    np.testing.assert_array_equal(outs[1][1][:n], outs[4][1][:n])


def test_sharded_screened_step_matches_host(tmp_path):
    """The sharded two-pass screened step (blocks over 't', reads over
    'd' on the virtual CPU mesh) must produce the host backend's exact
    candidate set on a multi-block screened DB
    (device.py::_make_screened_step_sharded)."""
    from kmcp_tpu.kmer import native as _nat

    if _nat.get_lib() is None:
        pytest.skip("native library unavailable")
    import jax
    from jax.sharding import Mesh

    from kmcp_tpu.commands.compute import ComputeOptions, run_compute
    from kmcp_tpu.index.build import run_index
    from kmcp_tpu.search.device import DeviceDB, HostDB
    from kmcp_tpu.search.engine import SearchEngine, SearchOptions
    from kmcp_tpu.search.stream import _unpack_result

    rng = np.random.default_rng(59)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genomes = []
    for g, size in enumerate([30000, 42000, 36000, 30000]):
        seq = rng.choice(bases, size=size).tobytes()
        (tmp_path / f"g{g}.fa").write_text(f">g{g}\n{seq.decode()}\n")
        genomes.append(seq)
    run_compute(
        out_dir=str(tmp_path / "ks"),
        files=[str(tmp_path / f"g{g}.fa") for g in range(4)],
        opt=ComputeOptions(ks=[21], split_number=4, split_overlap=100),
        force=True,
    )
    db_dir = str(tmp_path / "db")
    run_index(
        in_dir=str(tmp_path / "ks"), out_dir=db_dir, num_hashes=1,
        fpr=0.3, force=True, tpu_native=True, native_block_targets=4,
        block_screen=True, uniform_sigs=True,
    )

    B = 90  # deliberately not divisible by d: exercises batch padding
    reads = []
    for i in range(B):
        if i % 5 == 4:
            reads.append(rng.choice(bases, size=150).tobytes())
        elif i % 17 == 16:
            reads.append(b"ACGT")
        else:
            g = genomes[int(rng.integers(0, 4))]
            p = int(rng.integers(0, len(g) - 150))
            reads.append(g[p : p + 150])
    lens = np.array([len(s) for s in reads], dtype=np.int64)
    lmax = 160

    opt = SearchOptions(backend="jax", batch_size=B)
    eng = SearchEngine([db_dir], opt)
    db = eng.dbs[0]
    assert len(db.blocks) == 4

    budget = 8 * B
    hd = HostDB(db, opt)
    T = hd.t_per_block * hd.n_blocks
    host_res = hd.search_reads_async(
        (B, lmax), lens, budget, seqs=reads,
        dedup_threshold=opt.kmer_dedup_threshold,
    )
    hn, hqi, ht, hcnt, hnk = _unpack_result(host_res, budget, B, T)
    hidx = np.asarray(hqi).astype(np.int64) * T + np.asarray(ht)

    k = sorted(db.info.ks)[-1]
    kmax = lmax - k + 1
    hashes, counts = _nat.hash_reads_padded(reads, k, kmax)
    s_block = int(db.blocks[0].bits.shape[0])
    nbits = dev_nbits = None
    from kmcp_tpu.index.format import read_block_union

    nbits = int(read_block_union(db_dir, 0)[1])
    loc = _nat.locations(hashes, 1, s_block)[..., 0]
    loc[hashes == 0] = s_block
    loc_u = _nat.locations(hashes, 1, nbits)[..., 0]
    loc_u[hashes == 0] = nbits

    devs = np.array(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devs, ("d", "t"))
    dev = DeviceDB(db, opt, mesh=mesh)
    assert dev.screen is not None and dev.screen["num_bits"] == nbits
    res = dev.search_screened_sharded(
        loc, loc_u, counts, lens, budget
    )
    dn, dqi, dt_, dcnt, dnk = _unpack_result(np.asarray(res), budget, B, T)
    didx = np.asarray(dqi).astype(np.int64) * T + np.asarray(dt_)

    assert dn == hn
    ho = np.argsort(hidx, kind="stable")
    do = np.argsort(didx, kind="stable")
    np.testing.assert_array_equal(didx[do], hidx[ho])
    np.testing.assert_array_equal(np.asarray(dcnt)[do], np.asarray(hcnt)[ho])
    np.testing.assert_array_equal(dnk, hnk)


def test_block_screen_union(tmp_path):
    """--block-screen builds per-block union Blooms; screened search
    output is identical on clean+junk reads (true matches always clear
    the screen; FP-only junk never passes cmin at this scale)."""
    import glob
    import io

    from kmcp_tpu.commands.compute import ComputeOptions, run_compute
    from kmcp_tpu.index.build import run_index
    from kmcp_tpu.kmer import native
    from kmcp_tpu.search.engine import SearchEngine, SearchOptions
    from kmcp_tpu.search.stream import StreamSearcher

    if native.get_lib() is None:
        pytest.skip("native library unavailable")

    rng = np.random.default_rng(7)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genomes = []
    files = []
    for g in range(24):
        seq = rng.choice(bases, size=60000).tobytes()
        p = tmp_path / f"g{g:02d}.fa"
        p.write_text(f">g{g}\n{seq.decode()}\n")
        genomes.append(seq)
        files.append(str(p))
    run_compute(out_dir=str(tmp_path / "ks"), files=files,
                opt=ComputeOptions(ks=[21], split_number=2,
                                   split_overlap=100), force=True)
    for name, scr in (("scr", True), ("plain", False)):
        run_index(in_dir=str(tmp_path / "ks"),
                  out_dir=str(tmp_path / f"db_{name}"), num_hashes=1,
                  fpr=0.3, force=True, tpu_native=True,
                  native_block_targets=16, block_screen=scr)
    assert len(glob.glob(str(tmp_path / "db_scr" / "*.union.npz"))) == 3

    reads = []
    for i in range(800):
        g = genomes[i % 24]
        p = int(rng.integers(0, len(g) - 150))
        reads.append((f"c{i}", g[p : p + 150], None))
    for i in range(200):
        reads.append((f"j{i}", rng.choice(bases, size=150).tobytes(), None))

    outs = {}
    for name in ("plain", "scr"):
        opt = SearchOptions(backend="host", batch_size=512)
        st = StreamSearcher(SearchEngine([str(tmp_path / f"db_{name}")],
                                         opt))
        buf = io.StringIO()
        st.run(iter(reads), buf)
        outs[name] = buf.getvalue()
    assert outs["plain"] == outs["scr"]

    # union kernels agree with a direct membership oracle
    from kmcp_tpu.index.format import read_block_union
    from kmcp_tpu.kmer.kset import read_kset

    words, num_bits, fpr_u = read_block_union(str(tmp_path / "db_scr"), 0)
    hs = np.asarray(read_kset(
        sorted(glob.glob(str(tmp_path / "ks" / "*.kset")))[0])[0])
    got = native.union_count(words, num_bits, hs[:256].reshape(1, -1))
    assert int(got[0]) == 256  # every member k-mer must be present

    # round-4 sizing: num_bits is a power of two (the device screen
    # modulus lowers to one AND) and the stored fpr is the EXACT
    # 1-hash Bloom FPR for that size — both backends' theta bands
    # derive from it (build.py::_union_screen_fpr); the rounding can
    # only LOWER the fpr vs the designed band
    import math

    from kmcp_tpu.index.build import SCREEN_FPR_U

    assert num_bits & (num_bits - 1) == 0 and num_bits >= 64
    assert 0.0 < fpr_u <= SCREEN_FPR_U + 1e-12
    # exactness: recompute from the block's total k-mer count
    eng_scr = SearchEngine(
        [str(tmp_path / "db_scr")], SearchOptions(backend="numpy")
    )
    db0 = eng_scr.dbs[0]
    total = int(sum(int(s) for s in db0.blocks[0].sizes))
    want = -math.expm1(total * math.log1p(-1.0 / num_bits))
    assert abs(fpr_u - want) < 1e-12


@pytest.mark.parametrize("num_hashes", [1, 3])
def test_low_mem_row_seek_matches_resident(tmp_path, num_hashes):
    """--low-mem (row-seek mode, util-db-search.go:6975-7176): the index
    stays on disk and only the rows a batch gathers are pread; output is
    byte-identical to the resident path and bytes read stay well under
    the index size."""
    import io

    from kmcp_tpu.commands.compute import ComputeOptions, run_compute
    from kmcp_tpu.index.build import run_index
    from kmcp_tpu.search.engine import SearchEngine, SearchOptions
    from kmcp_tpu.search.tsv import write_results

    rng = np.random.default_rng(23)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genomes = []
    for g in range(3):
        seq = rng.choice(bases, size=60000).tobytes()
        (tmp_path / f"g{g}.fa").write_text(f">g{g}\n{seq.decode()}\n")
        genomes.append(seq)
    run_compute(
        out_dir=str(tmp_path / "ks"),
        files=[str(tmp_path / f"g{g}.fa") for g in range(3)],
        opt=ComputeOptions(ks=[21], split_number=2, split_overlap=50),
        force=True,
    )
    db = str(tmp_path / "db")
    run_index(in_dir=str(tmp_path / "ks"), out_dir=db,
              num_hashes=num_hashes, fpr=0.1, force=True)

    reads = []
    for i in range(120):
        g = genomes[int(rng.integers(0, 3))]
        p = int(rng.integers(0, len(g) - 150))
        reads.append((f"r{i}", g[p : p + 150], None))

    ref_eng = SearchEngine([db], SearchOptions(backend="numpy"))
    buf_ref = io.StringIO()
    write_results(buf_ref, ref_eng.search_batch(reads, 0), False)

    lm_eng = SearchEngine([db], SearchOptions(backend="numpy", low_mem=True))
    for blk in lm_eng.dbs[0].blocks:
        assert blk.bits is None, "low-mem must not map the matrix"
    buf_lm = io.StringIO()
    write_results(buf_lm, lm_eng.search_batch(reads, 0), False)
    assert buf_ref.getvalue() == buf_lm.getvalue()

    import os as _os

    from kmcp_tpu.index.format import block_paths

    total_read = sum(b.rows.bytes_read for b in lm_eng.dbs[0].blocks)
    total_size = sum(
        _os.path.getsize(block_paths(db, i)[0])
        for i in range(len(lm_eng.dbs[0].blocks))
    )
    assert 0 < total_read < total_size // 2, (total_read, total_size)

    # CLI surface: --low-mem flag routes through (no streaming fast path)
    from kmcp_tpu.search.stream import StreamSearcher

    lm_host = SearchEngine(
        [db], SearchOptions(backend="host", low_mem=True)
    )
    assert not StreamSearcher.usable(lm_host)


def test_chunked_count_tail_matches_dense():
    """The lax.map-chunked count tail (wide-T memory bounding) returns
    byte-identical (meta, aux) to the dense tail whenever nothing
    overflows, and reports n_cand > budget when any chunk overflows its
    share (triggering the caller's standard 4x retry)."""
    import jax.numpy as jnp

    from kmcp_tpu.search.device import _make_count_tail

    rng = np.random.default_rng(5)
    S, W, B, K = 997, 7, 64, 30
    T = W * 32
    bits = rng.integers(0, 2**32, (S + 1, W), dtype=np.uint32)
    bits[S] = 0  # sentinel row
    loc_t = rng.integers(0, S, (K, B), dtype=np.int32)
    loc_t[rng.random((K, B)) < 0.1] = S  # invalid windows
    nk = (loc_t != S).sum(axis=0, dtype=np.int32)[None, :]
    lens = np.full(B, 150, dtype=np.int32)
    lens[::13] = 10  # below min_len
    # random bits are ~50% dense, so counts ~ Binomial(valid_k, 0.5);
    # a high threshold keeps candidates sparse like a real search
    cmin = np.full(K + 1, 20, dtype=np.int32)
    tmin = np.zeros(T, dtype=np.int32)
    tmin[::3] = 21
    sizes_pos = np.ones(T, dtype=bool)
    sizes_pos[T - 5 :] = False
    budget = 4096
    args = (
        jnp.asarray(bits), (jnp.asarray(loc_t),), jnp.asarray(nk),
        jnp.asarray(lens), jnp.asarray(cmin), jnp.asarray(tmin),
        jnp.asarray(sizes_pos),
    )
    m1, a1 = _make_count_tail(budget, 30, 256, 1)(*args)
    m4, a4 = _make_count_tail(budget, 30, 256, 4)(*args)
    n = int(m1[0])
    assert 0 < n <= budget, n
    assert int(m4[0]) == n
    np.testing.assert_array_equal(m1[1 : 1 + n], m4[1 : 1 + n])
    np.testing.assert_array_equal(a1[:n], a4[:n])
    np.testing.assert_array_equal(a1[budget:], a4[budget:])

    # per-chunk overflow: tiny budget -> retry signal
    m_o, _ = _make_count_tail(8, 30, 256, 4)(*args)
    assert int(m_o[0]) > 8


def test_unpack_result_layouts():
    """Drain-side normalization of search-step results: compact tuple
    (meta int32 + aux uint16) in flat and split-id layouts, legacy
    concat int32 with and without the nkmers tail, and the overflow
    signal."""
    from kmcp_tpu.search.stream import _unpack_result

    budget, nb, T = 8, 4, 10
    meta = np.zeros(1 + budget, dtype=np.int32)
    aux = np.zeros(budget + nb, dtype=np.uint16)
    meta[0] = 3
    meta[1:4] = [5, 9, 77]
    aux[:3] = [2, 4, 6]
    aux[budget:] = [10, 11, 12, 13]
    n, qi, t, cnt, nk = _unpack_result((meta, aux), budget, nb, T)
    assert n == 3
    assert qi.tolist() == [0, 0, 7] and t.tolist() == [5, 9, 7]
    assert cnt.tolist() == [2, 4, 6]
    assert nk.tolist() == [10, 11, 12, 13]

    meta[0] = budget + 1  # overflow -> caller retries
    n, qi, t, cnt, nk = _unpack_result((meta, aux), budget, nb, T)
    assert n == budget + 1 and qi is None

    # split-id layout (screened wide-T tail): no flat B*T encoding
    meta2 = np.zeros(1 + 2 * budget, dtype=np.int32)
    meta2[0] = 2
    meta2[1:3] = [3, 900000]          # read ids
    meta2[1 + budget : 3 + budget] = [7, 524287]  # target ids
    n, qi, t, cnt, nk = _unpack_result((meta2, aux), budget, nb, T)
    assert n == 2
    assert qi.tolist() == [3, 900000] and t.tolist() == [7, 524287]

    legacy = np.zeros(1 + 2 * budget + nb, dtype=np.int64)
    legacy[0] = 2
    legacy[1:3] = [75, 83]
    legacy[1 + budget : 3 + budget] = [5, 3]
    legacy[1 + 2 * budget :] = [1, 2, 3, 4]
    n, qi, t, cnt, nk = _unpack_result(legacy, budget, nb, T)
    assert n == 2 and qi.tolist() == [7, 8] and t.tolist() == [5, 3]
    assert cnt.tolist() == [5, 3]
    assert nk.tolist() == [1, 2, 3, 4]

    legacy_short = legacy[: 1 + 2 * budget]
    n, qi, t, cnt, nk = _unpack_result(legacy_short, budget, nb, T)
    assert n == 2 and nk is None


def test_pack_rows_native_matches_numpy():
    from kmcp_tpu.kmer import native
    from kmcp_tpu.search.stream import _pack_reads_matrix

    if native.get_lib() is None:
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(3)
    seqs = [bytes(rng.integers(65, 90, rng.integers(0, 40), dtype=np.uint8))
            for _ in range(57)]
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    got = native.pack_rows(seqs, lens, 48)
    B = len(seqs)
    want = np.zeros((B, 48), dtype=np.uint8)
    concat = np.frombuffer(b"".join(seqs), dtype=np.uint8)
    cols = np.arange(48)[None, :]
    want[cols < lens[:, None]] = concat
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_pack_reads_matrix(seqs, lens, 48), want)


@pytest.mark.parametrize("K", [1, 5, 16, 23, 24, 31, 32, 48, 130, 137])
def test_unpack_count_csa_matches_naive(K):
    """The Harley-Seal CSA positional popcount (device.py::_unpack_count)
    must agree bit-for-bit with the direct unpack on every K regime:
    below the CSA cutoff, exact group multiples, and ragged tails."""
    from kmcp_tpu.search.device import _unpack_count, _unpack_sum
    import jax.numpy as jnp

    rng = np.random.default_rng(K)
    rows = rng.integers(0, 2**32, size=(K, 3, 5), dtype=np.uint32)
    got = np.asarray(_unpack_count(jnp.asarray(rows)))
    want = np.asarray(
        _unpack_sum(jnp.asarray(rows.reshape(K, 15)))
    ).reshape(3, 5 * 32)
    # independent numpy oracle as well (guards _unpack_sum itself)
    bits = (rows[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    oracle = bits.sum(axis=0).reshape(3, 5 * 32).astype(np.int32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle)


def test_per_read_compaction_matches_flat():
    """_compact_candidates' per-read two-level scheme (B >= 4096, small
    T: the demo-scale device regime) returns byte-identical
    (idx, cnt, n) to the flat cumsum+search scheme, and poisons n past
    the budget when a read holds more than its slot allowance."""
    import jax.numpy as jnp

    from kmcp_tpu.search.device import _compact_candidates, _nonzero_asc

    rng = np.random.default_rng(11)
    B, T = 4096, 96
    counts = rng.integers(0, 40, (B, T)).astype(np.int32)
    ok = counts >= 36  # ~10% lanes, up to ~20 per read
    budget = int(ok.sum()) + 64
    okj, cj = jnp.asarray(ok), jnp.asarray(counts)
    idx, cnt, n = _compact_candidates(okj, cj, budget, -1)
    # flat-scheme oracle
    fidx, fn = _nonzero_asc(okj.reshape(-1), budget, B * T)
    fcnt = jnp.where(
        fidx < B * T,
        jnp.take(cj.reshape(-1), jnp.minimum(fidx, B * T - 1)),
        -1,
    )
    # n_slots = max(8, ceil(4*budget/B)) covers the densest read here
    assert int(ok.sum(axis=1).max()) <= max(8, -(-4 * budget) // B)
    assert int(n) == int(fn) == int(ok.sum())
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(fidx))
    np.testing.assert_array_equal(np.asarray(cnt), np.asarray(fcnt))

    # per-read slot overflow: a tiny budget shrinks n_slots below one
    # read's candidate count -> n must exceed the budget (retry signal)
    dense_ok = np.zeros((B, T), dtype=bool)
    dense_ok[7, :32] = True  # one read with 32 candidates
    _, _, n_o = _compact_candidates(
        jnp.asarray(dense_ok), cj, 16, -1
    )
    assert int(n_o) > 16


def test_uint16_dedup_boundary_routing(tmp_path):
    """The compact device result layout carries counts/nkmers as uint16
    while the dedup threshold is below 65535 (device_step.aux_dtype);
    at or past it the tails widen the aux columns to int32 instead of
    saturating them, and an engine configured past the boundary must
    still stream object-engine-identical output on the device."""
    import io

    import jax.numpy as jnp

    from kmcp_tpu.kmer import native as _nat
    from kmcp_tpu.search.device import _make_count_tail
    from kmcp_tpu.search.device_step import aux_dtype
    from kmcp_tpu.search.engine import SearchEngine, SearchOptions
    from kmcp_tpu.search.stream import StreamSearcher
    from kmcp_tpu.search.tsv import write_results

    assert aux_dtype(65534) == jnp.uint16
    assert aux_dtype(65535) == jnp.int32
    bits = jnp.zeros((3, 1), jnp.uint32)
    loc = jnp.full((4, 8), 2, jnp.int32)
    _m, aux = _make_count_tail(64, 30, 65535, 1)(
        bits, (loc,), jnp.full((1, 8), 70000, jnp.int32),
        jnp.full((8,), 150, jnp.int32), jnp.ones((5,), jnp.int32),
        jnp.ones((32,), jnp.int32), jnp.ones((32,), bool),
    )
    assert aux.dtype == jnp.int32 and int(aux[-1]) == 70000

    if _nat.get_lib() is None:
        pytest.skip("native library unavailable (streaming needs it)")
    db, genomes = _tiny_db(tmp_path, [21])
    rng = np.random.default_rng(23)
    reads = []
    for i in range(64):
        g = genomes[int(rng.integers(0, len(genomes)))]
        ln = 600 if i % 7 == 0 else 150  # ~580 k-mers > default 256
        p = int(rng.integers(0, len(g) - ln))
        reads.append((f"r{i}", g[p : p + ln], None))

    opt_np = SearchOptions(
        backend="numpy", keep_unmatched=False, kmer_dedup_threshold=70000
    )
    buf1 = io.StringIO()
    write_results(
        buf1, SearchEngine([db], opt_np).search_batch(reads, 0), False
    )
    opt_j = SearchOptions(
        backend="jax", batch_size=64, kmer_dedup_threshold=70000
    )
    eng_j = SearchEngine([db], opt_j)
    assert StreamSearcher.usable(eng_j)
    buf2 = io.StringIO()
    total, _ = StreamSearcher(eng_j).run(iter(reads), buf2)
    assert total == 64
    assert buf1.getvalue() == buf2.getvalue()


def test_block_screen_adversarial_fp_only(tmp_path, monkeypatch):
    """Adversarial probe of the screen's documented divergence (PARITY.md
    deviation 7): at hostile settings — min_kmers=1, query-cov 0.31, fpr-0.3
    Blooms, 35 bp reads (15 k-mers) — junk reads false-positive-match
    targets through Bloom FP bits alone, and the union screen (whose
    bits are independent of the per-target Blooms) legitimately drops
    such rows.  The test pins the BOUND on that divergence:

    1. the screen only ever DROPS rows (screened subset of unscreened);
    2. every clean read's true-source row survives with identical
       fields (true k-mers always hit the union Bloom — no false
       negatives — so real matches clear the junk band);
    3. the divergence actually fires here (dropped FP-only junk rows),
       which is why PARITY.md documents it rather than claiming
       identity at all settings.

    Rows are compared WITHOUT the per-query `hits` column: dropping a
    query's FP rows legitimately decrements its surviving rows' hits
    count (a knock-on of the same documented divergence)."""
    import io

    from kmcp_tpu.commands.compute import ComputeOptions, run_compute
    from kmcp_tpu.index.build import run_index
    from kmcp_tpu.kmer import native
    from kmcp_tpu.search.engine import SearchEngine, SearchOptions
    from kmcp_tpu.search.stream import StreamSearcher

    if native.get_lib() is None:
        pytest.skip("native library unavailable")

    rng = np.random.default_rng(31)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genomes = []
    files = []
    for g in range(24):
        seq = rng.choice(bases, size=40000).tobytes()
        p = tmp_path / f"g{g:02d}.fa"
        p.write_text(f">g{g}\n{seq.decode()}\n")
        genomes.append(seq)
        files.append(str(p))
    run_compute(out_dir=str(tmp_path / "ks"), files=files,
                opt=ComputeOptions(ks=[21], split_number=2,
                                   split_overlap=100), force=True)
    run_index(in_dir=str(tmp_path / "ks"), out_dir=str(tmp_path / "db"),
              num_hashes=1, fpr=0.3, force=True, tpu_native=True,
              native_block_targets=16, block_screen=True)

    reads = []
    for i in range(100):  # clean 35 bp reads, one per half-genome
        g = genomes[i % 24]
        half = (len(genomes[0]) // 2) * ((i // 24) % 2)
        p = half + int(rng.integers(100, 15000))
        reads.append((f"c{i}", g[p : p + 35], None))
    for i in range(200):  # junk: no genuine 21-mer overlap with any genome
        reads.append((f"j{i}", rng.choice(bases, size=35).tobytes(), None))

    hostile = dict(
        backend="host", batch_size=512, min_kmers=1, min_query_cov=0.31,
        max_fpr=1.0,
    )
    rows = {}
    for name, no_screen in (("scr", False), ("plain", True)):
        if no_screen:
            monkeypatch.setenv("KMCP_TPU_NO_SCREEN", "1")
        else:
            monkeypatch.delenv("KMCP_TPU_NO_SCREEN", raising=False)
        st = StreamSearcher(
            SearchEngine([str(tmp_path / "db")], SearchOptions(**hostile))
        )
        buf = io.StringIO()
        st.run(iter(reads), buf)
        rows[name] = {
            tuple(f)  # drop col 4 (`hits`): see docstring
            for l in buf.getvalue().splitlines()
            if l and not l.startswith("#")
            for f in [l.split("\t")[:4] + l.split("\t")[5:]]
        }

    dropped = rows["plain"] - rows["scr"]
    added = rows["scr"] - rows["plain"]
    assert added == set(), f"screen ADDED rows: {sorted(added)[:3]}"
    assert dropped, "adversarial case must fire (FP-only rows dropped)"
    # every clean read keeps its true-source target row, bit-identical
    by_query_target = {}
    for r in rows["plain"]:
        by_query_target.setdefault((r[0], r[4]), []).append(r)
    for i in range(100):
        qid, want_t = f"c{i}", f"g{i % 24:02d}"
        true_rows = [
            r for r in by_query_target.get((qid, want_t), [])
        ]
        assert true_rows, f"{qid} lost its true match in plain output"
        for r in true_rows:
            assert r in rows["scr"], f"screen dropped TRUE match {r[:7]}"


def test_count_tail_in_dedup_matches_manual():
    """The count tail's in-step value dedup (in_dedup + vplanes, the
    paired device route) must equal a manually pre-deduplicated tail:
    over-threshold reads drop duplicate 64-bit values (keeping ONE
    window per value) and report unique counts; reads at or below the
    threshold keep duplicates — the reference's >256-only dedup quirk
    (util-db-search.go:874-908)."""
    import jax.numpy as jnp

    from kmcp_tpu.search.device import _make_count_tail

    rng = np.random.default_rng(41)
    S, W, K, B = 251, 4, 24, 64
    T = W * 32
    thr = 12
    bits = rng.integers(0, 2**32, (S + 1, W), dtype=np.uint32)
    bits[S] = 0
    # values: draw from a small pool so duplicates are common
    pool_hi = rng.integers(1, 2**32, 10, dtype=np.uint32)
    pool_lo = rng.integers(0, 2**32, 10, dtype=np.uint32)
    pick = rng.integers(0, 10, (K, B))
    vhi, vlo = pool_hi[pick], pool_lo[pick]
    # locations derive from the value (same value -> same location,
    # as a real hash mod would)
    loc = ((pool_lo[pick].astype(np.int64)) % S).astype(np.int32)
    invalid = rng.random((K, B)) < 0.15
    vhi[invalid], vlo[invalid] = 0, 0
    loc[invalid] = S
    nk = (~invalid).sum(axis=0, dtype=np.int32)
    # half the reads get few windows (<= thr) by invalidating extras
    few = np.arange(B) % 2 == 0
    kill = (np.arange(K)[:, None] >= thr - 2) & few[None, :]
    vhi[kill], vlo[kill] = 0, 0
    loc[kill] = S
    nk = ((vhi != 0) | (vlo != 0)).sum(axis=0).astype(np.int32)

    lens = np.full(B, 150, dtype=np.int32)
    cmin = np.full(K + 1, 1, dtype=np.int32)
    tmin = np.zeros(T, dtype=np.int32)
    spos = np.ones(T, dtype=bool)
    budget = B * T  # no overflow; exact comparison

    tail_d = _make_count_tail(budget, 30, thr, 1, True)
    m_d, a_d = tail_d(
        jnp.asarray(bits), (jnp.asarray(loc),), jnp.asarray(nk[None]),
        jnp.asarray(lens), jnp.asarray(cmin), jnp.asarray(tmin),
        jnp.asarray(spos), (jnp.asarray(vhi), jnp.asarray(vlo)),
    )

    # manual oracle: dedup over-threshold reads on (hi, lo), keep one
    loc_m = loc.copy()
    nk_m = nk.copy()
    for b in range(B):
        if nk[b] <= thr:
            continue
        seen = set()
        uniq = 0
        for kk in range(K):
            v = (int(vhi[kk, b]), int(vlo[kk, b]))
            if v == (0, 0):
                continue
            if v in seen:
                loc_m[kk, b] = S
            else:
                seen.add(v)
                uniq += 1
        nk_m[b] = uniq
    tail_x = _make_count_tail(budget, 30, 60000, 1)  # filter disabled
    m_x, a_x = tail_x(
        jnp.asarray(bits), (jnp.asarray(loc_m),), jnp.asarray(nk_m[None]),
        jnp.asarray(lens), jnp.asarray(cmin), jnp.asarray(tmin),
        jnp.asarray(spos),
    )
    n = int(m_x[0])
    assert int(m_d[0]) == n and 0 < n <= budget
    np.testing.assert_array_equal(
        np.asarray(m_d[1 : 1 + n]), np.asarray(m_x[1 : 1 + n])
    )
    np.testing.assert_array_equal(np.asarray(a_d), np.asarray(a_x))
    # the dedup actually changed something (both regimes exercised)
    assert (nk_m != nk).any() and (nk_m == nk)[few].all()


def test_low_mem_jax_warns(tmp_path, capsys):
    """--low-mem has no effect on the jax backend (blocks live in device
    HBM); the engine must say so instead of silently downgrading
    (VERDICT r4 weak item 4)."""
    from kmcp_tpu.search.engine import SearchOptions

    db, _ = _tiny_db(tmp_path, ks=[21])
    SearchEngine([db], SearchOptions(backend="jax", low_mem=True))
    err = capsys.readouterr().err
    assert "--low-mem is ignored" in err
    # host backend with low_mem stays silent (the flag is honored there)
    SearchEngine([db], SearchOptions(backend="host", low_mem=True))
    assert "--low-mem is ignored" not in capsys.readouterr().err


def test_whole_file_query_jax_matches_numpy(tmp_path):
    """Genome-scale containment queries (`search -g`,
    search.go:885-937) on the jax backend: the chunked k-mer-axis
    accumulation (kernel.make_jax_counter_genome) must give the numpy
    backend's counts bit-for-bit.  300 kb query -> ~280k k-mers, over
    the 262144 chunked-path threshold."""
    from kmcp_tpu.commands.compute import ComputeOptions, run_compute
    from kmcp_tpu.commands.search import run_search
    from kmcp_tpu.index.build import run_index
    from kmcp_tpu.search.engine import SearchOptions

    rng = np.random.default_rng(11)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genomes = []
    for g in range(3):
        seq = rng.choice(bases, size=300_000).tobytes()
        (tmp_path / f"g{g}.fa").write_text(f">g{g}\n{seq.decode()}\n")
        genomes.append(seq)
    run_compute(
        out_dir=str(tmp_path / "ks"),
        files=[str(tmp_path / f"g{g}.fa") for g in range(3)],
        opt=ComputeOptions(ks=[21], split_number=1),
        force=True,
    )
    run_index(in_dir=str(tmp_path / "ks"), out_dir=str(tmp_path / "db"),
              num_hashes=1, fpr=0.1, force=True)
    # query = genome 0 + a mutated copy of genome 1's first half
    q = tmp_path / "q.fa"
    q.write_text(f">q\n{genomes[0].decode()}{genomes[1][:150000].decode()}\n")

    outs = {}
    for backend in ("numpy", "jax"):
        out_path = tmp_path / f"{backend}.tsv"
        run_search(
            db_dir=str(tmp_path / "db"),
            out_file=str(out_path),
            files=[str(q)],
            whole_file=True,
            opt=SearchOptions(backend=backend, min_query_cov=0.3),
            verbose=False,
        )
        outs[backend] = out_path.read_text()
    assert outs["numpy"] == outs["jax"]
    assert "g0" in outs["numpy"]  # the full genome must match itself


@pytest.mark.parametrize("sketch", ["minimizer", "syncmer"])
def test_device_sketch_selection_matches_host(tmp_path, sketch):
    """On-device minimizer/closed-syncmer selection
    (search/sketch_device.py) must produce the host backend's exact
    candidate set — same (read, target, count) triples and the same
    sketch sizes (qKmers) — through the full device path
    (util-db-search.go:1050-1106 is the reference's in-engine sketch
    branch)."""
    from kmcp_tpu.kmer import native as _nat

    if _nat.get_lib() is None:
        pytest.skip("native library unavailable")

    from kmcp_tpu.commands.compute import ComputeOptions, run_compute
    from kmcp_tpu.index.build import run_index
    from kmcp_tpu.search.device import DeviceDB, HostDB
    from kmcp_tpu.search.engine import SearchEngine, SearchOptions
    from kmcp_tpu.search.stream import StreamSearcher, _unpack_result

    rng = np.random.default_rng(31)
    bases = np.frombuffer(b"ACGTN", dtype=np.uint8)
    genomes = []
    for g in range(3):
        seq = rng.choice(
            bases[:4], size=30000
        ).tobytes()
        (tmp_path / f"g{g}.fa").write_text(f">g{g}\n{seq.decode()}\n")
        genomes.append(seq)
    skw = (
        dict(minimizer_w=5) if sketch == "minimizer"
        else dict(syncmer_s=11)
    )
    run_compute(
        out_dir=str(tmp_path / "ks"),
        files=[str(tmp_path / f"g{g}.fa") for g in range(3)],
        opt=ComputeOptions(ks=[21], split_number=2, split_overlap=100,
                           **skw),
        force=True,
    )
    run_index(in_dir=str(tmp_path / "ks"), out_dir=str(tmp_path / "db"),
              num_hashes=1, fpr=0.3, force=True, tpu_native=True)

    B = 256
    reads = []
    for i in range(B):
        if i % 6 == 5:
            reads.append(rng.choice(bases[:4], size=150).tobytes())
        elif i % 17 == 16:
            reads.append(b"ACGTACGT")  # too short
        elif i % 11 == 10:
            # shorter than one minimizer window's worth of k-mers
            g = genomes[int(rng.integers(0, 3))]
            p = int(rng.integers(0, len(g) - 24))
            reads.append(g[p : p + 24])
        else:
            g = genomes[int(rng.integers(0, 3))]
            p = int(rng.integers(0, len(g) - 150))
            r = bytearray(g[p : p + 150])
            if i % 13 == 12:
                r[70] = ord("N")
            reads.append(bytes(r))
    lens = np.array([len(s) for s in reads], dtype=np.int64)
    lmax = 160
    mat = _nat.pack_rows(reads, lens, lmax)

    opt = SearchOptions(backend="jax", batch_size=B)
    eng = SearchEngine([str(tmp_path / "db")], opt)
    db = eng.dbs[0]
    assert db.is_sketch and len(db.blocks) == 1

    budget = 8 * B
    hd = HostDB(db, opt)
    T = hd.t_per_block * hd.n_blocks
    host_res = hd.search_reads_async(
        (B, lmax), lens, budget, seqs=reads,
        dedup_threshold=opt.kmer_dedup_threshold,
    )
    hn, hqi, ht, hcnt, hnk = _unpack_result(host_res, budget, B, T)

    assert StreamSearcher.usable(eng)
    dev = DeviceDB(db, opt)
    meta_aux = dev.search_reads(mat, lens, budget)
    dn, dqi, dt_, dcnt, dnk = _unpack_result(meta_aux, budget, B, T)

    assert dn == hn
    hidx = np.asarray(hqi).astype(np.int64) * T + np.asarray(ht)
    didx = np.asarray(dqi).astype(np.int64) * T + np.asarray(dt_)
    ho, do = np.argsort(hidx, kind="stable"), np.argsort(didx, kind="stable")
    np.testing.assert_array_equal(didx[do], hidx[ho])
    np.testing.assert_array_equal(np.asarray(dcnt)[do], np.asarray(hcnt)[ho])
    np.testing.assert_array_equal(dnk, hnk)  # sketch sizes (qKmers)


@pytest.mark.parametrize("num_hashes", [1, 2, 3])
def test_hash_kernel_pack_modes_identical(num_hashes):
    """ASCII, 4-bit, and 2-bit+bitmap packed inputs must produce
    identical device-hash outputs (loc/nk/value planes, one to three
    hash functions) —
    N-containing, short, and mixed-case reads included; the NumPy
    fallback packers must agree with the C++ packers."""
    from kmcp_tpu.kmer import native as _nat
    from kmcp_tpu.search.device_hash import make_hash_fn

    rng = np.random.default_rng(3)
    bases = np.frombuffer(b"ACGTNacgt", dtype=np.uint8)
    B, lmax, k = 256, 160, 21
    reads = []
    for i in range(B):
        L = int(rng.integers(8, 161))
        reads.append(rng.choice(bases, size=L).tobytes())
    lens = np.array([len(r) for r in reads], np.int64)
    mat = _nat.pack_rows(reads, lens, lmax)
    if mat is None:
        pytest.skip("native library unavailable")
    m4 = _nat.pack_rows_4bit(reads, lens, lmax)
    c2, nm = _nat.pack_rows_2bit(reads, lens, lmax)
    S = 99991
    outs = []
    for kw, arg in (
        ({}, mat),
        ({"packed4": True}, m4),
        ({"packed2": True}, (c2, nm)),
    ):
        fn = make_hash_fn(
            k, lmax, S, (1 << 64) - 1, num_hashes=num_hashes,
            emit_values=True, **kw,
        )
        outs.append([np.asarray(x) for x in fn(arg)])
    for i in range(len(outs[0])):
        np.testing.assert_array_equal(outs[0][i], outs[1][i])
        np.testing.assert_array_equal(outs[0][i], outs[2][i])

    import unittest.mock as _mock

    with _mock.patch.object(_nat, "get_lib", lambda: None):
        np.testing.assert_array_equal(
            _nat.pack_rows_4bit(reads, lens, lmax), m4
        )
        c2_np, nm_np = _nat.pack_rows_2bit(reads, lens, lmax)
    np.testing.assert_array_equal(c2_np, c2)
    np.testing.assert_array_equal(nm_np, nm)
