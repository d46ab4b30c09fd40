"""ctypes bridge to the C++ rolling-ntHash scanner (native/nthash.cpp).

Builds the shared library on first use (g++ is part of the environment);
falls back transparently to the NumPy prefix-XOR path when unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "native", "nthash.cpp")
_SRC_WRITER = os.path.join(_REPO, "native", "writer.cpp")
_SRC_PARSER = os.path.join(_REPO, "native", "parser.cpp")
_BUILD_DIR = os.path.join(_REPO, "native", "build")
_SO = os.path.join(_BUILD_DIR, "libkthash.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    srcs = [_SRC, _SRC_WRITER, _SRC_PARSER]
    cmd = [
        "g++", "-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC",
        "-fopenmp", "-o", _SO, *srcs,
    ]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if res.returncode != 0:
        # retry without openmp/march
        res = subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", _SO, *srcs],
            capture_output=True, text=True, timeout=120,
        )
        if res.returncode != 0:
            print(f"[kmcp-tpu] native hash build failed:\n{res.stderr}",
                  file=sys.stderr)
            return False
    return True


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("KMCP_TPU_NO_NATIVE"):
            return None
        if not os.path.isfile(_SO) or os.path.getmtime(_SO) < max(
            os.path.getmtime(s)
            for s in (_SRC, _SRC_WRITER, _SRC_PARSER)
            if os.path.isfile(s)
        ):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        lib.kthash_scan_mt.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
        ]
        lib.kthash_scan_mt.restype = None
        lib.kt_sort_unique.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64, ctypes.c_int,
        ]
        lib.kt_sort_unique.restype = ctypes.c_int64
        lib.kt_locations.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64, ctypes.c_int,
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ]
        lib.kt_locations.restype = None
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.kt_hash_reads.argtypes = [
            ctypes.c_char_p, i64p, i64p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64, i64p,
            ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ]
        lib.kt_hash_reads.restype = None
        lib.kt_hash_reads_loc.argtypes = [
            ctypes.c_char_p, i64p, i64p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, i64p,
            ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ]
        lib.kt_hash_reads_loc.restype = None
        lib.kt_build_word_column.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), i64p, ctypes.c_int,
            ctypes.c_int, ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.kt_build_word_column.restype = None
        lib.kt_count_block.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.kt_count_block.restype = None
        lib.kt_count_block_sparse.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int,
        ]
        lib.kt_count_block_sparse.restype = ctypes.c_int64
        lib.kt_count_hashes_sparse.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_uint64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int,
        ]
        lib.kt_count_hashes_sparse.restype = ctypes.c_int64
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.kt_count_blocks.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
            u64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, i64p, u64p, i64p, i64p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ]
        lib.kt_count_blocks.restype = None
        lib.kt_union_fill.argtypes = [
            u64p, ctypes.c_int64, ctypes.c_uint64, u64p, ctypes.c_int,
        ]
        lib.kt_union_fill.restype = None
        lib.kt_union_count.argtypes = [
            u64p, ctypes.c_uint64, u64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ]
        lib.kt_union_count.restype = None
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.kt_write_rows.argtypes = [
            i32p, i32p, i32p, ctypes.c_int64,
            ctypes.c_int64, i64p, i64p, i32p, u8p,
            ctypes.c_char_p, i64p,
            ctypes.c_char_p, i64p,
            ctypes.c_char_p, i64p,
            i64p,
            ctypes.c_char_p, i64p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.kt_write_rows.restype = ctypes.c_int64
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.kt_parse_search_tsv.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_double,
            ctypes.c_double,
            i64p, i32p, i32p, i64p, f64p,
            i64p, i64p, i32p, i64p,
            i64p, i64p,
            i64p,
        ]
        lib.kt_parse_search_tsv.restype = ctypes.c_int64
        lib.kt_merge_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
            i64p, i64p, i64p, i64p, i64p, i64p, f64p, i64p,
        ]
        lib.kt_merge_scan.restype = ctypes.c_int64
        lib.kt_merge_emit.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, i64p,
            i64p, i64p, i64p, i64p, i64p, i64p, i32p,
            ctypes.c_void_p,
        ]
        lib.kt_merge_emit.restype = ctypes.c_int64
        lib.kt_pack_rows.argtypes = [
            ctypes.c_char_p, i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.kt_pack_rows.restype = None
        if hasattr(lib, "kt_pack_rows_4bit"):
            lib.kt_pack_rows_4bit.argtypes = lib.kt_pack_rows.argtypes
            lib.kt_pack_rows_4bit.restype = None
        _lib = lib
        return _lib


def scan(
    buf: bytes | np.ndarray, k: int, canonical: bool = True, threads: int = 0
):
    """All-window ntHash over ``buf``.  Returns (hashes[L-k+1] uint64,
    valid[L-k+1] bool) or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if isinstance(buf, np.ndarray):
        buf = buf.tobytes()
    L = len(buf)
    n = L - k + 1
    if n <= 0:
        return np.empty(0, np.uint64), np.empty(0, bool)
    out = np.zeros(n, dtype=np.uint64)
    valid = np.zeros(n, dtype=np.uint8)
    if threads <= 0:
        threads = min(os.cpu_count() or 1, 16)
    lib.kthash_scan_mt(
        buf, L, k, int(canonical),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        threads,
    )
    return out, valid.view(bool)


def hash_reads_padded(
    reads: list[bytes],
    k: int,
    kmax: int,
    canonical: bool = True,
    max_hash: int | None = None,
    threads: int = 0,
    dedup_threshold: int = 0,
    minimizer_w: int = 0,
    syncmer_s: int = 0,
):
    """Batched hashing to a zero-padded [B, kmax] uint64 matrix + counts.
    With ``dedup_threshold`` > 0, rows with more than that many k-mers are
    sorted + deduplicated (the reference's large-query deduplication,
    util-db-search.go:874-908) and counts reflect the unique set."""
    lib = get_lib()
    if lib is None:
        return None
    B = len(reads)
    concat = b"".join(reads)
    lens = np.array([len(r) for r in reads], dtype=np.int64)
    starts = np.zeros(B, dtype=np.int64)
    if B > 1:
        np.cumsum(lens[:-1], out=starts[1:])
    out = np.zeros((B, kmax), dtype=np.uint64)
    counts = np.empty(B, dtype=np.int64)
    if threads <= 0:
        threads = min(os.cpu_count() or 1, 16)
    lib.kt_hash_reads(
        concat,
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        B, k, int(canonical),
        np.uint64(max_hash if max_hash is not None else 0xFFFFFFFFFFFFFFFF),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        kmax,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        threads, dedup_threshold, minimizer_w, syncmer_s,
    )
    return out, counts


def pack_rows(reads: list[bytes], lens: np.ndarray, stride: int):
    """Pack reads into a zero-padded row-major [B, stride] uint8 matrix
    (the device batch layout); None when the native library is
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    B = len(reads)
    concat = b"".join(reads)
    offs = np.zeros(B + 1, dtype=np.int64)
    np.cumsum(np.asarray(lens, dtype=np.int64), out=offs[1:])
    out = np.empty((B, stride), dtype=np.uint8)
    lib.kt_pack_rows(
        concat,
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        B, stride,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out


_P4_LUT = None


def pack_rows_4bit(reads: list[bytes], lens: np.ndarray, stride: int):
    """Pack reads into [B, stride//2] uint8 with two 4-bit base codes
    per byte (A=1 C=2 G=3 T=4, case-insensitive, else 0; low nibble
    first) — half the H2D bytes of pack_rows for the device hash path
    (device_hash.unpack_reads decodes on device).  NumPy fallback when the
    native library predates kt_pack_rows_4bit."""
    assert stride % 2 == 0
    lib = get_lib()
    B = len(reads)
    if lib is not None and hasattr(lib, "kt_pack_rows_4bit"):
        concat = b"".join(reads)
        offs = np.zeros(B + 1, dtype=np.int64)
        np.cumsum(np.asarray(lens, dtype=np.int64), out=offs[1:])
        out = np.empty((B, stride // 2), dtype=np.uint8)
        lib.kt_pack_rows_4bit(
            concat,
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            B, stride,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return out
    global _P4_LUT
    if _P4_LUT is None:
        lut = np.zeros(256, dtype=np.uint8)
        for c, v in zip(b"ACGTacgt", (1, 2, 3, 4, 1, 2, 3, 4)):
            lut[c] = v
        _P4_LUT = lut
    mat = pack_rows(reads, lens, stride)
    if mat is None:
        mat = np.zeros((B, stride), dtype=np.uint8)
        for i, r in enumerate(reads):
            ln = min(len(r), stride)
            mat[i, :ln] = np.frombuffer(r[:ln], np.uint8)
    codes = _P4_LUT[mat]
    return (codes[:, 0::2] | (codes[:, 1::2] << np.uint8(4))).astype(
        np.uint8
    )


_P2_LUTS = None


def pack_rows_2bit(reads: list[bytes], lens: np.ndarray, stride: int):
    """Pack reads into (codes [B, stride//4] uint8, nmask [B, stride//8]
    uint8): four 2-bit base codes per byte (A=0 C=1 G=2 T=3, low pair
    first) plus an invalid bitmap (bit i%8 of byte i//8 set = not
    ACGT; padding invalid) — 0.375x the ASCII bytes vs pack_rows_4bit's
    0.5x (device_hash.unpack_reads decodes on device).  NumPy fallback
    when the
    native library predates kt_pack_rows_2bit."""
    assert stride % 8 == 0
    lib = get_lib()
    B = len(reads)
    if lib is not None and hasattr(lib, "kt_pack_rows_2bit"):
        concat = b"".join(reads)
        offs = np.zeros(B + 1, dtype=np.int64)
        np.cumsum(np.asarray(lens, dtype=np.int64), out=offs[1:])
        codes = np.empty((B, stride // 4), dtype=np.uint8)
        nmask = np.empty((B, stride // 8), dtype=np.uint8)
        lib.kt_pack_rows_2bit(
            concat,
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            B, stride,
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            nmask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return codes, nmask
    global _P2_LUTS
    if _P2_LUTS is None:
        c2 = np.zeros(256, dtype=np.uint8)
        vl = np.zeros(256, dtype=bool)
        for ch, v in zip(b"ACGTacgt", (0, 1, 2, 3, 0, 1, 2, 3)):
            c2[ch] = v
            vl[ch] = True
        _P2_LUTS = (c2, vl)
    c2, vl = _P2_LUTS
    mat = pack_rows(reads, lens, stride)
    if mat is None:
        mat = np.zeros((B, stride), dtype=np.uint8)
        for i, r in enumerate(reads):
            ln = min(len(r), stride)
            mat[i, :ln] = np.frombuffer(r[:ln], np.uint8)
    # padding bytes are 0 -> invalid via the validity LUT
    codes = c2[mat]
    packed = (
        codes[:, 0::4]
        | (codes[:, 1::4] << np.uint8(2))
        | (codes[:, 2::4] << np.uint8(4))
        | (codes[:, 3::4] << np.uint8(6))
    ).astype(np.uint8)
    nmask = np.packbits(~vl[mat], axis=1, bitorder="little")
    return packed, nmask


def hash_reads_loc(
    reads: list[bytes],
    k: int,
    kmax: int,
    num_sigs: int,
    num_hashes: int = 1,
    canonical: bool = True,
    max_hash: int | None = None,
    threads: int = 0,
    dedup_threshold: int = 0,
    minimizer_w: int = 0,
    syncmer_s: int = 0,
):
    """Fused batched hash+mod: reads -> padded [B, kmax, h] int32 Bloom
    locations (padding lanes point at the sentinel row ``num_sigs``) plus
    per-read k-mer counts.  Returns None if native lib unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    B = len(reads)
    concat = b"".join(reads)
    lens = np.array([len(r) for r in reads], dtype=np.int64)
    starts = np.zeros(B, dtype=np.int64)
    if B > 1:
        np.cumsum(lens[:-1], out=starts[1:])
    out = np.empty((B, kmax, num_hashes), dtype=np.int32)
    counts = np.empty(B, dtype=np.int64)
    if threads <= 0:
        threads = min(os.cpu_count() or 1, 16)
    lib.kt_hash_reads_loc(
        concat,
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        B, k, int(canonical),
        np.uint64(max_hash if max_hash is not None else 0xFFFFFFFFFFFFFFFF),
        np.uint64(num_sigs), num_hashes,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        kmax,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        threads, dedup_threshold, minimizer_w, syncmer_s,
    )
    return out, counts


_write_buf: np.ndarray | None = None


def _get_write_buf(size: int) -> np.ndarray:
    global _write_buf
    if _write_buf is None or _write_buf.nbytes < size:
        _write_buf = np.empty(int(size * 1.5), dtype=np.uint8)
    return _write_buf


def make_strtab(strings: list[bytes]) -> tuple[bytes, np.ndarray]:
    """(data, offsets[n+1]) flat string table for the native writer."""
    offsets = np.zeros(len(strings) + 1, dtype=np.int64)
    np.cumsum(
        np.fromiter(map(len, strings), np.int64, len(strings)),
        out=offsets[1:],
    )
    return b"".join(strings), offsets


def write_rows(
    qi: np.ndarray, t: np.ndarray, cnt: np.ndarray,
    qlen: np.ndarray, nkmers: np.ndarray, hits: np.ndarray,
    flags: np.ndarray,
    qid_tab, tname_tab, tmeta_tab,
    sizes: np.ndarray,
    fpr_tab, fpr_nmax: int,
    qidx_base: int,
    keep_unmatched: bool = False,
    k: int = 0,
) -> bytes | None:
    """Format match rows natively; returns the TSV bytes or None.
    With ``keep_unmatched``, reads with no hits emit the reference's
    unmatched row (kSize column = ``k``; flags bit1 marks too-short
    reads whose k-mer count reports as 0)."""
    lib = get_lib()
    if lib is None:
        return None
    n_rows = len(qi)
    n_reads = len(qlen)
    est = (n_rows + (n_reads if keep_unmatched else 0)) * 256 + 64
    buf = _get_write_buf(est)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)

    def p32(a):
        return np.ascontiguousarray(a, dtype=np.int32).ctypes.data_as(i32p)

    def p64(a):
        return np.ascontiguousarray(a, dtype=np.int64).ctypes.data_as(i64p)

    qi32, t32, c32 = (
        np.ascontiguousarray(qi, np.int32),
        np.ascontiguousarray(t, np.int32),
        np.ascontiguousarray(cnt, np.int32),
    )
    ql64, nk64 = (
        np.ascontiguousarray(qlen, np.int64),
        np.ascontiguousarray(nkmers, np.int64),
    )
    h32 = np.ascontiguousarray(hits, np.int32)
    f8 = np.ascontiguousarray(flags, np.uint8)
    sz64 = np.ascontiguousarray(sizes, np.int64)
    qd, qo = qid_tab
    td, to = tname_tab
    md, mo = tmeta_tab
    fd, fo = fpr_tab
    n = lib.kt_write_rows(
        qi32.ctypes.data_as(i32p), t32.ctypes.data_as(i32p),
        c32.ctypes.data_as(i32p), n_rows,
        n_reads, ql64.ctypes.data_as(i64p), nk64.ctypes.data_as(i64p),
        h32.ctypes.data_as(i32p),
        f8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        qd, qo.ctypes.data_as(i64p),
        td, to.ctypes.data_as(i64p),
        md, mo.ctypes.data_as(i64p),
        sz64.ctypes.data_as(i64p),
        fd, fo.ctypes.data_as(i64p), fpr_nmax,
        qidx_base, buf.ctypes.data,
        int(keep_unmatched), (ks := str(k).encode()), len(ks),
    )
    return buf[:n].tobytes()


def build_word_column(
    hashes_concat: np.ndarray, offsets: np.ndarray, n_targets: int,
    num_hashes: int, num_sigs: int,
) -> np.ndarray | None:
    """Build one uint32 word column (<=32 targets) of a Bloom matrix."""
    lib = get_lib()
    if lib is None:
        return None
    col = np.zeros(num_sigs, dtype=np.uint32)
    h = np.ascontiguousarray(hashes_concat, dtype=np.uint64)
    off = np.ascontiguousarray(offsets, dtype=np.int64)
    lib.kt_build_word_column(
        h.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_targets, num_hashes, np.uint64(num_sigs),
        col.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    return col


def count_block(
    bits_ext: np.ndarray, loc: np.ndarray, num_hashes: int, threads: int = 0,
    active: np.ndarray | None = None,
) -> np.ndarray | None:
    """[B, W*32] int32 match counts on host (C++ sparse-bit iteration).
    ``active`` (uint8 per read) skips screened reads (zero counts)."""
    lib = get_lib()
    if lib is None:
        return None
    Sp1, W = bits_ext.shape
    B, K = loc.shape[0], loc.shape[1]
    bits_c = np.ascontiguousarray(bits_ext, dtype=np.uint32)
    loc_c = np.ascontiguousarray(loc, dtype=np.int32)
    out = np.empty((B, W * 32), dtype=np.int32)
    if threads <= 0:
        threads = min(os.cpu_count() or 1, 16)
    act_p = None
    if active is not None:
        active = np.ascontiguousarray(active, dtype=np.uint8)
        act_p = active.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    lib.kt_count_block(
        bits_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), W,
        loc_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), B, K,
        num_hashes,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), threads, act_p,
    )
    return out


def count_block_sparse(
    bits_ext: np.ndarray, loc: np.ndarray, num_hashes: int,
    cmin_per_read: np.ndarray, tmin_eff: np.ndarray,
    t_offset: int, t_total: int, budget: int,
    idx_out: np.ndarray, cnt_out: np.ndarray, cursor: int,
    threads: int = 0, active: np.ndarray | None = None,
) -> int | None:
    """Fused count+threshold+compaction (large-T path): appends passing
    (flat_idx, cnt) candidates into idx_out/cnt_out starting at
    ``cursor``; returns the new total (may exceed ``budget`` — caller
    retries).  None when the native library lacks the kernel."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "kt_count_block_sparse"):
        return None
    Sp1, W = bits_ext.shape
    B, K = loc.shape[0], loc.shape[1]
    bits_c = np.ascontiguousarray(bits_ext, dtype=np.uint32)
    loc_c = np.ascontiguousarray(loc, dtype=np.int32)
    cmin_c = np.ascontiguousarray(cmin_per_read, dtype=np.int32)
    tmin_c = np.ascontiguousarray(tmin_eff, dtype=np.int32)
    assert tmin_c.shape[0] == W * 32 and cmin_c.shape[0] == B
    assert idx_out.dtype == np.int64 and cnt_out.dtype == np.int32
    if threads <= 0:
        threads = min(os.cpu_count() or 1, 16)
    act_p = None
    if active is not None:
        active = np.ascontiguousarray(active, dtype=np.uint8)
        act_p = active.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    return int(
        lib.kt_count_block_sparse(
            bits_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), W,
            loc_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), B, K,
            num_hashes,
            cmin_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            tmin_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            act_p, t_offset, t_total, budget,
            idx_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            cnt_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            cursor, threads,
        )
    )


def count_hashes_sparse(
    bits_ext: np.ndarray, hashes: np.ndarray, num_hashes: int,
    num_sigs: int, row_offset: int,
    cmin_per_read: np.ndarray, tmin_eff: np.ndarray,
    t_offset: int, t_total: int, budget: int,
    idx_out: np.ndarray, cnt_out: np.ndarray, cursor: int,
    threads: int = 0, active: np.ndarray | None = None,
) -> int | None:
    """count_block_sparse on raw uint64 hashes: Bloom locations derive
    in-kernel (one native call per block, no loc intermediates)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "kt_count_hashes_sparse"):
        return None
    Sp1, W = bits_ext.shape
    B, K = hashes.shape
    bits_c = np.ascontiguousarray(bits_ext, dtype=np.uint32)
    h_c = np.ascontiguousarray(hashes, dtype=np.uint64)
    cmin_c = np.ascontiguousarray(cmin_per_read, dtype=np.int32)
    tmin_c = np.ascontiguousarray(tmin_eff, dtype=np.int32)
    assert tmin_c.shape[0] == W * 32 and cmin_c.shape[0] == B
    assert idx_out.dtype == np.int64 and cnt_out.dtype == np.int32
    if threads <= 0:
        threads = min(os.cpu_count() or 1, 16)
    act_p = None
    if active is not None:
        active = np.ascontiguousarray(active, dtype=np.uint8)
        act_p = active.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    return int(
        lib.kt_count_hashes_sparse(
            bits_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), W,
            h_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), B, K,
            num_hashes, num_sigs, row_offset,
            cmin_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            tmin_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            act_p, t_offset, t_total, budget,
            idx_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            cnt_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            cursor, threads,
        )
    )


def union_fill(
    hashes: np.ndarray,
    num_bits: int,
    threads: int = 0,
    out: np.ndarray | None = None,
):
    """Bloom bitset (1 hash) over ``hashes % num_bits``: the per-block
    union screen.  ORs into ``out`` when given (the C++ kernel
    accumulates in place — building a block's union target-by-target
    into one buffer instead of allocating a fresh multi-hundred-MB array
    per target, which cost ~17 min/block at GTDB scale).  Returns the
    uint64 words or None."""
    lib = get_lib()
    if lib is None:
        return None
    h = np.ascontiguousarray(hashes, dtype=np.uint64).ravel()
    words = (
        out
        if out is not None
        else np.zeros((num_bits + 63) // 64, dtype=np.uint64)
    )
    if threads <= 0:
        threads = min(os.cpu_count() or 1, 16)
    lib.kt_union_fill(
        h.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(h),
        np.uint64(num_bits),
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), threads,
    )
    return words


def union_count(
    words: np.ndarray, num_bits: int, hashes: np.ndarray, threads: int = 0
):
    """Per-read count of k-mers present in a union bitset; hashes is the
    padded [B, kmax] matrix (0 = padding)."""
    lib = get_lib()
    if lib is None:
        return None
    w = np.ascontiguousarray(words, dtype=np.uint64)
    h = np.ascontiguousarray(hashes, dtype=np.uint64)
    B, kmax = h.shape
    out = np.empty(B, dtype=np.int32)
    if threads <= 0:
        threads = min(os.cpu_count() or 1, 16)
    lib.kt_union_count(
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        np.uint64(num_bits),
        h.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), B, kmax,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), threads,
    )
    return out


def locations(
    hashes: np.ndarray, num_hashes: int, num_sigs: int, threads: int = 0
):
    """Bloom-row positions for a hash array (any shape); returns int32 with
    an extra trailing ``num_hashes`` axis, or None if native unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    flat = np.ascontiguousarray(hashes, dtype=np.uint64).ravel()
    out = np.empty(flat.shape[0] * num_hashes, dtype=np.int32)
    if threads <= 0:
        threads = min(os.cpu_count() or 1, 16)
    lib.kt_locations(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        flat.shape[0], num_hashes, num_sigs,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        threads,
    )
    return out.reshape(*hashes.shape, num_hashes)


def parse_search_tsv(buf: bytes, max_fpr: float, min_qcov: float):
    """Columnar parse of one search-result TSV's decompressed content
    (row filters qCov >= min / FPR <= max, consecutive-query grouping,
    target interning — util-profile.go:94-182 semantics).

    Returns a dict of arrays: group/target/frag/qlen/qcov per row,
    tgt_names (list[bytes]), tgt_idx_num, tgt_gsize per target,
    grp_query (list[bytes]) per group, total_queries; or None when the
    native library is unavailable.  Raises ValueError on malformed rows.
    """
    lib = get_lib()
    if lib is None:
        return None
    # capacity: number of newlines bounds rows/groups/targets
    cap = max(buf.count(b"\n") + 1, 1)
    i64 = ctypes.POINTER(ctypes.c_int64)
    i32 = ctypes.POINTER(ctypes.c_int32)
    f64 = ctypes.POINTER(ctypes.c_double)
    row_group = np.empty(cap, dtype=np.int64)
    row_target = np.empty(cap, dtype=np.int32)
    row_frag = np.empty(cap, dtype=np.int32)
    row_qlen = np.empty(cap, dtype=np.int64)
    row_qcov = np.empty(cap, dtype=np.float64)
    tgt_off = np.empty(cap, dtype=np.int64)
    tgt_len = np.empty(cap, dtype=np.int64)
    tgt_idx_num = np.empty(cap, dtype=np.int32)
    tgt_gsize = np.empty(cap, dtype=np.int64)
    grp_off = np.empty(cap, dtype=np.int64)
    grp_len = np.empty(cap, dtype=np.int64)
    counts = np.zeros(5, dtype=np.int64)
    rc = lib.kt_parse_search_tsv(
        buf, len(buf), max_fpr, min_qcov,
        row_group.ctypes.data_as(i64), row_target.ctypes.data_as(i32),
        row_frag.ctypes.data_as(i32), row_qlen.ctypes.data_as(i64),
        row_qcov.ctypes.data_as(f64),
        tgt_off.ctypes.data_as(i64), tgt_len.ctypes.data_as(i64),
        tgt_idx_num.ctypes.data_as(i32), tgt_gsize.ctypes.data_as(i64),
        grp_off.ctypes.data_as(i64), grp_len.ctypes.data_as(i64),
        counts.ctypes.data_as(i64),
    )
    if rc != 0:
        raise ValueError("invalid kmcp search result format")
    n_rows, n_groups, n_targets, total_q, matched_q = (
        int(c) for c in counts
    )
    return {
        "group": row_group[:n_rows],
        "target": row_target[:n_rows],
        "frag": row_frag[:n_rows],
        "qlen": row_qlen[:n_rows],
        "qcov": row_qcov[:n_rows],
        "tgt_names": [
            buf[int(o) : int(o) + int(l)]
            for o, l in zip(tgt_off[:n_targets], tgt_len[:n_targets])
        ],
        "tgt_idx_num": tgt_idx_num[:n_targets].copy(),
        "tgt_gsize": tgt_gsize[:n_targets].copy(),
        "grp_off": grp_off[:n_groups].copy(),
        "grp_len": grp_len[:n_groups].copy(),
        "total_queries": total_q,
        "matched_queries": matched_q,
    }


def merge_scan(buf: bytes, score_col: int):
    """Scan one search TSV for the k-way merge: per-row spans, hits-column
    spans, query-id lengths, queryIdx and score, plus the file's stat-line
    totals.  None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    cap = max(buf.count(b"\n") + 1, 1)
    i64 = ctypes.POINTER(ctypes.c_int64)
    f64 = ctypes.POINTER(ctypes.c_double)
    row_off = np.empty(cap, dtype=np.int64)
    row_len = np.empty(cap, dtype=np.int64)
    hits_off = np.empty(cap, dtype=np.int64)
    hits_len = np.empty(cap, dtype=np.int64)
    qid_len = np.empty(cap, dtype=np.int64)
    qidx = np.empty(cap, dtype=np.int64)
    score = np.empty(cap, dtype=np.float64)
    counts = np.zeros(3, dtype=np.int64)
    rc = lib.kt_merge_scan(
        buf, len(buf), score_col,
        row_off.ctypes.data_as(i64), row_len.ctypes.data_as(i64),
        hits_off.ctypes.data_as(i64), hits_len.ctypes.data_as(i64),
        qid_len.ctypes.data_as(i64), qidx.ctypes.data_as(i64),
        score.ctypes.data_as(f64), counts.ctypes.data_as(i64),
    )
    if rc != 0:
        raise ValueError("invalid kmcp search result format")
    n = int(counts[0])
    return {
        "row_off": row_off[:n], "row_len": row_len[:n],
        "hits_off": hits_off[:n], "hits_len": hits_len[:n],
        "qid_len": qid_len[:n], "qidx": qidx[:n], "score": score[:n],
        "total_queries": int(counts[1]),
        "matched_queries": int(counts[2]),
    }


def merge_emit(buf: bytes, order, row_off, row_len, hits_off, hits_len,
               qid_len, qidx, hits):
    """Assemble merged output rows (hits column rewritten) in ``order``.
    Returns bytes, or raises SystemExit on a query-id mismatch within a
    queryIdx group (reporting the offending output position)."""
    lib = get_lib()
    n_out = len(order)
    bufsize = int(row_len.sum()) + n_out * 12 + 64
    out = _get_write_buf(bufsize)
    i64 = ctypes.POINTER(ctypes.c_int64)
    i32 = ctypes.POINTER(ctypes.c_int32)
    rc = lib.kt_merge_emit(
        buf, n_out,
        np.ascontiguousarray(order, dtype=np.int64).ctypes.data_as(i64),
        np.ascontiguousarray(row_off, dtype=np.int64).ctypes.data_as(i64),
        np.ascontiguousarray(row_len, dtype=np.int64).ctypes.data_as(i64),
        np.ascontiguousarray(hits_off, dtype=np.int64).ctypes.data_as(i64),
        np.ascontiguousarray(hits_len, dtype=np.int64).ctypes.data_as(i64),
        np.ascontiguousarray(qid_len, dtype=np.int64).ctypes.data_as(i64),
        np.ascontiguousarray(qidx, dtype=np.int64).ctypes.data_as(i64),
        np.ascontiguousarray(hits, dtype=np.int32).ctypes.data_as(i32),
        out.ctypes.data,
    )
    if rc < 0:
        i = -int(rc) - 2
        r = int(order[i])
        row = buf[int(row_off[r]) : int(row_off[r]) + int(row_len[r])]
        qid = row.split(b"\t", 1)[0].decode()
        raise SystemExit(
            f"[queryIdx: {int(qidx[r])}] unmatched sequence Ids: "
            f"'{qid}' — results must come from the same query file"
        )
    return out[:rc].tobytes()


def sort_unique(hashes: np.ndarray, threads: int = 0) -> np.ndarray | None:
    """Parallel in-place sort + unique of a uint64 array; returns the
    unique sorted values (a view of the scratch copy) or None when the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(hashes, dtype=np.uint64).copy()
    if threads <= 0:
        threads = min(os.cpu_count() or 1, 16)
    m = lib.kt_sort_unique(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(a), threads
    )
    return a[:m]


def count_blocks(
    bits_ext: np.ndarray, hashes: np.ndarray, num_hashes: int,
    row_off: np.ndarray, num_sigs: np.ndarray, threads: int = 0,
) -> np.ndarray | None:
    """Fused multi-block counting: derive per-block Bloom locations from
    the raw padded [B, K] hash matrix and count matched k-mers for every
    block of a row-stacked common-width matrix, in one call (the
    reference-layout many-narrow-blocks host path)."""
    lib = get_lib()
    if lib is None:
        return None
    rows, w = bits_ext.shape
    B, K = hashes.shape
    nb = len(row_off)
    bits_c = np.ascontiguousarray(bits_ext, dtype=np.uint32)
    h_c = np.ascontiguousarray(hashes, dtype=np.uint64)
    ro = np.ascontiguousarray(row_off, dtype=np.int64)
    ns = np.ascontiguousarray(num_sigs, dtype=np.uint64)
    wo = (np.arange(nb, dtype=np.int64) * w)
    bw = np.full(nb, w, dtype=np.int64)
    out = np.empty((B, nb * w * 32), dtype=np.int32)
    if threads <= 0:
        threads = min(os.cpu_count() or 1, 16)
    i64 = ctypes.POINTER(ctypes.c_int64)
    lib.kt_count_blocks(
        bits_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), w,
        h_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), B, K,
        num_hashes, nb,
        ro.ctypes.data_as(i64),
        ns.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        wo.ctypes.data_as(i64), bw.ctypes.data_as(i64),
        np.int64(nb * w),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), threads,
    )
    return out
