"""Index construction: k-mer sets -> bit-sliced Bloom signature blocks.

Reimplements the reference's block partitioning and Bloom build
(/root/reference/kmcp/cmd/index.go:640-1319) on dense uint32 matrices:

- chunk files are sorted ascending by k-mer count and grouped into blocks
  of ``block_size`` (default ``max(8, min(n, (n//threads + 7)//8*8))``,
  index.go:671-682);
- three k-mer-count thresholds re-tier the block size mid-stream exactly
  like the reference's state machine (index.go:782-894): files above
  ``-x`` go into blocks of ``-X``, above ``-8`` into blocks of 8, above
  ``-1`` into single-file blocks;
- within a block, each run of 8 files is sorted by (name, chunk index)
  (index.go:1084);
- per block: ``num_sigs = calc_signature_size(max kmers, h, fpr)`` and each
  target's hash locations set bit t of row ``loc`` (index.go:1023,1107-1259).

The resulting per-target Bloom columns are bit-identical to the
reference's (same positions, same per-block sizing); only the physical
packing differs (uint32 LSB-first words instead of byte-interleaved
8-target groups).
"""

from __future__ import annotations

import os
import shutil
import sys

import numpy as np

from ..kmer import kset as ksetmod
from ..kmer.kset import KsetFileInfo, read_kset
from .format import (
    BlockMeta,
    DBInfo,
    write_block,
    write_db_info,
    write_name_mapping,
)
from .sizing import calc_signature_size, hash_locations, roundup64


def default_block_size(n_files: int, threads: int) -> int:
    s = (int(n_files / threads) + 7) // 8 * 8
    if s > n_files:
        s = n_files
    if s < 8:
        s = 8
    return s


def partition_blocks(
    infos: list[KsetFileInfo],
    block_size: int = 0,
    threads: int = 0,
    threshold_x: int = 10_000_000,
    block_size_x: int = 256,
    threshold_8: int = 20_000_000,
    threshold_1: int = 200_000_000,
) -> list[list[KsetFileInfo]]:
    """Faithful re-derivation of the index.go:782-894 state machine."""
    threads = threads or (os.cpu_count() or 1)
    infos = sorted(infos, key=lambda i: i.kmers)  # stable; index.go:667
    n = len(infos)
    s_block = block_size if block_size > 0 else default_block_size(n, threads)

    skip_block_x = block_size_x >= s_block
    if skip_block_x:
        block_size_x = s_block

    blocks: list[list[KsetFileInfo]] = []
    batch: list[KsetFileInfo] = []
    flag = flag8 = flag_x = False
    last: KsetFileInfo | None = None

    def emit():
        nonlocal batch
        if batch:
            blocks.append(batch)
            batch = []

    for i in range(n + 1):
        if i == n:
            if (flag or flag8 or flag_x) and last is not None:
                batch.append(last)
                last = None
            emit()
            break
        info = infos[i]
        if info.kmers == 0:
            continue
        if flag or flag8 or flag_x:
            if last is not None:
                batch.append(last)
                last = None
            if flag:
                last = info  # each big file gets its own block
            elif info.kmers > threshold_1:
                flag = True
                last = info
            elif skip_block_x:
                batch.append(info)
                if len(batch) < s_block:
                    continue
            elif info.kmers > threshold_8:
                if flag8:
                    batch.append(info)
                    if len(batch) < s_block:
                        continue
                else:
                    s_block = 8
                    flag8 = True
                    last = info
            else:  # flag_x tier
                batch.append(info)
                if len(batch) < s_block:
                    continue
        elif skip_block_x:
            if info.kmers > threshold_8:
                if info.kmers > threshold_1:
                    flag = True
                else:
                    s_block = block_size_x
                    flag_x = True
                last = info
            else:
                batch.append(info)
                if len(batch) < s_block:
                    continue
        else:
            if info.kmers > threshold_x:
                if info.kmers > threshold_1:
                    flag = True
                elif info.kmers > threshold_8:
                    s_block = 8
                    flag8 = True
                else:
                    s_block = block_size_x
                    flag_x = True
                last = info
            else:
                batch.append(info)
                if len(batch) < s_block:
                    continue
        emit()

    return blocks


def order_block_targets(block: list[KsetFileInfo]) -> list[KsetFileInfo]:
    """Within a block, every run of 8 files is sorted by (name, chunk idx)
    (index.go:1051-1105)."""
    out: list[KsetFileInfo] = []
    for i in range(0, len(block), 8):
        out.extend(sorted(block[i : i + 8], key=lambda x: (x.name, x.index)))
    return out


def build_block_bits(
    targets: list[KsetFileInfo], num_sigs: int, num_hashes: int,
    threads: int = 0, union_bits: int = 0,
) -> np.ndarray | tuple[np.ndarray, np.ndarray | None]:
    """Scatter each target's hash locations into its bit column.

    The C++ path builds each uint32 word column (32 targets) in one pass
    (races impossible: one thread per word); word columns build in a
    thread pool since the C++ releases the GIL through ctypes.

    With ``union_bits`` > 0 the per-block k-mer-union screen bitset
    accumulates in the same pass over the kset files (returns
    ``(bits, union_words)``) — reading each multi-GB block's ksets once
    instead of twice, with the union ORed into one shared buffer under a
    lock (the OR itself is milliseconds; a fresh buffer per target was
    the round-2 rehearsal's 17-min/block pathology)."""
    import concurrent.futures as cf
    import threading

    from ..kmer import native

    num_targets = len(targets)
    num_words = (num_targets + 31) // 32
    bits = np.zeros((num_sigs, num_words), dtype=np.uint32)

    if native.get_lib() is not None:
        union_words = (
            np.zeros((union_bits + 63) // 64, dtype=np.uint64)
            if union_bits
            else None
        )
        union_lock = threading.Lock()

        def one_word(w: int):
            grp = targets[w * 32 : (w + 1) * 32]
            hs = [np.asarray(read_kset(i.path)[0]) for i in grp]
            offsets = np.zeros(len(hs) + 1, dtype=np.int64)
            np.cumsum([len(h) for h in hs], out=offsets[1:])
            concat = (
                np.concatenate(hs) if hs else np.empty(0, np.uint64)
            )
            if union_words is not None and len(concat):
                with union_lock:
                    native.union_fill(concat, union_bits, out=union_words)
            return w, native.build_word_column(
                concat, offsets, len(grp), num_hashes, num_sigs
            )

        workers = threads or min(os.cpu_count() or 1, 8)
        with cf.ThreadPoolExecutor(max_workers=workers) as ex:
            for w, col in ex.map(one_word, range(num_words)):
                bits[:, w] = col
        return (bits, union_words) if union_bits else bits

    col = np.empty(num_sigs, dtype=bool)
    for t, info in enumerate(targets):
        hashes, _ = read_kset(info.path)
        locs = hash_locations(hashes, num_hashes, num_sigs).ravel()
        col[:] = False
        col[locs] = True
        bits[:, t >> 5] |= col.astype(np.uint32) << np.uint32(t & 31)
    return (bits, None) if union_bits else bits


SCREEN_FPR_U = 0.25


def _union_screen_bits(targets, fpr_u: float = SCREEN_FPR_U) -> int:
    """Bit count for a block's k-mer-union Bloom screen (1 hash,
    fpr_u <= SCREEN_FPR_U) — the large-T block screen: reads sharing
    no k-mers with a block's union skip its dense count entirely
    (kmcp-tpu native extension; the reference counts every block for
    every read).  The union itself accumulates inside
    build_block_bits' single pass over the kset files.

    Rounded UP to a power of two (<= 2x the designed size): the device
    hash's screen modulus then lowers to a single AND instead of a
    fold-and-double chain (device_hash.make_mod_pair),
    and the oversize only LOWERS the screen's false-positive rate —
    the stored fpr is the exact value for the rounded size, so the
    theta band tightens to match on both backends."""
    from .sizing import calc_signature_size

    total = sum(t.kmers for t in targets)
    bits = calc_signature_size(max(total, 1), 1, fpr_u)
    return 1 << max(6, (int(bits) - 1).bit_length())


def _union_screen_fpr(union_bits: int, targets) -> float:
    """Exact 1-hash Bloom FPR of the (power-of-two-rounded) union
    screen: 1 - (1 - 1/m)^n.  Stored in the union header and consumed
    by the identical float64 theta math on both backends
    (HostDB.screen_active / DeviceDB._theta_for)."""
    import math

    total = max(sum(t.kmers for t in targets), 1)
    return -math.expm1(total * math.log1p(-1.0 / union_bits))


def run_index(
    in_dir: str,
    out_dir: str,
    num_hashes: int = 1,
    fpr: float = 0.3,
    block_size: int = 0,
    threads: int = 0,
    threshold_x: int = 10_000_000,
    block_size_x: int = 256,
    threshold_8: int = 20_000_000,
    threshold_1: int = 200_000_000,
    alias: str = "",
    force: bool = False,
    dry_run: bool = False,
    block_screen: bool = False,
    round_pow2: bool = False,
    tpu_native: bool = False,
    native_block_targets: int = 4096,
    uniform_sigs: bool = False,
    verbose: bool = True,
) -> DBInfo:
    infos = ksetmod.read_info(in_dir)
    if not infos:
        raise SystemExit(f"kmcp-tpu index: no .kset files listed in {in_dir}")

    # parameter consistency comes from the first kset header
    _, meta0 = read_kset(infos[0].path)

    if tpu_native:
        # TPU-native layout: a few WIDE blocks (many targets per Bloom row)
        # so the device gather fetches large contiguous rows, instead of
        # the reference's cache-line-sized 8-target groups.  Bloom sizing
        # is still per block by its largest member; sorting by k-mer count
        # keeps similarly-sized targets together to bound memory blowup.
        srt = sorted(infos, key=lambda i: i.kmers)
        bs = native_block_targets
        blocks = [srt[i : i + bs] for i in range(0, len(srt), bs)]
    else:
        blocks = partition_blocks(
            infos,
            block_size=block_size,
            threads=threads,
            threshold_x=threshold_x,
            block_size_x=block_size_x,
            threshold_8=threshold_8,
            threshold_1=threshold_1,
        )

    if not dry_run:
        # --dry-run only prints the block plan (index.go:141-144),
        # touching nothing on disk
        if os.path.exists(out_dir):
            if not force:
                raise SystemExit(
                    f"kmcp-tpu index: out dir exists: {out_dir} "
                    "(use --force)"
                )
            shutil.rmtree(out_dir)
        os.makedirs(out_dir)

    from ..utils.progress import ProgressBar

    # --uniform-sigs: size every block's Bloom (and union screen) by the
    # GLOBAL maximum so all blocks share one modulus geometry — required
    # by the device two-pass screened search on heterogeneous inputs
    # (device.py::two_pass_ready); costs memory on blocks of small
    # targets, changes only Bloom FP noise (never misses).
    forced_sigs = forced_union = 0
    if uniform_sigs:
        forced_sigs = calc_signature_size(
            max(max(t.kmers for t in b) for b in blocks), num_hashes, fpr
        )
        if round_pow2:
            forced_sigs = roundup64(forced_sigs)
        if block_screen:
            forced_union = max(_union_screen_bits(b) for b in blocks)

    block_files: list[str] = []
    total_kmers = 0
    all_names: list[str] = []
    bar = ProgressBar(
        len(blocks), "index", unit="blocks",
        enabled=verbose and not dry_run and len(blocks) > 1,
    )
    for bid, block in enumerate(blocks):
        targets = order_block_targets(block)
        max_elements = max(t.kmers for t in targets)
        num_sigs = forced_sigs or calc_signature_size(
            max_elements, num_hashes, fpr
        )
        if round_pow2:
            num_sigs = roundup64(num_sigs)
        if dry_run:
            print(
                f"[index] block {bid:03d}: {len(targets)} targets, "
                f"max k-mers {max_elements}, num_sigs {num_sigs}",
                file=sys.stderr,
            )
            continue
        union_bits = 0
        if block_screen:
            from ..kmer import native as _native

            if _native.get_lib() is not None:
                union_bits = forced_union or _union_screen_bits(targets)
        if union_bits:
            bits, union_words = build_block_bits(
                targets, num_sigs, num_hashes, union_bits=union_bits
            )
            if union_words is not None:
                from .format import write_block_union

                write_block_union(
                    out_dir, bid, union_words, union_bits,
                    _union_screen_fpr(union_bits, targets),
                )
        else:
            bits = build_block_bits(targets, num_sigs, num_hashes)
        meta = BlockMeta(
            names=[t.name for t in targets],
            gsizes=[t.genome_size for t in targets],
            indices=[t.index + (t.indexes << 16) for t in targets],
            sizes=[t.kmers for t in targets],
            num_sigs=num_sigs,
            num_targets=len(targets),
        )
        block_files.append(write_block(out_dir, bid, bits, meta))
        total_kmers += sum(t.kmers for t in targets)
        all_names.extend(meta.names)
        bar.advance()
    bar.close()

    info = DBInfo(
        alias=alias or os.path.basename(os.path.normpath(out_dir)),
        ks=meta0.ks,
        canonical=meta0.canonical,
        scaled=meta0.scaled,
        scale=meta0.scale,
        minimizer=meta0.minimizer,
        minimizer_w=meta0.minimizer_w,
        syncmer=meta0.syncmer,
        syncmer_s=meta0.syncmer_s,
        split_seq=meta0.split_seq,
        split_num=meta0.split_num,
        split_size=meta0.split_size,
        split_overlap=meta0.split_overlap,
        num_hashes=num_hashes,
        fpr=fpr,
        num_names=sum(len(b) for b in blocks),
        block_size=block_size or default_block_size(len(infos), threads or (os.cpu_count() or 1)),
        total_kmers=total_kmers,
        blocks=block_files,
    )
    if not dry_run:
        write_db_info(out_dir, info)
        write_name_mapping(out_dir, sorted(set(all_names)))
        if verbose:
            print(
                f"[index] built {len(block_files)} block(s), "
                f"{info.num_names} targets, {total_kmers} k-mers -> {out_dir}",
                file=sys.stderr,
            )
    return info
