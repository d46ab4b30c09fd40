"""Seeded synthetic metagenome: genomes, reads, taxonomy.

The demo community has the shape of KMCP's demo-profiling set: 15
genomes at designed relative depths 1 (x5), 0.1 (x4), 0.05 (x2), 0.01
(x2) and 0.005 (x2), with a taxonomy of one kingdom down to 15 species.
Genomes are uniform-random ACGT of 1-5 Mb; reads are 150 bp, single-end
and as pairs (insert 350 bp, mate 2 reverse-complemented), with ~1%
substitutions, an N in 2% of reads and 10% junk reads (random sequence
from no genome).  Everything follows from ``seed``.

    python tools/synth_data.py OUT_DIR [--seed 1] [--scale 1.0]
        [--min-len 1000000] [--max-len 5000000]

writes OUT_DIR/refs/G00.fa ..., reads_se.fq, reads_1.fq, reads_2.fq,
taxdump/{nodes,names}.dmp, taxid.map and truth.tsv (genome, depth, %).
Used by chip_smoke.py, bench.py and the tests (at small sizes).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

DEPTHS = [1, 1, 1, 1, 1, 0.1, 0.1, 0.1, 0.1, 0.05, 0.05, 0.01, 0.01,
          0.005, 0.005]
READ_LEN = 150
INSERT = 350
_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMP = np.zeros(256, dtype=np.uint8)
_COMP[list(b"ACGTN")] = list(b"TGCAN")

# (rank, fan-in): species i sits in genus i//3, family i//6, ...
_RANKS = [("genus", 3), ("family", 2), ("order", 2), ("class", 2),
          ("phylum", 2)]


def genome_names(n: int = len(DEPTHS)) -> list[str]:
    return [f"G{i:02d}" for i in range(n)]


def _mutate(reads: np.ndarray, rng, sub_rate: float, n_rate: float):
    """In place: ~sub_rate random substitutions per base, one N in
    n_rate of the reads."""
    sub = rng.random(reads.shape) < sub_rate
    reads[sub] = _ACGT[rng.integers(0, 4, int(sub.sum()))]
    rows = np.nonzero(rng.random(reads.shape[0]) < n_rate)[0]
    reads[rows, rng.integers(0, reads.shape[1], len(rows))] = ord("N")


def _write_fastq(path: str, names: list[str], reads: np.ndarray):
    qual = b"I" * reads.shape[1]
    with open(path, "wb") as f:
        for name, r in zip(names, reads):
            f.write(b"@" + name.encode() + b"\n" + r.tobytes() + b"\n+\n"
                    + qual + b"\n")


def _write_taxdump(out: str, names: list[str]) -> dict[str, int]:
    """nodes.dmp/names.dmp for root -> Bacteria -> phylum ... genus ->
    species; returns genome -> species taxid."""
    os.makedirs(out, exist_ok=True)
    nodes = [(1, 1, "no rank", "root"), (2, 1, "superkingdom", "Bacteria")]
    ids: dict[tuple[int, int], int] = {}

    def node(level: int, j: int) -> int:
        if (level, j) not in ids:
            parent = (
                2 if level == len(_RANKS) - 1
                else node(level + 1, j // _RANKS[level + 1][1])
            )
            ids[(level, j)] = 10 + len(nodes)
            rank = _RANKS[level][0]
            nodes.append((ids[(level, j)], parent, rank, f"Synth {rank} {j}"))
        return ids[(level, j)]

    taxids = {}
    for i, g in enumerate(names):
        parent = node(0, i // _RANKS[0][1])
        taxids[g] = 10 + len(nodes)
        nodes.append((taxids[g], parent, "species", f"Synthia {g}"))
    with open(os.path.join(out, "nodes.dmp"), "w") as f:
        for t, p, r, _n in nodes:
            f.write(f"{t}\t|\t{p}\t|\t{r}\t|\t\t|\n")
    with open(os.path.join(out, "names.dmp"), "w") as f:
        for t, _p, _r, n in nodes:
            f.write(f"{t}\t|\t{n}\t|\t\t|\tscientific name\t|\n")
    return taxids


def make_demo(out_dir: str, seed: int = 1, scale: float = 1.0,
              min_len: int = 1_000_000, max_len: int = 5_000_000,
              junk: float = 0.10) -> dict:
    """Write the demo community to ``out_dir`` (idempotent: a finished
    directory is reused).  ``scale`` multiplies the read depth (depth 1
    = one genome's worth of bases in reads).  Returns the paths and the
    truth (genome -> % abundance, its share of the depths)."""
    names = genome_names()
    done = os.path.join(out_dir, "truth.tsv")
    paths = {
        "refs": os.path.join(out_dir, "refs"),
        "se": os.path.join(out_dir, "reads_se.fq"),
        "r1": os.path.join(out_dir, "reads_1.fq"),
        "r2": os.path.join(out_dir, "reads_2.fq"),
        "taxdump": os.path.join(out_dir, "taxdump"),
        "taxid_map": os.path.join(out_dir, "taxid.map"),
        "truth": done,
    }
    if os.path.isfile(done):
        with open(done) as f:
            truth = {l.split("\t")[0]: float(l.split("\t")[2]) for l in f}
        return {**paths, "truth_pct": truth, "names": names}
    rng = np.random.default_rng(seed)
    os.makedirs(paths["refs"], exist_ok=True)
    lens = rng.integers(min_len, max_len + 1, len(names))
    se, p1, p2, se_names, pair_names = [], [], [], [], []
    for g, glen, depth in zip(names, lens, DEPTHS):
        seq = _ACGT[rng.integers(0, 4, int(glen))]
        with open(os.path.join(paths["refs"], f"{g}.fa"), "wb") as f:
            f.write(f">{g} synthetic genome\n".encode())
            f.write(seq.tobytes() + b"\n")
        n = max(1, int(depth * scale * glen / READ_LEN))
        starts = rng.integers(0, glen - READ_LEN + 1, n)
        se.append(seq[starts[:, None] + np.arange(READ_LEN)])
        se_names += [f"{g}_r{i}" for i in range(n)]
        n_p = max(1, n // 2)
        st = rng.integers(0, glen - INSERT + 1, n_p)
        p1.append(seq[st[:, None] + np.arange(READ_LEN)])
        m2 = seq[st[:, None] + INSERT - READ_LEN + np.arange(READ_LEN)]
        p2.append(_COMP[m2[:, ::-1]])
        pair_names += [f"{g}_p{i}" for i in range(n_p)]
    for reads, rn in ((se, se_names), (p1, pair_names)):
        n_junk = int(len(rn) * junk / (1 - junk))
        reads.append(_ACGT[rng.integers(0, 4, (n_junk, READ_LEN))])
        rn += [f"junk_{i}" for i in range(n_junk)]
    p2.append(_ACGT[rng.integers(0, 4, (len(pair_names) - sum(
        len(x) for x in p2), READ_LEN))])
    se, p1, p2 = (np.concatenate(x) for x in (se, p1, p2))
    for reads in (se, p1, p2):
        _mutate(reads, rng, 0.01, 0.02)
    order = rng.permutation(len(se))
    _write_fastq(paths["se"], [se_names[i] for i in order], se[order])
    order = rng.permutation(len(p1))
    _write_fastq(paths["r1"], [pair_names[i] for i in order], p1[order])
    _write_fastq(paths["r2"], [pair_names[i] for i in order], p2[order])
    taxids = _write_taxdump(paths["taxdump"], names)
    with open(paths["taxid_map"], "w") as f:
        for g in names:
            f.write(f"{g}\t{taxids[g]}\n")
    truth = {g: d / sum(DEPTHS) * 100 for g, d in zip(names, DEPTHS)}
    with open(done + ".tmp", "w") as f:
        for g, d in zip(names, DEPTHS):
            f.write(f"{g}\t{d}\t{truth[g]}\n")
    os.replace(done + ".tmp", done)
    return {**paths, "truth_pct": truth, "names": names}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--min-len", type=int, default=1_000_000)
    ap.add_argument("--max-len", type=int, default=5_000_000)
    a = ap.parse_args(argv)
    d = make_demo(a.out_dir, a.seed, a.scale, a.min_len, a.max_len)
    print(f"synthetic demo in {a.out_dir}: {len(d['names'])} genomes",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
