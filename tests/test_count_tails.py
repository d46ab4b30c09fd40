"""The device count tails against brute-force NumPy oracles.

`_make_count_tail` (dense: every target of a single block) and
`_make_screened_tail` (two-pass: union screen, then only the active
(read, block) pairs) receive random bit matrices and location planes;
their (meta, aux) results must equal a direct per-window, per-target
count with the same integer thresholds — candidates ascending by
(read, target), counts, per-read k-mer counts and the overflow poison
(n_cand = budget + 1) that makes the stream retry with a larger budget.
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from kmcp_tpu.search.device import (  # noqa: E402
    _make_count_tail,
    _make_screened_tail,
)

MIN_LEN, DEDUP = 30, 256


def _bit_table(bits):
    """uint32 [S, W] -> bool [S, W*32], target w*32 + j = bit j."""
    S, W = bits.shape
    return np.unpackbits(
        bits.view(np.uint8), bitorder="little", axis=1
    ).reshape(S, W * 32).astype(bool)


def _dense_oracle(bits, loc_ts, nk, lens, cmin, tmin, spos):
    """Flat candidate ids (b*T + t) and counts, ascending."""
    tab = _bit_table(bits)
    K, B = loc_ts[0].shape
    counts = np.zeros((B, tab.shape[1]), np.int64)
    for kk in range(K):
        acc = np.ones((B, tab.shape[1]), bool)
        for loc in loc_ts:
            acc &= tab[loc[kk]]
        counts += acc
    thr = cmin[np.minimum(nk, len(cmin) - 1)][:, None]
    ok = (
        (counts >= thr) & (counts >= tmin[None, :]) & spos[None, :]
        & (lens >= MIN_LEN)[:, None] & (nk <= DEDUP)[:, None]
    )
    flat = np.nonzero(ok.reshape(-1))[0]
    return flat, counts.reshape(-1)[flat]


def _dense_inputs(K, W, H, seed):
    rng = np.random.default_rng(seed)
    S, B = 61, 16
    T = W * 32
    bits = rng.integers(0, 2**32, (S + 1, W), dtype=np.uint64).astype(
        np.uint32
    )
    bits[S] = 0  # sentinel row (invalid windows)
    loc_ts = []
    for _ in range(H):
        loc = rng.integers(0, S, (K, B)).astype(np.int32)
        loc[rng.random((K, B)) < 0.1] = S
        loc_ts.append(loc)
    nk = (loc_ts[0] != S).sum(axis=0).astype(np.int32)
    lens = np.full(B, 150, np.int32)
    lens[0] = 10  # below min_len: drops entirely
    nk[1] = DEDUP + 1  # over the dedup threshold: drops entirely
    # random rows are ~50% dense per hash: a floor above the mean keeps
    # the candidate set sparse like a real search
    floor = max(1, int(K * 0.5**H) + 1)
    cmin = np.full(K + 1 + DEDUP + 1, floor, np.int32)
    tmin = np.zeros(T, np.int32)
    tmin[::3] = floor + 1
    spos = np.ones(T, bool)
    spos[T - 5:] = False  # padding target lanes
    return bits, loc_ts, nk, lens, cmin, tmin, spos


def _run_dense(bits, loc_ts, nk, lens, cmin, tmin, spos, budget, chunks):
    tail = _make_count_tail(budget, MIN_LEN, DEDUP, chunks)
    meta, aux = tail(
        jnp.asarray(bits), tuple(jnp.asarray(x) for x in loc_ts),
        jnp.asarray(nk[None]), jnp.asarray(lens), jnp.asarray(cmin),
        jnp.asarray(tmin), jnp.asarray(spos),
    )
    return np.asarray(meta), np.asarray(aux)


@pytest.mark.parametrize("W", [64, 128, 1024])
@pytest.mark.parametrize("K", [5, 16, 33, 130])
def test_count_tail_matches_brute_oracle(K, W):
    """Every counter regime of the CSA contraction (_unpack_count):
    below one 16-plane group (5), one exact group (16), group + upper
    carries (33) and the 150 bp read shape (130 windows at k=21), over
    narrow to wide rows; unchunked and chunked tails both equal the
    oracle, too-short and over-dedup reads drop."""
    ins = _dense_inputs(K, W, 1, K * 1000 + W)
    want_idx, want_cnt = _dense_oracle(*ins)
    B = ins[3].shape[0]
    budget = B * W * 32  # never overflows: exact comparison
    for chunks in (1, 2):
        meta, aux = _run_dense(*ins, budget, chunks)
        n = int(meta[0])
        assert n == len(want_idx) > 0, chunks
        np.testing.assert_array_equal(meta[1:1 + n], want_idx)
        np.testing.assert_array_equal(aux[:n], want_cnt)
        np.testing.assert_array_equal(aux[budget:], ins[2])


@pytest.mark.parametrize("H", [2, 3])
def test_count_tail_multihash_matches_brute_oracle(H):
    """num_hashes > 1: the h Bloom rows of each window AND before the
    count (the reference's pand, util-db-search.go:6639-6645); a
    starved budget reports the overflow."""
    ins = _dense_inputs(33, 128, H, 90 + H)
    want_idx, want_cnt = _dense_oracle(*ins)
    budget = 16 * 128 * 32
    meta, aux = _run_dense(*ins, budget, 1)
    n = int(meta[0])
    assert n == len(want_idx) > 0
    np.testing.assert_array_equal(meta[1:1 + n], want_idx)
    np.testing.assert_array_equal(aux[:n], want_cnt)
    meta_o, _ = _run_dense(*ins, 4, 1)
    assert int(meta_o[0]) > 4


NB, S_BLOCK, T_BLOCK = 3, 40, 4096
B, K, NU = 32, 12, 57


def _screened_inputs(seed):
    rng = np.random.default_rng(seed)
    bits = rng.integers(
        0, 2**32, (NB * S_BLOCK + 1, T_BLOCK // 32), dtype=np.uint64
    ).astype(np.uint32)
    for _ in range(3):  # ~6% dense rows: sparse candidates
        bits &= rng.integers(
            0, 2**32, bits.shape, dtype=np.uint64
        ).astype(np.uint32)
    bits[-1] = 0
    u = rng.integers(0, 2**32, (NU + 1, 1), dtype=np.uint64).astype(
        np.uint32
    )
    u[-1] = 0
    return bits, dict(
        u=u,
        loc=rng.integers(0, S_BLOCK + 1, (K, B)).astype(np.int32),
        locu=rng.integers(0, NU + 1, (K, B)).astype(np.int32),
        nk=rng.integers(1, K + 1, (1, B)).astype(np.int32),
        lens=np.r_[np.int32(3), rng.integers(20, 60, B - 1).astype(np.int32)],
        cmin=np.maximum(1, (np.arange(K + 1) * 0.3).astype(np.int32)),
        theta=rng.integers(0, 3, (NB, K + 1)).astype(np.int32),
        tmin=rng.integers(3, 6, (NB * T_BLOCK,)).astype(np.int32),
        spos=rng.random(NB * T_BLOCK) > 0.2,
    )


def _screened_oracle(bits, a, min_len=10, dedup=1000):
    """(read ids, target ids, counts, n_pairs) ascending by (b, g, t)."""
    tab = _bit_table(bits)
    utab = _bit_table(a["u"])[:, :NB]
    nk = a["nk"][0]
    ucnt = utab[a["locu"]].sum(axis=0)  # [B, NB]
    theta = a["theta"][:, np.minimum(nk, a["theta"].shape[1] - 1)].T
    read_ok = (a["lens"] >= min_len) & (nk <= dedup)
    active = (ucnt >= theta) & read_ok[:, None]
    qs, ts, cs = [], [], []
    for b, g in zip(*np.nonzero(active)):
        loc = a["loc"][:, b]
        rows = np.where(loc == S_BLOCK, len(tab) - 1, loc + g * S_BLOCK)
        counts = tab[rows].sum(axis=0)  # block g's rows, [T_BLOCK]
        sl = slice(g * T_BLOCK, (g + 1) * T_BLOCK)
        ok = (
            (counts >= a["cmin"][min(nk[b], len(a["cmin"]) - 1)])
            & (counts >= a["tmin"][sl]) & a["spos"][sl]
        )
        t = np.nonzero(ok)[0]
        qs.append(np.full(len(t), b))
        ts.append(t + g * T_BLOCK)
        cs.append(counts[t])
    cat = lambda xs: np.concatenate(xs) if xs else np.zeros(0, int)  # noqa
    return cat(qs), cat(ts), cat(cs), int(active.sum())


def _run_screened(bits, a, cand_budget, pair_budget, chunks):
    tail = _make_screened_tail(
        cand_budget, pair_budget, 10, 1000, NB, T_BLOCK, S_BLOCK, chunks
    )
    meta, aux = tail(
        jnp.asarray(bits), *(jnp.asarray(a[x]) for x in (
            "u", "loc", "locu", "nk", "lens", "cmin", "theta", "tmin",
            "spos",
        )),
    )
    return np.asarray(meta), np.asarray(aux)


@pytest.mark.parametrize("chunks", [1, 4])
@pytest.mark.parametrize("seed", [3, 11])
def test_screened_tail_matches_brute_oracle(seed, chunks):
    """Screened tail parity: same candidates in (read, block, target)
    order — the reference emits matches query-major then
    target-ascending (util-db-search.go:1174-1201) — same counts and
    k-mer counts, with and without pair chunking (trailing chunks are
    all padding)."""
    bits, a = _screened_inputs(seed)
    q, t, c, n_pairs = _screened_oracle(bits, a)
    budget = 65536
    meta, aux = _run_screened(bits, a, budget, 96, chunks)
    n = int(meta[0])
    assert n == len(q) > 0 and n_pairs <= 96
    np.testing.assert_array_equal(meta[1:1 + n], q)
    np.testing.assert_array_equal(meta[1 + budget:1 + budget + n], t)
    np.testing.assert_array_equal(aux[:n], c)
    np.testing.assert_array_equal(aux[budget:], a["nk"][0])


@pytest.mark.parametrize("starved", ["candidates", "pairs"])
def test_screened_tail_overflow_poison(starved):
    """A starved candidate budget or pair budget reports
    n_cand = cand_budget + 1, so the caller's 4x retry fires."""
    bits, a = _screened_inputs(3)
    q, _t, _c, n_pairs = _screened_oracle(bits, a)
    if starved == "candidates":
        cand, pairs = max(1, len(q) // 2), 96
    else:
        cand, pairs = 65536, max(1, n_pairs // 2)
    meta, _ = _run_screened(bits, a, cand, pairs, 1)
    assert int(meta[0]) == cand + 1
