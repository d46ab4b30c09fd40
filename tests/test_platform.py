"""The platform gate, the compile-cache rule and the mesh rule — on the
CPU — plus the tests that need the card (``gpu`` marker)."""

import os

import numpy as np
import pytest

from kmcp_tpu.search import platform


@pytest.mark.parametrize("name", ["gpu", "cpu"])
def test_platform_gate_routes(monkeypatch, name):
    """gpu and cpu have the device route; the platform is read from
    JAX's first device."""
    import jax

    class Dev:
        platform = name

    monkeypatch.setattr(jax, "devices", lambda *a: [Dev()])
    assert platform.device_route() == name
    assert platform.device_route(name) == name


def test_platform_gate_refuses_unknown(monkeypatch):
    """Any other platform has no device route: the error names it, and
    DeviceDB construction (the jax backend's entry) refuses too."""
    import jax

    class Dev:
        platform = "metal"

    monkeypatch.setattr(jax, "devices", lambda *a: [Dev()])
    with pytest.raises(RuntimeError, match="'metal'"):
        platform.device_route()
    with pytest.raises(RuntimeError, match="'rocm'"):
        platform.device_route("rocm")
    from kmcp_tpu.search.device import DeviceDB

    with pytest.raises(RuntimeError, match="'metal'"):
        DeviceDB(None, None)


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins and nothing is set in code."""
    import jax

    from kmcp_tpu.search import device

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    device.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == before
    assert device.compile_cache_dir() == str(tmp_path)


def test_compile_cache_fixed_in_checkout(monkeypatch):
    """Without JAX_COMPILATION_CACHE_DIR the cache is a fixed directory
    inside the checkout."""
    import jax

    from kmcp_tpu.search import device

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert device.compile_cache_dir() == os.path.join(repo, ".jax_cache")
    old = jax.config.jax_compilation_cache_dir
    try:
        device.enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == device.REPO_CACHE_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_make_mesh_raises_without_devices():
    """No silent fallback: a mesh larger than the device count raises."""
    import jax

    from kmcp_tpu.parallel.sharding import make_mesh

    n = len(jax.devices())
    assert make_mesh(n).devices.size == n
    with pytest.raises(RuntimeError, match="devices requested"):
        make_mesh(n + 1)


@pytest.mark.gpu
def test_gpu_hash_matches_nthash(gpu):
    """The device hash compiled for the card at a real stream width
    (4096 reads of 150 bp, 2-bit wire format) equals the C++ scanner's
    Bloom locations and the NumPy oracle's window values."""
    from kmcp_tpu.kmer import native
    from kmcp_tpu.kmer.nthash import _window_hashes, encode_seq
    from kmcp_tpu.search.device_hash import make_hash_fn

    rng = np.random.default_rng(5)
    B, lmax, S = 4096, 160, 1_400_001
    raw = rng.choice(np.frombuffer(b"ACGTNacgt", np.uint8), size=(B, 150))
    seqs = [r.tobytes() for r in raw]
    packed = native.pack_rows_2bit(seqs, np.full(B, 150), lmax)
    loc, nk, vhi, vlo = (np.asarray(o) for o in make_hash_fn(
        21, lmax, S, (1 << 64) - 1, emit_values=True, packed2=True,
    )(packed))
    loc_ref, nk_ref = native.hash_reads_loc(seqs, 21, lmax - 20, S, 1)
    np.testing.assert_array_equal(nk[0], nk_ref)
    got = (vhi.astype(np.uint64) << np.uint64(32)) | vlo
    for i in range(0, B, 41):
        a = sorted(x for x in loc_ref[i, :, 0].tolist() if x != S)
        assert a == sorted(x for x in loc[:, i].tolist() if x != S), i
        fh, rh, valid = _window_hashes(encode_seq(seqs[i]), 21)
        h = np.minimum(fh, rh)
        want = np.zeros(got.shape[0], np.uint64)
        want[: len(h)] = np.where(valid & (h != 0), h, 0)
        np.testing.assert_array_equal(got[:, i], want, err_msg=str(i))


@pytest.mark.gpu
def test_gpu_stream_matches_host(gpu, tmp_path):
    """Single-end and paired streaming on the card equals the host
    backend byte for byte on a small single-block DB."""
    import io

    from kmcp_tpu.commands.compute import ComputeOptions, run_compute
    from kmcp_tpu.index.build import run_index
    from kmcp_tpu.search.engine import SearchEngine, SearchOptions
    from kmcp_tpu.search.stream import StreamSearcher

    rng = np.random.default_rng(8)
    bases = np.frombuffer(b"ACGT", np.uint8)
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
    run_index(in_dir=str(tmp_path / "ks"), out_dir=str(tmp_path / "db"),
              num_hashes=1, fpr=0.3, force=True, tpu_native=True)
    pairs = []
    for i in range(600):
        g = genomes[i % 4]
        p = int(rng.integers(0, len(g) - 500))
        pairs.append((f"p{i}", g[p:p + 150], g[p + 300:p + 450]))
    for paired in (False, True):
        qs = pairs if paired else [(q, a, None) for q, a, _ in pairs]
        outs = {}
        for backend in ("host", "jax"):
            eng = SearchEngine(
                [str(tmp_path / "db")],
                SearchOptions(backend=backend, batch_size=256),
            )
            assert StreamSearcher.usable(eng, paired=paired)
            buf = io.StringIO()
            StreamSearcher(eng).run(iter(qs), buf, paired=paired)
            outs[backend] = buf.getvalue()
        assert outs["host"] == outs["jax"] and outs["host"], paired
