"""compute -> index -> search -> profile on the seeded synthetic
community (tools/synth_data.py), through the CLI in-process: the jax
backend streams on the device path and its TSV equals the host
backend's byte for byte, single-end and paired; the profile recovers the
designed abundances."""

import filecmp
import os

import pytest

from kmcp_tpu.cli import main as cli
from kmcp_tpu.kmer import native


@pytest.fixture(scope="module")
def community(tmp_path_factory):
    if native.get_lib() is None:
        pytest.skip("native library unavailable (streaming needs it)")
    from tools.synth_data import make_demo

    d = tmp_path_factory.mktemp("synth")
    data = make_demo(str(d / "data"), seed=3, scale=3.0,
                     min_len=40_000, max_len=120_000)
    assert cli(["-q", "compute", "-I", data["refs"], "-k", "21", "-n",
                "10", "-l", "150", "-O", str(d / "ks"), "--force"]) == 0
    assert cli(["-q", "index", "-I", str(d / "ks"), "-O", str(d / "db"),
                "-f", "0.3", "-n", "1", "--tpu-native", "--force"]) == 0
    return d, data


@pytest.mark.parametrize("paired", [False, True])
def test_synth_search_jax_equals_host(community, paired, monkeypatch):
    from kmcp_tpu.search import stream

    d, data = community
    query = ["-1", data["r1"], "-2", data["r2"]] if paired else [data["se"]]
    routes = []
    orig = stream.StreamSearcher.run

    def run(st, *a, **kw):
        routes.append(type(st.dev).__name__)
        return orig(st, *a, **kw)

    monkeypatch.setattr(stream.StreamSearcher, "run", run)
    out = {}
    for backend in ("host", "jax"):
        out[backend] = str(d / f"{paired}.{backend}.tsv")
        assert cli(["-q", "search", "-d", str(d / "db"), *query,
                    "--backend", backend, "-o", out[backend]]) == 0
    assert routes == ["HostDB", "DeviceDB"]  # both streamed
    assert filecmp.cmp(out["host"], out["jax"], shallow=False)
    with open(out["jax"]) as f:
        assert sum(1 for l in f if not l.startswith("#")) > 1000


def test_synth_profile_recovers_design(community):
    d, data = community
    tsv = str(d / "profile_input.tsv")
    assert cli(["-q", "search", "-d", str(d / "db"), data["se"],
                "--backend", "jax", "-o", tsv]) == 0
    prof = str(d / "profile.tsv")
    assert cli(["-q", "profile", "-T", data["taxid_map"], "-X",
                data["taxdump"], "-m", "1", tsv, "-o", prof,
                "-C", str(d / "cami"), "-s", "0"]) == 0
    found = {}
    with open(prof) as f:
        f.readline()
        for line in f:
            parts = line.rstrip("\n").split("\t")
            found[parts[0]] = float(parts[1])
    truth = data["truth_pct"]
    for g, pct in truth.items():
        if pct > 1:  # the five depth-1 genomes and the 0.1 tier
            assert abs(found[g] - pct) < 1.5, (g, found.get(g), pct)
    ranks = {}
    with open(str(d / "cami") + ".profile") as f:
        for line in f:
            if line.startswith("@") or not line.strip():
                continue
            _t, rank, _p, _n, pct = line.rstrip("\n").split("\t")
            ranks[rank] = ranks.get(rank, 0.0) + float(pct)
    for rank in ("superkingdom", "phylum", "species"):
        assert abs(ranks[rank] - 100.0) < 0.01, (rank, ranks[rank])
