"""The port's OpenMP ``.bed`` helper (``hydra_tpu_torch/native.py`` over
``csrc/bedio.cpp``, built with g++ at first use) against its plain numpy
versions and the JAX package's helper (``hydra_tpu.native``) on the same
seeded bytes; the load path, the ``--bed-to-sparse`` converter and the
copied utilities against the JAX package's; the helper's build; and the
two scripts of the port at a tiny size on the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hydra_tpu import native as jnative
from hydra_tpu.data import genotypes as jgeno
from hydra_tpu.io import pheno as jpheno
from hydra_tpu.io import sparse as jsparse
from hydra_tpu_torch import native
from hydra_tpu_torch.data import genotypes as tgeno
from hydra_tpu_torch.io import pheno as tpheno
from hydra_tpu_torch.io import plink, simulate
from hydra_tpu_torch.io import sparse as tsparse
from hydra_tpu_torch.ops import _build, decode


# ---- plain numpy versions of the entry points that only tests call ----

_GENO = np.array([2, 0, 1, 0], np.int8)      # PLINK code -> genotype
_CODE = np.array([3, 2, 0], np.uint8)        # genotype -> PLINK code


def _codes(packed: np.ndarray) -> np.ndarray:
    """(m, nbytes) bytes -> (m, 4 nbytes) crumb codes, individual order."""
    shifts = 2 * np.arange(4, dtype=np.uint8)
    return ((packed[:, :, None] >> shifts) & 3).reshape(packed.shape[0], -1)


def _pack_codes(codes: np.ndarray, nbytes: int) -> np.ndarray:
    """(m, n) crumb codes -> (m, nbytes) bytes; crumbs past n are coded 0
    in a byte that holds individuals and missing in a byte that holds
    none, as the helper's packers leave them."""
    m, n = codes.shape
    full = np.zeros((m, nbytes * 4), np.uint8)
    full[:, :n] = codes
    full[:, -(-n // 4) * 4:] = 1
    c = full.reshape(m, nbytes, 4)
    return (c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4)
            | (c[..., 3] << 6)).astype(np.uint8)


def bed_sparse_fill_ref(packed: np.ndarray, n: int, s1, s2, sm, c1, c2, cm):
    """Plain version of ``bed_sparse_fill``: each marker's individuals by
    ``np.nonzero`` of its first n codes."""
    codes = _codes(packed)[:, :n]
    outs = []
    for code, s, c in ((2, s1, c1), (0, s2, c2), (1, sm, cm)):
        idx = np.zeros(int(np.sum(c)), np.uint32)
        for j in range(codes.shape[0]):
            hit = np.nonzero(codes[j] == code)[0]
            idx[int(s[j]):int(s[j]) + len(hit)] = hit
        outs.append(idx)
    return tuple(outs)


def bed_expand_planes_ref(packed: np.ndarray) -> np.ndarray:
    """Plain version of ``bed_expand_planes``."""
    return np.concatenate(
        [_GENO[(packed.astype(np.int64) >> (2 * k)) & 3] for k in range(4)],
        axis=1)


def bed_dot_ref(packed: np.ndarray, n: int, eps: np.ndarray,
                mave: np.ndarray, mstd: np.ndarray) -> np.ndarray:
    """Plain version of ``bed_dot`` (float64 sums in the helper's order,
    individual by individual)."""
    codes = _codes(packed)[:, :n]
    g = _GENO[codes].astype(np.float64)
    mk = (codes != 1).astype(np.float64)
    e = np.asarray(eps, np.float64)[:n]
    s1 = np.zeros(len(g))
    s2 = np.zeros(len(g))
    for i in range(n):
        s1 += g[:, i] * e[i]
        s2 += mk[:, i] * e[i]
    return mstd * (s1 - mave * s2)


def bed_pack_ref(geno: np.ndarray, nbytes: int) -> np.ndarray:
    """Plain version of ``bed_pack``: 0 -> 0b11, 1 -> 0b10, 2 -> 0b00,
    anything else missing (0b01)."""
    g = np.asarray(geno, np.uint8)
    codes = np.where(g <= 2, _CODE[np.minimum(g, 2)], 1).astype(np.uint8)
    return _pack_codes(codes, nbytes)


def bed_generate_ref(rand_bytes: np.ndarray, thr_a: np.ndarray,
                     thr_b: np.ndarray, nbytes: int) -> np.ndarray:
    """Plain version of ``bed_generate``."""
    u = np.asarray(rand_bytes, np.uint8)
    g = ((u < np.asarray(thr_a, np.uint8)[:, None]).astype(np.uint8)
         + (u < np.asarray(thr_b, np.uint8)[:, None]))
    return _pack_codes(_CODE[g], nbytes)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M = 33
# 77 and the other residues of N mod 4 (4k + 1, 4k + 3 and 4k)
NS = (77, 101, 203, 80)
SPARSE_EXTS = ("ss1", "ss2", "ssm", "sl1", "sl2", "slm", "si1", "si2", "sim",
               "dim")


def _geno(n, m=M, seed=0, missing=0.07):
    """(m, n) genotypes 0/1/2, -1 missing (7% of the calls)."""
    rs = np.random.RandomState(seed + n)
    p = rs.uniform(0.05, 0.5, (m, 1))
    g = (rs.random_sample((m, n)) < p).astype(np.int64) + (
        rs.random_sample((m, n)) < p)
    g[rs.random_sample(g.shape) < missing] = -1
    return g


def _packed(n, m=M, seed=0):
    rs = np.random.RandomState(seed)
    codes = np.array([3, 2, 0], np.uint8)
    g = _geno(n, m, seed)
    c = np.where(g < 0, 1, codes[np.maximum(g, 0)]).astype(np.uint8)
    full = np.full((m, -(-n // 4) * 4), 1, np.uint8)
    full[:, :n] = c
    pk = (full[:, 0::4] | (full[:, 1::4] << 2) | (full[:, 2::4] << 4)
          | (full[:, 3::4] << 6)).astype(np.uint8)
    # pad crumbs of the last byte random too: the helper must not read them
    if n % 4:
        junk = rs.randint(0, 256, m).astype(np.uint8)
        keep = (1 << (2 * (n % 4))) - 1
        pk[:, -1] = ((pk[:, -1] & np.uint8(keep))
                     | (junk & np.uint8(~keep & 0xFF)))
    return pk, g


def _offsets(c):
    return np.concatenate(([0], np.cumsum(c[:-1]))).astype(np.int64)


def _equal(got, *wants):
    got = got if isinstance(got, tuple) else (got,)
    for want in wants:
        want = want if isinstance(want, tuple) else (want,)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("entry", [
    "bed_counts", "bed_hpack", "bed_decode", "bed_expand_planes",
    "bed_remove_individuals", "bed_sparse_fill", "bed_dot", "bed_pack",
    "bed_generate"])
def test_entry_point_matches_plain_and_jax(entry, n):
    """Each of the nine entry points on N = 77, 4k + 1, 4k + 3 and 4k
    individuals, 7% missing calls: equal to its plain numpy version and
    bit for bit the JAX package's helper."""
    pk, g = _packed(n)
    nbytes = pk.shape[1]
    if entry == "bed_counts":
        got = native.bed_counts(pk, n)
        _equal(got, jnative.bed_counts(pk, n))
        _equal(tuple(c.astype(np.float64) for c in got),
               tgeno.marker_counts(pk, n))
        np.testing.assert_array_equal(got[2], (g < 0).sum(1))
    elif entry == "bed_hpack":
        for x in (pk, pk.reshape(-1)[:nbytes * 5 + 3]):   # odd totals
            _equal(native.bed_hpack(x), jnative.bed_hpack(x),
                   decode.hpack_bytes_ref(x))
    elif entry == "bed_decode":
        got = native.bed_decode(pk)
        want = plink.decode_bed_numpy(pk, 4 * nbytes)
        _equal(got, jnative.bed_decode(pk),
               tuple(w.astype(np.float32) for w in want))
    elif entry == "bed_expand_planes":
        _equal(native.bed_expand_planes(pk), jnative.bed_expand_planes(pk),
               bed_expand_planes_ref(pk))
    elif entry == "bed_remove_individuals":
        # the first, a middle and the last individual, alone and together
        for drop in ([0], [n // 2], [n - 1], [0, n // 2, n - 1],
                     list(range(0, n, 3))):
            drop = np.array(drop)
            got = native.bed_remove_individuals(pk, n, drop)
            _equal(got, jnative.bed_remove_individuals(pk, n, drop),
                   plink.remove_individuals_packed(pk, n, drop))
    elif entry == "bed_sparse_fill":
        c1, c2, cm = native.bed_counts(pk, n)
        s1, s2, sm = _offsets(c1), _offsets(c2), _offsets(cm)
        got = native.bed_sparse_fill(pk, n, s1, s2, sm, c1, c2, cm)
        _equal(got, jnative.bed_sparse_fill(pk, n, s1, s2, sm, c1, c2, cm),
               bed_sparse_fill_ref(pk, n, s1, s2, sm, c1, c2, cm))
        # reused buffers, larger than needed
        bufs = [np.full(int(c.sum()) + 5, 7, np.uint32) for c in (c1, c2, cm)]
        _equal(native.bed_sparse_fill(pk, n, s1, s2, sm, c1, c2, cm,
                                      out=bufs), got)
        np.testing.assert_array_equal(got[0][s1[3]:s1[3] + c1[3]],
                                      np.nonzero(g[3] == 1)[0])
    elif entry == "bed_dot":
        gd = tgeno.GenotypeData.from_packed(pk, n, np.empty(0, np.int64))
        eps = np.random.RandomState(n).randn(n)
        got = native.bed_dot(gd.packed, n, eps, gd.mave, gd.mstd)
        _equal(got, jnative.bed_dot(gd.packed, n, eps, gd.mave, gd.mstd))
        # the helper may contract a multiply-add: a last bit apart at most
        np.testing.assert_allclose(
            got, bed_dot_ref(gd.packed, n, eps, gd.mave, gd.mstd),
            rtol=1e-13, atol=1e-13)
    elif entry == "bed_pack":
        geno = np.where(g < 0, 3, g).astype(np.uint8)
        for nb in (nbytes, nbytes + 2):
            _equal(native.bed_pack(geno, nb), jnative.bed_pack(geno, nb),
                   bed_pack_ref(geno, nb))
        got = native.bed_pack(geno, nbytes)
        gg, mk = plink.decode_bed_numpy(got, n)
        np.testing.assert_array_equal(np.where(mk == 0, -1, gg), g)
    else:
        rs = np.random.RandomState(n)
        u = rs.randint(0, 256, (M, n)).astype(np.uint8)
        a, b = simulate.thresholds(rs.uniform(0.05, 0.5, M))
        _equal(native.bed_generate(u, a, b, nbytes),
               jnative.bed_generate(u, a, b, nbytes),
               bed_generate_ref(u, a, b, nbytes))


def _write_trio(tmp_path, n, m=M, na=(0, 9, 40)):
    pk, g = _packed(n, m, seed=3)
    base = str(tmp_path / "g")
    plink.write_bed(base + ".bed", g)
    with open(base + ".fam", "w") as fh:
        fh.writelines(f"f{i} i{i} 0 0 0 -9\n" for i in range(n))
    with open(base + ".bim", "w") as fh:
        fh.writelines(f"1 rs{j} 0 {j + 1} A C\n" for j in range(m))
    rs = np.random.RandomState(n)
    na = set(na) | {n - 1}
    with open(base + ".phen", "w") as fh:
        fh.writelines(f"f{i} i{i} {'NA' if i in na else rs.randn()}\n"
                      for i in range(n))
    return base, g


@pytest.mark.parametrize("n", [77, 203])
def test_load_dataset_matches_jax(n, tmp_path):
    """load_dataset on a .bed with NA phenotypes (the first, middle and
    last individuals among them) and N % 4 != 0: packed, mave, mstd, msd
    and nm bit for bit the JAX package's."""
    base, _ = _write_trio(tmp_path, n)
    pt = tpheno.read_phenotype_file(base + ".phen", n)
    pj = jpheno.read_phenotype_file(base + ".phen", n)
    assert pt.num_nas == 4
    dt = tgeno.load_dataset(base, pt)
    dj = jgeno.load_dataset(bed_basename=base, pheno=pj)
    for name in ("packed", "mave", "mstd", "msd", "nm", "n1", "n2"):
        a, b = getattr(dt.geno, name), np.asarray(getattr(dj.geno, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (dt.geno.n, dt.geno.n_pad) == (dj.geno.n, dj.geno.n_pad)


def test_load_path_runs_the_helper(tmp_path, monkeypatch):
    """The load path and the samplers' h-recode no longer call the plain
    versions: with them raising, load_dataset and a sampler still run."""
    from hydra_tpu_torch.samplers.bayesrrm import BayesRRm

    def boom(*a, **k):
        raise AssertionError("plain version called on the load path")

    monkeypatch.setattr(tgeno, "marker_counts", boom)
    monkeypatch.setattr(plink, "remove_individuals_packed", boom)
    monkeypatch.setattr(plink, "decode_bed_numpy", boom)
    monkeypatch.setattr(decode, "hpack_bytes_ref", boom)
    base, g = _write_trio(tmp_path, 101)
    ds = tgeno.load_dataset(base, tpheno.read_phenotype_file(base + ".phen",
                                                             101))
    keep = np.ones(101, bool)
    keep[[0, 9, 40, 100]] = False
    np.testing.assert_array_equal(ds.geno.nm, (g[:, keep] < 0).sum(1))
    s = BayesRRm(ds, window=8, exact=False, seed=1, device="cpu")
    st, _ = s.step(s.init_state(), 0)
    assert bool(torch.isfinite(st.eps).all())


def test_sparse_converter_matches_jax(tmp_path):
    """write_sparse_files with block_size 7 on M=33: the nine files byte
    for byte the JAX converter's and the plain version's; a round trip
    through read_sparse_files gives the .bed's bytes."""
    n = 101
    base, _ = _write_trio(tmp_path, n)
    outs = {}
    for name, fn in (("t", tsparse.write_sparse_files),
                     ("ref", tsparse.write_sparse_files_ref),
                     ("j", jsparse.write_sparse_files)):
        os.makedirs(tmp_path / name)
        outs[name] = str(tmp_path / name / "s")
        fn(base + ".bed", n, M, outs[name], block_size=7)
    for ext in SPARSE_EXTS:
        got = open(f"{outs['t']}.{ext}", "rb").read()
        assert got, ext
        for other in ("ref", "j"):
            assert got == open(f"{outs[other]}.{ext}", "rb").read(), (
                ext, other)
    sp = tsparse.read_sparse_files(outs["t"])
    np.testing.assert_array_equal(tsparse.sparse_to_packed_bed(sp),
                                  plink.read_bed(base + ".bed", n, M))


def test_sparse_converter_raises_the_writers_error(tmp_path, monkeypatch):
    """An error of the writer thread is raised after the join."""
    base, _ = _write_trio(tmp_path, 77)
    real = open

    class Full:
        def __init__(self, fh):
            self.fh = fh

        def write(self, _):
            raise OSError(28, "No space left on device")

        def close(self):
            self.fh.close()

    def fake_open(path, mode="r", *a, **k):
        fh = real(path, mode, *a, **k)
        return Full(fh) if str(path).endswith(".si2") else fh

    monkeypatch.setattr("builtins.open", fake_open)
    with pytest.raises(OSError, match="No space left"):
        tsparse.write_sparse_files(base + ".bed", 77, M,
                                   str(tmp_path / "s"), block_size=7)


_BUILD_CHILD = """
import sys
from hydra_tpu_torch.ops import _build
_build.BUILD_DIR = sys.argv[1]
from hydra_tpu_torch import native
import numpy as np
pk = np.arange(48, dtype=np.uint8).reshape(2, 24)
print(native.bed_counts(pk, 96)[0].tolist())
"""


def test_two_processes_build_the_helper_at_once(tmp_path):
    """Two processes that load the helper into an empty build directory at
    the same time: one builds under the file lock, both load it."""
    build = str(tmp_path / "_build")
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_CHILD, build],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert outs[0][0] == outs[1][0] != ""
    libs = sorted(f for f in os.listdir(build) if not f.startswith("."))
    assert len(libs) == 1 and libs[0].startswith("libhydra_bedio_"), libs
    assert libs[0].endswith(".so")


def test_failed_build_raises_with_the_compilers_stderr(tmp_path, monkeypatch):
    """No fallback: a source g++ refuses raises, naming the error."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / _build.HOST_SOURCE).write_text("int broken( {\n")
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError,
                       match="(?s)g\\+\\+ bedio.cpp failed.*error"):
        _build.load_host()
    assert not [f for f in os.listdir(tmp_path / "_build")
                if f.endswith(".so")]


def test_host_library_name_hashes_compiler_and_flags(monkeypatch):
    """The library's name moves with its flags and with the target options
    -march=native resolves to (another CPU under the same compiler), and
    stays put for the same inputs."""
    a = _build.host_library_path()
    assert a == _build.host_library_path()
    real = subprocess.run

    def other_cpu(cmd, **kw):
        r = real(cmd, **kw)
        if "--help=target" in cmd:
            return subprocess.CompletedProcess(
                r.args, r.returncode,
                r.stdout.replace("[enabled]", "[disabled]", 1), r.stderr)
        return r
    monkeypatch.setattr(_build.subprocess, "run", other_cpu)
    b = _build.host_library_path()
    assert b != a
    monkeypatch.setattr(_build.subprocess, "run", real)
    monkeypatch.setattr(_build, "HOST_FLAGS", _build.HOST_FLAGS + ("-g",))
    assert _build.host_library_path() not in (a, b)


@pytest.mark.parametrize("level", [1, 6, 9])
def test_compress_doubles_round_trips_with_jax(level):
    """compress_doubles / decompress_doubles in both directions with the
    JAX package's copies."""
    from hydra_tpu.utils import compression as jc
    from hydra_tpu_torch.utils import compression as tc

    x = np.random.RandomState(level).randn(1000) * 1e3
    for enc, dec in ((tc, jc), (jc, tc)):
        blob = enc.compress_doubles(x, level)
        np.testing.assert_array_equal(dec.decompress_doubles(blob, 1000), x)
    assert tc.compress_doubles(x, level) == jc.compress_doubles(x, level)
    with pytest.raises(ValueError):
        tc.decompress_doubles(tc.compress_doubles(x), 1001)


def test_gadgets_match_jax():
    from hydra_tpu.utils import gadgets as jg
    from hydra_tpu_torch.utils import gadgets as tg

    for text in ("a, b;;c", "  x  ", "", "1,2,3"):
        assert tg.tokenize(text, " ,;") == jg.tokenize(text, " ,;")
    for sec in (0.0, 59.9995, 3725.25, 90061.5):
        assert tg.Timer.format(sec) == jg.Timer.format(sec)
    t = tg.Timer()
    t.set_time()
    assert 0.0 <= t.elapsed() < 60.0


def test_panel_is_reproducible_and_has_its_missing_rate(tmp_path):
    """write_panel: the same bytes for the same seed whatever the threads,
    about the missing rate asked for, and the NA phenotypes."""
    m, n = 300, 1003
    blocks = [np.concatenate([pk for _, pk in simulate.packed_blocks(
        m, n, 5, 0.02, block=64, workers=w)]) for w in (1, 3)]
    np.testing.assert_array_equal(blocks[0], blocks[1])
    truth = simulate.write_panel(str(tmp_path / "p"), m, n, 5, missing=0.02,
                                 na=10, block=64)
    pk = plink.read_bed(str(tmp_path / "p.bed"), n, m)
    np.testing.assert_array_equal(pk, blocks[0])
    nm = native.bed_counts(pk, n)[2]
    assert 0.015 < nm.sum() / (m * n) < 0.025
    ph = tpheno.read_phenotype_file(str(tmp_path / "p.phen"), n)
    np.testing.assert_array_equal(ph.na_indices, truth["na_indices"])
    assert ph.num_nas == 10 and 0.35 < truth["h2"] < 0.65


def test_ess_certification_script_writes_its_table(tmp_path):
    """scripts/ess_certification_torch.py on the CPU at M=300 x N=400: five
    short chains of the CLI and the table."""
    out = tmp_path / "ess.md"
    res = subprocess.run(
        [sys.executable, "scripts/ess_certification_torch.py", "--device",
         "cpu", "--m", "300", "--n", "400", "--iters", "30", "--burnin-rec",
         "2", "--workdir", str(tmp_path / "w"), "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    rows = [ln for ln in out.read_text().splitlines()
            if ln.startswith("| ") and not ln.startswith("| config")]
    assert [r.split("|")[1].strip() for r in rows] == [
        "exact_block", "exact_marker", "stale_w64_block", "stale_w256_block",
        "stale_w256_marker"]
    for r in rows:
        vals = [float(v) for v in r.split("|")[2:-1]]
        assert len(vals) == 8 and all(np.isfinite(vals)) and vals[0] > 0


def test_profile_phases_script_sums_to_the_step(tmp_path):
    """scripts/profile_phases_torch.py on the CPU at M=300 x N=400: BayesW
    and BayesRRm steps split into phases that sum to within 10% of the
    step, the sweep among them."""
    import json
    js = tmp_path / "phases.json"
    res = subprocess.run(
        [sys.executable, "scripts/profile_phases_torch.py", "--device", "cpu",
         "--m", "300", "--n", "400", "--steps", "2", "--json", str(js)],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    got = {r["model"]: r for r in json.loads(js.read_text())}
    assert set(got) == {"bw", "brr"}
    for model, sweep in (("bw", "sweep_stale_bw"), ("brr", "sweep_exact")):
        r = got[model]
        names = [p[0] for p in r["phases"]]
        assert sweep in names and "sweep_order" in names, names
        assert abs(r["phases_ms"] - r["step_ms"]) <= 0.1 * r["step_ms"]
    assert {"mu slice", "alpha slice", "cov_sweep", "build_mrow"} <= {
        p[0] for p in got["bw"]["phases"]}


def test_profile_phases_script_splits_the_load(tmp_path):
    """scripts/profile_phases_torch.py --models ingest on the CPU at M=300 x
    N=400: the load path's stages with the helper and on the plain numpy
    versions, each reaching the first sweep."""
    import json
    js = tmp_path / "ingest.json"
    res = subprocess.run(
        [sys.executable, "scripts/profile_phases_torch.py", "--device", "cpu",
         "--models", "ingest", "--m", "300", "--n", "400", "--json",
         str(js)],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    (got,) = json.loads(js.read_text())
    assert got["model"] == "ingest"
    for key in ("helper", "plain"):
        t = got[key]
        assert {"read", "NA removal", "counts", "h-recode", "upload"} <= set(t)
        assert 0 < t["seconds to the upload"] <= t[
            "seconds to the first sweep"]
    assert res.stdout.count("host ingest ") == 2


def test_smoke_host_ingest_phase_on_the_cpu(tmp_path):
    """chip_smoke's phase 1b on the CPU at M=600 x N=401: the helper's
    passes against their plain versions, both converters timed and their
    files equal, the buffered write read. In a process of its own, since
    importing chip_smoke blocks JAX for the rest of the process."""
    code = ("import sys, torch, numpy as np\n"
            "import chip_smoke\n"
            "chip_smoke.INGEST = dict(m=600, n=401, seed=3, missing=0.02, "
            "na=10, check_rows=64, sparse_m=300)\n"
            f"chip_smoke.phase_host_ingest(torch, np, {str(tmp_path)!r}, "
            "'cpu', dev=torch.device('cpu'))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    for line in ("host ingest with the OpenMP helper",
                 "--bed-to-sparse (helper converter): 300 markers",
                 "--bed-to-sparse (plain converter): 300 markers",
                 "byte for byte the plain converter on 300 markers",
                 "bed_counts bit for bit", "buffered write of"):
        assert line in res.stdout, res.stdout


def test_h2_witness_script_runs_both_packages(tmp_path):
    """scripts/h2_witness_cpu.py at M=300 x N=400: a chain of each package
    on one panel, each with a finite posterior h2, and their difference."""
    res = subprocess.run(
        [sys.executable, "scripts/h2_witness_cpu.py", "--m", "300", "--n",
         "400", "--iters", "30", "--burnin-rec", "1", "--configs",
         "stale_w64_block", "--workdir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    rows = {ln.split("|")[2].strip(): ln.split("|")[3].strip()
            for ln in res.stdout.splitlines()
            if ln.startswith("| stale_w64_block")}
    assert set(rows) == {"jax", "torch", "torch - jax"}
    assert all(np.isfinite(float(v)) for v in rows.values())
    assert 0.0 < float(rows["jax"]) < 1.0 and 0.0 < float(rows["torch"]) < 1.0


@pytest.mark.parametrize("call", [
    lambda pk: native.bed_counts(pk, 4 * pk.shape[1] + 1),
    lambda pk: native.bed_remove_individuals(pk, 4 * pk.shape[1] + 4, [0]),
    lambda pk: native.bed_counts(pk.reshape(-1), 4),
    lambda pk: native.bed_pack(np.zeros((2, 9), np.uint8), 2),
    lambda pk: native.bed_generate(np.zeros((2, 8), np.uint8),
                                   np.zeros(3, np.uint8),
                                   np.zeros(3, np.uint8), 2),
    lambda pk: native.bed_sparse_fill(pk, 8, *[np.zeros(1, np.int64)] * 6),
])
def test_bindings_refuse_shapes_the_helper_would_overrun(call):
    """The helper trusts its sizes: the bindings check them first."""
    with pytest.raises(ValueError):
        call(np.zeros((3, 2), np.uint8))
