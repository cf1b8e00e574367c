"""The port's compiled host scanners (usher_tpu_torch/native/) against its
pure-Python scanners and the JAX package's (prebuilt) extension.

The five tests of tests/test_native_tools.py on the port's side, then each
of the six scanners on the fixture and on seeded random inputs: the port's
compiled scanner == its pure-Python one == the JAX package's compiled one
(pb_to_arrays, newick_to_arrays, parse_vcf, parse_vcf_mt, the transposed
codec, whose files must also carry the JAX encoder's bytes), and the build
itself: cached by a hash of the source, rebuilt after an edit, loud when
it fails.  Tolerance: none (every result is integers, names and bytes).
"""

import gzip
import os

import numpy as np
import pytest

import usher_tpu.native as jnative
from usher_tpu.cli.usher_cli import main as jax_usher
from usher_tpu.io import pb_arrays as jpa
from usher_tpu.io import transpose as jtr
from usher_tpu.io import vcf as jvcf
from usher_tpu_torch import native
from usher_tpu_torch.cli.usher_cli import main as torch_usher
from usher_tpu_torch.io import pb_arrays as tpa
from usher_tpu_torch.io import transpose as ttr
from usher_tpu_torch.io import vcf as tvcf
from usher_tpu_torch.native import _build

from conftest import REFERENCE_TEST_DIR
from test_torch_pb_arrays import _random_pb, assert_same_arrays

GLOBAL_NH = os.path.join(REFERENCE_TEST_DIR, "global_phylo.nh")
GLOBAL_VCF = os.path.join(REFERENCE_TEST_DIR, "global_samples.vcf")
NEW_VCF = os.path.join(REFERENCE_TEST_DIR, "new_samples.vcf")

CODEC_SAMPLES = [
    ("alpha", [(241, 8), (3037, 8), (23403, 4)], [(1, 55), (29804, 29903)]),
    ("beta", [(100, 1)], [(7, 7)]),
    ("gamma", [], []),
]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("USHER_TPU_PLATFORM", "cpu")


@pytest.fixture
def pure_python(monkeypatch):
    """The port as it runs where the scanner could not be built."""
    monkeypatch.setattr(native, "_loaded", lambda: (None, "not built"))


@pytest.fixture(scope="module")
def ext():
    assert native.available(), native.build_error()
    assert jnative.HAVE_NATIVE
    return native.ext


@pytest.fixture(scope="module")
def fixture_pbs(tmp_path_factory):
    """The fixture MAT built, then with the new samples placed, by the JAX
    CLI (the pbs every test here reads)."""
    out = str(tmp_path_factory.mktemp("native_fixture"))
    pb = os.path.join(out, "out.pb")
    pb2 = os.path.join(out, "out2.pb")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USHER_TPU_PLATFORM", "cpu")
        assert jax_usher(["-t", GLOBAL_NH, "-v", GLOBAL_VCF, "-o", pb,
                          "-d", out, "--mesh-devices", "0"]) == 0
        assert jax_usher(["-i", pb, "-v", NEW_VCF, "-o", pb2, "-d",
                          out + "/p", "--mesh-devices", "0"]) == 0
    return pb, pb2


def random_vcf(path, seed, n_samples=12, n_sites=80, gz=False):
    """A VCF with multi-allelic, N and ambiguous ALT alleles, missing and
    annotated genotype fields, comment lines and two chromosomes."""
    rng = np.random.default_rng(seed)
    bases = "ACGT"
    lines = ["##fileformat=VCFv4.2", "##source=random",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
             + "\t".join(f"s{j}" for j in range(n_samples))]
    for pos in sorted(rng.choice(np.arange(1, 5000), n_sites, replace=False)):
        ref = bases[rng.integers(4)]
        alts = [b for b in "ACGTNRY" if b != ref]
        alt = list(rng.choice(alts, rng.integers(1, 4), replace=False))
        gts = []
        for _ in range(n_samples):
            r = rng.random()
            if r < 0.5:
                gts.append("0")
            elif r < 0.6:
                gts.append(".")
            elif r < 0.7:
                gts.append(f"{rng.integers(len(alt) + 1)}:x")
            else:
                gts.append(str(rng.integers(1, len(alt) + 1)))
        chrom = "chrA" if pos < 2500 else "chrB"
        lines.append(f"{chrom}\t{pos}\t.\t{ref}\t{','.join(alt)}\t.\t.\t.\t"
                     f"GT\t" + "\t".join(gts))
    text = "\n".join(lines) + "\n"
    if gz:
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        with open(path, "w") as f:
            f.write(text)
    return path


def _sites(vcf):
    return (vcf.sample_ids, [(s.chrom, s.position, s.ref_nuc, s.variants)
                             for s in vcf.sites])


def _raw(parsed):
    """ext.parse_vcf's (sample_ids, raw tuples) as plain lists."""
    ids, sites = parsed
    return ids, [(c, int(p), int(r), [(int(a), int(b)) for a, b in v])
                 for c, p, r, v in sites]


# --- the five tests of tests/test_native_tools.py ---------------------------

def test_native_and_python_codecs_agree(ext, tmp_path):
    p1 = str(tmp_path / "native.tvcf")
    p2 = str(tmp_path / "py.tvcf")
    ttr._encode_py(CODEC_SAMPLES, p2)
    assert ttr._decode_py(p2) == CODEC_SAMPLES
    ttr.encode(CODEC_SAMPLES, p1)
    assert ttr.decode(p1) == CODEC_SAMPLES
    # cross-decoding: both codecs parse each other's bytes
    assert [(n, [(int(a), int(b)) for a, b in m],
             [(int(s), int(e)) for s, e in r])
            for n, m, r in ext.transpose_decode(p2)] == CODEC_SAMPLES
    assert ttr._decode_py(p1) == CODEC_SAMPLES


def test_transpose_vcf_roundtrip(ext, tmp_path):
    """VCF -> transposed (compiled codec) -> records keeps every genotype,
    and equals the JAX package's records of the same VCF."""
    tvcf_path = str(tmp_path / "g.tvcf")
    assert ttr.encode_vcf(GLOBAL_VCF, tvcf_path) == \
        jtr.encode_vcf(GLOBAL_VCF, str(tmp_path / "j.tvcf"))
    back = ttr.decode(tvcf_path)
    assert back == jtr.decode(str(tmp_path / "j.tvcf"))
    orig = tvcf.read_vcf_sites(GLOBAL_VCF)
    by_name = {n: (dict(m), r) for n, m, r in back}
    checked = 0
    for site in orig.sites:
        for col, nuc in site.variants:
            muts, nranges = by_name[orig.sample_ids[col]]
            if nuc == 0xF:
                assert any(s <= site.position <= e for s, e in nranges)
            else:
                assert muts[site.position] == nuc
            checked += 1
    assert checked > 1000


def test_compare_vcf(ext):
    """What compareVCF compares: the two fixture VCFs read by the compiled
    reader, the pure-Python reader and the JAX package's reader."""
    want = {p: _sites(jvcf.read_vcf_sites(p)) for p in (NEW_VCF, GLOBAL_VCF)}
    for p, sites in want.items():
        assert _sites(tvcf.read_vcf_sites(p)) == sites
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "_loaded", lambda: (None, "not built"))
        for p, sites in want.items():
            assert _sites(tvcf.read_vcf_sites(p)) == sites
    assert want[NEW_VCF] != want[GLOBAL_VCF]


def test_check_samples_place(ext, fixture_pbs, tmp_path):
    """The port's usher CLI, reading through the compiled scanners, builds
    and places the fixture as the JAX CLI did; the placed MAT holds the
    new samples and the original's nodes (check_samples' oracle, on the
    array loader)."""
    pb, pb2 = fixture_pbs
    out = str(tmp_path / "b")
    mine = os.path.join(out, "out.pb")
    assert torch_usher(["-t", GLOBAL_NH, "-v", GLOBAL_VCF, "-o", mine,
                        "-d", out]) == 0
    with open(mine, "rb") as a, open(pb, "rb") as b:
        assert a.read() == b.read()
    out2 = str(tmp_path / "p")
    mine2 = os.path.join(out2, "out2.pb")
    assert torch_usher(["-i", mine, "-v", NEW_VCF, "-o", mine2,
                        "-d", out2]) == 0
    with open(mine2, "rb") as a, open(pb2, "rb") as b:
        assert a.read() == b.read()
    from usher_tpu_torch.io.pbio import load_mat_pb

    def leaves(path):
        T = load_mat_pb(path)
        T.uncondense_leaves()
        return set(T.get_leaves_ids())
    before, after = leaves(pb), leaves(mine2)
    new = set(tvcf.read_vcf_sites(NEW_VCF).sample_ids)
    assert before | new == after and not new & before


def test_parse_vcf_mt_matches_serial(ext):
    a = ext.parse_vcf(GLOBAL_VCF)
    b = ext.parse_vcf_mt(GLOBAL_VCF, 3)
    assert a[0] == b[0]
    assert a[1] == b[1]


# --- the scanners against the pure-Python ones and the JAX extension --------

def test_native_scanner_is_built(ext):
    """The scanner built from the repo's source alone, into
    build/usher_tpu_torch/, and the readers use it."""
    assert native.HAVE_NATIVE and native.build_error() is None
    path = _build.library_path()
    assert path.exists() and path.parent == _build.BUILD_DIR
    assert ext.__name__ == "_usher_native"
    assert ext.__file__ == str(path)


@pytest.mark.parametrize("which", ["fixture", "placed", "random3", "random9"])
def test_pb_and_newick_scanners_match(ext, fixture_pbs, tmp_path, which):
    if which.startswith("random"):
        path, _, _ = _random_pb(tmp_path, int(which[6:]), n_leaves=90,
                                n_positions=40)
    else:
        path = fixture_pbs[which == "placed"]
    with open(path, "rb") as f:
        buf = f.read()
    got = ext.pb_to_arrays(buf)
    assert got == jnative.ext.pb_to_arrays(buf)
    py = tpa._py_pb_to_arrays(buf)
    assert got[0] == py[0] and got[6:8] == py[6:8]
    for k, dt in ((1, np.int32), (2, np.int32), (3, np.int8), (4, np.int8),
                  (5, np.uint8), (8, np.int32)):
        arr = np.frombuffer(got[k], dt) if got[k] else np.zeros(0, dt)
        np.testing.assert_array_equal(arr, py[k], err_msg=str(k))
    assert (got[9] or b"") == py[9]
    n, parent, names, blen = ext.newick_to_arrays(got[0])
    assert (n, parent, names, blen) == jnative.ext.newick_to_arrays(got[0])
    pn, pparent, pnames, pblen = tpa._py_newick_to_arrays(got[0])
    assert n == pn and names == pnames
    np.testing.assert_array_equal(np.frombuffer(parent, np.int32), pparent)
    np.testing.assert_array_equal(np.frombuffer(blen, np.float64), pblen)
    # the loader: compiled == JAX's == pure-Python
    compiled = tpa.load_mat_arrays(path)
    assert_same_arrays(compiled, jpa.load_mat_arrays(path))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "_loaded", lambda: (None, "not built"))
        assert_same_arrays(tpa.load_mat_arrays(path), compiled)


def test_empty_vectors_come_back_as_none(ext, tmp_path):
    """pb_to_arrays gives empty vectors as None (y# of a null pointer): a
    MAT without mutations, annotations or condensed nodes still loads."""
    from usher_tpu_torch.core.tree import Node, Tree
    from usher_tpu_torch.io.pbio import save_mat_pb
    T = Tree()
    T.root = Node("root", None, 0.0)
    T._all_nodes["root"] = T.root
    for name in ("a", "b"):
        nd = Node(name, T.root, 1.0)
        T.root.children.append(nd)
        T._all_nodes[name] = nd
    path = str(tmp_path / "bare.pb")
    save_mat_pb(T, path)
    with open(path, "rb") as f:
        raw = ext.pb_to_arrays(f.read())
    assert raw[1] is not None          # three nodes, zero mutations each
    assert raw[2:6] == (None,) * 4     # no mutation: positions, nt ids, masks
    got = tpa.load_mat_arrays(path)
    assert got.n == 3 and len(got.positions) == 0
    assert_same_arrays(got, jpa.load_mat_arrays(path))


@pytest.mark.parametrize("seed,gz", [(1, False), (2, True), (5, False)])
def test_vcf_parsers_match_python(ext, tmp_path, pure_python, seed, gz):
    path = random_vcf(str(tmp_path / f"r{seed}.vcf{'.gz' if gz else ''}"),
                      seed, gz=gz)
    want = _sites(tvcf.read_vcf_sites(path))       # pure Python (fixture)
    assert _sites(jvcf.read_vcf_sites(path)) == want
    for parsed in (ext.parse_vcf(path), ext.parse_vcf_mt(path, 4),
                   ext.parse_vcf_mt(path)):
        ids, sites = _raw(parsed)
        assert (ids, sites) == want
    for path in (GLOBAL_VCF, NEW_VCF):
        want = _sites(tvcf.read_vcf_sites(path))
        assert _raw(ext.parse_vcf(path)) == want
        assert _raw(ext.parse_vcf_mt(path, 5)) == want


def test_read_vcf_sites_takes_mt_for_large_files(ext, tmp_path, monkeypatch):
    """Above 32 MB on 8 cores read_vcf_sites goes through parse_vcf_mt, as in
    the JAX package, and gives what the serial parser gives."""
    path = random_vcf(str(tmp_path / "big.vcf"), 7)
    want = _sites(tvcf.read_vcf_sites(path))
    calls = []
    mt = ext.parse_vcf_mt
    monkeypatch.setattr(ext, "parse_vcf_mt",
                        lambda *a: calls.append(a) or mt(*a))
    monkeypatch.setattr(os.path, "getsize", lambda p: 33 << 20)
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    assert _sites(tvcf.read_vcf_sites(path)) == want
    assert calls == [(path,)]


def test_transposed_bytes_equal_the_jax_encoder(ext, tmp_path):
    """The compiled codec writes the JAX package's bytes (its compiled
    encoder) and the pure-Python encoder's, appends included, and the
    port's pure-Python codec reads them."""
    a, b = tmp_path / "jax.tvcf", tmp_path / "port.tvcf"
    rng = np.random.default_rng(11)
    samples = [(f"s{i}", sorted({(int(p), int(1 << rng.integers(4)))
                                 for p in rng.integers(1, 30000, 20)}),
                [(int(s), int(s + rng.integers(0, 40)))
                 for s in sorted(rng.integers(1, 30000, 3))])
               for i in range(40)]
    jtr.encode(samples, str(a))
    jtr.encode(CODEC_SAMPLES, str(a), append=True)
    ttr.encode(samples, str(b))
    ttr.encode(CODEC_SAMPLES, str(b), append=True)
    assert a.read_bytes() == b.read_bytes()
    # and the pure-Python encoder's bytes
    c = tmp_path / "py.tvcf"
    ttr._encode_py(samples, str(c))
    ttr._encode_py(CODEC_SAMPLES, str(c), append=True)
    assert c.read_bytes() == b.read_bytes()
    assert ttr._decode_py(str(b)) == jtr.decode(str(a))
    assert ttr.decode(str(b)) == samples + CODEC_SAMPLES


# --- the build ---------------------------------------------------------------

def test_build_is_cached_and_rebuilt_after_an_edit(tmp_path):
    """A temporary copy of the source: the first build compiles, a second
    finds the library by its hash, an edited source gets a new one; every
    library loads as _usher_native."""
    src = tmp_path / "usher_native.cpp"
    src.write_bytes(_build.SOURCE.read_bytes())
    out = tmp_path / "build"
    first = _build.build(src, out)
    stamp = first.stat().st_mtime_ns
    assert _build.build(src, out) == first
    assert first.stat().st_mtime_ns == stamp
    src.write_text(src.read_text() + "\n// edited\n")
    second = _build.build(src, out)
    assert second != first and second.exists() and first.exists()
    assert not list(out.glob("*.tmp"))
    mod = _build.load(second)
    assert mod.__name__ == "_usher_native"
    assert mod.parse_vcf(NEW_VCF) == native.ext.parse_vcf(NEW_VCF)


def test_failed_build_is_loud(tmp_path, monkeypatch, capsys):
    """A source that does not compile raises with the compiler's error, and
    the package prints one stderr line and falls back to pure Python."""
    src = tmp_path / "usher_native.cpp"
    src.write_text("#include <Python.h>\nthis is not C++;\n")
    out = tmp_path / "build"
    with pytest.raises(RuntimeError, match="error"):
        _build.build(src, out)
    assert not list(out.glob("*"))
    build = _build.build
    monkeypatch.setattr(_build, "build", lambda: build(src, out))
    mod, err = native._loaded.__wrapped__()
    assert mod is None and "this is not C++" in err
    lines = capsys.readouterr().err.splitlines()
    assert len(lines) == 1 and "pure-Python" in lines[0]
    assert "error:" in lines[0] and str(src) in lines[0]
