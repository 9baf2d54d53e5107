"""Parity: the PyTorch port's z-stack I/O (its native TIFF codec,
``read_tiff_stack``, ``read_zstack``, ``read_imagej_channels``,
``write_tiff``, ``NativePrefetcher``) and its ``split`` and ``normalize``
verbs against the JAX package's.

Inputs are made with numpy from a seed and written once to ``tmp_path``.
The tolerance is 0: decoded arrays equal in dtype, shape and bytes, written
files byte for byte, and the split and normalize trees path for path and
byte for byte.  The verbs move their inputs (``os.rename``), so each
package runs on its own copy of a tree and the two results are compared.
"""

import hashlib
import logging
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from particle_col_image_segmentation_tpu.cli import main as jax_cli
from particle_col_image_segmentation_tpu.io import native as jax_native
from particle_col_image_segmentation_tpu.io import tiff as jax_tiff
from particle_col_image_segmentation_tpu.io.discovery import (
    normalize_capture_tree as jax_normalize_capture_tree,
)
from particle_col_image_segmentation_tpu.models import zsplit as jax_zsplit
from particle_col_image_segmentation_tpu_torch.cli import main as torch_cli
from particle_col_image_segmentation_tpu_torch.io import native, tiff
from particle_col_image_segmentation_tpu_torch.io.discovery import normalize_capture_tree
from particle_col_image_segmentation_tpu_torch.models import zsplit

from chip_smoke import write_tiff_pages

REPO = Path(__file__).resolve().parent.parent


def _rand(shape, dtype, seed):
    return np.random.default_rng(seed).integers(
        0, np.iinfo(dtype).max, shape, endpoint=True).astype(dtype)


def _imagej(z, c):
    return f"ImageJ=1.53c\nimages={z * c}\nchannels={c}\nslices={z}\n"


def _outcome(fn, *args):
    """What a call returned, comparable across packages: arrays by dtype,
    shape and bytes; an exception by type and message."""
    try:
        out = fn(*args)
    except Exception as e:  # noqa: BLE001 — the exception is the outcome
        return ("raises", type(e).__name__, str(e))
    if isinstance(out, np.ndarray):
        return ("array", out.dtype.str, out.shape, out.tobytes())
    return ("value", out)


# ---- reads -----------------------------------------------------------------

READ_CASES = {
    # name: (writer, the native codec decodes it)
    "u8-single": (lambda p: write_tiff_pages(p, _rand((1, 40, 56), np.uint8, 1)), True),
    "u16-single": (lambda p: write_tiff_pages(p, _rand((1, 40, 56), np.uint16, 2)), True),
    "u8-multi": (lambda p: write_tiff_pages(p, _rand((6, 40, 56), np.uint8, 3)), True),
    "u16-multi": (lambda p: write_tiff_pages(p, _rand((6, 40, 56), np.uint16, 4)), True),
    "u16-multi-lzw": (lambda p: write_tiff_pages(p, _rand((4, 33, 47), np.uint16, 5),
                                           compression="tiff_lzw"), True),
    "u8-deflate": (lambda p: write_tiff_pages(p, _rand((2, 33, 47), np.uint8, 6),
                                        compression="tiff_adobe_deflate"), True),
    "imagej-4ch": (lambda p: write_tiff_pages(p, _rand((12, 24, 20), np.uint16, 7), _imagej(3, 4)),
                   True),
    "imagej-2ch": (lambda p: write_tiff_pages(p, _rand((4, 24, 20), np.uint8, 8), _imagej(2, 2)),
                   True),
    "imagej-1ch": (lambda p: write_tiff_pages(p, _rand((3, 24, 20), np.uint8, 9), _imagej(3, 1)),
                   True),
    "indivisible-5-pages": (lambda p: write_tiff_pages(p, _rand((5, 16, 16), np.uint8, 10)), True),
    # PackBits is outside the codec: it reports 0 pages and PIL reads
    "pil-only-packbits": (lambda p: write_tiff_pages(p, _rand((3, 30, 26), np.uint8, 11),
                                               compression="packbits"), False),
    "not-a-tiff": (lambda p: Path(p).write_bytes(b"garbage data, not a tiff"), False),
}


@pytest.fixture(scope="module")
def read_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("reads")
    for name, (write, _) in READ_CASES.items():
        write(root / f"{name}.tif")
    return root


@pytest.mark.parametrize("case", sorted(READ_CASES))
def test_reads_match_jax(read_dir, case):
    path = str(read_dir / f"{case}.tif")
    assert native.available() and jax_native.available()
    assert (native.read_tiff(path) is not None) == READ_CASES[case][1]
    calls = [
        ("read_tiff", native.read_tiff, jax_native.read_tiff, ()),
        ("read_tiff_stack", tiff.read_tiff_stack, jax_tiff.read_tiff_stack, ()),
        ("read_imagej_channels", tiff.read_imagej_channels, jax_tiff.read_imagej_channels, ()),
        ("read_zstack", tiff.read_zstack, jax_tiff.read_zstack, ()),
        ("read_zstack 2", tiff.read_zstack, jax_tiff.read_zstack, (2,)),
        ("read_zstack 4", tiff.read_zstack, jax_tiff.read_zstack, (4,)),
    ]
    for what, ours, theirs, extra in calls:
        assert _outcome(ours, path, *extra) == _outcome(theirs, path, *extra), what


def test_read_cases_reach_each_branch(read_dir):
    """The inputs cover the ImageJ grouping, the metadata overriding the
    caller's hint, the indivisible-pages error and the PIL route."""
    z = tiff.read_zstack(str(read_dir / "imagej-4ch.tif"), num_channels=2)
    assert z.shape == (3, 4, 24, 20)
    with pytest.raises(ValueError, match="do not group"):
        tiff.read_zstack(str(read_dir / "indivisible-5-pages.tif"), num_channels=2)
    assert native.read_tiff(str(read_dir / "pil-only-packbits.tif")) is None
    assert tiff.read_tiff_stack(str(read_dir / "pil-only-packbits.tif")).shape == (3, 30, 26)


# ---- writes ----------------------------------------------------------------

WRITE_CASES = {
    "u8-plane": _rand((37, 41), np.uint8, 20),
    "u16-plane": _rand((37, 41), np.uint16, 21),
    "u16-plane-view": _rand((41, 37), np.uint16, 22).T,  # not contiguous
    "u16-stack": _rand((3, 20, 24), np.uint16, 23),  # PIL, multi-page
    "f32-plane": np.random.default_rng(24).random((20, 24)).astype(np.float32),  # PIL
}


@pytest.mark.parametrize("case", sorted(WRITE_CASES))
def test_write_tiff_bytes_match_jax(tmp_path, case):
    arr = WRITE_CASES[case]
    tiff.write_tiff(str(tmp_path / "port.tif"), arr)
    jax_tiff.write_tiff(str(tmp_path / "jax.tif"), arr)
    assert (tmp_path / "port.tif").read_bytes() == (tmp_path / "jax.tif").read_bytes()
    np.testing.assert_array_equal(tiff.read_tiff_stack(str(tmp_path / "port.tif")), arr)


def test_prefetcher_matches_jax(read_dir):
    paths = [str(read_dir / f"{c}.tif") for c in sorted(READ_CASES)]
    ours = native.NativePrefetcher(paths, num_threads=3)
    theirs = jax_native.NativePrefetcher(paths, num_threads=3)
    try:
        order = np.random.default_rng(30).permutation(len(paths))
        decoded = 0
        for idx in map(int, order):
            got = _outcome(ours.get, idx)
            assert got == _outcome(theirs.get, idx), paths[idx]
            decoded += got[0] == "array"
        assert decoded == sum(ok for _, ok in READ_CASES.values())
        with pytest.raises(IndexError):
            ours.get(len(paths))
    finally:
        ours.close()
        theirs.close()
    with pytest.raises(RuntimeError, match="after close"):
        ours.get(0)


# ---- the native library: where it builds, concurrent builds, failures -------

def test_library_builds_under_build_and_outside_both_packages():
    lib = native.get_lib()
    assert lib is not None
    path = native.lib_path().resolve()
    assert Path(lib._name).resolve() == path
    assert path.is_relative_to(REPO / "build")
    for pkg in ("particle_col_image_segmentation_tpu", "particle_col_image_segmentation_tpu_torch"):
        assert not path.is_relative_to(REPO / pkg)
    assert Path(jax_native.get_lib()._name).resolve() != path


def test_concurrent_first_builds_all_load(tmp_path):
    """Processes that find an empty build directory and build at once all
    load a whole library and decode the same file equally."""
    arr = _rand((4, 50, 60), np.uint16, 40)
    src = tmp_path / "stack.tif"
    write_tiff_pages(src, arr, compression="tiff_adobe_deflate")
    build_dir = tmp_path / "build"
    code = (
        "import hashlib, sys\n"
        "from pathlib import Path\n"
        "from particle_col_image_segmentation_tpu_torch.io import native\n"
        "native.BUILD_DIR = Path(sys.argv[1])\n"
        "a = native.read_tiff(sys.argv[2])\n"
        "assert a is not None, 'the codec did not load or decode'\n"
        "print(native.lib_path().name, a.dtype, a.shape, hashlib.sha256(a.tobytes()).hexdigest())\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build_dir), str(src)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    lines = {out.strip().splitlines()[-1] for out, _ in outs}
    want = (f"{native.lib_path().name} uint16 (4, 50, 60) "
            f"{hashlib.sha256(arr.tobytes()).hexdigest()}")
    assert lines == {want}
    assert sorted(p.name for p in build_dir.iterdir()) == [native.lib_path().name]


def test_failed_build_logs_once_and_reads_with_pil(tmp_path, monkeypatch):
    """A failed build leaves ``available()`` False, logs the compiler's
    output once, writes no library, and every read and write goes to PIL."""
    bad = tmp_path / "pcis_io.cpp"
    bad.write_text("#error this codec does not build\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("pcis.native")
    logger.addHandler(handler)
    try:
        assert not native.available()
        assert not native.available()
        arr = _rand((3, 20, 30), np.uint16, 50)
        p = str(tmp_path / "x.tif")
        write_tiff_pages(p, arr)
        assert native.read_tiff(p) is None
        np.testing.assert_array_equal(tiff.read_tiff_stack(p), arr)
        assert not native.write_tiff(str(tmp_path / "y.tif"), arr[0])
        tiff.write_tiff(str(tmp_path / "y.tif"), arr[0])
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "y.tif")), arr[0])
        with pytest.raises(RuntimeError, match="unavailable"):
            native.NativePrefetcher([p])
    finally:
        logger.removeHandler(handler)
    assert len(records) == 1
    assert "this codec does not build" in records[0].getMessage()
    assert list((tmp_path / "build").iterdir()) == []


# ---- the split verb --------------------------------------------------------

def _tree(root: Path) -> dict:
    """Every path under root: file bytes, or None for a directory."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        for d in dirnames:
            out[os.path.relpath(os.path.join(dirpath, d), root)] = None
        for f in filenames:
            out[os.path.relpath(os.path.join(dirpath, f), root)] = \
                Path(dirpath, f).read_bytes()
    return out


def _split_two_channel(top):
    stack = _rand((3, 2, 16, 16), np.uint8, 1)
    jax_tiff.write_tiff(str(top / "acq1" / "Tp_RFP_GFP_5_zstack.tif"), stack.reshape(6, 16, 16))


def _split_four_channel(top):
    write_tiff_pages(top / "acq1" / "Tp_CY5_RFP_GFP_DAPI_1_zstack.tif",
               _rand((12, 24, 20), np.uint16, 2), _imagej(3, 4))
    write_tiff_pages(top / "acq2" / "Tp_RFP_GFP_2_zstack.tif", _rand((4, 24, 20), np.uint16, 3),
               _imagej(2, 2))


def _split_metadata_overrides_token(top):
    # the token says two channels, the ImageJ metadata four
    write_tiff_pages(top / "acq1" / "Tp_RFP_GFP_1_zstack.tif", _rand((12, 8, 8), np.uint8, 5),
               _imagej(3, 4))


def _split_mip_dirname(top):
    (top / "exports_mip_x").mkdir()
    stack = _rand((4, 16, 16), np.uint8, 6)
    jax_tiff.write_tiff(str(top / "exports_mip_x" / "Tp_RFP_GFP_7_zstack.tif"), stack)


def _split_uppercase(top):
    jax_tiff.write_tiff(str(top / "acq1" / "Tp_RFP_GFP_8_zstack.TIF"),
                        _rand((4, 16, 16), np.uint8, 9))


def _split_mips_moved(top):
    jax_tiff.write_tiff(str(top / "acq1" / "Tp_RFP_GFP_5_mip.tif"), _rand((16, 16), np.uint8, 2))
    (top / "acq1" / "Tp_RFP_GFP_5_mip.jpg").write_bytes(b"\xff\xd8not really a jpeg")
    jax_tiff.write_tiff(str(top / "acq1" / "Tp_RFP_GFP_5_zstack.tif"),
                        _rand((4, 16, 16), np.uint16, 12))


def _split_bad_among_good(top):
    # 'aaa' sorts first, so the failure comes before the good capture
    jax_tiff.write_tiff(str(top / "acq1" / "Tp_RFP_GFP_aaa_zstack.tif"),
                        np.zeros((5, 16, 16), np.uint8))
    jax_tiff.write_tiff(str(top / "acq1" / "Tp_RFP_GFP_zzz_zstack.tif"),
                        _rand((4, 16, 16), np.uint8, 3))
    jax_tiff.write_tiff(str(top / "acq2" / "Tp_RFP_GFP_1_zstack.tif"),
                        _rand((4, 16, 16), np.uint8, 4))


def _split_single_page_and_one_channel(top):
    jax_tiff.write_tiff(str(top / "acq1" / "Tp_RFP_GFP_1_zstack.tif"),
                        _rand((16, 16), np.uint8, 13))
    write_tiff_pages(top / "acq1" / "Tp_RFP_GFP_2_zstack.tif", _rand((3, 8, 8), np.uint8, 14),
               _imagej(3, 1))
    jax_tiff.write_tiff(str(top / "acq1" / "Tp_RFP_GFP_3_zstack.tif"),
                        _rand((2, 8, 8), np.uint8, 15))


def _split_no_token_and_skips(top):
    jax_tiff.write_tiff(str(top / "acq1" / "plain_zstack.tif"), _rand((4, 8, 8), np.uint8, 16))
    (top / ".hidden").mkdir()
    jax_tiff.write_tiff(str(top / ".hidden" / "Tp_RFP_GFP_1_zstack.tif"),
                        _rand((4, 8, 8), np.uint8, 17))
    (top / "loose_RFP_GFP_zstack.tif").write_bytes(b"a file at the top level is not scanned")
    (top / "acq1" / "notes_zstack.txt").write_bytes(b"not a capture")


SPLIT_CASES = {
    "two-channel": (_split_two_channel, [1, 2]),
    "four-and-two-channel": (_split_four_channel, [1, 2]),
    "four-channel-other-indices": (_split_four_channel, [0, 3]),
    "metadata-overrides-token": (_split_metadata_overrides_token, [1, 2]),
    "mip-in-dirname": (_split_mip_dirname, [1, 2]),
    "uppercase-TIF": (_split_uppercase, [1, 2]),
    "mips-moved-only": (_split_mips_moved, [1, 2]),
    "bad-among-good": (_split_bad_among_good, [1, 2]),
    "single-page-and-one-channel": (_split_single_page_and_one_channel, [1, 2]),
    "no-token-and-skips": (_split_no_token_and_skips, [1, 2]),
}


def _run_split(pkg: str, entry: str, top: Path, channels):
    if entry == "cli":
        cli = torch_cli if pkg == "port" else jax_cli
        return cli(["split", str(top), "--channels", *map(str, channels)])
    return (zsplit if pkg == "port" else jax_zsplit).process_folder(str(top), channels)


@pytest.mark.parametrize("entry", ["cli", "process_folder"])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_tree_matches_jax(tmp_path, monkeypatch, case, entry):
    make, channels = SPLIT_CASES[case]
    src = tmp_path / "src" / "top"
    (src / "acq1").mkdir(parents=True)
    (src / "acq2").mkdir()
    make(src)
    results, trees = {}, {}
    for pkg in ("jax", "port"):
        top = tmp_path / pkg / "top"
        shutil.copytree(src, top)
        monkeypatch.chdir(tmp_path / pkg)
        outcome = _outcome(_run_split, pkg, entry, top, channels)
        if outcome[0] == "raises":
            outcome = outcome[:2] + (outcome[2].replace(str(tmp_path / pkg), "<root>"),)
        results[pkg], trees[pkg] = outcome, _tree(tmp_path / pkg)
    assert results["port"] == results["jax"]
    assert sorted(trees["port"]) == sorted(trees["jax"])
    assert trees["port"] == trees["jax"]
    # the inputs were split or moved, not left in place
    assert trees["port"] != _tree(tmp_path / "src")


def test_split_cases_reach_each_branch(tmp_path, monkeypatch):
    """Spot checks of the port's own tree on the cases above: planes equal
    their source planes, mips are moved only, a bad capture is reported
    at the end with the others split."""
    top = tmp_path / "top"
    (top / "acq1").mkdir(parents=True)
    (top / "acq2").mkdir()
    _split_four_channel(top)
    _split_mips_moved(top)
    _split_bad_among_good(top)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match=r"1 capture\(s\) failed") as e:
        torch_cli(["split", str(top)])
    assert "Tp_RFP_GFP_aaa_zstack.tif" in str(e.value)
    src = _rand((12, 24, 20), np.uint16, 2).reshape(3, 4, 24, 20)
    rfp = top / "acq1" / "Tp_1" / "Tp_1_zstack_RFP"
    assert sorted(os.listdir(rfp)) == [f"Tp_1_zstack_z{i}_RFP.tif" for i in range(3)]
    for i in range(3):
        np.testing.assert_array_equal(tiff.read_tiff_stack(str(rfp / f"Tp_1_zstack_z{i}_RFP.tif")),
                                      src[i, 1])
    assert sorted(os.listdir(top / "acq1" / "Tp_5")) == [
        "Tp_5_zstack_GFP", "Tp_5_zstack_RFP", "Tp_RFP_GFP_5_mip.jpg", "Tp_RFP_GFP_5_mip.tif",
        "Tp_RFP_GFP_5_zstack.tif"]
    assert len(os.listdir(top / "acq1" / "Tp_zzz" / "Tp_zzz_zstack_GFP")) == 2


# ---- the normalize verb ----------------------------------------------------

def _norm_basic(cap):
    for n in ("Tp_RFP_3_zstack.tif", "Tp_RFP_3_mip.tif", "Tp_RFP_3_mip.jpg"):
        (cap / "run1" / n).write_bytes(b"II*\x00" + n.encode())


def _norm_token_boundary(cap):
    for n in ("run_Pos1_DAPI_zstack.tif", "run_Pos1_DAPI_mip.tif", "run_Pos10_DAPI_mip.tif",
              "run_Pos10_DAPI_zstack.tif"):
        (cap / "run1" / n).write_bytes(n.encode())


def _norm_token_in_dirname(cap):
    d = cap / "run_GFP_zstack"
    d.mkdir()
    for n in ("Tp_GFP_2_zstack.tif", "Tp_GFP_2_mip.jpg"):
        (d / n).write_bytes(n.encode())


def _norm_skips(cap):
    (cap / ".hidden").mkdir()
    (cap / ".hidden" / "Tp_RFP_1_zstack.tif").write_bytes(b"x")
    (cap / "run1" / "Tp_CY5_RFP_GFP_DAPI_4_zstack.TIF").write_bytes(b"upper")
    (cap / "run1" / "only_mip.tif").write_bytes(b"mip-only names are never listed")
    (cap / "loose_zstack.tif").write_bytes(b"a file at the top level is not scanned")


NORMALIZE_CASES = {
    "basic": _norm_basic,
    "token-boundary": _norm_token_boundary,
    "token-in-dirname": _norm_token_in_dirname,
    "skips-and-uppercase": _norm_skips,
}


@pytest.mark.parametrize("case", list(NORMALIZE_CASES))
def test_normalize_matches_jax(tmp_path, monkeypatch, capsys, case):
    src = tmp_path / "src" / "cap"
    (src / "run1").mkdir(parents=True)
    NORMALIZE_CASES[case](src)
    printed, trees, returned = {}, {}, {}
    for pkg, cli, fn in (("jax", jax_cli, jax_normalize_capture_tree),
                         ("port", torch_cli, normalize_capture_tree)):
        for entry in ("cli", "function"):
            root = tmp_path / pkg / entry
            shutil.copytree(src, root / "cap")
            monkeypatch.chdir(root)
            capsys.readouterr()
            if entry == "cli":
                assert cli(["normalize", str(root / "cap")]) == 0
                printed[pkg] = capsys.readouterr().out.replace(str(root), "<root>")
            else:
                returned[pkg] = [os.path.relpath(f, root) for f in fn(str(root / "cap"))]
            trees[pkg, entry] = _tree(root)
    assert printed["port"] == printed["jax"]
    assert printed["port"].count("normalized: ") >= 1
    assert returned["port"] == returned["jax"]
    for entry in ("cli", "function"):
        assert trees["port", entry] == trees["jax", entry]
    assert trees["port", "cli"] == trees["port", "function"]
