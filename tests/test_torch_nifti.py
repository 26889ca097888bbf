"""The port's NIfTI-1 reader and writer (``data/nifti.py``) and its
``NiftiVBMDataset`` (``models/cnn3d.py``), on the CPU.

The JAX package's ``tests/test_nifti.py`` cases run on the port, and the
two packages are held to each other bit for bit: a file written by either
loads identically in the other, an uncompressed file's bytes are the same
(a ``.nii.gz`` after decompression: gzip stamps the time), and the
dataset's items are the same arrays.  The built-in reader is the path
under test (no nibabel here).
"""
import gzip
import os
import struct

import numpy as np
import pytest

from coinstac_dinunet_tpu.data import nifti as jax_nifti
from coinstac_dinunet_tpu.models import NiftiVBMDataset as JaxNiftiVBMDataset
from coinstac_dinunet_tpu_torch.data import nifti
from coinstac_dinunet_tpu_torch.data.nifti import load_nifti, save_nifti
from coinstac_dinunet_tpu_torch.models import NiftiVBMDataset, fit_volume

DTYPES = [np.float32, np.int16, np.uint8, np.float64]


def test_no_nibabel_so_the_builtin_reader_is_tested():
    assert nifti.HAVE_NIBABEL is False and jax_nifti.HAVE_NIBABEL is False
    assert nifti._DTYPES == jax_nifti._DTYPES


# ------------------------------------------------------------------ reader
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("gz", [False, True])
def test_nifti_roundtrip(tmp_path, dtype, gz):
    rng = np.random.default_rng(0)
    arr = (rng.normal(size=(5, 7, 3)) * 50).astype(dtype)
    p = str(tmp_path / ("v.nii.gz" if gz else "v.nii"))
    save_nifti(p, arr)
    back = load_nifti(p)
    np.testing.assert_array_equal(back, arr.astype(back.dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("gz", [False, True])
def test_files_cross_between_packages_bit_for_bit(tmp_path, dtype, gz):
    rng = np.random.default_rng(1)
    arr = (rng.normal(size=(6, 5, 4)) * 40).astype(dtype)
    ext = ".nii.gz" if gz else ".nii"
    ours, theirs = str(tmp_path / f"port{ext}"), str(tmp_path / f"jax{ext}")
    save_nifti(ours, arr)
    jax_nifti.save_nifti(theirs, arr)
    read = lambda p: open(p, "rb").read()  # noqa: E731
    raw = (lambda p: gzip.decompress(read(p))) if gz else read
    assert raw(ours) == raw(theirs)
    for path in (ours, theirs):
        a, b = load_nifti(path), jax_nifti.load_nifti(path)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(load_nifti(path, dtype=np.float32),
                                      jax_nifti.load_nifti(path, dtype=np.float32))


def _patch_scaling(p, slope, inter):
    raw = bytearray(open(p, "rb").read())
    struct.pack_into("<2f", raw, 112, slope, inter)
    open(p, "wb").write(bytes(raw))


def test_nifti_scl_slope_applied(tmp_path):
    arr = np.arange(24, dtype=np.int16).reshape(2, 3, 4)
    p = str(tmp_path / "scaled.nii")
    save_nifti(p, arr)
    _patch_scaling(p, 0.5, 10.0)
    back = load_nifti(p)
    np.testing.assert_allclose(back, arr * 0.5 + 10.0, atol=1e-5)
    np.testing.assert_array_equal(back, jax_nifti.load_nifti(p))


def test_nifti_scl_slope_zero_means_no_scaling(tmp_path):
    arr = np.arange(24, dtype=np.int16).reshape(2, 3, 4)
    p = str(tmp_path / "unscaled.nii")
    save_nifti(p, arr)
    _patch_scaling(p, 0.0, 10.0)
    back = load_nifti(p)
    np.testing.assert_array_equal(back, arr.astype(back.dtype))
    assert back.dtype == np.int16 == jax_nifti.load_nifti(p).dtype


def test_nifti_big_endian(tmp_path):
    arr = np.arange(8, dtype=np.int16).reshape(2, 2, 2)
    hdr = bytearray(348)
    struct.pack_into(">i", hdr, 0, 348)
    struct.pack_into(">8h", hdr, 40, 3, 2, 2, 2, 1, 1, 1, 1)
    struct.pack_into(">h", hdr, 70, 4)  # int16
    struct.pack_into(">h", hdr, 72, 16)
    struct.pack_into(">f", hdr, 108, 352.0)
    struct.pack_into(">2f", hdr, 112, 1.0, 0.0)
    hdr[344:348] = b"n+1\x00"
    p = str(tmp_path / "be.nii")
    open(p, "wb").write(bytes(hdr) + b"\x00" * 4 + arr.astype(">i2").tobytes(order="F"))
    np.testing.assert_array_equal(load_nifti(p), arr)


def test_nifti_fortran_order(tmp_path):
    arr = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
    p = str(tmp_path / "f.nii")
    save_nifti(p, arr)
    np.testing.assert_array_equal(load_nifti(p), arr)
    # column-major on disk: the first voxels after the header run along x
    data = np.frombuffer(open(p, "rb").read()[352:], np.float32)
    np.testing.assert_array_equal(data[:2], arr[:, 0, 0])


def test_nifti_gzip_by_magic_not_by_name(tmp_path):
    arr = np.arange(27, dtype=np.float32).reshape(3, 3, 3)
    gz = str(tmp_path / "v.nii.gz")
    save_nifti(gz, arr)
    renamed = str(tmp_path / "v_really_gzip.nii")
    os.rename(gz, renamed)
    np.testing.assert_array_equal(load_nifti(renamed), arr)


def test_nifti_clear_errors(tmp_path):
    p = str(tmp_path / "junk.nii")
    open(p, "wb").write(b"\x00" * 400)
    with pytest.raises(ValueError, match="NIfTI"):
        load_nifti(p)
    hdr = bytearray(400)
    struct.pack_into("<i", hdr, 0, 348)
    p2 = str(tmp_path / "pair.nii")
    open(p2, "wb").write(bytes(hdr))
    with pytest.raises(ValueError, match="nibabel"):
        load_nifti(p2)
    # a NIfTI-2 header (sizeof_hdr 540) names nibabel too
    n2 = bytearray(600)
    struct.pack_into("<i", n2, 0, 540)
    p3 = str(tmp_path / "n2.nii")
    open(p3, "wb").write(bytes(n2))
    with pytest.raises(ValueError, match="NIfTI-2"):
        load_nifti(p3)
    p4 = str(tmp_path / "short.nii")
    open(p4, "wb").write(b"\x00" * 10)
    with pytest.raises(ValueError, match="too short"):
        load_nifti(p4)


def test_fit_volume_crop_and_pad():
    arr = np.arange(4 * 6 * 2, dtype=np.float32).reshape(4, 6, 2)
    out = fit_volume(arr, (2, 4, 4))
    assert out.shape == (2, 4, 4)
    np.testing.assert_array_equal(out[:, :, 1:3], arr[1:3, 1:5, :])
    assert out[:, :, 0].sum() == 0 and out[:, :, 3].sum() == 0


def test_fit_volume_rejects_wrong_ndim():
    with pytest.raises(ValueError, match="4-D"):
        fit_volume(np.zeros((4, 4, 4, 7), np.float32), (4, 4, 4))


# ----------------------------------------------------------------- dataset
def make_site_data(d, n, shape=(10, 12, 9), start=0, n_classes=2, scaled_int16=False,
                   labels_file="labels.csv"):
    """``n`` labelled volumes (label ``(start + i) % n_classes``, a class
    offset on the mean), every other one an int16 ``.nii`` with a header
    slope when ``scaled_int16``, plus a stray unlabelled ``.nii.gz``."""
    rng = np.random.default_rng(start)
    rows = []
    for i in range(n):
        y = (start + i) % n_classes
        vol = rng.normal(loc=0.6 * y, size=shape).astype(np.float32)
        if scaled_int16 and i % 2:
            name = f"subj_{start + i}.nii"
            save_nifti(os.path.join(d, name), np.round(vol * 1000).astype(np.int16))
            _patch_scaling(os.path.join(d, name), 1e-3, 0.25)
        else:
            name = f"subj_{start + i}.nii.gz"
            save_nifti(os.path.join(d, name), vol)
        rows.append(f"{name},{y}")
    save_nifti(os.path.join(d, "stray.nii.gz"), np.zeros(shape, np.float32))
    with open(os.path.join(d, labels_file), "w") as f:
        f.write("filename,label\n" + "\n".join(rows) + "\n")


@pytest.mark.parametrize("normalize", [True, False])
def test_dataset_items_equal_jax(tmp_path, normalize):
    d = tmp_path / "data"
    d.mkdir()
    make_site_data(str(d), 6, n_classes=3, scaled_int16=True)
    cache = {"input_shape": (8, 8, 8), "data_dir": "data", "normalize": normalize}
    state = {"baseDirectory": str(tmp_path), "clientId": "s"}
    files = sorted(os.listdir(d))
    ours, theirs = NiftiVBMDataset(), JaxNiftiVBMDataset()
    ours.add(files, cache=dict(cache), state=dict(state))
    theirs.add(files, cache=dict(cache), state=dict(state))
    assert len(ours) == len(theirs) == 6  # the stray and labels.csv skipped
    assert ours.indices == theirs.indices
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert sorted(a) == sorted(b) == ["inputs", "labels"]
        assert a["inputs"].dtype == b["inputs"].dtype == np.float32
        assert a["inputs"].shape == (8, 8, 8)
        np.testing.assert_array_equal(a["inputs"], b["inputs"])
        assert a["labels"] == b["labels"] and a["labels"].dtype == b["labels"].dtype
        if normalize:
            assert abs(float(a["inputs"].mean())) < 1e-4


def test_dataset_labels_file_and_skipped_volumes(tmp_path):
    d = tmp_path / "data"
    d.mkdir()
    make_site_data(str(d), 4, labels_file="labels_binary.csv")
    ds = NiftiVBMDataset()
    cache = {"input_shape": (8, 8, 8), "data_dir": "data", "labels_file": "labels_binary.csv"}
    ds.add(sorted(os.listdir(d)), cache=cache,
           state={"baseDirectory": str(tmp_path), "clientId": "s"})
    assert len(ds) == 4
    assert "stray.nii.gz" not in [f for _, f in ds.indices]
    assert ds[0]["labels"] in (0, 1)
