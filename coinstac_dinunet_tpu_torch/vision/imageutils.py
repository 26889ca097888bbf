"""Neuroimaging / segmentation image utilities: the port of the JAX
package's ``vision/imageutils.py``.

Host-side numpy (and ``scipy.ndimage``) code, no device work: the image
container with mask, ground truth and CLAHE, the TP/FP/FN RGB map,
precision/recall/F1, rescaling, N-dimensional patch chunking, merging and
mirror expansion, the largest connected component, component pruning and
pixel neighbours.  Every function returns what the JAX package's returns on
the same input, bit for bit, the known-defect fixes included (coverage-
counted patch averages, component extent by its bounding box).  PIL and
cv2 are imported lazily; CLAHE takes OpenCV where it is installed and
otherwise the numpy tile-interpolated equalization :func:`_clahe_numpy`.
"""
import copy as _copy
import math
import os

import numpy as np

from ..utils import logger

__all__ = [
    "Image",
    "get_rgb_scores",
    "get_praf1",
    "rescale",
    "rescale2d",
    "rescale3d",
    "get_signed_diff_int8",
    "whiten_image2d",
    "get_chunk_indexes",
    "get_chunk_indices_by_index",
    "merge_patches",
    "expand_and_mirror_patch",
    "largest_cc",
    "map_img_to_img2d",
    "remove_connected_comp",
    "get_pix_neigh",
]


class Image:
    """Container for an image, its mask, and its ground truth.

    Mirrors the reference container API (``vision/imageutils.py:21-85``):
    ``load``/``load_mask``/``load_ground_truth`` resolve files through a
    filename-mapping callable, ``apply_mask`` zeroes outside the mask, and
    ``apply_clahe`` contrast-equalizes in place.  Load failures are logged
    and swallowed (matching ``safe_collate``-style robustness, ref
    ``data/data.py:23-27``).
    """

    def __init__(self, dtype=np.uint8):
        self.dir = None
        self.file = None
        self.array = None
        self.mask = None
        self.ground_truth = None
        self.extras = {}
        self.dtype = dtype

    @staticmethod
    def _read(path, dtype):
        from PIL import Image as PILImage

        return np.array(PILImage.open(path), dtype=dtype)

    @property
    def path(self):
        return os.path.join(self.dir, self.file)

    def load(self, dir, file):
        try:
            self.dir, self.file = dir, file
            self.array = self._read(self.path, self.dtype)
        except Exception as e:  # noqa: BLE001 — parity: log-and-continue
            logger.error(f"loading image file {file}: {e}")

    def load_mask(self, mask_dir=None, fget_mask=lambda x: x):
        try:
            self.mask = self._read(
                os.path.join(mask_dir, fget_mask(self.file)), self.dtype
            )
        except Exception as e:  # noqa: BLE001
            logger.error(f"loading mask for {self.file}: {e}")

    def load_ground_truth(self, gt_dir=None, fget_ground_truth=lambda x: x):
        try:
            self.ground_truth = self._read(
                os.path.join(gt_dir, fget_ground_truth(self.file)), self.dtype
            )
        except Exception as e:  # noqa: BLE001
            logger.error(f"loading ground truth for {self.file}: {e}")

    def get_array(self, dir="", getter=lambda x: x, file=None):
        return self._read(os.path.join(dir, getter(file or self.file)), self.dtype)

    def apply_mask(self):
        if self.mask is not None:
            self.array[self.mask == 0] = 0

    def apply_clahe(self, clip_limit=2.0, tile_shape=(8, 8)):
        if self.array.ndim == 2:
            self.array = _clahe(self.array, clip_limit, tile_shape)
        elif self.array.ndim == 3:
            for c in range(min(self.array.shape[-1], 3)):
                self.array[..., c] = _clahe(self.array[..., c], clip_limit, tile_shape)
        else:
            logger.warn(f"apply_clahe skipped: unsupported {self.array.ndim}-D array")

    def __copy__(self):
        out = Image(dtype=_copy.deepcopy(self.dtype))
        out.dir = self.dir
        out.file = self.file
        out.array = _copy.copy(self.array)
        out.mask = _copy.copy(self.mask)
        out.ground_truth = _copy.copy(self.ground_truth)
        out.extras = _copy.deepcopy(self.extras)
        return out


def _clahe(arr2d, clip_limit, tile_shape):
    """CLAHE via OpenCV when present, else a numpy tile-equalization fallback."""
    try:
        import cv2

        return cv2.createCLAHE(
            clipLimit=clip_limit, tileGridSize=tuple(tile_shape)
        ).apply(np.ascontiguousarray(arr2d, np.uint8))
    except Exception:  # noqa: BLE001 — cv2 absent or non-uint8 input
        return _clahe_numpy(arr2d, clip_limit, tile_shape)


def _clahe_numpy(arr2d, clip_limit, tile_shape):
    """Tile-wise clipped histogram equalization, bilinearly interpolated.

    Fallback used only when OpenCV is unavailable; same knobs (clip limit in
    multiples of the uniform bin height, tile grid shape).
    """
    arr = np.ascontiguousarray(arr2d, np.uint8)
    h, w = arr.shape
    th, tw = max(h // tile_shape[0], 1), max(w // tile_shape[1], 1)
    gy, gx = math.ceil(h / th), math.ceil(w / tw)
    # per-tile clipped CDF lookup tables
    luts = np.zeros((gy, gx, 256), np.float32)
    for i in range(gy):
        for j in range(gx):
            tile = arr[i * th:(i + 1) * th, j * tw:(j + 1) * tw]
            hist = np.bincount(tile.ravel(), minlength=256).astype(np.float64)
            clip = clip_limit * tile.size / 256.0
            excess = np.maximum(hist - clip, 0).sum()
            hist = np.minimum(hist, clip) + excess / 256.0
            cdf = hist.cumsum()
            cdf = cdf / max(cdf[-1], 1.0)
            luts[i, j] = (cdf * 255.0).astype(np.float32)
    # bilinear interpolation between the four surrounding tile LUTs
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    fy = (yy + 0.5) / th - 0.5
    fx = (xx + 0.5) / tw - 0.5
    y0 = np.clip(np.floor(fy).astype(int), 0, gy - 1)
    x0 = np.clip(np.floor(fx).astype(int), 0, gx - 1)
    y1 = np.clip(y0 + 1, 0, gy - 1)
    x1 = np.clip(x0 + 1, 0, gx - 1)
    wy = np.clip(fy - y0, 0.0, 1.0)
    wx = np.clip(fx - x0, 0.0, 1.0)
    v = arr
    out = (
        luts[y0, x0, v] * (1 - wy) * (1 - wx)
        + luts[y1, x0, v] * wy * (1 - wx)
        + luts[y0, x1, v] * (1 - wy) * wx
        + luts[y1, x1, v] * wy * wx
    )
    return out.astype(np.uint8)


def _binarize(a):
    a = a.copy()
    a[a == 255] = 1
    return a


def get_rgb_scores(arr_2d=None, truth=None):
    """RGB TP/FP/FN map of a binary prediction vs ground truth
    (≙ ref ``imageutils.py:88-107``): TP white, FP green, FN red, TN black.
    """
    code = _binarize(arr_2d).astype(np.int64) + 2 * _binarize(truth).astype(np.int64)
    palette = np.array(
        [[0, 0, 0], [0, 255, 0], [255, 0, 0], [255, 255, 255]], np.uint8
    )
    return palette[code]


def get_praf1(arr_2d=None, truth=None):
    """Precision/recall/F1/accuracy between two binary arrays, 5 decimals
    (≙ ref ``imageutils.py:110-151``)."""
    code = _binarize(arr_2d).astype(np.int64) + 2 * _binarize(truth).astype(np.int64)
    counts = np.bincount(code.ravel(), minlength=4)
    tn, fp, fn, tp = (int(c) for c in counts[:4])
    p = tp / (tp + fp) if tp + fp else 0
    r = tp / (tp + fn) if tp + fn else 0
    a = (tp + tn) / max(tp + fp + fn + tn, 1)
    f1 = 2 * p * r / (p + r) if p + r else 0
    return {
        "Precision": round(p, 5),
        "Recall": round(r, 5),
        "Accuracy": round(a, 5),
        "F1": round(f1, 5),
    }


def rescale(arr):
    """Min-max rescale to [0, 1] (any rank)."""
    arr = np.asarray(arr, np.float64)
    lo, hi = arr.min(), arr.max()
    return (arr - lo) / max(hi - lo, np.finfo(np.float64).tiny)


rescale2d = rescale  # parity aliases (ref ``imageutils.py:154-161``)


def rescale3d(arrays):
    return [rescale(a) for a in arrays]


def get_signed_diff_int8(image_arr1=None, image_arr2=None):
    """Signed difference image, rescaled to uint8 (≙ ref ``:164-168``)."""
    diff = np.asarray(image_arr1, np.int16) - np.asarray(image_arr2, np.int16)
    return (rescale(diff.astype(np.int8)) * 255).astype(np.uint8)


def whiten_image2d(img_arr2d=None):
    """Zero-mean/unit-std whiten then rescale to uint8 (≙ ref ``:171-174``)."""
    z = (img_arr2d - img_arr2d.mean()) / max(img_arr2d.std(), 1e-12)
    return (rescale(z) * 255).astype(np.uint8)


def get_chunk_indexes(img_shape, chunk_shape, offset=None):
    """Corners of sliding patches covering an N-D image.

    Yields ``[d0_from, d0_to, d1_from, d1_to, ...]`` per patch.  Strided by
    ``offset`` per axis; the trailing patch in each axis is shifted back so it
    ends exactly at the image border (same tiling semantics as ref
    ``imageutils.py:177-208``, generalized from 2-D to any rank — VBM volumes
    tile with the identical call).
    """
    if offset is None:
        offset = chunk_shape
    axes = []
    for size, chunk, step in zip(img_shape, chunk_shape, offset):
        starts = []
        for i in range(0, size, step):
            if i + chunk >= size:
                starts.append(max(size - chunk, 0))
                break
            starts.append(i)
        axes.append(starts)
    grids = np.meshgrid(*[np.arange(len(a)) for a in axes], indexing="ij")
    for idx in zip(*(g.ravel() for g in grids)):
        out = []
        for ax, i in enumerate(idx):
            start = axes[ax][i]
            # clamp: an image smaller than the chunk yields one full-image patch
            out += [int(start), int(min(start + chunk_shape[ax], img_shape[ax]))]
        yield out


def get_chunk_indices_by_index(img_shape, chunk_shape, indices=None):
    """Patch corners centered on given points, clamped inside the image
    (≙ ref ``imageutils.py:211-226``, any rank)."""
    out = []
    for center in indices:
        corners = []
        for size, chunk, c in zip(img_shape, chunk_shape, center):
            lo, hi = c - chunk // 2, c - chunk // 2 + chunk
            if lo < 0:
                lo, hi = 0, chunk
            if hi > size:
                lo, hi = max(size - chunk, 0), size
            corners += [int(lo), int(min(hi, size))]
        out.append(corners)
    return out


def merge_patches(patches, image_size, patch_size, offset=None, out_dtype=None):
    """Reassemble patches produced by :func:`get_chunk_indexes`; overlaps
    averaged by true coverage count.

    Unlike the reference (``imageutils.py:229-250``) this accumulates into a
    single sum/count buffer pair with slice assignment (no per-patch
    full-image pad), counts every covered pixel — the reference's
    ``padded > 0`` test drops zero-valued patch pixels from the denominator —
    and preserves the patch dtype (probability maps stay float;
    ``out_dtype`` overrides, the reference always clamped to uint8).
    """
    acc = np.zeros(tuple(image_size), np.float64)
    cnt = np.zeros(tuple(image_size), np.int64)
    for i, corners in enumerate(get_chunk_indexes(image_size, patch_size, offset)):
        sl = tuple(
            slice(corners[2 * d], corners[2 * d + 1]) for d in range(len(image_size))
        )
        shape = tuple(s.stop - s.start for s in sl)
        acc[sl] += np.asarray(patches[i]).reshape(shape)
        cnt[sl] += 1
    if out_dtype is None:
        out_dtype = np.asarray(patches[0]).dtype
    return (acc / np.maximum(cnt, 1)).astype(out_dtype)


def expand_and_mirror_patch(full_img_shape, orig_patch_indices, expand_by):
    """Grow a patch window by ``expand_by`` per axis; where the grown window
    leaves the image, report mirror-padding amounts instead.

    Returns ``(clamped_corners, pad_per_axis)`` where ``clamped_corners`` is
    ``(lo0, hi0, lo1, hi1, …)`` and ``pad_per_axis`` feeds ``np.pad(...,
    mode='reflect')`` — the U-Net wide-context trick (≙ ref
    ``imageutils.py:253-279``, generalized to any rank)."""
    ndim = len(full_img_shape)
    corners, pads = [], []
    for d in range(ndim):
        half = int(expand_by[d] / 2)
        lo = orig_patch_indices[2 * d] - half
        hi = orig_patch_indices[2 * d + 1] + half
        pad_lo = max(-lo, 0)
        pad_hi = max(hi - full_img_shape[d], 0)
        corners += [lo + pad_lo, hi - pad_hi]
        pads.append((pad_lo, pad_hi))
    return tuple(corners) + (pads,)


def _label(binary_arr):
    from scipy import ndimage

    structure = np.ones((3,) * np.asarray(binary_arr).ndim, np.int8)
    return ndimage.label(binary_arr, structure)


def largest_cc(binary_arr=None):
    """Boolean mask of the largest connected component (≙ ref ``:282-287``;
    scipy.ndimage instead of skimage, full connectivity, any rank)."""
    labels, n = _label(binary_arr)
    if n == 0:
        return None
    sizes = np.bincount(labels.ravel())[1:]
    return labels == (int(np.argmax(sizes)) + 1)


def map_img_to_img2d(map_to, img):
    """Overlay binary ``img`` in red onto a grayscale/RGB base
    (≙ ref ``imageutils.py:290-301``)."""
    arr = np.asarray(map_to).copy()
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1).astype(np.uint8)
    hot = img == 255
    arr[..., 0][hot] = 255
    arr[..., 1][hot] = 0
    arr[..., 2][hot] = 0
    return arr


def remove_connected_comp(segmented_img, connected_comp_diam_limit=20):
    """Drop connected components whose bounding-box diagonal is below the
    diameter limit (≙ ref ``imageutils.py:304-325``).

    Vectorized: one labeling pass + per-component bounding boxes via
    ``ndimage.find_objects``; the component's extent is its bbox diagonal
    (the reference measured the distance between the first and last pixels in
    scan order — an underestimate for most shapes)."""
    from scipy import ndimage

    img = np.asarray(segmented_img).copy()
    labels, n = _label(img)
    keep = np.ones(n + 1, bool)
    for i, sl in enumerate(ndimage.find_objects(labels), start=1):
        if sl is None:
            continue
        diam = math.sqrt(sum((s.stop - 1 - s.start) ** 2 for s in sl))
        keep[i] = diam >= connected_comp_diam_limit
    img[~keep[labels]] = 0
    return img


def get_pix_neigh(i, j, eight=False):
    """4- or 8-neighborhood of pixel (i, j), same ordering as the reference
    (``imageutils.py:328-348``)."""
    if eight:
        return [
            (i - 1, j - 1), (i - 1, j), (i - 1, j + 1), (i, j - 1),
            (i, j + 1), (i + 1, j - 1), (i + 1, j), (i + 1, j + 1),
        ]
    return [(i - 1, j), (i, j + 1), (i + 1, j), (i, j - 1)]
