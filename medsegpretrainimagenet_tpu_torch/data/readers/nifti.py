"""Minimal NIfTI-1 reader and writer (numpy only).

The port's own copy of ``medsegpretrainimagenet_tpu/data/readers/nifti.py``.
The reference loads ACDC patient volumes with nibabel
(``segmentation/datasets/datasets.py:416-435``); this module parses NIfTI-1
itself: a 348-byte little-endian header (gzipped together with the data in
a ``.nii.gz``) followed by Fortran-ordered voxels.  Only the fields the
ACDC reader needs are read: dims, datatype, scaling slope and intercept,
the sform affine.
"""
from __future__ import annotations

import gzip
import struct
from typing import Tuple

import numpy as np

__all__ = ["load_nii", "save_nii"]

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
    1280: np.uint64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as fh:
        head = fh.read(2)
        fh.seek(0)
        if head == b"\x1f\x8b":
            return gzip.decompress(fh.read())
        return fh.read()


def load_nii(path: str) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Returns ``(fdata float64, affine 4x4, header dict)`` like nibabel's
    ``(nimg.get_fdata(), nimg.affine, nimg.header)``."""
    raw = _read_bytes(path)
    if len(raw) < 348:
        raise ValueError(f"{path}: truncated NIfTI header")
    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    if sizeof_hdr != 348:
        raise ValueError(f"{path}: not a little-endian NIfTI-1 file")
    dim = struct.unpack_from("<8h", raw, 40)
    ndim = dim[0]
    shape = tuple(dim[1:1 + ndim])
    datatype = struct.unpack_from("<h", raw, 70)[0]
    vox_offset = int(struct.unpack_from("<f", raw, 108)[0])
    scl_slope, scl_inter = struct.unpack_from("<2f", raw, 112)
    dtype = _DTYPES.get(datatype)
    if dtype is None:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")

    count = int(np.prod(shape)) if shape else 0
    data = np.frombuffer(raw, dtype=np.dtype(dtype).newbyteorder("<"),
                         count=count, offset=vox_offset or 352)
    data = data.reshape(shape, order="F").astype(np.float64)
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data * slope + scl_inter

    srow = np.array(struct.unpack_from("<12f", raw, 280),
                    np.float64).reshape(3, 4)
    affine = np.eye(4)
    if np.abs(srow).sum() > 0:
        affine[:3] = srow
    header = {"dim": dim, "datatype": datatype, "vox_offset": vox_offset,
              "scl_slope": scl_slope, "scl_inter": scl_inter}
    return data, affine, header


def save_nii(path: str, data: np.ndarray, affine: np.ndarray = None,
             compresslevel: int = 9) -> None:
    """Write a minimal single-file NIfTI-1 (.nii, or .nii.gz gzipped at
    *compresslevel*)."""
    data = np.asarray(data)
    code = _CODES.get(data.dtype)
    if code is None:
        data = data.astype(np.float32)
        code = _CODES[np.dtype(np.float32)]
    header = bytearray(352)
    struct.pack_into("<i", header, 0, 348)
    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", header, 40, *dim)
    struct.pack_into("<h", header, 70, code)
    struct.pack_into("<h", header, 72, data.dtype.itemsize * 8)
    struct.pack_into("<8f", header, 76, 0, *([1.0] * data.ndim),
                     *([0.0] * (7 - data.ndim)))  # pixdim
    struct.pack_into("<f", header, 108, 352)      # vox_offset
    struct.pack_into("<2f", header, 112, 1.0, 0.0)
    struct.pack_into("<h", header, 254, 1)        # sform_code (252 is qform)
    if affine is None:
        affine = np.eye(4)
    struct.pack_into("<12f", header, 280,
                     *np.asarray(affine, np.float32)[:3].reshape(-1))
    header[344:348] = b"n+1\x00"
    payload = bytes(header) + data.tobytes(order="F")
    if path.endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=compresslevel) as fh:
            fh.write(payload)
    else:
        with open(path, "wb") as fh:
            fh.write(payload)
