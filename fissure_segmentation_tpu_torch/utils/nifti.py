"""Minimal pure-numpy NIfTI-1 reader/writer.

The reference delegates image IO to SimpleITK (utils/image_ops.py); neither
SimpleITK nor nibabel ships in this environment, so this implements the
NIfTI-1 subset the pipeline needs: .nii / .nii.gz, scalar volumes, common
dtypes, spacing (pixdim), affine (srow), scl slope/inter, and header-only
metadata reads (reference load_image_metadata, image_ops.py:115).

Arrays are returned zyx (D, H, W) like sitk.GetArrayFromImage; spacing is
returned xyz like sitk Image.GetSpacing().

A copy of the JAX package's utils/nifti.py (the port imports nothing of
that package); tests/test_torch_repairs.py holds it equal to the original.
"""
from __future__ import annotations

import gzip
import struct
from typing import NamedTuple

import numpy as np

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


class NiftiImage(NamedTuple):
    array: np.ndarray       # (D, H, W) zyx
    spacing: tuple          # (sx, sy, sz) xyz
    affine: np.ndarray      # 4x4 voxel(xyz, index order i,j,k) -> world

    @property
    def shape(self):
        return self.array.shape


def _read_bytes(path: str) -> bytes:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


def load_image_metadata(path: str):
    """Header-only read -> (size (D, H, W), spacing xyz)
    (reference utils/image_ops.py:115-124 parity)."""
    raw = _read_bytes(path)[:352]
    dim = struct.unpack_from("<8h", raw, 40)
    pixdim = struct.unpack_from("<8f", raw, 76)
    nx, ny, nz = dim[1], dim[2], dim[3]
    sx, sy, sz = pixdim[1], pixdim[2], pixdim[3]
    return (nz, ny, nx), (sx, sy, sz)


def load_nifti(path: str) -> NiftiImage:
    raw = _read_bytes(path)
    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    if sizeof_hdr != 348:
        raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")
    dim = struct.unpack_from("<8h", raw, 40)
    datatype = struct.unpack_from("<h", raw, 70)[0]
    pixdim = struct.unpack_from("<8f", raw, 76)
    vox_offset = int(struct.unpack_from("<f", raw, 108)[0])
    scl_slope = struct.unpack_from("<f", raw, 112)[0]
    scl_inter = struct.unpack_from("<f", raw, 116)[0]
    sform_code = struct.unpack_from("<h", raw, 254)[0]
    srow = np.array([struct.unpack_from("<4f", raw, 280 + 16 * r)
                     for r in range(3)])

    if datatype not in _DTYPES:
        raise ValueError(f"unsupported NIfTI datatype {datatype}")
    ndim = dim[0]
    shape_xyz = dim[1:1 + max(ndim, 3)]
    nx, ny, nz = shape_xyz[0], shape_xyz[1], (shape_xyz[2] if ndim >= 3 else 1)
    count = nx * ny * max(nz, 1)
    data = np.frombuffer(raw, dtype=_DTYPES[datatype], count=count,
                         offset=vox_offset or 352)
    arr = data.reshape(nz, ny, nx)  # fortran-order x-fastest -> zyx C order
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        arr = arr * (scl_slope or 1.0) + scl_inter

    affine = np.eye(4)
    if sform_code > 0:
        affine[:3] = srow
    else:
        affine[0, 0], affine[1, 1], affine[2, 2] = pixdim[1], pixdim[2], pixdim[3]
    spacing = (float(pixdim[1]), float(pixdim[2]), float(pixdim[3]))
    return NiftiImage(np.ascontiguousarray(arr), spacing, affine)


def save_nifti(path: str, array: np.ndarray, spacing=(1.0, 1.0, 1.0),
               affine: np.ndarray | None = None) -> None:
    """Write a (D, H, W) zyx array with xyz spacing."""
    array = np.asarray(array)
    if array.dtype == bool:
        array = array.astype(np.uint8)
    if array.dtype not in _DTYPE_CODES:
        array = array.astype(np.float32)
    nz, ny, nx = array.shape
    if affine is None:
        affine = np.diag([spacing[0], spacing[1], spacing[2], 1.0])

    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 3, nx, ny, nz, 1, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, _DTYPE_CODES[array.dtype])
    struct.pack_into("<h", hdr, 72, array.dtype.itemsize * 8)  # bitpix
    struct.pack_into("<8f", hdr, 76, 1.0, spacing[0], spacing[1], spacing[2],
                     1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)    # scl_slope
    struct.pack_into("<h", hdr, 252, 1)      # qform_code (identity quat)
    struct.pack_into("<h", hdr, 254, 1)      # sform_code
    for r in range(3):
        struct.pack_into("<4f", hdr, 280 + 16 * r, *affine[r])
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + array.tobytes()  # zyx C-order == x-fastest
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(payload)
