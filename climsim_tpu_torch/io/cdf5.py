"""Minimal pure-Python reader for classic netCDF files (CDF-1/2/5).

A copy of ``climsim_tpu/io/cdf5.py``, kept here so the port imports
nothing of the JAX package. The ClimSim grid file
``ClimSim_low-res_grid-info.nc`` is CDF-5 ("64-bit data" classic netCDF),
which neither h5py nor scipy.io.netcdf_file can read. This implements the
classic-format on-disk spec (magic ``CDF\\x01|\\x02|\\x05``) directly:
header = [numrecs, dim_list, gatt_list, var_list]; fixed variables are
contiguous at their ``begin`` offset, record variables interleave along the
unlimited dimension. Variables come out as numpy arrays in native byte
order.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

_NC_DIMENSION = 0x0A
_NC_VARIABLE = 0x0B
_NC_ATTRIBUTE = 0x0C

# nc_type -> (numpy dtype, on-disk size in bytes)
_TYPEMAP = {
    1: (np.dtype(">i1"), 1),   # NC_BYTE
    2: (np.dtype("S1"), 1),    # NC_CHAR
    3: (np.dtype(">i2"), 2),   # NC_SHORT
    4: (np.dtype(">i4"), 4),   # NC_INT
    5: (np.dtype(">f4"), 4),   # NC_FLOAT
    6: (np.dtype(">f8"), 8),   # NC_DOUBLE
    7: (np.dtype(">u1"), 1),   # NC_UBYTE   (CDF-5)
    8: (np.dtype(">u2"), 2),   # NC_USHORT  (CDF-5)
    9: (np.dtype(">u4"), 4),   # NC_UINT    (CDF-5)
    10: (np.dtype(">i8"), 8),  # NC_INT64   (CDF-5)
    11: (np.dtype(">u8"), 8),  # NC_UINT64  (CDF-5)
}


@dataclass
class CDFVariable:
    name: str
    nc_type: int
    dimids: tuple[int, ...]
    shape: tuple[int, ...]
    attrs: dict
    vsize: int
    begin: int
    is_record: bool


@dataclass
class CDFDataset:
    """Parsed classic-netCDF file: dims, global attrs, lazy variable data."""

    path: str
    dims: dict[str, int] = field(default_factory=dict)
    attrs: dict = field(default_factory=dict)
    variables: dict[str, CDFVariable] = field(default_factory=dict)
    numrecs: int = 0
    _raw: bytes = b""

    def __getitem__(self, name: str) -> np.ndarray:
        v = self.variables[name]
        dt, _ = _TYPEMAP[v.nc_type]
        if not v.is_record:
            count = int(np.prod(v.shape, dtype=np.int64)) if v.shape else 1
            arr = np.frombuffer(self._raw, dtype=dt, count=count, offset=v.begin)
            out = arr.reshape(v.shape)
        else:
            # record vars interleave: rec r of var v lives at begin + r*recsize
            recsize = self._recsize
            per_rec_shape = v.shape[1:]
            count = int(np.prod(per_rec_shape, dtype=np.int64)) if per_rec_shape else 1
            recs = [
                np.frombuffer(
                    self._raw, dtype=dt, count=count, offset=v.begin + r * recsize
                ).reshape(per_rec_shape)
                for r in range(self.numrecs)
            ]
            out = np.stack(recs, axis=0) if recs else np.empty((0,) + per_rec_shape, dt)
        return np.ascontiguousarray(out.astype(dt.newbyteorder("=")))

    def keys(self):
        return self.variables.keys()

    def __contains__(self, name):
        return name in self.variables


class _Parser:
    def __init__(self, buf: bytes, version: int):
        self.buf = buf
        self.off = 4
        self.version = version
        # CDF-5 widens every NON_NEG count to int64
        self.nonneg_fmt = ">q" if version == 5 else ">i"
        self.nonneg_size = 8 if version == 5 else 4
        # OFFSET (variable begin): 4 bytes in CDF-1, 8 in CDF-2/5
        self.off_fmt = ">i" if version == 1 else ">q"
        self.off_size = 4 if version == 1 else 8

    def u32(self) -> int:
        (v,) = struct.unpack_from(">i", self.buf, self.off)
        self.off += 4
        return v

    def nonneg(self) -> int:
        (v,) = struct.unpack_from(self.nonneg_fmt, self.buf, self.off)
        self.off += self.nonneg_size
        return v

    def offset(self) -> int:
        (v,) = struct.unpack_from(self.off_fmt, self.buf, self.off)
        self.off += self.off_size
        return v

    def name(self) -> str:
        n = self.nonneg()
        s = self.buf[self.off : self.off + n].decode("utf-8")
        self.off += (n + 3) // 4 * 4  # padded to 4-byte boundary
        return s

    def tag_list(self, expected_tag: int) -> int:
        tag = self.u32()
        nelems = self.nonneg()
        if tag == 0:  # ABSENT
            return 0
        if tag != expected_tag:
            raise ValueError(f"bad tag {tag:#x}, expected {expected_tag:#x}")
        return nelems

    def att_list(self) -> dict:
        n = self.tag_list(_NC_ATTRIBUTE)
        out = {}
        for _ in range(n):
            nm = self.name()
            nc_type = self.u32()
            nelems = self.nonneg()
            dt, size = _TYPEMAP[nc_type]
            raw = self.buf[self.off : self.off + nelems * size]
            self.off += (nelems * size + 3) // 4 * 4
            if nc_type == 2:
                out[nm] = raw.decode("utf-8", errors="replace")
            else:
                vals = np.frombuffer(raw, dtype=dt, count=nelems)
                out[nm] = vals[0] if nelems == 1 else vals
        return out


def open_cdf(path: str) -> CDFDataset:
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:3] != b"CDF" or buf[3] not in (1, 2, 5):
        raise ValueError(f"{path}: not a classic netCDF file")
    version = buf[3]
    p = _Parser(buf, version)
    ds = CDFDataset(path=path)
    ds._raw = buf

    numrecs = p.nonneg()
    ds.numrecs = 0 if numrecs < 0 else numrecs  # STREAMING = -1

    ndims = p.tag_list(_NC_DIMENSION)
    dim_names, dim_lens = [], []
    for _ in range(ndims):
        nm = p.name()
        ln = p.nonneg()
        dim_names.append(nm)
        dim_lens.append(ln)
        ds.dims[nm] = ln

    ds.attrs = p.att_list()

    nvars = p.tag_list(_NC_VARIABLE)
    recsize = 0
    for _ in range(nvars):
        nm = p.name()
        nd = p.nonneg()
        dimids = tuple(p.nonneg() for _ in range(nd))
        attrs = p.att_list()
        nc_type = p.u32()
        vsize = p.nonneg()
        begin = p.offset()
        is_record = bool(dimids) and dim_lens[dimids[0]] == 0
        shape = tuple(
            (ds.numrecs if (i == 0 and is_record) else dim_lens[d])
            for i, d in enumerate(dimids)
        )
        ds.variables[nm] = CDFVariable(
            nm, nc_type, dimids, shape, attrs, vsize, begin, is_record
        )
        if is_record:
            recsize += vsize
    ds._recsize = recsize
    return ds
