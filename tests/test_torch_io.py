"""The port's netCDF readers and ``Grid.from_file`` against the JAX
package's on the same fabricated files, on the CPU: CDF-1 and CDF-2
written by ``scipy.io.netcdf_file``, CDF-5 (the ClimSim grid file's
container, which scipy cannot write) by ``struct`` after the classic
format's spec, and HDF5 by ``h5py``. Readers must agree exactly: the same
keys, dtypes and values."""
import struct

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from climsim_tpu.grid import Grid as JaxGrid
from climsim_tpu.io import open_cdf as jopen_cdf
from climsim_tpu.io import read_netcdf as jread
from climsim_tpu_torch import Grid
from climsim_tpu_torch.io import open_cdf, read_netcdf

NCOL, NLEV = 24, 8


def _variables(seed=0):
    """Named arrays of the classic types scipy writes (byte, short, int,
    float, double), one of them a record variable (leading axis 3)."""
    rng = np.random.default_rng(seed)
    return {
        "lat": ("ncol", rng.uniform(-90, 90, NCOL).astype(np.float32)),
        "area": ("ncol", rng.uniform(0.01, 0.03, NCOL)),
        "hyam": ("lev", rng.uniform(0, 0.1, NLEV)),
        "flag": ("lev", rng.integers(-100, 100, NLEV).astype(np.int8)),
        "count": (("lev", "ncol"), rng.integers(-3e4, 3e4, (NLEV, NCOL))
                  .astype(np.int16)),
        "index": ("ncol", rng.integers(-2**31, 2**31 - 1, NCOL)
                  .astype(np.int32)),
        "T": (("time", "ncol"), rng.normal(250, 20, (3, NCOL))
              .astype(np.float32)),
    }


def _write_scipy(path, version, variables, scalars=()):
    """A CDF-1 (version 1) or CDF-2 (version 2) file with attributes."""
    with netcdf_file(path, "w", version=version) as f:
        f.history = "fabricated for a test"
        f.createDimension("time", None)
        f.createDimension("ncol", NCOL)
        f.createDimension("lev", NLEV)
        f.createDimension("ilev", NLEV + 1)
        for name, (dims, arr) in variables.items():
            dims = (dims,) if isinstance(dims, str) else dims
            v = f.createVariable(name, arr.dtype.char, dims)
            v.units = "1"
            v[:] = arr
        for name, value in scalars:
            f.createVariable(name, "d", ())[...] = value


# ---------------------------------------------------------------- CDF-5

# nc_type -> big-endian dtype (the classic format and its CDF-5 additions)
_NC = {1: ">i1", 2: "S1", 3: ">i2", 4: ">i4", 5: ">f4", 6: ">f8", 7: ">u1",
       8: ">u2", 9: ">u4", 10: ">i8", 11: ">u8"}


def _pad(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 4)


def _name(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">q", len(b)) + _pad(b)


def _atts(atts: dict) -> bytes:
    if not atts:
        return struct.pack(">iq", 0, 0)
    out = struct.pack(">iq", 0x0C, len(atts))
    for name, (nc_type, values) in atts.items():
        if nc_type == 2:
            raw, n = values.encode(), len(values)
        else:
            arr = np.asarray(values, _NC[nc_type]).ravel()
            raw, n = arr.tobytes(), arr.size
        out += _name(name) + struct.pack(">iq", nc_type, n) + _pad(raw)
    return out


def _write_cdf5(path, dims, gatts, variables, numrecs):
    """A CDF-5 file after the classic format's spec: ``dims`` [(name,
    length)] (length 0: the record dimension), ``variables`` [(name,
    dimids, nc_type, array, atts)], counts and offsets 64-bit; fixed
    variables contiguous from their ``begin``, record variables
    interleaved record by record."""
    def vsize(dimids, nc_type):
        shape = [d for i, d in enumerate(dimids) if dims[d][1] or i]
        n = int(np.prod([dims[d][1] for d in shape])) if shape else 1
        return (n * np.dtype(_NC[nc_type]).itemsize + 3) // 4 * 4

    def header(begins):
        out = b"CDF\x05" + struct.pack(">q", numrecs)
        out += struct.pack(">iq", 0x0A, len(dims))
        for name, length in dims:
            out += _name(name) + struct.pack(">q", length)
        out += _atts(gatts) + struct.pack(">iq", 0x0B, len(variables))
        for (name, dimids, nc_type, _, atts), begin in zip(variables,
                                                           begins):
            out += _name(name) + struct.pack(">q", len(dimids))
            out += struct.pack(f">{len(dimids)}q", *dimids) + _atts(atts)
            out += struct.pack(">iqq", nc_type, vsize(dimids, nc_type),
                               begin)
        return out

    is_rec = [bool(d) and dims[d[0]][1] == 0 for _, d, _, _, _ in variables]
    off = len(header([0] * len(variables)))
    begins = [0] * len(variables)
    for i, (_, dimids, nc_type, _, _) in enumerate(variables):
        if not is_rec[i]:
            begins[i], off = off, off + vsize(dimids, nc_type)
    for i, (_, dimids, nc_type, _, _) in enumerate(variables):
        if is_rec[i]:
            begins[i], off = off, off + vsize(dimids, nc_type)
    body = b"".join(_pad(np.asarray(a, _NC[t]).tobytes())
                    for (_, _, t, a, _), r in zip(variables, is_rec)
                    if not r)
    for rec in range(numrecs):
        body += b"".join(_pad(np.asarray(a[rec], _NC[t]).tobytes())
                         for (_, _, t, a, _), r in zip(variables, is_rec)
                         if r)
    with open(path, "wb") as f:
        f.write(header(begins) + body)


def _cdf5_case(path):
    rng = np.random.default_rng(5)
    dims = [("time", 0), ("ncol", NCOL), ("lev", NLEV)]
    variables = [
        ("lat", (1,), 6, rng.uniform(-90, 90, NCOL),
         {"units": (2, "degrees_north")}),
        ("area", (1,), 5, rng.uniform(0.01, 0.03, NCOL), {}),
        ("hyam", (2,), 6, rng.uniform(0, 0.1, NLEV),
         {"scale": (6, [1.0, 2.0])}),
        ("ids", (1,), 10, rng.integers(-2**62, 2**62, NCOL), {}),
        ("big", (2,), 11, rng.integers(0, 2**63, NLEV, dtype=np.uint64),
         {}),
        ("mask", (2, 1), 7, rng.integers(0, 255, (NLEV, NCOL)), {}),
        ("odd", (2,), 8, rng.integers(0, 65535, NLEV - 1).tolist()
         + [7], {}),
        ("u32", (1,), 9, rng.integers(0, 2**32 - 1, NCOL), {}),
        ("P0", (), 6, np.float64(1.0e5), {}),
        ("T", (0, 1), 5, rng.normal(250, 20, (3, NCOL)), {}),
        ("ps", (0, 1), 6, rng.normal(1e5, 500, (3, NCOL)), {}),
    ]
    _write_cdf5(path, dims, {"title": (2, "fabricated"),
                             "version": (4, [5])}, variables, 3)


# -------------------------------------------------------------- readers


def _assert_same(got: dict, want: dict):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("version", [1, 2])
def test_read_netcdf_classic_matches_jax(tmp_path, version):
    """CDF-1 and CDF-2 from scipy: every variable, the record variable
    included, and the dimensions and attributes open_cdf parses."""
    path = str(tmp_path / f"cdf{version}.nc")
    _write_scipy(path, version, _variables(version), [("P0", 1.0e5)])
    got = read_netcdf(path)
    assert got["T"].shape == (3, NCOL)
    _assert_same(got, jread(path))
    tds, jds = open_cdf(path), jopen_cdf(path)
    assert tds.dims == jds.dims and tds.numrecs == jds.numrecs == 3
    assert tds.attrs == jds.attrs


def test_read_netcdf_cdf5_matches_jax(tmp_path):
    """CDF-5 with the types it adds (ubyte, ushort, uint, int64, uint64),
    64-bit counts and offsets, attributes and two record variables."""
    path = str(tmp_path / "cdf5.nc")
    _cdf5_case(path)
    got = read_netcdf(path)
    assert got["ids"].dtype == np.int64 and got["ps"].shape == (3, NCOL)
    assert got["mask"].dtype == np.uint8 and got["odd"][-1] == 7
    _assert_same(got, jread(path))
    tds, jds = open_cdf(path), jopen_cdf(path)
    assert tds.dims == jds.dims and tds.numrecs == jds.numrecs == 3
    assert set(tds.attrs) == set(jds.attrs) == {"title", "version"}
    assert tds.attrs["title"] == jds.attrs["title"] == "fabricated"
    assert tds.attrs["version"] == jds.attrs["version"] == 5
    np.testing.assert_array_equal(tds.variables["hyam"].attrs["scale"],
                                  [1.0, 2.0])


def test_read_netcdf_hdf5_matches_jax(tmp_path):
    """HDF5 (netCDF-4): datasets at the root and in a group, scalars."""
    path = str(tmp_path / "norm.nc")
    rng = np.random.default_rng(9)
    with h5py.File(path, "w") as f:
        f["state_t"] = rng.normal(250, 20, NLEV).astype(np.float32)
        f["state_ps"] = np.float64(1.0e5)
        f["icol"] = np.arange(NCOL, dtype=np.int64)
        f.create_group("grp")["w"] = rng.normal(size=(NLEV, 3))
    got = read_netcdf(path)
    assert set(got) == {"state_t", "state_ps", "icol", "grp/w"}
    _assert_same(got, jread(path))


def test_read_netcdf_refuses_other_files(tmp_path):
    path = tmp_path / "x.nc"
    path.write_bytes(b"NOTCDF00")
    for reader in (read_netcdf, jread):
        with pytest.raises(ValueError, match="unrecognized"):
            reader(str(path))
    path.write_bytes(b"CDF\x03" + b"\0" * 16)
    with pytest.raises(ValueError, match="classic"):
        open_cdf(str(path))


# ------------------------------------------------------------ the grid


def _grid_file(path, fmt, with_p0):
    """A grid file of Grid.synthetic's arrays in container ``fmt``, lat
    and lon stored as float32 as in the ClimSim file, P0 = 101325 Pa (not
    the default 1e5) where present."""
    g = Grid.synthetic(NCOL, NLEV, dtype=torch.float64)
    arrays = {k: getattr(g, k).numpy() for k in ("lat", "lon", "area",
                                                 "hyai", "hybi", "hyam",
                                                 "hybm")}
    arrays["lat"] = arrays["lat"].astype(np.float32)
    arrays["lon"] = arrays["lon"].astype(np.float32)
    dims = {"lat": "ncol", "lon": "ncol", "area": "ncol", "hyai": "ilev",
            "hybi": "ilev", "hyam": "lev", "hybm": "lev"}
    if fmt == "cdf1":
        _write_scipy(path, 1, {k: (dims[k], a) for k, a in arrays.items()},
                     [("P0", 101325.0)] if with_p0 else [])
    elif fmt == "cdf5":
        order = ["time", "ncol", "lev", "ilev"]
        variables = [(k, (order.index(dims[k]),),
                      5 if a.dtype == np.float32 else 6, a, {})
                     for k, a in arrays.items()]
        if with_p0:
            variables.append(("P0", (), 6, np.float64(101325.0), {}))
        _write_cdf5(path, [("time", 0), ("ncol", NCOL), ("lev", NLEV),
                           ("ilev", NLEV + 1)], {}, variables, 0)
    else:
        with h5py.File(path, "w") as f:
            for k, a in arrays.items():
                f[k] = a
            if with_p0:
                f["P0"] = np.float64(101325.0)


@pytest.mark.parametrize("with_p0", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("fmt", ["cdf1", "cdf5", "hdf5"])
def test_grid_from_file_matches_jax(tmp_path, fmt, dtype, with_p0):
    """Grid.from_file against JAX's on the same file, exactly: every array
    in the dtype asked for (area_wgt formed in float64 first), P0 from
    the file or the default, and the pressure ops on top."""
    path = str(tmp_path / "grid.nc")
    _grid_file(path, fmt, with_p0)
    tg = Grid.from_file(path, dtype=getattr(torch, dtype), device="cpu")
    jg = JaxGrid.from_file(path, dtype=getattr(jnp, dtype))
    assert tg.p0 == jg.p0 == (101325.0 if with_p0 else 1.0e5)
    assert tg.ncol == NCOL and tg.nlev == NLEV
    for k in ("lat", "lon", "area", "area_wgt", "hyai", "hybi", "hyam",
              "hybm"):
        want = np.asarray(getattr(jg, k))
        got = getattr(tg, k).numpy()
        assert got.dtype == want.dtype == np.dtype(dtype), k
        np.testing.assert_array_equal(got, want, err_msg=k)
    ps = np.random.default_rng(2).normal(1e5, 500, NCOL).astype(dtype)
    np.testing.assert_allclose(
        tg.mass_weights(torch.as_tensor(ps)).numpy(),
        np.asarray(jg.mass_weights(jnp.asarray(ps))), rtol=1e-6)


def test_grid_from_file_defaults_to_the_card(tmp_path):
    """device=None means the card: without one it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = str(tmp_path / "grid.nc")
    _grid_file(path, "cdf1", True)
    with pytest.raises(RuntimeError, match="CUDA"):
        Grid.from_file(path)
