"""Unified reader for the two netCDF flavors in the ClimSim data tree.

Counterpart of ``climsim_tpu/io/ncio.py``:

* classic CDF-1/2/5 (e.g. ``grid_info/ClimSim_low-res_grid-info.nc``) via the
  pure-Python parser in :mod:`climsim_tpu_torch.io.cdf5`;
* netCDF4/HDF5 (the normalization files under ``preprocessing/normalizations``)
  via h5py, imported only when such a file is read.

Returns a plain ``dict[str, np.ndarray]``; callers move what they need to
a device themselves (``Grid.from_file``).
"""
from __future__ import annotations

import numpy as np

from .cdf5 import open_cdf


def read_netcdf(path: str) -> dict[str, np.ndarray]:
    """Read every variable of a netCDF file into a dict of numpy arrays."""
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic[:3] == b"CDF":
        ds = open_cdf(path)
        return {k: ds[k] for k in ds.keys()}
    if magic[:4] == b"\x89HDF":
        import h5py

        out: dict[str, np.ndarray] = {}
        with h5py.File(path, "r") as f:
            def visit(name, obj):
                if isinstance(obj, h5py.Dataset):
                    out[name] = np.asarray(obj[()])
            f.visititems(visit)
        return out
    raise ValueError(f"{path}: unrecognized netCDF container")
