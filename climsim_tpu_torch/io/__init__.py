"""netCDF readers (counterpart of ``climsim_tpu/io``): numpy only."""
from .cdf5 import open_cdf, CDFDataset
from .ncio import read_netcdf

__all__ = ["open_cdf", "CDFDataset", "read_netcdf"]
