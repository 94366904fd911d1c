"""Grid metadata and hybrid sigma-pressure ops on tensors.

Counterpart of ``climsim_tpu/grid.py``. Pressure contract:

    p_int[l] = P0*hyai[l] + hybi[l]*ps        (nlev+1 interfaces)
    dp[l]    = p_int[l+1] - p_int[l]          (nlev layers)
    p_mid[l] = P0*hyam[l] + hybm[l]*ps        (nlev mid levels)

``Grid.from_file`` reads the ClimSim grid file (classic CDF-5 or HDF5)
through the port's own ``io.read_netcdf``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import constants as C
from .io import read_netcdf


@dataclass(frozen=True)
class Grid:
    """Static grid info as tensors on one device."""

    lat: torch.Tensor       # [ncol] degrees
    lon: torch.Tensor       # [ncol] degrees
    area: torch.Tensor      # [ncol]
    area_wgt: torch.Tensor  # [ncol] area / mean(area)
    hyai: torch.Tensor      # [nlev+1]
    hybi: torch.Tensor      # [nlev+1]
    hyam: torch.Tensor      # [nlev]
    hybm: torch.Tensor      # [nlev]
    p0: float = C.P0

    @property
    def ncol(self) -> int:
        return self.lat.shape[0]

    @property
    def nlev(self) -> int:
        return self.hyam.shape[0]

    @classmethod
    def from_file(cls, path: str, dtype: torch.dtype = torch.float32,
                  device=None) -> "Grid":
        """The grid of a netCDF grid file (lat, lon, area, hyai, hybi,
        hyam, hybm and, if present, P0) as ``climsim_tpu.grid.Grid.
        from_file`` reads it: area_wgt = area / mean(area) in float64,
        then every array in ``dtype``. ``device=None`` means ``"cuda"``
        and raises without a CUDA device."""
        from .ops import resolve_device
        dev = resolve_device(device)
        raw = read_netcdf(path)
        area = np.asarray(raw["area"], np.float64)
        p0 = float(np.asarray(raw["P0"]).ravel()[0]) if "P0" in raw \
            else C.P0
        t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
        return cls(lat=t(raw["lat"]), lon=t(raw["lon"]), area=t(area),
                   area_wgt=t(area / area.mean()), hyai=t(raw["hyai"]),
                   hybi=t(raw["hybi"]), hyam=t(raw["hyam"]),
                   hybm=t(raw["hybm"]), p0=p0)

    @classmethod
    def synthetic(cls, ncol: int = C.NCOL_LOWRES, nlev: int = C.NLEV,
                  dtype: torch.dtype = torch.float32,
                  device: str | torch.device = "cpu") -> "Grid":
        """Deterministic stand-in grid, the same numbers as
        ``climsim_tpu.grid.Grid.synthetic``: hybrid coefficients go from
        pure pressure aloft to terrain-following at the surface."""
        lat = np.linspace(-88.0, 88.0, ncol)
        lon = np.linspace(0.0, 360.0, ncol, endpoint=False)
        area = 0.02 + 0.015 * np.cos(np.deg2rad(lat))
        s = np.linspace(0.0, 1.0, nlev + 1) ** 1.4
        hyai = np.maximum.accumulate(np.where(s < 0.5, s * 0.1,
                                              (1 - s) * 0.1))
        hyai = np.concatenate([[5e-5], np.maximum(hyai[1:], 5e-5)])
        hybi = np.clip((s - 0.3) / 0.7, 0.0, 1.0) ** 1.2
        hyam = 0.5 * (hyai[1:] + hyai[:-1])
        hybm = 0.5 * (hybi[1:] + hybi[:-1])
        t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype,
                                      device=device)
        return cls(lat=t(lat), lon=t(lon), area=t(area),
                   area_wgt=t(area / area.mean()), hyai=t(hyai),
                   hybi=t(hybi), hyam=t(hyam), hybm=t(hybm))

    # ---- pressure ops (ps [...] -> [..., nlev(+1)]) ----

    def interface_pressure(self, ps: torch.Tensor) -> torch.Tensor:
        """p at the interfaces: P0*hyai + hybi*ps."""
        return self.p0 * self.hyai + self.hybi * ps[..., None]

    def mid_pressure(self, ps: torch.Tensor) -> torch.Tensor:
        """p at the layer midpoints: P0*hyam + hybm*ps."""
        return self.p0 * self.hyam + self.hybm * ps[..., None]

    def layer_thickness(self, ps: torch.Tensor) -> torch.Tensor:
        """dp[l] = p_int[l+1] - p_int[l] (positive, increases downward)."""
        pint = self.interface_pressure(ps)
        return pint[..., 1:] - pint[..., :-1]

    def mass_weights(self, ps: torch.Tensor) -> torch.Tensor:
        """dp/g, the per-layer air-mass column weighting [kg m-2]."""
        return self.layer_thickness(ps) / C.GRAV
