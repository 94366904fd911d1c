"""Raw netCDF -> keeplev ingestion: the L2 preprocessing pipeline
(counterpart of ``climsim_tpu/data/ingest.py``).

Equivalent of the reference's canonical preprocessing sequence
(preprocessing/create_npy_data_new.py + data_utils.save_as_h5_keeplev_new,
SURVEY.md §3.1): for each mli/mlo file pair, read the input variables
(deriving state_rh / state_qn / liq_partition / icol when absent,
data_utils.get_xrdata:654-711), build tendency targets
(get_target:720-747), optionally normalize, and append to the keeplev H5
store; ``save_as_npy`` exports a split in the flat contract.

Files are read with the port's ``io.read_netcdf`` (classic CDF, and
HDF5 netCDF4 where h5py is installed). Variables are expected as [ncol]
or [ncol, nlev] (or transposed [nlev, ncol], auto-detected). The relative
humidity, the liquid fraction and the normalizer run as tensor
operations on ``device`` (``None`` means the card); everything returned
is numpy on the host. The keeplev H5 (``ingest``) and ``save_h5`` need
h5py.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from .. import constants as C
from .. import variables as V
from ..io import read_netcdf
from ..ops import resolve_device
from ..physics import thermo
from .h5store import KeeplevReader, KeeplevWriter


def _shape_fix(a: np.ndarray, ncol: int, nlev: int) -> np.ndarray:
    a = np.asarray(a)
    a = a.squeeze()
    if a.ndim == 2 and a.shape == (nlev, ncol):
        a = a.T
    return a


def derive_missing(data: dict, vset: V.VariableSet, grid,
                   ncol: int, nlev: int, device=None) -> dict:
    """Derived inputs when absent from file (data_utils.get_xrdata).

    state_rh comes from the blended-saturation qsat at the mid-level
    pressure, which is computed in float64 from state_ps
    (``grid.mid_pressure``), as JAX computes it with x64 enabled; it and
    liq_partition are computed on ``device`` in the inputs' dtype."""
    out = dict(data)
    names = set(vset.inputs.names)
    need_rh = "state_rh" in names and "state_rh" not in out
    need_liq = "liq_partition" in names and "liq_partition" not in out
    if need_rh or need_liq:
        dev = resolve_device(device)
        # numpy arrays from the files, or the pressure already on a device
        t = lambda a: torch.as_tensor(a, device=dev)
    if need_rh:
        pmid = out.get("state_pmid")
        if pmid is None:
            ps = torch.as_tensor(np.asarray(out["state_ps"], np.float64),
                                 device=grid.hyam.device)
            pmid = grid.mid_pressure(ps)
        # the reference uses the omega-blended eliq/eice qsat here
        out["state_rh"] = thermo.specific_to_relative_humidity(
            t(out["state_q0001"]), t(out["state_t"]), t(pmid)).cpu().numpy()
    if "state_qn" in names and "state_qn" not in out:
        out["state_qn"] = out["state_q0002"] + out["state_q0003"]
    if need_liq:
        out["liq_partition"] = thermo.liquid_fraction(
            t(out["state_t"])).cpu().numpy()
    if "icol" in names and "icol" not in out:
        out["icol"] = np.arange(1, ncol + 1, dtype=np.float64)
    for nm in ("state_qn_prvphy", "tm_state_qn_prvphy"):
        base = nm.replace("qn", "q0002"), nm.replace("qn", "q0003")
        if nm in names and nm not in out and all(b in out for b in base):
            out[nm] = out[base[0]] + out[base[1]]
    # cos/sin latitude from the grid file (the reference adds these from
    # grid info, not the mli archive: climsim_adding_input.py)
    for nm, fn in (("clat", np.cos), ("slat", np.sin)):
        if nm in names and nm not in out:
            out[nm] = fn(np.deg2rad(grid.lat.detach().cpu().numpy()[:ncol]))
    return out


def build_targets(mli: dict, mlo: dict, vset: V.VariableSet) -> dict:
    """Tendencies (mlo-mli)/1200 + passthrough surface outputs
    (data_utils.get_target)."""
    t: dict = {}
    dt = C.DT_STEP
    t["ptend_t"] = (mlo["state_t"] - mli["state_t"]) / dt
    t["ptend_q0001"] = (mlo["state_q0001"] - mli["state_q0001"]) / dt
    if vset.full_vars:
        t["ptend_q0002"] = (mlo["state_q0002"] - mli["state_q0002"]) / dt
        t["ptend_q0003"] = (mlo["state_q0003"] - mli["state_q0003"]) / dt
        t["ptend_u"] = (mlo["state_u"] - mli["state_u"]) / dt
        t["ptend_v"] = (mlo["state_v"] - mli["state_v"]) / dt
    elif vset.full_vars_v5:
        t["ptend_qn"] = ((mlo["state_q0002"] - mli["state_q0002"])
                         + (mlo["state_q0003"] - mli["state_q0003"])) / dt
        t["ptend_u"] = (mlo["state_u"] - mli["state_u"]) / dt
        t["ptend_v"] = (mlo["state_v"] - mli["state_v"]) / dt
    for name in vset.outputs.sfc_names:
        t[name] = mlo[name]
    return t


def pack_pair(mli_path: str, mlo_path: str, vset: V.VariableSet, grid,
              normalizer=None, device=None):
    """One file pair -> keeplev 4-tuple (numpy float32 arrays [ncol, ...]).
    ``normalizer`` is a :class:`LevelNormalizer`, applied on ``device``."""
    mli_raw = read_netcdf(mli_path)
    mlo_raw = read_netcdf(mlo_path)
    ncol, nlev = grid.ncol, grid.nlev
    mli = {k: _shape_fix(v, ncol, nlev) for k, v in mli_raw.items()}
    mlo = {k: _shape_fix(v, ncol, nlev) for k, v in mlo_raw.items()}
    mli = derive_missing(mli, vset, grid, ncol, nlev, device)
    tgt = build_targets(mli, mlo, vset)

    def stack(names, src):
        return np.stack([np.broadcast_to(np.asarray(src[n], np.float32),
                                         (ncol, nlev) if V.var_len(n) == nlev
                                         else (ncol,))
                         for n in names], axis=-1)

    x_lev = stack(vset.inputs.lev_names, mli)
    x_sfc = stack(vset.inputs.sfc_names, mli)
    y_lev = stack(vset.outputs.lev_names, tgt)
    y_sfc = stack(vset.outputs.sfc_names, tgt)
    if normalizer is not None:
        dev = resolve_device(device)
        nz = normalizer.to(dev)
        t = lambda a: torch.as_tensor(a, device=dev)
        xl, xs = nz.normalize(t(x_lev), t(x_sfc))
        yl, ys = nz.scale_output(t(y_lev), t(y_sfc))
        x_lev, x_sfc, y_lev, y_sfc = (a.cpu().numpy()
                                      for a in (xl, xs, yl, ys))
    return x_lev, x_sfc, y_lev, y_sfc


def keeplev_to_flat(x_lev, x_sfc, layout):
    """Keeplev arrays ([N, L, n_lev_vars] in lev_names order + [N, n_sfc])
    -> the flat registry-ordered vector [N, feature_len] in float32
    (data_utils.py:1202-1293 flattened-generator contract)."""
    lev_names = list(layout.lev_names)
    sfc_names = list(layout.sfc_names)
    parts = []
    for n in layout.names:
        if n in lev_names:
            parts.append(np.asarray(x_lev[..., lev_names.index(n)]))
        else:
            parts.append(np.asarray(x_sfc[..., sfc_names.index(n)])[:, None])
    return np.concatenate(parts, axis=1).astype(np.float32)


def save_as_npy(source, vset: V.VariableSet, save_path: str,
                data_split: str = "train", save_npy: bool = True,
                save_h5: bool = False, grid=None,
                save_latlontime: bool = False, dates=None) -> tuple:
    """Export a split as ``{split}_input.npy`` / ``{split}_target.npy``
    (+ optional .h5 twins and the index->(lat,lon,date) pickle): the
    reference's ``save_as_npy`` (climsim_utils/data_utils.py:1295-1355).

    ``source``: a keeplev H5 path, a KeeplevReader, or a 4-tuple of
    keeplev arrays. NaN/Inf are scrubbed to 0 as the reference does."""
    if isinstance(source, str):
        source = KeeplevReader(source)
    if hasattr(source, "load_all"):
        d = source.load_all()
        arrs = (d["input_lev"], d["input_sca"],
                d["output_lev"], d["output_sca"])
    else:
        arrs = source
    x = keeplev_to_flat(arrs[0], arrs[1], vset.inputs)
    y = keeplev_to_flat(arrs[2], arrs[3], vset.outputs)
    x[~np.isfinite(x)] = 0.0
    y[~np.isfinite(y)] = 0.0

    os.makedirs(save_path, exist_ok=True)
    paths = []
    for tag, a in (("input", x), ("target", y)):
        if save_npy:
            p = os.path.join(save_path, f"{data_split}_{tag}.npy")
            np.save(p, a)
            paths.append(p)
        if save_h5:
            import h5py
            p = os.path.join(save_path, f"{data_split}_{tag}.h5")
            with h5py.File(p, "w") as hdf:
                hdf.create_dataset("data", data=a, dtype=a.dtype)
            paths.append(p)
    if save_latlontime and grid is not None:
        ncol = grid.ncol
        # one copy each to the host: the grid may lie on the card
        lat = grid.lat.detach().cpu().numpy()
        lon = grid.lon.detach().cpu().numpy()
        dates = list(dates or [])
        latlontime = {
            i: [(float(lat[i % ncol]), float(lon[i % ncol])),
                dates[i // ncol] if i // ncol < len(dates) else None]
            for i in range(x.shape[0])}
        p = os.path.join(save_path, f"{data_split}_indextolatlontime.pkl")
        with open(p, "wb") as f:
            pickle.dump(latlontime, f)
        paths.append(p)
    return tuple(paths)


def ingest(filelists, vset: V.VariableSet, grid, out_path: str,
           split: str = "train", normalizer=None,
           progress: bool = False, device=None) -> int:
    """Run the full pipeline over a split's file list into a keeplev H5.
    Returns rows written."""
    files = filelists.get_filelist(split)
    varnames = {"input_lev": list(vset.inputs.lev_names),
                "input_sca": list(vset.inputs.sfc_names),
                "output_lev": list(vset.outputs.lev_names),
                "output_sca": list(vset.outputs.sfc_names)}
    n = 0
    with KeeplevWriter(out_path, varnames=varnames) as w:
        for i, f in enumerate(files):
            pair = pack_pair(f, filelists.output_path(f), vset, grid,
                             normalizer, device)
            w.append(*pair)
            n += pair[0].shape[0]
            if progress and i % 50 == 0:
                print(f"[ingest] {i + 1}/{len(files)} files, {n} rows")
    return n
