"""Normalization statistics: loading, assembly and application (counterpart
of ``climsim_tpu/data/normalization.py``).

Stats are assembled once on the host into dense arrays matching a
:class:`~climsim_tpu_torch.variables.VariableSet` layout and held as
tensors (float32 on the CPU unless asked otherwise; ``to(device)`` moves
them): input ``(x - mean) / div`` with div = max - min, output
``y * scale``. ``reference_level_normalizer`` assembles the ClimSim norm
files exactly as the reference's hydra trainer does; the netCDF files are
read through the port's ``io`` (HDF5 files need h5py, imported only
then).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, fields

import numpy as np
import torch

from .. import variables as V
from ..io import read_netcdf

NLEV = V.NLEV


def _per_feature(stats: dict[str, np.ndarray], layout: V.FeatureLayout,
                 default: float) -> np.ndarray:
    """Flatten per-variable stats (scalar or [lev]) to a flat feature
    vector."""
    out = np.full(layout.total, default, np.float64)
    for name in layout.names:
        sl = layout.slices[name]
        if name not in stats:
            continue
        v = np.asarray(stats[name], np.float64).ravel()
        n = sl.stop - sl.start
        if v.size == 1:
            out[sl] = v[0]
        elif v.size == n:
            out[sl] = v
        else:  # per-level stat for a scalar var or vice versa: broadcast mean
            out[sl] = v.mean()
    return out


def _tensor(a, dtype, device="cpu") -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                           device=device)


class _Tensors:
    """``to(device)`` for the frozen dataclasses of tensors below."""

    def to(self, device):
        return type(self)(*(getattr(self, f.name).to(device)
                            for f in fields(self)))


@dataclass(frozen=True)
class Normalizer(_Tensors):
    """Flat-feature normalization for one variable set:
    x_norm = (x - mean) / div, y_norm = y * scale (div = max - min, with
    max == min guarded to 1)."""

    mean: torch.Tensor    # [nx]
    div: torch.Tensor     # [nx]
    scale: torch.Tensor   # [ny]

    def normalize_input(self, x):
        return (x - self.mean) / self.div

    def denormalize_input(self, x):
        return x * self.div + self.mean

    def scale_output(self, y):
        return y * self.scale

    def unscale_output(self, y):
        return y / self.scale

    @classmethod
    def from_arrays(cls, mean, maxv, minv, scale,
                    dtype=torch.float32) -> "Normalizer":
        mean = np.asarray(mean, np.float64)
        div = np.asarray(maxv, np.float64) - np.asarray(minv, np.float64)
        # zero-range guard: features with max==min carry no signal
        div = np.where(np.abs(div) < 1e-30, 1.0, div)
        return cls(_tensor(mean, dtype), _tensor(div, dtype),
                   _tensor(scale, dtype))

    @classmethod
    def from_files(cls, vset: V.VariableSet, input_mean: str, input_max: str,
                   input_min: str, output_scale: str,
                   dtype=torch.float32) -> "Normalizer":
        """Build from the reference normalization netCDF files."""
        m = read_netcdf(input_mean)
        mx = read_netcdf(input_max)
        mn = read_netcdf(input_min)
        sc = read_netcdf(output_scale)
        return cls.from_arrays(_per_feature(m, vset.inputs, 0.0),
                               _per_feature(mx, vset.inputs, 1.0),
                               _per_feature(mn, vset.inputs, 0.0),
                               _per_feature(sc, vset.outputs, 1.0),
                               dtype=dtype)

    @classmethod
    def identity(cls, vset: V.VariableSet,
                 dtype=torch.float32) -> "Normalizer":
        nx, ny = vset.input_feature_len, vset.target_feature_len
        return cls(torch.zeros(nx, dtype=dtype), torch.ones(nx, dtype=dtype),
                   torch.ones(ny, dtype=dtype))


@dataclass(frozen=True)
class LevelNormalizer(_Tensors):
    """Keeplev-layout normalization: separate (lev, sfc) coefficient
    matrices. x_lev: [..., nlev, n_lev_vars], x_sfc: [..., n_sfc_vars];
    coefficients per level ([nlev, n]) or per variable ([1, n])."""

    mean_lev: torch.Tensor   # [nlev or 1, nx_lev]
    div_lev: torch.Tensor
    mean_sfc: torch.Tensor   # [nx_sfc]
    div_sfc: torch.Tensor
    scale_lev: torch.Tensor  # [nlev or 1, ny_lev]
    scale_sfc: torch.Tensor  # [ny_sfc]

    def normalize(self, x_lev, x_sfc):
        return ((x_lev - self.mean_lev) / self.div_lev,
                (x_sfc - self.mean_sfc) / self.div_sfc)

    def denormalize(self, x_lev, x_sfc):
        return (x_lev * self.div_lev + self.mean_lev,
                x_sfc * self.div_sfc + self.mean_sfc)

    def scale_output(self, y_lev, y_sfc):
        return y_lev * self.scale_lev, y_sfc * self.scale_sfc

    def unscale_output(self, y_lev, y_sfc):
        return y_lev / self.scale_lev, y_sfc / self.scale_sfc

    @classmethod
    def from_var_stats(cls, vset: V.VariableSet, mean: dict, maxv: dict,
                       minv: dict, scale: dict, per_level: bool = True,
                       dtype=torch.float32) -> "LevelNormalizer":
        """Assemble from per-variable stat dicts (numpy scalars or [lev])."""
        inl, outl = vset.inputs, vset.outputs

        def mat(stats, names, default, rows):
            out = np.full((rows, len(names)), default, np.float64)
            for j, n in enumerate(names):
                if n not in stats:
                    continue
                v = np.asarray(stats[n], np.float64).ravel()
                out[:, j] = v if v.size == rows else v.mean()
            return out

        rows = NLEV if per_level else 1
        mean_lev = mat(mean, inl.lev_names, 0.0, rows)
        div_lev = (mat(maxv, inl.lev_names, 1.0, rows)
                   - mat(minv, inl.lev_names, 0.0, rows))
        div_lev = np.where(np.abs(div_lev) < 1e-30, 1.0, div_lev)
        mean_sfc = mat(mean, inl.sfc_names, 0.0, 1)[0]
        div_sfc = (mat(maxv, inl.sfc_names, 1.0, 1)[0]
                   - mat(minv, inl.sfc_names, 0.0, 1)[0])
        div_sfc = np.where(np.abs(div_sfc) < 1e-30, 1.0, div_sfc)
        scale_lev = mat(scale, outl.lev_names, 1.0, rows)
        scale_sfc = mat(scale, outl.sfc_names, 1.0, 1)[0]
        return cls(*(_tensor(a, dtype) for a in (
            mean_lev, div_lev, mean_sfc, div_sfc, scale_lev, scale_sfc)))

    @classmethod
    def from_files(cls, vset: V.VariableSet, input_mean: str, input_max: str,
                   input_min: str, output_scale: str, per_level: bool = True,
                   dtype=torch.float32) -> "LevelNormalizer":
        return cls.from_var_stats(
            vset, read_netcdf(input_mean), read_netcdf(input_max),
            read_netcdf(input_min), read_netcdf(output_scale),
            per_level=per_level, dtype=dtype)

    @classmethod
    def identity(cls, vset: V.VariableSet, dtype=torch.float32):
        inl, outl = vset.inputs, vset.outputs
        z = lambda *s: torch.zeros(s, dtype=dtype)
        o = lambda *s: torch.ones(s, dtype=dtype)
        return cls(z(1, inl.n_lev_vars), o(1, inl.n_lev_vars),
                   z(inl.n_sfc_vars), o(inl.n_sfc_vars),
                   o(1, outl.n_lev_vars), o(outl.n_sfc_vars))


# the ClimSim norm files' place in the ClimSim repository's tree, relative
# to the directory the caller runs from (the JAX package names an absolute
# path; cli.run_hybrid.DEFAULT_GRID does the same for the grid file)
REF_NORM_DIR = "preprocessing/normalizations"


def reference_norm_paths(input_mean=None, input_max=None, input_min=None,
                         output_scale=None) -> dict:
    """The norm-file paths :func:`reference_level_normalizer` loads
    (defaults included), to be recorded next to checkpoints: a checkpoint
    trained under one output scale decodes wrongly under another."""
    return {
        "input_mean": input_mean
        or f"{REF_NORM_DIR}/inputs/input_mean_v4_pervar.nc",
        "input_max": input_max
        or f"{REF_NORM_DIR}/inputs/input_max_v4_pervar.nc",
        "input_min": input_min
        or f"{REF_NORM_DIR}/inputs/input_min_v4_pervar.nc",
        "output_scale": output_scale
        or f"{REF_NORM_DIR}/outputs/output_scale_std_lowerthred_v5.nc",
    }


def reference_level_normalizer(vset: V.VariableSet,
                               input_mean: str | None = None,
                               input_max: str | None = None,
                               input_min: str | None = None,
                               output_scale: str | None = None,
                               snowhice_fix: bool = True,
                               remove_past_sfc: bool = False,
                               dtype=torch.float32) -> LevelNormalizer:
    """Assemble coefficients exactly as the reference's hydra trainer does
    (rnn/train_rnn_rollout_torchscript_hydra.py:323-456) from the
    per-variable norm files (input_{mean,max,min}_v4_pervar.nc,
    output_scale_std_lowerthred_v5.nc unless ``output_scale`` names
    another):

    * per-level mean and (max - min) div for every level variable, scalar
      mean/div for surface variables, y scale from the output scale file;
    * zero-division fix: zeros of a level variable's div are replaced by
      that channel's smallest positive div (CH4/N2O in the lower
      atmosphere);
    * ``snowhice_fix``: SNOWHICE gets mean 0, div 1;
    * ``remove_past_sfc``: the five tm_* previous-step surface channels
      are dropped.
    """
    paths = reference_norm_paths(input_mean, input_max, input_min,
                                 output_scale)
    mean = read_netcdf(paths["input_mean"])
    maxv = read_netcdf(paths["input_max"])
    minv = read_netcdf(paths["input_min"])
    scale = read_netcdf(paths["output_scale"])
    inl, outl = vset.inputs, vset.outputs

    def mat(stats, names, rows):
        out = np.zeros((rows, len(names)), np.float64)
        for j, n in enumerate(names):
            if n not in stats:
                raise KeyError(f"variable {n!r} missing from norm file")
            v = np.asarray(stats[n], np.float64).ravel()
            out[:, j] = v if v.size == rows else v.mean()
        return out

    mean_lev = mat(mean, inl.lev_names, NLEV)
    div_lev = mat(maxv, inl.lev_names, NLEV) - mat(minv, inl.lev_names, NLEV)
    for j in range(div_lev.shape[1]):
        col = div_lev[:, j]
        if (col == 0.0).any():
            pos = col[col > 0.0]
            col[col == 0.0] = pos.min() if pos.size else 1.0
    mean_sfc = mat(mean, inl.sfc_names, 1)[0]
    div_sfc = (mat(maxv, inl.sfc_names, 1)[0]
               - mat(minv, inl.sfc_names, 1)[0])
    div_sfc = np.where(div_sfc == 0.0, 1.0, div_sfc)
    if snowhice_fix and "cam_in_SNOWHICE" in inl.sfc_names:
        i = inl.sfc_names.index("cam_in_SNOWHICE")
        mean_sfc[i], div_sfc[i] = 0.0, 1.0
    if remove_past_sfc:
        keep = [i for i, n in enumerate(inl.sfc_names)
                if n not in ("tm_state_ps", "tm_pbuf_SOLIN",
                             "tm_pbuf_LHFLX", "tm_pbuf_SHFLX",
                             "tm_pbuf_COSZRS")]
        mean_sfc, div_sfc = mean_sfc[keep], div_sfc[keep]
    scale_lev = mat(scale, outl.lev_names, NLEV)
    scale_sfc = mat(scale, outl.sfc_names, 1)[0]
    return LevelNormalizer(*(_tensor(a, dtype) for a in (
        mean_lev, div_lev, mean_sfc, div_sfc, scale_lev, scale_sfc)))


def load_exp_lambdas(path: str) -> np.ndarray:
    """Per-level lambda of the exponential cloud transform from the
    reference's txt files (one comma-separated row; whitespace-separated
    files also accepted)."""
    with open(path) as f:
        head = f.read(4096)
    delim = "," if "," in head else None
    return np.loadtxt(path, delimiter=delim).ravel()


def save_norm_txt(normalizer: Normalizer, save_path: str = "",
                  write_input: bool = True, write_output: bool = True):
    """Export flat normalization vectors as text files (inp_sub.txt,
    inp_div.txt, out_scale.txt), the artifact the E3SM-side coupling
    consumes."""
    row = lambda t: t.detach().cpu().numpy()[None]
    if write_input:
        np.savetxt(os.path.join(save_path, "inp_sub.txt"),
                   row(normalizer.mean), fmt="%.18e", delimiter=",")
        np.savetxt(os.path.join(save_path, "inp_div.txt"),
                   row(normalizer.div), fmt="%.18e", delimiter=",")
    if write_output:
        np.savetxt(os.path.join(save_path, "out_scale.txt"),
                   row(normalizer.scale), fmt="%.18e", delimiter=",")


def fit_exp_lambdas(q: np.ndarray, threshold: float = 1e-7,
                    fill: float = 1e7) -> np.ndarray:
    """Per-level exponential cloud-transform coefficients from data:
    lambda_l = 1 / mean(q_l | q_l > threshold), ``fill`` where a level
    has no cloud above threshold. q: [..., nlev] raw condensate."""
    nlev = q.shape[-1]
    flat = np.asarray(q).reshape(-1, nlev)
    lbd = np.full(nlev, np.nan)
    for i in range(nlev):
        col = flat[:, i]
        sel = col[col > threshold]
        if sel.size:
            lbd[i] = 1.0 / sel.mean()
    lbd[~np.isfinite(lbd)] = fill
    return lbd


def save_exp_lambdas(lbd: np.ndarray, path: str) -> None:
    """Write lambdas in the reference txt layout (one comma-separated row,
    read by :func:`load_exp_lambdas`)."""
    np.savetxt(path, np.asarray(lbd).reshape(1, -1), fmt="%e",
               delimiter=",")
