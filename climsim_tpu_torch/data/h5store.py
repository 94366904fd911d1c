"""Keeplev H5 store: the training-data format of the rnn/ stack
(counterpart of ``climsim_tpu/data/h5store.py``).

Resizable float32 datasets ``input_lev [N, nlev, nx]``, ``input_sca
[N, nx_sfc]``, ``output_lev [N, nlev, ny]``, ``output_sca [N, ny_sfc]``
with a ``varnames`` attribute per dataset, lzf compression, NaN/Inf
scrubbed to 0; ``concatenate`` joins shard files. The reader gives numpy
arrays, whole (``load_all``) or by row range (``load_slice``).

``h5py`` is imported only when a store is opened, so the rest of the port
(and the training CLI on synthetic data) runs without it.
"""
from __future__ import annotations

import numpy as np

_KEYS = ("input_lev", "input_sca", "output_lev", "output_sca")


def _h5py():
    import h5py
    return h5py


class KeeplevWriter:
    def __init__(self, path: str, varnames: dict[str, list[str]] | None = None,
                 compression: str = "lzf"):
        self.path = path
        self.varnames = varnames or {}
        self.compression = compression
        self._file = None

    def __enter__(self):
        self._file = _h5py().File(self.path, "w")
        return self

    def __exit__(self, *exc):
        self._file.close()

    def append(self, input_lev, input_sca, output_lev, output_sca):
        # copies: the scrub below must not write into the caller's arrays
        arrays = {k: np.array(a, np.float32) for k, a in
                  zip(_KEYS, (input_lev, input_sca, output_lev, output_sca))}
        for k, a in arrays.items():
            a[~np.isfinite(a)] = 0.0
            if k not in self._file:
                d = self._file.create_dataset(
                    k, a.shape, maxshape=(None,) + a.shape[1:],
                    compression=self.compression, dtype="float32")
                d[:] = a
                if k in self.varnames:
                    d.attrs["varnames"] = self.varnames[k]
            else:
                d = self._file[k]
                n0 = d.shape[0]
                d.resize(n0 + a.shape[0], axis=0)
                d[n0:] = a


class KeeplevReader:
    def __init__(self, path: str):
        self.path = path
        with _h5py().File(path, "r") as f:
            self.shapes = {k: f[k].shape for k in _KEYS if k in f}
            self.varnames = {k: [v.decode() if isinstance(v, bytes) else v
                                 for v in f[k].attrs.get("varnames", [])]
                             for k in _KEYS if k in f}
        self.n = self.shapes["input_lev"][0]

    def load_all(self) -> dict[str, np.ndarray]:
        """The whole store in host memory."""
        with _h5py().File(self.path, "r") as f:
            return {k: np.asarray(f[k]) for k in _KEYS if k in f}

    def load_slice(self, start: int, stop: int) -> dict[str, np.ndarray]:
        with _h5py().File(self.path, "r") as f:
            return {k: np.asarray(f[k][start:stop]) for k in _KEYS if k in f}

    def iter_chunks(self, chunk_rows: int):
        for s in range(0, self.n, chunk_rows):
            yield self.load_slice(s, min(s + chunk_rows, self.n))


def concatenate(paths: list[str], out_path: str, compression: str = "lzf"):
    """Concatenate shard files into one store."""
    first = KeeplevReader(paths[0])
    with KeeplevWriter(out_path, varnames=first.varnames,
                       compression=compression) as w:
        for p in paths:
            r = KeeplevReader(p)
            for chunk in r.iter_chunks(16384):
                w.append(*[chunk[k] for k in _KEYS])


def write_timeseries(path: str, x_lev, x_sfc, y_lev, y_sfc,
                     varnames: dict | None = None):
    """Write time-major arrays [T, B, ...] (numpy arrays or tensors)
    flattened to the [T*B, ...] row convention (each step's columns
    contiguous). Returns T."""
    T = x_lev.shape[0]

    def flat(a):
        a = a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)
        return a.reshape((-1,) + a.shape[2:])
    with KeeplevWriter(path, varnames=varnames) as w:
        w.append(flat(x_lev), flat(x_sfc), flat(y_lev), flat(y_sfc))
    return T
