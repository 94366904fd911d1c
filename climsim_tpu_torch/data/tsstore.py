"""TensorStore-backed sharded array store (the zarr format).

The ingestion target SURVEY.md §7.1 calls for ("sharded array store
(zarr/TensorStore)"): chunked, concurrently-readable keeplev arrays suited
to multi-host streaming of the 41 TB high-res set — the role the
reference's monolithic h5 files can't fill at scale. Chunks default to
whole-timestep rows (ncol x nlev x nvar) so readers fetch contiguous
time ranges with one request each.

Same logical schema as h5store: input_lev/input_sca/output_lev/output_sca.
Counterpart of ``climsim_tpu/data/tsstore.py``, host numpy copied as it
is; ``tensorstore`` is imported only when a store is created or opened.
"""
from __future__ import annotations

import json
import os

import numpy as np

_KEYS = ("input_lev", "input_sca", "output_lev", "output_sca")


def _spec(root: str, name: str, shape=None, chunks=None, create=False):
    spec = {
        "driver": "zarr",
        "kvstore": {"driver": "file", "path": os.path.join(root, name)},
    }
    if create:
        spec["metadata"] = {"dtype": "<f4", "shape": list(shape),
                            "chunks": list(chunks)}
        spec["create"] = True
        spec["delete_existing"] = True
    return spec


class TsKeeplevStore:
    """Sharded keeplev store; rows = flattened (time, col) samples."""

    def __init__(self, root: str):
        self.root = root

    # -------------------------------------------------------------- write

    def create(self, n_rows: int, shapes: dict, varnames: dict | None = None,
               rows_per_chunk: int = 384):
        """shapes: key -> trailing shape (e.g. input_lev: (60, nx))."""
        import tensorstore as ts

        os.makedirs(self.root, exist_ok=True)
        self._arrays = {}
        for k in _KEYS:
            if k not in shapes:
                continue
            full = (n_rows,) + tuple(shapes[k])
            chunks = (rows_per_chunk,) + tuple(shapes[k])
            self._arrays[k] = ts.open(
                _spec(self.root, k, full, chunks, create=True)).result()
        with open(os.path.join(self.root, "meta.json"), "w") as f:
            json.dump({"n_rows": n_rows,
                       "varnames": varnames or {}}, f)
        return self

    def write_rows(self, start: int, **arrays):
        futures = []
        for k, a in arrays.items():
            a = np.asarray(a, np.float32)
            a[~np.isfinite(a)] = 0.0
            futures.append(self._arrays[k][start:start + len(a)].write(a))
        for fut in futures:
            fut.result()

    # -------------------------------------------------------------- read

    def open(self):
        import tensorstore as ts

        with open(os.path.join(self.root, "meta.json")) as f:
            self.meta = json.load(f)
        self._arrays = {k: ts.open(_spec(self.root, k)).result()
                        for k in _KEYS
                        if os.path.isdir(os.path.join(self.root, k))}
        self.n = self.meta["n_rows"]
        self.varnames = self.meta.get("varnames", {})
        return self

    def read_rows(self, start: int, stop: int) -> dict:
        """Concurrent reads across the four arrays."""
        futures = {k: a[start:stop].read() for k, a in self._arrays.items()}
        return {k: np.asarray(f.result()) for k, f in futures.items()}

    def iter_chunks(self, rows: int):
        for s in range(0, self.n, rows):
            yield self.read_rows(s, min(s + rows, self.n))


def from_h5(h5_path: str, root: str, rows_per_chunk: int = 384):
    """Convert a keeplev H5 file to the sharded store."""
    from .h5store import KeeplevReader

    r = KeeplevReader(h5_path)
    d = r.load_all()
    store = TsKeeplevStore(root).create(
        r.n, {k: v.shape[1:] for k, v in d.items()}, r.varnames,
        rows_per_chunk)
    store.write_rows(0, **d)
    return store
