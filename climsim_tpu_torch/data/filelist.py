"""Split/file-list management for the raw netCDF dataset (counterpart of
``climsim_tpu/data/filelist.py``; pure Python, copied as it is).

Equivalent of the reference's regexp-driven split machinery
(climsim_utils/data_utils.py:749-857 set_regexps / set_stride_sample /
set_filelist / get_filelist): glob file lists per split with stride
subsampling. Default strides match the official protocol
(preprocessing/README.md): 7 for train/val, 6 for the scoring split.

File naming convention: E3SM-MMF.{mli,mlo}.YYYY-MM-DD-SSSSS.nc
(website/dataset.md).
"""
from __future__ import annotations

import glob
import os
import re
from dataclasses import dataclass, field

DEFAULT_STRIDES = {"train": 7, "val": 7, "scoring": 6, "test": 1}
SPLITS = ("train", "val", "scoring", "test")


@dataclass
class FileLists:
    data_path: str
    input_abbrev: str = "mli"
    output_abbrev: str = "mlo"
    regexps: dict = field(default_factory=dict)
    strides: dict = field(default_factory=lambda: dict(DEFAULT_STRIDES))
    _lists: dict = field(default_factory=dict)

    def set_regexps(self, split: str, regexps: list[str]):
        assert split in SPLITS, f"invalid split {split}"
        self.regexps[split] = list(regexps)
        self._lists.pop(split, None)

    def set_stride_sample(self, split: str, stride: int):
        assert split in SPLITS
        self.strides[split] = stride
        self._lists.pop(split, None)

    def set_filelist(self, split: str):
        """Resolve globs, sort, apply stride (data_utils.py:777-838)."""
        assert split in self.regexps, f"no regexps set for {split}"
        files: list[str] = []
        for rx in self.regexps[split]:
            files.extend(glob.glob(os.path.join(self.data_path, rx)))
        files = sorted(set(files))
        stride = self.strides.get(split, 1)
        self._lists[split] = files[::stride]
        return self._lists[split]

    def get_filelist(self, split: str) -> list[str]:
        if split not in self._lists:
            self.set_filelist(split)
        return self._lists[split]

    def output_path(self, input_path: str) -> str:
        """mli -> mlo pair (data_utils.get_target:729)."""
        return input_path.replace(f".{self.input_abbrev}.",
                                  f".{self.output_abbrev}.")


def official_split_regexps(years_train=(1, 8), month_stride: int = 1):
    """The official year-based split patterns (train years 1-7 + Jan of
    year 8, val/scoring from years 8-9 — preprocessing/README.md)."""
    train = [f"*/E3SM-MMF.mli.000{y}-*.nc"
             for y in range(years_train[0], years_train[1])]
    train += ["*/E3SM-MMF.mli.0008-01-*.nc"]
    val = [f"*/E3SM-MMF.mli.0008-{m:02d}-*.nc" for m in range(2, 13)]
    val += ["*/E3SM-MMF.mli.0009-01-*.nc"]
    scoring = val
    return {"train": train, "val": val, "scoring": scoring}
