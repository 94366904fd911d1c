"""Kaggle/LEAP-competition helper: subset index lists + text norm vectors.

Equivalent of the reference's ``for_kaggle_users.py:1-188``: builds the v2
sub/div/scale text files and the feature-index bookkeeping for the Kaggle
LEAP subset (which drops some variables from the 557/368 v2 contract).
Counterpart of ``climsim_tpu/data/kaggle.py``.
"""
from __future__ import annotations

import os

import numpy as np

from .. import variables as V
from .normalization import Normalizer


# Kaggle subset drops these v2 inputs (mostly redundant surface fields)
KAGGLE_DROPPED_INPUTS: tuple = ("cam_in_SNOWHICE",)
# and zero-weights these output blocks in scoring
KAGGLE_ZEROED_OUTPUTS: tuple = ("ptend_q0002",)


def kaggle_index_lists(vset_name: str = "v2"):
    """Return (kept_input_idx, dropped_input_idx, zeroed_output_idx) flat
    index arrays for the Kaggle subset of a variable set."""
    vs = V.get(vset_name)
    dropped = []
    for name in KAGGLE_DROPPED_INPUTS:
        if name in vs.inputs.slices:
            sl = vs.inputs.slices[name]
            dropped.extend(range(sl.start, sl.stop))
    kept = [i for i in range(vs.input_feature_len) if i not in set(dropped)]
    zeroed = []
    for name in KAGGLE_ZEROED_OUTPUTS:
        if name in vs.outputs.slices:
            sl = vs.outputs.slices[name]
            zeroed.extend(range(sl.start, sl.stop))
    return (np.asarray(kept, np.int64), np.asarray(dropped, np.int64),
            np.asarray(zeroed, np.int64))


def export_kaggle_files(normalizer: Normalizer, save_path: str,
                        vset_name: str = "v2"):
    """Write the sub/div/scale text vectors + index lists the competition
    harness consumes (for_kaggle_users.py output contract)."""
    os.makedirs(save_path, exist_ok=True)
    kept, dropped, zeroed = kaggle_index_lists(vset_name)
    # the vectors may lie on the card: one copy each to the host
    host = {k: getattr(normalizer, k).detach().cpu().numpy()
            for k in ("mean", "div", "scale")}
    for name, k in (("inp_sub.txt", "mean"), ("inp_div.txt", "div"),
                    ("out_scale.txt", "scale")):
        np.savetxt(os.path.join(save_path, name), host[k][None],
                   fmt="%.18e", delimiter=",")
    np.savetxt(os.path.join(save_path, "input_kept_idx.txt"), kept[None],
               fmt="%d", delimiter=",")
    np.savetxt(os.path.join(save_path, "output_zeroed_idx.txt"),
               zeroed[None], fmt="%d", delimiter=",")
    return {"kept": len(kept), "dropped": len(dropped),
            "zeroed": len(zeroed)}
