"""Keeplev <-> flat layout conversion (counterpart of the part of
``climsim_tpu/data/ingest.py`` that the training CLI's ``pred_export``
uses; the rest of ingest waits, ROADMAP A.14)."""
from __future__ import annotations

import numpy as np


def keeplev_to_flat(x_lev, x_sfc, layout):
    """Keeplev arrays ([N, L, n_lev_vars] in lev_names order + [N, n_sfc])
    -> the flat registry-ordered vector [N, feature_len] in float32."""
    lev_names = list(layout.lev_names)
    sfc_names = list(layout.sfc_names)
    parts = []
    for n in layout.names:
        if n in lev_names:
            parts.append(np.asarray(x_lev[..., lev_names.index(n)]))
        else:
            parts.append(np.asarray(x_sfc[..., sfc_names.index(n)])[:, None])
    return np.concatenate(parts, axis=1).astype(np.float32)
