"""The slice's constant tables, carried from the JAX package as tensors.

The PSK receive paths learn nothing: their parameters are the projection
templates and the magic patterns. The port builds its own tables
(``ops.psk``) with the JAX package's formulas; this module turns the JAX
package's numpy arrays into the port's tensors, so a comparison can feed
both implementations the very same tables.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..utils.torchenv import DeviceLike, resolve_device

# Table name (the JAX package's builder) -> number of dimensions.
TABLE_NDIM = {
    "_blocked_templates": 3,  # (n_offsets, ROW+OV, 256)
    "_offset_templates": 2,  # (2*spsym, 2*n_offsets)
    "_offset_grams": 2,  # (n_offsets, 3)
    "_shifted_pack_weights_qpsk": 4,  # (4 tables: wa, wb, waw, wbw, 8 shifts, 128, 32)
}


def tables_from_reference(
    arrays: Dict[str, np.ndarray], device: DeviceLike = None
) -> Dict[str, torch.Tensor]:
    """float32 tensors on ``device`` from the JAX package's numpy tables,
    keyed like :data:`TABLE_NDIM`. ``_shifted_pack_weights_qpsk`` may be the
    JAX builder's 4-tuple; it is stacked into one array."""
    dev = resolve_device(device)
    out = {}
    for name, a in arrays.items():
        if name not in TABLE_NDIM:
            raise KeyError(f"unknown table {name!r}; expected one of {sorted(TABLE_NDIM)}")
        a = np.stack(a) if isinstance(a, (tuple, list)) else np.asarray(a)
        if a.dtype != np.float32 or a.ndim != TABLE_NDIM[name]:
            raise ValueError(f"{name}: {a.dtype} {a.shape}")
        out[name] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return out
