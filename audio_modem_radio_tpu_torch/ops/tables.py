"""The slice's constant tables, carried from the JAX package as tensors.

The receive paths learn nothing at run time: their parameters are the
projection templates, the FIR front end, the discriminator's equalizer, the
magic patterns and NEURAL's committed codebook with the tables derived
from it. The port builds its own tables (``ops.psk``, ``ops.fsk``,
``ops.neural``) with the JAX package's formulas; this module turns the JAX
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
    "_fsk_blocked_templates": 3,  # (n_offsets, row+ov, 4*spr)
    "_fir_padded_template": 2,  # (c_pad, 256)
    "_fsk_boxcar_templates_geom": 3,  # (n_offsets, row2+ov2, spr2)
    "_fsk_quadrature_templates_geom": 3,  # (n_offsets, row2+ov2, 4*spr2)
    "_discriminator_calibration": 1,  # (_EQ_TAPS + 1,): equalizer taps, then the bias
    "_codebook": 2,  # (256, 16): the NEURAL codebook
    "_corr_table": 2,  # (128+P, 256): the NEURAL preamble correlation weights
    "_codebook_blocked": 2,  # (256//chip_len, spr*256): the block-diagonal scorer
    "_energy_table": 2,  # (128+P, 128): banded ones, the window energies
}


def tables_from_reference(
    arrays: Dict[str, np.ndarray], device: DeviceLike = None
) -> Dict[str, torch.Tensor]:
    """float32 tensors on ``device`` (the card unless the caller names the
    CPU) from the JAX package's numpy tables, keyed like :data:`TABLE_NDIM`. ``_shifted_pack_weights_qpsk`` may be the
    JAX builder's 4-tuple; it is stacked into one array."""
    unknown = sorted(set(arrays) - set(TABLE_NDIM))
    if unknown:
        raise KeyError(f"unknown table {unknown[0]!r}; expected one of {sorted(TABLE_NDIM)}")
    dev = resolve_device(device)
    out = {}
    for name, a in arrays.items():
        a = np.stack(a) if isinstance(a, (tuple, list)) else np.asarray(a)
        if a.dtype != np.float32 or a.ndim != TABLE_NDIM[name]:
            raise ValueError(f"{name}: {a.dtype} {a.shape}")
        out[name] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return out
