"""Conversion of the JAX chain's parameters into the port's tensors.

The JAX package builds its chain constants as host numpy arrays; this
module moves them onto a torch device unchanged, so that both packages
can be held to the same numbers.
"""
from __future__ import annotations

import numpy as np
import torch

# Parameter name -> number of planes kept (None: a single array; 0: all
# planes, as many as the JAX package made).
# ``_inner_consts`` of the JAX kernel also carries the lane DFT-128 planes
# its MXU finish used; the CUDA kernel computes that DFT with butterflies,
# so only the inner twiddle (Wr, Wi) is kept.
_KEYS = {"taps": None, "window": None, "_dif_planes": 4,
         "_dif_twiddle_factored": 4, "_inner_consts": 2, "_dft_planes": 3,
         "polyphase_taps": None, "_rowblock_matrices": 0, "prototype": None,
         "taps_merged": None}
# Complex taps are what the overlap-save path's own tests convolve with;
# the resampler's constants are float64 where lin/hermite build them so.
_DTYPES = {"taps": (np.float32, np.complex64),
           "polyphase_taps": (np.float32, np.float64),
           "_rowblock_matrices": (np.float32, np.float64)}


def _tensor(a, device, dtypes=(np.float32,)) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype not in dtypes:
        raise TypeError(f"expected {' or '.join(map(str, dtypes))} arrays, "
                        f"got {a.dtype}")
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def from_numpy(params: dict, device) -> dict:
    """Maps ``{"taps": ..., "window": ..., "_dif_planes": (4 planes),
    "_dif_twiddle_factored": (4), "_inner_consts": (5), "_dft_planes":
    (3), "polyphase_taps": (P, 2L+1), "_rowblock_matrices": [(Q, P),
    ...], "prototype": (t*C,), "taps_merged": (t+1, C)}`` of float32
    numpy arrays (any subset of these keys; taps may also be complex64,
    the resampler's two constants float64) to the same keys holding
    tensors of the same dtype on ``device``: a tensor for taps, window,
    polyphase_taps, the channelizer's prototype and its merged tap matrix
    (``parallel.channelizer._merged_tap_rows``), a tuple of plane tensors
    for each constant family."""
    out = {}
    for key, value in params.items():
        if key not in _KEYS:
            raise KeyError(f"unknown parameter {key!r}; expected one of "
                           f"{sorted(_KEYS)}")
        keep = _KEYS[key]
        if keep is None:
            out[key] = _tensor(value, device, _DTYPES.get(key, (np.float32,)))
        else:
            if len(value) < keep:
                raise ValueError(f"{key}: expected at least {keep} planes")
            dtypes = _DTYPES.get(key, (np.float32,))
            out[key] = tuple(_tensor(p, device, dtypes)
                             for p in value[:keep or len(value)])
    return out
