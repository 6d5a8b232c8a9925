"""Weights carried between the reference and the port.

``params_from_reference`` takes the reference's params (``repro.models.
lm.init_params``' tree, as a nested dict of numpy arrays; bfloat16 leaves
passed as float32, which holds every bfloat16 value exactly) and returns
the port's tensors; ``params_to_numpy`` is the inverse.  The expected
keys, shapes and dtypes are those of ``lm.init_params`` on the meta
device, and any difference raises.
"""

from __future__ import annotations

import numpy as np
import torch

from . import lm


def params_from_reference(tree, cfg, *, device) -> dict:
    """The reference's ``tree`` as the port's params on ``device``, each
    leaf in the dtype ``init_params`` gives it (``cfg.dtype``, float32
    for the router and the SSM's A_log, D and dt_bias).  Raises
    ValueError on a missing or extra key or a wrong shape."""
    dev = lm._device(device)
    want, _ = lm.init_params(cfg, device="meta")

    def walk(got, exp, path):
        if isinstance(exp, dict):
            if not isinstance(got, dict) or set(got) != set(exp):
                have = sorted(got) if isinstance(got, dict) else type(got)
                raise ValueError(f"params{path}: keys {have}, expected "
                                 f"{sorted(exp)}")
            return {k: walk(got[k], exp[k], f"{path}[{k!r}]") for k in exp}
        arr = np.asarray(got)
        if arr.shape != tuple(exp.shape):
            raise ValueError(f"params{path}: shape {arr.shape}, expected "
                             f"{tuple(exp.shape)}")
        return torch.from_numpy(np.array(arr)).to(device=dev,
                                                  dtype=exp.dtype)
    return walk(tree, want, "")


def params_to_numpy(params) -> dict:
    """The port's params as a nested dict of float32 numpy arrays."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return params.detach().float().cpu().numpy()
