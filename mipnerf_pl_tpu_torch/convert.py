"""Parameters between the JAX package's flax tree and this port.

The JAX MipNerf keeps its MLP under {'params': {'mlp': {name: {'kernel':
[in, out], 'bias': [out]}}}} (a flax Dense layout); the port's MipNerf state
dict holds `mlp.<name>.weight` [out, in] and `mlp.<name>.bias` [out] for
the same layer names.  Both directions work on numpy arrays (or anything
np.asarray takes), so neither side needs the other's framework.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def jax_params_to_torch(params: Dict[str, Any], device=None
                        ) -> Dict[str, torch.Tensor]:
    """Flax param tree (numpy leaves) -> the port's MipNerf state dict."""
    mlp = params['params']['mlp']
    out = {}
    for name, leaf in mlp.items():
        kernel = np.asarray(leaf['kernel'], np.float32)
        bias = np.asarray(leaf['bias'], np.float32)
        out[f'mlp.{name}.weight'] = torch.tensor(kernel.T.copy(),
                                                 device=device)
        out[f'mlp.{name}.bias'] = torch.tensor(bias, device=device)
    return out


def torch_params_to_jax(state_dict: Dict[str, torch.Tensor]
                        ) -> Dict[str, Any]:
    """The port's MipNerf state dict -> flax param tree with numpy leaves."""
    mlp: Dict[str, Dict[str, np.ndarray]] = {}
    for key, value in state_dict.items():
        prefix, name, kind = key.split('.')
        if prefix != 'mlp' or kind not in ('weight', 'bias'):
            raise KeyError(f'unexpected parameter {key!r}')
        arr = value.detach().to('cpu', torch.float32).numpy()
        if kind == 'weight':
            mlp.setdefault(name, {})['kernel'] = arr.T.copy()
        else:
            mlp.setdefault(name, {})['bias'] = arr.copy()
    return {'params': {'mlp': mlp}}
