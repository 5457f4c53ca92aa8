"""Carry the reference's flax parameters of a loss into the port's
modules.

The reference's ``LossModule.init_params`` returns a pytree such as SAC's
``{"actor": {"m0": {"Dense_0": {"kernel", "bias"}, ...}, "m1": {}},
"qvalue": {"MLP_0": {"Dense_0": ...}}, "target_qvalue": ..., "log_alpha"}``
with ensembles stacked on a leading axis of n. :func:`flax_paths` maps
each parameter of the port's loss to its place in that tree; flax's
``[in, out]`` kernels are ``[out, in]`` here (``[n, in, out]`` stacked,
``[n, out, in]`` here).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .networks import MLP, ConcatMLP, Ensemble
from .tdmodule import ProbabilisticActor, TDModule, TDSequential

__all__ = ["flax_paths", "params_from_flax"]


def _mlp_paths(mlp: MLP, prefix: str, path: tuple) -> dict:
    out = {}
    for j in range(len(mlp.layers)):
        out[f"{prefix}layers.{j}.weight"] = (path + (f"Dense_{j}", "kernel"), True)
        out[f"{prefix}layers.{j}.bias"] = (path + (f"Dense_{j}", "bias"), False)
    return out


def _module_paths(module: nn.Module, prefix: str, path: tuple) -> dict:
    if isinstance(module, ProbabilisticActor):
        return _module_paths(module.inner, prefix + "inner.", path)
    if isinstance(module, TDSequential):
        out = {}
        for i, m in enumerate(module.tdmodules):
            out.update(_module_paths(m, f"{prefix}tdmodules.{i}.", path + (f"m{i}",)))
        return out
    if isinstance(module, TDModule):
        return _module_paths(module.module, prefix + "module.", path)
    if isinstance(module, ConcatMLP):
        return _mlp_paths(module.mlp, prefix + "mlp.", path + ("MLP_0",))
    if isinstance(module, MLP):
        return _mlp_paths(module, prefix, path)
    if isinstance(module, Ensemble):
        path = path + (("MLP_0",) if module.from_concat else ())
        out = {}
        for j in range(len(module.weights)):
            out[f"{prefix}weights.{j}"] = (path + (f"Dense_{j}", "kernel"), True)
            out[f"{prefix}biases.{j}"] = (path + (f"Dense_{j}", "bias"), False)
        return out
    if not any(True for _ in module.parameters()):
        return {}
    raise TypeError(f"no flax layout known for {type(module).__name__}")


def flax_paths(loss: nn.Module) -> dict[str, tuple[tuple, bool]]:
    """``{name in loss.state_dict(): (path in the flax tree, transposed)}``
    for every parameter and target of ``loss``'s direct children (a
    ``nn.Parameter`` child maps to its own name)."""
    out = {}
    for name, child in loss.named_children():
        out.update(_module_paths(child, name + ".", (name,)))
    for name, _ in loss.named_parameters(recurse=False):
        out[name] = ((name,), False)
    return out


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree, dtype=np.float32)


def to_port_layout(x: np.ndarray, transposed: bool) -> torch.Tensor:
    """A flax array in the port's layout (kernels' last two axes swapped)."""
    t = torch.from_numpy(np.array(x, dtype=np.float32))
    return t.transpose(-1, -2).contiguous() if transposed else t


@torch.no_grad()
def params_from_flax(loss: nn.Module, params) -> nn.Module:
    """Copy the reference's ``init_params`` tree (nested mappings of
    arrays, anything ``numpy.asarray`` reads) into the built ``loss``, in
    place; every parameter and target must be found. Returns ``loss``."""
    sd = loss.state_dict()
    paths = flax_paths(loss)
    missing = set(sd) - set(paths)
    if missing:
        raise KeyError(f"no flax path for {sorted(missing)}")
    for name, (path, transposed) in paths.items():
        src = to_port_layout(_get(params, path), transposed)
        if src.shape != sd[name].shape:
            raise ValueError(f"{name}: flax {'/'.join(path)} has shape {tuple(src.shape)}, "
                             f"the port {tuple(sd[name].shape)}")
        sd[name].copy_(src)
    return loss
