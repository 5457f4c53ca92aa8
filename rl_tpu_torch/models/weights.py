"""Load the reference's flax parameters into :class:`TransformerLM`."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_flax"]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def params_from_flax(params, cfg) -> dict[str, torch.Tensor]:
    """A ``state_dict`` for :class:`TransformerLM` from the flax param
    tree of :class:`rl_tpu.models.TransformerLM`, given as nested mappings
    of arrays (anything ``numpy.array`` reads): ``wte/embedding``,
    ``wpe/embedding``, ``h{i}/ln1``, ``h{i}/attn/qkv`` (or ``wq`` and
    ``wkv`` with GQA), ``h{i}/attn/proj``, ``h{i}/ln2``, ``h{i}/up``,
    ``h{i}/down``, ``ln_f``. Dense kernels are ``[in, out]`` in flax and
    are transposed to ``nn.Linear``'s ``[out, in]``; LayerNorm
    ``scale``/``bias`` become ``weight``/``bias``. Tensors are float32 on
    the CPU; ``load_state_dict`` casts them to the model's dtype."""
    sd = {
        "wte.weight": _t(params["wte"]["embedding"]),
        "wpe.weight": _t(params["wpe"]["embedding"]),
    }

    def ln(name, p):
        sd[f"{name}.weight"] = _t(p["scale"])
        sd[f"{name}.bias"] = _t(p["bias"])

    def dense(name, p):
        sd[f"{name}.weight"] = _t(p["kernel"]).T.contiguous()
        if "bias" in p:
            sd[f"{name}.bias"] = _t(p["bias"])

    for i in range(cfg.n_layers):
        p = params[f"h{i}"]
        pre = f"h.{i}"
        ln(f"{pre}.ln1", p["ln1"])
        attn = p["attn"]
        if cfg.kv_heads == cfg.n_heads:
            dense(f"{pre}.attn.qkv", attn["qkv"])
        else:
            dense(f"{pre}.attn.wq", attn["wq"])
            dense(f"{pre}.attn.wkv", attn["wkv"])
        dense(f"{pre}.attn.proj", attn["proj"])
        ln(f"{pre}.ln2", p["ln2"])
        dense(f"{pre}.up", p["up"])
        dense(f"{pre}.down", p["down"])
    ln("ln_f", params["ln_f"])
    return sd
