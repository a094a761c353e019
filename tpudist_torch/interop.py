"""Weight bridges into the port's models.

:func:`gpt2_params_from_flax` maps a flax :class:`tpudist.models.gpt2.GPT2`
param tree (as a nested dict of numpy arrays under the flax names) onto
the state dict of :class:`tpudist_torch.models.gpt2.GPT2`, so both
packages can run the same weights. Flax ``Dense`` kernels are
``[in, out]`` and ``nn.Linear`` weights ``[out, in]``; ``DenseGeneral``
kernels flatten their grouped axes first (``qkv`` ``[d, 3, h, dh]``,
``out`` ``[h, dh, d]``).
"""

from __future__ import annotations

import numpy as np
import torch


def _linear(sd: dict, prefix: str, kernel, bias, n_in_axes: int = 1) -> None:
    k = np.asarray(kernel, np.float32)
    n_in = int(np.prod(k.shape[:n_in_axes]))
    sd[f"{prefix}.weight"] = torch.from_numpy(
        np.ascontiguousarray(k.reshape(n_in, -1).T))
    sd[f"{prefix}.bias"] = torch.from_numpy(
        np.asarray(bias, np.float32).reshape(-1).copy())


def gpt2_params_from_flax(tree) -> dict[str, torch.Tensor]:
    """flax GPT-2 params (``wte``, ``wpe``, ``h_{i}/{ln_1,qkv,out,ln_2,
    mlp_fc,mlp_proj}``, ``ln_f``; a ``{"params": ...}`` wrapper is
    accepted) -> the port's state dict, in f32 on the CPU.
    ``GPT2.load_state_dict`` casts each entry to the model's dtype and
    device."""
    p = tree["params"] if "params" in tree else tree
    sd: dict[str, torch.Tensor] = {
        "wte": torch.from_numpy(np.asarray(p["wte"], np.float32).copy()),
        "wpe": torch.from_numpy(np.asarray(p["wpe"], np.float32).copy()),
    }
    depth = sum(1 for k in p if k.startswith("h_"))
    for i in range(depth):
        src, dst = p[f"h_{i}"], f"h.{i}"
        for ln in ("ln_1", "ln_2"):
            sd[f"{dst}.{ln}.scale"] = torch.from_numpy(
                np.asarray(src[ln]["scale"], np.float32).copy())
            sd[f"{dst}.{ln}.bias"] = torch.from_numpy(
                np.asarray(src[ln]["bias"], np.float32).copy())
        _linear(sd, f"{dst}.qkv", src["qkv"]["kernel"], src["qkv"]["bias"])
        _linear(sd, f"{dst}.out", src["out"]["kernel"], src["out"]["bias"],
                n_in_axes=2)
        _linear(sd, f"{dst}.mlp_fc", src["mlp_fc"]["kernel"],
                src["mlp_fc"]["bias"])
        _linear(sd, f"{dst}.mlp_proj", src["mlp_proj"]["kernel"],
                src["mlp_proj"]["bias"])
    sd["ln_f.scale"] = torch.from_numpy(
        np.asarray(p["ln_f"]["scale"], np.float32).copy())
    sd["ln_f.bias"] = torch.from_numpy(
        np.asarray(p["ln_f"]["bias"], np.float32).copy())
    return sd

