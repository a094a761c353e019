"""Weight bridges into the port's models.

:func:`resnet_params_from_flax` maps a flax
:class:`tpudist.models.resnet.ResNet`'s params and batch_stats onto the
state dict of :class:`tpudist_torch.models.resnet.ResNet`: conv kernels
``[kh, kw, in, out]`` become ``[out, in, kh, kw]``, the head's ``Dense``
``[in, out]`` becomes ``[out, in]``, and BatchNorm ``scale``/``bias`` and
running ``mean``/``var`` carry over.

:func:`gpt2_params_from_flax` maps a flax :class:`tpudist.models.gpt2.GPT2`
param tree (as a nested dict of numpy arrays under the flax names) onto
the state dict of :class:`tpudist_torch.models.gpt2.GPT2`, so both
packages can run the same weights. Flax ``Dense`` kernels are
``[in, out]`` and the port's weights ``[out, in]``; ``DenseGeneral``
kernels flatten their grouped axes first (``qkv`` ``[d, 3, h, dh]``,
``out`` ``[h, dh, d]``), and biases keep their shapes (``qkv``'s
``[3, h, dh]``).

:func:`vit_params_from_flax` maps a flax :class:`tpudist.models.vit.ViT`
param tree onto the state dict of :class:`tpudist_torch.models.vit.ViT`
the same way: the patch ``Conv`` kernel ``[p, p, 3, d]`` becomes
``[d, 3, p, p]``, ``Dense`` kernels ``[out, in]``, biases and ``cls`` /
``pos_embedding`` keep their shapes.
"""

from __future__ import annotations

import numpy as np
import torch


def _linear(sd: dict, prefix: str, kernel, bias, n_in_axes: int = 1) -> None:
    k = np.asarray(kernel, np.float32)
    n_in = int(np.prod(k.shape[:n_in_axes]))
    sd[f"{prefix}.weight"] = torch.from_numpy(
        np.ascontiguousarray(k.reshape(n_in, -1).T))
    # the bias keeps the reference's shape (qkv: [3, heads, dh])
    sd[f"{prefix}.bias"] = torch.from_numpy(
        np.array(bias, np.float32))


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


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def resnet_params_from_flax(params, batch_stats) -> dict[str, torch.Tensor]:
    """flax ResNet ``params`` and ``batch_stats`` (nested dicts of numpy
    arrays; ``{"params": ...}``/``{"batch_stats": ...}`` wrappers
    accepted) -> the port's state dict, in float32 on the CPU. Block
    ``{ResNetBlock,BottleneckBlock}_{k}`` becomes ``blocks.{k}``, its
    ``Conv_{j}``/``BatchNorm_{j}`` become ``conv{j}``/``bn{j}``, and
    ``Dense_0`` becomes ``head``."""
    p = params.get("params", params)
    stats = batch_stats.get("batch_stats", batch_stats)
    sd: dict[str, torch.Tensor] = {}

    def conv(dst, src):
        sd[f"{dst}.weight"] = _f32(np.transpose(src["kernel"], (3, 2, 0, 1)))

    def norm(dst, src, st):
        for name in ("scale", "bias"):
            sd[f"{dst}.{name}"] = _f32(src[name])
        for name in ("mean", "var"):
            sd[f"{dst}.{name}"] = _f32(st[name])

    for name, sub in p.items():
        if name in ("conv_init", "conv_init_s2d"):
            conv(name, sub)
        elif name == "bn_init":
            norm(name, sub, stats[name])
        elif name == "Dense_0":
            sd["head.weight"] = _f32(np.asarray(sub["kernel"]).T)
            sd["head.bias"] = _f32(sub["bias"])
        else:
            block = f"blocks.{int(name.rsplit('_', 1)[1])}"
            for inner, leaf in sub.items():
                kind, _, j = inner.rpartition("_")
                if inner == "conv_proj" or kind == "Conv":
                    conv(f"{block}.{'conv' + j if kind == 'Conv' else inner}",
                         leaf)
                else:
                    dst = "bn" + j if kind == "BatchNorm" else inner
                    norm(f"{block}.{dst}", leaf, stats[name][inner])
    return sd



def vit_params_from_flax(tree) -> dict[str, torch.Tensor]:
    """flax ViT params (``embedding``, ``cls``, ``pos_embedding``,
    ``block_{i}/{LayerNorm_0,qkv,out,LayerNorm_1,MlpBlock_0/{Dense_0,
    Dense_1}}``, ``LayerNorm_0``, ``head``; a ``{"params": ...}`` wrapper
    is accepted) -> the port's state dict, in f32 on the CPU. Block
    ``block_{i}`` becomes ``blocks.{i}``, its norms ``ln_0``/``ln_1``, its
    MLP's ``Dense_0``/``Dense_1`` ``mlp.fc``/``mlp.proj``; the final
    ``LayerNorm_0`` becomes ``norm``."""
    p = tree["params"] if "params" in tree else tree
    sd: dict[str, torch.Tensor] = {
        "embedding.weight": _f32(np.transpose(p["embedding"]["kernel"],
                                              (3, 2, 0, 1))),
        "embedding.bias": _f32(p["embedding"]["bias"]),
        "cls": _f32(p["cls"]),
        "pos_embedding": _f32(p["pos_embedding"]),
    }

    def norm(dst, src):
        sd[f"{dst}.scale"] = _f32(src["scale"])
        sd[f"{dst}.bias"] = _f32(src["bias"])

    depth = sum(1 for k in p if k.startswith("block_"))
    for i in range(depth):
        src, dst = p[f"block_{i}"], f"blocks.{i}"
        norm(f"{dst}.ln_0", src["LayerNorm_0"])
        norm(f"{dst}.ln_1", src["LayerNorm_1"])
        _linear(sd, f"{dst}.qkv", src["qkv"]["kernel"], src["qkv"]["bias"])
        _linear(sd, f"{dst}.out", src["out"]["kernel"], src["out"]["bias"],
                n_in_axes=2)
        mlp = src["MlpBlock_0"]
        _linear(sd, f"{dst}.mlp.fc", mlp["Dense_0"]["kernel"],
                mlp["Dense_0"]["bias"])
        _linear(sd, f"{dst}.mlp.proj", mlp["Dense_1"]["kernel"],
                mlp["Dense_1"]["bias"])
    norm("norm", p["LayerNorm_0"])
    _linear(sd, "head", p["head"]["kernel"], p["head"]["bias"])
    return sd
