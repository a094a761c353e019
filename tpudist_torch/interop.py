"""Weight bridges into the port's models.

:func:`resnet_params_from_flax` maps a flax
:class:`tpudist.models.resnet.ResNet`'s params and batch_stats onto the
state dict of :class:`tpudist_torch.models.resnet.ResNet`: conv kernels
``[kh, kw, in, out]`` become ``[out, in, kh, kw]``, the head's ``Dense``
``[in, out]`` becomes ``[out, in]``, and BatchNorm ``scale``/``bias`` and
running ``mean``/``var`` carry over.

:func:`gpt2_params_from_flax` maps a flax :class:`tpudist.models.gpt2.GPT2`
param tree (as a nested dict of numpy arrays under the flax names; the
unrolled ``h_{i}`` layout or the ``scan_layers`` one, stacked under
``hs``) onto the state dict of :class:`tpudist_torch.models.gpt2.GPT2`, so
both packages can run the same weights. Flax ``Dense`` kernels are
``[in, out]`` and the port's weights ``[out, in]``; ``DenseGeneral``
kernels flatten their grouped axes first (``qkv`` ``[d, 3, h, dh]``,
``out`` ``[h, dh, d]``), and biases keep their shapes (``qkv``'s
``[3, h, dh]``).

:func:`llama_params_from_flax` maps a flax :class:`tpudist.models.llama.Llama`
param tree (unrolled ``layer_{i}``, or stacked under ``layers``) onto the
state dict of :class:`tpudist_torch.models.llama.Llama`: the bias-free
kernels ``[in, out...]`` (``q_proj``/``k_proj``/``v_proj`` ``[d, heads,
dh]``, ``o_proj`` ``[h, dh, d]``) become ``[out, in]`` weights, the
RMSNorm ``scale`` s, ``embed`` and ``lm_head`` carry over.

:func:`vit_params_from_flax` maps a flax :class:`tpudist.models.vit.ViT`
param tree onto the state dict of :class:`tpudist_torch.models.vit.ViT`
the same way: the patch ``Conv`` kernel ``[p, p, 3, d]`` becomes
``[d, 3, p, p]``, ``Dense`` kernels ``[out, in]``, biases and ``cls`` /
``pos_embedding`` keep their shapes.

:func:`bert_params_from_flax` and :func:`t5_params_from_flax` map the
encoder families' flax trees the same way (BERT unrolled or stacked under
``hs``; T5 has no scanned layout).

The HF bridge (:func:`load_hf_params`, :func:`save_hf_checkpoint` and the
per-family maps between them) is the reference's, onto the port's state
dict: HF's GPT-2 ``Conv1D`` weights are ``[in, out]`` with q|k|v packed
along the output, so each becomes a port weight by one transpose; HF's
Llama, BERT and T5 ``Linear`` weights are ``[out, in]``, the port's
layout, so they carry over as they are (BERT's separate query/key/value
stacked into ``qkv``). Checkpoints are
read and written with a small ``safetensors`` codec of the port's own
(:func:`read_safetensors`, :func:`write_safetensors`; the machine with the
card has no ``safetensors`` package), or ``pytorch_model*.bin`` through
``torch.load(weights_only=True)``. Nothing is downloaded.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch


def _kernel(kernel, n_in_axes: int = 1) -> torch.Tensor:
    """A flax kernel ``[in..., out...]`` as a port weight ``[out, in]``."""
    k = np.asarray(kernel, np.float32)
    n_in = int(np.prod(k.shape[:n_in_axes]))
    return torch.from_numpy(np.ascontiguousarray(k.reshape(n_in, -1).T))


def _linear(sd: dict, prefix: str, kernel, bias, n_in_axes: int = 1) -> None:
    sd[f"{prefix}.weight"] = _kernel(kernel, n_in_axes)
    # the bias keeps the reference's shape (qkv: [3, heads, dh])
    sd[f"{prefix}.bias"] = torch.from_numpy(
        np.array(bias, np.float32))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def unstack_layers(params: dict, *, prefix: str, dest: str) -> dict:
    """The ``scan_layers`` layout (``{dest}/block/...`` with a leading depth
    axis) -> the unrolled ``{prefix}{i}/...`` one: the port's copy of
    ``tpudist.models.lm_utils.unstack_layers`` on unboxed numpy trees."""
    block = params[dest]["block"]
    leaf = block
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    out = {k: v for k, v in params.items() if k != dest}
    for i in range(np.shape(leaf)[0]):
        out[f"{prefix}{i}"] = _tree_map(lambda a: np.asarray(a)[i], block)
    return out


def gpt2_params_from_flax(tree) -> dict[str, torch.Tensor]:
    """flax GPT-2 params (``wte``, ``wpe``, ``h_{i}/{ln_1,qkv,out,ln_2,
    mlp_fc,mlp_proj}`` or their ``scan_layers`` stack ``hs/block/...``,
    ``ln_f``; a ``{"params": ...}`` wrapper is accepted) -> the port's
    state dict, in f32 on the CPU. ``GPT2.load_state_dict`` casts each
    entry to the model's dtype and device."""
    p = tree["params"] if "params" in tree else tree
    if "hs" in p:
        p = unstack_layers(p, prefix="h_", dest="hs")
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



#: a Llama block's bias-free linears and how many leading kernel axes
#: each contracts (o_proj's DenseGeneral: heads and dh)
_LLAMA_LINEARS = (("q_proj", 1), ("k_proj", 1), ("v_proj", 1), ("o_proj", 2),
                  ("gate_proj", 1), ("up_proj", 1), ("down_proj", 1))


def llama_params_from_flax(tree) -> dict[str, torch.Tensor]:
    """flax Llama params (``embed``, ``layer_{i}/{attn_norm, q_proj, ...,
    down_proj}`` or their ``scan_layers`` stack ``layers/block/...``,
    ``norm``, and ``lm_head`` when untied; a ``{"params": ...}`` wrapper is
    accepted) -> the port's state dict, in f32 on the CPU."""
    p = tree["params"] if "params" in tree else tree
    if "layers" in p:
        p = unstack_layers(p, prefix="layer_", dest="layers")
    sd: dict[str, torch.Tensor] = {"embed": _f32(p["embed"])}
    depth = sum(1 for k in p if k.startswith("layer_"))
    for i in range(depth):
        src, dst = p[f"layer_{i}"], f"layer_{i}"
        for norm in ("attn_norm", "mlp_norm"):
            sd[f"{dst}.{norm}.scale"] = _f32(src[norm]["scale"])
        for name, n_in in _LLAMA_LINEARS:
            sd[f"{dst}.{name}.weight"] = _kernel(src[name]["kernel"], n_in)
    sd["norm.scale"] = _f32(p["norm"]["scale"])
    if "lm_head" in p:
        sd["lm_head"] = _f32(p["lm_head"])
    return sd


def _ln(sd: dict, prefix: str, src) -> None:
    sd[f"{prefix}.scale"] = _f32(src["scale"])
    sd[f"{prefix}.bias"] = _f32(src["bias"])


def bert_params_from_flax(tree) -> dict[str, torch.Tensor]:
    """flax BERT params (``wte``, ``wpe``, ``wty``, ``ln_embed``,
    ``h_{i}/{qkv, out, ln_attn, mlp_fc, mlp_proj, ln_mlp}`` or their
    ``scan_layers`` stack ``hs/block/...``, and ``mlm_head/{transform, ln,
    bias}`` when present; a ``{"params": ...}`` wrapper is accepted) -> the
    port's :class:`~tpudist_torch.models.bert.Bert` state dict, in f32 on
    the CPU. ``qkv`` ``[d, 3, h, dh]`` and ``out`` ``[h, dh, d]`` flatten
    their grouped axes; the biases keep their shapes."""
    p = tree["params"] if "params" in tree else tree
    if "hs" in p:
        p = unstack_layers(p, prefix="h_", dest="hs")
    sd: dict[str, torch.Tensor] = {k: _f32(p[k]) for k in ("wte", "wpe", "wty")
                                   if k in p}
    _ln(sd, "ln_embed", p["ln_embed"])
    depth = sum(1 for k in p if k.startswith("h_"))
    for i in range(depth):
        src, dst = p[f"h_{i}"], f"h.{i}"
        _linear(sd, f"{dst}.qkv", src["qkv"]["kernel"], src["qkv"]["bias"])
        _linear(sd, f"{dst}.out", src["out"]["kernel"], src["out"]["bias"],
                n_in_axes=2)
        for name in ("mlp_fc", "mlp_proj"):
            _linear(sd, f"{dst}.{name}", src[name]["kernel"],
                    src[name]["bias"])
        for ln in ("ln_attn", "ln_mlp"):
            _ln(sd, f"{dst}.{ln}", src[ln])
    if "mlm_head" in p:
        head = p["mlm_head"]
        _linear(sd, "mlm_head.transform", head["transform"]["kernel"],
                head["transform"]["bias"])
        _ln(sd, "mlm_head.ln", head["ln"])
        sd["mlm_head.bias"] = _f32(head["bias"])
    return sd


def t5_params_from_flax(tree) -> dict[str, torch.Tensor]:
    """flax T5 params (``wte``, ``enc_rel_bias``, ``dec_rel_bias``,
    ``enc_{i}/{ln_attn, attn, ln_mlp, mlp}``, ``ln_enc``, ``dec_{i}/{ln_self,
    self_attn, ln_cross, cross_attn, ln_mlp, mlp}``, ``ln_dec``, ``lm_head``;
    a ``{"params": ...}`` wrapper is accepted; the family has no scanned
    layout) -> the port's :class:`~tpudist_torch.models.t5.T5` state dict,
    in f32 on the CPU: the bias-free kernels ``[in..., out...]`` (q/k/v
    ``[d, h, dh]``, out ``[h, dh, d]``) become ``[out, in]`` weights."""
    p = tree["params"] if "params" in tree else tree
    sd: dict[str, torch.Tensor] = {
        k: _f32(p[k]) for k in ("wte", "enc_rel_bias", "dec_rel_bias")}

    def attn(dst, src):
        for name in ("q", "k", "v"):
            sd[f"{dst}.{name}.weight"] = _kernel(src[name]["kernel"])
        sd[f"{dst}.out.weight"] = _kernel(src["out"]["kernel"], 2)

    def block(dst, src, norms, attns):
        for ln in norms:
            sd[f"{dst}.{ln}.scale"] = _f32(src[ln]["scale"])
        for a in attns:
            attn(f"{dst}.{a}", src[a])
        for name in ("wi_0", "wi_1", "wo"):
            sd[f"{dst}.mlp.{name}.weight"] = _kernel(src["mlp"][name]["kernel"])

    for i in range(sum(1 for k in p if k.startswith("enc_") and k[4:].isdigit())):
        block(f"enc.{i}", p[f"enc_{i}"], ("ln_attn", "ln_mlp"), ("attn",))
    for i in range(sum(1 for k in p if k.startswith("dec_") and k[4:].isdigit())):
        block(f"dec.{i}", p[f"dec_{i}"], ("ln_self", "ln_cross", "ln_mlp"),
              ("self_attn", "cross_attn"))
    sd["ln_enc.scale"] = _f32(p["ln_enc"]["scale"])
    sd["ln_dec.scale"] = _f32(p["ln_dec"]["scale"])
    sd["lm_head.weight"] = _kernel(p["lm_head"]["kernel"])
    return sd


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


# -- safetensors: an 8-byte little-endian header length, a JSON header of
# {name: {dtype, shape, data_offsets}}, then the raw little-endian bytes
_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32,
              "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def read_safetensors(path) -> dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU."""
    buf = bytearray(Path(path).read_bytes())
    if len(buf) < 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    n = int.from_bytes(buf[:8], "little")
    if 8 + n > len(buf):
        raise ValueError(f"{path}: header of {n} bytes past the file's end")
    header = json.loads(buf[8:8 + n].decode("utf-8"))
    header.pop("__metadata__", None)
    base, size = 8 + n, len(buf) - 8 - n
    out = {}
    for name, info in header.items():
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has unsupported dtype "
                             f"{info['dtype']}")
        shape = [int(d) for d in info["shape"]]
        begin, end = (int(o) for o in info["data_offsets"])
        count = int(np.prod(shape, dtype=np.int64))
        itemsize = torch.empty((), dtype=dtype).element_size()
        if not 0 <= begin <= end <= size or end - begin != count * itemsize:
            raise ValueError(f"{path}: {name}'s offsets {begin}..{end} do "
                             f"not hold {shape} {info['dtype']}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        out[name] = torch.frombuffer(buf, dtype=dtype, count=count,
                                     offset=base + begin).reshape(shape)
    return out


def write_safetensors(tensors: dict[str, torch.Tensor], path,
                      metadata: dict[str, str] | None = None) -> None:
    """Write ``tensors`` as a ``.safetensors`` file, by name, contiguous,
    the header padded with spaces to a multiple of 8 bytes."""
    header: dict = {"__metadata__": dict(metadata)} if metadata else {}
    blobs, offset = [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        if t.dtype not in _ST_NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name")
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode("utf-8")
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def load_hf_state_dict(path) -> dict[str, torch.Tensor]:
    """A local HF checkpoint (a directory or one file) -> {name: tensor}:
    ``*.safetensors`` (preferred; shards merge) or ``pytorch_model*.bin``."""
    p = Path(path)
    if p.is_dir():
        files = (sorted(p.glob("*.safetensors"))
                 or sorted(p.glob("pytorch_model*.bin")))
        if not files:
            raise FileNotFoundError(
                f"{p} holds no *.safetensors or pytorch_model*.bin")
    elif p.exists():
        files = [p]
    else:
        raise FileNotFoundError(str(p))
    sd = {}
    for f in files:
        if f.suffix == ".safetensors":
            sd.update(read_safetensors(f))
        else:
            sd.update(torch.load(f, map_location="cpu", weights_only=True))
    return sd


#: the port's GPT-2 linears and their HF ``Conv1D`` names
_HF_LINEARS = (("qkv", "attn.c_attn"), ("out", "attn.c_proj"),
               ("mlp_fc", "mlp.c_fc"), ("mlp_proj", "mlp.c_proj"))


def gpt2_params_from_hf(state_dict, *, depth: int,
                        num_heads: int) -> dict[str, torch.Tensor]:
    """HF ``GPT2LMHeadModel``/``GPT2Model`` state dict -> the port's GPT-2
    state dict, in f32 on the CPU. The LM head is tied in both, so only
    ``wte`` transfers; keys may carry the ``transformer.`` prefix or not."""
    sd = {k.removeprefix("transformer."): v for k, v in state_dict.items()}

    def f32(key):
        return sd[key].detach().to("cpu", torch.float32)

    wte = f32("wte.weight")
    d = wte.shape[1]
    out = {"wte": wte.clone(), "wpe": f32("wpe.weight").clone(),
           "ln_f.scale": f32("ln_f.weight").clone(),
           "ln_f.bias": f32("ln_f.bias").clone()}
    for i in range(depth):
        src, dst = f"h.{i}", f"h.{i}"
        for ln in ("ln_1", "ln_2"):
            out[f"{dst}.{ln}.scale"] = f32(f"{src}.{ln}.weight").clone()
            out[f"{dst}.{ln}.bias"] = f32(f"{src}.{ln}.bias").clone()
        for port, hf in _HF_LINEARS:
            # Conv1D [in, out] -> Dense [out, in]
            out[f"{dst}.{port}.weight"] = f32(f"{src}.{hf}.weight").t().contiguous()
            out[f"{dst}.{port}.bias"] = f32(f"{src}.{hf}.bias").clone()
        # q|k|v along the output: the bias keeps the port's [3, heads, dh]
        out[f"{dst}.qkv.bias"] = out[f"{dst}.qkv.bias"].reshape(
            3, num_heads, d // num_heads)
    return out


def gpt2_params_to_hf(params: dict, *, depth: int) -> dict[str, torch.Tensor]:
    """Inverse of :func:`gpt2_params_from_hf`: the port's GPT-2 state dict
    -> one HF ``GPT2LMHeadModel.load_state_dict(strict=False)`` loads
    (``strict=False`` only for HF's non-weight buffers), f32 on the CPU."""
    def f32(key):
        return params[key].detach().to("cpu", torch.float32)

    wte = f32("wte").clone()
    sd = {"transformer.wte.weight": wte,
          "transformer.wpe.weight": f32("wpe").clone(),
          "transformer.ln_f.weight": f32("ln_f.scale").clone(),
          "transformer.ln_f.bias": f32("ln_f.bias").clone(),
          "lm_head.weight": wte}  # tied
    for i in range(depth):
        src, dst = f"h.{i}", f"transformer.h.{i}"
        for ln in ("ln_1", "ln_2"):
            sd[f"{dst}.{ln}.weight"] = f32(f"{src}.{ln}.scale").clone()
            sd[f"{dst}.{ln}.bias"] = f32(f"{src}.{ln}.bias").clone()
        for port, hf in _HF_LINEARS:
            sd[f"{dst}.{hf}.weight"] = f32(f"{src}.{port}.weight").t().contiguous()
            sd[f"{dst}.{hf}.bias"] = f32(f"{src}.{port}.bias").reshape(-1).clone()
    return sd


#: the port's Llama block leaves and their HF ``LlamaForCausalLM`` names
_HF_LLAMA = (("attn_norm.scale", "input_layernorm.weight"),
             ("mlp_norm.scale", "post_attention_layernorm.weight"),
             ("q_proj.weight", "self_attn.q_proj.weight"),
             ("k_proj.weight", "self_attn.k_proj.weight"),
             ("v_proj.weight", "self_attn.v_proj.weight"),
             ("o_proj.weight", "self_attn.o_proj.weight"),
             ("gate_proj.weight", "mlp.gate_proj.weight"),
             ("up_proj.weight", "mlp.up_proj.weight"),
             ("down_proj.weight", "mlp.down_proj.weight"))


def llama_params_from_hf(state_dict, *, depth: int, num_heads: int,
                         num_kv_heads: int | None = None
                         ) -> dict[str, torch.Tensor]:
    """HF ``LlamaForCausalLM``/``LlamaModel`` state dict -> the port's
    Llama state dict, in f32 on the CPU (the reference's
    ``llama_params_from_hf``). HF's linears are ``[out, in]`` as the
    port's, with q/k/v heads in the same (heads, dh) order; GQA shapes are
    checked against ``num_heads`` / ``num_kv_heads``. ``lm_head`` is
    emitted only when present and not the embedding (a tied checkpoint
    loads into ``Llama(tie_embeddings=True)``)."""
    sd = {k.removeprefix("model."): v for k, v in state_dict.items()}

    def f32(key):
        return sd[key].detach().to("cpu", torch.float32).clone()

    embed = f32("embed_tokens.weight")
    d = embed.shape[1]
    kv = num_kv_heads or num_heads
    out = {"embed": embed, "norm.scale": f32("norm.weight")}
    for i in range(depth):
        for port, hf in _HF_LLAMA:
            out[f"layer_{i}.{port}"] = f32(f"layers.{i}.{hf}")
        k = out[f"layer_{i}.k_proj.weight"]
        if k.shape != (kv * (d // num_heads), d):
            raise ValueError(
                f"layer {i}: k_proj {tuple(k.shape)} is not {kv} K/V heads of "
                f"{d // num_heads} (num_heads {num_heads}, num_kv_heads {kv})")
    if "lm_head.weight" in sd:
        head = f32("lm_head.weight")
        if not torch.equal(head, embed):
            out["lm_head"] = head
    return out


def llama_params_to_hf(params: dict, *, depth: int) -> dict[str, torch.Tensor]:
    """Inverse of :func:`llama_params_from_hf`: the port's Llama state
    dict -> one HF ``LlamaForCausalLM.load_state_dict`` loads, f32 on the
    CPU (a tied model writes ``lm_head.weight`` = the embedding, as
    ``tie_word_embeddings=True`` expects)."""
    def f32(key):
        return params[key].detach().to("cpu", torch.float32).clone()

    sd = {"model.embed_tokens.weight": f32("embed"),
          "model.norm.weight": f32("norm.scale"),
          "lm_head.weight": f32("lm_head" if "lm_head" in params else "embed")}
    for i in range(depth):
        for port, hf in _HF_LLAMA:
            sd[f"model.layers.{i}.{hf}"] = f32(f"layer_{i}.{port}")
    return sd


#: the port's BERT block leaves and their HF ``BertForMaskedLM`` names
#: (under ``bert.encoder.layer.{i}.``), q/k/v aside
_HF_BERT = (("out", "attention.output.dense"),
            ("ln_attn", "attention.output.LayerNorm"),
            ("mlp_fc", "intermediate.dense"),
            ("mlp_proj", "output.dense"),
            ("ln_mlp", "output.LayerNorm"))
_QKV = ("query", "key", "value")


def _hf_leaf(port: str) -> str:
    """A port leaf's HF name: LayerNorm ``scale`` is HF's ``weight``."""
    return "weight" if port == "scale" else port


def bert_params_from_hf(state_dict, *, depth: int,
                        num_heads: int) -> dict[str, torch.Tensor]:
    """HF ``BertForMaskedLM``/``BertModel`` state dict -> the port's BERT
    state dict, in f32 on the CPU (the reference's ``bert_params_from_hf``).
    HF's ``Linear`` weights are ``[out, in]`` as the port's; its separate
    query/key/value stack into ``qkv`` (bias ``[3, heads, dh]``); the MLM
    head's transform and bias map onto ``mlm_head`` when present (the
    decoder matrix is tied to ``wte`` in both); the pooler is ignored."""
    sd = {k.removeprefix("bert."): v for k, v in state_dict.items()}

    def f32(key):
        return sd[key].detach().to("cpu", torch.float32).clone()

    def ln(dst, src):
        out[f"{dst}.scale"] = f32(f"{src}.weight")
        out[f"{dst}.bias"] = f32(f"{src}.bias")


    out = {"wte": f32("embeddings.word_embeddings.weight"),
           "wpe": f32("embeddings.position_embeddings.weight"),
           "wty": f32("embeddings.token_type_embeddings.weight")}
    d = out["wte"].shape[1]
    ln("ln_embed", "embeddings.LayerNorm")
    for i in range(depth):
        src, dst = f"encoder.layer.{i}", f"h.{i}"
        out[f"{dst}.qkv.weight"] = torch.cat(
            [f32(f"{src}.attention.self.{n}.weight") for n in _QKV])
        out[f"{dst}.qkv.bias"] = torch.stack(
            [f32(f"{src}.attention.self.{n}.bias") for n in _QKV]).reshape(
                3, num_heads, d // num_heads)
        for port, hf in _HF_BERT:
            if port.startswith("ln"):
                ln(f"{dst}.{port}", f"{src}.{hf}")
            else:
                out[f"{dst}.{port}.weight"] = f32(f"{src}.{hf}.weight")
                out[f"{dst}.{port}.bias"] = f32(f"{src}.{hf}.bias")
    head = "cls.predictions"
    if f"{head}.transform.dense.weight" in sd:
        out["mlm_head.transform.weight"] = f32(f"{head}.transform.dense.weight")
        out["mlm_head.transform.bias"] = f32(f"{head}.transform.dense.bias")
        ln("mlm_head.ln", f"{head}.transform.LayerNorm")
        out["mlm_head.bias"] = f32(f"{head}.bias")
    return out


def bert_params_to_hf(params: dict, *, depth: int) -> dict[str, torch.Tensor]:
    """Inverse of :func:`bert_params_from_hf`: the port's BERT state dict ->
    one HF ``BertForMaskedLM.load_state_dict(strict=False)`` loads
    (``strict=False`` for HF's position-id buffer and the pooler), f32 on
    the CPU; the decoder is the tied ``wte``."""
    def f32(key):
        return params[key].detach().to("cpu", torch.float32).clone()

    e = "bert.embeddings"
    wte = f32("wte")
    sd = {f"{e}.word_embeddings.weight": wte,
          f"{e}.position_embeddings.weight": f32("wpe"),
          f"{e}.token_type_embeddings.weight": f32("wty"),
          f"{e}.LayerNorm.weight": f32("ln_embed.scale"),
          f"{e}.LayerNorm.bias": f32("ln_embed.bias"),
          "cls.predictions.decoder.weight": wte}
    for i in range(depth):
        src, dst = f"h.{i}", f"bert.encoder.layer.{i}"
        w, b = f32(f"{src}.qkv.weight"), f32(f"{src}.qkv.bias").reshape(3, -1)
        for j, n in enumerate(_QKV):
            sd[f"{dst}.attention.self.{n}.weight"] = w.chunk(3)[j].clone()
            sd[f"{dst}.attention.self.{n}.bias"] = b[j].clone()
        for port, hf in _HF_BERT:
            for leaf in (("scale", "bias") if port.startswith("ln")
                         else ("weight", "bias")):
                sd[f"{dst}.{hf}.{_hf_leaf(leaf)}"] = f32(f"{src}.{port}.{leaf}")
    if "mlm_head.bias" in params:
        c = "cls.predictions"
        sd[f"{c}.transform.dense.weight"] = f32("mlm_head.transform.weight")
        sd[f"{c}.transform.dense.bias"] = f32("mlm_head.transform.bias")
        sd[f"{c}.transform.LayerNorm.weight"] = f32("mlm_head.ln.scale")
        sd[f"{c}.transform.LayerNorm.bias"] = f32("mlm_head.ln.bias")
        sd[f"{c}.bias"] = f32("mlm_head.bias")
        sd[f"{c}.decoder.bias"] = f32("mlm_head.bias")
    return sd


#: a T5 block's sub-layers: (port prefix, HF layer index, HF module) per
#: stack; each attention is q/k/v/o, each MLP wi_0/wi_1/wo
_HF_T5 = {"enc": (("ln_attn", "attn", 0, "SelfAttention"),
                  ("ln_mlp", "mlp", 1, "DenseReluDense")),
          "dec": (("ln_self", "self_attn", 0, "SelfAttention"),
                  ("ln_cross", "cross_attn", 1, "EncDecAttention"),
                  ("ln_mlp", "mlp", 2, "DenseReluDense"))}
_HF_STACK = {"enc": "encoder", "dec": "decoder"}


def _t5_leaves(module: str):
    """(port leaf, HF leaf) of one T5 sub-layer's linears."""
    if module == "DenseReluDense":
        return (("wi_0", "wi_0"), ("wi_1", "wi_1"), ("wo", "wo"))
    return (("q", "q"), ("k", "k"), ("v", "v"), ("out", "o"))


def t5_params_from_hf(state_dict, *, enc_depth: int, dec_depth: int,
                      num_heads: int) -> dict[str, torch.Tensor]:
    """HF ``T5ForConditionalGeneration`` (v1.1: gated-gelu, untied
    ``lm_head``) state dict -> the port's T5 state dict, in f32 on the CPU
    (the reference's ``t5_params_from_hf``). HF's ``Linear`` weights are
    ``[out, in]`` as the port's; the shared relative bias lives on block 0
    of each stack in HF and as ``enc_rel_bias`` / ``dec_rel_bias`` here; the
    embeddings are the shared table. ``num_heads`` is checked against the
    bias tables."""
    def f32(key):
        return state_dict[key].detach().to("cpu", torch.float32).clone()

    rel = "block.0.layer.0.SelfAttention.relative_attention_bias.weight"
    out = {"wte": f32("shared.weight"),
           "enc_rel_bias": f32(f"encoder.{rel}"),
           "dec_rel_bias": f32(f"decoder.{rel}"),
           "ln_enc.scale": f32("encoder.final_layer_norm.weight"),
           "ln_dec.scale": f32("decoder.final_layer_norm.weight"),
           "lm_head.weight": f32("lm_head.weight")}
    if out["enc_rel_bias"].shape[1] != num_heads:
        raise ValueError(f"relative bias of {out['enc_rel_bias'].shape[1]} "
                         f"heads, not num_heads {num_heads}")
    for stack, depth in (("enc", enc_depth), ("dec", dec_depth)):
        for i in range(depth):
            src = f"{_HF_STACK[stack]}.block.{i}.layer"
            for norm, sub, j, module in _HF_T5[stack]:
                out[f"{stack}.{i}.{norm}.scale"] = f32(
                    f"{src}.{j}.layer_norm.weight")
                for port, hf in _t5_leaves(module):
                    out[f"{stack}.{i}.{sub}.{port}.weight"] = f32(
                        f"{src}.{j}.{module}.{hf}.weight")
    return out


def t5_params_to_hf(params: dict, *, enc_depth: int,
                    dec_depth: int) -> dict[str, torch.Tensor]:
    """Inverse of :func:`t5_params_from_hf`: the port's T5 state dict -> one
    HF ``T5ForConditionalGeneration.load_state_dict`` loads on a matching
    v1.1 config (``feed_forward_proj="gated-gelu"``,
    ``tie_word_embeddings=False``), f32 on the CPU."""
    def f32(key):
        return params[key].detach().to("cpu", torch.float32).clone()

    rel = "block.0.layer.0.SelfAttention.relative_attention_bias.weight"
    wte = f32("wte")
    sd = {"shared.weight": wte, "encoder.embed_tokens.weight": wte,
          "decoder.embed_tokens.weight": wte,
          f"encoder.{rel}": f32("enc_rel_bias"),
          f"decoder.{rel}": f32("dec_rel_bias"),
          "encoder.final_layer_norm.weight": f32("ln_enc.scale"),
          "decoder.final_layer_norm.weight": f32("ln_dec.scale"),
          "lm_head.weight": f32("lm_head.weight")}
    for stack, depth in (("enc", enc_depth), ("dec", dec_depth)):
        for i in range(depth):
            dst = f"{_HF_STACK[stack]}.block.{i}.layer"
            for norm, sub, j, module in _HF_T5[stack]:
                sd[f"{dst}.{j}.layer_norm.weight"] = f32(
                    f"{stack}.{i}.{norm}.scale")
                for port, hf in _t5_leaves(module):
                    sd[f"{dst}.{j}.{module}.{hf}.weight"] = f32(
                        f"{stack}.{i}.{sub}.{port}.weight")
    return sd


def _unknown(arch: str):
    return ValueError(f"unknown arch {arch!r} (want gpt2, llama, bert, or t5)")


def load_hf_params(path, *, arch: str, depth: int, num_heads: int,
                   num_kv_heads: int | None = None) -> dict[str, torch.Tensor]:
    """One-call warm start: a local HF checkpoint -> the port's state dict
    for ``arch`` (gpt2, llama, bert, t5; T5 with ``depth`` layers in each
    stack, the published symmetric geometries)."""
    if arch not in ("gpt2", "llama", "bert", "t5"):
        raise _unknown(arch)
    sd = load_hf_state_dict(path)
    if arch == "gpt2":
        return gpt2_params_from_hf(sd, depth=depth, num_heads=num_heads)
    if arch == "llama":
        return llama_params_from_hf(sd, depth=depth, num_heads=num_heads,
                                    num_kv_heads=num_kv_heads)
    if arch == "bert":
        return bert_params_from_hf(sd, depth=depth, num_heads=num_heads)
    return t5_params_from_hf(sd, enc_depth=depth, dec_depth=depth,
                             num_heads=num_heads)


def save_hf_checkpoint(params: dict, path, *, arch: str, depth: int) -> None:
    """Write the port's ``params`` (a state dict) as an HF-layout
    ``model.safetensors`` under ``path`` (``{"format": "pt"}`` metadata,
    which ``from_pretrained`` requires)."""
    if arch == "gpt2":
        sd = gpt2_params_to_hf(params, depth=depth)
    elif arch == "llama":
        sd = llama_params_to_hf(params, depth=depth)
    elif arch == "bert":
        sd = bert_params_to_hf(params, depth=depth)
    elif arch == "t5":
        sd = t5_params_to_hf(params, enc_depth=depth, dec_depth=depth)
    else:
        raise _unknown(arch)
    os.makedirs(path, exist_ok=True)
    write_safetensors(sd, os.path.join(path, "model.safetensors"),
                      metadata={"format": "pt"})
