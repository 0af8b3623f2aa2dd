"""Carry weights, gradients and optimizer-visible names between the JAX
package and the port.

``from_jax_params`` turns a flax ``VisionMamba``, ``MaskedAutoencoderVim``,
``ChannelVisionMamba``, ``UperNetSegmentor``, ``SimpleFPN`` or
``CascadeMaskRCNN`` variable tree (nested mappings of array-likes, with or without the top-level
``"params"``; a segmentor's ``"batch_stats"`` become its BatchNorms'
running statistics) into the port's ``state_dict`` as numpy arrays,
under the torch reference's names (the port's own for the heads), and
raises on a leaf it does not know rather than drop it. A gradient tree
from ``jax.grad`` has the parameters' structure, so the same function
maps it onto the port's names, and so it does any
per-leaf tree (a weight-decay mask broadcast to the leaves' shapes).
``to_jax_params`` is the inverse, and ``grads_to_numpy`` collects a
model's ``.grad``s (or a name → gradient mapping) under the same names.
They need numpy only:

==============================  =======================================
flax (``fastvim_tpu.models``)   port / reference torch name
==============================  =======================================
patch_embed/proj/kernel (p,p,C,D)  patch_embed.proj.weight (D,C,p,p)
ChannelVim's (p,p,1,D)          patch_embed.proj.weight (D,1,1,p,p)
patch_embed/channel_embed       patch_embed.channel_embed.weight
layers_{i}/norm_weight          layers.{i}.norm.weight
layers_{i}/mixer/in_proj/kernel layers.{i}.mixer.in_proj.weight (.T)
conv1d{_b}_weight (w, d)        ...mixer.conv1d{_b}.weight (d, 1, w)
x_proj{_b}_weight / dt_proj...  ...mixer.x_proj{_b}.weight (.T) / ...
A{_b}_log, D{_b}, layernorm_*   ...mixer.A{_b}_log, D{_b}, layernorm.*
out_proj/kernel                 ...mixer.out_proj.weight (.T)
norm_f_weight, head/kernel      norm_f.weight, head.weight (.T)
...mixer/gamma                  ...mixer.gamma
decoder_blocks_{i}/...          decoder_blocks.{i}.... (as layers_{i})
decoder_embed/_pred kernel      decoder_embed/_pred.weight (.T)
decoder_norm_weight, mask_token decoder_norm.weight, mask_token
outnorm_{j}_weight / _bias      outnorm_{j}.weight / .bias
backbone/...                    backbone.... (as above)
decode_head/PSPModule_0/        decode_head.psp.stages.{k}
  ConvModule_{k}
decode_head/ConvModule_0        decode_head.bottleneck
decode_head/ConvModule_{1+i}    decode_head.lateral_convs.{i}
decode_head/ConvModule_{n+i}    decode_head.fpn_convs.{i} (n maps)
decode_head/ConvModule_{2n-1}   decode_head.fpn_bottleneck
decode_head/Conv_0              decode_head.conv_seg
aux_head/ConvModule_0, Conv_0   aux_head.convs.0, aux_head.conv_seg
.../Conv_0/kernel (kh,kw,I,O)   ....conv.weight (O,I,kh,kw)
.../LayerNorm_0/scale, bias     ....ln.weight, .bias
.../BatchNorm_0/scale, bias     ....bn.weight, .bias
batch_stats/.../BatchNorm_0/    ....bn.running_mean, .running_var
  mean, var
SimpleFPN's {fpn1_deconv1,      the same names, .weight (in, out, kh,
  fpn1_deconv2, fpn2_deconv}/   kw) = the kernel flipped on both
  kernel (kh,kw,in,out)         spatial axes (flax does not flip)
lateral_{i}, fpn_conv_{i}       .weight (O,I,kh,kw)
..._norm_{i}/weight, bias       ..._norm_{i}.weight, .bias
neck/...                        neck.... (as SimpleFPN)
rpn/{rpn_conv,rpn_cls,rpn_reg}  rpn.{...}.weight (O,I,kh,kw), .bias
stages/head/{fc1,fc2,cls,reg}/  stages.{s}.head.{...}.weight (out, in)
  kernel (3, in, out), bias       = kernel[s].T, .bias = bias[s]
  (3, out)
mask_head/{conv0..3,logits}     mask_head.{...}.weight (O,I,kh,kw)
mask_head/upsample/kernel       mask_head.upsample.weight (in, out,
                                  kh, kw), flipped like the FPN's
==============================  =======================================

``fc1`` needs no permutation: the port's RoI features are NHWC, so its
input is flax's flatten of (7, 7, C).

``lm_from_jax_params`` carries a flax ``MambaLMHeadModel`` across (the
inverse of the JAX package's ``utils/hf.convert_lm``), and
``cache_from_jax`` its decode caches and the vision mixer's, whose
layouts the port keeps: the LM's (conv window (batch, d_conv, d_inner),
ssm (batch, d_inner, d_state) fp32) per layer, the mixer's ``{"conv":
(batch, d_conv, d_inner), "ssm": (batch, d_inner, d_state) fp32}``:

==============================  =======================================
flax (``fastvim_tpu.models.lm``)  port / reference torch name
==============================  =======================================
embedding/embedding             backbone.embedding.weight
norm_{i}_weight, norm_f_weight  backbone.layers.{i}.norm.weight,
                                  backbone.norm_f.weight
layers_{i}/in_proj/kernel       backbone.layers.{i}.mixer.in_proj.weight
  (and out_proj)                  (.T)
layers_{i}/conv1d_weight (w,d)  ...mixer.conv1d.weight (d, 1, w)
layers_{i}/x_proj_weight,       ...mixer.x_proj.weight, dt_proj.weight
  dt_proj_weight                  (.T)
conv1d_bias, dt_proj_bias,      ...mixer.conv1d.bias, dt_proj.bias,
  A_log, D                        A_log, D
==============================  =======================================
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np


def _np(x) -> np.ndarray:
    return np.asarray(x)


def _mixer(m: Mapping[str, Any], pre: str) -> Dict[str, np.ndarray]:
    sd = {}
    for name in ("in_proj", "out_proj"):
        sd[f"{pre}.{name}.weight"] = _np(m[name]["kernel"]).T
        if "bias" in m[name]:
            sd[f"{pre}.{name}.bias"] = _np(m[name]["bias"])
    for sfx in ("", "_b"):
        sd[f"{pre}.conv1d{sfx}.weight"] = _np(
            m[f"conv1d{sfx}_weight"]).T[:, None, :]
        if f"conv1d{sfx}_bias" in m:
            sd[f"{pre}.conv1d{sfx}.bias"] = _np(m[f"conv1d{sfx}_bias"])
        sd[f"{pre}.x_proj{sfx}.weight"] = _np(m[f"x_proj{sfx}_weight"]).T
        sd[f"{pre}.dt_proj{sfx}.weight"] = _np(m[f"dt_proj{sfx}_weight"]).T
        sd[f"{pre}.dt_proj{sfx}.bias"] = _np(m[f"dt_proj{sfx}_bias"])
        sd[f"{pre}.A{sfx}_log"] = _np(m[f"A{sfx}_log"])
        sd[f"{pre}.D{sfx}"] = _np(m[f"D{sfx}"])
    if "layernorm_weight" in m:
        sd[f"{pre}.layernorm.weight"] = _np(m["layernorm_weight"])
        sd[f"{pre}.layernorm.bias"] = _np(m["layernorm_bias"])
    if "gamma" in m:
        sd[f"{pre}.gamma"] = _np(m["gamma"])
    return sd


_STACKS = ("layers", "decoder_blocks")
_DENSE = ("in_proj", "out_proj", "head", "decoder_embed", "decoder_pred")


def from_jax_params(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """flax variables (or params) → the port's state_dict (numpy arrays);
    load with ``{k: torch.from_numpy(v.copy()) for k, v in ...}``."""
    p = params.get("params", params)
    stats = params.get("batch_stats", {}) if "params" in params else {}
    if "embedding" in p and "norm_f_weight" in p:
        return lm_from_jax_params(p)
    if any(k in p for k in _DETECTOR):
        sd = _detector_from_jax(p)
        dropped = (set(_leaf_paths(p))
                   - set(_leaf_paths(to_jax_params(sd)["params"])))
        if dropped:
            raise ValueError(f"from_jax_params: no port name for "
                             f"{sorted(dropped)}")
        return sd
    segmentor = any(k in p for k in _SEGMENTOR)
    if segmentor or "fpn1_deconv1" in p:
        sd = _segmentor_from_jax(p, stats) if segmentor else _fpn_from_jax(p)
        jax_tree = to_jax_params(sd)
        dropped = ((set(_leaf_paths(p)) - set(_leaf_paths(
            jax_tree["params"])))
            | {f"batch_stats/{k}" for k in set(_leaf_paths(stats)) - set(
                _leaf_paths(jax_tree.get("batch_stats", {})))})
        if dropped:
            raise ValueError(f"from_jax_params: no port name for "
                             f"{sorted(dropped)}")
        return sd
    return _trunk_from_jax(p)


def _trunk_from_jax(p: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A VisionMamba / MAE / ChannelVim params tree → its state_dict."""
    proj = p["patch_embed"]["proj"]
    kernel = _np(proj["kernel"])
    if "channel_embed" in p["patch_embed"]:
        # ChannelVim's filter shared by every channel: a Conv3d(1, D,
        # (1, p, p)) in the reference
        sd = {"patch_embed.proj.weight": kernel[:, :, 0, :].transpose(
                  2, 0, 1)[:, None, None],
              "patch_embed.channel_embed.weight": _np(
                  p["patch_embed"]["channel_embed"])}
    else:
        sd = {"patch_embed.proj.weight": kernel.transpose(3, 2, 0, 1)}
    sd["patch_embed.proj.bias"] = _np(proj["bias"])
    for name in ("pos_embed", "cls_token", "mask_token"):
        if name in p:
            sd[name] = _np(p[name])
    for stack in _STACKS:
        i = 0
        while f"{stack}_{i}" in p:
            lp = p[f"{stack}_{i}"]
            sd[f"{stack}.{i}.norm.weight"] = _np(lp["norm_weight"])
            if "norm_bias" in lp:
                sd[f"{stack}.{i}.norm.bias"] = _np(lp["norm_bias"])
            sd.update(_mixer(lp["mixer"], f"{stack}.{i}.mixer"))
            i += 1
    j = 0
    while f"outnorm_{j}_weight" in p:
        sd[f"outnorm_{j}.weight"] = _np(p[f"outnorm_{j}_weight"])
        sd[f"outnorm_{j}.bias"] = _np(p[f"outnorm_{j}_bias"])
        j += 1
    for norm in ("norm_f", "decoder_norm"):
        for part in ("weight", "bias"):
            if f"{norm}_{part}" in p:
                sd[f"{norm}.{part}"] = _np(p[f"{norm}_{part}"])
    for name in ("head", "decoder_embed", "decoder_pred"):
        if name in p:
            sd[f"{name}.weight"] = _np(p[name]["kernel"]).T
            sd[f"{name}.bias"] = _np(p[name]["bias"])
    dropped = (set(_leaf_paths(p))
               - set(_leaf_paths(to_jax_params(sd)["params"])))
    if dropped:
        raise ValueError(f"from_jax_params: no port name for "
                         f"{sorted(dropped)}")
    return sd


def _conv_to_torch(kernel) -> np.ndarray:
    """flax conv kernel (kh, kw, in, out) → torch (out, in, kh, kw)."""
    return _np(kernel).transpose(3, 2, 0, 1)


def _conv_to_jax(weight) -> np.ndarray:
    return _np(weight).transpose(2, 3, 1, 0)


def _head_modules(head: str, n_maps: int, n_scales: int):
    """(flax module path, port module prefix) of a head's ConvModules and
    its classifier: ``n_maps`` input maps, ``n_scales`` pool scales."""
    if head == "aux_head":
        return [("aux_head/ConvModule_0", "aux_head.convs.0"),
                ("aux_head/Conv_0", "aux_head.conv_seg")]
    n = n_maps
    pairs = [(f"decode_head/PSPModule_0/ConvModule_{k}",
              f"decode_head.psp.stages.{k}") for k in range(n_scales)]
    pairs.append(("decode_head/ConvModule_0", "decode_head.bottleneck"))
    pairs += [(f"decode_head/ConvModule_{1 + i}",
               f"decode_head.lateral_convs.{i}") for i in range(n - 1)]
    pairs += [(f"decode_head/ConvModule_{n + i}",
               f"decode_head.fpn_convs.{i}") for i in range(n - 1)]
    pairs.append((f"decode_head/ConvModule_{2 * n - 1}",
                  "decode_head.fpn_bottleneck"))
    pairs.append(("decode_head/Conv_0", "decode_head.conv_seg"))
    return pairs


def _get(tree: Mapping[str, Any], path: str):
    for k in path.split("/"):
        if not isinstance(tree, Mapping) or k not in tree:
            return None
        tree = tree[k]
    return tree


def _count(tree: Mapping[str, Any], prefix: str) -> int:
    """How many ``{prefix}{i}`` keys, from 0 up, ``tree`` holds."""
    n = 0
    while f"{prefix}{n}" in (tree or {}):
        n += 1
    return n


_SEGMENTOR = ("backbone", "decode_head", "aux_head")


def _segmentor_from_jax(p: Mapping[str, Any], stats: Mapping[str, Any]
                        ) -> Dict[str, np.ndarray]:
    """A segmentor's tree, or one of its heads' under its name."""
    sd = ({f"backbone.{k}": v
           for k, v in _trunk_from_jax(p["backbone"]).items()}
          if "backbone" in p else {})
    dh = p.get("decode_head", {})
    n_maps = _count(dh, "ConvModule_") // 2
    n_scales = _count(dh.get("PSPModule_0"), "ConvModule_")
    for head in ("decode_head", "aux_head"):
        if head not in p:
            continue
        for fpath, tpre in _head_modules(head, n_maps, n_scales):
            m = _get(p, fpath)
            if fpath.endswith("Conv_0"):  # the classifier
                sd[f"{tpre}.weight"] = _conv_to_torch(m["kernel"])
                sd[f"{tpre}.bias"] = _np(m["bias"])
                continue
            sd[f"{tpre}.conv.weight"] = _conv_to_torch(m["Conv_0"]["kernel"])
            kind = "bn" if "BatchNorm_0" in m else "ln"
            norm = m["BatchNorm_0" if kind == "bn" else "LayerNorm_0"]
            sd[f"{tpre}.{kind}.weight"] = _np(norm["scale"])
            sd[f"{tpre}.{kind}.bias"] = _np(norm["bias"])
            bn = _get(stats, f"{fpath}/BatchNorm_0")
            if bn is not None:
                sd[f"{tpre}.bn.running_mean"] = _np(bn["mean"])
                sd[f"{tpre}.bn.running_var"] = _np(bn["var"])
    return sd


def _segmentor_to_jax(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    trunk = {k[len("backbone."):]: v for k, v in state_dict.items()
             if k.startswith("backbone.")}
    params: Dict[str, Any] = (
        {"backbone": to_jax_params(trunk)["params"]} if trunk else {})
    stats: Dict[str, Any] = {}
    n_maps = sum(1 for k in state_dict
                 if k.startswith("decode_head.lateral_convs.")
                 and k.endswith(".conv.weight")) + 1
    n_scales = sum(1 for k in state_dict
                   if k.startswith("decode_head.psp.stages.")
                   and k.endswith(".conv.weight"))
    for head in ("decode_head", "aux_head"):
        if f"{head}.conv_seg.weight" not in state_dict:
            continue
        for fpath, tpre in _head_modules(head, n_maps, n_scales):
            if fpath.endswith("Conv_0"):
                _set(params, f"{fpath}/kernel",
                     _conv_to_jax(state_dict[f"{tpre}.weight"]))
                _set(params, f"{fpath}/bias", _np(state_dict[f"{tpre}.bias"]))
                continue
            _set(params, f"{fpath}/Conv_0/kernel",
                 _conv_to_jax(state_dict[f"{tpre}.conv.weight"]))
            kind = "bn" if f"{tpre}.bn.weight" in state_dict else "ln"
            norm = fpath + ("/BatchNorm_0" if kind == "bn" else "/LayerNorm_0")
            _set(params, f"{norm}/scale",
                 _np(state_dict[f"{tpre}.{kind}.weight"]))
            _set(params, f"{norm}/bias",
                 _np(state_dict[f"{tpre}.{kind}.bias"]))
            if f"{tpre}.bn.running_mean" in state_dict:
                _set(stats, f"{norm}/mean",
                     _np(state_dict[f"{tpre}.bn.running_mean"]))
                _set(stats, f"{norm}/var",
                     _np(state_dict[f"{tpre}.bn.running_var"]))
    tree = {"params": params}
    if stats:
        tree["batch_stats"] = stats
    return tree


_FPN_DECONVS = ("fpn1_deconv1", "fpn1_deconv2", "fpn2_deconv")


def _fpn_from_jax(p: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    names = ["fpn1_deconv1", "fpn1_norm", "fpn1_deconv2", "fpn2_deconv"]
    for i in range(_count(p, "lateral_")):
        names += [f"lateral_{i}", f"lateral_norm_{i}", f"fpn_conv_{i}",
                  f"fpn_norm_{i}"]
    sd = {}
    for name in names:
        for leaf, v in p[name].items():
            v = _np(v)
            if leaf == "kernel":
                v = (v[::-1, ::-1].transpose(2, 3, 0, 1)
                     if name in _FPN_DECONVS else _conv_to_torch(v))
            sd[f"{name}.{'weight' if leaf == 'kernel' else leaf}"] = v
    return sd


def _fpn_to_jax(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in state_dict.items():
        name, leaf = key.split(".")
        v = _np(v)
        is_norm = "norm" in name
        if leaf == "weight" and not is_norm:
            leaf = "kernel"
            v = (v.transpose(2, 3, 0, 1)[::-1, ::-1]
                 if name in _FPN_DECONVS else _conv_to_jax(v))
        _set(tree, f"{name}/{leaf}", v)
    return {"params": tree}


_DETECTOR = ("rpn", "stages", "mask_head")  # its "neck" is a SimpleFPN tree
_RPN = ("rpn_conv", "rpn_cls", "rpn_reg")
_BBOX_HEAD = ("fc1", "fc2", "cls", "reg")


def _mask_convs(m: Mapping[str, Any]):
    return [f"conv{i}" for i in range(_count(m, "conv"))] + ["logits"]


def _detector_from_jax(p: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A ``CascadeMaskRCNN`` tree: the stacked (3, …) stage heads split
    into ``stages.{s}.head``."""
    sd = {}
    if "backbone" in p:
        sd.update({f"backbone.{k}": v
                   for k, v in _trunk_from_jax(p["backbone"]).items()})
    if "neck" in p:
        sd.update({f"neck.{k}": v for k, v in _fpn_from_jax(p["neck"]).items()})
    convs = [(f"rpn.{n}", p.get("rpn", {}).get(n)) for n in _RPN]
    mh = p.get("mask_head", {})
    convs += [(f"mask_head.{n}", mh.get(n)) for n in _mask_convs(mh)]
    for pre, m in convs:
        if m is not None:
            sd[f"{pre}.weight"] = _conv_to_torch(m["kernel"])
            sd[f"{pre}.bias"] = _np(m["bias"])
    if "upsample" in mh:
        sd["mask_head.upsample.weight"] = _np(
            mh["upsample"]["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1)
        sd["mask_head.upsample.bias"] = _np(mh["upsample"]["bias"])
    head = p.get("stages", {}).get("head", {})
    for name, m in head.items():
        kernel, bias = _np(m["kernel"]), _np(m["bias"])
        for s in range(kernel.shape[0]):
            sd[f"stages.{s}.head.{name}.weight"] = kernel[s].T
            sd[f"stages.{s}.head.{name}.bias"] = bias[s]
    return sd


def _detector_to_jax(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    params: Dict[str, Any] = {}
    for sub in ("backbone", "neck"):
        part = {k[len(sub) + 1:]: v for k, v in state_dict.items()
                if k.startswith(sub + ".")}
        if part:
            params[sub] = to_jax_params(part)["params"]
    heads: Dict[str, Dict[str, list]] = {}
    for key, v in state_dict.items():
        parts = key.split(".")
        v = _np(v)
        if parts[0] in ("rpn", "mask_head"):
            name, leaf = parts[1], parts[2]
            if leaf == "weight" and name == "upsample":
                v = v.transpose(2, 3, 0, 1)[::-1, ::-1]
            elif leaf == "weight":
                v = _conv_to_jax(v)
            _set(params, f"{parts[0]}/{name}/"
                 + ("kernel" if leaf == "weight" else "bias"), v)
        elif parts[0] == "stages":
            s, name, leaf = int(parts[1]), parts[3], parts[4]
            slots = heads.setdefault(name, {}).setdefault(leaf, [])
            slots.extend([None] * (s + 1 - len(slots)))
            slots[s] = v.T if leaf == "weight" else v
    for name, leaves in heads.items():
        for leaf, per_stage in leaves.items():
            _set(params, f"stages/head/{name}/"
                 + ("kernel" if leaf == "weight" else "bias"),
                 np.stack(per_stage))
    return {"params": params}


def _leaf_paths(tree: Mapping[str, Any], prefix: str = ""):
    """The "a/b/c" paths of a nested mapping's leaves."""
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaf_paths(v, f"{prefix}{k}/")
        else:
            yield prefix + k


def _set(tree: Dict[str, Any], path: str, value: np.ndarray) -> None:
    *parents, leaf = path.split("/")
    for k in parents:
        tree = tree.setdefault(k, {})
    tree[leaf] = value


def to_jax_params(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """The port's state_dict (name → array-like; torch tensors go through
    ``.numpy()`` first) → the flax tree ``{"params": {...}}``: the inverse
    of :func:`from_jax_params`, with ``"batch_stats"`` beside
    ``"params"`` where a segmentor has BatchNorms."""
    if any(k.split(".")[0] in _DETECTOR for k in state_dict):
        return _detector_to_jax(state_dict)
    if any(k.split(".")[0] in _SEGMENTOR for k in state_dict):
        return _segmentor_to_jax(state_dict)
    if "fpn1_deconv1.weight" in state_dict:
        return _fpn_to_jax(state_dict)
    tree: Dict[str, Any] = {}
    for name, v in state_dict.items():
        v = _np(v)
        parts = name.split(".")
        if parts[0] in _STACKS:
            pre, rest = f"{parts[0]}_{parts[1]}/", parts[2:]
        else:
            pre, rest = "", parts
        if rest[0] == "mixer":
            pre, rest = pre + "mixer/", rest[1:]
        key = ".".join(rest)
        if key == "patch_embed.proj.weight" and v.ndim == 5:
            _set(tree, "patch_embed/proj/kernel",
                 v[:, 0, 0].transpose(1, 2, 0)[:, :, None, :])
        elif key == "patch_embed.proj.weight":
            _set(tree, "patch_embed/proj/kernel", v.transpose(2, 3, 1, 0))
        elif key == "patch_embed.channel_embed.weight":
            _set(tree, "patch_embed/channel_embed", v)
        elif key == "patch_embed.proj.bias":
            _set(tree, "patch_embed/proj/bias", v)
        elif rest[0] in _DENSE:
            _set(tree, f"{pre}{rest[0]}/" + ("kernel" if rest[1] == "weight"
                                             else "bias"),
                 v.T if rest[1] == "weight" else v)
        elif rest[0].startswith("conv1d") and rest[1] == "weight":
            _set(tree, f"{pre}{rest[0]}_weight", v[:, 0, :].T)
        elif rest[0].startswith(("x_proj", "dt_proj")) and rest[1] == "weight":
            _set(tree, f"{pre}{rest[0]}_weight", v.T)
        else:  # norm.weight → norm_weight, A_log, D, gamma, mask_token, ...
            _set(tree, pre + "_".join(rest), v)
    return {"params": tree}


def lm_from_jax_params(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """flax ``MambaLMHeadModel`` variables (or params) → the port's
    state_dict (numpy arrays, the reference's names; no ``lm_head``: it
    is tied to the embedding). Raises on a leaf it does not know."""
    p = params.get("params", params)
    leaves = {path: _get(p, path) for path in _leaf_paths(p)}
    take = lambda path: _np(leaves.pop(path))
    sd = {"backbone.embedding.weight": take("embedding/embedding"),
          "backbone.norm_f.weight": take("norm_f_weight")}
    for i in range(_count(p, "layers_")):
        pre, m = f"backbone.layers.{i}", f"layers_{i}/"
        sd[f"{pre}.norm.weight"] = take(f"norm_{i}_weight")
        for name in ("in_proj", "out_proj"):
            sd[f"{pre}.mixer.{name}.weight"] = take(f"{m}{name}/kernel").T
        sd[f"{pre}.mixer.conv1d.weight"] = take(
            f"{m}conv1d_weight").T[:, None, :]
        for name in ("x_proj", "dt_proj"):
            sd[f"{pre}.mixer.{name}.weight"] = take(f"{m}{name}_weight").T
        for name in ("conv1d_bias", "dt_proj_bias"):
            sd[f"{pre}.mixer.{name.replace('_bias', '.bias')}"] = take(
                m + name)
        for name in ("A_log", "D"):
            sd[f"{pre}.mixer.{name}"] = take(m + name)
    if leaves:
        raise ValueError(f"lm_from_jax_params: no port name for "
                         f"{sorted(leaves)}")
    return sd


def cache_from_jax(cache, device="cpu"):
    """A JAX decode cache (the LM's list of (conv window, ssm) tuples, or
    the vision mixer's ``{"conv", "ssm"}`` dict, of array-likes) → the
    same structure of torch tensors on ``device``: the layouts are the
    same in both packages."""
    if isinstance(cache, Mapping):
        return {k: cache_from_jax(v, device) for k, v in cache.items()}
    if isinstance(cache, (list, tuple)):
        return type(cache)(cache_from_jax(v, device) for v in cache)
    import torch

    return torch.from_numpy(np.array(cache)).to(device)


def grads_to_numpy(source) -> Dict[str, np.ndarray]:
    """A model's ``.grad``s, or a name → gradient tensor mapping, as
    ``{name: float32 numpy array}`` under the port's names."""
    items = (source.items() if isinstance(source, Mapping)
             else ((n, p.grad) for n, p in source.named_parameters()))
    return {n: g.detach().float().cpu().numpy() for n, g in items
            if g is not None}
