"""Carry weights, gradients and optimizer-visible names between the JAX
package and the port.

``from_jax_params`` turns a flax ``VisionMamba``, ``MaskedAutoencoderVim``
or ``ChannelVisionMamba`` parameter tree (nested mappings of array-likes,
with or without the top-level ``"params"``) into the port's
``state_dict`` as numpy arrays, under the torch reference's names, and
raises on a leaf it does not know rather than drop it. A gradient tree from ``jax.grad`` has the parameters' structure,
so the same function maps it onto the port's names, and so it does any
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
    """flax VisionMamba or MaskedAutoencoderVim params → the port's
    state_dict (numpy arrays); load with ``{k: torch.from_numpy(v.copy())
    for k, v in ...}``."""
    p = params.get("params", params)
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
    of :func:`from_jax_params`."""
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


def grads_to_numpy(source) -> Dict[str, np.ndarray]:
    """A model's ``.grad``s, or a name → gradient tensor mapping, as
    ``{name: float32 numpy array}`` under the port's names."""
    items = (source.items() if isinstance(source, Mapping)
             else ((n, p.grad) for n, p in source.named_parameters()))
    return {n: g.detach().float().cpu().numpy() for n, g in items
            if g is not None}
