"""Weights: the flat-npz format of ``neuray_tpu/utils/params_io.py``
read and written with numpy alone, and the bridge from the flax
parameter tree to a PyTorch ``state_dict`` and back (``torch_to_flax``:
port gradients and checkpoints as flax trees).

The port names its submodules after the flax tree
(``image_encoder.layer1.block0.conv1``...), so each leaf maps by one
rule per leaf kind:
  * a conv kernel [kh, kw, in, out] becomes ``weight`` [out, in, kh, kw];
  * a 3-D kernel [kd, kh, kw, a, b] becomes ``weight`` [b, a, kd, kh, kw]:
    a Conv3d's [kd, kh, kw, in, out] becomes its [out, in, kd, kh, kw],
    and a ConvTranspose3d's (flax's ``transpose_kernel`` layout [kd, kh,
    kw, out, in], ``neuray_tpu/utils/mvsnet_convert.py``) becomes its
    [in, out, kd, kh, kw], with no flip: one permutation serves both;
  * a dense kernel [in, out] becomes a Linear ``weight`` [out, in];
  * an InstanceNorm / LayerNorm / FrozenBN ``scale`` becomes ``weight``;
  * ``bias`` stays ``bias``, and a FrozenBN's ``mean`` and ``var`` stay
    (the port keeps them as parameters that take no gradient);
  * flax's ``Conv_0`` level inside a ``ReflectConv`` is dropped (the
    port's ``ReflectConv`` is itself the conv).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn


def load_params_npz(path: str, dtype=np.float32) -> Dict[str, Any]:
    """Rebuild the nested-dict tree from a flat npz whose keys are
    '/'-joined tree paths; float arrays are cast to ``dtype``."""
    with np.load(path) as z:
        tree: Dict[str, Any] = {}
        for key in z.files:
            arr = z[key]
            if dtype is not None and np.issubdtype(arr.dtype, np.floating):
                arr = arr.astype(dtype)
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = arr
    return tree


def save_params_npz(path: str, tree: Dict[str, Any],
                    dtype=np.float16) -> None:
    """Write a nested-dict tree as the flat npz ``load_params_npz`` (and
    the JAX package's) reads: one entry a leaf keyed by its '/'-joined
    path, f32 leaves stored as ``dtype`` (f16, as the JAX package's
    ``save_params_npz`` stores them)."""
    flat = {}
    for keys, arr in _leaves(tree):
        arr = np.asarray(arr)
        if dtype is not None and arr.dtype == np.float32:
            arr = arr.astype(dtype)
        flat["/".join(keys)] = arr
    np.savez_compressed(path, **flat)


def _leaves(tree: Dict[str, Any], prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_to_torch(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax parameter tree (optionally under a top-level ``params``) ->
    state_dict of f32 CPU tensors. Raises on a leaf kind it does not
    know and on two leaves that map to one key."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    state: Dict[str, torch.Tensor] = {}
    for path, arr in _leaves(tree):
        *mods, leaf = [p for p in path if p != "Conv_0"]
        arr = np.array(arr, np.float32)                 # own, writable
        if leaf == "kernel" and arr.ndim == 4:
            name, arr = "weight", arr.transpose(3, 2, 0, 1)
        elif leaf == "kernel" and arr.ndim == 5:
            name, arr = "weight", arr.transpose(4, 3, 0, 1, 2)
        elif leaf == "kernel" and arr.ndim == 2:
            name, arr = "weight", arr.T
        elif leaf == "scale" and arr.ndim == 1:
            name = "weight"
        elif leaf in ("bias", "mean", "var") and arr.ndim == 1:
            name = leaf
        else:
            raise ValueError(f"unknown leaf {'/'.join(path)} "
                             f"with shape {arr.shape}")
        key = ".".join([*mods, name])
        if key in state:
            raise ValueError(f"two flax leaves map to {key}")
        state[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return state


def torch_to_flax(module: nn.Module,
                  tensors: Dict[str, torch.Tensor] | None = None
                  ) -> Dict[str, Any]:
    """The inverse of ``flax_to_torch`` for ``module``: tensors keyed as
    its parameters (default: the parameters themselves; or, say, their
    gradients) -> ``{"params": tree}`` of f32 numpy arrays in the flax
    layout. The owning submodule gives each leaf's kind: a conv weight
    becomes ``kernel`` [kh, kw, in, out], a 3-D (transposed) conv's
    [kd, kh, kw, a, b], a ``ReflectConv``'s leaves go under ``Conv_0``, a
    Linear weight becomes ``kernel`` [in, out], any other ``weight`` (a
    norm's) ``scale``."""
    from neuray_tpu_torch.models.blocks import ReflectConv
    tree: Dict[str, Any] = {}
    for mod_name, mod in module.named_modules():
        for leaf, param in mod.named_parameters(recurse=False):
            key = f"{mod_name}.{leaf}" if mod_name else leaf
            arr = (param if tensors is None else tensors[key])
            arr = arr.detach().cpu().float().numpy()
            path = mod_name.split(".") if mod_name else []
            if isinstance(mod, nn.Conv2d):
                if leaf == "weight":
                    leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)
                if isinstance(mod, ReflectConv):
                    path.append("Conv_0")
            elif isinstance(mod, (nn.Conv3d, nn.ConvTranspose3d)):
                if leaf == "weight":
                    leaf, arr = "kernel", arr.transpose(2, 3, 4, 1, 0)
            elif leaf == "weight":
                leaf, arr = (("kernel", arr.T) if isinstance(mod, nn.Linear)
                             else ("scale", arr))
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = np.ascontiguousarray(arr)
    return {"params": tree}


def init_like_flax(module: nn.Module) -> None:
    """Re-draw ``module``'s parameters, in place from torch's default
    generator, from the distributions the JAX package's flax modules
    initialize them with: every conv (2-D, 3-D and transposed 3-D) and
    dense kernel from a normal truncated at two deviations with variance
    scale / fan_in (flax's ``variance_scaling`` "truncated_normal"; a
    transposed kernel's fan_in counts its out channels, as flax's
    ``transpose_kernel`` layout puts them second to last), scale 2
    (``he_normal``) in the aggregation net's dense chains and 1
    (``lecun_normal``, flax's default) elsewhere; biases 0, norm scales 1,
    a FrozenBN's mean 0 and var 1. (PyTorch's own defaults
    draw biases too and leave the fine aggregation net's ReLU density
    dead at init on the synthetic scene.)"""
    from neuray_tpu_torch.models.ibrnet import _Seq, _SplitSeq
    he = {id(m) for seq in module.modules() if isinstance(seq, (_Seq,
                                                                _SplitSeq))
          for m in seq.modules()}
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d,
                                nn.Linear)):
                w = mod.weight
                fan_in = w[0].numel()
                std = np.sqrt((2.0 if id(mod) in he else 1.0) / fan_in
                              ) / 0.87962566103423978
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif hasattr(mod, "weight") and isinstance(mod.weight,
                                                       nn.Parameter):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                if hasattr(mod, "var"):
                    mod.mean.zero_()
                    mod.var.fill_(1.0)


def load_flax_params(module: nn.Module, tree: Dict[str, Any]) -> None:
    """Load a flax tree into ``module`` in place. Raises if a leaf is
    left over, a parameter is missing, or a shape differs."""
    state = flax_to_torch(tree)
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise ValueError(f"weight bridge mismatch: missing {missing}, "
                         f"left over {extra}")
    module.load_state_dict(state, strict=True)


# ---------------- finetuning's tree ----------------
# The JAX package's FT parameters are {"net": {"params": <the renderer's
# tree, no init_net>}, "ray_feats": [N, fh, fw, c]}; the port's FT state
# (``models/ft.py: FtRenderer``) is its renderer ``net`` and the one
# parameter ``ray_feats`` [N, fh, fw, c], keyed ``net.<leaf>`` and
# ``ray_feats`` in its state_dict.

def ft_flax_to_torch(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX FT tree -> the port's FT state_dict (f32 CPU tensors)."""
    state = {f"net.{k}": v for k, v in flax_to_torch(tree["net"]).items()}
    state["ray_feats"] = torch.from_numpy(
        np.array(tree["ray_feats"], np.float32))
    return state


def ft_torch_to_flax(ft: nn.Module,
                     tensors: Dict[str, torch.Tensor] | None = None
                     ) -> Dict[str, Any]:
    """The inverse of ``ft_flax_to_torch`` for an FT module (``net`` and
    ``ray_feats``): tensors keyed as its parameters (default: the
    parameters; or, say, their gradients) -> the JAX FT tree of f32
    numpy arrays."""
    named = dict(ft.named_parameters())
    tensors = named if tensors is None else tensors
    net = {k[len("net."):]: v for k, v in tensors.items()
           if k.startswith("net.")}
    return {"net": torch_to_flax(ft.net, net),
            "ray_feats": tensors["ray_feats"].detach().cpu().float().numpy()}


def load_ft_flax_params(ft: nn.Module, tree: Dict[str, Any]) -> None:
    """Load a JAX FT tree into an FT module in place: the net by
    ``load_flax_params`` (an ``init_net`` leaf is left over and raises)
    and ``ray_feats`` by ``ft.set_ray_feats``."""
    load_flax_params(ft.net, tree["net"])
    ft.set_ray_feats(torch.from_numpy(np.array(tree["ray_feats"],
                                               np.float32)))
