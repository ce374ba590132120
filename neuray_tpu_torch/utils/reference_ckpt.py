"""The reference NeuRay's PyTorch checkpoints read straight into the port
(the port's own copy of ``neuray_tpu/utils/torch_convert.py:
convert_gen_state_dict`` and ``neuray_tpu/utils/mvsnet_convert.py``,
in numpy and torch only).

The reference saves ``{"network_state_dict": ..., "step": ...}`` from its
``NeuralRayGenRenderer`` (``model_best.pth``); its cost-volume init net
holds MVSNet under ``init_net.mvsnet.*``, as pytorch-lightning's
``mvsnet_pl.ckpt`` holds it under ``model.*``. Both are PyTorch, so every
tensor keeps its layout (a Conv2d's [out, in, kh, kw], a Linear's
[out, in], a ConvTranspose3d's [in, out, k, k, k]): only the names change,
to the port's, which follow the JAX package's flax tree
(``utils/params.py``). The renames:
  * a ResNet layer's blocks ``layerN.{i}`` -> ``layerN.block{i}``, their
    ``downsample.0`` / ``.1`` -> ``down_conv`` / ``down_norm``;
  * an ``nn.Sequential`` MLP's Linear indices (0, 2, 4) -> ``fc0..fc2``,
    the agg net's ``prob_embed.0`` / ``.2`` -> ``prob_embed_0`` / ``_1``;
  * a residual block's ``conv.{0,2,3,5}`` -> ``norm1, conv1, norm2,
    conv2``; the vis encoder's ``out_conv.{0..3}`` -> ``conv_in, res0,
    res1, conv_out``; the depth init net's ``depth_skip.0`` / ``.2`` ->
    ``depth_skip_0`` / ``_1``; the cost-volume init net's three
    Sequentials ``{volume_conv2d, depth_conv, out_conv}.{0,1,2}`` ->
    ``{volume, depth, out}_{conv_in, res, conv_out}``;
  * MVSNet's BatchNorms keep ``weight`` / ``bias`` and their
    ``running_mean`` / ``running_var`` become the port's FrozenBN ``mean``
    / ``var``; its deconvs' ``convN.0`` / ``.1`` -> ``convN.conv`` /
    ``convN.bn``.
(The attention's ``w_qs``, ``w_ks``, ``w_vs`` keep their names: the port
keeps them as three Linears, as the reference does. The flax tree's
``Conv_0`` level inside a reflect-padded conv has no counterpart on
either side.)

Every mapping is recorded as a (reference key, port key, layout) triple,
the layout naming the tensor's kind (``conv2d``, ``conv3d``,
``deconv3d``, ``linear``, ``norm``, ``bn_stat``, ``bias``), each the same
tensor on both sides; ``reverse`` runs the renames backwards. Loads are
strict: a reference key that the mapper wants and the file lacks, a
reference key that fills nothing and a port parameter that no reference
key fills each raise, listing every such key.
"""
from __future__ import annotations

import pickle
import re
from typing import Any, Dict, List, Tuple

import torch

Record = List[Tuple[str, str, str]]


class _Mapper:
    """Reference state dict -> port state dict, one rename at a time,
    mirroring the JAX package's ``torch_convert._Mapper``; with
    ``reverse`` the same renames the other way (``sd`` a port state dict,
    whose keys then decide the optional leaves)."""

    def __init__(self, sd: Dict[str, torch.Tensor], reverse: bool = False):
        self.sd = sd
        self.reverse = reverse
        self.out: Dict[str, torch.Tensor] = {}
        self.record: Record = []
        self.missing: List[str] = []

    def take(self, ref_key: str, port_key: str, layout: str) -> None:
        src, dst = (port_key, ref_key) if self.reverse else (ref_key,
                                                             port_key)
        if src not in self.sd:
            self.missing.append(src)
            return
        self.out[dst] = self.sd[src]
        self.record.append((ref_key, port_key, layout))

    def has(self, ref_key: str, port_key: str) -> bool:
        return (port_key if self.reverse else ref_key) in self.sd

    # ---- leaves ----

    def conv(self, key, port, layout="conv2d"):
        self.take(f"{key}.weight", f"{port}.weight", layout)
        if self.has(f"{key}.bias", f"{port}.bias"):
            self.take(f"{key}.bias", f"{port}.bias", "bias")

    def lin(self, key, port):
        self.take(f"{key}.weight", f"{port}.weight", "linear")
        if self.has(f"{key}.bias", f"{port}.bias"):
            self.take(f"{key}.bias", f"{port}.bias", "bias")

    def norm(self, key, port):
        self.take(f"{key}.weight", f"{port}.weight", "norm")
        self.take(f"{key}.bias", f"{port}.bias", "bias")

    # ---- composite blocks ----

    def basic_block(self, key, port, has_down):
        self.conv(f"{key}.conv1", f"{port}.conv1")
        self.norm(f"{key}.bn1", f"{port}.bn1")
        self.conv(f"{key}.conv2", f"{port}.conv2")
        self.norm(f"{key}.bn2", f"{port}.bn2")
        if has_down:
            self.conv(f"{key}.downsample.0", f"{port}.down_conv")
            self.norm(f"{key}.downsample.1", f"{port}.down_norm")

    def res_layer(self, key, port, blocks):
        for i in range(blocks):
            has_down = i == 0 and self.has(
                f"{key}.{i}.downsample.0.weight",
                f"{port}.block{i}.down_conv.weight")
            self.basic_block(f"{key}.{i}", f"{port}.block{i}", has_down)

    def conv_elu(self, key, port):
        self.conv(f"{key}.conv", f"{port}.conv")
        self.norm(f"{key}.bn", f"{port}.bn")

    def resunet(self, key, port, layers):
        self.conv(f"{key}.conv1", f"{port}.conv1")
        self.norm(f"{key}.bn1", f"{port}.bn1")
        for i in range(3):
            self.res_layer(f"{key}.layer{i + 1}", f"{port}.layer{i + 1}",
                           layers[i])
        for name in ("upconv3", "upconv2"):
            self.conv_elu(f"{key}.{name}.conv", f"{port}.{name}.conv")
        for name in ("iconv3", "iconv2"):
            self.conv_elu(f"{key}.{name}", f"{port}.{name}")
        self.conv(f"{key}.out_conv", f"{port}.out_conv")

    def residual_block(self, key, port):
        self.norm(f"{key}.conv.0", f"{port}.norm1")
        self.conv(f"{key}.conv.2", f"{port}.conv1")
        self.norm(f"{key}.conv.3", f"{port}.norm2")
        self.conv(f"{key}.conv.5", f"{port}.conv2")
        if self.has(f"{key}.short_cut.weight", f"{port}.short_cut.weight"):
            self.conv(f"{key}.short_cut", f"{port}.short_cut")

    def mlp_head(self, key, port, ids=(0, 2, 4)):
        for i, li in enumerate(ids):
            self.lin(f"{key}.{li}", f"{port}.fc{i}")

    def dist_decoder(self, key, port, use_vis):
        for name in ("mean_decoder", "var_decoder", "aw_decoder") + (
                ("vis_decoder",) if use_vis else ()):
            self.mlp_head(f"{key}.{name}", f"{port}.{name}")

    def mha(self, key, port):
        for name in ("w_qs", "w_ks", "w_vs", "fc"):
            self.lin(f"{key}.{name}", f"{port}.{name}")
        self.norm(f"{key}.layer_norm", f"{port}.layer_norm")

    def ibrnet(self, key, port):
        for name in ("ray_dir_fc", "base_fc", "vis_fc", "vis_fc2",
                     "geometry_fc", "out_geometry_fc", "neuray_fc"):
            self.mlp_head(f"{key}.{name}", f"{port}.{name}", (0, 2))
        self.mha(f"{key}.ray_attention", f"{port}.ray_attention")
        self.mlp_head(f"{key}.rgb_fc", f"{port}.rgb_fc", (0, 2, 4))

    def agg_net(self, key, port):
        self.lin(f"{key}.prob_embed.0", f"{port}.prob_embed_0")
        self.lin(f"{key}.prob_embed.2", f"{port}.prob_embed_1")
        self.ibrnet(f"{key}.agg_impl", f"{port}.agg_impl")

    def vis_encoder(self, key, port):
        self.conv(f"{key}.out_conv.0", f"{port}.conv_in")
        self.residual_block(f"{key}.out_conv.1", f"{port}.res0")
        self.residual_block(f"{key}.out_conv.2", f"{port}.res1")
        self.conv(f"{key}.out_conv.3", f"{port}.conv_out")

    def depth_init_net(self, key, port):
        self.resunet(f"{key}.res_net", f"{port}.res_net", (2, 2, 2))
        self.conv(f"{key}.depth_skip.0", f"{port}.depth_skip_0")
        self.conv(f"{key}.depth_skip.2", f"{port}.depth_skip_1")
        self.conv(f"{key}.conv_out", f"{port}.conv_out")

    def cost_volume_init_net(self, key, port):
        """The reference's CostVolumeInitNet (reference init_net.py:
        205-254): ``mvsnet.*``, ``res_net`` (ResUNetLight (2, 3, 6, 3)) and
        three conv3x3 / ResidualBlock / conv1x1 Sequentials."""
        self.mvsnet(f"{key}.mvsnet", f"{port}.mvsnet")
        self.resunet(f"{key}.res_net", f"{port}.res_net", (2, 3, 6, 3))
        for ref_name, name in (("volume_conv2d", "volume"),
                               ("depth_conv", "depth"), ("out_conv", "out")):
            self.conv(f"{key}.{ref_name}.0", f"{port}.{name}_conv_in")
            self.residual_block(f"{key}.{ref_name}.1", f"{port}.{name}_res")
            self.conv(f"{key}.{ref_name}.2", f"{port}.{name}_conv_out")

    # ---- MVSNet (``neuray_tpu/utils/mvsnet_convert.py``'s keys) ----

    def bn(self, key, port):
        self.norm(key, port)
        self.take(f"{key}.running_mean", f"{port}.mean", "bn_stat")
        self.take(f"{key}.running_var", f"{port}.var", "bn_stat")

    def mvsnet(self, key, port):
        """MVSNet under the reference prefix ``key`` and the port prefix
        ``port`` ("" for MVSNet's own keys)."""
        def j(a, b):
            return f"{a}.{b}" if a else b

        for i in range(7):
            k, p = j(key, f"feature.conv{i}"), j(port, f"feature.conv{i}")
            self.conv(f"{k}.conv", f"{p}.conv")
            self.bn(f"{k}.bn", f"{p}.bn")
        self.conv(j(key, "feature.feature"), j(port, "feature.feature"))
        cr = j(key, "cost_regularization")
        pr = j(port, "cost_regularization")
        for i in range(7):
            self.conv(f"{cr}.conv{i}.conv", f"{pr}.conv{i}.conv", "conv3d")
            self.bn(f"{cr}.conv{i}.bn", f"{pr}.conv{i}.bn")
        for i in (7, 9, 11):
            self.conv(f"{cr}.conv{i}.0", f"{pr}.conv{i}.conv", "deconv3d")
            self.bn(f"{cr}.conv{i}.1", f"{pr}.conv{i}.bn")
        self.conv(f"{cr}.prob", f"{pr}.prob", "conv3d")


def _finish(m: _Mapper, what: str) -> Tuple[Dict[str, torch.Tensor], Record]:
    """Raise on reference keys the mapper wanted and did not find, and on
    reference keys that filled nothing; else (port state, record)."""
    side = "port" if m.reverse else "reference"
    used = {p if m.reverse else r for r, p, _ in m.record}
    extra = sorted(set(m.sd) - used)
    if m.missing or extra:
        raise KeyError(f"{what}: {side} keys missing {sorted(m.missing)}; "
                       f"{side} keys that fill nothing {extra}")
    return m.out, m.record


def convert_gen_state_dict(sd: Dict[str, torch.Tensor],
                           use_hierarchical: bool = True,
                           use_vis: bool = False,
                           fine_use_vis: bool = False,
                           init_net_type: str = "depth",
                           reverse: bool = False
                           ) -> Tuple[Dict[str, torch.Tensor], Record]:
    """A reference ``NeuralRayGenRenderer`` state dict -> (the port's
    ``NeurayRenderer`` state dict, the record of the mapping). The flags
    are the config's (``gen_flags``); ``init_net_type`` "" maps no init
    net (a finetuning net). ``reverse``: a port state dict -> (the
    reference state dict, the record), the inverse."""
    m = _Mapper(sd, reverse)
    m.resunet("image_encoder", "image_encoder", (1, 2, 6, 4))
    m.vis_encoder("vis_encoder", "vis_encoder")
    m.dist_decoder("dist_decoder", "dist_decoder", use_vis)
    m.agg_net("agg_net", "agg_net")
    if init_net_type == "depth":
        m.depth_init_net("init_net", "init_net")
    elif init_net_type == "cost_volume":
        m.cost_volume_init_net("init_net", "init_net")
    elif init_net_type:
        raise ValueError(f"unknown init_net_type {init_net_type!r}")
    if use_hierarchical:
        m.dist_decoder("fine_dist_decoder", "fine_dist_decoder",
                       fine_use_vis)
        m.agg_net("fine_agg_net", "fine_agg_net")
    return _finish(m, "NeuralRayGenRenderer state dict")


def convert_mvsnet_state_dict(sd: Dict[str, torch.Tensor],
                              port_prefix: str = ""
                              ) -> Tuple[Dict[str, torch.Tensor], Record]:
    """MVSNet's state dict (``feature.*``, ``cost_regularization.*``; a
    lightning checkpoint's keys without ``model.``) -> (the port's
    ``models/mvsnet.py: MVSNet`` state dict, its keys under
    ``port_prefix``, e.g. the renderer's ``init_net.mvsnet``; the
    record)."""
    m = _Mapper(sd)
    m.mvsnet("", port_prefix)
    return _finish(m, "MVSNet state dict")


def check_state(state: Dict[str, torch.Tensor],
                own: Dict[str, torch.Tensor]) -> None:
    """Raise unless ``state`` fills exactly the parameters of ``own`` (a
    module's state dict) with tensors of their shapes, listing each port
    parameter no reference key fills, each mapped key the module lacks
    and each shape that differs."""
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    shapes = sorted(f"{k}: {tuple(state[k].shape)} for {tuple(own[k].shape)}"
                    for k in set(own) & set(state)
                    if state[k].shape != own[k].shape)
    if missing or extra or shapes:
        raise KeyError(f"port parameters no reference key fills {missing}; "
                       f"mapped keys the port lacks {extra}; "
                       f"shapes that differ {shapes}")


def _load(path: str) -> Any:
    """``torch.load`` on the CPU with ``weights_only=True``. A file that
    pickles other objects (a lightning checkpoint's hyperparameters, say)
    is refused: the error names the file and the refused class."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        found = re.search(r"GLOBAL ([\w.]+)", str(e))
        cls = found.group(1) if found else "an object"
        raise pickle.UnpicklingError(
            f"{path}: torch.load(weights_only=True) refused {cls}. Only a "
            f"file you trust may be loaded with weights_only=False; re-save "
            f"its state dict from such a load with torch.save and convert "
            f"that file") from e


def read_reference_ckpt(path: str) -> Tuple[Dict[str, torch.Tensor], int]:
    """A reference checkpoint (``{"network_state_dict", "step"}``, or a
    bare state dict) -> (state dict of f32 tensors, step)."""
    ckpt = _load(path)
    sd = ckpt.get("network_state_dict", ckpt)
    step = int(ckpt.get("step", 0)) if "network_state_dict" in ckpt else 0
    return {k: v.float() for k, v in sd.items()}, step


def read_mvsnet_ckpt(path: str) -> Dict[str, torch.Tensor]:
    """A pytorch-lightning MVSNet checkpoint (``{"state_dict": {"model.*"}}``,
    or a bare state dict) -> the port's MVSNet state dict (its own keys,
    f32), as the JAX package's ``load_mvsnet_ckpt`` reads it."""
    ckpt = _load(path)
    sd = ckpt.get("state_dict", ckpt)
    sd = {k[len("model."):] if k.startswith("model.") else k: v.float()
          for k, v in sd.items()}
    return convert_mvsnet_state_dict(sd)[0]


def gen_flags(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The conversion's flags from a gen config, as
    ``tools/convert_reference_ckpt.py`` reads them."""
    dd = cfg.get("dist_decoder_cfg", {}) or {}
    fdd = cfg.get("fine_dist_decoder_cfg", {}) or {}
    return {"use_hierarchical": cfg.get("use_hierarchical_sampling", False),
            "use_vis": dd.get("use_vis", True),
            "fine_use_vis": fdd.get("use_vis", dd.get("use_vis", True)),
            "init_net_type": cfg.get("init_net_type", "depth")}
