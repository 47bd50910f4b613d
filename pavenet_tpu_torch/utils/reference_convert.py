"""Reference (mmdet / opera) PyTorch checkpoints -> the port's
``state_dict`` (as ``pavenet_tpu/utils/weight_convert.py``'s
``convert_{videopose,petr,soit,inspose}_state_dict`` and
``load_torch_checkpoint``,
dispatched by model as ``tools/dataset_converters/torch2flax.py``).

Both sides are PyTorch layouts, so the conversion is a table of rules, each
naming reference keys, port keys and one of five layout kinds:

- ``copy``: one tensor, unchanged (Linear, Conv, norms, BatchNorm
  statistics, embeddings, Swin's ``relative_position_bias_table``);
- ``split``: ``nn.MultiheadAttention``'s ``in_proj_weight`` (3C, C) and
  ``in_proj_bias`` into the port's ``query``, ``key`` and ``value``;
- ``cat``: the reference's per-frame offset and weight linears (``pre_``,
  now, ``next_``...) into the port's one fused Linear, frame-major along
  the output axis;
- ``perm``: Swin's ``PatchMerging``, whose ``nn.Unfold`` orders the 2x2
  neighbourhood channel-major where the port concatenates position-major:
  the reduction's input columns and the norm are permuted;
- ``dcn``: InsPose's star ``DeformConv2d`` weight (o, i, 3, 3) as the
  port's ``Linear(9i, o)`` over tap-major, channel-minor patches
  (``models/detectors/inspose.py::DeformConvGN``): (o, 9i).

The table follows the JAX converter key for key, with what it reads
whatever the model (``reference_rules``): the video tree reads
``bbox_head.fc_hm`` and the three RealNVP flows, PETR's the heatmap
encoder and ``fc_hm``; where the model lacks such a subtree (``TRAIN_ONLY``)
its converted keys are dropped, as flax ignores them. PETR's reference
tree has no sigma branches and no flows: those keys keep the model's own
init, as the JAX converter's ``init_params``. JAX refuses a video tree
with a Swin or HRNet backbone, and so does the port. ``strict`` refuses
reference keys that no rule reads (``num_batches_tracked`` aside, and for
the video tree mmcv's ``.mask`` and ``prior`` buffers), and the unused
keys are returned either way.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..models.backbones.hrnet import HRNET_EXTRA
from ..models.backbones.resnet import ARCH_SETTINGS
from ..models.detectors.inspose import InsPoseDetector
from ..models.detectors.soit import SOITDetector
from ..models.detectors.videopose import VideoPoseDetector
from .weight_convert import TRAIN_ONLY

Rule = collections.namedtuple("Rule", "kind refs ports arg")


class _Rules:
    """The rule table of one model under construction. ``has(port_key)``
    answers the JAX converter's ``sd.has`` (a downsample branch, an HRNet
    transition) from the model's own state dict ``own``."""

    def __init__(self, own: Mapping[str, torch.Tensor]):
        self.own = own
        self.rules: List[Rule] = []

    def has(self, port_key: str) -> bool:
        return port_key in self.own

    def add(self, kind, refs, ports, arg=None):
        self.rules.append(Rule(kind, tuple(refs), tuple(ports), arg))

    def copy(self, ref, port, names=("weight", "bias")):
        for n in names:
            self.add("copy", [f"{ref}.{n}"], [f"{port}.{n}"])

    def bn(self, ref, port):
        self.copy(ref, port, ("weight", "bias", "running_mean",
                              "running_var"))

    def conv(self, ref, port):
        self.copy(ref, port, ("weight",))

    def mha(self, ref, port):
        out = f"{port}.MultiHeadDotProductAttention_0"
        for n in ("weight", "bias"):
            self.add("split", [f"{ref}.attn.in_proj_{n}"],
                     [f"{out}.{p}.{n}" for p in ("query", "key", "value")])
        self.copy(f"{ref}.attn.out_proj", f"{out}.out")

    def fused(self, refs, port):
        for n in ("weight", "bias"):
            self.add("cat", [f"{r}.{n}" for r in refs], [f"{port}.{n}"])

    def mlp(self, ref, port, idxs):
        for i, t in enumerate(idxs):
            self.copy(f"{ref}.{t}", f"{port}.Dense_{i}")

    def sigma_branch(self, ref, port, num_fcs=2):
        for i in range(num_fcs):
            self.copy(f"{ref}.{i}", f"{port}.Dense_{i}")
        self.copy(f"{ref}.{num_fcs}.linear", f"{port}.Dense_{num_fcs}")

    def flow(self, ref, port):
        for i in range(6):
            for st in ("s", "t"):
                for j in range(3):
                    self.copy(f"{ref}.{st}.{i}.{2 * j}",
                              f"{port}.{st}{i}.Dense_{j}")

    def ffn(self, ref, port):
        self.copy(f"{ref}.layers.0.0", f"{port}.Dense_0")
        self.copy(f"{ref}.layers.1", f"{port}.Dense_1")

    def deform_attn(self, ref, port, multi_frame=False, num_frames=3):
        self.copy(f"{ref}.value_proj", f"{port}.value_proj")
        self.copy(f"{ref}.output_proj", f"{port}.output_proj")
        if not multi_frame:
            self.copy(f"{ref}.sampling_offsets", f"{port}.sampling_offsets")
            self.copy(f"{ref}.attention_weights",
                      f"{port}.attention_weights")
            return
        # frame order: pre..., now, next...
        frames = {3: ("pre_", "", "next_"),
                  5: ("pre_pre_", "pre_", "", "next_", "next_next_")}
        if num_frames not in frames:
            raise ValueError(f"no per-frame layout for {num_frames} frames")
        for name in ("sampling_offsets", "attention_weights"):
            self.fused([f"{ref}.{f}{name}" for f in frames[num_frames]],
                       f"{port}.{name}")

    def enc_layer(self, ref, port):
        self.deform_attn(f"{ref}.attentions.0", f"{port}.attn")
        self.copy(f"{ref}.norms.0", f"{port}.norm1")
        self.ffn(f"{ref}.ffns.0", f"{port}.ffn")
        self.copy(f"{ref}.norms.1", f"{port}.norm2")

    def dec_layer(self, ref, head, i, prefix, multi_frame, num_frames=3):
        """A pose decoder (``dec``) or joint decoder (``ref``) layer of the
        head whose keys start with ``head`` ('' or 'head.')."""
        p = f"{head}{prefix}"
        self.mha(f"{ref}.attentions.0", f"{p}_self_attn{i}")
        self.deform_attn(f"{ref}.attentions.1", f"{p}_cross_attn{i}",
                         multi_frame, num_frames)
        for j in (1, 2, 3):
            self.copy(f"{ref}.norms.{j - 1}", f"{p}_norm{j}_{i}")
        self.ffn(f"{ref}.ffns.0", f"{p}_ffn{i}")


def _resnet(r: _Rules, depth: int):
    block, stage_blocks = ARCH_SETTINGS[depth]
    r.conv("backbone.conv1", "backbone.conv1")
    r.bn("backbone.bn1", "backbone.bn1")
    n_convs = 3 if block == "bottleneck" else 2
    for s, blocks in enumerate(stage_blocks):
        for i in range(blocks):
            tp = f"backbone.layer{s + 1}.{i}"
            name = f"backbone.layer{s + 1}_{i}"
            for c in range(1, n_convs + 1):
                r.conv(f"{tp}.conv{c}", f"{name}.conv{c}")
                r.bn(f"{tp}.bn{c}", f"{name}.bn{c}")
            if r.has(f"{name}.downsample_conv.weight"):
                r.conv(f"{tp}.downsample.0", f"{name}.downsample_conv")
                r.bn(f"{tp}.downsample.1", f"{name}.downsample_bn")


def _hrnet(r: _Rules, width: int):
    """mmdet's HRNet: stem conv1/bn1 + conv2/bn2, the Bottleneck layer1,
    ``transition{n}`` Sequentials, per-module branches and fuse layers."""
    extra = HRNET_EXTRA[width]
    for n in (1, 2):
        r.conv(f"backbone.conv{n}", f"backbone.stem{n}.conv")
        r.bn(f"backbone.bn{n}", f"backbone.stem{n}.bn")
    _, _, (n1,), _ = extra[0]
    for k in range(n1):
        tp, name = f"backbone.layer1.{k}", f"backbone.layer1_{k}"
        for c in (1, 2, 3):
            r.conv(f"{tp}.conv{c}", f"{name}.conv{c}")
            r.bn(f"{tp}.bn{c}", f"{name}.bn{c}")
        if r.has(f"{name}.downsample_conv.weight"):
            r.conv(f"{tp}.downsample.0", f"{name}.downsample_conv")
            r.bn(f"{tp}.downsample.1", f"{name}.downsample_bn")
    prev = 1
    for s, (_, num_modules, num_blocks, channels) in enumerate(extra[1:],
                                                                start=2):
        tname = f"backbone.transition{s - 1}"
        for b in range(len(channels)):
            # a channel-adapting conv, or a new branch's downsample
            tp = f"{tname}.{b}" if b < prev else f"{tname}.{b}.0"
            port = f"backbone.transition{s - 1}_{b}"
            if r.has(f"{port}.conv.weight"):
                r.conv(f"{tp}.0", f"{port}.conv")
                r.bn(f"{tp}.1", f"{port}.bn")
        prev = len(channels)
        for m in range(num_modules):
            base = f"backbone.stage{s}.{m}"
            port = f"backbone.stage{s}_module{m}"
            for b in range(len(channels)):
                for k in range(num_blocks[b]):
                    tp = f"{base}.branches.{b}.{k}"
                    for c in (1, 2):
                        r.conv(f"{tp}.conv{c}",
                               f"{port}.branch{b}_block{k}.conv{c}")
                        r.bn(f"{tp}.bn{c}", f"{port}.branch{b}_block{k}.bn{c}")
            for i in range(len(channels)):
                for j in range(len(channels)):
                    fp = f"{base}.fuse_layers.{i}.{j}"
                    if j > i:
                        r.conv(f"{fp}.0", f"{port}.fuse{i}_{j}_conv")
                        r.bn(f"{fp}.1", f"{port}.fuse{i}_{j}_bn")
                    for t in range(i - j):
                        r.conv(f"{fp}.{t}.0", f"{port}.fuse{i}_{j}_down{t}.conv")
                        r.bn(f"{fp}.{t}.1", f"{port}.fuse{i}_{j}_down{t}.bn")


def _swin(r: _Rules, depths, out_indices):
    """mmdet's SwinTransformer: attention under ``attn.w_msa``, the FFN
    under ``ffn.layers``, output norms ``norm{i}``."""
    r.copy("backbone.patch_embed.projection", "backbone.patch_embed")
    r.copy("backbone.patch_embed.norm", "backbone.patch_norm")
    for s, depth in enumerate(depths):
        for b in range(depth):
            tp, port = (f"backbone.stages.{s}.blocks.{b}",
                        f"backbone.stage{s}_block{b}")
            r.copy(f"{tp}.norm1", f"{port}.norm1")
            r.copy(f"{tp}.attn.w_msa.qkv", f"{port}.attn.qkv")
            r.copy(f"{tp}.attn.w_msa.proj", f"{port}.attn.proj")
            r.copy(f"{tp}.attn.w_msa", f"{port}.attn",
                   ("relative_position_bias_table",))
            r.copy(f"{tp}.norm2", f"{port}.norm2")
            r.copy(f"{tp}.ffn.layers.0.0", f"{port}.fc1")
            r.copy(f"{tp}.ffn.layers.1", f"{port}.fc2")
        if s < len(depths) - 1:
            tp, port = f"backbone.stages.{s}.downsample", f"backbone.merge{s}"
            cin = r.own[f"{port}.reduction.weight"].shape[1] // 4
            # the port's position p in [ee, oe, eo, oo] is the unfold's
            # row-major position q_of_p[p]
            q_of_p = (0, 2, 1, 3)
            perm = np.array([c * 4 + q_of_p[p]
                             for p in range(4) for c in range(cin)])
            r.add("perm", [f"{tp}.reduction.weight"],
                  [f"{port}.reduction.weight"], (perm, 1))
            for n in ("weight", "bias"):
                r.add("perm", [f"{tp}.norm.{n}"], [f"{port}.norm.{n}"],
                      (perm, 0))
    for i in out_indices:
        r.copy(f"backbone.norm{i}", f"backbone.out_norm{i}")


def _neck(r: _Rules, num_ins=3, num_outs=4, port="neck"):
    for i in range(num_ins):
        r.conv(f"neck.convs.{i}.conv", f"{port}.conv{i}")
        r.copy(f"neck.convs.{i}.gn", f"{port}.gn{i}")
    for j in range(num_outs - num_ins):
        r.conv(f"neck.extra_convs.{j}.conv", f"{port}.extra_conv{j}")
        r.copy(f"neck.extra_convs.{j}.gn", f"{port}.extra_gn{j}")


TFM = "bbox_head.transformer"


def _head_common(r: _Rules, h: str):
    r.add("copy", [f"{TFM}.level_embeds"], [f"{h}level_embeds"])
    r.copy(f"{TFM}.enc_output", f"{h}enc_output")
    r.copy(f"{TFM}.enc_output_norm", f"{h}enc_output_norm")


def _videopose_rules(r: _Rules, model: VideoPoseDetector):
    """``convert_videopose_state_dict``: a ResNet video PAVE-Net."""
    head = model.head
    T = model.num_frames
    _resnet(r, model.backbone.depth)
    _neck(r)
    _head_common(r, "head.")
    r.add("copy", ["bbox_head.query_embedding.weight"],
          ["head.query_embedding"])
    r.add("copy", [f"{TFM}.refine_query_embedding.weight"],
          ["head.refine_query_embedding"])
    for i in range(head.num_encoder_layers):
        r.enc_layer(f"{TFM}.encoder.layers.{i}", f"head.encoder_layer{i}")
    for i in range(head.num_decoder_layers):
        r.dec_layer(f"{TFM}.decoder.layers.{i}", "head.", i, "dec", True, T)
    mlp_idx = (0, 2, 4, 6)
    for i in range(head.num_decoder_layers + 1):
        r.copy(f"bbox_head.cls_branches.{i}", f"head.cls_branch{i}")
        r.mlp(f"bbox_head.kpt_branches.{i}", f"head.kpt_branch{i}", mlp_idx)
        r.sigma_branch(f"bbox_head.dec_fc_sigma_branches.{i}",
                       f"head.sigma_branch{i}")
    aux_names = (["pre_kpt_branches", "next_kpt_branches"] if T == 3 else
                 ["pre_pre_kpt_branches", "pre_kpt_branches",
                  "next_kpt_branches", "next_next_kpt_branches"])
    for f, aux in enumerate(aux_names):
        for i in range(head.num_decoder_layers):
            r.mlp(f"bbox_head.{aux}.{i}", f"head.aux_kpt_branch_f{f}_l{i}",
                  mlp_idx)
    for i in range(head.num_refine_layers):
        r.dec_layer(f"{TFM}.refine_decoder.layers.{i}", "head.", i, "ref",
                    True, T)
    refine_names = {3: ("pre_refine_kpt_branches", "refine_kpt_branches",
                        "next_refine_kpt_branches"),
                    5: ("pre_pre_refine_kpt_branches",
                        "pre_refine_kpt_branches", "refine_kpt_branches",
                        "next_refine_kpt_branches",
                        "next_next_refine_kpt_branches")}[T]
    for t in range(T):
        for i in range(head.num_refine_layers):
            r.mlp(f"bbox_head.{refine_names[t]}.{i}",
                  f"head.refine_kpt_branch_f{t}_l{i}", (0, 2, 4))
    for i in range(head.num_refine_layers):
        r.sigma_branch(f"bbox_head.refine_fc_sigma_branches.{i}",
                       f"head.refine_sigma_branch{i}")
    r.copy("bbox_head.fc_hm", "head.fc_hm")
    for flow in ("enc_flow", "dec_flow", "flow"):
        r.flow(f"bbox_head.{flow}", f"head.{flow}")


def _petr_rules(r: _Rules, model: VideoPoseDetector):
    """``convert_petr_state_dict``: single-frame PETR with a ResNet, HRNet
    or Swin; no sigma branches, flows or aux-frame branches, and an active
    heatmap encoder."""
    head = model.head
    if model.backbone_type == "swin":
        _swin(r, model.backbone.depths, model.backbone.out_indices)
    elif model.backbone_type == "hrnet":
        _hrnet(r, model.backbone.width)
    else:
        _resnet(r, model.backbone.depth)
    _neck(r)
    _head_common(r, "head.")
    r.add("copy", ["bbox_head.query_embedding.weight"],
          ["head.query_embedding"])
    r.add("copy", [f"{TFM}.refine_query_embedding.weight"],
          ["head.refine_query_embedding"])
    for i in range(head.num_encoder_layers):
        r.enc_layer(f"{TFM}.encoder.layers.{i}", f"head.encoder_layer{i}")
    r.enc_layer(f"{TFM}.hm_encoder.layers.0", "head.hm_encoder_layer")
    for i in range(head.num_decoder_layers):
        r.dec_layer(f"{TFM}.decoder.layers.{i}", "head.", i, "dec", False)
    for i in range(head.num_decoder_layers + 1):
        r.copy(f"bbox_head.cls_branches.{i}", f"head.cls_branch{i}")
        r.mlp(f"bbox_head.kpt_branches.{i}", f"head.kpt_branch{i}",
              (0, 2, 4, 6))
    for i in range(head.num_refine_layers):
        r.dec_layer(f"{TFM}.refine_decoder.layers.{i}", "head.", i, "ref",
                    False)
        r.mlp(f"bbox_head.refine_kpt_branches.{i}",
              f"head.refine_kpt_branch_f0_l{i}", (0, 2, 4))
    r.copy("bbox_head.fc_hm", "head.fc_hm")


def _soit_rules(r: _Rules, model: SOITDetector):
    """``convert_soit_state_dict``: SOIT, and DK-DETR, whose tree is the
    same with embedding-sized class branches."""
    _resnet(r, model.backbone.depth)
    _neck(r)
    _head_common(r, "")
    for name in ("pos_trans", "pos_trans_norm", "mask_trans",
                 "mask_trans_norm"):
        r.copy(f"{TFM}.{name}", name)
    for i in range(model.num_encoder_layers):
        r.enc_layer(f"{TFM}.encoder.layers.{i}", f"encoder_layer{i}")
    r.enc_layer(f"{TFM}.seg_encoder.layers.0", "seg_encoder_layer")
    for i in range(model.num_decoder_layers):
        r.dec_layer(f"{TFM}.decoder.layers.{i}", "", i, "dec", False)
    for i in range(model.num_decoder_layers + 1):
        r.copy(f"bbox_head.cls_branches.{i}", f"cls_branch{i}")
        r.mlp(f"bbox_head.reg_branches.{i}", f"reg_branch{i}", (0, 2, 4))
        if i < model.num_decoder_layers:
            r.mlp(f"bbox_head.seg_branches.{i}", f"seg_branch{i}",
                  (0, 2, 4))


def _inspose_rules(r: _Rules, model: InsPoseDetector):
    """``convert_inspose_state_dict``: mmdet's FPN (``lateral_convs``,
    ``fpn_convs`` with the extra convolutions at its tail) and the head's
    ConvModule towers, heads and star DeformConv2d + GroupNorm pairs."""
    _resnet(r, model.backbone.depth)
    neck = model.neck
    for i in range(neck.num_levels):
        r.copy(f"neck.lateral_convs.{i}.conv", f"neck.lateral{i}")
        r.copy(f"neck.fpn_convs.{i}.conv", f"neck.fpn{i}")
    for j in range(neck.num_extra):
        r.copy(f"neck.fpn_convs.{neck.num_levels + j}.conv",
               f"neck.fpn_extra{j}")
    bh = "bbox_head"

    def convgn(ref, port):
        r.conv(f"{ref}.conv", f"{port}.Conv_0")
        r.copy(f"{ref}.gn", f"{port}.GroupNorm_0")

    for i in range(model.stacked_convs):
        convgn(f"{bh}.cls_convs.{i}", f"cls_tower{i}")
        convgn(f"{bh}.ctrl_convs.{i}", f"ctrl_tower{i}")
    for i in range(model.stacked_convs_kpt):
        convgn(f"{bh}.kpt_convs.{i}", f"kpt_tower{i}")
    for i in range(4):
        convgn(f"{bh}.shared_convs.{i}", f"shared_tower{i}")
    convgn(f"{bh}.shared_convs.4", "shared_out")
    for name in ("conv_cls", "controller", "kpt_offset"):
        r.copy(f"{bh}.{name}", name)
    for name in ("cls_star", "ctr_star"):
        r.add("dcn", [f"{bh}.{name}_conv.weight"], [f"{name}.kernel.weight"])
        r.copy(f"{bh}.{name}_gn", f"{name}.GroupNorm_0")
    if model.with_hm:
        for i in range(model.stacked_convs_hm):
            convgn(f"{bh}.hm_convs.{i}", f"hm_tower{i}")
        for name in ("hm_pred", "ae_pred", "hm_offset"):
            r.copy(f"{bh}.{name}", name)


def _video_ignored(key: str) -> bool:
    return ".mask" in key or "prior" in key


def reference_rules(model: nn.Module) -> Tuple[List[Rule],
                                               Callable[[str], bool]]:
    """The rule table of ``model`` and the predicate of the reference keys
    that ``strict`` ignores besides ``num_batches_tracked``. Raises
    ``ValueError`` where the JAX converter has no tree (a video model with
    a Swin or HRNet backbone)."""
    r = _Rules(model.state_dict())
    if isinstance(model, SOITDetector):
        _soit_rules(r, model)
        return r.rules, lambda k: False
    if isinstance(model, InsPoseDetector):
        _inspose_rules(r, model)
        return r.rules, lambda k: False
    if not isinstance(model, VideoPoseDetector):
        raise ValueError(f"no reference converter for "
                         f"{type(model).__name__}")
    if model.num_frames == 1:
        _petr_rules(r, model)
        return r.rules, lambda k: False
    if model.backbone_type != "resnet":
        raise ValueError(
            f"the video converter takes ResNet trees, as the JAX one; got "
            f"backbone_type={model.backbone_type!r}")
    _videopose_rules(r, model)
    return r.rules, _video_ignored


def _apply(rule: Rule, arrays: List[torch.Tensor]) -> List[torch.Tensor]:
    if rule.kind == "copy":
        return arrays
    if rule.kind == "cat":
        return [torch.cat(arrays, 0)]
    if rule.kind == "split":
        return list(arrays[0].chunk(len(rule.ports), 0))
    if rule.kind == "perm":
        perm, axis = rule.arg
        return [arrays[0].index_select(axis, torch.as_tensor(perm))]
    if rule.kind == "dcn":
        w = arrays[0]
        return [w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)]
    raise KeyError(rule.kind)


def _tensor(v) -> torch.Tensor:
    t = v.detach() if torch.is_tensor(v) else torch.from_numpy(
        np.asarray(v))
    return t.to(torch.float32).contiguous()


def convert_reference_state_dict(model: nn.Module,
                                 state_dict: Mapping,
                                 strict: bool = False
                                 ) -> Tuple[Dict[str, torch.Tensor],
                                            List[str]]:
    """A reference state dict (tensors or numpy arrays) -> (the port's
    converted entries, float32, and the sorted reference keys no rule
    read). A key a rule needs and the reference lacks raises ``KeyError``,
    as does any unused key under ``strict``."""
    rules, ignored = reference_rules(model)
    out: Dict[str, torch.Tensor] = {}
    used = set()
    for rule in rules:
        missing = [k for k in rule.refs if k not in state_dict]
        if missing:
            raise KeyError(f"reference checkpoint lacks {missing}")
        used.update(rule.refs)
        arrays = [_tensor(state_dict[k]) for k in rule.refs]
        for port, t in zip(rule.ports, _apply(rule, arrays)):
            out[port] = t.contiguous()
    unused = sorted(k for k in state_dict if k not in used
                    and not k.endswith("num_batches_tracked")
                    and not ignored(k))
    if strict and unused:
        raise KeyError(f"unconverted reference params: {unused[:20]}")
    return out, unused


def keeps_own_init(model: nn.Module) -> bool:
    """Whether the model's keys that the reference tree lacks keep the
    model's own init (PETR: sigma branches, flows), as the JAX converter's
    ``init_params``."""
    return isinstance(model, VideoPoseDetector) and model.num_frames == 1


def load_reference_state_dict(model: nn.Module, state_dict: Mapping,
                              strict: bool = False) -> List[str]:
    """Convert ``state_dict`` and load it into ``model``; returns the unused
    reference keys. Converted keys the model lacks are dropped where they
    are a ``TRAIN_ONLY`` subtree (the heatmap branch, the flows) and raise
    elsewhere; model keys the reference lacks raise, except PETR's
    (``keeps_own_init``)."""
    converted, unused = convert_reference_state_dict(model, state_dict,
                                                     strict)
    own = model.state_dict()

    def train_only(key):
        return any(f".{f}." in f".{key}" for f in TRAIN_ONLY)

    extra = [k for k in converted if k not in own and not train_only(k)]
    missing = ([] if keeps_own_init(model)
               else [k for k in own if k not in converted])
    if extra or missing:
        raise KeyError(f"reference checkpoint does not fit the model: "
                       f"missing {missing[:20]}, unexpected {extra[:20]}")
    model.load_state_dict({k: v for k, v in converted.items() if k in own},
                          strict=False)
    return unused


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` as a flat state dict on the CPU (its
    ``state_dict`` entry where it has one; DDP's ``module.`` prefixes
    stripped), read with ``torch.load(weights_only=True)``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k[7:] if k.startswith("module.") else k: v
            for k, v in sd.items()}
