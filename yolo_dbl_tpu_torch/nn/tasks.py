"""YAML → model compiler and the detection model (port of yolo_dbl_tpu/nn/tasks.py).

Only the branches that the YOLOv13/DBL family (`cfg/models/v13/`), the
detect families' rows (v3, v5, v6, v7, v8, v9, v10, 11, v12), the
segment, pose, OBB and classify heads, the `-cls-resnet` trunks
(ResNetLayer, TorchVision), the module pools' rows that FFCA-YOLO{,-L},
YOLO-EMAC, yolo11-C3k2_EFE-IRSTE and YOLO-World (`WorldModel`) use,
RT-DETR's (HGStem, HGBlock, RepC3, AIFI, RTDETRDecoder), the module
catalogue's (utils/benchmarks.py: the attention and upsample rows of
tasks.py:318-415 under JAX's names and aliases, `CATALOGUE_ROWS`) and the
`nn/structures` rows (tasks.py:419-455, `STRUCTURE_ROWS`) are ported; of the
names JAX's builders take, PConv alone raises NotImplementedError (ROADMAP
"Deliberately not ported"), as does any name JAX does not take. The model YAMLs
are the port's own verbatim copies under cfg/, read by path with the port's
small YAML reader (utils/yaml_subset.py), so the port needs no YAML package.
"""

from __future__ import annotations

import ast
import math
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Union

import numpy as np
import torch
from torch import nn

from ..ops.resample import max_pool, nearest_upsample
from ..utils.device import resolve_device
from ..utils.yaml_subset import load_yaml
from . import blocks as B
from . import v9v10 as V
from . import world as W
from ..models.rtdetr import RTDETRDecoder, rtdetr_postprocess
from .attention import SLA
from .attention import bigarch as AB
from .attention import channel as AC
from .attention import spatial as AS
from .attention import extra as AE
from .attention.extra import AIFI, TorchMHA
from .common import Conv, ConvTranspose2d, DSConv, DWConv, default_act, lecun_normal_
from ..ops.nms import mask_classes, non_max_suppression
from .heads import (OBB, Classify, Detect, IDetect, Pose, Segment, V10Detect, decode_detections,
                    decode_keypoints, decode_obb, decode_v7, flatten_levels, gather_anchors)
from . import structures as S
from .structures.blocks import FasterBlock, TorchVision
from .upsample import batch3 as U3
from .upsample import carafe as U
from .upsample import misc as UM
from .upsample import pig as UP

CFG_DIR = Path(__file__).resolve().parent.parent / "cfg"

# ---------------------------------------------------------------- spec pass


def make_divisible(x, divisor=8):
    """Round a channel count up to a multiple of divisor (tasks.py:45)."""
    return math.ceil(x / divisor) * divisor


def guess_model_scale(model_path) -> str:
    """The n/s/m/l/x scale char of a model name (tasks.py:50)."""
    m = re.search(r"yolo[v]?\d+([nslmx])", Path(model_path).stem)
    return m.group(1) if m else ""


def yaml_model_load(path) -> Dict:
    """Load a model YAML from the port's cfg/, resolving the scale char in the
    name (tasks.py:56): 'yolov13s_DBL.yaml' → cfg/models/v13/yolov13_DBL.yaml, scale 's'."""
    path = Path(path)
    stem = path.stem
    scale = guess_model_scale(stem)
    unified = re.sub(r"(\d+)([nslmx])(.+)?$", r"\1\3", stem) + ".yaml"
    candidates = [path]
    if path.parent == Path("."):
        candidates += sorted(CFG_DIR.glob(f"models/*/{stem}.yaml"))
        candidates += sorted(CFG_DIR.glob(f"models/*/{unified}"))
    candidates.append(path.with_name(unified))
    for cand in candidates:
        if cand.is_file():
            d = load_yaml(cand.read_text())
            d["scale"] = scale
            d["yaml_file"] = str(cand)
            return d
    raise FileNotFoundError(f"Model YAML not found for '{path}'")


@dataclass
class LayerSpec:
    i: int  # layer index
    f: Union[int, List[int]]  # input layer index/indices (-1 = previous)
    name: str  # module type name
    args: List[Any]  # resolved positional args (incl. channels)
    c2: int  # output channels
    n: int = 1  # outer repeat count (sequential chain)


@dataclass
class ModelSpec:
    layers: List[LayerSpec]
    save: List[int]
    nc: int
    scale: str


# the v13/DBL-family and detect-family subset of the JAX module families
# (tasks.py:102-138)
_C2_SCALED = {"Conv", "DWConv", "DSConv", "Bottleneck", "DSBottleneck", "C2f", "C3", "C3k",
              "C3k2", "DSC3k2", "DSC3k", "SPPF", "A2C2f", "GhostConv", "GhostBottleneck",
              "C3Ghost", "C1", "C2", "SPP", "C2PSA", "RepConv", "RepCSP", "RepNCSPELAN4",
              "ELAN1", "ADown", "AConv", "SPPELAN", "SCDown", "C2fCIB", "PSA",
              "SPDConv", "FEM", "C3k2_EFE", "M2C2f", "C3k2_EAMC", "C3_Faster", "FasterBlock",
              "C2fAttn", "RepC3",
              # the catalogue's (c1, c2) rows (tasks.py:104-108)
              "CoordAttention", "GAM", "MHSA_YOLO", "EfficientAttention_YOLO", "SwinTransformer",
              "ResBlock_CBAM", "DeBiAttention_YOLO",
              # the pools' last (c1, c2) rows (tasks.py:108-112)
              "PSAModule", "CPCA_YOLO", "Outlooker_YOLO", "C2f_PIG", "C2f_WT", "GhostModuleV2",
              "GhostBottleneckV2",
              # the structures' (c1, c2) rows (tasks.py:110-114)
              "UIB", "RepViTBlock", "GhostModuleV3", "GhostBottleneckV3", "PatchEmbed",
              "SwinStage", "PatchMerging", "EffBlock", "MBConv", "APConv", "RepGhostBottleneck",
              "RepLKBlock", "GGhostBottleneck", "GGhostStage"}
_REPEAT_INSERT = {"C2f", "C3", "C3k2", "DSC3k2", "DSC3k", "A2C2f", "C3Ghost", "C1", "C2", "C2PSA",
                  "C2fCIB", "RepCSP", "C3k2_EFE", "M2C2f", "C3k2_EAMC", "C2fAttn", "C3_Faster",
                  "RepC3", "EffBlock"}
_LEGACY_FALSE = {"C3k2", "DSC3k2", "A2C2f"}
# parameter-free layers, run in DetectionModel.forward (tasks.py:275-278,
# :743-759): YOLOv7's MP (k x k max pool, stride k) and SP (stride 1, pad
# k // 2), YOLOv9-E's Silence (the identity)
TORCH_ROWS = {"nn.MaxPool2d", "nn.ZeroPad2d", "nn.Identity", "Silence", "MP", "SP"}
_C1_ONLY = {"DySample", "LSKblock", "SLA", "DLU", "CARAFE", "CARAFEPack", "SCAM",
            # the catalogue's c1-only rows (tasks.py:124-138)
            "CBAM", "EMA", "SELayer", "EdgeAwareAttention", "BAM", "BAM_YOLO",
            "FullyAttentionalBlock", "HiLo", "NonLocalBlock2D", "BiFormerNCHW", "DAT_YOLO", "ELA",
            "BoTAttention", "BoTAttention_YOLO", "CoTNetLayer", "TripletAttention", "EUCB", "MEUM",
            "ECALayer", "SimAM", "MLCA", "AxialBlock_dynamic", "AxialBlock_wopos", "ECALayer_ns",
            "ShiftWindowAttention", "FusedKQnA",
            # the pools' last c1-only rows
            "EdgeAwareAttentionV2", "CAA", "CARAFEplusplus", "LDA_AQU", "CPCA",
            # the structures' c1-only rows (tasks.py:134)
            "ScConv", "MQA"}
# rows whose args pass through unchanged and whose width is their input's
# (the final `else` of tasks.py:141's branches)
_ARGS_AS_GIVEN = {"CARAFE_XiaLiPKU", "CARAFE_simplified", "MHSA", "EfficientAttention",
                  "AxialBlock_YOLO", "DeBiAttentionBlock", "ASFF", "MFA"}


def _opt(a, i, default):
    return a[i] if len(a) > i else default


# the catalogue's rows (tasks.py:318-415): {name: build(resolved args, input
# width)}. The JAX modules read their input width from the input; the port's
# take it as `c`, and an arg JAX ignores stays ignored (MHSA's and
# EfficientAttention's first, DeBiAttentionBlock's width but in BiFormer's
# scale, FusedKQnA's n_channels as the input width).
CATALOGUE_ROWS = {
    "SELayer": lambda a, c: AC.SELayer(c, *a[1:]),
    "ECALayer": lambda a, c: AC.ECALayer(c, *a[1:]),
    "CBAM": lambda a, c: AC.CBAM(c, *a[1:]),
    "SimAM": lambda a, c: AC.SimAM(c, *a[1:]),
    "EMA": lambda a, c: AC.EMA(c, *a[1:]),
    "CoordAttention": lambda a, c: AC.CoordAttention(c, *a[1:]),
    "GAM": lambda a, c: AC.GAM(c, *a[1:]),
    "TripletAttention": lambda a, c: AC.TripletAttention(c, *a[1:]),
    "MLCA": lambda a, c: AC.MLCA(a[0], *a[1:]),
    "ELA": lambda a, c: AC.ELA(c, *a[1:]),
    "BAM": lambda a, c: AC.BAM(c, *a[1:]),
    "BAM_YOLO": lambda a, c: AC.BAM(c, *a[1:]),
    "CoTNetLayer": lambda a, c: AC.CoTNetLayer(c, *a[1:]),
    "ECALayer_ns": lambda a, c: AC.ECALayer_ns(c, _opt(a, 1, 3)),
    "EfficientAttention": lambda a, c: AS.EfficientAttention(c, *a[1:]),
    "EfficientAttention_YOLO": lambda a, c: AS.EfficientAttention(
        c, key_channels=max(_opt(a, 3, 64), _opt(a, 2, 8)), head_count=_opt(a, 2, 8),
        value_channels=a[0]),
    "HiLo": lambda a, c: AS.HiLo(c, *a[1:]),
    "FullyAttentionalBlock": lambda a, c: AS.FullyAttentionalBlock(c, *a[1:]),
    "NonLocalBlock2D": lambda a, c: AS.NonLocalBlock2D(c, *a[1:]),
    "MHSA": lambda a, c: AS.MHSA(c, *a[1:]),
    "MHSA_YOLO": lambda a, c: AS.MHSA(c, *a[1:]),
    "BoTAttention": lambda a, c: AS.BoTAttention(c, *a[1:]),
    "BoTAttention_YOLO": lambda a, c: AS.BoTAttention(c, *a[1:]),
    "EdgeAwareAttention": lambda a, c: AS.EdgeAwareAttention(c, *a[1:]),
    "BiFormerNCHW": lambda a, c: AB.BiFormerNCHW(a[0], *a[1:], c1=c),
    "DAT_YOLO": lambda a, c: AB.DAT(c, *a[1:]),
    "DeBiAttentionBlock": lambda a, c: AB.DeBiAttentionBlock(a[0], *a[1:], c1=c),
    "AxialBlock_YOLO": lambda a, c: AB.AxialBlock(c, a[0] // 2, kernel_size=_opt(a, 1, 20)),
    "AxialBlock_dynamic": lambda a, c: AB.AxialBlock_dynamic(c, a[0] // 2,
                                                             kernel_size=_opt(a, 1, 20)),
    "AxialBlock_wopos": lambda a, c: AB.AxialBlock_wopos(c, a[0] // 2, kernel_size=_opt(a, 1, 20)),
    "DeBiAttention_YOLO": lambda a, c: AB.DeBiAttention_YOLO(c, a[1], *a[2:]),
    "ShiftWindowAttention": lambda a, c: AB.ShiftWindowAttention(c, *a[1:]),
    "FusedKQnA": lambda a, c: AB.FusedKQnA(n_q=_opt(a, 1, 1), n_channels=a[0],
                                           n_heads=_opt(a, 2, 8), ksize=_opt(a, 3, 3), c1=c),
    "SwinTransformer": lambda a, c: AB.SwinTransformer(c, a[1], *a[2:]),
    "EUCB": lambda a, c: UM.EUCB(c, *a[1:]),
    "MEUM": lambda a, c: UM.MEUM(c, *a[1:]),
    "ResBlock_CBAM": lambda a, c: UM.ResBlock_CBAM(c, a[1], *a[2:]),
}
# the pools' last rows (tasks.py:345-410,432-434): {name: build(resolved
# args, the widths of the row's inputs)}; each is built from the width of its
# input, which flax reads from the input
POOL_ROWS = {
    "EdgeAwareAttentionV2": lambda a, c: AS.EdgeAwareAttentionV2(c[0], *a[1:]),
    "Outlooker_YOLO": lambda a, c: AB.Outlooker(c[0], a[1], *a[2:]),
    "PSAModule": lambda a, c: AE.PSAModule(c[0], a[1], *a[2:]),
    "CPCA": lambda a, c: AE.CPCA(c[0], *a[1:]),
    "CPCA_YOLO": lambda a, c: AE.CPCA(c[0], a[1], *a[2:]),
    "ASFF": lambda a, c: AE.ASFF(a[0] if isinstance(a[0], int) else 0, *a[1:], ch=c),
    "CAA": lambda a, c: UM.CAA(c[0], *a[1:]),
    "C2f_PIG": lambda a, c: UP.C2f_PIG(c[0], a[1], *a[2:]),
    "C2f_WT": lambda a, c: UP.C2f_WT(c[0], a[1], *a[2:]),
    "CARAFEplusplus": lambda a, c: U3.CARAFEplusplus(c[0], *a[1:]),
    "LDA_AQU": lambda a, c: U3.LDA_AQU(c[0], *a[1:]),
    "GhostModuleV2": lambda a, c: S.GhostModuleV2(c[0], a[1], *a[2:]),
    "GhostBottleneckV2": lambda a, c: S.GhostBottleneckV2(c[0], a[1], a[2] if len(a) > 2 else a[1],
                                                          *a[3:]),
}
# the `nn/structures` rows (tasks.py:419-455), built like POOL_ROWS; a row
# with a second width (RepViTBlock's oup, GhostBottleneckV3's and
# RepGhostBottleneck's mid or out) takes it unscaled, as JAX's builders do
STRUCTURE_ROWS = {
    "ScConv": lambda a, c: S.ScConv(c[0], *a[1:]),
    "EffBlock": lambda a, c: S.EffBlock(c[0], a[1], *a[2:]),
    "MBConv": lambda a, c: S.MBConv(c[0], a[1], *a[2:]),
    "RepViTBlock": lambda a, c: S.RepViTBlock(c[0], a[1], _opt(a, 2, a[1]), *a[3:]),
    "UIB": lambda a, c: S.UIB(c[0], a[1], *a[2:]),
    "GhostModuleV3": lambda a, c: S.GhostModuleV3(c[0], a[1], *a[2:]),
    "GhostBottleneckV3": lambda a, c: S.GhostBottleneckV3(c[0], a[1], _opt(a, 2, a[1]), *a[3:]),
    "PatchEmbed": lambda a, c: S.PatchEmbed(c[0], a[1], *a[2:]),
    "PatchMerging": lambda a, c: S.PatchMerging(c[0], a[1]),
    "SwinStage": lambda a, c: S.SwinStage(c[0], a[1], *a[2:]),
    "ExtractLayer": lambda a, c: S.ExtractLayer(a[0]),
    "Index": lambda a, c: S.ExtractLayer(_opt(a, 2, 0)),
    "MQA": lambda a, c: S.MQA(c[0], *a[1:]),
    "MFA": lambda a, c: S.MFA(c, _opt(a, 1, a[0]), *a[2:]),
    "RepGhostBottleneck": lambda a, c: S.RepGhostBottleneck(c[0], a[1], _opt(a, 2, a[1]), *a[3:]),
    "RepLKBlock": lambda a, c: S.RepLKBlock(c[0], a[1], *a[2:]),
    "GGhostBottleneck": lambda a, c: S.GGhostBottleneck(c[0], a[1], *a[2:]),
    "GGhostStage": lambda a, c: S.GGhostStage(c[0], a[1], *a[2:]),
    "GiraffeNeckV2": lambda a, c: S.GiraffeNeckV2(
        c, tuple(a[0]), tuple(a[1]) if len(a) > 1 and isinstance(a[1], (list, tuple))
        else tuple(a[0]), *a[2:]),
    "APConv": lambda a, c: S.APConvPinwheel(c[0], a[1], *a[2:]),
}
# modules built as Module(*resolved args)
_FROM_ARGS = {"Conv": Conv, "DWConv": DWConv, "DSConv": DSConv, "ConvTranspose2d": ConvTranspose2d,
              "DSBottleneck": B.DSBottleneck, "C2f": B.C2f, "C3": B.C3, "C3k": B.C3k,
              "C3k2": B.C3k2, "C1": B.C1, "C2": B.C2, "SPPF": B.SPPF, "SPP": B.SPP,
              "DSC3k2": B.DSC3k2, "DSC3k": B.DSC3k, "A2C2f": B.A2C2f, "HyperACE": B.HyperACE,
              "C2PSA": V.C2PSA, "GhostConv": B.GhostConv, "GhostBottleneck": B.GhostBottleneck,
              "C3Ghost": B.C3Ghost, "DySample": B.DySample, "SLA": SLA, "DLU": U.DLU,
              "CARAFE": U.CARAFE, "CARAFEPack": U.CARAFEPack,
              "CARAFE_XiaLiPKU": U.CARAFE_XiaLiPKU, "CARAFE_simplified": U.CARAFE_simplified,
              "RepConv": V.RepConv, "RepCSP": V.RepCSP, "RepNCSPELAN4": V.RepNCSPELAN4,
              "ELAN1": V.ELAN1, "ADown": V.ADown, "AConv": V.AConv, "SPPELAN": V.SPPELAN,
              "SCDown": V.SCDown, "C2fCIB": V.C2fCIB, "PSA": V.PSA, "SPPCSPC": B.SPPCSPC,
              "CBLinear": B.CBLinear, "SPDConv": UM.SPDConv, "FEM": UM.FEM,
              "C3k2_EFE": UM.C3k2_EFE, "Multibranch": UM.Multibranch, "SCAM": UM.SCAM,
              "FFM_Concat2": UM.FFM_Concat2, "FFM_Concat3": UM.FFM_Concat3, "M2C2f": U3.M2C2f,
              "C3k2_EAMC": U3.C3k2_EAMC, "C3_Faster": B.C3_Faster, "FasterBlock": FasterBlock,
              "C2fAttn": W.C2fAttn, "HGStem": B.HGStem, "HGBlock": B.HGBlock, "RepC3": B.RepC3,
              "AIFI": AIFI}
# rows whose JAX builder reads only their first args (tasks.py:469-471,503,526): how many
_ARGS_READ = {"ELAN1": 4, "ADown": 2, "AConv": 2, "SPDConv": 2}
# rows that take the text (tasks.py:684-741): C2fAttn the running text,
# ImagePoolingAttn replaces it, WorldDetect the original
TEXT_ROWS = ("C2fAttn", "ImagePoolingAttn", "WorldDetect")
# the width of a text embedding: the default text is zeros (B, nc, 512) (tasks.py:690)
TEXT_WIDTH = 512
# the module pools' blocks, which have no tensor- or spatial-parallel form
# (their Dense, LayerNorm and Conv1d layers, FFTs, window padding, global
# poolings and text inputs; ROADMAP Queue 1 item 7)
POOL_MODULES = (UM.SPDConv, UM.EFE, UM.C3k2_EFE, UM.FGM, UM.OmniKernel, UM.Multibranch, UM.FEM,
                UM.SCAM, UM._FFMConcat, U3.DyT, U3.WindowMHSA, U3.MBlock, U3.M2C2f, U3.C3k2_EAMC,
                FasterBlock, W.MaxSigmoidAttnBlock, W.C2fAttn, W.ImagePoolingAttn,
                W.WorldDetect,
                # the catalogue's (CATALOGUE_ROWS): global poolings and attentions over
                # the whole map, Dense, LayerNorm and GroupNorm layers, K2's sampling
                AC.SELayer, AC.ECALayer, AC.CBAM, AC.SimAM, AC.EMA, AC.CoordAttention, AC.GAM,
                AC.TripletAttention, AC.MLCA, AC.ELA, AC.BAM, AC.CoTNetLayer, AC.ECALayer_ns,
                AS.EfficientAttention, AS.HiLo, AS.FullyAttentionalBlock, AS.NonLocalBlock2D,
                AS.MHSA, AS.BoTAttention, AS.EdgeAwareAttention, AB.BiFormerNCHW, AB.DAT,
                AB.DeBiAttentionBlock, AB.AxialBlock, AB.DeBiAttention_YOLO,
                AB.ShiftWindowAttention, AB.FusedKQnA, AB.SwinTransformer, UM.EUCB, UM.MEUM,
                UM.ResBlock_CBAM,
                # the pools' last rows (POOL_ROWS): Dense and LayerNorm layers, global
                # poolings, per-pixel softmaxes over taps, wavelet cells, K2's sampling
                AS.EdgeAwareAttentionV2, AB.OutlookAttention, AB.Outlooker, AE.PSAModule,
                AE.CPCA, AE.ASFF, UM.CAA, UP.WTConv2d, UP.PConvPIG, UP.InceptionDWConv2d,
                UP.C2f_PIG, UP.C2f_WT, U3.CARAFEplusplus, U3.LDA_AQU, S.GhostModuleV2,
                S.GhostBottleneckV2,
                # the structures' (STRUCTURE_ROWS and MobileNetV3): window attention
                # with its padding and rolls, Dense and LayerNorm layers, tuple outputs,
                # global poolings, grouped and 31x31 depthwise convs, strided queries
                S.SwinStage, S.SwinTransformerBlock, S.WindowAttention, S.PatchEmbed,
                S.PatchMerging, S.GiraffeNeckV2, S.CSPStage, S.BasicBlock3x3Reverse,
                S.RepConvG, S.ConvBNAct, S.ExtractLayer, S.ScConv, S.MBConv, S.EffBlock,
                S.RepVGGDW, S.RepViTBlock, S.UIB, S.GhostModuleV3, S.GhostBottleneckV3,
                S.APConvPinwheel, S.MQA, S.MFA, S.RepGhostModule, S.RepGhostBottleneck,
                S.ReparamLargeKernelConv, S.RepLKBlock, S.GGhostBottleneck, S.GGhostStage,
                S.MobileNetV3, S.InvertedResidual, S.MNV3SELayer)
# RT-DETR's modules, which have no tensor- or spatial-parallel form either
# (Dense and LayerNorm layers, attention over the whole map, the decoder's
# top-k and deformable sampling; ROADMAP Queue 1 item 7)
RTDETR_MODULES = (RTDETRDecoder, AIFI, TorchMHA, B.HGStem, B.HGBlock)


def _not_ported(m: str):
    return NotImplementedError(f"module '{m}' is not ported to yolo_dbl_tpu_torch yet")


def parse_model_spec(d: Dict, ch: int = 3) -> ModelSpec:
    """Resolve a model YAML dict into a ModelSpec (tasks.py:141), v13/DBL
    family and detect-family rows only. Detect keeps `legacy=True` (the v8
    class branch) unless a C3k2, DSC3k2, A2C2f or HyperACE(2) row comes
    before it; v10Detect's branches are always `legacy=False`."""
    nc = d.get("nc", 80)
    scales = d.get("scales")
    depth, width = d.get("depth_multiple", 1.0), d.get("width_multiple", 1.0)
    max_channels = float("inf")
    scale = d.get("scale", "")
    if scales:
        if not scale:
            scale = tuple(scales.keys())[0]
        depth, width, max_channels = scales[scale]

    chs = [ch]
    layers: List[LayerSpec] = []
    save: List[int] = []
    legacy = True
    for i, (f, n, m, args) in enumerate(d["backbone"] + d["head"]):
        args = list(args)
        for j, a in enumerate(args):
            if isinstance(a, str) and a == "nc":
                args[j] = nc
            elif isinstance(a, str) and a in d:
                args[j] = d[a]
            elif isinstance(a, str):
                try:
                    args[j] = ast.literal_eval(a)
                except (ValueError, SyntaxError):
                    pass
        # an `anchors` arg without a top-level anchors key (FFCA-YOLO-L.yaml)
        # is a stale placeholder for the anchor-free Detect: dropped (tasks.py:170-172)
        args = [a for a in args if not (isinstance(a, str) and a == "anchors")]
        n = max(round(n * depth), 1) if n > 1 else n

        if m in _C2_SCALED:
            c1, c2 = chs[f], args[0]
            if c2 != nc:
                c2 = make_divisible(min(c2, max_channels) * width, 8)
            if m == "C2fAttn":  # embed channels and heads (tasks.py:181-184)
                args[1] = make_divisible(min(args[1], max_channels // 2) * width, 8)
                args[2] = int(max(round(min(args[2], max_channels // 2 // 32)) * width, 1)
                              if args[2] > 1 else args[2])
            args = [c1, c2, *args[1:]]
            if m in _REPEAT_INSERT:
                args.insert(2, n)
                n = 1
            if m in _LEGACY_FALSE:
                legacy = False
            if m == "A2C2f" and scale in "lx" and scale:
                args.append(True)  # residual
                args.append(1.5)  # mlp_ratio
        elif m in ("HyperACE", "HyperACE2"):
            legacy = False
            c1 = chs[f[1]]
            c2 = make_divisible(min(args[0], max_channels) * width, 8)
            he = args[1]
            if scale == "n":
                he = int(args[1] * 0.5)
            elif scale == "x":
                he = int(args[1] * 1.5)
            args = [c1, c2, n, he, *args[2:]]
            n = 1
        elif m == "DownsampleConv":
            c1 = chs[f]
            c2 = c1 * 2
            args = [c1]  # the yaml channel_adjust arg is dropped (tasks.py:208)
        elif m == "FullPAD_Tunnel":
            c2 = chs[f[0]]
            args = []
        elif m == "GiraffeNeckV2":  # a list of widths (tasks.py:212-215)
            c1 = [chs[x] for x in f]
            c2 = args[0]
            args = [c1, *args]
        elif m == "ExtractLayer":  # one level of a list width (tasks.py:216-217)
            c2 = chs[f][args[0]] if isinstance(chs[f], (list, tuple)) else chs[f]
        elif m == "Index":  # c2 = args[0], unscaled (tasks.py:218-221)
            c2 = args[0]
            args = [chs[f], c2, *args[1:]]
        elif m == "Multibranch":
            c2 = chs[f]
            args = [c2]
        elif m in _C1_ONLY:
            c1 = c2 = chs[f]
            args = [c1, *args[1:]]
        elif m == "FFM_Concat2":  # [dim, c // 2, c // 2] (tasks.py:229-232)
            c2 = sum(chs[x] for x in f)
            args = [args[0], c2 // 2, c2 // 2]
        elif m == "FFM_Concat3":  # [dim, c // 4, c // 2, c // 4] (tasks.py:233-236)
            c2 = sum(chs[x] for x in f)
            args = [args[0], c2 // 4, c2 // 2, c2 // 4]
        elif m == "ImagePoolingAttn":  # [ec, ch]; its output is the text (tasks.py:266-268)
            args.append([chs[x] for x in f])
            c2 = chs[f[0]]
        elif m == "WorldDetect":
            args.append([chs[x] for x in f])
            c2 = 0
        elif m == "Concat":
            c2 = sum(chs[x] for x in f)
        elif m in ("v10Detect", "IDetect"):
            args.append([chs[x] for x in f])
            c2 = 0
        elif m == "SPPCSPC":
            c1, c2 = chs[f], args[0]
            if c2 != nc:
                c2 = make_divisible(min(c2, max_channels) * width, 8)
            args = [c1, c2, *args[1:]]
        elif m == "CBLinear":
            c1, c2 = chs[f], args[0]  # the unscaled list of branch widths (tasks.py:279)
            args = [c1, c2, *args[1:]]
        elif m == "CBFuse":
            c2 = chs[f[-1]]
        elif m in ("nn.Upsample", "Upsample"):
            m = "Upsample"
            c2 = chs[f]
        elif m in ("nn.ConvTranspose2d", "ConvTranspose2d"):
            m = "ConvTranspose2d"
            c1, c2 = chs[f], args[0]
            if c2 != nc:
                c2 = make_divisible(min(c2, max_channels) * width, 8)
            args = [c1, c2, *args[1:]]
        elif m in TORCH_ROWS:
            c2 = chs[f]
        elif m in ("Detect", "Segment", "Pose", "OBB"):
            if m == "Segment" and len(args) > 2:  # the prototypes' width
                args[2] = make_divisible(min(args[2], max_channels) * width, 8)
            args.append([chs[x] for x in f])
            args.append(legacy)
            c2 = 0
        elif m == "Classify":
            c1, c2 = chs[f], args[0]
            if c2 != nc:
                c2 = make_divisible(min(c2, max_channels) * width, 8)
            args = [c1, c2, *args[1:]]
        elif m == "AIFI":  # channels prepended, cm and heads raw (tasks.py:253)
            args = [chs[f], *args]
            c2 = chs[f]
        elif m in ("HGStem", "HGBlock"):  # unscaled (tasks.py:257)
            c1, cm, c2 = chs[f], args[0], args[1]
            args = [c1, cm, c2, *args[2:]]
            if m == "HGBlock":
                args.insert(4, n)
                n = 1
        elif m == "RTDETRDecoder":  # the channel list inserted (tasks.py:272)
            args.insert(1, [chs[x] for x in f])
            c2 = 0
        elif m == "ResNetLayer":  # unscaled (tasks.py:264): c2 = args[1], or 4x past the stem
            c2 = args[1] if args[3] else args[1] * 4
        elif m == "TorchVision":  # the trunk's width, unscaled (tasks.py:279-281)
            c1, c2 = chs[f], args[0]
            args = [c1, c2, *args[1:]]
        elif m in _ARGS_AS_GIVEN:
            c2 = chs[f] if isinstance(f, int) else chs[f[-1]]
        else:
            raise _not_ported(m)

        layers.append(LayerSpec(i=i, f=f, name=m, args=args, c2=c2, n=n))
        save.extend(x % i for x in ([f] if isinstance(f, int) else f) if x != -1)
        if i == 0:
            chs = []
        chs.append(c2)
    return ModelSpec(layers=layers, save=sorted(set(save)), nc=nc, scale=scale)


def _build_module(spec: LayerSpec, c_in: List[int]):
    """The PyTorch module for one LayerSpec row (one repeat), or None.
    `c_in`: the widths of the row's inputs (HyperACE2's fuse conv takes
    their sum, which flax reads from the inputs). A row whose first arg is
    its input's width is built from `c_in`: after an ASFF row the row table
    holds JAX's `chs` width, not the one flax reads from the input."""
    m, a = spec.name, spec.args
    if (m in _C2_SCALED or m in _C1_ONLY) and a and a[0] != c_in[0]:
        a = [c_in[0], *a[1:]]
    if m in POOL_ROWS:
        return POOL_ROWS[m](a, c_in)
    if m in STRUCTURE_ROWS:
        return STRUCTURE_ROWS[m](a, c_in)
    if m in _FROM_ARGS:
        return _FROM_ARGS[m](*a[:_ARGS_READ.get(m, len(a))])
    if m in CATALOGUE_ROWS:
        return CATALOGUE_ROWS[m](a, c_in[0])
    if m == "Bottleneck":
        kw = dict(zip(["shortcut", "g", "k", "e"], a[2:]))
        if "k" in kw:
            kw["k"] = tuple(kw["k"])
        return B.Bottleneck(a[0], a[1], **kw)
    if m == "HyperACE2":
        return B.HyperACE2(*a, c_cat=sum(c_in))
    if m == "DownsampleConv":
        return B.DownsampleConv(a[0], channel_adjust=True)
    if m == "FullPAD_Tunnel":
        return B.FullPAD_Tunnel()
    if m == "LSKblock":
        return B.LSKblock(a[0])
    if m == "Detect":
        nc, ch, legacy = a
        return Detect(nc=nc, ch=tuple(ch), legacy=legacy)
    if m == "v10Detect":
        return V10Detect(nc=a[0], ch=tuple(a[-1]))
    if m == "Segment":  # (tasks.py:591)
        return Segment(nc=a[0], nm=a[1] if len(a) > 3 else 32, npr=a[2] if len(a) > 4 else 256,
                       ch=tuple(a[-2]), legacy=a[-1])
    if m == "Pose":
        return Pose(nc=a[0], kpt_shape=tuple(a[1]) if len(a) > 3 else (17, 3), ch=tuple(a[-2]),
                    legacy=a[-1])
    if m == "OBB":  # (tasks.py:597)
        return OBB(nc=a[0], ne=a[1] if len(a) > 3 else 1, ch=tuple(a[-2]), legacy=a[-1])
    if m == "Classify":
        return Classify(a[0], a[1])
    if m == "ResNetLayer":  # [c1, c2, s, is_first, n(, e)] (tasks.py:542)
        return B.ResNetLayer(c_in[0], *a[1:])
    if m == "TorchVision":
        return TorchVision(*a)
    if m == "RTDETRDecoder":
        return RTDETRDecoder(nc=a[0], ch=tuple(a[1]))
    if m == "IDetect":
        return IDetect(nc=a[0], anchors=a[1], ch=tuple(a[2]))
    if m == "ImagePoolingAttn":
        return W.ImagePoolingAttn(ec=a[0], ch=tuple(a[1]))
    if m == "WorldDetect":
        return W.WorldDetect(nc=a[0], embed=a[1], with_bn=a[2], ch=tuple(a[3]))
    if m in ("Concat", "Upsample", "CBFuse") or m in TORCH_ROWS:
        return None
    raise _not_ported(m)


def _out_width(layer: LayerSpec, c_in: List[int]):
    """A row's true output width, which flax infers and the next row is
    built from: ASFF's `expand_c`, the `out_chs` of a GhostBottleneckV2, a
    RepViTBlock (its `oup`) or a RepGhostBottleneck, an MFA's and a CPCA's c2
    where their args give them (JAX's row table holds another width), the
    level an Index row picks from a list of widths, a concat's sum and a
    c1-only row's input width; else the row table's (a GiraffeNeckV2's is
    the list of its levels' widths)."""
    m, a = layer.name, layer.args
    if m == "ASFF":
        return AE.ASFF.EXPAND[a[0] if isinstance(a[0], int) else 0]
    if m in ("GhostBottleneckV2", "RepViTBlock", "RepGhostBottleneck") and len(a) > 2:
        return a[2]
    if m == "MFA":
        return _opt(a, 1, a[0])
    if m == "Index" and isinstance(c_in[0], (list, tuple)):
        return c_in[0][_opt(a, 2, 0)]
    if m == "CPCA" and len(a) > 1 and a[1]:
        return a[1]
    if m == "Concat":
        return sum(c_in)
    if m in _C1_ONLY:
        return c_in[0]
    return layer.c2


def _layer_names(layer: LayerSpec) -> List[str]:
    """Flax scope names of a row's modules: m{i}, or m{i}_{j} for repeats."""
    return [f"m{layer.i}_{j}" for j in range(layer.n)] if layer.n > 1 else [f"m{layer.i}"]


# ---------------------------------------------------------------- model

@torch.no_grad()
def init_flax_defaults(root: nn.Module, generator: torch.Generator):
    """Draw every parameter of `root` from `generator` with flax's default
    initialisers: lecun_normal kernels, zero biases, unit BatchNorm,
    LayerNorm and GroupNorm, xavier_uniform prototypes, zero gates; zero
    kernels where flax's `kernel_init` is zeros, marked `zero_init`, or a
    normal of a stated deviation, marked `normal_std`; the
    pools' and the catalogue's own initial values (`init_own`)."""
    for mod in root.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)) and getattr(mod, "zero_init", False):
            mod.weight.zero_()
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Conv2d) and getattr(mod, "normal_std", None):
            mod.weight.normal_(0.0, mod.normal_std, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.Conv2d, nn.Linear, nn.ConvTranspose2d, nn.Conv1d)):
            # flax's fan-in is a kernel's in-channels times its window:
            # weight[0] for (out, in, kh, kw) and (out, in), but the
            # transposed conv's weight is (in, out, kh, kw)
            fan_in = (mod.weight.shape[0] * mod.weight[0, 0].numel()
                      if isinstance(mod, nn.ConvTranspose2d) else mod.weight[0].numel())
            lecun_normal_(mod.weight, fan_in, generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()
            if getattr(mod, "zero_scale", False):  # flax's scale_init=zeros
                mod.weight.zero_()
        elif isinstance(mod, nn.Embedding):  # flax Embed: fan-in (the width) normal
            lecun_normal_(mod.weight, mod.weight.shape[1], generator)
        elif isinstance(mod, B.AdaHyperedgeGen):
            nn.init.xavier_uniform_(mod.prototype_base, generator=generator)
        elif isinstance(mod, B.FullPAD_Tunnel):
            mod.gate.zero_()
        elif isinstance(mod, B.A2C2f) and mod.gamma is not None:
            mod.gamma.fill_(0.01)
        elif isinstance(mod, B.DySample):
            mod.init_pos = mod._init_pos()
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            mod.reset_parameters()
        elif hasattr(mod, "init_own"):  # the pools' and the catalogue's own parameters
            mod.init_own(generator)
        elif isinstance(mod, IDetect):
            for i in range(mod.nl):
                getattr(mod, f"ia{i}").normal_(0.0, 0.02, generator=generator)
                getattr(mod, f"im{i}").normal_(1.0, 0.02, generator=generator)


class DetectionModel(nn.Module):
    """YOLO detection model built from a YAML (tasks.py:770).

    Layers are registered under their flax scope names (m0, m6_0, ...), so
    JAX variables load key by key (utils/convert.py). Built on the meta
    device, the strides are probed there on an `imgsz` image (640, the
    size JAX's `init` takes; a BoTAttention row's position tables are sized
    for it, as JAX's are); weights are then drawn on the CPU
    from `generator` (seed 0 when none is given) with flax's default
    initialisers and the Detect bias prior, and moved to `device` (default
    "cuda", which raises without a card). On CUDA the model runs
    channels_last.

    `dtype` is the compute type, the JAX model's `dtype` (tasks.py:623):
    float32, or bfloat16 for the JAX package's TPU policy. Parameters and
    BatchNorm statistics stay float32 (no `model.to(torch.bfloat16)`: that
    would make the master weights and the optimizer bfloat16, which JAX
    does not); `forward` casts the images once to `dtype` and every layer
    computes in it (nn/common.py).

    `forward` takes NHWC images and returns the raw per-level Detect maps in
    NHWC and in `dtype`, as the JAX module's apply does; `predict` decodes
    them to (B, 4+nc, A) in `dtype`. The head is the last row
    (`head_name`): a v10Detect model returns {"one2many": maps, "one2one":
    maps} and decodes one2one; an IDetect model (YOLOv7) returns per-level
    (B, H, W, na, 5 + nc) maps in float32 and decodes them with `decode_v7`
    (its A counts na anchors a cell). A Segment model returns (Detect maps,
    coefficient maps, prototypes (B, Hm, Wm, nm)) and a Pose model (Detect
    maps, keypoint maps), all NHWC, and both decode the Detect maps; an OBB
    model returns (Detect maps, angle maps) and decodes to (B, 4+nc+1, A)
    rotated boxes with the angle last (`decode_obb`). None of the three gets
    the bias prior (`_bias_init`). `ClassificationModel` holds a Classify
    head. An RTDETRDecoder model (RT-DETR) returns the decoder's tuple
    (models/rtdetr.py) and decodes to its sorted (B, Q, 6) rows in pixels
    (`rtdetr_postprocess`); its strides are (8, 16, 32), unprobed.

    A model with C2fAttn, ImagePoolingAttn or WorldDetect rows takes a text,
    (B, K, 512) prompt embeddings: `forward(x, text)`; without one the text
    is zeros of (B, nc, 512), as in JAX's module (tasks.py:686-690).
    `WorldModel` supplies its own `txt_feats` instead.
    """

    def __init__(self, cfg="yolov13s_DBL.yaml", ch=3, nc=None, device=None,
                 generator: torch.Generator = None, dtype=torch.float32, imgsz: int = 640):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")
        self._dtype = dtype
        dev = resolve_device(device)
        d = yaml_model_load(cfg) if isinstance(cfg, (str, Path)) else dict(cfg)
        if nc is not None:
            d["nc"] = nc
        self.yaml = d
        self.spec = parse_model_spec(d, ch=ch)
        self.nc = self.spec.nc
        self.names = {i: f"{i}" for i in range(self.nc)}
        self.reg_max = 16
        self.head_name = self.spec.layers[-1].name
        # a YAML `activation:` is the Conv default of this build only (tasks.py:634-638)
        with torch.device("meta"), default_act(d.get("activation")):
            widths = []  # each row's output width
            for layer in self.spec.layers:
                src = [layer.f] if isinstance(layer.f, int) else layer.f
                c_in = [widths[j] for j in src] if widths else [ch]
                for name in _layer_names(layer):
                    module = _build_module(layer, c_in)
                    if module is not None:
                        self.add_module(name, module)
                widths.append(_out_width(layer, c_in))
            # the decoder takes the P3-P5 pyramid and decodes normalized boxes:
            # no probe (tasks.py:792)
            self.strides = ((8, 16, 32) if self.head_name == "RTDETRDecoder"
                            else self._probe_strides(ch, imgsz))
        self.to_empty(device="cpu")
        for mod in self.modules():  # constant buffers, which to_empty left unset
            if hasattr(mod, "init_buffers"):
                mod.init_buffers()
        self.init_weights(generator if generator is not None else torch.Generator().manual_seed(0))
        self.to(dev)
        if dev.type == "cuda":
            self.to(memory_format=torch.channels_last)
        self.eval()

    def _probe_strides(self, ch, probe=640):
        """The head's strides, from one forward of a probe image on the meta
        device; a BoTAttention row's position tables take their size from
        it, as JAX's `init(imgsz)` sizes them."""
        feats = self.forward_text(torch.zeros((1, probe, probe, ch)))
        if isinstance(feats, dict):  # v10Detect (tasks.py:802)
            feats = feats["one2one"]
        elif isinstance(feats, tuple):  # Segment, Pose, OBB (tasks.py:804)
            feats = feats[0]
        return tuple(int(probe // f.shape[1]) for f in feats)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """flax's default initial values (`init_flax_defaults`) + the bias prior."""
        init_flax_defaults(self, generator)
        self._bias_init()

    def reset_weights(self, seed: int):
        """Draw the weights anew from `seed` on the CPU, as construction does,
        and put them back where the model lives."""
        dev = self.device
        self.to("cpu")
        self.init_weights(torch.Generator().manual_seed(seed))
        self.to(dev)
        if dev.type == "cuda":
            self.to(memory_format=torch.channels_last)

    @torch.no_grad()
    def _bias_init(self):
        """Stride-aware Detect bias prior (tasks.py:814), on a plain Detect or
        a WorldDetect head only: JAX's rule matches `m{head}/cv2_{lvl}_2/conv/bias`
        and `cv3_{lvl}_2`, which WorldDetect has too (its cv3_{lvl}_2 is the
        512-wide embedding conv), but no v10Detect leaf (`m{head}/one2many/cv2_...`), no
        Segment or Pose leaf (`m{head}/detect/cv2_...`), no OBB leaf and no IDetect leaf
        matches, so those heads keep zero biases (ROADMAP Queue 3)."""
        if self.head_name not in ("Detect", "WorldDetect"):
            return
        det = self.detect
        for lvl, s in enumerate(self.strides):
            getattr(det, f"cv2_{lvl}_2").conv.bias.fill_(1.0)
            getattr(det, f"cv3_{lvl}_2").conv.bias.fill_(math.log(5 / self.nc / (640 / s) ** 2))

    @property
    def detect(self) -> nn.Module:
        """The head module: Detect, V10Detect, IDetect, Segment, Pose, OBB or Classify."""
        return getattr(self, f"m{self.spec.layers[-1].i}")

    @property
    def detect_branches(self) -> List[Detect]:
        """The head's Detect modules: the head itself, v10Detect's one2many
        and one2one, a task head's nested `detect`, none for IDetect or
        Classify."""
        det = self.detect
        if isinstance(det, V10Detect):
            return [det.one2many, det.one2one]
        if isinstance(det, (Segment, Pose, OBB)):
            return [det.detect]
        return [det] if isinstance(det, Detect) else []

    @torch.no_grad()
    def zero_class_biases(self):
        """Zero the class biases of every Detect branch, or a WorldDetect's
        contrastive `bias` (-10 at init), so that random weights score near
        0.5 and NMS has candidates."""
        for det in self.detect_branches:
            for lvl in range(det.nl):
                getattr(det, f"cv3_{lvl}_2").conv.bias.zero_()
        if isinstance(self.detect, W.WorldDetect):
            for lvl in range(self.detect.nl):
                getattr(self.detect, f"cv4_{lvl}").bias.zero_()

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        """The compute type: `dtype` while the parameters are float32; the
        parameters' own type for a copy cast whole (`.double()`: a float64
        reference on the CPU)."""
        p = next(self.parameters()).dtype
        return self._dtype if p == torch.float32 else p

    @property
    def takes_text(self) -> bool:
        """Whether a row of the model reads a text (C2fAttn, ImagePoolingAttn, WorldDetect)."""
        return any(layer.name in TEXT_ROWS for layer in self.spec.layers)

    def forward(self, x, text=None):
        """NHWC images (and a text, where the model takes one) → the head's
        raw NHWC outputs."""
        return self.forward_text(x, text)

    def forward_text(self, x, text=None):
        """The layers' routing (tasks.py:682): NHWC images → the head's raw
        NHWC outputs. A model that takes a text gets `text`, or zeros of (B,
        nc, 512) without one, as JAX's module does; the trainer calls this
        without a text, as JAX's train step applies the module (a world model
        trains on the zero text). The text is cast once to the compute
        type, as the images are."""
        y: List[Any] = []
        out = x.permute(0, 3, 1, 2).to(self.dtype)
        if self.takes_text:
            if text is None:
                text = torch.zeros((x.shape[0], self.spec.nc, TEXT_WIDTH), device=x.device)
            text = text.to(self.dtype)
        txt = text  # the running text, which ImagePoolingAttn replaces
        save = set(self.spec.save)
        for layer in self.spec.layers:
            f = layer.f
            if isinstance(f, int):
                inp = out if f == -1 else y[f]
            else:
                inp = [out if j == -1 else y[j] for j in f]
            if layer.name == "Concat":
                out = torch.cat(inp, 1)
            elif layer.name == "Upsample":
                scale = int(layer.args[1]) if len(layer.args) > 1 else 2
                out = nearest_upsample(inp.permute(0, 2, 3, 1), scale).permute(0, 3, 1, 2)
            elif layer.name == "nn.MaxPool2d":
                a = layer.args
                k = int(a[0]) if a else 2
                st = int(a[1]) if len(a) > 1 else k
                pd = int(a[2]) if len(a) > 2 else 0
                out = max_pool(inp.permute(0, 2, 3, 1), k, st, pd).permute(0, 3, 1, 2)
            elif layer.name == "nn.ZeroPad2d":
                left, right, top, bottom = layer.args[0]
                out = nn.functional.pad(inp, (left, right, top, bottom))
            elif layer.name in ("nn.Identity", "Silence"):
                out = inp
            elif layer.name == "MP":
                k = int(layer.args[0]) if layer.args else 2
                out = max_pool(inp.permute(0, 2, 3, 1), k, k, 0).permute(0, 3, 1, 2)
            elif layer.name == "SP":
                k = int(layer.args[0]) if layer.args else 3
                out = max_pool(inp.permute(0, 2, 3, 1), k, 1, k // 2).permute(0, 3, 1, 2)
            elif layer.name == "CBFuse":
                out = B.cb_fuse(inp, layer.args[0])
            elif layer.name == "C2fAttn":
                out = getattr(self, f"m{layer.i}")(inp, txt)
            elif layer.name == "ImagePoolingAttn":  # the layer's output is its inputs, unchanged
                txt, out = getattr(self, f"m{layer.i}")(inp, txt), inp
            elif layer.name == "WorldDetect":  # the original text (tasks.py:739-740)
                out = getattr(self, f"m{layer.i}")(inp, text)
            else:
                out = inp
                for name in _layer_names(layer):
                    out = getattr(self, name)(out)
            y.append(out if layer.i in save else None)
        if self.head_name in ("Classify", "RTDETRDecoder"):
            return out
        if isinstance(out, dict):
            return {k: [o.permute(0, 2, 3, 1) for o in v] for k, v in out.items()}
        if isinstance(out, tuple):  # Segment, Pose: lists of maps, and the prototypes
            return tuple([o.permute(0, 2, 3, 1) for o in v] if isinstance(v, list)
                         else v.permute(0, 2, 3, 1) for v in out)
        if self.head_name == "IDetect":
            return [o.permute(0, 2, 3, 1).unflatten(-1, (self.detect.na, -1)) for o in out]
        return [o.permute(0, 2, 3, 1) for o in out]

    @torch.inference_mode()
    def predict(self, x):
        """NHWC images → decoded (B, 4+nc, A) predictions (tasks.py:837). A
        model that parallel/shardings.py `shard_variables` sharded, or one
        run inside parallel/spatial.py `spatial`, returns the replicated
        result on every model rank; the decode runs on whole maps."""
        feats = self.forward(x)
        if self.head_name == "RTDETRDecoder":  # pixels of the input's side (tasks.py:837-840)
            return self.decode_outputs(feats, img_size=x.shape[1])
        return self.decode_outputs(feats)

    def decode_outputs(self, feats, img_size=None):
        """Raw forward outputs → (B, 4+nc, A) (tasks.py:843): v10Detect's
        one2one branch, a Segment or Pose head's Detect maps, or IDetect's
        maps through `decode_v7`; an OBB head's maps and angles → (B,
        4+nc+1, A) through `decode_obb`; RT-DETR's outputs → the (B, Q, 6)
        rows of `rtdetr_postprocess` in pixels of a square `img_size`."""
        if self.head_name == "RTDETRDecoder":
            return rtdetr_postprocess(feats[0], feats[1], img_size=img_size)
        if isinstance(feats, dict):
            feats = feats["one2one"]
        elif isinstance(feats, tuple):
            if self.head_name == "OBB":
                return decode_obb(feats[0], feats[1], self.strides, self.nc, self.reg_max)
            feats = feats[0]
        if self.head_name == "IDetect":
            return decode_v7(feats, self.strides, self.detect.anchors, self.nc)
        return decode_detections(feats, self.strides, self.nc, self.reg_max)


    @torch.inference_mode()
    def kept_rows(self, x, conf=0.25, iou=0.45, max_det=300, class_agnostic=False, classes=None,
                  kpt_shape=None):
        """A Segment or Pose model's NHWC images → the rows NMS keeps and their
        task outputs, all on the model's device: forward, decode, the
        `classes` filter, NMS with each kept row's anchor index, and the
        gather at those anchors (the JAX predictors' and validators' infer,
        predictor.py:473-546, validator.py:139-224). Segment: (dets, counts,
        kept coefficients (B, max_det, nm), prototypes (B, Hm, Wm, nm));
        Pose: (dets, counts, kept keypoints (B, max_det, K, nd) in input
        pixels, visibility sigmoided), `kpt_shape` defaulting to the head's."""
        outputs = self.forward(x)
        pred = mask_classes(self.decode_outputs(outputs), classes, self.nc)
        dets, num, idx = non_max_suppression(pred, conf_thres=conf, iou_thres=iou,
                                             max_det=max_det, nc=self.nc, return_idx=True,
                                             class_agnostic=class_agnostic)
        if self.head_name == "Segment":
            return dets, num, gather_anchors(flatten_levels(outputs[1]), idx), outputs[2]
        if self.head_name == "Pose":
            kpts = decode_keypoints(outputs[0], outputs[1], self.strides,
                                    tuple(kpt_shape or self.detect.kpt_shape))
            return dets, num, gather_anchors(kpts, idx)
        raise ValueError(f"kept_rows is for Segment and Pose heads, not {self.head_name}")

class ClassificationModel(DetectionModel):
    """An image classifier built from a YAML whose head is Classify
    (tasks.py:903): `forward` returns (B, nc) logits and `predict` their
    softmax. No strides, no bias prior."""

    def _probe_strides(self, ch, probe=640):
        return ()

    @torch.inference_mode()
    def predict(self, x):
        """NHWC images → (B, nc) class probabilities (tasks.py:915)."""
        return torch.softmax(self.forward(x), -1)


class WorldModel(DetectionModel):
    """The YOLO-World open-vocabulary detector (tasks.py:920). Its text,
    `txt_feats` (1, K, 512), is the seeded buffer the JAX model keeps in
    place of CLIP's prompt embeddings: `np.random.default_rng(0)
    .standard_normal((1, nc, 512))` in float32, not normalized.
    `set_classes` installs precomputed embeddings. `forward` and `predict`
    use `txt_feats`, broadcast to the batch, unless a text is given; the
    trainer calls `forward_text` without one, so a world model trains on the
    zero text, as JAX's train step applies its module (ROADMAP Queue 3)."""

    def __init__(self, cfg="yolov8s-world.yaml", ch=3, nc=None, device=None,
                 generator: torch.Generator = None, dtype=torch.float32):
        super().__init__(cfg, ch=ch, nc=nc, device=device, generator=generator, dtype=dtype)
        feats = np.random.default_rng(0).standard_normal((1, self.nc, TEXT_WIDTH))
        self.register_buffer("txt_feats", torch.from_numpy(feats.astype(np.float32)).to(self.device),
                             persistent=False)

    @torch.no_grad()
    def set_classes(self, embeddings, names=None):
        """Install (K, 512) or (1, K, 512) precomputed text embeddings,
        l2-normalized (tasks.py:938); `nc` becomes K."""
        emb = torch.as_tensor(np.asarray(embeddings, np.float32))
        if emb.dim() == 2:
            emb = emb[None]
        norm = torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), min=1e-12)
        self.txt_feats = (emb / norm).to(self.device)
        self.nc = emb.shape[1]
        if names is not None:
            self.names = dict(enumerate(names))

    def _text(self, batch: int):
        t = self.txt_feats
        return t.expand(batch, *t.shape[1:]) if t.shape[0] != batch else t

    def forward(self, x, text=None):
        """NHWC images → raw NHWC WorldDetect maps, scored against `text` or
        `txt_feats` (tasks.py:967)."""
        return self.forward_text(x, self._text(x.shape[0]) if text is None else text)
