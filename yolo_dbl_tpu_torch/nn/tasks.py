"""YAML → model compiler and the detection model (port of yolo_dbl_tpu/nn/tasks.py).

Only the branches the YOLOv13/DBL family (`cfg/models/v13/`) and YOLOv8
rows use are ported; any other module name raises NotImplementedError. The
model YAMLs are the port's own verbatim copies under cfg/, read by path with
the port's small YAML reader (utils/yaml_subset.py), so the port needs no
YAML package.
"""

from __future__ import annotations

import ast
import math
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Union

import torch
from torch import nn

from ..ops.resample import nearest_upsample
from ..utils.device import resolve_device
from ..utils.yaml_subset import load_yaml
from . import blocks as B
from .attention import SLA
from .common import Conv, DSConv, DWConv
from .heads import Detect, decode_detections
from .upsample import carafe as U

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


# the v13/DBL-family and YOLOv8 subset of the JAX module families (tasks.py:102-138)
_C2_SCALED = {"Conv", "DWConv", "DSConv", "Bottleneck", "DSBottleneck", "C2f", "DSC3k2",
              "DSC3k", "SPPF", "A2C2f", "GhostConv", "GhostBottleneck", "C3Ghost"}
_REPEAT_INSERT = {"C2f", "DSC3k2", "DSC3k", "A2C2f", "C3Ghost"}
_LEGACY_FALSE = {"DSC3k2", "A2C2f"}
_C1_ONLY = {"DySample", "LSKblock", "SLA", "DLU", "CARAFE", "CARAFEPack"}
# rows whose args pass through unchanged and whose width is their input's
# (the final `else` of tasks.py:141's branches)
_ARGS_AS_GIVEN = {"CARAFE_XiaLiPKU", "CARAFE_simplified"}
# modules built as Module(*resolved args)
_FROM_ARGS = {"GhostConv": B.GhostConv, "GhostBottleneck": B.GhostBottleneck,
              "C3Ghost": B.C3Ghost, "DySample": B.DySample, "SLA": SLA, "DLU": U.DLU,
              "CARAFE": U.CARAFE, "CARAFEPack": U.CARAFEPack,
              "CARAFE_XiaLiPKU": U.CARAFE_XiaLiPKU, "CARAFE_simplified": U.CARAFE_simplified}


def _not_ported(m: str):
    return NotImplementedError(f"module '{m}' is not ported to yolo_dbl_tpu_torch yet")


def parse_model_spec(d: Dict, ch: int = 3) -> ModelSpec:
    """Resolve a model YAML dict into a ModelSpec (tasks.py:141), v13/DBL
    family and YOLOv8 rows only. Detect keeps `legacy=True` (the v8 class
    branch) unless a DSC3k2, A2C2f or HyperACE(2) row comes before it."""
    if d.get("activation"):
        raise _not_ported(f"activation {d['activation']}")
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
        n = max(round(n * depth), 1) if n > 1 else n

        if m in _C2_SCALED:
            c1, c2 = chs[f], args[0]
            if c2 != nc:
                c2 = make_divisible(min(c2, max_channels) * width, 8)
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
        elif m in _C1_ONLY:
            c1 = c2 = chs[f]
            args = [c1, *args[1:]]
        elif m == "Concat":
            c2 = sum(chs[x] for x in f)
        elif m in ("nn.Upsample", "Upsample"):
            m = "Upsample"
            c2 = chs[f]
        elif m == "Detect":
            args.append([chs[x] for x in f])
            args.append(legacy)
            c2 = 0
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
    their sum, which flax reads from the inputs)."""
    m, a = spec.name, spec.args
    if m == "Conv":
        return Conv(*a)
    if m == "DWConv":
        return DWConv(*a)
    if m == "DSConv":
        return DSConv(*a)
    if m == "Bottleneck":
        kw = dict(zip(["shortcut", "g", "k", "e"], a[2:]))
        if "k" in kw:
            kw["k"] = tuple(kw["k"])
        return B.Bottleneck(a[0], a[1], **kw)
    if m == "DSBottleneck":
        return B.DSBottleneck(*a)
    if m == "C2f":
        return B.C2f(*a)
    if m == "SPPF":
        return B.SPPF(*a)
    if m == "DSC3k2":
        return B.DSC3k2(*a)
    if m == "DSC3k":
        return B.DSC3k(*a)
    if m == "A2C2f":
        return B.A2C2f(*a)
    if m == "HyperACE":
        return B.HyperACE(*a)
    if m == "HyperACE2":
        return B.HyperACE2(*a, c_cat=sum(c_in))
    if m == "DownsampleConv":
        return B.DownsampleConv(a[0], channel_adjust=True)
    if m == "FullPAD_Tunnel":
        return B.FullPAD_Tunnel()
    if m in _FROM_ARGS:
        return _FROM_ARGS[m](*a)
    if m == "LSKblock":
        return B.LSKblock(a[0])
    if m == "Detect":
        nc, ch, legacy = a
        return Detect(nc=nc, ch=tuple(ch), legacy=legacy)
    if m in ("Concat", "Upsample"):
        return None
    raise _not_ported(m)


def _layer_names(layer: LayerSpec) -> List[str]:
    """Flax scope names of a row's modules: m{i}, or m{i}_{j} for repeats."""
    return [f"m{layer.i}_{j}" for j in range(layer.n)] if layer.n > 1 else [f"m{layer.i}"]


# ---------------------------------------------------------------- model

# lecun_normal (flax's default kernel init): truncated normal, std corrected
# for the truncation at two standard deviations
_TRUNC_STD = 0.87962566103423978


class DetectionModel(nn.Module):
    """YOLO detection model built from a YAML (tasks.py:770).

    Layers are registered under their flax scope names (m0, m6_0, ...), so
    JAX variables load key by key (utils/convert.py). Built on the meta
    device, the strides are probed there; weights are then drawn on the CPU
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
    them to (B, 4+nc, A) in `dtype`.
    """

    def __init__(self, cfg="yolov13s_DBL.yaml", ch=3, nc=None, device=None,
                 generator: torch.Generator = None, dtype=torch.float32):
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
        with torch.device("meta"):
            widths = []  # each row's output width
            for layer in self.spec.layers:
                src = [layer.f] if isinstance(layer.f, int) else layer.f
                c_in = [widths[j] for j in src] if widths else [ch]
                for name in _layer_names(layer):
                    module = _build_module(layer, c_in)
                    if module is not None:
                        self.add_module(name, module)
                widths.append(layer.c2)
            self.strides = self._probe_strides(ch)
        self.to_empty(device="cpu")
        self.init_weights(generator if generator is not None else torch.Generator().manual_seed(0))
        self.to(dev)
        if dev.type == "cuda":
            self.to(memory_format=torch.channels_last)
        self.eval()

    def _probe_strides(self, ch, probe=256):
        feats = self.forward(torch.zeros((1, probe, probe, ch)))
        return tuple(int(probe // f.shape[1]) for f in feats)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """flax default initialisers (lecun_normal kernels, zero biases, unit
        BatchNorm, xavier_uniform prototypes, zero gates; zero kernels where
        flax's `kernel_init` is zeros, marked `zero_init`) + the bias prior."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)) and getattr(mod, "zero_init", False):
                mod.weight.zero_()
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (nn.Conv2d, nn.Linear)):
                std = math.sqrt(1.0 / mod.weight[0].numel()) / _TRUNC_STD
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.BatchNorm2d):
                mod.reset_parameters()
            elif isinstance(mod, B.AdaHyperedgeGen):
                nn.init.xavier_uniform_(mod.prototype_base, generator=generator)
            elif isinstance(mod, B.FullPAD_Tunnel):
                mod.gate.zero_()
            elif isinstance(mod, B.A2C2f) and mod.gamma is not None:
                mod.gamma.fill_(0.01)
            elif isinstance(mod, B.DySample):
                mod.init_pos = mod._init_pos()
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
        """Stride-aware Detect bias prior (tasks.py:814)."""
        det = self.detect
        for lvl, s in enumerate(self.strides):
            getattr(det, f"cv2_{lvl}_2").conv.bias.fill_(1.0)
            getattr(det, f"cv3_{lvl}_2").conv.bias.fill_(math.log(5 / self.nc / (640 / s) ** 2))

    @property
    def detect(self) -> Detect:
        return getattr(self, f"m{self.spec.layers[-1].i}")

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

    def forward(self, x):
        """NHWC images → raw per-level NHWC Detect maps (tasks.py:682 routing)."""
        y: List[Any] = []
        out = x.permute(0, 3, 1, 2).to(self.dtype)
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
            else:
                out = inp
                for name in _layer_names(layer):
                    out = getattr(self, name)(out)
            y.append(out if layer.i in save else None)
        return [o.permute(0, 2, 3, 1) for o in out]

    @torch.inference_mode()
    def predict(self, x):
        """NHWC images → decoded (B, 4+nc, A) predictions (tasks.py:837). A
        model that parallel/shardings.py `shard_variables` sharded, or one
        run inside parallel/spatial.py `spatial`, returns the replicated
        result on every model rank; the decode runs on whole maps."""
        return self.decode_outputs(self.forward(x))

    def decode_outputs(self, feats):
        return decode_detections(feats, self.strides, self.nc, self.reg_max)
