"""Per-module timer of the upsample and attention catalogues (port of
yolo_dbl_tpu/utils/benchmarks.py, the counterpart of the original's root
test.py and its `avg_time`/`check_time`).

Each catalogue module is built with flax's default initial values drawn
from seed 0 (`nn/tasks.py` `init_flax_defaults`), put in eval mode on the
device (channels_last on the card), and called on the reference's inputs
drawn from seed 0: the upsamplers on 2x64x64x64, the attentions on
4x64x256x256 (1x64x64x64 with `quick`), NCHW here, where JAX has NHWC.
A call is timed as JAX times it: `warmup` calls, then `repeat` calls
between two device synchronizations, on the host's clock.

`check_time` prints FAILED for a module that raises and goes on, as JAX's
and the original's do. At the attentions' reference shape MHSA,
BoTAttention, HiLo and DeBiAttention_YOLO hold score tensors of 69-288 GB
at once, as JAX writes them, so there they fail on an 80 GB card
(chip_smoke.py's `catalogue` phase reckons their bytes first and times
them at the quick shape instead). Nothing else in the port catches.

    python -m yolo_dbl_tpu_torch.utils.benchmarks [--quick] [--cpu]

runs on the card unless `--cpu` (or `device="cpu"`) is given; without a
card it raises.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from .device import resolve_device

UPSAMPLE_SHAPE = (2, 64, 64, 64)  # NHWC, the reference's upsample input
ATTENTION_SHAPE = (4, 256, 256, 64)
ATTENTION_QUICK_SHAPE = (1, 64, 64, 64)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def avg_time(fn: Callable, *args, warmup: int = 1, repeat: int = 10) -> float:
    """Seconds a call of `fn(*args)`: `warmup` calls, then `repeat` calls
    between two synchronizations of the device of the first tensor argument
    (benchmarks.py:21)."""
    device = next((a.device for a in args if isinstance(a, torch.Tensor)), torch.device("cpu"))
    for _ in range(warmup):
        fn(*args)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(repeat):
        fn(*args)
    _sync(device)
    return (time.perf_counter() - t0) / repeat


def prepare(module: nn.Module, device, seed: int = 0) -> nn.Module:
    """`module` with flax's default initial values drawn from `seed` on the
    CPU, in eval mode on `device` (channels_last on the card)."""
    from ..nn.tasks import init_flax_defaults

    init_flax_defaults(module, torch.Generator().manual_seed(seed))
    module = module.to(device).eval()
    if torch.device(device).type == "cuda":
        module = module.to(memory_format=torch.channels_last)
    return module


def reference_input(shape, device, seed: int = 0):
    """The NHWC `shape` drawn from N(0, 1) with `seed`, as an NCHW tensor
    on `device` (channels_last on the card)."""
    x = torch.randn(shape, generator=torch.Generator().manual_seed(seed))
    return x.to(device).permute(0, 3, 1, 2)


def check_time(name: str, module: nn.Module, x, repeat: int = 10,
               warmup: int = 1) -> Optional[Dict]:
    """Time one prepared module on `x`; print its name, NHWC output shape
    and seconds a call, and return them (benchmarks.py:33). The first of
    the `warmup` calls gives the shape. A module that raises prints FAILED
    and returns None, as JAX's does."""
    try:
        with torch.no_grad():
            out_shape = tuple(module(x).permute(0, 2, 3, 1).shape)
            dt = avg_time(module, x, warmup=warmup - 1, repeat=repeat)
        print(f"{name:28s} {str(out_shape):24s} {dt:.6f} s/iter")
        return {"name": name, "shape": out_shape, "sec_per_iter": dt}
    except Exception as e:  # noqa: BLE001 - the catalogue timer goes on, as JAX's and test.py's do
        print(f"{name:28s} FAILED: {type(e).__name__}: {e}")
        return None


def upsample_catalogue(c: int = 64) -> List[Tuple[str, nn.Module]]:
    """(name, module) of the nine upsamplers (benchmarks.py:48)."""
    from ..nn.blocks import DySample
    from ..nn.upsample import carafe as U
    from ..nn.upsample import misc as UM

    return [
        ("DySample", DySample(c)),
        ("CARAFE", U.CARAFE(c)),
        ("CARAFE_XiaLiPKU", U.CARAFE_XiaLiPKU(c)),
        ("CARAFE_simplified", U.CARAFE_simplified(c)),
        ("DLU", U.DLU(c)),
        ("EUCB", UM.EUCB(c)),
        ("MEUM", UM.MEUM(c)),
        ("CARAFEPack", U.CARAFEPack(c)),
        ("ResBlock_CBAM", UM.ResBlock_CBAM(c, c)),
    ]


def attention_catalogue(c: int = 64, hw=(256, 256)) -> List[Tuple[str, nn.Module]]:
    """(name, module) of the 26 attentions (benchmarks.py:65); `hw`, the
    map's size, sizes BoTAttention's position tables, as JAX's init does."""
    from ..nn.attention import bigarch as AB
    from ..nn.attention import channel as AC
    from ..nn.attention import spatial as AS
    from ..nn.blocks import LSKblock

    return [
        ("SELayer", AC.SELayer(c)),
        ("ECALayer", AC.ECALayer(c)),
        ("CBAM", AC.CBAM(c)),
        ("SimAM", AC.SimAM(c)),
        ("EMA", AC.EMA(c, factor=8)),
        ("CoordAttention", AC.CoordAttention(c, c)),
        ("GAM", AC.GAM(c, c)),
        ("TripletAttention", AC.TripletAttention(c)),
        ("MLCA", AC.MLCA(c)),
        ("ELA", AC.ELA(c)),
        ("BAM", AC.BAM(c)),
        ("CoTNetLayer", AC.CoTNetLayer(c)),
        ("LSKblock", LSKblock(c)),
        ("EfficientAttention", AS.EfficientAttention(c, key_channels=64, head_count=8)),
        ("HiLo", AS.HiLo(c, num_heads=8)),
        ("FullyAttentionalBlock", AS.FullyAttentionalBlock(c)),
        ("NonLocalBlock2D", AS.NonLocalBlock2D(c)),
        ("MHSA", AS.MHSA(c, num_heads=4)),
        ("BoTAttention", AS.BoTAttention(c, heads=4, dim_head=16, size=tuple(hw))),
        ("EdgeAwareAttention", AS.EdgeAwareAttention(c)),
        ("ECALayer_ns", AC.ECALayer_ns(c)),
        ("AxialBlock_dynamic", AB.AxialBlock_dynamic(c, c // 2, kernel_size=16)),
        ("AxialBlock_wopos", AB.AxialBlock_wopos(c, c // 2, kernel_size=16)),
        ("ShiftWindowAttention", AB.ShiftWindowAttention(c, heads=4, window_size=4,
                                                         shift_size=2)),
        ("FusedKQnA", AB.FusedKQnA(n_q=1, n_channels=c, n_heads=4)),
        ("DeBiAttention_YOLO", AB.DeBiAttention_YOLO(c, c, num_heads=4)),
    ]


def _run(catalogue, shape, device, repeat):
    x = reference_input(shape, device)
    results = []
    for name, module in catalogue:
        r = check_time(name, prepare(module, device), x, repeat=repeat)
        if r:
            results.append(r)
    return results


def upsample_test(quick: bool = False, device=None, repeat: Optional[int] = None):
    """The upsamplers on 2x64x64x64 (benchmarks.py:99); `repeat` timed calls
    (3 with `quick`, else 10)."""
    device = resolve_device(device)
    return _run(upsample_catalogue(), UPSAMPLE_SHAPE, device, repeat or (3 if quick else 10))


def attention_test(quick: bool = False, device=None, repeat: Optional[int] = None):
    """The attentions on 4x64x256x256, or 1x64x64x64 with `quick`
    (benchmarks.py:110)."""
    device = resolve_device(device)
    shape = ATTENTION_QUICK_SHAPE if quick else ATTENTION_SHAPE
    return _run(attention_catalogue(hw=shape[1:3]), shape, device,
                repeat or (3 if quick else 10))


if __name__ == "__main__":
    import sys

    quick = "--quick" in sys.argv
    dev = "cpu" if "--cpu" in sys.argv else None
    print("== upsample pool ==")
    upsample_test(quick, dev)
    print("== attention pool ==")
    attention_test(quick, dev)
