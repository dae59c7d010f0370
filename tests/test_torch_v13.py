"""The PyTorch port's stock YOLOv13 against the JAX package, on the CPU.

K3's plain version (the einsum path of `_area_attention`) against the JAX
function and against JAX's Pallas `flash_attention` in interpret mode,
called as yolo_dbl_tpu/nn/blocks.py:871-884 calls it, forward and gradient;
C3k and the A2C2f → ABlock → AAttn stack with shared random variables; and
yolov13n (nc=80, the config's own) at 64 px: raw maps, decode, NMS and
u8 frames → boxes, the weight bridge, parameter counts and widths, and
three train steps against `make_train_step`.

Bars: 1e-5 where both sides run the same float32 arithmetic on a few
hundred terms (attention, single modules); the whole network at the bars
of tests/test_torch_model.py and tests/test_torch_train.py, whose sums are
taken in another order by each framework. Where float32 cannot reach a bar
(four ABlocks deep; train mode at 64 px), both sides are held to the JAX
package run in float64 (`dtype=jnp.float64` under `jax.enable_x64`).
"""

import copy
import functools

import flax.linen
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import yaml
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as FA
from jax.experimental.pallas.ops.tpu.flash_attention import BlockSizes, SegmentIds, flash_attention

from yolo_dbl_tpu import DetectionModel as JaxDetectionModel
from yolo_dbl_tpu.cfg import get_cfg as jax_get_cfg
from yolo_dbl_tpu.engine import train_state as JS
from yolo_dbl_tpu.engine.predictor import BasePredictor
from yolo_dbl_tpu.engine.trainer import make_train_step as jax_make_train_step
from yolo_dbl_tpu.kernels.preprocess import device_normalize as jax_device_normalize
from yolo_dbl_tpu.kernels.preprocess import letterbox_geometry as jax_letterbox_geometry
from yolo_dbl_tpu.kernels.preprocess import letterbox_normalize as jax_letterbox
from yolo_dbl_tpu.losses import detection as JD
from yolo_dbl_tpu.nn import blocks as JB
from yolo_dbl_tpu.nn.tasks import parse_model_spec as jax_parse_model_spec
from yolo_dbl_tpu.ops.nms import non_max_suppression as jax_nms

from yolo_dbl_tpu_torch import DetectionModel, kernels
from yolo_dbl_tpu_torch.engine.predictor import DetectionPredictor
from yolo_dbl_tpu_torch.kernels import attention as TA
from yolo_dbl_tpu_torch.kernels.preprocess import device_normalize
from yolo_dbl_tpu_torch.losses.detection import detection_loss
from yolo_dbl_tpu_torch.nn import blocks as TB
from yolo_dbl_tpu_torch.nn import tasks as T
from yolo_dbl_tpu_torch.ops.nms import non_max_suppression as torch_nms
from yolo_dbl_tpu_torch.utils.convert import (TORCH_ONLY_SUFFIX, jax_param_paths,
                                              load_jax_variables, params_from_jax,
                                              state_dict_from_jax)

from tests import test_torch_train as TT
from tests.test_torch_model import REPO
from tests.test_torch_modules import _input, random_variables, run_pair, to_nchw, to_nhwc

TOL = 1e-5
IMGSZ, NC = 64, 80


def _qkv(seed, shape, n_tensors=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(0.0, 1.0, shape).astype(np.float32) for _ in range(n_tensors)]


# ---------------------------------------------------------------- K3


@pytest.mark.parametrize("shape", [(2, 4, 1, 32), (3, 100, 2, 32), (2, 400, 4, 32),
                                   (2, 9, 3, 16)])
def test_area_attention_plain_matches_jax(shape):
    """N = 4 and 400 are the 64 and 640 px sites; hd = 16 is off the
    kernels' path but inside the plain version's."""
    q, k, v, g = _qkv(shape[1], shape, 4)
    ref, vjp = jax.vjp(lambda a, b, c: JB._area_attention(a, b, c, shape[-1]),
                       *map(jnp.asarray, (q, k, v)))
    out = TA.area_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
    got = TA.area_attention_backward_plain(*map(torch.from_numpy, (q, k, v, g)))
    for a, b in zip(got, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=TOL)


def _pallas_area_attention(q, k, v, residuals=False):
    """JAX's Pallas flash_attention with the padding, segment ids and block
    sizes of yolo_dbl_tpu/nn/blocks.py:871-884. With `residuals`, the row
    log-sum-exp m + log l that its forward keeps for the backward, (B, H, N)."""
    bb, n, _, hd = q.shape
    pad = (-n) % 128

    def to_kernel(t):
        return jnp.pad(jnp.swapaxes(t, 1, 2), ((0, 0), (0, 0), (0, pad), (0, 0)))

    seg = jnp.concatenate([jnp.zeros((bb, n), jnp.int32), jnp.ones((bb, pad), jnp.int32)], axis=1)
    bs = BlockSizes(block_q=128, block_k_major=128, block_k=128, block_b=1,
                    block_q_major_dkv=128, block_k_major_dkv=128, block_k_dkv=128,
                    block_q_dkv=128, block_k_major_dq=128, block_k_dq=128, block_q_dq=128)
    if residuals:
        _, l, m = FA._flash_attention(*map(to_kernel, (q, k, v)), None, SegmentIds(seg, seg),
                                      True, False, hd ** -0.5, bs, False)
        return (m + jnp.log(l))[:, :, :n]
    out = flash_attention(*map(to_kernel, (q, k, v)), segment_ids=SegmentIds(seg, seg),
                          sm_scale=hd ** -0.5, block_sizes=bs)
    return jnp.swapaxes(out[:, :, :n], 1, 2)


@functools.lru_cache(maxsize=None)
def _pallas_reference(n):
    """Seeded (1, n, 2, 32) inputs (q, k, v, output gradient) and the TPU
    kernels on them in Pallas interpret mode: the output, the log-sum-exp
    residual of the forward, and (dq, dk, dv) through jax.grad (the dkv and
    dq kernels). Cached: the tests of one file run in one process."""
    q, k, v, g = _qkv(n + 1, (1, n, 2, 32), 4)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        ref = _pallas_area_attention(jq, jk, jv)
        ref_lse = _pallas_area_attention(jq, jk, jv, residuals=True)
        grads = jax.grad(lambda a, b, c: (_pallas_area_attention(a, b, c) * g).sum(),
                         argnums=(0, 1, 2))(jq, jk, jv)
    return (q, k, v, g), np.asarray(ref), np.asarray(ref_lse), tuple(map(np.asarray, grads))


@pytest.mark.parametrize("n", [100, 400])
def test_area_attention_plain_matches_pallas_flash_attention(n):
    """The TPU kernels themselves (forward with its log-sum-exp residual, and
    dkv and dq through jax.grad), in Pallas interpret mode, against the plain
    version the CUDA kernels are held to on the card."""
    (q, k, v, g), ref, ref_lse, grads = _pallas_reference(n)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o, lse = TA.area_attention_plain(tq, tk, tv), TA.area_attention_lse_plain(tq, tk)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
    assert lse.shape == ref_lse.shape == (1, 2, n)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=TOL, rtol=TOL)
    got = TA.area_attention_backward_plain(tq, tk, tv, torch.from_numpy(g))
    for a, b in zip(got, grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=TOL)


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero,
    by integer masking: what cvt.rna.tf32.f32 gives."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_matmul(a, b, passes):
    """a @ b from TF32 operands, summed in float32: one pass, or the
    backward kernels' three (A_small B_big + A_big B_small + A_big B_big,
    X_small = tf32(X - X_big), small-by-big terms first)."""
    a_big, b_big = _tf32(a), _tf32(b)
    if passes == 1:
        return a_big @ b_big
    return (_tf32(a - a_big) @ b_big + a_big @ _tf32(b - b_big)) + a_big @ b_big


def _emulated_backward(q, k, v, g, passes):
    """(dq, dk, dv) with the arithmetic of the CUDA backward kernels
    (csrc/attention.cu): the float32 forward's o and lse, delta =
    rowsum(dO * o), the exp and dS = P (dP - delta) in float32, and each
    of the five products S, dP, dQ, dK, dV in `passes` TF32 passes."""
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    o = TA.area_attention_plain(tq, tk, tv).transpose(1, 2)
    lse = TA.area_attention_lse_plain(tq, tk)[..., None]
    q, k, v, g = (t.transpose(1, 2) for t in (tq, tk, tv, tg))  # (B, H, N, hd)
    scale = q.shape[-1] ** -0.5
    p = torch.exp(_tf32_matmul(q, k.transpose(-1, -2), passes) * scale - lse)
    ds = p * (_tf32_matmul(g, v.transpose(-1, -2), passes) - (g * o).sum(-1, keepdim=True))
    grads = (_tf32_matmul(ds, k, passes) * scale,
             _tf32_matmul(ds.transpose(-1, -2), q, passes) * scale,
             _tf32_matmul(p.transpose(-1, -2), g, passes))
    return [t.transpose(1, 2).numpy() for t in grads]


@pytest.mark.parametrize("n", [100, 400])
def test_area_attention_3xtf32_backward_matches_pallas_flash_attention(n):
    """The CUDA backward kernels run their products on the tensor cores in
    3xTF32. Emulated here, that arithmetic is within 1e-5 of the Pallas dkv
    and dq kernels; a single TF32 pass is not: it misses 1e-4 of the
    largest gradient, the bar the kernels are held to on the card."""
    inputs, _, _, grads = _pallas_reference(n)
    for a, b in zip(_emulated_backward(*inputs, passes=3), grads):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)
    one_pass = [np.abs(a - b).max() / np.abs(b).max()
                for a, b in zip(_emulated_backward(*inputs, passes=1), grads)]
    assert max(one_pass) > 1e-4, one_pass


def test_area_attention_plain_takes_float64_and_checks_shapes():
    q, k, v = (torch.from_numpy(a).double() for a in _qkv(5, (2, 7, 2, 32)))
    out = TA.area_attention(q, k, v)
    assert out.dtype == torch.float64
    torch.testing.assert_close(out.float(), TA.area_attention(q.float(), k.float(), v.float()),
                               atol=1e-6, rtol=0)
    with pytest.raises(ValueError):
        TA.area_attention(q, k[:, :5], v)
    with pytest.raises(TypeError):
        TA.area_attention(q, k.float(), v)


def test_area_attention_kernel_entry_points_refuse_cpu_tensors():
    """Only `area_attention` runs the plain version for a CPU tensor; the
    kernels' entry points raise before they build or launch anything."""
    q, k, v = map(torch.from_numpy, _qkv(6, (1, 8, 2, 32)))
    kernels.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        TA.area_attention_forward(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        TA.area_attention_backward(q, k, v, q, q[:, 0].transpose(1, 2), q)
    assert sum(kernels.launches.values()) == 0


# ---------------------------------------------------------------- modules


MODULE_CASES = {
    "C3k": (lambda: JB.C3k(32, 2), lambda: TB.C3k(16, 32, 2), (2, 8, 8, 16)),
    "AAttn_area1": (lambda: JB.AAttn(64, 2, 1), lambda: TB.AAttn(64, 2, 1), (2, 4, 6, 64)),
    "AAttn_area4": (lambda: JB.AAttn(64, 2, 4), lambda: TB.AAttn(64, 2, 4), (2, 8, 6, 64)),
    "ABlock": (lambda: JB.ABlock(64, 2, 1.2, 4), lambda: TB.ABlock(64, 2, 1.2, 4), (2, 4, 4, 64)),
    "A2C2f_area1": (lambda: JB.A2C2f(64, 1, True, 1), lambda: TB.A2C2f(48, 64, 1, True, 1),
                    (2, 4, 4, 48)),
    "A2C2f_area4_residual": (lambda: JB.A2C2f(64, 1, True, 4, True, 1.5),
                             lambda: TB.A2C2f(64, 64, 1, True, 4, True, 1.5), (2, 8, 4, 64)),
    "A2C2f_c3k": (lambda: JB.A2C2f(64, 1, False), lambda: TB.A2C2f(32, 64, 1, False),
                  (2, 6, 6, 32)),
}


@pytest.mark.parametrize("case", sorted(MODULE_CASES))
def test_v13_module_parity(case):
    make_j, make_t, shape = MODULE_CASES[case]
    tm = make_t()
    out_j, out_t = run_pair(make_j(), tm, _input(shape))
    np.testing.assert_allclose(to_nhwc(out_t), np.asarray(out_j), atol=TOL, rtol=TOL)
    if case.startswith("A2C2f"):
        assert (tm.gamma is not None) == case.endswith("residual")


# A2C2f with two repeats (four ABlocks), as rows 6 (area 4) and 8 (area 1) of
# yolov13s run it, and as l/x run it with the residual. Its output's largest
# is 20 to 30 here, and four ABlocks in float32 put each side a few 1e-6 of
# that from the float64 result (over four seeds, JAX's float32 up to 2.0e-6,
# the port's up to 8.1e-6; 6.7e-5 absolute at seed 0 of the residual case,
# the reading that 1e-5 absolute missed), while the float64 sides of JAX and
# the port agree within 1.2e-14 of it. So both float32 sides are held to
# JAX's float64 output at 2e-5 of its largest, and the float64 sides to each
# other at 1e-12.
TWO_REPEAT_CASES = {
    "area4": (lambda d: JB.A2C2f(64, 2, True, 4, dtype=d),
              lambda: TB.A2C2f(64, 64, 2, True, 4), (2, 8, 4, 64)),
    "area1": (lambda d: JB.A2C2f(64, 2, True, 1, dtype=d),
              lambda: TB.A2C2f(48, 64, 2, True, 1), (2, 4, 4, 48)),
    "area4_residual": (lambda d: JB.A2C2f(64, 2, True, 4, True, 1.5, dtype=d),
                       lambda: TB.A2C2f(64, 64, 2, True, 4, True, 1.5), (2, 8, 4, 64)),
}


@pytest.mark.parametrize("case", sorted(TWO_REPEAT_CASES))
def test_v13_a2c2f_two_repeats_against_float64(case):
    make_j, make_t, shape = TWO_REPEAT_CASES[case]
    x = _input(shape)
    jm = make_j(jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    variables = random_variables(shapes, np.random.default_rng(0))
    out_j = np.asarray(jm.apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x)))
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        ref = np.asarray(make_j(jnp.float64).apply(v64, jnp.asarray(x, jnp.float64)))
    assert ref.dtype == np.float64
    tm = load_jax_variables(make_t(), variables).eval()
    with torch.no_grad():
        out_t = to_nhwc(tm(to_nchw(x)))
        out_t64 = to_nhwc(copy.deepcopy(tm).double()(to_nchw(x).double()))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out_t64, ref, atol=1e-12 * scale, rtol=0)
    for out in (out_j, out_t):
        np.testing.assert_allclose(out, ref, atol=2e-5 * scale, rtol=0)


# ---------------------------------------------------------------- model


@pytest.fixture(scope="module")
def pair():
    """JAX yolov13n with perturbed variables, its port loaded from them,
    and the JAX raw maps + decoded predictions on a fixed input."""
    jm = JaxDetectionModel("yolov13n.yaml", nc=NC)
    x = np.random.default_rng(0).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    shapes = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0), jnp.asarray(x))
    variables = random_variables(shapes, np.random.default_rng(1))
    # class logits near 0 so that NMS has candidates at conf 0.25
    for name in variables["params"]["m32"]:
        if name.startswith("cv3_") and name.endswith("_2"):
            variables["params"]["m32"][name]["conv"]["bias"][:] = 0.0
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    run = jax.jit(lambda v, img: (lambda f: (f, jm.decode_outputs(f)))(jm.module.apply(v, img)))
    feats_j, pred_j = run(jv, jnp.asarray(x))
    tm = DetectionModel("yolov13n.yaml", nc=NC, device="cpu")
    load_jax_variables(tm, variables)
    return dict(jm=jm, jv=jv, variables=variables, run=run, x=x, tm=tm,
                feats_j=[np.asarray(f) for f in feats_j], pred_j=np.asarray(pred_j))


def test_v13_forward_decode_nms_parity(pair):
    x = torch.from_numpy(pair["x"])
    tm = pair["tm"]
    with torch.no_grad():
        feats_t = tm(x)
    for a, b in zip(feats_t, pair["feats_j"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4, rtol=0)
    pred_t = tm.predict(x).numpy()
    pred_j = pair["pred_j"]
    assert pred_t.shape == pred_j.shape == (2, 4 + NC, 84)
    assert np.abs(pred_t[:, :4] - pred_j[:, :4]).max() < 0.05
    assert np.abs(pred_t[:, 4:] - pred_j[:, 4:]).max() <= 1e-3
    dj, nj = jax_nms(jnp.asarray(pred_j), conf_thres=0.25, iou_thres=0.45)
    dt, nt = torch_nms(torch.from_numpy(pred_t), conf_thres=0.25, iou_thres=0.45)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert int(nt.min()) > 0


def test_v13_u8_frames_to_boxes_parity(pair):
    """u8 frames → letterbox → YOLOv13 forward (K3 inside every AAttn) →
    decode → NMS → boxes in source pixels, against the JAX u8 lane."""
    frames = np.random.default_rng(2).integers(0, 256, (2, 48, 80, 3), dtype=np.uint8)
    img_j = jax_letterbox(jnp.asarray(frames), (IMGSZ, IMGSZ), scaleup=False, interpret=True)
    _, pred_j = pair["run"](pair["jv"], img_j)
    dj, nj = jax_nms(pred_j, conf_thres=0.25, iou_thres=0.45)
    gain, _, _, top, left = jax_letterbox_geometry(48, 80, IMGSZ, IMGSZ, scaleup=False)
    ref = [BasePredictor._rescale_boxes(np.asarray(dj[i][: int(nj[i])]), gain,
                                        (float(left), float(top)), (48, 80)) for i in range(2)]
    kernels.reset_launches()
    out = DetectionPredictor(pair["tm"], imgsz=IMGSZ)(frames)
    assert sum(kernels.launches.values()) == 0  # the CPU runs the plain versions
    assert [len(o) for o in out] == [len(r) for r in ref] and len(out[0]) > 0
    for o, r in zip(out, ref):
        assert np.abs(o[:, :4] - r[:, :4]).max() < 0.05
        assert np.abs(o[:, 4] - r[:, 4]).max() <= 1e-3
        np.testing.assert_array_equal(o[:, 5], r[:, 5])


def test_v13_bridge_covers_every_leaf(pair):
    leaves = jax.tree_util.tree_leaves(pair["variables"])
    mapped = state_dict_from_jax(pair["variables"])
    own = {k for k in pair["tm"].state_dict() if not k.endswith(TORCH_ONLY_SUFFIX)}
    assert len(leaves) == len(mapped) == 718
    assert set(mapped) == own
    paths = jax_param_paths(pair["tm"])
    flat = {"/".join(str(k.key) for k in p)
            for p, _ in jax.tree_util.tree_flatten_with_path(pair["variables"]["params"])[0]}
    assert set(paths.values()) == flat


@pytest.mark.parametrize("scale,n_params", [("n", 2_512_567), ("s", 9_092_375)])
def test_v13_param_counts_and_widths_match_jax(scale, n_params):
    name = f"yolov13{scale}.yaml"
    jm = JaxDetectionModel(name, nc=NC)
    shapes = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    assert sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"])) == n_params
    tm = DetectionModel(name, nc=NC, device="cpu")
    assert sum(p.numel() for p in tm.parameters()) == n_params
    assert [l.c2 for l in tm.spec.layers] == [l.c2 for l in jm.spec.layers]
    assert [l.args for l in tm.spec.layers] == [l.args for l in jm.spec.layers]
    assert tm.strides == jm.strides == (8, 16, 32)
    attn = [m for m in tm.modules() if isinstance(m, TB.AAttn)]
    assert len(attn) == 8 and {m.head_dim for m in attn} == {32}
    if scale == "s":
        assert tm.spec.layers[6].args == [256, 256, 2, True, 4]
        assert tm.spec.layers[8].args == [512, 512, 2, True, 1]
        sites = {}
        for m in attn:
            m.register_forward_hook(lambda mod, inp, out: sites.update(
                {(mod.num_heads, mod.area): tuple(inp[0].shape)}))
        tm.to("meta")(torch.zeros((8, 640, 640, 3), device="meta"))
        # (BB, N, H, hd) at 640: row 6 (32, 400, 4, 32), row 8 (8, 400, 8, 32)
        assert sites == {(4, 4): (8, 128, 40, 40), (8, 1): (8, 256, 20, 20)}


def test_v13_yaml_copy_and_scaled_rows():
    port = REPO / "yolo_dbl_tpu_torch/cfg/models/v13/yolov13.yaml"
    ref = REPO / "yolo_dbl_tpu/cfg/models/v13/yolov13.yaml"
    assert port.read_bytes() == ref.read_bytes()
    assert T.load_yaml(port.read_text()) == yaml.safe_load(port.read_text())
    for scale in "nslx":  # l and x append A2C2f's residual=True, mlp_ratio=1.5
        spec_j = jax_parse_model_spec(yaml.safe_load(ref.read_text()) | {"scale": scale})
        spec_t = T.parse_model_spec(T.yaml_model_load(f"yolov13{scale}.yaml"))
        assert [(l.name, l.args, l.c2, l.n) for l in spec_t.layers] == \
            [(l.name, l.args, l.c2, l.n) for l in spec_j.layers]
    assert spec_t.layers[6].args[-2:] == [True, 1.5] and spec_t.layers[10].name == "Upsample"


def test_v13_large_scale_gamma_init():
    """At l/x A2C2f has the gamma-scaled residual; the model initialises
    gamma to 0.01 (flax's constant initialiser) after its meta-device build."""
    tm = DetectionModel("yolov13l.yaml", nc=NC, device="cpu")
    gammas = {n: p for n, p in tm.named_parameters() if n.endswith("gamma")}
    assert sorted(gammas) == ["m6.gamma", "m8.gamma"]
    for n, p in gammas.items():
        assert p.shape == (tm.spec.layers[int(n[1])].c2,)
        torch.testing.assert_close(p.detach(), torch.full_like(p, 0.01))
    assert not any("gamma" in n for n, _ in DetectionModel("yolov13n.yaml", nc=NC,
                                                            device="cpu").named_parameters())


# ---------------------------------------------------------------- training


@pytest.fixture(scope="module")
def train_run():
    """Three train steps of yolov13n on both sides from the same variables,
    dropout off on both (tests/test_torch_train.py says why)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", TT._NoDropout)
        return TT._train_run("yolov13n.yaml", NC)


def test_v13_train_step_losses_match_jax(train_run):
    TT.check_train_losses(train_run)


@pytest.fixture(scope="module")
def float64_run(train_run):
    """JAX's own float64 reading of the same run: yolov13n built with
    dtype float64 under `jax.enable_x64`, from the same variables and
    batches; its step-1 gradient, and its BatchNorm statistics after the
    three steps of `make_train_step`. Its loss casts the maps to float32
    (yolo_dbl_tpu/losses/detection.py:87), so it is float64 up to the maps."""
    tm = train_run["tm"]
    batches = [{k: jnp.asarray(v) for k, v in b.items()} for b in TT._train_batches(3)]
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(flax.linen, "Dropout", TT._NoDropout)
        jm = JaxDetectionModel("yolov13n.yaml", nc=NC, dtype=jnp.float64)
        state = train_run["states"][0]
        params, stats = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                               (state.params, state.batch_stats))

        def loss_fn(p, batch):
            outs, _ = jm.module.apply({"params": p, "batch_stats": stats},
                                      jax_device_normalize(batch["img"], jnp.float64),
                                      train=True, mutable=["batch_stats"])
            return JD.detection_loss(outs, batch, jm.strides, jm.nc)[0]

        grads = jax.jit(jax.grad(loss_fn))(params, batches[0])
        cfg = jax_get_cfg(overrides=TT.TRAIN_OVERRIDES)
        tx, _ = JS.build_optimizer(params, NC, cfg, 5)
        state = JS.create_train_state({"params": params, "batch_stats": stats}, tx)
        step = jax.jit(jax_make_train_step(jm, cfg, tx))
        for b in batches:
            state, _ = step(state, b, jax.random.PRNGKey(0))
        grads, stats = jax.tree_util.tree_map(np.asarray, (grads, state.batch_stats))
    out = dict(grads=params_from_jax(tm, grads),
               stats=state_dict_from_jax({"batch_stats": stats}))
    assert all(t.dtype == torch.float64 for d in out.values() for t in d.values())
    return out


def _port_float64_grads(train_run):
    """{name: gradient} of the step-1 loss of a float64 copy of the port's
    initial model on the CPU (the plain kernels take float64)."""
    model = copy.deepcopy(train_run["model0"]).double().train()
    batch = {k: torch.as_tensor(v) for k, v in train_run["batch0"].items()}
    batch = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    cfg = train_run["trainer"].cfg
    loss, _ = detection_loss(model(device_normalize(batch["img"], torch.float64)), batch,
                             model.strides, model.nc, box_gain=cfg.box, cls_gain=cfg.cls,
                             dfl_gain=cfg.dfl)
    names, params = zip(*model.named_parameters())
    return dict(zip(names, torch.autograd.grad(loss, params)))


# The leaves whose exact step-1 gradient is 0 at 64 px: the ABlocks'
# pe/proj/mlp_1 BatchNorm biases (each reaches the loss only through convs
# into a train-mode BatchNorm, which takes out a constant shift), the
# hyperedge generators' pre_head_proj biases (a shift of every node's logit
# before a softmax over nodes) and Detect's P5 box branch (no foreground
# anchor on the 2x2 P5 grid).
EXACT_ZERO_LEAVES = frozenset(
    [f"m{i}.m_{a}_{b}.{part}.bn.bias" for i in (6, 8) for a in (0, 1) for b in (0, 1)
     for part in ("attn.pe", "attn.proj", "mlp_1")]
    + [f"m9.branch{i}.m.hgnn.edge_generator.pre_head_proj.bias" for i in (1, 2)]
    + [f"m32.cv2_2_{i}.{leaf}" for i in (0, 1) for leaf in ("conv.weight", "bn.weight", "bn.bias")]
    + ["m32.cv2_2_2.conv.weight", "m32.cv2_2_2.conv.bias"])

# The leaves on which the port's and JAX's float32 step-1 gradients were
# read more than 1e-3 of JAX's largest apart (CPU, 64 px, the seeds of
# tests/test_torch_train.py). On each, JAX's float32 gradient is 0.88e-3 to
# 2.4e-3 of its largest from JAX's float64 one, the port's 0.9e-4 to 3.6e-4.
FLOAT32_SPREAD_LEAVES = frozenset([
    "m8.m_0_0.attn.qkv.conv.weight", "m8.m_0_1.attn.qkv.conv.weight",
    "m8.m_0_1.attn.pe.conv.weight", "m13.gate", "m21.m_0.m_1.cv1.bn.bias", "m23.gate",
    "m26.m_0.cv3.bn.weight", "m28.conv.weight", "m30.cv1.bn.weight",
    "m30.m_0.cv1.conv.weight", "m30.m_0.cv1.bn.weight", "m30.m_0.m_0.cv1.pw.weight",
    "m30.m_0.m_0.cv1.bn.weight", "m30.m_0.m_0.cv1.bn.bias", "m30.m_0.m_1.cv1.pw.weight",
    "m30.m_0.m_1.cv1.bn.bias", "m30.m_0.m_1.cv2.bn.weight", "m30.m_0.m_1.cv2.bn.bias",
    "m30.m_0.cv3.conv.weight", "m30.cv2.bn.weight", "m30.cv2.bn.bias",
    "m32.cv3_2_1_1.conv.weight"])

# The BatchNorm statistic after step 3 that the two float32 runs put more
# than 1e-4 apart: JAX's is 1.01e-4 from JAX's float64 run, the port's 3.4e-5.
FLOAT32_SPREAD_STATS = frozenset(["m8.m_1_1.mlp_0.bn.running_var"])


def test_v13_train_step_gradients_match_jax(train_run, float64_run):
    """At 64 px the P5 maps are 2x2, BatchNorm normalizes over 8 values and
    the model's largest |g| is about 1e3, so float32 reads some leaves'
    gradients poorly. Every leaf of the port's step-1 gradient is held to
    JAX's float64 one within 1e-3 of its largest (the worst reading is
    3.6e-4), an exact-zero leaf within 1e-7 of the model's largest. Every
    leaf is also held to JAX's float32 gradient within 1e-3 of its largest,
    but for those of FLOAT32_SPREAD_LEAVES, on which JAX's float32 must then
    be the further of the two from float64. The 8 attn.qkv convs get their
    gradient only through K3's backward and pe."""
    gj, gt, g64 = train_run["grads_j"], train_run["grads_t"], float64_run["grads"]
    assert set(gj) == set(gt) == set(g64)
    g_max = max(float(g.abs().max()) for g in g64.values())
    assert {n for n in g64 if float(g64[n].abs().max()) <= 1e-9 * g_max} == EXACT_ZERO_LEAVES
    spread = set()
    for n in gt:
        if n in EXACT_ZERO_LEAVES:
            assert float(gt[n].abs().max()) <= 1e-7 * g_max, n
            continue
        ref = g64[n]
        err_t, err_j = (float((g.double() - ref).abs().max()) for g in (gt[n], gj[n]))
        assert err_t <= 1e-3 * float(ref.abs().max()), n
        if float((gt[n] - gj[n]).abs().max()) > 1e-3 * float(gj[n].abs().max()):
            spread.add(n)
            assert err_j > 2 * err_t, n
    assert spread <= FLOAT32_SPREAD_LEAVES
    qkv = [n for n in gt if ".attn.qkv.conv." in n]
    assert len(qkv) == 8 and all(float(gt[n].abs().max()) > 0 for n in qkv)


def test_v13_float64_gradient_matches_jax_float64(train_run, float64_run):
    """The port's function, apart from float32: a float64 copy of the port's
    model against JAX's float64 step-1 gradient, within 1e-5 of each leaf's
    largest (JAX's float32 loss head leaves about 1e-6) and 1e-12 of the
    model's largest."""
    g64, gp = float64_run["grads"], _port_float64_grads(train_run)
    g_max = max(float(g.abs().max()) for g in g64.values())
    for n, ref in g64.items():
        np.testing.assert_allclose(gp[n].numpy(), ref.numpy(), rtol=0, err_msg=n,
                                   atol=1e-5 * float(ref.abs().max()) + 1e-12 * g_max)


def test_v13_train_step_updates_and_batch_stats_match_jax(train_run, float64_run):
    """As tests/test_torch_train.py, with two differences. The leaves of
    EXACT_ZERO_LEAVES do not move. The statistic of FLOAT32_SPREAD_STATS is
    held to JAX's float64 run, and every statistic is also held to it within
    1e-4."""
    TT.check_train_updates_and_batch_stats(train_run, min_moved=0.9,
                                           float64_stats=float64_run["stats"],
                                           float32_spread=FLOAT32_SPREAD_STATS)
    own = train_run["tm"].state_dict()
    for k, ref in float64_run["stats"].items():
        np.testing.assert_allclose(own[k].numpy(), ref.numpy(), atol=1e-4, rtol=1e-4, err_msg=k)
