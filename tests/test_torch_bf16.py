"""The port's bfloat16 compute policy against the JAX package's, on the CPU.

The JAX package keeps float32 parameters and computes in the flax module
`dtype` (yolo_dbl_tpu/nn/common.py:13-14); `bench.py` runs it in bfloat16.
Here the port's `dtype=torch.bfloat16` is held to JAX's `dtype=jnp.bfloat16`
on the same variables and inputs (made with numpy seeds):

- (a) the blocks where PyTorch would silently promote to float32 (DySample's
  `init_pos`, A2C2f's `gamma`, AdaHyperedgeGen's `prototype_base`, the
  FullPAD `gate`): every activation bfloat16 (a promotion fails here), and
  the output near JAX's bfloat16 one. bfloat16 rounding differs between the
  frameworks, so the bars are JAX's own bfloat16-against-float32 spread:
  the largest |d| within 4x JAX's largest, and the mean |d| within 2x JAX's
  mean (two independent roundings: about sqrt(2)). DySample's is a quarter
  of it: its sample coordinates are bfloat16 values formed in JAX's order,
  equal on both sides but where the offset conv's last bit differs, so most
  outputs are equal; coordinates formed in float32 move most samples and
  sit a whole spread away on average.
- (b, c) the K2 and K3 kernels' bfloat16 plain versions against the TPU
  kernels in Pallas interpret mode on the same bfloat16 values;
- (d) the whole YOLO-DBL-n and YOLOv13-n decode: against JAX bfloat16 within
  4x JAX's own bfloat16-against-float32 spread, and against JAX float32
  within `check_amp`'s bars (yolo_dbl_tpu/utils/checks.py:43-45: boxes 0.02
  of imgsz, scores 0.05);
- (e) YOLO-DBL-n bfloat16 train-mode losses and gradients against JAX's
  float64 at 128 px on three seeds, within 4x JAX bfloat16's own distance
  from it (medians over the seeds);
- (f) K1's bfloat16 output is its float32 output rounded once, bit for bit;
- and NMS on bfloat16 predictions, the trainer's float32 state, the batch's
  /255 in bfloat16.
"""

import copy
import functools

import flax.linen
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from yolo_dbl_tpu import DetectionModel as JaxDetectionModel
from yolo_dbl_tpu.kernels.preprocess import device_normalize as jax_device_normalize
from yolo_dbl_tpu.kernels.sampling import _pallas_sample
from yolo_dbl_tpu.losses import detection as JD
from yolo_dbl_tpu.nn import blocks as JB
from yolo_dbl_tpu.ops.nms import non_max_suppression as jax_nms

from yolo_dbl_tpu_torch import DetectionModel, kernels
from yolo_dbl_tpu_torch.engine.predictor import DetectionPredictor
from yolo_dbl_tpu_torch.engine.trainer import Trainer, train_loss
from yolo_dbl_tpu_torch.kernels import attention as TA
from yolo_dbl_tpu_torch.kernels import preprocess as TP
from yolo_dbl_tpu_torch.kernels import sampling as TS
from yolo_dbl_tpu_torch.nn import blocks as TB
from yolo_dbl_tpu_torch.ops.nms import non_max_suppression as torch_nms
from yolo_dbl_tpu_torch.utils.convert import load_jax_variables, params_from_jax

from tests.test_torch_modules import jax_tree, random_variables, to_nchw, to_nhwc
from tests.test_torch_train import TRAIN_OVERRIDES, _NoDropout
from tests.test_torch_v13 import _pallas_area_attention, _qkv
from tests.torch_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)

BF16 = torch.bfloat16
IMGSZ = 64
TRAIN_IMGSZ = 128
# (batch seed, variables seed) of each train step: single draws of bfloat16
# train-mode noise are heavy-tailed (see the train-step tests)
TRAIN_SEEDS = ((21, 22), (41, 42), (61, 62))
# check_amp's bars (yolo_dbl_tpu/utils/checks.py:43-45)
AMP_BOX, AMP_SCORE = 0.02 * IMGSZ, 0.05


def _round_bf16(a):
    """numpy float32 values rounded to bfloat16 (and back to float32)."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _np(t):
    return t.detach().float().numpy()


def _bf16_ulp(a):
    """The spacing of bfloat16 at each value of `a`: 2^(e - 8) for |a| in
    [2^(e-1), 2^e) (8 significant bits)."""
    _, e = np.frexp(np.asarray(a, np.float32))
    return np.ldexp(np.float32(1), e - 8)


def _all_bf16_activations(module):
    """Forward hooks that record every submodule whose output (or an output
    tensor in a list) is not bfloat16; returns the list and the handles."""
    bad = []

    def hook(mod, _, out):
        outs = out if isinstance(out, (list, tuple)) else [out]
        if any(torch.is_tensor(o) and o.is_floating_point() and o.dtype != BF16 for o in outs):
            bad.append(type(mod).__name__)

    return bad, [m.register_forward_hook(hook) for m in module.modules()]


# ---------------------------------------------------------------- (a) blocks

# name: (JAX block for a dtype, port block, NHWC input shape or shapes, mean bar
# as a multiple of JAX's mean bfloat16-against-float32 spread)
BLOCK_CASES = {
    "DySample": (lambda dt: JB.DySample(32, dtype=dt), lambda: TB.DySample(32), (2, 40, 40, 32),
                 0.25),
    "A2C2f_gamma": (lambda dt: JB.A2C2f(64, 1, True, 4, residual=True, mlp_ratio=1.5, dtype=dt),
                    lambda: TB.A2C2f(64, 64, 1, True, 4, residual=True, mlp_ratio=1.5),
                    (2, 8, 8, 64), 2.0),
    "AdaHyperedgeGen": (lambda dt: JB.AdaHyperedgeGen(32, 8, 2, dtype=dt),
                        lambda: TB.AdaHyperedgeGen(32, 8, 2), (2, 36, 32), 2.0),
    "FullPAD_Tunnel": (lambda dt: JB.FullPAD_Tunnel(dtype=dt), lambda: TB.FullPAD_Tunnel(),
                       [(2, 8, 8, 16), (2, 8, 8, 16)], 2.0),
}


def _block_io(shape, seed):
    """bfloat16-valued float32 input(s): both sides read the same values."""
    rng = np.random.default_rng(seed)
    if isinstance(shape, list):
        return [_round_bf16(rng.normal(0.0, 1.0, s).astype(np.float32)) for s in shape]
    return _round_bf16(rng.normal(0.0, 1.0, shape).astype(np.float32))


def _to_port(x):
    """NHWC numpy → the port's layout (NCHW for images, as is for tokens)."""
    return to_nchw(x) if x.ndim == 4 else torch.from_numpy(np.ascontiguousarray(x))


def _from_port(t):
    return to_nhwc(t.float()) if t.dim() == 4 else _np(t)


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_block_bf16_matches_jax_bf16(case):
    make_j, make_t, shape, mean_bar = BLOCK_CASES[case]
    x = _block_io(shape, 1)
    xs = x if isinstance(x, list) else [x]
    jin = [jnp.asarray(a) for a in xs]
    shapes = jax.eval_shape(make_j(jnp.float32).init, jax.random.PRNGKey(0),
                            jin if isinstance(x, list) else jin[0])
    variables = random_variables(shapes, np.random.default_rng(0))

    def run_jax(dt):
        args = [a.astype(dt) for a in jin]
        out = make_j(dt).apply(jax_tree(variables), args if isinstance(x, list) else args[0])
        assert out.dtype == dt
        return np.asarray(out.astype(jnp.float32))

    j16, j32 = run_jax(jnp.bfloat16), run_jax(jnp.float32)
    tm = make_t()
    load_jax_variables(tm, variables)
    tm.eval()
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    tin = [_to_port(a).to(BF16) for a in xs]
    bad, handles = _all_bf16_activations(tm)
    with torch.no_grad():
        out = tm(tin if isinstance(x, list) else tin[0])
    for h in handles:
        h.remove()
    assert out.dtype == BF16 and not bad, bad
    t16 = _from_port(out)
    spread_max, spread_mean = np.abs(j16 - j32).max(), np.abs(j16 - j32).mean()
    d = np.abs(t16 - j16)
    print(f"{case}: port vs JAX bf16 max {d.max():.3g} mean {d.mean():.3g}; JAX bf16 vs f32 "
          f"max {spread_max:.3g} mean {spread_mean:.3g}")
    assert spread_mean > 0
    assert d.max() <= 4 * spread_max and d.mean() <= mean_bar * spread_mean


# ---------------------------------------------------------------- (b, c) kernels


@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_sample_bilinear_bf16_plain_matches_pallas_sample(padding_mode):
    """The plain version in bfloat16 (float32 taps, weights and blend on the
    upcast inputs, the output rounded once: what the bfloat16 K2 kernel
    computes) against the TPU kernel `_pallas_sample` in interpret mode on
    the same bfloat16 x and coordinates. The TPU kernel rounds its 1-D tap
    weights to bfloat16 (`_tap_matrix`, relative error <= 2^-9 each, more
    where 1 - frac or the frac of a negative coordinate rounds) and their
    product again (`_kernel`: `(ay * ax).astype(x.dtype)`), then sums in
    float32 and rounds the output once. The four weights sum to 1, so the
    two sides differ by at most about 3 x 2^-9 of max |x| from the weights
    plus a rounding of the output on each side: bar 2^-7 of max |x|."""
    rng = np.random.default_rng(30)
    b, h, w, c, n = 2, 9, 7, 16, 200
    x = _round_bf16(rng.normal(0.0, 1.0, (b, h, w, c)).astype(np.float32))
    gy = _round_bf16(rng.uniform(-1.5, h + 0.5, (b, n)).astype(np.float32))
    gx = _round_bf16(rng.uniform(-1.5, w + 0.5, (b, n)).astype(np.float32))
    ref = _pallas_sample(*(jnp.asarray(a, jnp.bfloat16) for a in (x, gy, gx)), padding_mode,
                         interpret=True)
    assert ref.dtype == jnp.bfloat16
    tx, ty, tz = (torch.from_numpy(a).to(BF16) for a in (x, gy[..., None], gx[..., None]))
    got = TS.sample_bilinear(tx, ty, tz, padding_mode)
    assert got.dtype == BF16
    d = np.abs(_np(got) - np.asarray(ref.astype(jnp.float32)))
    print(f"max |d| {d.max():.3g} of max |x| {np.abs(x).max():.3g}")
    assert d.max() <= 2 ** -7 * np.abs(x).max()


@pytest.mark.parametrize("n", [100, 400])
def test_area_attention_bf16_plain_matches_pallas_flash_attention(n):
    """The plain version in bfloat16 (float32 on the upcast q, k, v, output
    rounded once: what the bfloat16 K3 kernels compute, as the JAX flash
    path does, blocks.py:876,885) against JAX's Pallas `flash_attention` in
    interpret mode on the same bfloat16-valued q, k, v cast to float32, its
    output rounded to bfloat16: within one bfloat16 step of the output, and
    near 0, where that step is finer than the two float32 results' own
    difference (2.4e-7 here), within 1e-6 of max |v|."""
    q, k, v = (_round_bf16(a) for a in _qkv(n + 7, (1, n, 2, 32)))
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        ref = _pallas_area_attention(*(jnp.asarray(a) for a in (q, k, v)))
    ref = np.asarray(ref.astype(jnp.bfloat16).astype(jnp.float32))
    got = TA.area_attention(*(torch.from_numpy(a).to(BF16) for a in (q, k, v)))
    assert got.dtype == BF16
    assert (np.abs(_np(got) - ref) <= _bf16_ulp(ref) + 1e-6 * np.abs(v).max()).all()


# ---------------------------------------------------------------- (d) decode


def _smoke_variables(variables):
    """The smoke's settings on JAX's default init: FullPAD gates 0.5 (they
    start at 0 and would hide the tunnels) and Detect class biases 0 (the
    bias prior holds every score near 0)."""
    for mod in variables["params"].values():
        if "gate" in mod:
            mod["gate"] = np.full_like(mod["gate"], 0.5)
        for sub, leaf in mod.items():
            if sub.startswith("cv3_") and sub.endswith("_2"):
                leaf["conv"]["bias"] = np.zeros_like(leaf["conv"]["bias"])
    return variables


@functools.lru_cache(maxsize=None)
def _jax_decoders(cfg, nc):
    """{name: (JAX model, its jitted decode)} in float32 and bfloat16."""
    out = {}
    for name, dt in (("j32", jnp.float32), ("j16", jnp.bfloat16)):
        jm = JaxDetectionModel(cfg, nc=nc, dtype=dt)
        out[name] = (jm, jax.jit(lambda v, img, jm=jm: jm.decode_outputs(jm.module.apply(v, img))))
    return out


@functools.lru_cache(maxsize=None)
def _decode_run(cfg, nc, variables_kind):
    """JAX's float32 and bfloat16 decode and the port's bfloat16 one, on the
    same variables and 2 uniform images at 64 px. `variables_kind`: "smoke",
    JAX's default init with the smoke's settings; "perturbed", the tests'
    variables (BatchNorm statistics and biases drawn, gates 0.5:
    tests/test_torch_modules.py), on which the scores carry signal."""
    decoders = _jax_decoders(cfg, nc)
    x = np.random.default_rng(3).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    jm32 = decoders["j32"][0]
    if variables_kind == "smoke":
        init = jm32.init(jax.random.PRNGKey(0), imgsz=IMGSZ)
        variables = _smoke_variables(jax.tree_util.tree_map(np.array, init))
    else:
        shapes = jax.eval_shape(jm32.module.init, jax.random.PRNGKey(0), jnp.asarray(x))
        variables = random_variables(shapes, np.random.default_rng(4))
    out = {name: fn(jax_tree(variables), jnp.asarray(x)) for name, (_, fn) in decoders.items()}
    tm = DetectionModel(cfg, nc=nc, device="cpu", dtype=BF16)
    load_jax_variables(tm, variables)
    bad, handles = _all_bf16_activations(tm)
    out["t16"] = tm.predict(torch.from_numpy(x))
    for h in handles:
        h.remove()
    out["bad"] = bad
    out["tm"] = tm
    return out


@pytest.mark.parametrize("variables_kind", ["smoke", "perturbed"])
@pytest.mark.parametrize("cfg,nc", [("yolov13n_DBL.yaml", 3), ("yolov13n.yaml", 80)])
def test_bf16_decode_matches_jax(cfg, nc, variables_kind):
    """Port bfloat16 against JAX bfloat16 within 4x JAX's own bfloat16-
    against-float32 spread, boxes and scores apart. Against JAX float32:
    within check_amp's bars on the smoke's variables. On JAX's default init
    the scores stay within 2e-4 of 0.5, even with the smoke's gates of 0.5
    and class biases of 0, so the perturbed variables give them signal; on
    those, JAX's own bfloat16 decode misses check_amp's box bar (1.28 px at
    64 px: it reads 1.5 px on YOLO-DBL-n, 2.1 px on YOLOv13-n), so there the
    port is held to JAX float32 within 2x JAX bfloat16's own distance."""
    r = _decode_run(cfg, nc, variables_kind)
    assert r["j16"].dtype == jnp.bfloat16 and r["t16"].dtype == BF16 and not r["bad"], r["bad"]
    j32, j16, t16 = (np.asarray(a, np.float32) if not torch.is_tensor(a) else _np(a)
                     for a in (r["j32"], r["j16"].astype(jnp.float32), r["t16"]))
    assert t16.shape == j32.shape == (2, 4 + nc, 84) and np.isfinite(t16).all()
    assert all(p.dtype == torch.float32 for p in r["tm"].parameters())
    spread = {k: float(np.abs(j16[:, s] - j32[:, s]).max())
              for k, s in (("box", slice(0, 4)), ("score", slice(4, None)))}
    vs16 = {k: float(np.abs(t16[:, s] - j16[:, s]).max())
            for k, s in (("box", slice(0, 4)), ("score", slice(4, None)))}
    vs32 = {k: float(np.abs(t16[:, s] - j32[:, s]).max())
            for k, s in (("box", slice(0, 4)), ("score", slice(4, None)))}
    print(f"{cfg}: JAX bf16 vs f32 {spread}; port bf16 vs JAX bf16 {vs16}; port bf16 vs JAX "
          f"f32 {vs32}; scores up to {float(j32[:, 4:].max()):.3g}")
    assert vs16["box"] <= 4 * spread["box"] and vs16["score"] <= 4 * spread["score"]
    if variables_kind == "smoke":
        assert vs32["box"] < AMP_BOX and vs32["score"] < AMP_SCORE
    else:
        assert spread["score"] > 1e-3  # the scores carry signal
        assert vs32["box"] <= 2 * spread["box"] and vs32["score"] <= 2 * spread["score"]


def test_nms_takes_bf16_predictions_like_jax():
    """bfloat16 predictions: JAX's NMS suppresses with float32 class indices
    (nms.py:144), so its class offsets (up to 79 x 7680) keep every box
    apart; the port's does the same and returns the same float32 rows."""
    r = _decode_run("yolov13n.yaml", 80, "perturbed")
    pred = r["j16"]
    dj, nj = jax_nms(pred, conf_thres=0.25, iou_thres=0.45)
    dt, nt = torch_nms(torch.from_numpy(np.asarray(pred.astype(jnp.float32))).to(BF16),
                       conf_thres=0.25, iou_thres=0.45)
    assert dj.dtype == jnp.float32 and dt.dtype == torch.float32
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert int(nt.min()) > 0
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


# ---------------------------------------------------------------- (e) train step


def _batch(imgsz, seed, b=2, m=5, nc=3):
    """A seeded batch of the loss's contract (tests/test_torch_train.py's,
    at `imgsz`)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.25, 0.75, (b, m, 2))
    wh = rng.uniform(0.1, 0.5, (b, m, 2))
    return dict(img=rng.integers(0, 256, (b, imgsz, imgsz, 3), dtype=np.uint8),
                gt_boxes=np.concatenate([xy, wh], -1).astype(np.float32),
                gt_cls=rng.integers(0, nc, (b, m)).astype(np.int32),
                gt_mask=(np.arange(m)[None] < np.array([[3], [5]])).astype(np.float32))


def train_grads(imgsz, seeds, cfg="yolov13n_DBL.yaml"):
    """One train-mode loss and gradient of `cfg` for each (batch seed,
    variables seed) in `seeds`, from the same variables and batch on both
    sides: JAX in bfloat16 and in float64 (under jax.enable_x64), the port in
    bfloat16; dropout off on both sides (tests/test_torch_train.py says
    why). Each JAX step is compiled once for all seeds."""
    jm = JaxDetectionModel(cfg, nc=3)
    shapes = jax.eval_shape(jm.module.init, jax.random.PRNGKey(0),
                            jnp.zeros((2, imgsz, imgsz, 3), jnp.float32))
    runs = [dict(batch=_batch(imgsz, b_seed),
                 variables=random_variables(shapes, np.random.default_rng(v_seed)))
            for b_seed, v_seed in seeds]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        for name, dt in (("j16", jnp.bfloat16), ("j64", jnp.float64)):
            with jax.enable_x64(dt == jnp.float64):
                jmd = JaxDetectionModel(cfg, nc=3, dtype=dt)
                wide = jnp.float64 if dt == jnp.float64 else jnp.float32

                def loss_fn(p, stats, b, jmd=jmd, wide=wide):
                    outs, _ = jmd.module.apply({"params": p, "batch_stats": stats},
                                               jax_device_normalize(b["img"], wide), train=True,
                                               mutable=["batch_stats"])
                    return JD.detection_loss(outs, b, jmd.strides, jmd.nc)

                step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
                for run in runs:
                    params, stats = jax.tree_util.tree_map(
                        lambda a, wide=wide: jnp.asarray(a, wide),
                        (run["variables"]["params"], run["variables"]["batch_stats"]))
                    (loss, items), grads = step(params, stats,
                                                {k: jnp.asarray(v) for k, v in run["batch"].items()})
                    run[name] = dict(loss=float(loss), items=np.asarray(items, np.float64),
                                     grads=jax.tree_util.tree_map(np.asarray, grads))
    for run in runs:
        tm = DetectionModel(cfg, nc=3, device="cpu", dtype=BF16)
        load_jax_variables(tm, run["variables"])
        for m in tm.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        cfg_t = Trainer(tm, dict(TRAIN_OVERRIDES, imgsz=imgsz)).cfg
        names, params = zip(*tm.named_parameters())
        loss, items = train_loss(tm, cfg_t, {k: torch.as_tensor(v) for k, v in run["batch"].items()})
        grads = torch.autograd.grad(loss, params)
        run["t16"] = dict(loss=float(loss.detach()),
                          items=np.array([float(v.detach()) for v in items], np.float64),
                          grads=dict(zip(names, grads)), loss_dtype=loss.dtype,
                          items_dtype=[v.dtype for v in items])
        for name in ("j16", "j64"):
            run[name]["grads"] = params_from_jax(tm, run[name]["grads"])
    return runs


@pytest.fixture(scope="module")
def train_bf16():
    return train_grads(TRAIN_IMGSZ, TRAIN_SEEDS)


def _median(values):
    return float(np.median(np.asarray(values)))


def test_bf16_train_step_loss_matches_jax_float64(train_bf16):
    """The loss is float32 (the maps are cast to float32, losses/detection.py:67,
    JAX :87); its value and items, as the median over the seeds of the
    distance from JAX's float64 ones, within 4x JAX bfloat16's median. One
    draw is not enough: the classification item is a sum over every anchor
    divided by TAL's target-score sum, and on these seeds the port's distance
    reads 0.1-21x JAX's (medians 0.6-1.8x)."""
    d_t, d_j = [], []
    for run in train_bf16:
        t, j16, j64 = run["t16"], run["j16"], run["j64"]
        assert t["loss_dtype"] == torch.float32 and set(t["items_dtype"]) == {torch.float32}
        want = np.append(j64["items"], j64["loss"])
        d_t.append(np.abs(np.append(t["items"], t["loss"]) - want))
        d_j.append(np.abs(np.append(j16["items"], j16["loss"]) - want))
    med_t, med_j = np.median(d_t, 0), np.median(d_j, 0)
    print(f"|d| from float64 (box, cls, dfl, loss) by seed: port bf16 {d_t}, JAX bf16 {d_j}")
    loss = min(abs(run["j64"]["loss"]) for run in train_bf16)
    assert (med_t <= 4 * med_j + 1e-6 * loss).all(), (med_t, med_j)


def test_bf16_train_step_gradients_match_jax_float64(train_bf16):
    """The port's bfloat16 gradient (float32, as the parameters) against
    JAX's float64 one, held to JAX bfloat16's own distance from it, as
    medians over the seeds.

    In train mode at 128 px both bfloat16 steps are about half a gradient
    away from float64: JAX's whole gradient reads 0.48-0.52 of its norm
    (cosine 0.87-0.88) and a typical leaf 0.52 of its largest (median over
    leaves; 10% of leaves 0.33 or less). A single seed's leaf is a draw of
    that noise: one seed puts the port past 4x JAX on 1-7 of 399 leaves and
    JAX past 4x the port on 2-6, on both sides mostly FullPAD gates and
    Detect classification leaves, none of them on every seed. So:
    - every leaf, the 7 gates and the 6 DySample offset convs (whose
      gradient comes only through K2's backward) included: the median over
      the seeds of its largest |d| from float64 within 4x JAX bfloat16's
      median (plus 1e-10 of the model's largest |g64|, for leaves whose
      exact gradient is 0);
    - the whole gradient: the median of its distance from float64 (L2 over
      every leaf, relative to float64's norm) within 1.5x JAX's median. Two
      bfloat16 roundings of one step are equally far from float64 in
      distribution (per seed the port reads 0.91-1.32x JAX); a zero gradient
      reads 1.0, about 2x JAX.
    Against that noise the per-leaf bar catches a sign-flipped leaf on less
    than half of the leaves and a zeroed one on few: it holds the port's
    bfloat16 to JAX's, not to float64."""
    per_leaf, whole = {}, {"port": [], "jax": []}
    for run in train_bf16:
        t, j16, j64 = (run[k]["grads"] for k in ("t16", "j16", "j64"))
        assert set(t) == set(j16) == set(j64)
        assert all(g.dtype == torch.float32 for g in t.values())
        g_max = max(float(g.abs().max()) for g in j64.values())
        norm64 = sum(float((g ** 2).sum()) for g in j64.values()) ** 0.5
        for k, g in (("port", t), ("jax", j16)):
            whole[k].append(sum(float(((g[n].double() - j64[n]) ** 2).sum())
                                for n in j64) ** 0.5 / norm64)
        for n, ref in j64.items():
            per_leaf.setdefault(n, []).append(
                (float((t[n].double() - ref).abs().max()),
                 float((j16[n].double() - ref).abs().max()), 1e-10 * g_max))
    med = {n: [_median([r[i] for r in rows]) for i in range(3)] for n, rows in per_leaf.items()}
    ratio = sorted((e_t / e_j, n) for n, (e_t, e_j, _) in med.items() if e_j)
    print(f"relative L2 from float64 by seed: {whole}; largest port/JAX ratios of the "
          f"per-leaf medians: {ratio[-5:]}")
    assert _median(whole["port"]) <= 1.5 * _median(whole["jax"])
    failing = {n: e for n, e in med.items() if e[0] > 4 * e[1] + e[2]}
    assert not failing, failing
    gates = [n for n in med if n.endswith(".gate")]
    offsets = [n for n in med if ".offset.conv." in n]
    assert len(gates) == 7 and len(offsets) == 6
    assert all(float(run["t16"]["grads"][n].abs().max()) > 0 for run in train_bf16
               for n in offsets)


def test_bf16_trainer_keeps_float32_state():
    """A bfloat16 model's train step: parameters, their gradients, the
    optimizer, the EMA and BatchNorm's running statistics stay float32
    (JAX's optax state and EMA are float32); activations are bfloat16."""
    tm = DetectionModel("yolov13n_DBL.yaml", nc=3, device="cpu", dtype=BF16)
    trainer = Trainer(tm, TRAIN_OVERRIDES).setup(5)
    before = [p.detach().clone() for p in tm.parameters()]
    bad, handles = _all_bf16_activations(tm)
    for seed in (23, 24):  # the schedule's first step has a learning rate of 0
        metrics = trainer.step(_batch(IMGSZ, seed))
    for h in handles:
        h.remove()
    assert not bad, bad
    assert all(np.isfinite(float(v)) and v.dtype == torch.float32 for v in metrics.values())
    assert trainer.optimizer.count == 2
    state = tm.state_dict()
    assert all(v.dtype in (torch.float32, torch.int64) for v in state.values())
    assert all(t.dtype == torch.float32 for t in trainer.ema + trainer.optimizer.trace)
    moved = sum(not torch.equal(a, p) for a, p in zip(before, tm.parameters()))
    assert moved > 0.5 * len(before)
    assert not tm.training


def test_device_normalize_bf16_is_jax_float32_rounded_once():
    """The batch's /255 in bfloat16 gives the bits flax's first bfloat16
    layer makes of JAX's float32 /255: every uint8 value."""
    u8 = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    got = TP.device_normalize(torch.from_numpy(u8), BF16)
    want = jax_device_normalize(jnp.asarray(u8)).astype(jnp.bfloat16)
    assert got.dtype == BF16
    np.testing.assert_array_equal(_np(got), np.asarray(want.astype(jnp.float32)))


# ---------------------------------------------------------------- (f) K1


@pytest.mark.parametrize("in_hw,out_hw", [((512, 768), (640, 640)), ((251, 333), (257, 330)),
                                          ((100, 60), (128, 128))])
def test_letterbox_bf16_is_float32_rounded_once(in_hw, out_hw):
    """K1's bfloat16 output (the plain version here, the kernel on the card)
    is its float32 output rounded once, bit for bit: what flax's first
    bfloat16 layer makes of the float32 canvas JAX's predictor hands it."""
    img = torch.from_numpy(np.random.default_rng(31).integers(0, 256, (1, *in_hw, 3),
                                                              dtype=np.uint8))
    f32 = TP.letterbox_normalize(img, out_hw)
    bf16 = TP.letterbox_normalize(img, out_hw, out_dtype=BF16)
    assert bf16.dtype == BF16 and torch.equal(bf16, f32.to(BF16))


def test_bf16_predictor_asks_k1_for_bf16():
    """The predictor of a bfloat16 model hands it K1's bfloat16 canvas; its
    boxes are the model's prediction on the float32 canvas rounded once."""
    r = _decode_run("yolov13n_DBL.yaml", 3, "perturbed")
    tm = r["tm"]
    frames = np.random.default_rng(32).integers(0, 256, (2, 50, 70, 3), dtype=np.uint8)
    seen, forward = [], tm.forward
    tm.forward = lambda x: (seen.append(x.dtype), forward(x))[1]
    kernels.reset_launches()
    dets, counts = DetectionPredictor(tm, conf=0.01, imgsz=IMGSZ).infer(torch.from_numpy(frames))
    del tm.forward
    assert seen == [BF16] and sum(kernels.launches.values()) == 0
    canvas = TP.letterbox_normalize(torch.from_numpy(frames), (IMGSZ, IMGSZ))
    want = torch_nms(tm.predict(canvas.to(BF16)), conf_thres=0.01)
    assert torch.equal(dets, want[0]) and torch.equal(counts, want[1])
    assert int(counts.min()) > 0


def test_detection_model_dtype_policy():
    """float32 is the default; bfloat16 keeps float32 parameters and running
    statistics; other types are refused; a float64 copy computes in float64."""
    assert DetectionModel("yolov13n_DBL.yaml", nc=3, device="cpu").dtype == torch.float32
    tm = DetectionModel("yolov13n_DBL.yaml", nc=3, device="cpu", dtype=BF16)
    assert tm.dtype == BF16
    assert all(v.dtype in (torch.float32, torch.int64) for v in tm.state_dict().values())
    with pytest.raises(TypeError):
        DetectionModel("yolov13n_DBL.yaml", nc=3, device="cpu", dtype=torch.float16)
    m64 = copy.deepcopy(tm).double()
    assert m64.dtype == torch.float64
    with torch.no_grad():
        feats = m64(torch.rand(1, IMGSZ, IMGSZ, 3, dtype=torch.float64))
    assert all(f.dtype == torch.float64 for f in feats)
