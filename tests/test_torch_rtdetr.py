"""Shared-weight parity of RT-DETR's modules in the port with the JAX package.

HGStem, HGBlock and RepC3 (nn/blocks.py), sincos_2d_position, TorchMHA and
AIFI (nn/attention/extra.py), _inverse_sigmoid, MSDeformAttn,
DeformableDecoderLayer, RTDETRDecoder and rtdetr_postprocess
(models/rtdetr.py), hungarian_match and rtdetr_loss (losses/detr.py). Each
case builds the JAX module and its port at narrow widths, draws one set of
variables with numpy (`detr_variables`: every leaf, the packed attention
projection and the class embedding too), loads them through the weight
bridge and compares in float32. Tolerance: 1e-4 absolute and relative
(float32 sums of up to a few hundred terms in another order), boxes 0.05 px
and scores 1e-3 after the decode, gradients 1e-3 of each leaf's largest.

AIFI runs at H != W (its position embedding is built with w and h swapped);
MSDeformAttn samples points off the map (zeros padding: they read 0); the
narrow decoder is tests/test_zoo.py's (hd 64, 20 queries, 2 layers, 4
heads, more tokens than queries) and a second one whose widest level has
anchors outside (0.01, 0.99), so that +inf logits reach the selected
queries. The train-mode gradient holds the decoder's detached queries and
references and layer 1's gradient through layer 0's undetached box.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_dbl_tpu.losses import detr as JD
from yolo_dbl_tpu.models import rtdetr as JR
from yolo_dbl_tpu.nn import blocks as JB
from yolo_dbl_tpu.nn.attention import extra as JA

from yolo_dbl_tpu_torch.losses import detr as TD
from yolo_dbl_tpu_torch.models import rtdetr as TR
from yolo_dbl_tpu_torch.nn import blocks as TB
from yolo_dbl_tpu_torch.nn.attention import extra as TA
from yolo_dbl_tpu_torch.utils.convert import (jax_param_paths, load_jax_variables, params_from_jax,
                                              state_dict_from_jax)

from tests.test_task_losses import _detr_batch
from tests.test_torch_modules import jax_tree, random_variables, run_pair, to_nchw, to_nhwc
from tests.torch_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)

ATOL = RTOL = 1e-4
# RT-DETR's own leaves: the packed attention projection and the class embedding
DETR_LEAVES = {
    "in_proj_weight": lambda rng, shape: rng.normal(0.0, 1.0 / np.sqrt(shape[1]), shape),
    "in_proj_bias": lambda rng, shape: rng.normal(0.0, 0.2, shape),
    "embedding": lambda rng, shape: rng.normal(0.0, 1.0, shape),
}


def detr_variables(shapes, rng):
    """`random_variables` for a JAX variables shape tree, RT-DETR's own
    leaves (DETR_LEAVES) drawn too; float32."""

    def draw(path, leaf):
        name = str(path[-1].key)
        if name in DETR_LEAVES:
            return DETR_LEAVES[name](rng, leaf.shape).astype(np.float32)
        return random_variables({name: leaf}, rng)[name].astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(0.0, scale, shape)).astype(np.float32)


def _pair(jax_module, torch_module, jax_args, seed=0, **kw):
    """Shared variables of `jax_module` at `jax_args`, loaded into the port's
    module: (variables, JAX output, port module in eval mode)."""
    jargs = jax.tree_util.tree_map(jnp.asarray, jax_args)
    shapes = jax.eval_shape(lambda k: jax_module.init(k, *jargs, **kw), jax.random.PRNGKey(0))
    variables = detr_variables(shapes, np.random.default_rng(seed))
    out = jax.jit(lambda v, *a: jax_module.apply(v, *a, **kw))(jax_tree(variables), *jargs)
    load_jax_variables(torch_module, variables)
    return variables, out, torch_module.eval()


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


# {case: (JAX module, port module, NHWC input shape)}
BLOCK_CASES = {
    "HGStem": (lambda: JB.HGStem(16, 24), lambda: TB.HGStem(3, 16, 24), (2, 17, 22, 3)),
    "HGBlock": (lambda: JB.HGBlock(8, 32, 3, 3), lambda: TB.HGBlock(16, 8, 32, 3, 3),
                (2, 9, 11, 16)),
    "HGBlock_light_shortcut": (lambda: JB.HGBlock(8, 16, 5, 2, True, True),
                               lambda: TB.HGBlock(16, 8, 16, 5, 2, True, True), (2, 10, 8, 16)),
    "HGBlock_shortcut_widths_differ": (lambda: JB.HGBlock(8, 32, 3, 2, False, True),
                                       lambda: TB.HGBlock(16, 8, 32, 3, 2, False, True),
                                       (2, 8, 8, 16)),
    "RepC3": (lambda: JB.RepC3(16, 2), lambda: TB.RepC3(24, 16, 2), (2, 9, 10, 24)),
    "RepC3_cv3": (lambda: JB.RepC3(16, 1, 0.5), lambda: TB.RepC3(24, 16, 1, 0.5), (2, 8, 8, 24)),
}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_backbone_and_neck_blocks_match_jax(case):
    """The HGNetV2 stem (one shared pad before stem2a and the pool, odd
    sizes), HG blocks with plain and light convs, with and without the
    residual, and RepC3 with and without cv3."""
    make_j, make_t, shape = BLOCK_CASES[case]
    x = _normal(shape, 1)
    tm = make_t()
    if case.startswith("RepC3"):
        assert (tm.cv3 is None) == (case == "RepC3")
    out_j, out_t = run_pair(make_j(), tm, x)
    _close(to_nhwc(out_t), out_j)


def test_sincos_position_matches_jax_at_h_ne_w():
    for h, w, dim in ((3, 5, 16), (7, 2, 32)):
        _close(TA.sincos_2d_position(h, w, dim).numpy(), JA.sincos_2d_position(h, w, dim),
               atol=1e-5, rtol=1e-5)


def test_torch_mha_matches_jax_and_keeps_torch_layout():
    q, k, v = (_normal((2, 7, 32), s) for s in (2, 3, 4))
    variables, out_j, tm = _pair(JA.TorchMHA(4), TA.TorchMHA(32, 4), (q, k, v))
    with torch.no_grad():
        out_t = tm(*(torch.from_numpy(a) for a in (q, k, v)))
    _close(out_t.numpy(), out_j)
    # the packed projection is copied as it is: (3C, C), torch's own layout
    np.testing.assert_array_equal(tm.in_proj_weight.detach().numpy(),
                                  variables["params"]["in_proj_weight"])


@pytest.mark.parametrize("hw", [(5, 7), (6, 4)])
def test_aifi_matches_jax_at_h_ne_w(hw):
    """AIFI on an H != W map: the token order, the swapped position builder
    and the erf GELU."""
    x = _normal((2, *hw, 32), 5)
    _, out_j, tm = _pair(JA.AIFI(32, num_heads=4, cm=64), TA.AIFI(32, 64, 4), (x,))
    with torch.no_grad():
        out_t = tm(to_nchw(x))
    _close(to_nhwc(out_t), out_j)


def test_inverse_sigmoid_matches_jax_with_its_gradient():
    x = np.array([-0.5, 0.0, 1e-7, 0.2, 0.5, 0.9999999, 1.0, 1.5], np.float32)
    want, gj = jax.value_and_grad(lambda a: JR._inverse_sigmoid(a).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = TR._inverse_sigmoid(xt)
    (gt,) = torch.autograd.grad(got.sum(), xt)
    _close(got.detach().numpy(), np.asarray(JR._inverse_sigmoid(jnp.asarray(x))), atol=1e-5)
    _close(gt.numpy(), gj, atol=1e-3, rtol=1e-5)


def test_descending_sort_keeps_top_k_tie_order():
    """Ties come out in index order, as jax.lax.top_k and jnp.argsort(-x)
    give them."""
    s = np.array([[0.5, 0.9, 0.5, 0.9, 0.1, 0.5, 0.9, 0.5]], np.float32)
    idx_t = TR.sort_descending(torch.from_numpy(s), 1)[1][:, :6].numpy()
    np.testing.assert_array_equal(idx_t, np.asarray(jax.lax.top_k(jnp.asarray(s), 6)[1]))
    np.testing.assert_array_equal(TR.sort_descending(torch.from_numpy(s), 1)[1].numpy(),
                                  np.asarray(jnp.argsort(-jnp.asarray(s), axis=-1)))


def _deform_inputs(b=2, q=9, c=32, shapes=((6, 10), (3, 5)), seed=6):
    rng = np.random.default_rng(seed)
    query = rng.normal(0, 1, (b, q, c)).astype(np.float32)
    # centres anywhere, sides up to the whole map: many points fall off it
    refer = np.concatenate([rng.uniform(0, 1, (b, q, 2)), rng.uniform(0.2, 1.0, (b, q, 2))],
                           -1).astype(np.float32)
    values = [rng.normal(0, 1, (b, h, w, c)).astype(np.float32) for h, w in shapes]
    return query, refer, values


def _off_map_share(tm, query, refer, values):
    """The share of MSDeformAttn's sampling points whose taps all fall off
    their level's map (each reads 0)."""
    b, q, c = query.shape
    with torch.no_grad():
        off = tm.sampling_offsets(torch.from_numpy(query)).reshape(
            b, q, tm.n_heads, tm.n_levels, tm.n_points, 2)
    r = torch.from_numpy(refer)[:, :, None, None, None]
    locs = r[..., :2] + off / tm.n_points * r[..., 2:] * 0.5
    outside = []
    for lvl, v in enumerate(values):
        h, w = v.shape[1:3]
        gx, gy = locs[..., lvl, :, 0] * w - 0.5, locs[..., lvl, :, 1] * h - 0.5
        outside.append((gx <= -1) | (gx >= w) | (gy <= -1) | (gy >= h))
    return float(torch.stack(outside).float().mean())


def test_ms_deform_attn_matches_jax_with_points_off_the_map():
    """The port samples the 4 heads as 4 channel groups of the untransposed
    value in one call a level; JAX transposes and samples each head. Both
    with zeros padding."""
    query, refer, values = _deform_inputs()
    jm = JR.MSDeformAttn(32, n_levels=2, n_heads=4, n_points=2)
    _, out_j, tm = _pair(jm, TR.MSDeformAttn(32, 2, 4, 2), (query, refer, values), seed=7)
    with torch.no_grad():
        out_t = tm(torch.from_numpy(query), torch.from_numpy(refer),
                   [torch.from_numpy(v) for v in values])
    _close(out_t.numpy(), out_j)
    assert 0.05 < _off_map_share(tm, query, refer, values) < 0.9


def test_deformable_decoder_layer_matches_jax():
    query, refer, values = _deform_inputs(seed=8)
    pos = _normal(query.shape, 9)
    jm = JR.DeformableDecoderLayer(32, n_heads=4, n_levels=2, n_points=2, d_ffn=48)
    _, out_j, tm = _pair(jm, TR.DeformableDecoderLayer(32, 4, 2, 2, 48),
                         (query, refer, values, pos), seed=10)
    with torch.no_grad():
        out_t = tm(*(torch.from_numpy(a) for a in (query, refer)),
                   [torch.from_numpy(v) for v in values], torch.from_numpy(pos))
    _close(out_t.numpy(), out_j)


# (level (H, W) shapes, nq): tests/test_zoo.py's decoder, 336 tokens for 20 queries; and
# one whose widest level is 56 wide, so its first and last columns' anchors lie outside
# (0.01, 0.99), with fewer tokens (294) than queries, so every one is selected
DECODERS = {"zoo_20_queries": (((16, 16), (8, 8), (4, 4)), 20),
            "inf_anchors_selected": (((4, 56), (2, 28), (1, 14)), 300)}


def _decoder_pair(case, train=False, seed=11):
    shapes, nq = DECODERS[case]
    feats = [_normal((2, h, w, 64), seed + i) for i, (h, w) in enumerate(shapes)]
    jm = JR.RTDETRDecoder(nc=5, ch=(64, 64, 64), hd=64, nq=nq, ndl=2, nh=4)
    tm = TR.RTDETRDecoder(nc=5, ch=(64, 64, 64), hd=64, nq=nq, ndl=2, nh=4)
    variables, out_j, tm = _pair(jm, tm, (feats,), seed=seed, train=False)
    return jm, tm, variables, feats, out_j


@pytest.mark.parametrize("case", sorted(DECODERS))
def test_decoder_and_postprocess_match_jax(case):
    """The four outputs, and rtdetr_postprocess's rows within 0.05 px and
    1e-3 (the same query order: the selection and the sort hold JAX's tie
    order). Where invalid anchors are selected their +inf logit gives
    boxes of 1 and no NaN on either side."""
    jm, tm, _, feats, out_j = _decoder_pair(case)
    with torch.no_grad():
        out_t = tm([to_nchw(f) for f in feats])
    nq = min(DECODERS[case][1], sum(h * w for h, w in DECODERS[case][0]))
    assert out_t[0].shape == (2, 2, nq, 4) and out_t[1].shape == (2, 2, nq, 5)
    for a, b in zip(out_t, out_j, strict=True):
        assert np.isfinite(np.asarray(b)).all() and bool(torch.isfinite(a).all())
        _close(a.numpy(), b)
    dets_j = np.asarray(JR.rtdetr_postprocess(out_j[0], out_j[1], img_size=128))
    dets_t = TR.rtdetr_postprocess(out_t[0], out_t[1], img_size=128).numpy()
    assert dets_t.shape == dets_j.shape == (2, nq, 6)
    assert np.abs(dets_t[..., :4] - dets_j[..., :4]).max() < 0.05
    assert np.abs(dets_t[..., 4] - dets_j[..., 4]).max() <= 1e-3
    np.testing.assert_array_equal(dets_t[..., 5], dets_j[..., 5])
    if case == "inf_anchors_selected":
        assert (np.asarray(out_j[2]) == 1.0).all(-1).any() and (out_t[2] == 1.0).all(-1).any()


def _train_loss_weights(out_j, seed=12):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, np.shape(o)).astype(np.float32) for o in out_j]


def test_decoder_train_gradient_chain_matches_jax():
    """Train mode: one gradient of a fixed weighted sum of the four outputs
    within 1e-3 of each leaf's largest, over every leaf, in float64 on both
    sides (JAX under jax.enable_x64): the train-mode BatchNorms of the input
    projections normalize 28 values at the narrowest level, where the two
    frameworks' float32 gradients part by 1.16e-3 of `input_proj_1_1`'s
    largest. JAX detaches the selected queries and every layer's reference
    box, and gives layer 1's box the gradient through layer 0's undetached
    one: a port that loses or adds that path fails `dec_bbox_head_0`'s
    leaves. The class embedding gets a zero gradient on both sides."""
    case = "inf_anchors_selected"
    _, tm, variables, feats, out_j = _decoder_pair(case)
    weights = [w.astype(np.float64) for w in _train_loss_weights(out_j)]
    wide = jax.tree_util.tree_map(lambda a: a.astype(np.float64), variables)
    feats = [f.astype(np.float64) for f in feats]
    with jax.enable_x64(True):
        jm = JR.RTDETRDecoder(nc=5, ch=(64, 64, 64), hd=64, nq=DECODERS[case][1], ndl=2, nh=4,
                              dtype=jnp.float64)

        def loss_j(params):
            out, _ = jm.apply({"params": params, "batch_stats": jax_tree(wide["batch_stats"])},
                              [jnp.asarray(f) for f in feats], train=True,
                              mutable=["batch_stats"])
            return sum((o * w).sum() for o, w in zip(out, weights))

        grads_j = jax.tree_util.tree_map(np.asarray,
                                         jax.jit(jax.grad(loss_j))(jax_tree(wide["params"])))
    tm = tm.double().train()
    names, params = zip(*tm.named_parameters())
    out_t = tm([to_nchw(f) for f in feats])
    loss_t = sum((o * torch.from_numpy(w)).sum() for o, w in zip(out_t, weights))
    grads_t = dict(zip(names, torch.autograd.grad(loss_t, params, materialize_grads=True)))
    want = params_from_jax(tm, grads_j)
    for n in names:
        g, ref = grads_t[n].numpy(), want[n].numpy()
        assert np.isfinite(g).all(), n
        scale = max(float(np.abs(ref).max()), 1e-6)
        assert np.abs(g - ref).max() <= 1e-3 * scale, n
    assert float(np.abs(want["dec_bbox_head_0.layers_2.weight"].numpy()).max()) > 0
    assert not grads_t["denoising_class_embed.weight"].any()


def test_bridge_rules_for_packed_projection_and_embedding():
    """`in_proj_weight` and `in_proj_bias` are copied as they are (not
    through the Dense transpose), flax Embed's `embedding` is
    nn.Embedding's `weight`, and `jax_param_paths` inverts both."""
    rng = np.random.default_rng(13)
    w = rng.normal(size=(24, 8)).astype(np.float32)
    emb = rng.normal(size=(5, 8)).astype(np.float32)
    sd = state_dict_from_jax({"params": {"a": {"in_proj_weight": w, "in_proj_bias": w[:, 0]},
                                         "e": {"embedding": emb}}})
    np.testing.assert_array_equal(sd["a.in_proj_weight"].numpy(), w)
    np.testing.assert_array_equal(sd["a.in_proj_bias"].numpy(), w[:, 0])
    np.testing.assert_array_equal(sd["e.weight"].numpy(), emb)
    dec = TR.RTDETRDecoder(nc=5, ch=(8, 8, 8), hd=16, nq=4, ndl=1, nh=2)
    paths = jax_param_paths(dec)
    assert paths["denoising_class_embed.weight"] == "denoising_class_embed/embedding"
    assert paths["decoder_layers_0.self_attn.in_proj_weight"] == \
        "decoder_layers_0/self_attn/in_proj_weight"
    assert paths["decoder_layers_0.self_attn.out_proj.weight"] == \
        "decoder_layers_0/self_attn/out_proj/kernel"
    assert paths["enc_output_1.weight"] == "enc_output_1/scale"
    with pytest.raises(KeyError, match="no rule"):
        state_dict_from_jax({"params": {"a": {"mystery": w}}})


def _random_outputs(seed, b=2, layers=3, q=32, nc=3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.2, 0.8, (b, layers, q, 4)).astype(np.float32),
            rng.normal(-1, 1, (b, layers, q, nc)).astype(np.float32),
            rng.uniform(0.2, 0.8, (b, q, 4)).astype(np.float32),
            rng.normal(-1, 1, (b, q, nc)).astype(np.float32))


def test_hungarian_match_indices_match_jax():
    outs = _random_outputs(14, layers=1)
    batch = _detr_batch(b=2, m=8)
    args = (outs[0][:, 0], outs[1][:, 0], batch["gt_boxes"], batch["gt_cls"], batch["gt_mask"])
    idx_j = np.asarray(jax.jit(JD.hungarian_match)(*(jnp.asarray(a) for a in args)))
    idx_t = TD.hungarian_match(*(torch.from_numpy(np.asarray(a)) for a in args)).numpy()
    np.testing.assert_array_equal(idx_t, idx_j)
    assert (idx_t[:, 2:] == 0).all() and len(set(idx_t[0, :2])) == 2


def test_rtdetr_loss_items_and_gradients_match_jax():
    """The loss items (the final layer's GIoU, class, L1) within 1e-4
    relative, the total likewise, and the gradient of the total with
    respect to each output within 1e-3 of its largest, on JAX's
    `_detr_batch`; the matchings are equal."""
    outs = _random_outputs(15)
    batch = _detr_batch(b=2, m=8)
    (loss_j, items_j), grads_j = jax.jit(jax.value_and_grad(
        lambda o: JD.rtdetr_loss(o, batch, 3), has_aux=True))(tuple(jnp.asarray(o) for o in outs))
    outs_t = tuple(torch.from_numpy(o).requires_grad_() for o in outs)
    loss_t, items_t = TD.rtdetr_loss(outs_t, {k: torch.from_numpy(v) for k, v in batch.items()}, 3)
    grads_t = torch.autograd.grad(loss_t, outs_t)
    assert items_t._fields == ("giou", "cls", "l1")
    for k in items_t._fields:
        got = float(items_t._asdict()[k].detach())
        assert abs(got - float(items_j[k])) <= 1e-4 * abs(float(items_j[k]))
    assert abs(float(loss_t.detach()) - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    for g, r in zip(grads_t, grads_j):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= 1e-3 * np.abs(r).max()
