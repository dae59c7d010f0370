"""The module catalogue's YAML rows and its timer in the port against the JAX package, on the CPU.

Every attention and upsample name of the catalogue that JAX's compiler
takes as a row (`yolo_dbl_tpu/nn/tasks.py:318-415`, with the aliases
BAM_YOLO, MHSA_YOLO, BoTAttention_YOLO, EfficientAttention_YOLO,
AxialBlock_YOLO, DAT_YOLO) in a small model (Conv, the row, Conv, a
one-level Detect) at 32 px: the port's row table is JAX's, its parameter
count is the JAX model's, and its raw Detect map from the same variables
is JAX's within 1e-4 of its largest magnitude. Rows whose first arg JAX
ignores (MHSA, EfficientAttention, DeBiAttentionBlock's width) carry a
value that differs from the input's width.

Then `utils/benchmarks.py`'s `upsample_test(quick=True)` and
`attention_test(quick=True)` on the CPU: 9 and 26 results whose shapes are
JAX's (`jax.eval_shape`, no JAX timing); the bridge's new rules,
round-tripped through `params_from_jax` and `jax_param_paths`; a
deferred module's row still raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_dbl_tpu.nn.tasks import YOLOModel
from yolo_dbl_tpu.nn.tasks import parse_model_spec as jax_parse_model_spec
from yolo_dbl_tpu.utils import benchmarks as JBM

from yolo_dbl_tpu_torch import DetectionModel
from yolo_dbl_tpu_torch.nn import tasks as T
from yolo_dbl_tpu_torch.nn.attention import bigarch as TBA
from yolo_dbl_tpu_torch.nn.attention import channel as TC
from yolo_dbl_tpu_torch.nn.attention import spatial as TSP
from yolo_dbl_tpu_torch.utils import benchmarks as TBM
from yolo_dbl_tpu_torch.utils.convert import (jax_param_paths, load_jax_variables,
                                              params_from_jax, state_dict_from_jax)

from tests.test_torch_catalogue import catalogue_variables
from tests.test_torch_modules import jax_tree
from tests.torch_fixtures import one_torch_thread  # noqa: F401 (autouse fixture)

IMGSZ = 32
BAR = 1e-4
# {row name: its YAML args}, after a Conv to 32 channels at 16x16
ROWS = {
    "SELayer": [32], "ECALayer": [32, 5], "CBAM": [32], "SimAM": [32], "EMA": [32, 8],
    "CoordAttention": [32], "GAM": [32], "TripletAttention": [32], "MLCA": [32], "ELA": [32],
    "BAM": [32], "BAM_YOLO": [32, 8], "CoTNetLayer": [32], "ECALayer_ns": [32, 5],
    "EfficientAttention": [7, 32, 8], "EfficientAttention_YOLO": [32, 8, 32], "HiLo": [32, 4],
    "FullyAttentionalBlock": [32], "NonLocalBlock2D": [32], "MHSA": [99, 0, 4],
    "MHSA_YOLO": [32, 4], "BoTAttention": [32, 4, 16], "BoTAttention_YOLO": [32, 2, 8],
    "EdgeAwareAttention": [32], "BiFormerNCHW": [32, 4, 4, 2], "DAT_YOLO": [32, 4, 1],
    "DeBiAttentionBlock": [16, 4, 4], "AxialBlock_YOLO": [32, 8], "AxialBlock_dynamic": [32, 24],
    "AxialBlock_wopos": [32, 12], "DeBiAttention_YOLO": [32, 4, 4],
    "ShiftWindowAttention": [32, 4, 4, 2], "FusedKQnA": [32, 2, 4], "SwinTransformer": [32, 4, 4],
    "EUCB": [32], "MEUM": [32], "ResBlock_CBAM": [64, 2],
}


def _yaml(name):
    return {"nc": 3,
            "backbone": [[-1, 1, "Conv", [32, 3, 2]], [-1, 1, name, list(ROWS[name])],
                         [-1, 1, "Conv", [32, 3, 2]]],
            "head": [[[2], 1, "Detect", ["nc"]]]}


def test_every_catalogue_row_is_ported():
    """The port's catalogue rows are JAX's attention and upsample builders'
    names less the ones deferred to ROADMAP 6.3c and those ported before."""
    from yolo_dbl_tpu.nn import tasks as JT

    jax_names = set(JT._ATTENTION_BUILDERS) | set(JT._UPSAMPLE_BUILDERS)
    earlier = {"SLA", "AIFI", "CARAFE", "CARAFE_XiaLiPKU", "CARAFE_simplified", "DLU", "SCAM",
               "SPDConv", "FEM", "C3k2_EFE", "Multibranch", "FFM_Concat2", "M2C2f", "C3k2_EAMC",
               "CARAFEPack", "FFM_Concat3"}
    deferred = {"EdgeAwareAttentionV2", "Outlooker_YOLO", "PSAModule", "CPCA", "CPCA_YOLO",
                "ASFF", "CAA", "C2f_PIG", "C2f_WT", "CARAFEplusplus", "LDA_AQU"}
    assert set(T.CATALOGUE_ROWS) == jax_names - earlier - deferred == set(ROWS)


@pytest.mark.parametrize("name", sorted(ROWS))
def test_catalogue_row_matches_jax(name):
    """Rows, parameter count and the raw Detect map of Conv → row → Conv →
    Detect at 32 px, from one set of variables."""
    d = _yaml(name)
    spec_j, spec_t = jax_parse_model_spec(dict(d)), T.parse_model_spec(dict(d))
    assert [(l.f, l.name, l.args, l.c2, l.n) for l in spec_t.layers] == \
        [(l.f, l.name, l.args, l.c2, l.n) for l in spec_j.layers]
    x = np.random.default_rng(3).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    module = YOLOModel(spec_j)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.asarray(x))
    variables = catalogue_variables(shapes, np.random.default_rng(4))
    tm = DetectionModel(dict(d), device="cpu", imgsz=IMGSZ)
    assert sum(p.numel() for p in tm.parameters()) == sum(
        int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(shapes["params"]))
    load_jax_variables(tm, variables)
    want = np.asarray(jax.jit(module.apply)(jax_tree(variables), jnp.asarray(x))[0])
    with torch.no_grad():
        got = tm(torch.from_numpy(x))[0].numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= BAR * float(np.abs(want).max())


def test_bot_row_is_sized_by_imgsz_and_refuses_another_map():
    """A BoTAttention row's position tables follow `imgsz` (JAX's init
    size): 16 rows at 32 px, 32 at 64; a forward at another size raises."""
    d = _yaml("BoTAttention")
    assert DetectionModel(dict(d), device="cpu", imgsz=32).m1.rel_height.shape == (16, 16)
    tm = DetectionModel(dict(d), device="cpu", imgsz=64)
    assert tm.m1.rel_width.shape == (32, 16)
    with pytest.raises(ValueError, match="position tables are for a 32x32 map"):
        tm(torch.zeros((1, 32, 32, 3)))


@pytest.mark.parametrize("name", ["SELayer", "DAT_YOLO", "EUCB"])
def test_catalogue_rows_refuse_the_parallel_paths(name):
    """The catalogue's modules have no tensor- or spatial-parallel form
    (ROADMAP Queue 1 item 7): global poolings, attentions over the whole
    map, Dense and norm layers, K2's sampling."""
    from types import SimpleNamespace

    from yolo_dbl_tpu_torch.parallel.shardings import model_parallel_shardings
    from yolo_dbl_tpu_torch.parallel.spatial import spatial

    two = SimpleNamespace(shape={"data": 1, "model": 2}, n_model=2)
    tm = DetectionModel(_yaml(name), device="cpu", imgsz=IMGSZ)
    with pytest.raises(NotImplementedError, match="item 7"):
        model_parallel_shardings(tm, two)
    with pytest.raises(NotImplementedError, match="item 7"):
        with spatial(tm, two):
            pass


def test_deferred_row_still_raises():
    d = _yaml("SELayer")
    d["backbone"][1] = [-1, 1, "PConv", [32]]
    with pytest.raises(NotImplementedError, match="PConv"):
        DetectionModel(d, device="cpu")


def _jax_shapes(catalogue, shape):
    """{name: NHWC output shape} of JAX's catalogue by jax.eval_shape."""
    x = jax.ShapeDtypeStruct(shape, jnp.float32)
    out = {}
    for name, module in catalogue:
        def apply(xx, module=module):
            return module.apply(module.init(jax.random.PRNGKey(0), xx), xx)
        out[name] = tuple(jax.eval_shape(apply, x).shape)
    return out


def test_catalogue_timer_on_the_cpu_gives_jax_shapes(capsys):
    """`upsample_test(quick=True)` and `attention_test(quick=True)` on the
    CPU (one timed call each): 9 and 26 results, in JAX's order, with JAX's
    output shapes."""
    ups = TBM.upsample_test(quick=True, device="cpu", repeat=1)
    att = TBM.attention_test(quick=True, device="cpu", repeat=1)
    assert "FAILED" not in capsys.readouterr().out
    want_ups = _jax_shapes(JBM.upsample_catalogue(), TBM.UPSAMPLE_SHAPE)
    want_att = _jax_shapes(JBM.attention_catalogue(), TBM.ATTENTION_QUICK_SHAPE)
    assert [r["name"] for r in ups] == list(want_ups) and len(ups) == 9
    assert [r["name"] for r in att] == list(want_att) and len(att) == 26
    for r in ups + att:
        assert r["shape"] == {**want_ups, **want_att}[r["name"]], r["name"]
        assert r["sec_per_iter"] > 0


def test_catalogue_timer_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TBM.upsample_test(quick=True)


def test_check_time_prints_failed_and_goes_on(capsys):
    """A module that raises gives None and a FAILED line, as JAX's check_time."""
    assert TBM.check_time("Broken", torch.nn.Linear(3, 3), torch.zeros(1, 4, 4, 4)) is None
    assert "Broken" in capsys.readouterr().out.split("FAILED")[0]


# the bridge's new rules: {case: (JAX leaf path, array, port key, the port's array)}
_Q = np.arange(8 * 2 * 4, dtype=np.float32).reshape(8, 2, 4)
_O = np.arange(2 * 4 * 8, dtype=np.float32).reshape(2, 4, 8)
BRIDGE_RULES = {
    "dense_general_query": (("m1", "self_attention", "query", "kernel"), _Q,
                            "m1.self_attention.query.weight", _Q.reshape(8, 8).T),
    "dense_general_bias": (("m1", "self_attention", "key", "bias"), _Q[0],
                           "m1.self_attention.key.bias", _Q[0].reshape(-1)),
    "dense_general_out": (("m1", "self_attention", "out", "kernel"), _O,
                          "m1.self_attention.out.weight", _O.reshape(8, 8).T),
    "group_norm_scale": (("m1", "gn", "scale"), np.arange(4, dtype=np.float32), "m1.gn.weight",
                         None),
    "rel_height": (("m1", "rel_height"), _Q[:, 0], "m1.rel_height", None),
    "relative": (("m1", "hight", "relative"), _Q[0], "m1.hight.relative", None),
    "rpb_table": (("m1", "rpb_table"), _Q[:, 1], "m1.rpb_table", None),
    "bias_table": (("m1", "attn", "relative_position_bias_table"), _Q[:, 0],
                   "m1.attn.relative_position_bias_table", None),
    "eca_ns_taps": (("m1", "conv"), _Q[:, 0, :3], "m1.conv", None),
}


@pytest.mark.parametrize("rule", sorted(BRIDGE_RULES))
def test_bridge_rule(rule):
    path, arr, key, want = BRIDGE_RULES[rule]
    tree = {}
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = arr
    dense = frozenset({".".join(path[:-1])}) if rule.startswith("dense") else frozenset()
    sd = state_dict_from_jax({"params": tree}, dense=dense)
    np.testing.assert_array_equal(sd[key].numpy(), arr if want is None else want)


def test_catalogue_parameters_round_trip_through_the_bridge():
    """Every parameter of MHSA (3-D Dense kernels), EMA (GroupNorm), BoT,
    an AxialBlock, FusedKQnA, ShiftWindowAttention and ECALayer_ns names
    its JAX path; a params tree filled leaf by leaf with its index comes
    back on the parameter that path names."""
    from yolo_dbl_tpu.nn import attention as JA

    class JaxStack(__import__("flax").linen.Module):
        @__import__("flax").linen.compact
        def __call__(self, x):
            x = JA.MHSA(16, num_heads=2, name="mhsa")(x)
            x = JA.EMA(16, factor=4, name="ema")(x)
            x = JA.BoTAttention(16, heads=2, dim_head=8, name="bot")(x)
            x = JA.AxialBlock(8, kernel_size=8, name="axial")(x)
            x = JA.FusedKQnA(n_q=1, n_channels=16, n_heads=2, name="qna")(x)
            x = JA.ShiftWindowAttention(16, heads=2, window_size=4, name="swa")(x)
            return JA.ECALayer_ns(16, name="eca")(x)

    tm = torch.nn.ModuleDict({
        "mhsa": TSP.MHSA(16, num_heads=2), "ema": TC.EMA(16, factor=4),
        "bot": TSP.BoTAttention(16, heads=2, dim_head=8, size=(8, 8)),
        "axial": TBA.AxialBlock(16, 8, kernel_size=8), "qna": TBA.FusedKQnA(1, 16, 2),
        "swa": TBA.ShiftWindowAttention(16, heads=2, window_size=4),
        "eca": TC.ECALayer_ns(16)})
    shapes = jax.eval_shape(JaxStack().init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 16)))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes["params"])
    fill = {"/".join(str(k.key) for k in p): float(i + 1) for i, (p, _) in enumerate(leaves)}
    params = jax.tree_util.tree_unflatten(
        treedef, [np.full(leaf.shape, i + 1, np.float32) for i, (_, leaf) in enumerate(leaves)])
    paths = jax_param_paths(tm)
    assert sorted(paths.values()) == sorted(fill)
    assert paths["mhsa.self_attention.query.weight"] == "mhsa/self_attention/query/kernel"
    assert paths["ema.gn.weight"] == "ema/gn/scale"
    assert paths["eca.conv"] == "eca/conv"
    for name, value in params_from_jax(tm, params).items():
        assert bool((value == fill[paths[name]]).all()), name
