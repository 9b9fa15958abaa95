"""The port's op set against the JAX package's.

- The registries: the port registers every one of the reference's op
  names, its 291 `_np_*` names (`mx.np`) among them, and the names under
  `nd.random/image/linalg/contrib` and `sym.random/image/linalg/contrib`
  equal the reference's.
- A table of parity cases, one or more for each op of the op-set slice
  (the 205 names in NEW_OPS) that is not held elsewhere, and for every op
  mode that raised before it: the same seeded numpy inputs go through
  the port's `nd.invoke` and the reference's op function under
  ``jax.vjp``, jitted (what the reference's tape records for an op
  without a hand-written rule; the ops with one go through its
  autograd). Forward: float32 within 1e-5 of the
  reference's largest magnitude (linalg within 1e-4), integer, boolean
  and index results exact. Gradients of sum(out * cot), the port's
  through its autograd, for each differentiable op, within 1e-5 (1e-4
  for linalg and the special functions).
- `Deconvolution` is upstream MXNet's transposed convolution; the
  reference correlates with the kernel unflipped, so the port on a
  kernel is held to the reference on that kernel flipped in space.
- `LeakyReLU(act_type="rrelu")` raises in the reference; the port's is
  upstream's, held to its closed form in predict mode and to its slope
  range in training.

The other new names are held in test_torch_contrib_vision.py (detection),
test_torch_quantization.py, test_torch_random_ops.py (the draws, held to
their distributions) and test_torch_image_ops.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.ops import registry as ref_registry
from mxnet_tpu_torch.ops import registry as port_registry

FWD_TOL = 1e-5
LINALG_TOL = 1e-4
GRAD_TOL = 1e-5
SPECIAL_GRAD_TOL = 1e-4
# run eagerly in the reference: shapes that depend on values, and windows
# that floor or ceil a quotient (under jit XLA folds a division by a
# constant into a multiplication by its reciprocal, which moves some)
EAGER = {"boolean_mask", "where_index", "ROIPooling"}

# the 205 reference names this slice registers (143 -> 348)
NEW_OPS = """
BatchNorm_v1 BilinearSampler Correlation Crop Deconvolution GridGenerator
GroupNorm InstanceNorm L2Normalization RMSNorm ROIPooling SoftmaxActivation
UpSampling _contrib_div_sqrt_dim crop dot_scaled hard_sigmoid
softmax_cross_entropy softmin
BlockGrad_inner _copyto _div_scalar _internal_getitem _minus_scalar
_mul_scalar _plus_scalar _power _power_scalar amp_cast arccos arccosh
arcsin arcsinh arctan arctan2 arctanh argmax argmin argsort batch_dot
boolean_mask broadcast_axes broadcast_axis broadcast_hypot
broadcast_logical_and broadcast_logical_or broadcast_logical_xor
broadcast_mod broadcast_power cbrt ceil cos cosh cumsum degrees
depth_to_space diag erf erfinv expm1 eye fix floor gamma gammaln gather_nd
isfinite isinf isnan khatri_rao linalg_gemm2 linalg_potrf linalg_syrk log10
log1p log2 logical_not logsumexp max max_axis min min_axis moveaxis nanprod
nansum pow prod radians reciprocal repeat rint round rsqrt scatter_nd
shape_array sign sin sinh size_array slice slice_like smooth_l1 softsign
sort space_to_depth squeeze stop_gradient_passthrough take take_along_axis
tan tile topk trunc where_index
IdentityAttachKLSparseReg LRN SVMOutput SpatialTransformer argmax_channel
batch_take broadcast_like cast_storage col2im digamma fill_element_0index
im2col linalg_det linalg_extractdiag linalg_extracttrian linalg_gelqf
linalg_gemm linalg_inverse linalg_makediag linalg_maketrian linalg_potri
linalg_slogdet linalg_sumlogdiag linalg_trmm linalg_trsm linspace make_loss
moments ravel_multi_index rcbrt reshape_like unravel_index
_contrib_AdaptiveAvgPooling2D _contrib_BilinearResize2D
_contrib_DeformableConvolution _contrib_MultiBoxDetection
_contrib_MultiBoxPrior _contrib_MultiBoxTarget _contrib_PSROIPooling
_contrib_ROIAlign _contrib_adaptive_avg_pooling2d _contrib_arange_like
_contrib_bilinear_resize2d _contrib_box_decode _contrib_box_encode
_contrib_box_iou _contrib_box_nms
_contrib_dequantize _contrib_quantize_v2 _contrib_quantized_conv
_contrib_quantized_fully_connected _contrib_requantize
_image_crop _image_flip_left_right _image_flip_top_bottom _image_normalize
_image_random_brightness _image_random_contrast
_image_random_flip_left_right _image_random_flip_top_bottom _image_resize
_image_to_tensor
_random_exponential _random_gamma _random_generalized_negative_binomial
_random_negative_binomial _random_normal _random_poisson _random_randint
_random_uniform _sample_gamma _sample_multinomial _sample_normal
_sample_uniform _sample_unique_zipfian _shuffle bernoulli normal randint
randn random_exponential random_gamma random_generalized_negative_binomial
random_negative_binomial random_normal random_poisson random_randint
random_uniform sample_multinomial shuffle uniform
""".split()

# held in the other files of this slice
ELSEWHERE = {n for n in NEW_OPS if n.startswith(
    ("_contrib_", "_image_", "_random_", "_sample_", "random_", "sample_"))
    and n != "_contrib_div_sqrt_dim"} | {
    "normal", "uniform", "randn", "randint", "shuffle", "_shuffle",
    "bernoulli"}


def test_registry_difference_is_the_numpy_ops():
    """Since the numpy slice the difference is empty: the port registers
    the reference's 291 `_np_*` names too (held op by op in
    test_torch_numpy_ops.py)."""
    ref, port = set(ref_registry.list_ops()), set(port_registry.list_ops())
    assert ref - port == set()
    numpy_ops = {n for n in ref if n.startswith("_np_")}
    assert len(numpy_ops) == 291 and numpy_ops <= port
    assert len(NEW_OPS) == len(set(NEW_OPS)) == 205
    assert set(NEW_OPS) <= port and not set(NEW_OPS) & numpy_ops


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


@pytest.mark.parametrize("space", ["random", "image", "linalg", "contrib"])
def test_namespaces_match_the_reference(space):
    assert _public(getattr(mx.nd, space)) == \
        _public(getattr(jmx.nd, space))
    assert _public(getattr(mx.sym, space)) == \
        _public(getattr(jmx.sym, space))


def test_operator_and_custom_are_there():
    assert callable(mx.nd.Custom)
    for name in ("CustomOp", "CustomOpProp", "register"):
        assert hasattr(mx.operator, name)


# ---------------------------------------------------------------------------
# the parity table
# ---------------------------------------------------------------------------
def U(shape, lo=-1.0, hi=1.0, seed=0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def N(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def PM(shape, lo, hi, seed=0):
    """Magnitudes in [lo, hi) with random signs."""
    rng = np.random.RandomState(seed)
    sign = np.where(rng.rand(*shape) < 0.5, -1.0, 1.0)
    return (sign * rng.uniform(lo, hi, shape)).astype(np.float32)


def I(shape, lo, hi, seed=0, dtype=np.float32):
    return np.random.RandomState(seed).randint(lo, hi, shape).astype(dtype)


def SPD(b, n, seed=0):
    a = N((b, n, n), seed)
    return (a @ a.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)
            ).astype(np.float32)


def LOWER(b, n, seed=0):
    """Lower triangles, well conditioned (diagonal in [2, 3)); the upper
    part holds noise that the triangular ops must not read."""
    a = N((b, n, n), seed) * 0.3
    d = np.eye(n, dtype=np.float32) * U((b, n, 1), 2, 3, seed + 1)
    return (np.tril(a, -1) + d + np.triu(a, 1) * 5).astype(np.float32)


HALVES = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.3, -0.7, 3.49],
                  np.float32)
SPECIAL = np.array([1.0, np.nan, np.inf, -np.inf, 0.0, -2.0], np.float32)
WITH_NAN = np.where(U((3, 4), seed=5) > 0.6, np.nan, U((3, 4), .5, 1.5))
WITH_ZERO = np.where(U((3, 4), seed=6) > 0.5, 0.0, N((3, 4))).astype(
    np.float32)
ROIS = np.array([[0, 1, 1, 6, 5], [1, 0, 2, 7, 7], [0, 3.4, 0.6, 5.2, 3.1]],
                np.float32)

C = []      # (id, op, args, kwargs, grad positions, tol, grad tol)


def case(op, args, kwargs=None, grad=(), tol=FWD_TOL, gtol=GRAD_TOL,
         tag=""):
    C.append(pytest.param(op, args, kwargs or {}, tuple(grad), tol, gtol,
                          id="%s%s" % (op, "-" + tag if tag else "")))


X = N((3, 4))
# -- unary math ---------------------------------------------------------------
for _op, _x, _gt in [
        ("sign", X, GRAD_TOL), ("reciprocal", PM((3, 4), .5, 2), GRAD_TOL),
        ("rsqrt", U((3, 4), .5, 3), GRAD_TOL),
        ("cbrt", PM((3, 4), .2, 3), GRAD_TOL),
        ("rcbrt", PM((3, 4), .2, 3), GRAD_TOL),
        ("log2", U((3, 4), .2, 3), GRAD_TOL),
        ("log10", U((3, 4), .2, 3), GRAD_TOL),
        ("log1p", U((3, 4), -.5, 3), GRAD_TOL), ("expm1", X, GRAD_TOL),
        ("sin", X, GRAD_TOL), ("cos", X, GRAD_TOL), ("tan", X, GRAD_TOL),
        ("arcsin", U((3, 4), -.9, .9), GRAD_TOL),
        ("arccos", U((3, 4), -.9, .9), GRAD_TOL), ("arctan", X, GRAD_TOL),
        ("sinh", X, GRAD_TOL), ("cosh", X, GRAD_TOL),
        ("arcsinh", X, GRAD_TOL), ("arccosh", U((3, 4), 1.2, 3), GRAD_TOL),
        ("arctanh", U((3, 4), -.9, .9), GRAD_TOL), ("erf", X, GRAD_TOL),
        ("erfinv", U((3, 4), -.95, .95), SPECIAL_GRAD_TOL),
        ("gamma", U((3, 4), .5, 4), SPECIAL_GRAD_TOL),
        ("gammaln", U((3, 4), .2, 5), SPECIAL_GRAD_TOL),
        ("digamma", U((3, 4), .2, 5), SPECIAL_GRAD_TOL),
        ("softsign", X, GRAD_TOL), ("degrees", X, GRAD_TOL),
        ("radians", X, GRAD_TOL)]:
    case(_op, [_x], grad=[0], gtol=_gt)
case("erfinv", [np.array([-1.0, 1.0, 0.0, 0.999999, -0.5], np.float32)],
     tag="edges")
case("gammaln", [np.array([1e-6, 1.0, 2.0, 0.5, 30.0], np.float32)],
     tag="edges")
case("digamma", [np.array([1e-3, 1.0, 0.5, 30.0, 1e4], np.float32)],
     tag="edges", tol=1e-4)
case("logical_not", [WITH_ZERO])
for _op in ("round", "rint"):
    case(_op, [HALVES])
for _op in ("ceil", "floor", "trunc", "fix"):
    case(_op, [HALVES * 1.3])
for _op in ("isnan", "isinf", "isfinite"):
    case(_op, [SPECIAL])

# -- binary, logic and scalar ops -------------------------------------------
case("broadcast_mod", [N((3, 4)) * 3, PM((1, 4), .5, 2)], grad=[0, 1])
case("broadcast_mod", [I((3, 4), -9, 9), I((3, 1), 1, 4, seed=2)],
     tag="int")
case("broadcast_power", [U((3, 4), .5, 2), N((3, 1))], grad=[0, 1])
case("broadcast_hypot", [N((3, 4)), N((3, 4), seed=1)], grad=[0, 1])
case("arctan2", [N((3, 4)), N((1, 4), seed=1)], grad=[0, 1])
for _op in ("broadcast_logical_and", "broadcast_logical_or",
            "broadcast_logical_xor"):
    case(_op, [I((3, 4), 0, 2), I((3, 4), 0, 2, seed=1)])
for _op, _s in [("_plus_scalar", 2.5), ("_minus_scalar", 2.5),
                ("_mul_scalar", -1.5), ("_div_scalar", 4.0),
                ("_power_scalar", 2.0)]:
    case(_op, [U((3, 4), .5, 2), _s], grad=[0])
case("_power", [U((3, 4), .5, 2), U((3, 4), -1, 2, seed=1)], grad=[0, 1])
case("pow", [U((3, 4), .5, 2), N((4,), seed=1)], grad=[0, 1])
case("smooth_l1", [N((3, 4)) * 2], {"scalar": 2.0}, grad=[0])

# -- reductions, ordering -----------------------------------------------------
X3 = U((2, 3, 4), .5, 1.5)
for _op, _kw in [("prod", {}), ("max", {"axis": 1}),
                 ("min", {"axis": (0, 2), "keepdims": True}),
                 ("nansum", {"axis": 1, "exclude": True}),
                 ("nanprod", {"axis": (0, 2)}),
                 ("prod", {"axis": 1, "exclude": True, "keepdims": True})]:
    case(_op, [X3], _kw, grad=[0], tag="-".join(sorted(_kw)))
case("max_axis", [X3], {"axis": 2}, grad=[0])
case("min_axis", [X3], {"axis": 0, "keepdims": True}, grad=[0])
case("nansum", [WITH_NAN], {"axis": 1}, grad=[0], tag="nan")
case("nanprod", [WITH_NAN], {"axis": 0}, grad=[0], tag="nan")
case("logsumexp", [N((2, 3, 4))], grad=[0])
case("logsumexp", [N((2, 3, 4))], {"axis": 1, "keepdims": True}, grad=[0],
     tag="axis")
TIES = np.array([[3, 1, 3, 2, 1, 3], [0, 0, 5, 5, 5, 1]], np.float32)
case("argmax", [TIES])
case("argmax", [TIES], {"axis": 0, "keepdims": True}, tag="keep")
case("argmin", [TIES], {"axis": 1}, tag="axis")
case("argsort", [TIES])
case("argsort", [TIES], {"is_ascend": False, "dtype": "int32"},
     tag="descend")
case("argsort", [N((3, 4))], {"axis": 0}, tag="axis0")
case("sort", [N((3, 5))], grad=[0])
case("sort", [N((3, 5))], {"axis": 0, "is_ascend": False}, grad=[0],
     tag="descend")
for _rt, _ax in (("indices", -1), ("value", 0), ("both", -1),
                 ("mask", -1)):
    case("topk", [TIES], {"k": 2, "ret_typ": _rt, "axis": _ax}, tag=_rt)
case("topk", [TIES], {"k": 4, "ret_typ": "both", "is_ascend": True},
     tag="ascend")
case("cumsum", [N((3, 4))], {"axis": 1}, grad=[0], tag="axis")
case("cumsum", [I((3, 4), -5, 5, dtype=np.int32)], {"axis": 0}, tag="int")
case("cumsum", [N((3, 4))], {"axis": 0, "dtype": "float16"}, tag="dtype")

# -- shape --------------------------------------------------------------------
X4 = N((2, 3, 4))
for _kw, _tag in [({"shape": (-4, 1, 2, -2)}, "m4_m2"),
                  ({"shape": (0, -4, -1, 3, 4)}, "m4_infer"),
                  ({"shape": (-1, 0, 2), "reverse": True}, "reverse")]:
    case("reshape", [X4], _kw, grad=[0], tag=_tag)
case("squeeze", [N((2, 1, 3, 1))], grad=[0])
case("squeeze", [N((2, 1, 3, 1))], {"axis": (1, 3)}, grad=[0], tag="axes")
case("moveaxis", [X4], {"source": 0, "destination": 2}, grad=[0])
case("broadcast_axis", [N((2, 1, 3))], {"axis": 1, "size": 4}, grad=[0])
case("broadcast_axes", [N((1, 2, 1))], {"axis": (0, 2), "size": (3, 4)},
     grad=[0])
case("tile", [X4], {"reps": (2, 1, 3)}, grad=[0])
case("tile", [X4], {"reps": (2,)}, grad=[0], tag="short")
case("repeat", [X4], {"repeats": 2}, grad=[0])
case("repeat", [X4], {"repeats": 3, "axis": 1}, grad=[0], tag="axis")
case("slice", [X4], {"begin": (0, 1), "end": (2, None),
                     "step": (1, 2)}, grad=[0])
case("slice", [X4], {"begin": (None, 2, 3), "end": (None, None, 0),
                     "step": (1, -1, -2)}, grad=[0], tag="negstep")
case("slice_like", [N((4, 5)), N((2, 3), seed=1)], grad=[0])
case("slice_like", [N((4, 5)), N((2, 3), seed=1)], {"axes": (1,)},
     grad=[0], tag="axes")
case("space_to_depth", [N((1, 2, 4, 6))], {"block_size": 2}, grad=[0])
case("depth_to_space", [N((1, 8, 2, 3))], {"block_size": 2}, grad=[0])
case("diag", [N((4,))], {"k": 1}, grad=[0])
case("diag", [N((3, 4))], {"k": -1}, grad=[0], tag="matrix")
case("eye", [], {"N": 3, "M": 4, "k": 1})
case("eye", [], {"N": 4, "dtype": "int32"}, tag="square")
case("shape_array", [X4])
case("size_array", [X4])
case("pad", [N((1, 2, 3, 4))], {"mode": "edge",
                                "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)},
     grad=[0], tag="edge")
case("pad", [N((1, 2, 3, 4))], {"mode": "reflect",
                                "pad_width": (0, 0, 0, 0, 2, 1, 1, 3)},
     grad=[0], tag="reflect")
case("pad", [N((1, 1, 3, 4))], {"mode": "reflect",
                                "pad_width": (0, 0, 0, 0, 5, 4, 6, 7)},
     grad=[0], tag="reflect_wide")
case("pick", [N((3, 5)), np.array([0, 7, -2], np.float32)],
     {"mode": "wrap"}, grad=[0], tag="wrap")

# -- indexing and small linear algebra ----------------------------------------
IDX = np.array([0, 4, 7, -1, 2], np.float32)
case("take", [N((5, 3)), IDX], grad=[0])
case("take", [N((5, 3)), IDX], {"mode": "wrap"}, grad=[0], tag="wrap")
case("take", [N((2, 5, 3)), np.array([[0, 2], [4, 1]], np.float32)],
     {"axis": 1}, grad=[0], tag="axis")
case("take_along_axis", [N((3, 4)), I((3, 2), 0, 4)], {"axis": 1},
     grad=[0])
case("gather_nd", [N((3, 4, 5)), I((2, 6), 0, 3)], grad=[0])
case("scatter_nd", [N((5,)), np.array([[0, 1, 2, 2, 0], [3, 0, 1, 2, 2]],
                                     np.float32)], {"shape": (3, 4)},
     grad=[0])
case("boolean_mask", [N((5, 3)), np.array([1, 0, 1, 1, 0], np.float32)])
case("where_index", [WITH_ZERO])
case("_internal_getitem", [X4], {"index": (slice(0, 2), 1)}, grad=[0])
for _op in ("_copyto", "BlockGrad_inner", "stop_gradient_passthrough"):
    case(_op, [X4], grad=[0])
case("amp_cast", [X4], {"dtype": "float16"})
case("batch_dot", [N((2, 3, 4)), N((2, 4, 5), seed=1)], grad=[0, 1])
case("batch_dot", [N((2, 4, 3)), N((2, 5, 4), seed=1)],
     {"transpose_a": True, "transpose_b": True}, grad=[0, 1], tag="t")
case("linalg_gemm2", [N((2, 4, 3)), N((2, 4, 5), seed=1)],
     {"transpose_a": True, "alpha": 2.0}, grad=[0, 1], tol=LINALG_TOL,
     gtol=LINALG_TOL)
case("linalg_potrf", [SPD(2, 3)], grad=[0], tol=LINALG_TOL, gtol=LINALG_TOL)
case("linalg_syrk", [N((2, 3, 4))], {"alpha": .5}, grad=[0],
     tol=LINALG_TOL, gtol=LINALG_TOL)
case("linalg_syrk", [N((2, 3, 4))], {"transpose": True}, grad=[0],
     tol=LINALG_TOL, gtol=LINALG_TOL, tag="t")
case("khatri_rao", [N((2, 3)), N((4, 3), seed=1)], grad=[0, 1])

# -- nn -------------------------------------------------------------------------
XI = N((2, 4, 5, 6))
G4, B4 = U((4,), .5, 1.5, seed=1), N((4,), seed=2)
case("BatchNorm_v1", [XI, G4, B4, N((4,), seed=3), U((4,), .5, 2, seed=4)],
     {"fix_gamma": False, "use_global_stats": True}, grad=[0, 1, 2])
case("InstanceNorm", [XI, G4, B4], grad=[0, 1, 2])
case("GroupNorm", [XI, G4, B4], {"num_groups": 2}, grad=[0, 1, 2])
for _mode in ("instance", "channel", "spatial"):
    case("L2Normalization", [XI], {"mode": _mode}, grad=[0], tag=_mode)
case("RMSNorm", [N((3, 5)), U((5,), .5, 1.5)], grad=[0, 1])
case("hard_sigmoid", [N((3, 4)) * 3], {"alpha": .3, "beta": .4}, grad=[0])
case("softmin", [N((3, 4))], {"axis": 0}, grad=[0])
case("SoftmaxActivation", [XI], grad=[0])
case("SoftmaxActivation", [XI], {"mode": "channel"}, grad=[0], tag="channel")
case("softmax_cross_entropy", [N((4, 5)), I((4,), 0, 5)], grad=[0])
case("UpSampling", [N((1, 2, 3, 4))], {"scale": 2}, grad=[0])
case("UpSampling", [N((1, 2, 3, 4))], {"scale": 3,
                                       "sample_type": "bilinear"},
     grad=[0], tag="bilinear")
case("BilinearSampler", [N((2, 2, 5, 6)), U((2, 2, 4, 3), -1.1, 1.1)],
     grad=[0, 1])
case("GridGenerator", [N((2, 6))], {"target_shape": (3, 4)}, grad=[0])
case("SpatialTransformer", [N((2, 2, 5, 6)), N((2, 6), seed=1) * .5],
     {"target_shape": (4, 3)}, grad=[0, 1])
case("ROIPooling", [N((2, 3, 8, 9)), ROIS], {"pooled_size": (2, 3),
                                             "spatial_scale": .9},
     grad=[0])
case("Correlation", [N((1, 3, 7, 8)), N((1, 3, 7, 8), seed=1)],
     {"kernel_size": 3, "max_displacement": 2, "pad_size": 2}, grad=[0, 1])
case("Correlation", [N((1, 2, 6, 6)), N((1, 2, 6, 6), seed=1)],
     {"kernel_size": 1, "max_displacement": 2, "stride1": 2,
      "stride2": 2, "pad_size": 1, "is_multiply": False}, grad=[0, 1],
     tag="absdiff")
case("dot_scaled", [N((3, 4)), N((4, 2), seed=1)], {"scale": .5},
     grad=[0, 1])
case("crop", [N((1, 2, 6, 7))], {"h_w": (3, 4), "offset": (1, 2)},
     grad=[0])
case("Crop", [N((1, 2, 6, 7)), N((1, 1, 4, 4), seed=1)],
     {"num_args": 2, "center_crop": True}, grad=[0], tag="like")
case("_contrib_div_sqrt_dim", [N((2, 3, 16))], grad=[0])
# the modes that raised before this slice
case("Convolution", [N((2, 3, 9)), N((4, 3, 3), seed=1), N((4,), seed=2)],
     {"kernel": (3,), "stride": (2,), "pad": (1,), "num_filter": 4},
     grad=[0, 1, 2], tag="1d")
case("Convolution", [N((2, 9, 3)), N((4, 3, 3), seed=1), N((4,), seed=2)],
     {"kernel": (3,), "dilate": (2,), "num_filter": 4, "layout": "NWC"},
     grad=[0, 1, 2], tag="1d_nwc")
case("Convolution", [N((1, 2, 5, 6, 4)), N((3, 2, 3, 3, 3), seed=1),
                     N((3,), seed=2)],
     {"kernel": (3, 3, 3), "pad": (1, 1, 1), "num_filter": 3},
     grad=[0, 1, 2], tag="3d")
case("Convolution", [N((1, 5, 6, 4, 2)), N((4, 3, 3, 3, 1), seed=1)],
     {"kernel": (3, 3, 3), "num_filter": 4, "num_group": 2,
      "no_bias": True, "layout": "NDHWC"}, grad=[0, 1], tag="3d_ndhwc")
for _pt, _nd in (("max", 1), ("avg", 3), ("sum", 1), ("lp", 3), ("max", 3),
                 ("avg", 1)):
    if _nd == 1:
        case("Pooling", [N((2, 3, 9))], {"kernel": (3,), "stride": (2,),
                                         "pad": (1,), "pool_type": _pt},
             grad=[0], tag="1d_" + _pt)
    else:
        case("Pooling", [N((1, 2, 5, 6, 4))],
             {"kernel": (2, 3, 2), "stride": (2, 2, 1), "pool_type": _pt,
              "pooling_convention": "full"}, grad=[0], tag="3d_" + _pt)
case("Pooling", [N((2, 3, 7, 7))], {"kernel": (3, 3), "pad": (1, 1),
                                    "pool_type": "avg",
                                    "count_include_pad": False}, grad=[0],
     tag="2d_avg_nopad")
case("Pooling", [N((2, 3, 5, 6))], {"kernel": (2, 2), "pool_type": "lp",
                                    "p_value": 3}, grad=[0], tag="2d_lp3")
case("Pooling", [N((2, 3, 9))], {"global_pool": True, "pool_type": "sum"},
     grad=[0], tag="global_sum")
case("LeakyReLU", [N((2, 3, 4)), U((3,), .1, .5)], {"act_type": "prelu"},
     grad=[0, 1], tag="prelu")
case("LeakyReLU", [N((2, 3, 4))], {"act_type": "elu", "slope": .3},
     grad=[0], tag="elu")
case("LeakyReLU", [N((2, 3, 4))], {"act_type": "selu"}, grad=[0],
     tag="selu")
for _act in ("gelu_tanh", "silu", "swish"):
    case("Activation", [N((3, 4))], {"act_type": _act}, grad=[0], tag=_act)
case("softmax", [N((3, 5)), -1, None, np.array([2, 5, 1], np.float32),
                 True], grad=[0], tag="use_length")

# -- extended.py --------------------------------------------------------------
case("IdentityAttachKLSparseReg", [U((4, 3), .1, .9)],
     {"sparseness_target": .2, "penalty": .01}, grad=[0])
case("LRN", [N((2, 6, 3, 3))], {"nsize": 3, "alpha": .1}, grad=[0])
for _lin in (False, True):
    case("SVMOutput", [N((4, 5)), I((4,), 0, 5)],
         {"margin": .5, "regularization_coefficient": 2.0,
          "use_linear": _lin}, grad=[0], tag="linear" if _lin else "sq")
case("argmax_channel", [N((3, 4, 2))])
case("batch_take", [N((4, 5)), I((4,), 0, 5)], grad=[0])
case("broadcast_like", [N((1, 3)), N((4, 3), seed=1)], grad=[0])
case("broadcast_like", [N((1, 3, 1)), N((2, 5), seed=1)],
     {"lhs_axes": (0, 2), "rhs_axes": (0, 1)}, grad=[0], tag="axes")
case("cast_storage", [X4], {"stype": "default"})
case("im2col", [N((2, 2, 4, 5))], {"kernel": (2, 3), "stride": (1, 2),
                                   "pad": (1, 0)}, grad=[0])
case("col2im", [N((1, 8, 12))], {"output_size": (4, 5), "kernel": (2, 2)},
     grad=[0])
case("fill_element_0index", [N((3, 4)), I((3,), 0, 4), N((3,), seed=1)])
case("make_loss", [N((3, 4))], {"grad_scale": 2.0,
                                "normalization": "batch"}, grad=[0])
case("moments", [N((3, 4, 5))], {"axes": (0, 2), "keepdims": True},
     grad=[0])
case("ravel_multi_index", [np.array([[0, 3, 5, 1], [2, 0, 7, 5]],
                                    np.float32)], {"shape": (4, 6)})
case("unravel_index", [np.array([0, 5, 23, 11], np.float32)],
     {"shape": (4, 6)})
case("reshape_like", [N((2, 6)), N((3, 4), seed=1)], grad=[0])
case("reshape_like", [N((2, 6, 5)), N((2, 3), seed=1)],
     {"lhs_begin": 1, "lhs_end": 2, "rhs_begin": 0, "rhs_end": 2},
     grad=[0], tag="range")
case("linspace", [], {"start": -1.0, "stop": 2.0, "num": 7})
case("linspace", [], {"start": 0.0, "stop": 1.0, "num": 5,
                      "endpoint": False, "dtype": "float16"}, tag="open")
_LT = dict(tol=LINALG_TOL, gtol=LINALG_TOL)
case("linalg_det", [N((2, 3, 3))], grad=[0], **_LT)
case("linalg_slogdet", [N((2, 3, 3))], grad=[0], **_LT)
case("linalg_inverse", [SPD(2, 3)], grad=[0], **_LT)
case("linalg_potri", [np.linalg.cholesky(SPD(1, 3)[0]).astype(np.float32)],
     grad=[0], **_LT)
case("linalg_gemm", [N((2, 3, 4)), N((2, 5, 4), seed=1), N((2, 3, 5),
                                                           seed=2)],
     {"transpose_b": True, "alpha": .5, "beta": 2.0}, grad=[0, 1, 2], **_LT)
for _kw, _tag in [({"transpose": True}, "t"),
                  ({"rightside": True, "alpha": 2.0}, "right")]:
    case("linalg_trmm", [LOWER(2, 3), N((2, 3, 3), seed=3)], _kw,
         grad=[0, 1], tag=_tag, **_LT)
for _kw, _tag in [({"transpose": True}, "t"),
                  ({"rightside": True, "alpha": 2.0}, "right"),
                  ({"rightside": True, "transpose": True, "lower": False},
                   "right_t_upper")]:
    a = LOWER(2, 3)
    if _kw.get("lower") is False:
        a = a.transpose(0, 2, 1).copy()
    case("linalg_trsm", [a, N((2, 3, 3), seed=3)], _kw, grad=[0, 1],
         tag=_tag, **_LT)
case("linalg_gelqf", [N((2, 3, 5))], **_LT)
case("linalg_makediag", [N((2, 3))], {"offset": 1}, grad=[0])
case("linalg_extractdiag", [N((2, 3, 4))], {"offset": -1}, grad=[0])
case("linalg_sumlogdiag", [SPD(2, 3)], grad=[0], **_LT)
case("linalg_maketrian", [N((6,))], grad=[0])
case("linalg_maketrian", [N((6,))], {"lower": False}, grad=[0],
     tag="upper")
case("linalg_extracttrian", [N((2, 3, 3))], grad=[0])
case("linalg_extracttrian", [N((2, 3, 3))], {"lower": False}, grad=[0],
     tag="upper")


def _cot(shape, seed=99):
    return np.asarray(np.random.RandomState(seed).randn(*shape),
                      dtype=np.float32)


def _reference(op, args, kwargs, grad):
    """(outputs, gradients) of the reference. Where its tape would record
    the op with ``jax.vjp`` of the op's function (every op without a
    hand-written rule or recorder, and not eager-only), that is computed
    here directly, forward and vjp in one jitted program: the same
    functions, one compile a case instead of one a primitive. The other
    ops go through its NDArray autograd, and so do EAGER's."""
    ref = ref_registry.get(op)
    if ref.vjp_rule is not None or ref.record_override is not None or \
            op in EAGER:
        return _run(jmx, op, args, kwargs, grad)
    pos = [i for i, a in enumerate(args) if isinstance(a, np.ndarray)]

    def forward(*arrays):
        full = list(args)
        for p, a in zip(pos, arrays):
            full[p] = a
        return ref.fn(*full, **kwargs)

    def both(*arrays):
        if not grad:
            return forward(*arrays), ()
        out, vjp = jax.vjp(forward, *arrays)
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        cots = [jnp.asarray(_cot(outs[0].shape))] + [
            jnp.zeros_like(o) for o in outs[1:]]
        grads = vjp(type(out)(cots) if isinstance(out, (tuple, list))
                    else cots[0])
        return out, tuple(grads[pos.index(i)] for i in grad)

    out, grads = jax.jit(both)(*[jnp.asarray(args[p]) for p in pos])
    outs = out if isinstance(out, (tuple, list)) else [out]
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _run(pkg, op, args, kwargs, grad, cot_seed=99):
    """(outputs, gradients) of `op` in one package on the CPU, through its
    NDArray autograd."""
    with pkg.cpu():
        vals = [pkg.nd.array(a, dtype=a.dtype) if isinstance(a, np.ndarray)
                else a for a in args]
        for i in grad:
            vals[i].attach_grad()
        if not grad:
            out = pkg.nd.invoke(op, *vals, **kwargs)
            outs = out if isinstance(out, (list, tuple)) else [out]
            return [o.asnumpy() for o in outs], []
        with pkg.autograd.record():
            out = pkg.nd.invoke(op, *vals, **kwargs)
            outs = out if isinstance(out, (list, tuple)) else [out]
            cot = _cot(outs[0].shape, cot_seed)
            loss = (outs[0] * pkg.nd.array(cot)).sum()
        loss.backward()
        return ([o.asnumpy() for o in outs],
                [vals[i].grad.asnumpy() for i in grad])


def _check(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    if got.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                  err_msg=what)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin & ~np.isnan(want)],
                                  want[~fin & ~np.isnan(want)], err_msg=what)
    if fin.any():
        scale = max(1.0, float(np.abs(want[fin]).max()))
        np.testing.assert_allclose(got[fin], want[fin], rtol=0,
                                   atol=tol * scale, err_msg=what)


@pytest.mark.parametrize("op,args,kwargs,grad,tol,gtol", C)
def test_op_matches_reference(op, args, kwargs, grad, tol, gtol):
    want, wgrads = _reference(op, args, kwargs, grad)
    got, ggrads = _run(mx, op, args, kwargs, grad)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _check(g, w, tol, "%s output %d" % (op, i))
    for i, g, w in zip(grad, ggrads, wgrads):
        _check(g, w, gtol, "%s gradient of input %d" % (op, i))


def test_the_table_covers_the_slice():
    covered = {p.values[0] for p in C} | {"Deconvolution"}  # see below
    assert set(NEW_OPS) - ELSEWHERE <= covered, \
        sorted(set(NEW_OPS) - ELSEWHERE - covered)


# ---------------------------------------------------------------------------
# Deconvolution and rrelu
# ---------------------------------------------------------------------------
def _flip(w):
    return np.ascontiguousarray(w[(slice(None),) * 2 + (slice(None, None,
                                                               -1),)
                                  * (w.ndim - 2)])


@pytest.mark.parametrize("nd_,kw", [
    (1, {"kernel": (3,), "stride": (2,), "pad": (1,), "adj": (1,)}),
    (2, {"kernel": (3, 2), "stride": (2, 1), "pad": (1, 0)}),
    (2, {"kernel": (4, 4), "stride": (2, 2), "pad": (1, 1), "adj": (1, 1)}),
    (3, {"kernel": (2, 3, 3), "stride": (1, 2, 2), "pad": (0, 1, 1)})])
def test_deconvolution_is_the_reference_on_the_flipped_kernel(nd_, kw):
    x = N((2, 3) + (5, 4, 3)[:nd_])
    w = N((3, 4) + tuple(kw["kernel"]), seed=1)
    b = N((4,), seed=2)
    kw = dict(kw, num_filter=4, no_bias=False)
    want, (wx, ww, wb) = _run(jmx, "Deconvolution", [x, _flip(w), b], kw,
                              (0, 1, 2))
    got, (gx, gw, gb) = _run(mx, "Deconvolution", [x, w, b], kw, (0, 1, 2))
    _check(got[0], want[0], FWD_TOL, "output")
    _check(gx, wx, GRAD_TOL, "data gradient")
    _check(gw, _flip(ww), GRAD_TOL, "weight gradient")
    _check(gb, wb, GRAD_TOL, "bias gradient")


def test_deconvolution_is_the_gradient_of_convolution():
    """Upstream's definition: <deconv(y, w), x> = <y, conv(x, w)>."""
    import torch
    x, y, w = N((2, 3, 7, 6)), N((2, 4, 4, 3), seed=1), N((4, 3, 3, 3),
                                                            seed=2)
    with mx.cpu():
        conv = mx.nd.Convolution(mx.nd.array(x), mx.nd.array(w),
                                 kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                                 num_filter=4, no_bias=True).asnumpy()
        dec = mx.nd.Deconvolution(mx.nd.array(y), mx.nd.array(w),
                                  kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                                  adj=(0, 1), num_filter=3).asnumpy()
    lhs = float((torch.tensor(dec, dtype=torch.float64)
                 * torch.tensor(x, dtype=torch.float64)).sum())
    rhs = float((torch.tensor(conv, dtype=torch.float64)
                 * torch.tensor(y, dtype=torch.float64)).sum())
    assert abs(lhs - rhs) <= 1e-5 * max(1.0, abs(rhs))


def test_rrelu_raises_in_the_reference_and_is_upstreams_here():
    x = N((4, 50)) * 2
    with jmx.cpu(), pytest.raises(ValueError):
        jmx.nd.LeakyReLU(jmx.nd.array(x), act_type="rrelu").asnumpy()
    lo, hi = .1, .4
    with mx.cpu():
        pred = mx.nd.LeakyReLU(mx.nd.array(x), act_type="rrelu",
                               lower_bound=lo, upper_bound=hi).asnumpy()
        mx.random.seed(3)
        with mx.autograd.train_mode():
            train = mx.nd.LeakyReLU(mx.nd.array(x), act_type="rrelu",
                                    lower_bound=lo,
                                    upper_bound=hi).asnumpy()
    np.testing.assert_allclose(pred, np.where(x >= 0, x, (lo + hi) / 2 * x),
                               rtol=1e-6)
    neg = x < 0
    slope = train[neg] / x[neg]
    assert np.all(train[~neg] == x[~neg])
    assert slope.min() >= lo - 1e-6 and slope.max() <= hi + 1e-6
    assert slope.std() > 0.03       # one draw per element


def test_batched_potri_and_maketrian():
    """Batches: the reference's linalg_potri raises on one (an unbatched
    identity), and the gradient of its batched linalg_maketrian raises
    inside ``jax.vjp``; the table holds the single ones with their
    gradients. The port's batched maketrian equals the reference's, and
    both batched results are the stack of the port's single ones."""
    chol = np.linalg.cholesky(SPD(2, 3)).astype(np.float32)
    vec = N((2, 6))
    want, _ = _run(jmx, "linalg_maketrian", [vec], {}, ())
    got, _ = _run(mx, "linalg_maketrian", [vec], {}, ())
    _check(got[0], want[0], FWD_TOL, "linalg_maketrian")
    with pytest.raises(ValueError):
        _run(jmx, "linalg_potri", [chol], {}, ())
    for op, a in (("linalg_potri", chol), ("linalg_maketrian", vec)):
        got, _ = _run(mx, op, [a], {}, ())
        with mx.cpu():
            one = [mx.nd.invoke(op, mx.nd.array(x)).asnumpy() for x in a]
        np.testing.assert_allclose(got[0], np.stack(one), rtol=0, atol=1e-6)
