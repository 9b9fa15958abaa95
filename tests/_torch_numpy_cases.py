"""The `mx.np` op cases shared by tests/test_torch_numpy_ops.py (the
port against the reference on the CPU) and chip_smoke.py's op sweep (the
port on the card against the port on the CPU). Seeded numpy inputs only:
this module imports neither JAX nor torch.

CASES maps each of the reference's 275 `_np_<name>` ops (by public name)
and LINALG each of its 16 `_np_linalg_<name>` ops to a list of
(args, kwargs); a list of numpy arrays in args is a sequence argument.
The callables (apply_along_axis, apply_over_axes, piecewise) work on
torch tensors and jax arrays alike.
"""
import numpy as onp

R = onp.random.RandomState(0)
A = R.randn(3, 4).astype("float32")
B = R.randn(3, 4).astype("float32")
P = (onp.abs(A) + 0.5).astype("float32")           # strictly positive
U = R.uniform(-0.9, 0.9, (3, 4)).astype("float32")  # inside (-1, 1)
V = R.randn(6).astype("float32")
W = R.randn(6).astype("float32")
C3 = R.randn(4, 3).astype("float32")
SQ = (R.randn(4, 4) + 4 * onp.eye(4)).astype("float32")
SPD = (SQ @ SQ.T + onp.eye(4)).astype("float32")
T3 = R.randn(2, 3, 4).astype("float32")
NANS = A.copy()
NANS[0, 1] = onp.nan
NANS[2, 3] = onp.nan
INFS = NANS.copy()
INFS[1, 0] = onp.inf
INFS[1, 2] = -onp.inf
I = onp.array([[3, 1, 2, 0], [1, 0, 3, 2], [0, 2, 1, 3]], dtype="int32")
IV = onp.array([5, -3, 7, 12, 0, 9], dtype="int32")
BOOL = A > 0
U8 = onp.array([3, 200, 7, 0, 255, 18], dtype="uint8")
SORTED = onp.sort(V)
X3 = R.randn(5, 3).astype("float32")
POLY = onp.array([1.0, -3.0, 2.0, 0.5], dtype="float32")
POLY2 = onp.array([2.0, 0.5, -1.0], dtype="float32")
XP = onp.array([0.0, 1.0, 2.5, 4.0], dtype="float32")
FP = onp.array([1.0, 3.0, -2.0, 0.5], dtype="float32")
XQ = onp.array([-0.5, 0.3, 1.7, 2.5, 3.9, 4.5], dtype="float32")


def _sum_rows(r):
    return r.sum()


def _double(r):
    return r * 2


def _axis_sum(a, axis):
    return a.sum(axis)


def _times2(x):
    return x * 2


def _minus1(x):
    return x - 1


# name -> [(args, kwargs), ...]; a list of numpy arrays is a sequence
# argument, each array converted
CASES = {
    "add": [((A, B), {}), ((I, 2.5), {}), ((I, IV[:4]), {}),
            ((BOOL, BOOL), {})],
    "subtract": [((A, B), {}), ((I, 3), {})],
    "multiply": [((A, B), {}), ((A, 2), {}), ((BOOL, BOOL), {})],
    "divide": [((A, P), {}), ((I, 2), {})],
    "true_divide": [((A, P), {}), ((I, IV[:4] + 20), {})],
    "mod": [((A, P), {}), ((I, 3), {})],
    "remainder": [((A, P), {}), ((IV, 4), {})],
    "fmod": [((A, P), {}), ((IV, 4), {})],
    "power": [((P, B), {}), ((I, 2), {})],
    "pow": [((P, B), {})],
    "float_power": [((P, B), {}), ((I, 2), {})],
    "maximum": [((A, B), {}), ((I, 2), {})],
    "minimum": [((A, B), {}), ((I, 2), {})],
    "fmax": [((A, NANS), {})],
    "fmin": [((A, NANS), {})],
    "hypot": [((A, B), {})],
    "negative": [((A,), {}), ((I,), {})],
    "positive": [((A,), {})],
    "reciprocal": [((P,), {})],
    "abs": [((A,), {}), ((IV,), {})],
    "absolute": [((A,), {})],
    "fabs": [((A,), {}), ((IV,), {})],
    "sign": [((A,), {}), ((IV,), {})],
    "heaviside": [((onp.array([-1.5, 0.0, 2.0], "float32"),
                    onp.array([0.3, 0.5, 0.7], "float32")), {})],
    "copysign": [((A, B), {})],
    "ldexp": [((A, I), {})],
    "nextafter": [((A, B), {})],
    "spacing": [((A,), {})],
    "signbit": [((A,), {})],
    "exp": [((A,), {}), ((I,), {})],
    "exp2": [((A,), {})],
    "expm1": [((A,), {})],
    "log": [((P,), {})],
    "log2": [((P,), {})],
    "log10": [((P,), {})],
    "log1p": [((P,), {})],
    "logaddexp": [((A, B), {})],
    "logaddexp2": [((A, B), {})],
    "sqrt": [((P,), {}), ((I + 1,), {})],
    "cbrt": [((A,), {})],
    "square": [((A,), {}), ((I,), {})],
    "sin": [((A,), {})], "cos": [((A,), {})], "tan": [((U,), {})],
    "arcsin": [((U,), {})], "arccos": [((U,), {})], "arctan": [((A,), {})],
    "arctan2": [((A, B), {})],
    "asin": [((U,), {})], "acos": [((U,), {})], "atan": [((A,), {})],
    "atan2": [((A, B), {})],
    "sinh": [((A,), {})], "cosh": [((A,), {})], "tanh": [((A,), {})],
    "arcsinh": [((A,), {})], "arccosh": [((P + 1,), {})],
    "arctanh": [((U,), {})],
    "asinh": [((A,), {})], "acosh": [((P + 1,), {})], "atanh": [((U,), {})],
    "sinc": [((A,), {})],
    "i0": [((A,), {})],
    "angle": [((A,), {})],
    "unwrap": [((onp.array([0.0, 1.0, 4.0, 7.0, 2.0, 9.0], "float32"),),
                {})],
    "degrees": [((A,), {})], "radians": [((A,), {})],
    "deg2rad": [((A,), {})], "rad2deg": [((A,), {})],
    "rint": [((A * 3,), {})],
    "floor": [((A,), {}), ((I,), {})],
    "ceil": [((A,), {})],
    "trunc": [((A,), {}), ((I,), {})],
    "fix": [((A,), {})],
    "round": [((A * 3,), {}), ((A,), {"decimals": 2})],
    "around": [((A * 3,), {})],
    "clip": [((A, -0.5, 0.5), {}), ((I, 1, 2), {})],
    "nan_to_num": [((NANS,), {}), ((NANS,), {"nan": 7.0})],
    "dot": [((A, C3), {}), ((V, W), {}), ((T3, V[:4]), {}), ((A, 2.0), {})],
    "matmul": [((A, C3), {}), ((T3, C3), {})],
    "inner": [((A, B), {}), ((V, W), {})],
    "outer": [((V, W), {})],
    "tensordot": [((T3, C3), {"axes": ([2], [0])}), ((A, B), {"axes": 2})],
    "einsum": [(("ij,jk->ik", A, C3), {}), (("bij->bji", T3), {})],
    "vdot": [((A, B), {})],
    "vecdot": [((A, B), {})],
    "kron": [((A[:2, :2], B[:2, :3]), {})],
    "cross": [((X3, X3[::-1]), {})],
    "trace": [((SQ,), {}), ((I[:, :3],), {})],
    "matrix_transpose": [((T3,), {})],
    "sum": [((A,), {}), ((A,), {"axis": 1, "keepdims": True}),
            ((I,), {"axis": 0}), ((BOOL,), {}),
            ((I.astype("int8"),), {})],
    "prod": [((P,), {"axis": 0}), ((I + 1,), {})],
    "mean": [((A,), {"axis": 0}), ((I,), {})],
    "std": [((A,), {}), ((A,), {"axis": 1, "ddof": 1})],
    "var": [((A,), {"axis": 0}), ((A,), {})],
    "cumsum": [((A,), {"axis": 1}), ((A,), {}), ((I,), {"axis": 0})],
    "cumprod": [((P,), {"axis": 0}), ((I,), {"axis": 1})],
    "max": [((A,), {}), ((A,), {"axis": 1}), ((I,), {"axis": 0})],
    "min": [((A,), {"axis": 0, "keepdims": True})],
    "amax": [((A,), {"axis": 1})],
    "amin": [((A,), {})],
    "ptp": [((A,), {"axis": 0})],
    "median": [((A,), {}), ((A,), {"axis": 1}), ((V,), {})],
    "quantile": [((A, 0.3), {}), ((A, onp.array([0.1, 0.75], "float32")),
                                  {"axis": 1})],
    "percentile": [((A, 40.0), {"axis": 0})],
    "average": [((A,), {"axis": 1}),
                ((A,), {"axis": 1, "weights": P[0]})],
    "nansum": [((NANS,), {}), ((NANS,), {"axis": 1})],
    "nanprod": [((NANS,), {"axis": 0})],
    "nanmean": [((NANS,), {"axis": 1})],
    "nanstd": [((NANS,), {})],
    "nanvar": [((NANS,), {"axis": 0})],
    "nanmedian": [((NANS,), {"axis": 1})],
    "nanquantile": [((NANS, 0.25), {"axis": 1})],
    "nanpercentile": [((NANS, 60.0), {"axis": 0})],
    "nanmax": [((NANS,), {"axis": 1})],
    "nanmin": [((NANS,), {})],
    "nancumsum": [((NANS,), {"axis": 1})],
    "nancumprod": [((NANS,), {"axis": 0})],
    "nanargmax": [((NANS,), {"axis": 1})],
    "nanargmin": [((NANS,), {})],
    "trapezoid": [((A,), {}), ((A,), {"x": onp.array(
        [0.0, 0.5, 1.7, 2.0], "float32")}), ((A,), {"dx": 0.3, "axis": 0})],
    "corrcoef": [((A,), {})],
    "cov": [((A,), {}), ((A,), {"rowvar": False})],
    "reshape": [((A, (4, 3)), {}), ((A, (2, -1)), {})],
    "ravel": [((A,), {})],
    "transpose": [((T3,), {}), ((T3, (1, 0, 2)), {})],
    "permute_dims": [((T3, (2, 0, 1)), {})],
    "swapaxes": [((T3, 0, 2), {})],
    "moveaxis": [((T3, 0, -1), {})],
    "rollaxis": [((T3, 2), {}), ((T3, 0, 2), {})],
    "expand_dims": [((A, 1), {}), ((A, (0, 3)), {})],
    "squeeze": [((A[None, :, None],), {}), ((A[None],), {"axis": 0})],
    "broadcast_to": [((V[:4], (3, 4)), {})],
    "concatenate": [(([A, B],), {}), (([A, B],), {"axis": 1}),
                    (([A, B],), {"axis": None})],
    "concat": [(([A, B],), {"axis": 1})],
    "stack": [(([A, B],), {}), (([A, B],), {"axis": 2})],
    "vstack": [(([A, B],), {}), (([V, W],), {})],
    "hstack": [(([A, B],), {}), (([V, W],), {})],
    "dstack": [(([A, B],), {})],
    "column_stack": [(([V, W],), {})],
    "split": [((A, 2), {"axis": 1}), ((V, [1, 4]), {})],
    "array_split": [((V, 4), {})],
    "vsplit": [((A[:2], 2), {})],
    "hsplit": [((A, 2), {})],
    "dsplit": [((T3, 2), {})],
    "tile": [((A, 2), {}), ((V, (2, 2)), {})],
    "repeat": [((A, 2), {}), ((A, 2), {"axis": 0}),
               ((V[:3], onp.array([1, 0, 2], "int32")), {})],
    "roll": [((A, 2), {}), ((A, -1), {"axis": 1})],
    "flip": [((A,), {}), ((T3,), {"axis": 1})],
    "fliplr": [((A,), {})],
    "flipud": [((A,), {})],
    "rot90": [((A,), {}), ((A,), {"k": 3})],
    "pad": [((A, 1), {}), ((A, ((1, 0), (0, 2))), {"mode": "edge"}),
            ((A, 2), {"mode": "reflect"}), ((A, 1), {"mode": "wrap"}),
            ((A, 2), {"mode": "symmetric"}),
            ((A, 1), {"constant_values": 3.5}),
            ((A, 1), {"mode": "maximum"}), ((A, 1), {"mode": "mean"})],
    "append": [((A, B), {}), ((A, B), {"axis": 0})],
    "delete": [((A, 1, 0), {}), ((V, onp.array([0, 3], "int32")), {})],
    "insert": [((A, 1, 5.0, 0), {}), ((V, 2, 9.0), {}),
               ((A, 1, V[:3]), {"axis": 1})],
    "resize": [((A, (5, 3)), {})],
    "trim_zeros": [((onp.array([0.0, 0.0, 1.5, 2.0, 0.0], "float32"),),
                    {})],
    "broadcast_arrays": [((A, V[:4]), {})],
    "atleast_1d": [((onp.array(A[0, 0]),), {})],
    "atleast_2d": [((V,), {})],
    "atleast_3d": [((A,), {}), ((V,), {})],
    "astype": [((A, "float16"), {}), ((A, "int32"), {}),
               ((I, "float32"), {})],
    "copy": [((A,), {})],
    "take": [((A, I[0]), {}), ((A, I[0], 1), {}),
             ((V, onp.array([-1, 7, 2], "int32")), {}),
             ((V, onp.array([-1, 7, 2], "int32")), {"mode": "clip"}),
             ((IV, onp.array([-9, 1], "int32")), {})],
    "take_along_axis": [((A, I % 4, 1), {}),
                        ((A, onp.argsort(A, axis=0).astype("int32"), 0),
                         {})],
    "where": [((A > 0, A, B), {}), ((A > 0, A, 0.0), {})],
    "select": [(([A > 0.5, A < -0.5], [A, B]), {"default": 1.0})],
    "compress": [((onp.array([True, False, True]), A, 0), {}),
                 ((onp.array([0, 1, 1, 0, 1], "int32"), V), {})],
    "choose": [((onp.array([[0, 1, 0, 1], [1, 1, 0, 0], [0, 0, 1, 1]],
                           "int32"), [A, B]), {})],
    "extract": [((A > 0, A), {})],
    "diag": [((SQ,), {}), ((V,), {}), ((SQ,), {"k": 1})],
    "diagflat": [((V[:3],), {}), ((A[:1, :2],), {"k": -1})],
    "diagonal": [((SQ,), {}), ((T3,), {"offset": 1, "axis1": 1,
                                       "axis2": 2})],
    "tril": [((A,), {}), ((A,), {"k": -1})],
    "triu": [((A,), {"k": 1})],
    "meshgrid": [((V[:3], W[:4]), {}), ((V[:3], W[:4]),
                                       {"indexing": "ij"})],
    "ix_": [((onp.array([0, 2], "int32"), onp.array([1, 3, 0], "int32")),
             {})],
    "sort": [((A,), {}), ((A,), {"axis": 0}), ((I,), {"axis": None})],
    "partition": [((V, 2), {}), ((A, 1), {"axis": 1})],
    "argpartition": [((V, 2), {}), ((A, 2), {"axis": 1})],
    "argmax": [((A,), {}), ((A,), {"axis": 1})],
    "argmin": [((A,), {"axis": 0})],
    "argsort": [((A,), {}), ((I,), {"axis": 0})],
    "argwhere": [((A > 0,), {})],
    "searchsorted": [((SORTED, V), {}), ((SORTED, W), {"side": "right"}),
                     ((SORTED, 0.1), {})],
    "flatnonzero": [((A > 0,), {})],
    "count_nonzero": [((I,), {}), ((I,), {"axis": 1})],
    "nonzero": [((A > 0,), {}), ((V > 0,), {})],
    "lexsort": [(([I[0], I[1]],), {})],
    "sort_complex": [((V,), {})],
    "digitize": [((V, onp.array([-1.0, 0.0, 1.0], "float32")), {}),
                 ((V, onp.array([1.0, 0.0, -1.0], "float32")),
                  {"right": True})],
    "floor_divide": [((A, P), {}), ((IV, 4), {})],
    "equal": [((I, I.T.reshape(3, 4)), {})],
    "not_equal": [((I, I.T.reshape(3, 4)), {})],
    "greater": [((A, B), {})], "greater_equal": [((A, B), {})],
    "less": [((A, B), {})], "less_equal": [((A, 0.0), {})],
    "logical_and": [((A > 0, B > 0), {})],
    "logical_or": [((A > 0, B > 0), {})],
    "logical_not": [((A > 0,), {})],
    "logical_xor": [((A > 0, B), {})],
    "isnan": [((NANS,), {})], "isinf": [((INFS,), {})],
    "isfinite": [((NANS,), {})],
    "isposinf": [((onp.array([1.0, onp.inf, -onp.inf], "float32"),), {})],
    "isneginf": [((onp.array([1.0, onp.inf, -onp.inf], "float32"),), {})],
    "isreal": [((A,), {})], "iscomplex": [((A,), {})],
    "all": [((A > -3,), {}), ((A > 0,), {"axis": 1})],
    "any": [((A > 0,), {"axis": 0}), ((A > 9,), {})],
    "allclose": [((A, A + 1e-7), {}), ((A, B), {})],
    "isclose": [((A, A + B * 1e-6), {})],
    "array_equal": [((A, A), {}), ((A, B), {}), ((A, V), {})],
    "array_equiv": [((A, A[0:1]), {}), ((A, B), {})],
    "isin": [((I, onp.array([1, 3], "int32")), {})],
    "unique": [((I,), {}), ((I,), {"return_index": True,
                                    "return_inverse": True,
                                    "return_counts": True}),
               ((onp.array([[1, 2], [1, 2], [0, 3]], "int32"),),
                {"axis": 0})],
    "union1d": [((IV, I[0]), {})],
    "intersect1d": [((IV, onp.array([7, 0, 4, 5], "int32")), {})],
    "setdiff1d": [((IV, onp.array([7, 0, 4], "int32")), {})],
    "setxor1d": [((IV, onp.array([7, 0, 4], "int32")), {})],
    "unique_all": [((I,), {})],
    "unique_counts": [((I,), {})],
    "unique_inverse": [((I,), {})],
    "unique_values": [((I,), {})],
    "lcm": [((onp.abs(IV) + 1, 6), {})],
    "gcd": [((onp.abs(IV), 6), {})],
    "bincount": [((onp.abs(IV),), {}), ((I.ravel(),), {"weights": A.ravel()}),
                 ((I.ravel(),), {"minlength": 6})],
    "bitwise_and": [((IV, 6), {})], "bitwise_or": [((IV, 6), {})],
    "bitwise_xor": [((IV, I[0, :1]), {})],
    "bitwise_not": [((IV,), {})], "bitwise_invert": [((U8,), {})],
    "bitwise_count": [((IV,), {}), ((U8,), {})],
    "invert": [((IV,), {}), ((BOOL,), {})],
    "left_shift": [((IV, 2), {})], "right_shift": [((IV, 1), {})],
    "bitwise_left_shift": [((U8, 1), {})],
    "bitwise_right_shift": [((IV, 2), {})],
    "packbits": [((onp.array([1, 0, 1, 1, 0, 0, 0, 1, 1], "uint8"),), {}),
                 ((BOOL,), {"axis": 1})],
    "unpackbits": [((U8,), {}), ((U8,), {"bitorder": "little"})],
    "interp": [((XQ, XP, FP), {}), ((XQ, XP, FP), {"left": -9.0,
                                                   "right": 9.0})],
    "diff": [((A,), {}), ((A,), {"axis": 0, "n": 2}), ((BOOL,), {})],
    "ediff1d": [((A,), {})],
    "gradient": [((V,), {}), ((A,), {})],
    "convolve": [((V, W[:3]), {}), ((V, W[:4]), {"mode": "same"}),
                 ((V[:3], W), {"mode": "valid"})],
    "correlate": [((V, W[:3]), {}), ((V, W[:3]), {"mode": "full"})],
    "real": [((A,), {})], "imag": [((A,), {})],
    "conj": [((A,), {})], "conjugate": [((A,), {})],
    "histogram": [((A,), {}), ((A,), {"bins": 4, "range": (-1.0, 1.0)})],
    "histogram2d": [((V, W), {"bins": 3})],
    "histogramdd": [((X3,), {"bins": 2})],
    "histogram_bin_edges": [((A,), {"bins": 5})],
    "frexp": [((A,), {})],
    "modf": [((A * 3,), {})],
    "divmod": [((A, P), {}), ((IV, 4), {})],
    "unravel_index": [((onp.array([7, 3, 11], "int32"), (3, 4)), {})],
    "ravel_multi_index": [(((onp.array([2, 0], "int32"),
                             onp.array([3, 1], "int32")), (3, 4)), {})],
    "polyval": [((POLY, A), {})],
    "polyadd": [((POLY, POLY2), {})],
    "polysub": [((POLY, POLY2), {})],
    "polymul": [((POLY, POLY2), {})],
    "polyder": [((POLY,), {}), ((POLY,), {"m": 2})],
    "polyint": [((POLY,), {}), ((POLY,), {"m": 2, "k": 1.5})],
    "polydiv": [((POLY, POLY2), {})],
    "polyfit": [((XP + 0.25, FP, 2), {})],
    "poly": [((onp.array([1.0, -2.0, 0.5], "float32"),), {})],
    "roots": [((onp.array([1.0, -3.0, 2.0], "float32"),), {})],
    "vander": [((V[:4],), {}), ((V[:4],), {"N": 3, "increasing": True})],
    "apply_along_axis": [((_sum_rows, 1, A), {}), ((_double, 0, A), {})],
    "apply_over_axes": [((_axis_sum, A, [0, 1]), {})],
    "piecewise": [((V, [V < 0, V >= 0], [_times2, _minus1]), {}),
                  ((V, [V < -0.5], [_times2, 3.0]), {})],
}

LINALG = {
    "norm": [((A,), {}), ((A,), {"axis": 1}), ((A,), {"ord": 1}),
             ((V,), {"ord": 3})],
    "svd": [((A,), {})],
    "cholesky": [((SPD,), {})],
    "qr": [((C3,), {})],
    "pinv": [((A,), {})],
    "solve": [((SQ, V[:4]), {}), ((SQ, A.T), {})],
    "lstsq": [((C3, V[:4]), {})],
    "eig": [((SPD,), {})],
    "eigvals": [((SPD,), {})],
    "eigh": [((SPD,), {})],
    "eigvalsh": [((SPD,), {})],
    "matrix_rank": [((A,), {}), ((onp.outer(V, W).astype("float32"),),
                                 {})],
    "matrix_power": [((SQ / 4, 3), {})],
    "multi_dot": [(([A, C3, B[:, :2]],), {})],
    "tensorinv": [((SQ.reshape(4, 2, 2), 1), {})],
    "tensorsolve": [((SQ.reshape(2, 2, 4), A[:2, :2]), {})],
}

# looser forward tolerances, and why
FORWARD_TOL = {
    # factorizations and fits: LAPACK in torch against XLA's own routines
    "svd": 1e-4, "qr": 1e-4, "pinv": 1e-4, "lstsq": 1e-4, "eig": 1e-4,
    "eigvals": 1e-4, "eigh": 1e-4, "eigvalsh": 1e-4, "cholesky": 1e-5,
    "solve": 1e-5, "tensorinv": 1e-5, "tensorsolve": 1e-5,
    "matrix_power": 1e-5, "multi_dot": 1e-5, "polyfit": 1e-4,
    "roots": 1e-5, "poly": 1e-5, "cov": 1e-5, "corrcoef": 1e-5,
    # special functions and transcendental compositions (one or two ulps
    # of a different polynomial)
    "i0": 1e-5, "sinc": 1e-5, "cbrt": 1e-6, "logaddexp2": 1e-6,
    "std": 1e-6, "nanstd": 1e-6,
}
GRAD_TOL = 1e-5
GRAD_TOL_LOOSE = {"svd": 1e-3, "qr": 1e-3, "pinv": 1e-3, "eigh": 1e-3,
                  "eigvalsh": 1e-4, "cholesky": 1e-4, "tensorinv": 1e-4,
                  "tensorsolve": 1e-4, "solve": 1e-4, "polyfit": 1e-3,
                  "i0": 1e-4, "corrcoef": 1e-4, "cov": 1e-4,
                  "matrix_power": 1e-4}
# sign and phase of eigen/singular vectors differ between LAPACK calls:
# held by reconstruction and by the invariants instead
VECTOR_OUTPUTS = {"svd", "qr", "eig", "eigh"}

# sequence arguments unpacked into arrays by both packages' surfaces;
# the other ops' sequences (select, choose, ravel_multi_index) reach
# jax.numpy as they are, so both packages get them as numpy arrays
SEQ_UNPACKED = {"concatenate", "concat", "stack", "vstack", "hstack",
                "dstack", "column_stack", "lexsort", "multi_dot"}
