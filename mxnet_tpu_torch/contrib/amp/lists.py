"""AMP op lists (a copy of `mxnet_tpu.contrib.amp.lists`; reference:
python/mxnet/contrib/amp/lists/symbol_fp16.py): the ops that run in the
low-precision type, the ops pinned to float32, and the multi-input ops
that run in the widest floating type of their inputs."""

# matmul- and convolution-class ops: the tensor cores take them in bf16 or
# fp16
TARGET_DTYPE_OPS = [
    "Convolution", "Deconvolution", "FullyConnected", "dot", "batch_dot",
    "RNN",
]

# numerically sensitive ops pinned to fp32 (the reference's FP32_FUNCS
# core set)
FP32_OPS = [
    "softmax", "log_softmax", "SoftmaxOutput", "SoftmaxActivation",
    "BatchNorm", "LayerNorm", "InstanceNorm", "L2Normalization", "norm",
    "exp", "log", "log2", "log10", "log1p", "expm1", "rsqrt", "sqrt",
    "square", "sum", "mean", "prod", "nansum", "nanprod", "cumsum",
    "erf", "erfinv", "gamma", "gammaln", "power", "rcbrt", "cbrt",
    "smooth_l1", "arcsin", "arccos", "arctan", "arcsinh", "arccosh",
    "arctanh", "sin", "cos", "tan", "sinh", "cosh", "tanh",
    "linalg_gemm", "linalg_gemm2", "linalg_potrf", "linalg_syrk",
    "moments", "topk",
]

# elementwise multi-input ops that run in the widest input dtype
WIDEST_TYPE_CASTS = [
    "broadcast_add", "broadcast_sub", "broadcast_mul", "broadcast_div",
    "broadcast_maximum", "broadcast_minimum", "broadcast_power",
    "broadcast_hypot", "elemwise_add", "elemwise_sub", "elemwise_mul",
    "elemwise_div", "add_n", "concat", "Concat", "stack", "where",
    "maximum", "minimum",
]
