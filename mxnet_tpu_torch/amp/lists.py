"""AMP op lists: a copy of ``mxnet_tpu/amp/lists.py`` (reference:
python/mxnet/amp/lists/symbol_fp16.py, symbol_bf16.py). Entries are
dispatch names: the names under which the port's ops call
``amp._maybe_cast_op_inputs`` (the JAX package's ``_invoke`` names), so one
entry covers every call site. Ops that run on the tensor cores run in the
target dtype; reductions, normalizations and transcendentals in fp32;
elementwise combiners widen to the widest floating input (torch's type
promotion, as jnp's)."""

# run in target (bf16/fp16) precision: the tensor-core products
# (reference FP16_FUNCS: Convolution/Deconvolution/FullyConnected/RNN +
# the attention matmul ops)
TARGET_DTYPE_OPS = [
    "matmul", "dot", "einsum", "tensordot", "convolution", "deconvolution",
    "fused_conv_bn_relu",   # BN statistics accumulate f32 internally
    "fully_connected", "batch_dot", "rnn", "multi_head_attention",
    "interleaved_matmul_selfatt_qk", "interleaved_matmul_selfatt_valatt",
    "interleaved_matmul_encdec_qk", "interleaved_matmul_encdec_valatt",
]

# always fp32 — numerically sensitive
# (reference FP32_FUNCS: norm layers, softmax family, losses, exp/log
# transcendentals, cumulative reductions)
FP32_OPS = [
    "softmax", "log_softmax", "masked_softmax", "masked_log_softmax",
    "softmin", "batch_norm", "layer_norm", "group_norm", "instance_norm",
    "l2_normalization", "lrn",
    "sum", "mean", "var", "std", "norm", "cumsum", "prod", "nansum",
    "exp", "expm1", "log", "log1p", "log2", "log10", "erf", "erfinv",
    "gamma", "gammaln", "digamma", "sqrt", "cbrt",
    "arccos", "arcsin", "arctanh", "arccosh", "cosh", "sinh", "tan",
    "softmax_cross_entropy", "smooth_l1", "ctc_loss", "softmax_output",
    "linear_regression_output", "logistic_regression_output",
    "mae_regression_output", "make_loss",
]

# fp32 only for specific attr values, encoded as dispatch-name suffixes
# ("activation:softrelu") — the analog of the reference's
# CONDITIONAL_FP32_FUNCS [(op, attr, values)] triples
# (amp/lists/symbol_fp16.py CONDITIONAL_FP32_FUNCS)
CONDITIONAL_FP32_OPS = [
    ("activation", "act_type", ["softrelu"]),
    ("leaky_relu", "act_type", ["elu", "selu"]),
    ("pooling", "pool_type", ["lp", "sum"]),
]

# elementwise combiners: cast mixed floating inputs to the widest dtype
# present (reference: WIDEST_TYPE_CASTS via amp_multicast,
# symbol_fp16.py:629-688 — the full npi tail)
WIDEST_TYPE_CASTS = [
    "add", "subtract", "multiply", "true_divide", "divide", "where",
    "maximum", "minimum", "fmax", "fmin", "fmod", "hypot", "mod",
    "remainder", "copysign", "cross", "kron", "ldexp", "arctan2",
    "ediff1d", "logical_and", "logical_or", "logical_xor",
    "equal", "not_equal", "greater", "greater_equal", "less", "less_equal",
    "concatenate", "stack", "column_stack", "vstack", "hstack", "dstack",
    "dot", "inner", "outer", "vdot",
]


def conditional_fp32_names():
    """The conditional triples expanded to exact dispatch names
    (dispatch names carry the attr value as a suffix)."""
    out = set()
    for op, _attr, values in CONDITIONAL_FP32_OPS:
        for v in values:
            out.add(f"{op}:{v}")
    return out
