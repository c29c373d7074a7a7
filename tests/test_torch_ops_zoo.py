"""The PyTorch port's op zoo (ops/ref/{shape,reduce,norm,misc,detection}.py,
conv1d / conv3d / deconv, embedding, rope, llm_pos and the streaming-ASR
cache ops, through ops/api.py) against the JAX package, on the CPU.

  * every case of csinn2_tpu_torch/examples/op_zoo.py — the same seeded
    numpy inputs through the JAX op API and the port's, layer mode: integer
    and boolean outputs and the cases of tolerance 0 (shape and index ops)
    bit for bit, dtype included; float outputs within rtol = 10·tol,
    atol = tol, tol the JAX package's own test's for that op
    (tests/test_op_goldens.py, test_ops_extended.py, test_ops_layer.py);
  * the same case recorded into a GRAPH Session on the CPU (output shapes
    inferred on meta tensors) equal to the eager call, bit for bit;
  * concat and conv1d under the dtype matrix's schemes
    (tests/test_dtype_matrix.py:24-45): the port's output against JAX's
    (integer carriers within 1 LSB — the generic dequant → f32 → requant
    path, whose f32 sums can round the other way — float carriers within
    one ulp of the output dtype of max|y|), and the port's dequantized
    output against the float golden at that file's cosine gate;
  * coverage: the port registers every op of the JAX registry, its ops.api
    has every public callable of the JAX ops.api, and every op this slice
    adds has a case.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import csinn2_tpu.ops.api as japi
from csinn2_tpu import ops as jops
from csinn2_tpu.core.dtypes import Dtype as JDtype
from csinn2_tpu.core.quant import observe as jobserve
from csinn2_tpu.core.tensor import Tensor as JTensor
from csinn2_tpu.core.tensor import from_float as jfrom_float
from csinn2_tpu.ops.registry import registry as jregistry
import csinn2_tpu_torch.ops.api as tapi
from csinn2_tpu_torch import ops
from csinn2_tpu_torch.core.dtypes import Dtype
from csinn2_tpu_torch.core.quant import observe
from csinn2_tpu_torch.core.tensor import Tensor, from_float
from csinn2_tpu_torch.examples import op_zoo as Z
from csinn2_tpu_torch.ops.registry import registry
from csinn2_tpu_torch.utils.verify import cosine_similarity

torch.set_num_threads(2)
T = torch.from_numpy

# the 94 ops of the JAX registry this slice adds to the port
NEW_OPS = frozenset("""
all any arange argmax argmin batch_norm batch_to_space batch_to_space_nd broadcast_to
cache_conv1d cache_matmul cast col2im concat conv1d conv3d crop cumprod cumsum deconv2d
deconv3d depth_to_space depthwise_conv1d depthwise_deconv2d embedding expand_dims flip fsmn
gather gather_nd group_conv1d group_deconv2d im2col instance_norm l2_normalization
layer_norm llm_pos lrn max maxpool2d_locat mean mean_stride min min_stride ndarray_size
non_max_suppression one_hot pad prod proposal psroipooling reduce_logsumexp reduce_max
reduce_mean reduce_min reduce_prod reduce_sum reorg reshape resize reverse rms_norm
roialign roipool rope scatter_nd segment_max segment_mean segment_min segment_prod
segment_sum sequence_mask shape shuffle_channel slice space_to_batch space_to_batch_nd
space_to_depth split squeeze stack strided_slice sum tile topk transpose unpooling
unsorted_segment_max unsorted_segment_mean unsorted_segment_min unsorted_segment_prod
unsorted_segment_sum unstack yuv_rgb_scale
""".split())


@pytest.mark.parametrize("name", list(Z.CASES))
def test_case_matches_jax(name):
    fn, tol = Z.CASES[name]
    want = Z.arrays(fn(jops))
    got = Z.arrays(fn(ops))
    why = Z.mismatch(got, want, tol)
    assert not why, f"{name}: {why}"
    graph = Z.arrays(Z.run_graph(name, "cpu"))
    why = Z.mismatch(graph, got, 0)
    assert not why, f"{name} (GRAPH session): {why}"


def test_coverage_of_the_jax_registry_and_api():
    jax_ops = set(jregistry.ops())
    assert len(NEW_OPS) == 94
    assert not jax_ops - set(registry.ops()), sorted(jax_ops - set(registry.ops()))
    assert not set(registry.ops()) - jax_ops
    case_ops = {Z.case_op(n) for n in Z.CASES}
    assert not NEW_OPS - case_ops, sorted(NEW_OPS - case_ops)
    assert case_ops <= jax_ops
    public = [n for n in dir(japi) if not n.startswith("_") and callable(getattr(japi, n))]
    assert len(public) == 201
    missing = [n for n in public if not hasattr(tapi, n)]
    assert not missing, missing
    # every function of the JAX ops.api is exported by the port's ops package
    defined = [n for n in public if getattr(getattr(japi, n), "__module__", "") == japi.__name__]
    assert not set(defined) - set(tapi.__all__), sorted(set(defined) - set(tapi.__all__))
    assert all(hasattr(ops, n) for n in tapi.__all__)


def test_squeeze_of_a_wider_axis_raises_as_in_jax():
    x = np.ones((2, 3), np.float32)
    for o in (jops, ops):
        with pytest.raises(ValueError):
            o.squeeze(x, o.SqueezeParams(axis=(0,)))


def test_not_registered_op_raises():
    with pytest.raises(NotImplementedError, match="no registered implementation"):
        registry.lookup("no_such_op")


# -- the dtype matrix (tests/test_dtype_matrix.py) for concat and conv1d ------------------

# scheme → (activation dtype, weight dtype, weight per-channel, cosine gate)
SCHEMES = {
    "f32": (None, None, False, 0.9999), "f16": ("FLOAT16", "FLOAT16", False, 0.999),
    "bf16": ("BFLOAT16", "BFLOAT16", False, 0.995), "i8": ("INT8", "INT8", False, 0.99),
    "i8pc": ("INT8", "INT8", True, 0.99), "u8": ("UINT8", "INT8", False, 0.99),
    "i16": ("INT16", "INT16", False, 0.9999),
}
GENERIC_LSB = 1


def _as(x, dt, axis=None):
    """(JAX Tensor, port Tensor) of x under dtype name dt."""
    if dt is None:
        return JTensor(jnp.asarray(x)), Tensor(x)
    if dt in ("FLOAT16", "BFLOAT16"):
        return JTensor(jnp.asarray(x, JDtype[dt].jnp)), Tensor(T(x).to(Dtype[dt].torch))
    sym = dt != "UINT8"
    return (jfrom_float(x, jobserve(x, JDtype[dt], symmetric=sym, axis=axis)),
            from_float(x, observe(x, Dtype[dt], symmetric=sym, axis=axis)))


def _out(golden, dt):
    if dt is None:
        return None, None
    if dt in ("FLOAT16", "BFLOAT16"):
        return jobserve(golden, JDtype[dt]), observe(golden, Dtype[dt])
    sym = dt != "UINT8"
    return (jobserve(golden, JDtype[dt], symmetric=sym),
            observe(golden, Dtype[dt], symmetric=sym))


def _matrix(scheme, golden, build, xs):
    """xs: [(array, 'a' activation | 'w' weight)]; build(ops, tensors, out_qinfo)."""
    adt, wdt, perchan, cos = SCHEMES[scheme]
    pairs = [_as(a, adt if slot == "a" else wdt, axis=0 if (slot == "w" and perchan) else None)
             for a, slot in xs]
    jo, to = _out(golden, adt)
    want = build(jops, [p[0] for p in pairs], jo)
    got = build(ops, [p[1] for p in pairs], to)
    w, g = np.asarray(want.data), got.data
    if adt is None or adt in ("FLOAT16", "BFLOAT16"):
        g = g.float().numpy()
        w = np.asarray(w, np.float32)
        eps = 1e-6 if adt is None else float(torch.finfo(Dtype[adt].torch).eps)
        np.testing.assert_allclose(g, w, rtol=eps, atol=eps * np.abs(w).max())
    else:
        assert g.dtype == getattr(torch, str(w.dtype))
        d = np.abs(g.numpy().astype(int) - w.astype(int))
        assert d.max() <= GENERIC_LSB, d.max()
    c = cosine_similarity(got.astype_f32().numpy(), golden)
    assert c >= cos, (scheme, c)


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_matrix_concat(rng, scheme):
    a = rng.standard_normal((2, 8)).astype(np.float32)
    b = rng.standard_normal((2, 8)).astype(np.float32)
    _matrix(scheme, np.concatenate([a, b], axis=1),
            lambda o, ts, oq: o.concat(ts, o.ConcatParams(axis=1), out_qinfo=oq),
            [(a, "a"), (b, "a")])


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_matrix_conv1d(rng, scheme):
    x = rng.standard_normal((2, 4, 20)).astype(np.float32)
    w = (rng.standard_normal((8, 4, 5)) * 0.3).astype(np.float32)
    golden = torch.nn.functional.conv1d(T(x), T(w), padding=2).numpy()
    _matrix(scheme, golden,
            lambda o, ts, oq: o.conv1d(ts[0], ts[1], None, o.Conv1dParams(pad=(2, 2)),
                                       out_qinfo=oq),
            [(x, "a"), (w, "w")])
