"""The Q4_0 dequant-strategy probes of the PyTorch port
(csinn2_tpu_torch/kernels/int4_probe.py and examples/int4_dequant_probe.py)
against the JAX probe, examples/int4_dequant_probe.py, on the CPU.

The JAX probe is loaded from its file; in these tests only, its module's
`pl` is replaced by a namespace whose `pallas_call` runs in interpret mode.
On the CPU the port's wrappers run the kernels' plain versions.

Gates:
  * the packers byte for byte: the mixed pack (pack_int4_mixed), main's
    re-biased pack, the Q4_0 pack, and the i4native carrier against a plain
    numpy packer of `jnp.int4 [K, N]` (column 2j low nibble, 2j+1 high);
  * each of the 11 kernels' functions (run_split i32/i8, run_i4,
    run_bitcast, run_andmask, run_andmask_bf16s, run_stream, run_intdot,
    run_w4a8, run_timing_variant noscale/halfq8) against the JAX function at
    two shapes: cosine >= 0.99999 and max|Δ| <= 1e-5·max|y|: the bf16
    plane values and the int32 partials are the same, only the f32 sums run
    in another order; bitcast 1e-4, since its correction cancels ~97 % of
    the kernel's sum and so magnifies that order's rounding;
  * the slice: the port's probe program with device="cpu" gives every
    variant of main (cur(quant_matmul), the w4a8 geometries and the andmask
    sweep included) the JAX function's cosine against the golden within
    1e-4."""

import functools
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csinn2_tpu.kernels.qmatmul import quant_matmul as jax_qmm
from csinn2_tpu_torch.examples import int4_dequant_probe as tprobe
from csinn2_tpu_torch.kernels import int4_probe as T
from csinn2_tpu_torch.kernels.qmatmul import pack_int4 as t_pack_int4
from csinn2_tpu_torch.utils.verify import cosine_similarity

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(512, 256, 128, 256), (1024, 384, 128, 512)]      # (K, N, bn, bk), M = 8
M = 8


@pytest.fixture(scope="module")
def jp():
    """The JAX probe module with interpret-mode pallas_call."""
    spec = importlib.util.spec_from_file_location(
        "int4_dequant_probe_jax", os.path.join(REPO, "examples", "int4_dequant_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mp = pytest.MonkeyPatch()
    pl = mod.pl
    ns = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("__")})
    ns.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    mp.setattr(mod, "pl", ns)
    yield mod
    mp.undo()


def _inputs(K, N, seed=0):
    rng = np.random.default_rng(seed)
    x = np.asarray(jnp.asarray(rng.standard_normal((M, K)), jnp.bfloat16), np.float32)
    q = rng.integers(-8, 8, (K, N)).astype(np.int8)
    s = (rng.random((K // 32, N)) * 0.01 + 0.005).astype(np.float32)
    return x, q, s


def _biased_jax(q):
    """main's re-biased pack (int4_dequant_probe.py:609-614)."""
    K, N = q.shape
    qb = ((q.astype(np.int16) + 8) & 0xF).astype(np.int8)
    q3 = qb.reshape(K // 32, 32, N)
    return (q3[:, :16, :].astype(np.int32) | (q3[:, 16:, :].astype(np.int32) << 4)) \
        .astype(np.int8).reshape(K // 2, N)


@pytest.mark.parametrize("K,N", [(64, 8), (512, 384)])
def test_packers_byte_for_byte(jp, K, N):
    _, q, _ = _inputs(K, N, seed=K)
    q[0, :2] = (-8, 7)
    qt = torch.from_numpy(q)
    np.testing.assert_array_equal(T.pack_int4_mixed(qt).numpy(),
                                  np.asarray(jp.pack_int4_mixed(q)))
    np.testing.assert_array_equal(T.pack_int4_biased(qt).numpy(), _biased_jax(q))
    np.testing.assert_array_equal(t_pack_int4(qt).numpy(), np.asarray(jp.pack_int4(jnp.asarray(q))))
    native = ((q[:, 0::2].astype(np.int32) & 0xF) | ((q[:, 1::2].astype(np.int32) & 0xF) << 4))
    np.testing.assert_array_equal(T.pack_int4_native(qt).numpy(), native.astype(np.uint8)
                                  .view(np.int8))
    np.testing.assert_array_equal(T.unpack_int4_native(T.pack_int4_native(qt)).numpy(), q)


def _jax_call(jp, kind, x, q, s, bn, bk):
    xj, sj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(s)
    wp, wm = jp.pack_int4(jnp.asarray(q)), jp.pack_int4_mixed(q)
    s16 = sj.astype(jnp.bfloat16)
    f = {"split_i32": lambda: jp.run_split(xj, wp, sj, M, bn, bk, "i32"),
         "split_i8": lambda: jp.run_split(xj, wp, sj, M, bn, bk, "i8"),
         "i4native": lambda: jp.run_i4(xj, jax.jit(lambda a: a.astype(jnp.int4))(
             jnp.asarray(q)), sj, M, bn, bk),
         "bitcast": lambda: jp.run_bitcast(xj, jnp.asarray(_biased_jax(q)), sj, M, bn, bk),
         "andmask": lambda: jp.run_andmask(xj, wm, sj, M, bn, bk),
         "andmask_bf16s": lambda: jp.run_andmask_bf16s(xj, wm, s16, M, bn, bk),
         "stream": lambda: jp.run_stream(xj, wp, sj, M, bn, bk),
         "intdot": lambda: jp.run_intdot(xj, wm, sj, M, bn, bk),
         "w4a8": lambda: jp.run_w4a8(xj, wm, sj, M, bn, bk),
         "noscale": lambda: jp.run_timing_variant(jp._noscale_kernel, xj, wm, s16, M, bn, bk),
         "halfq8": lambda: jp.run_timing_variant(jp._halfq8_kernel, xj, wm, s16, M, bn, bk)}
    return np.asarray(f[kind](), np.float32)


def _port_call(kind, x, q, s, bn, bk):
    xt, st, qt = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(s), torch.from_numpy(q)
    s16 = st.to(torch.bfloat16)
    f = {"split_i32": lambda: T.run_split(xt, t_pack_int4(qt), st, M, bn, bk, "i32"),
         "split_i8": lambda: T.run_split(xt, t_pack_int4(qt), st, M, bn, bk, "i8"),
         "i4native": lambda: T.run_i4(xt, T.pack_int4_native(qt), st, M, bn, bk),
         "bitcast": lambda: T.run_bitcast(xt, T.pack_int4_biased(qt), st, M, bn, bk),
         "andmask": lambda: T.run_andmask(xt, T.pack_int4_mixed(qt), st, M, bn, bk),
         "andmask_bf16s": lambda: T.run_andmask_bf16s(xt, T.pack_int4_mixed(qt), s16, M, bn, bk),
         "stream": lambda: T.run_stream(xt, t_pack_int4(qt), st, M, bn, bk),
         "intdot": lambda: T.run_intdot(xt, T.pack_int4_mixed(qt), st, M, bn, bk),
         "w4a8": lambda: T.run_w4a8(xt, T.pack_int4_mixed(qt), st, M, bn, bk),
         "noscale": lambda: T.run_timing_variant("noscale", xt, T.pack_int4_mixed(qt), s16, M,
                                                 bn, bk),
         "halfq8": lambda: T.run_timing_variant("halfq8", xt, T.pack_int4_mixed(qt), s16, M,
                                                bn, bk)}
    y = f[kind]()
    assert y.dtype == torch.float32 and y.shape == (M, q.shape[1]) and y.device.type == "cpu"
    return y.numpy()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "K{}_N{}_bn{}_bk{}".format(*s))
@pytest.mark.parametrize("kind", list(T.KINDS))
def test_kernel_functions_match_jax(jp, kind, shape):
    K, N, bn, bk = shape
    x, q, s = _inputs(K, N)
    want = _jax_call(jp, kind, x, q, s, bn, bk)
    got = _port_call(kind, x, q, s, bn, bk)
    err = np.abs(got - want).max()
    rel = 1e-4 if kind == "bitcast" else 1e-5
    assert cosine_similarity(got, want) >= 0.99999
    assert err <= rel * np.abs(want).max(), (kind, err, np.abs(want).max())


def _jax_main_cosines(jp, K, N, bn, bk):
    """The JAX main's variants at one shape, their cosines against the golden
    (inputs drawn as main draws them)."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((M, K)), jnp.bfloat16)
    q = rng.integers(-8, 8, (K, N)).astype(np.int8)
    s = jnp.asarray(rng.random((K // 32, N)) * 0.01 + 0.005, jnp.float32)
    wf = q.astype(np.float32).reshape(K // 32, 32, N) * np.asarray(s)[:, None, :]
    gold = np.asarray(x, np.float32) @ wf.reshape(K, N)
    wp, wm, wb = jp.pack_int4(jnp.asarray(q)), jp.pack_int4_mixed(q), jnp.asarray(_biased_jax(q))
    w4 = jax.jit(lambda a: a.astype(jnp.int4))(jnp.asarray(q))
    s16 = s.astype(jnp.bfloat16)
    v = {tprobe.CUR: lambda: jax_qmm(x, wp, s, scale_mode="block", packed_int4=True,
                                     interpret=True),
         "split_i32": lambda: jp.run_split(x, wp, s, M, bn, bk, "i32"),
         "split_i8": lambda: jp.run_split(x, wp, s, M, bn, bk, "i8"),
         "i4native": lambda: jp.run_i4(x, w4, s, M, bn, bk),
         "bitcast": lambda: jp.run_bitcast(x, wb, s, M, bn, bk),
         "andmask": lambda: jp.run_andmask(x, wm, s, M, bn, bk),
         "andmask_bf16s": lambda: jp.run_andmask_bf16s(x, wm, s16, M, bn, bk),
         "stream": lambda: jp.run_stream(x, wp, s, M, bn, bk),
         "intdot": lambda: jp.run_intdot(x, wm, s, M, bn, bk),
         "w4a8": lambda: jp.run_w4a8(x, wm, s, M, bn, bk),
         "w4a8_n2048": lambda: jp.run_w4a8(x, wm, s, M, 2048, 512),
         "w4a8_n1024": lambda: jp.run_w4a8(x, wm, s, M, 1024, 512),
         "noscale(timing)": lambda: jp.run_timing_variant(jp._noscale_kernel, x, wm, s16, M,
                                                          bn, bk),
         "halfq8(timing)": lambda: jp.run_timing_variant(jp._halfq8_kernel, x, wm, s16, M,
                                                         bn, bk)}
    for bn2, bk2 in [(N, 256), (N // 2, 256), (N, 512), (N // 4, 256)]:
        if bn2 > N or K % bk2 or N % bn2:
            continue
        v[f"andmask_bn{bn2}_bk{bk2}"] = functools.partial(jp.run_andmask, x, wm, s, M, bn2, bk2)
    return {name: cosine_similarity(np.asarray(f(), np.float32), gold) for name, f in v.items()}


def test_probe_cosines_match_jax_main(jp):
    """The slice: main's variants through the port's probe on the CPU, at
    K = 512, N = 2048 (so that w4a8's bn 2048 covers N in the JAX grid)."""
    shape = (512, 2048, 2048, 256)
    lines = []
    recs = tprobe.probe(device="cpu", shapes=[shape], log=lines.append)
    want = _jax_main_cosines(jp, *shape)
    got = {r["name"]: r["cos"] for r in recs}
    assert list(got) == list(want)
    for name in want:
        assert abs(got[name] - want[name]) <= 1e-4, (name, got[name], want[name])
    assert lines[0].startswith("# device: cpu") and len(lines) == 2 + len(want)
    assert want["bitcast"] < 0.999 and got["stream"] < 0.5       # inexact / timing only


def test_launch_geometry():
    assert [T.launch_geometry(bn, 512) for bn in (6144, 5504, 4096, 2048, 1024)] == \
        [(128, 512), (128, 512), (128, 512), (64, 512), (32, 512)]
    assert T.launch_geometry(22016, 256) == (256, 256)
    assert T.launch_geometry(128, 256) == (32, 256)


def test_kernel_bytes():
    K, N = 4096, 22016
    base = K * N // 2 + M * N * 4
    assert T.kernel_bytes("andmask", M, N, K) == base + K // 32 * N * 4 + M * K * 2
    assert T.kernel_bytes("andmask_bf16s", M, N, K) == base + K // 32 * N * 2 + M * K * 2
    assert T.kernel_bytes("stream", M, N, K) == base + M * N * 4
    assert T.kernel_bytes("w4a8", M, N, K) == base + K // 32 * N * 4 + M * K
    assert T.kernel_bytes("intdot", M, N, K) == base + K // 32 * N * 4 + M * K + M * K // 8


def test_argument_checks():
    x = torch.zeros((8, 512), dtype=torch.bfloat16)
    w = torch.zeros((256, 64), dtype=torch.int8)
    s = torch.zeros((16, 64))
    with pytest.raises(ValueError, match="bk"):
        T.run_andmask(x, w, s, 8, 128, 48)
    with pytest.raises(ValueError, match="bk"):
        T.run_andmask(x, w, s, 8, 128, 1024)
    with pytest.raises(ValueError, match="shifts"):
        T.run_split(x, w, s, 8, 128, 256, "i16")
    with pytest.raises(ValueError, match="run_timing_variant"):
        T.run_timing_variant("fast", x, w, s, 8, 128, 256)


def test_timing_needs_a_card():
    from csinn2_tpu_torch.examples import int4_tile_tune
    with pytest.raises(RuntimeError):
        int4_tile_tune.tune(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tprobe.probe()
