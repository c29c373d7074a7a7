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
    1e-4;
  * the tensor-core kernel of the eight plane kinds, modelled in numpy: its
    widening of ldmatrix.trans register words and its A-fragment → (k,
    column) map (i4native's permuted columns included) give the JAX body's
    bf16 plane values bit for bit; every kind's geometry is the decode
    GEMM's split plan, and kernel_bytes counts the tiles the timing-only
    kinds move;
  * the int8 kernel of intdot and w4a8, modelled in numpy: its regrouping
    ldmatrix.trans words, masked low and sign-extended high nibbles and its
    x tile give, through the m16n8k32 products, the JAX body's
    p_lo + (p_hi >> 4) for every (block, column, token), every byte value in
    every nibble position;
  * the stream kernel's sampled byte rows, stage by stage of the ring, are
    kernel_ref's row set at bk 64-512 and splits that end inside a tile."""

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
from csinn2_tpu_torch.kernels import qmatmul as tq
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


@pytest.mark.parametrize("M", [1, 8, 16])
def test_plane_geometry_is_the_decode_plan(M):
    """Every kind takes the decode GEMM's 256-column strip and split plan (on
    the H100's 132 SMs: wqkv 5 splits, w13 3, w2 15, wo 16) whatever the TPU
    tile; a ksplit sets the split length."""
    want = {(4096, 12288): 896, (4096, 22016): 1408, (11008, 4096): 768, (4096, 4096): 256}
    for (K, N), rows in want.items():
        plan = tq.gemm_plan(M, N, K, False, 132)
        assert T.plane_geometry(M, N, K, 132) == (256, rows) \
            == (plan["strip"], plan["blocks_per_split"] * 32)
        assert T.plane_geometry(M, N, K, 132, ksplit=96) == (256, 96)
    assert set(T.PLANE_KINDS) | {"stream", "intdot", "w4a8"} == set(T.KINDS)


@pytest.mark.parametrize("kind", ["andmask", "stream", "intdot", "w4a8"])
def test_ksplit_override_checks(kind):
    """Every kind takes a split length: a positive multiple of 32."""
    x = torch.zeros((8, 512), dtype=torch.bfloat16)
    w = torch.zeros((256, 64), dtype=torch.int8)
    s = torch.zeros((16, 64))
    call = T.prepare(kind, x, w, s, 8, 128, 256, ksplit=96)
    assert call.ksplit == 96 and T.prepare(kind, x, w, s, 8, 128, 256).ksplit is None
    for bad in (0, 48, -32):
        with pytest.raises(ValueError, match="ksplit"):
            T.prepare(kind, x, w, s, 8, 128, 256, ksplit=bad)


def test_kernel_bytes():
    K, N = 4096, 22016
    base = K * N // 2 + M * N * 4
    assert T.kernel_bytes("andmask", M, N, K) == base + K // 32 * N * 4 + M * K * 2
    assert T.kernel_bytes("andmask_bf16s", M, N, K) == base + K // 32 * N * 2 + M * K * 2
    assert T.kernel_bytes("stream", M, N, K) == base + M * N * 4
    assert T.kernel_bytes("w4a8", M, N, K) == base + K // 32 * N * 4 + M * K
    assert T.kernel_bytes("intdot", M, N, K) == base + K // 32 * N * 4 + M * K + M * K // 8
    # the timing-only kinds move the tiles they do not read: the bf16 scales
    # (noscale) and x_hi (halfq8)
    for kind in ("noscale", "halfq8"):
        assert T.kernel_bytes(kind, M, N, K) == base + K // 32 * N * 2 + M * K * 2
    for kind in ("split_i32", "split_i8", "bitcast", "i4native"):
        assert T.kernel_bytes(kind, M, N, K) == base + K // 32 * N * 4 + M * K * 2


# -- the tensor-core kernel K1 (csrc/int4_probe.cu k_planes), modelled in numpy ------
#
# A CTA's strip is 256 columns, warp w owns columns 32w .. 32w + 31 as two
# m16n8k16 tiles.  ldmatrix.x4.trans hands lane (g, tig) of matrix j a word
# of the bytes (r, c), (r, c+1), (r+1, c), (r+1, c+1) of a 16-byte chunk,
# r = 2·tig, c = 2·g.  The model builds those words from a block's bytes,
# widens them as each kind's CUDA code does (integer ops on the words, I2F
# as an exact int → bf16, HMUL2 as the product rounded to bf16), places each
# A-fragment pair at the (k, column) the kernel's finish stores it at, and
# holds the plane matrix bit for bit to the JAX body's.

def _bf16(v):
    """Round to bf16 (nearest even), as float64."""
    return torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16).double().numpy()


def _trans_word(tile, r0, c0, g, tig):
    """The ldmatrix.trans word of lane (g, tig) for the 8 × 16-byte matrix at
    tile rows r0 .. r0+7, bytes c0 .. c0+15 (little-endian byte order)."""
    r, c = r0 + 2 * tig, c0 + 2 * g
    b = [tile[r, c], tile[r, c + 1], tile[r + 1, c], tile[r + 1, c + 1]]
    return sum(int(v) << (8 * i) for i, v in enumerate(np.asarray(b, np.uint8)))


def _sbyte(word, i):
    return int(np.int8(np.uint8((word >> (8 * i)) & 0xFF)))


def _sra(word, left):
    """(int32(word) << left) >> 28, arithmetic."""
    v = np.int64((word << left) & 0xFFFFFFFF)
    return int(((v ^ 0x80000000) - 0x80000000) >> 28)


def _widen_plane(ex, r, ks):
    """csrc/int4_probe.cu widen_plane: (e, o) = the unscaled pairs (k, k+1) of
    columns c and c+1, as float pairs (exact values of the bf16 results)."""
    if ex == "i32":
        return ((_sra(r, 28 - 4 * ks), _sra(r, 12 - 4 * ks)),
                (_sra(r, 20 - 4 * ks), _sra(r, 4 - 4 * ks)))
    if ex == "i8":
        t = ((r >> (4 * ks)) & 0x0F0F0F0F) ^ 0x08080808
        v = sum((((t >> (8 * i)) & 0xFF) - 8) % 256 << (8 * i) for i in range(4))   # __vsub4
        return (_sbyte(v, 0), _sbyte(v, 2)), (_sbyte(v, 1), _sbyte(v, 3))
    if ex == "lop3":
        def pair(bits):
            return tuple(np.array([bits & 0xFFFF, bits >> 16], np.uint16)
                         .astype(np.uint32).__lshift__(16).view(np.float32).astype(float))
        return (pair(((r >> (4 * ks)) & 0x000F000F) | 0x43004300),
                pair(((r >> (8 + 4 * ks)) & 0x000F000F) | 0x43004300))
    if ex == "and":
        v = r & (0xF0F0F0F0 if ks else 0x0F0F0F0F)
        return (_sbyte(v, 0), _sbyte(v, 2)), (_sbyte(v, 1), _sbyte(v, 3))
    assert ex == "byte"
    return (_sbyte(r, 0), _sbyte(r, 2)), (_sbyte(r, 1), _sbyte(r, 3))


def _widen_native(r, t):
    """csrc/int4_probe.cu widen_native: columns 4g + 2t (e) and + 1 (o)."""
    return ((_sra(r, 28 - 8 * t), _sra(r, 12 - 8 * t)),
            (_sra(r, 24 - 8 * t), _sra(r, 8 - 8 * t)))


# kind → (widening, scale: "f32" rounded to bf16, "bf16" as it is, or None)
K1_KINDS = {"split_i32": ("i32", "f32"), "split_i8": ("i8", "f32"), "bitcast": ("lop3", "f32"),
            "andmask": ("and", "f32"), "andmask_bf16s": ("and", "bf16"),
            "noscale": ("and", None), "halfq8": ("byte", "bf16"), "i4native": ("i32", "f32")}


def _model_block(kind, tile, s_cols):
    """The plane values [k, n] one block's stage gives the mma A fragments,
    placed at the k and the column the kernel assigns them (each once).
    tile: the block's bytes — [16, 256] of a [K/2, N] pack, or [32, 128] of
    the [K, N/2] carrier; s_cols: the block's scales [256] (f32 or bf16)."""
    ex, sc = K1_KINDS[kind]
    native = kind == "i4native"
    planes = 1 if kind == "halfq8" else 2
    out = np.full((32 if planes == 2 or native else 16, 256), np.nan)
    scale = None if sc is None else _bf16(s_cols.float().numpy() if sc == "f32"
                                          else s_cols.float().numpy())
    for w in range(8):
        cb = 32 * w
        for lane in range(32):
            g, tig = lane // 4, lane % 4
            for ks in range(planes):
                for t in range(2):
                    col = cb + 4 * g + 2 * t if native else cb + 16 * t + 2 * g
                    for h in range(2):                 # k 0-7 and 8-15 of the step
                        if native:                      # matrix 2ks + h: k rows 16ks + 8h ..
                            r = _trans_word(tile, 16 * ks + 8 * h, 16 * w, g, tig)
                            e, o = _widen_native(r, t)
                        else:                           # matrix 2t + h: byte rows 8h .., chunk
                            r = _trans_word(tile, 8 * h, cb + 16 * t, g, tig)
                            e, o = _widen_plane(ex, r, ks)
                        k = 16 * ks + 8 * h + 2 * tig
                        for n, pair in ((col, e), (col + 1, o)):
                            v = np.asarray(pair, float)
                            if scale is not None:
                                v = _bf16(v * scale[n])
                            assert np.isnan(out[k:k + 2, n]).all()
                            out[k:k + 2, n] = v
    assert not np.isnan(out).any()
    return out


def _jax_block_planes(kind, p, q, s):
    """The JAX body's dequantized plane values [k, n] of one block (k < 16:
    the low plane of byte row k, else the high plane of byte row k - 16;
    halfq8: the one plane of the 16 byte rows; i4native: the 32 rows of
    jnp.int4), as examples/int4_dequant_probe.py computes them."""
    pj, sj = jnp.asarray(p), jnp.asarray(s)
    s16 = sj.astype(jnp.bfloat16)
    if kind == "split_i32":                                          # :103-108
        p32 = pj.astype(jnp.int32)
        lo, hi = ((p32 << 28) >> 28).astype(jnp.bfloat16), (p32 >> 4).astype(jnp.bfloat16)
    elif kind == "split_i8":                                         # :110-111
        lo, hi = ((pj << 4) >> 4).astype(jnp.bfloat16), (pj >> 4).astype(jnp.bfloat16)
    elif kind == "bitcast":                                          # :199-203
        p16 = pj.astype(jnp.int16)
        lo = jax.lax.bitcast_convert_type((p16 & 0xF) | 0x4300, jnp.bfloat16)
        hi = jax.lax.bitcast_convert_type(((p16 >> 4) & 0xF) | 0x4300, jnp.bfloat16)
    elif kind in ("andmask", "andmask_bf16s", "noscale"):            # :247-251, :450-451
        lo = (pj & jnp.int8(0x0F)).astype(jnp.bfloat16)
        hi = (pj & jnp.int8(-16)).astype(jnp.bfloat16)
    elif kind == "halfq8":                                           # :469-471
        return np.asarray(pj.astype(jnp.bfloat16) * s16, np.float64)
    else:                                                            # i4native, :149-151
        w4 = jax.jit(lambda a: a.astype(jnp.int4))(jnp.asarray(q))
        return np.asarray(w4.astype(jnp.bfloat16) * s16, np.float64)
    if kind != "noscale":
        lo, hi = lo * s16, hi * s16
    return np.concatenate([np.asarray(lo, np.float64), np.asarray(hi, np.float64)])


@pytest.mark.parametrize("kind", list(K1_KINDS))
def test_k1_widening_and_fragment_map_match_jax_planes(kind):
    """K1's widening of ldmatrix.trans words and its A-fragment → (k, column)
    map, including i4native's permuted column order, give the JAX body's
    bf16 plane values bit for bit on one block of a 256-column strip (every
    byte value in every nibble position, scales of every magnitude)."""
    rng = np.random.default_rng(3)
    q = rng.integers(-8, 8, (32, 256)).astype(np.int8)
    q[:16, :16] = np.arange(-8, 8)[None, :]
    q[16:, 16:32] = np.arange(-8, 8)[:, None]
    s = (rng.random((1, 256)) * 0.02 + 0.001).astype(np.float32)
    s[0, :4] = (3e-3, 1.0, 7.5, 1e-5)
    qt, st = torch.from_numpy(q), torch.from_numpy(s)
    scale = st.to(torch.bfloat16) if K1_KINDS[kind][1] == "bf16" else st
    if kind == "i4native":
        pack = T.pack_int4_native(qt)                    # [32, 128]
    else:
        pack = {"split_i32": t_pack_int4, "split_i8": t_pack_int4,
                "bitcast": T.pack_int4_biased}.get(kind, T.pack_int4_mixed)(qt)   # [16, 256]
    got = _model_block(kind, pack.numpy(), scale[0])
    want = _jax_block_planes(kind, pack.numpy(), q, s[:1].repeat(16 if kind != "i4native"
                                                                 else 32, 0))
    np.testing.assert_array_equal(got, want)


# -- k_int8 (csrc/int4_probe.cu: intdot and w4a8), modelled in numpy ------------------
#
# A stage holds a block's 16 byte rows of the strip's 256 columns; warp w owns
# columns 32w .. 32w + 31 as two m16 tiles.  The regrouping ldmatrix.trans x4:
# lane 8j + i addresses byte row regroup_row = 4(i >> 1) + (i & 1) + 2(j & 1)
# of chunk 2w + (j >> 1), and lane (g, tig) receives bytes 2g, 2g + 1 of the
# rows lanes 8j + 2tig and 8j + 2tig + 1 address.  quad_even / quad_odd (PRMT
# 0x6420 / 0x7531) of registers 2t, 2t + 1 are byte rows 4tig .. 4tig + 3 of
# columns 32w + 16t + 2g and + 1; the A fragments are their low nibbles as
# they are and their high nibbles sign-extended (nib_signed), at k 4tig .. and
# 16 + 4tig ..  The x tile row of a token is block b's x_lo, then x_hi (intdot
# copies the 16-byte chunks from its halves, w4a8's xq lies so), and plain
# ldmatrix gives lane (g, tig) token g's bytes 4tig .. 4tig + 3 of a chunk.

def _prmt(r0, r1, sel):
    """__byte_perm(r0, r1, sel)."""
    b = [(r0 >> 8 * k) & 0xFF for k in range(4)] + [(r1 >> 8 * k) & 0xFF for k in range(4)]
    return sum(b[(sel >> 4 * k) & 0xF] << 8 * k for k in range(4))


def _nib_signed(v):
    """csrc/int8_frag.cuh nib_signed: ((v & 0x0F0F0F0F) ^ 0x08080808) + 0x78787878,
    then ^ 0x80808080 (four nibbles sign-extended to int8)."""
    return ((((v & 0x0F0F0F0F) ^ 0x08080808) + 0x78787878) & 0xFFFFFFFF) ^ 0x80808080


def _s8(word):
    return [int(np.int8(np.uint8((word >> 8 * k) & 0xFF))) for k in range(4)]


def _int8_a_fragments(tile):
    """A[column, k] of one block as k_int8's fragments hold it (k < 16: the
    low-nibble operand of byte row k, else the high-nibble one of row k - 16),
    each element placed once.  tile: the block's bytes [16, 256]."""
    u = tile.view(np.uint8).astype(np.int64)
    A = np.full((256, 32), 99, np.int64)
    regroup = lambda lane: 4 * ((lane & 7) >> 1) + (lane & 1) + 2 * ((lane >> 3) & 1)
    for w in range(8):
        for lane in range(32):
            g, tig = lane // 4, lane % 4
            regs = []
            for j in range(4):
                r0, r1 = regroup(8 * j + 2 * tig), regroup(8 * j + 2 * tig + 1)
                c = 16 * (2 * w + (j >> 1)) + 2 * g
                regs.append(u[r0, c] | u[r0, c + 1] << 8 | u[r1, c] << 16 | u[r1, c + 1] << 24)
            for t in range(2):
                qe, qo = _prmt(regs[2 * t], regs[2 * t + 1], 0x6420), \
                    _prmt(regs[2 * t], regs[2 * t + 1], 0x7531)
                col = 32 * w + 16 * t + 2 * g
                frags = ((qe & 0x0F0F0F0F, col, 4 * tig), (qo & 0x0F0F0F0F, col + 1, 4 * tig),
                         (_nib_signed(qe >> 4), col, 16 + 4 * tig),
                         (_nib_signed(qo >> 4), col + 1, 16 + 4 * tig))
                for word, n, k in frags:
                    assert (A[n, k:k + 4] == 99).all()
                    A[n, k:k + 4] = _s8(word)
    assert (A != 99).all()
    return A


def _int8_b_fragments(xtile, b):
    """B[k, token] of block b from the x tile [16, 128] by plain ldmatrix:
    lane (g, tig) of matrix j takes token 8(j >> 1) + g's bytes 4tig .. 4tig + 3
    of chunk 2b + (j & 1)."""
    B = np.zeros((32, 16), np.int64)
    for j in range(4):
        for g in range(8):
            for tig in range(4):
                k = 16 * (j & 1) + 4 * tig
                B[k:k + 4, 8 * (j >> 1) + g] = xtile[8 * (j >> 1) + g, 32 * b + k:32 * b + k + 4]
    return B


@pytest.mark.parametrize("kind", ["intdot", "w4a8"])
def test_k_int8_fragments_match_jax_partials(kind):
    """k_int8's A and B fragments of one 4-block stage, through the m16n8k32
    products, give the JAX body's exact p_lo + (p_hi >> 4) per (block,
    column, token) (examples/int4_dequant_probe.py :338-352 for intdot, the
    same planes at :514-520 for w4a8): every byte value in every nibble
    position (byte row 0 of each block runs through all 256 bytes over the
    strip), activations at ±127."""
    rng = np.random.default_rng(11)
    q = rng.integers(-8, 8, (128, 256)).astype(np.int8)          # 4 blocks of a strip
    for b in range(4):
        q[32 * b, :] = np.arange(256) % 16 - 8                    # low nibble of byte row 0
        q[32 * b + 16, :] = np.arange(256) // 16 - 8              # its high nibble
    xq = rng.integers(-127, 128, (16, 128)).astype(np.int8)
    xq[:, :2] = (-127, 127)
    pack = T.pack_int4_mixed(torch.from_numpy(q)).numpy()         # [64, 256]
    x3 = xq.reshape(16, 4, 32)
    x_lo = x3[:, :, :16].reshape(16, 64)
    x_hi = x3[:, :, 16:].reshape(16, 64)
    if kind == "w4a8":                                            # xq [M, K] as it lies
        xtile = xq.astype(np.int64)
    else:                                                         # chunk c: half c % 2 of block c // 2
        xtile = np.zeros((16, 128), np.int64)
        for c in range(8):
            src = x_hi if c % 2 else x_lo
            xtile[:, 16 * c:16 * c + 16] = src[:, 8 * (c - c % 2):8 * (c - c % 2) + 16]
    for b in range(4):
        p = pack[16 * b:16 * b + 16]
        z = _int8_a_fragments(p) @ _int8_b_fragments(xtile, b)  # [column, token]
        pj = jnp.asarray(p)
        l8, h8 = pj & jnp.int8(0x0F), pj & jnp.int8(-16)
        xl, xh = jnp.asarray(x_lo[:, 16 * b:16 * b + 16]), jnp.asarray(x_hi[:, 16 * b:16 * b + 16])
        pz = jnp.dot(xl, l8, preferred_element_type=jnp.int32) + \
            (jnp.dot(xh, h8, preferred_element_type=jnp.int32) >> 4)   # [token, column]
        np.testing.assert_array_equal(z.T, np.asarray(pz))
        # and the operands themselves: w_lo + 8 and w_hi
        A = _int8_a_fragments(p)
        np.testing.assert_array_equal(A[:, :16].T, q[32 * b:32 * b + 16].astype(np.int64) + 8)
        np.testing.assert_array_equal(A[:, 16:].T, q[32 * b + 16:32 * b + 32])


# -- k_stream (csrc/int4_probe.cu), modelled: its sampled rows stage by stage --------

def _stream_rows(K, bk, ksplit):
    """The byte rows k_stream sums, split by split and stage by stage: a stage
    is 64 byte rows (4 blocks) from the split's first; rows r = (every - row0 %
    every) % every, + every, ... of a stage whose row 0 is byte row row0,
    while row0 + r < lim; rows past the split's end are zero-filled there
    (the next split sums them)."""
    every, lim = bk // 16, K // bk * (bk // 2)
    nb, bps = K // 32, ksplit // 32
    rows = []
    for kb_begin in range(0, nb, bps):
        kb_end = min(nb, kb_begin + bps)
        row0 = kb_begin * 16
        for _ in range(-(-(kb_end - kb_begin) // 4)):
            r = (every - row0 % every) % every
            while r < 64 and row0 + r < lim:
                if row0 + r < kb_end * 16:
                    rows.append(row0 + r)
                r += every
            row0 += 64
    return rows


@pytest.mark.parametrize("ksplit", [96, 160, 1408])
@pytest.mark.parametrize("bk", [64, 128, 256, 512])
def test_stream_stage_rows_are_kernel_refs(bk, ksplit):
    """k_stream's sampled rows are kernel_ref's: 8 rows bk/16 apart in each
    whole bk-row tile, each once, at the 7B w2 depth (K = 11008: K % 512 !=
    0, so the last partial tile is not sampled) with splits of 3, 5 and 44
    blocks (3 and 5 end inside tiles and stages)."""
    K = 11008
    rows = _stream_rows(K, bk, ksplit)
    want = [t * (bk // 2) + i * (bk // 16) for t in range(K // bk) for i in range(8)]
    assert len(rows) == len(set(rows)) and sorted(rows) == want
    # and the value: the sums of those rows, as kernel_ref forms them
    w = torch.from_numpy(np.random.default_rng(bk).integers(-128, 128, (K // 2, 24))
                         .astype(np.int8))
    xw = torch.zeros((2, 24))
    got = w[rows].to(torch.int64).sum(0).float()
    assert torch.equal(xw + got, T.kernel_ref("stream", {"w": w, "xw": xw}, 2, 24, K, 24, bk))


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
