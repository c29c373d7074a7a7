"""Attention of the PyTorch port against the JAX package: the plain versions
of decode_attention, prefill_attention and flash_attention (bshd and bhsd)
against the Pallas kernels in interpret mode (GQA, int8 KV with kv_scale, per-row
q_offset / kv_len, a kv_len = 0 lane), and the port's attention_block
against the JAX package's XLA fallback (model.py:669-693).  K/V reach the
port as permuted views of a [b, S, hk, d] cache buffer, as on the main path.

Tolerance: verify(tol=2e-2, min_cosine=0.9999), as tests/test_attention.py
(the Pallas kernels run bf16 dots, the port's plain versions f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csinn2_tpu.kernels import flash_attention as jfa
from csinn2_tpu.llm import model as jm
from csinn2_tpu.llm.config import LlamaConfig as JConfig
from csinn2_tpu.utils.verify import verify
from csinn2_tpu_torch.kernels import flash_attention as tfa
from csinn2_tpu_torch.llm import model as tm
from csinn2_tpu_torch.llm.config import LlamaConfig as TConfig
from csinn2_tpu_torch.llm.params import params_from_numpy

torch.set_num_threads(2)

KV_SCALE = 0.05


def _q(rng, shape):
    """bf16 query as (jax array, torch tensor) holding the same values."""
    qj = jnp.asarray(rng.standard_normal(shape).astype(np.float32), jnp.bfloat16)
    return qj, torch.from_numpy(np.array(qj, np.float32)).to(torch.bfloat16)


def _kv(rng, b, hk, S, d, int8):
    """K/V as [b, hk, S, d] numpy (for JAX) and as the permuted view of a
    [b, S, hk, d] buffer (for the port)."""
    if int8:
        a = rng.integers(-127, 128, (2, b, S, hk, d)).astype(np.int8)
    else:
        a = np.array(jnp.asarray(rng.standard_normal((2, b, S, hk, d)), jnp.bfloat16)
                     .astype(jnp.float32))
    jax_kv = [np.ascontiguousarray(x.transpose(0, 2, 1, 3)) for x in a]
    t = torch.from_numpy(a)
    if not int8:
        t = t.to(torch.bfloat16)
        jax_kv = [jnp.asarray(x, jnp.bfloat16) for x in jax_kv]
    return jax_kv, [t[0].permute(0, 2, 1, 3), t[1].permute(0, 2, 1, 3)]


def _check(got, want):
    r = verify(np.asarray(got.float().numpy(), np.float32),
               np.asarray(want, np.float32), tol=2e-2, min_cosine=0.9999)
    assert r.passed and r.cosine_sim > 0.9999, r


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("hq,hk", [(8, 4), (4, 4)])
def test_decode_attention_matches_jax(rng, int8, hq, hk):
    b, d, S = 3, 32, 256
    qj, qt = _q(rng, (b, hq, 1, d))
    (kj, vj), (kt, vt) = _kv(rng, b, hk, S, d, int8)
    kv_len = np.array([200, 0, 17], np.int32)          # lane 1: inactive slot
    pos = np.maximum(kv_len - 1, 0)
    scale = KV_SCALE if int8 else None
    want = np.asarray(jfa.decode_attention(qj, kj, vj, q_offset=pos, kv_len=kv_len,
                                           kv_scale=scale, hk_blk=2, interpret=True),
                      np.float32)
    got = tfa.decode_attention(qt, kt, vt, q_offset=torch.from_numpy(pos),
                               kv_len=torch.from_numpy(kv_len), kv_scale=scale)
    assert got.shape == (b, hq, 1, d) and got.dtype == torch.bfloat16
    _check(got, want)
    assert float(got[1].abs().max()) == 0.0 and np.abs(want[1]).max() == 0.0


def test_decode_attention_default_kv_len(rng):
    """kv_len defaults to q_offset + 1 (decode semantics)."""
    qj, qt = _q(rng, (2, 4, 1, 16))
    (kj, vj), (kt, vt) = _kv(rng, 2, 2, 128, 16, True)
    pos = np.array([5, 90], np.int32)
    want = np.asarray(jfa.decode_attention(qj, kj, vj, q_offset=pos, kv_scale=KV_SCALE,
                                           interpret=True), np.float32)
    got = tfa.decode_attention(qt, kt, vt, q_offset=torch.from_numpy(pos),
                               kv_scale=KV_SCALE)
    _check(got, want)


@pytest.mark.parametrize("int8", [True, False])
def test_prefill_attention_matches_jax(rng, int8):
    b, sq, hq, hk, d, S = 2, 40, 8, 4, 32, 128
    qj, qt = _q(rng, (b, sq, hq, d))
    (kj, vj), (kt, vt) = _kv(rng, b, hk, S, d, int8)
    off = np.array([0, 9], np.int32)
    kvl = off + sq
    scale = KV_SCALE if int8 else None
    want = np.asarray(jfa.prefill_attention(qj, kj, vj, causal=True, q_offset=off,
                                            kv_len=kvl, kv_scale=scale, interpret=True),
                      np.float32)
    got = tfa.prefill_attention(qt, kt, vt, causal=True, q_offset=torch.from_numpy(off),
                                kv_len=torch.from_numpy(kvl), kv_scale=scale)
    assert got.shape == (b, sq, hq, d)
    _check(got, want)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bshd_matches_jax(rng, causal):
    b, sq, hq, hk, d, S = 2, 24, 8, 2, 32, 128
    qj, qt = _q(rng, (b, sq, hq, d))
    (kj, vj), (kt, vt) = _kv(rng, b, hk, S, d, True)
    off = np.array([3, 10], np.int32)                  # q_offset > 0
    kvl = off + sq
    want = np.asarray(jfa.flash_attention(qj, kj, vj, causal=causal, q_offset=off,
                                          kv_len=kvl, kv_scale=KV_SCALE, blk_q=8,
                                          blk_k=128, qo_layout="bshd", interpret=True),
                      np.float32)
    got = tfa.flash_attention(qt, kt, vt, causal=causal, q_offset=torch.from_numpy(off),
                              kv_len=torch.from_numpy(kvl), kv_scale=KV_SCALE,
                              qo_layout="bshd")
    _check(got, want)


def test_prefill_and_flash_agree_in_jax_and_port(rng):
    """The two prefill entry points compute one function: the JAX kernels
    agree with each other, and the port's two plain paths agree exactly."""
    b, sq, hq, hk, d, S = 1, 32, 4, 2, 32, 256
    qj, qt = _q(rng, (b, sq, hq, d))
    (kj, vj), (kt, vt) = _kv(rng, b, hk, S, d, True)
    kw = dict(causal=True, q_offset=0, kv_len=sq, kv_scale=KV_SCALE)
    jp = np.asarray(jfa.prefill_attention(qj, kj, vj, interpret=True, **kw), np.float32)
    jf = np.asarray(jfa.flash_attention(qj, kj, vj, qo_layout="bshd", interpret=True, **kw),
                    np.float32)
    r = verify(jp, jf, tol=2e-2, min_cosine=0.9999)
    assert r.passed, r
    tp = tfa.prefill_attention(qt, kt, vt, **kw)
    tf = tfa.flash_attention(qt, kt, vt, qo_layout="bshd", **kw)
    assert torch.equal(tp, tf)


def test_flash_attention_bhsd_not_ported(rng):
    """bhsd, the JAX default layout, which the first slices left unported,
    now runs by default: small MHA case against the JAX kernel (interpret)."""
    qj, qt = _q(rng, (1, 2, 4, 16))
    (kj, vj), (kt, vt) = _kv(rng, 1, 2, 64, 16, True)
    want = np.asarray(jfa.flash_attention(qj, kj, vj, kv_scale=KV_SCALE, blk_q=8, blk_k=128,
                                          interpret=True), np.float32)
    got = tfa.flash_attention(qt, kt, vt, kv_scale=KV_SCALE)
    assert got.shape == (1, 2, 4, 16) and got.dtype == torch.bfloat16
    _check(got, want)


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bhsd_matches_jax(rng, int8, causal):
    """bhsd q/out [b, hq, sq, d], GQA, per-row q_offset / kv_len."""
    b, sq, hq, hk, d, S = 3, 20, 8, 2, 32, 128
    qj, qt = _q(rng, (b, hq, sq, d))
    (kj, vj), (kt, vt) = _kv(rng, b, hk, S, d, int8)
    off = np.array([0, 7, 100], np.int32)
    kvl = np.minimum(off + sq, S).astype(np.int32)
    scale = KV_SCALE if int8 else None
    want = np.asarray(jfa.flash_attention(qj, kj, vj, causal=causal, q_offset=off,
                                          kv_len=kvl, kv_scale=scale, blk_q=8, blk_k=128,
                                          interpret=True), np.float32)
    got = tfa.flash_attention(qt, kt, vt, causal=causal, q_offset=torch.from_numpy(off),
                              kv_len=torch.from_numpy(kvl), kv_scale=scale)
    assert got.shape == (b, hq, sq, d)
    _check(got, want)
    # the decode form: one query per row at its position, kv_len = pos + 1
    pos = np.array([5, 60, 127], np.int32)
    qj1, qt1 = _q(rng, (b, hq, 1, d))
    want1 = np.asarray(jfa.flash_attention(qj1, kj, vj, causal=True, q_offset=pos,
                                           kv_len=pos + 1, kv_scale=scale, interpret=True),
                       np.float32)
    got1 = tfa.flash_attention(qt1, kt, vt, causal=True, q_offset=torch.from_numpy(pos),
                               kv_len=torch.from_numpy(pos + 1), kv_scale=scale)
    _check(got1, want1)


def test_flash_attention_layouts_agree(rng):
    """bhsd and bshd compute one function: the port's plain paths agree exactly."""
    qj, qt = _q(rng, (2, 4, 24, 32))
    _, (kt, vt) = _kv(rng, 2, 2, 64, 32, True)
    kw = dict(causal=True, q_offset=torch.tensor([0, 9]), kv_len=torch.tensor([24, 33]),
              kv_scale=KV_SCALE)
    a = tfa.flash_attention(qt, kt, vt, qo_layout="bhsd", **kw)
    b = tfa.flash_attention(qt.permute(0, 2, 1, 3), kt, vt, qo_layout="bshd", **kw)
    assert torch.equal(a, b.permute(0, 2, 1, 3))


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("branch", ["prefill", "flash"])
def test_attention_block_matches_jax_fallback(rng, monkeypatch, quantized, branch):
    """attention_block (QKV GEMM, RoPE, KV store, attention, wo) against the
    JAX XLA fallback, through both kernels of the 8 MiB dispatch."""
    if branch == "flash":
        monkeypatch.setattr(tm, "PREFILL_KV_BYTES", 0)
    jcfg, tcfg = JConfig.tiny(), TConfig.tiny()
    jp = jm.init_params(jcfg, jm.Q8_0, seed=7)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    x = rng.standard_normal((2, 12, jcfg.dim)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj, np.float32)).to(torch.bfloat16)
    pos = 5
    jc = jm.KVCache.create(jcfg, 2, quantized=quantized)
    tc = tm.KVCache.create(tcfg, 2, quantized=quantized, device="cpu")
    want, jc = jm.attention_block(xj, jp["layers"][0], jc, 0, pos, jcfg,
                                  use_pallas=False)
    got, tc = tm.attention_block(xt, tp["layers"][0], tc, 0, pos, tcfg)
    _check(got, np.asarray(want, np.float32))
    assert np.array_equal(np.array(jc.k.astype(jnp.float32)), tc.k.float().numpy())


@pytest.mark.parametrize("entry", ["prefill", "flash_bhsd", "decode"])
@pytest.mark.parametrize("d,int8", [(20, True), (80, False), (320, True), (384, False),
                                    (576, True), (1000, False)])
def test_head_dims_and_f32_q_match_jax(rng, entry, d, int8):
    """Head dims that are not 64 or 128, above 256 too (320, 384, 576 —
    DeepSeek-V2/V3's absorbed latent attention scores over 576 dims — and
    1000: the CUDA path's wide kernel), and an f32 q, which the JAX kernels take (they
    pad d to a multiple of 128 and round q to bf16) and the port's CUDA
    kernels now take too: the plain path, which rounds q to bf16 as they do,
    against the Pallas kernels; the output in f32."""
    b, hq, hk, S = 2, 4, 2, 96
    sq = 1 if entry == "decode" else 12
    (kj, vj), (kt, vt) = _kv(rng, b, hk, S, d, int8)
    shape = (b, sq, hq, d) if entry == "prefill" else (b, hq, sq, d)
    qn = rng.standard_normal(shape).astype(np.float32)
    qj, qt = jnp.asarray(qn), torch.from_numpy(qn)
    off = np.array([0, 40], np.int32)
    kvl = off + sq
    sc = KV_SCALE if int8 else None
    kw = dict(q_offset=off, kv_len=kvl, kv_scale=sc)
    tkw = dict(q_offset=torch.from_numpy(off), kv_len=torch.from_numpy(kvl), kv_scale=sc)
    if entry == "prefill":
        want = jfa.prefill_attention(qj, kj, vj, causal=True, interpret=True, **kw)
        got = tfa.prefill_attention(qt, kt, vt, causal=True, **tkw)
    elif entry == "flash_bhsd":
        want = jfa.flash_attention(qj, kj, vj, causal=True, blk_q=8, blk_k=128,
                                   interpret=True, **kw)
        got = tfa.flash_attention(qt, kt, vt, causal=True, **tkw)
    else:
        want = jfa.decode_attention(qj, kj, vj, hk_blk=2, interpret=True, **kw)
        got = tfa.decode_attention(qt, kt, vt, **tkw)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    _check(got, np.asarray(want, np.float32))


def test_fwd_plan():
    """The wrapper's choice of attn_fwd_kernel's shape on a 132-SM H100: the
    split-KV decode where sq·group fits one CTA (64 rows, 16 a row group;
    chunks of 256 keys); else one chunk covering all S keys and the largest
    row block (128 at d <= 128, 64, 32 or 16 rows) that still gives 90 % of
    the SMs a CTA; below 4 row groups the other warps take key slices (at
    least 16 of a tile's 64 keys, 32 at d > 128)."""
    plan = lambda b, sq, hq, hk, S, d=128: tfa._fwd_plan(b, sq, hq, hk, S, d, 132)
    assert plan(4, 1, 32, 32, 2048) == (1, 4, 256, 8)      # 7B flash decode
    assert plan(4, 1, 32, 32, 200) == (1, 4, 256, 1)       # one chunk: no merge
    assert plan(4, 1, 32, 32, 2048, 256) == (1, 2, 256, 8)
    assert plan(1, 2, 64, 8, 4096) == (1, 4, 256, 16)      # 70B GQA, 2 queries: 16 rows
    assert plan(1, 3, 64, 8, 4096) == (2, 2, 256, 16)      # 24 rows: 2 row groups
    assert plan(1, 8, 64, 8, 4096) == (4, 1, 256, 16)      # 64 rows: 4 row groups
    assert plan(1, 9, 64, 8, 4096) == (1, 4, 4096, 1)      # 72 rows: the query rows split
    assert plan(1, 2048, 32, 32, 2048) == (8, 1, 2048, 1)  # row 4: 512 CTAs of 128 rows
    assert plan(1, 2048, 32, 32, 2000, 256) == (4, 1, 2048, 1)
    assert plan(1, 300, 32, 32, 512) == (4, 1, 512, 1)     # 160 CTAs of 64 rows
    assert plan(1, 128, 32, 32, 256) == (2, 2, 256, 1)     # row 3: 128 CTAs of 32 rows
    assert plan(1, 32, 4, 2, 128) == (4, 1, 256, 1)        # LlamaConfig.tiny() prefill
    assert plan(2, 40, 8, 4, 100) == (1, 4, 256, 1)        # 80 rows: 40 CTAs of 16


@pytest.mark.parametrize("d", [257, 300, 320, 384, 512, 576, 1000, 2112, 4096])
@pytest.mark.parametrize("kv_bytes", [1, 2])
@pytest.mark.parametrize("shape", ["prefill", "long_prefill", "decode", "decode_gqa8",
                                   "decode_mla"])
def test_wide_plan(d, kv_bytes, shape):
    """attn_wide_mma_kernel's plan on a 132-SM H100 (pure Python, the
    kernel's layout mirrored by _wide_smem): every CTA's shared memory within
    the card's 232448 bytes; O's 128 columns a warpgroup (64 f32 registers a
    thread), at most 3 warpgroups a CTA, the column slices
    covering d once; qc a multiple of 64, d padded to 64 where Q stays
    resident; the chunks (a multiple of the tile) covering S; one chunk where
    the unsplit grid already gives 2 CTAs an SM; a split's f32 partials at
    most twice its K/V rows; the grid over a full window the nearest 2 CTAs
    an SM of every allowed chunk's; every decode split where the unsplit
    grid is under one CTA an SM, absorbed MLA's (128 query heads on one
    latent head: two blocks of 64 m rows) too; at b = 4, GQA 32/8, S = 2048
    at least one CTA an SM over a full window (256 CTAs for d <= 384)."""
    b, sq, hq, hk, S = {"prefill": (1, 512, 32, 8, 512), "long_prefill": (1, 2048, 32, 32, 4096),
                        "decode": (4, 1, 32, 8, 2048), "decode_gqa8": (1, 8, 64, 8, 777),
                        "decode_mla": (4, 1, 128, 1, 2048)}[shape]
    p = tfa._wide_plan(b, sq, hq, hk, S, d, kv_bytes, 132)
    assert tfa._wide_smem(p.wg, p.bkv, p.qc, p.stages, d, kv_bytes) <= 232448
    assert tfa.WIDE_OW // 2 <= 64
    cols = p.wg * tfa.WIDE_OW
    assert p.slices * cols >= d > (p.slices - 1) * cols
    assert 1 <= p.wg <= 3 and p.bkv in (32, 64)
    assert p.qc % 64 == 0 and (p.qc < d or p.qc == -(-d // 64) * 64)
    assert p.stages in (1, 2) and p.chunk % p.bkv == 0
    assert p.chunk * p.n_chunks >= S > p.chunk * (p.n_chunks - 1)
    rows = sq * (hq // hk)
    ctas = b * hk * p.slices * -(-rows // tfa.WIDE_ROWS)
    if ctas >= 2 * 132:
        assert p.n_chunks == 1
    if p.n_chunks > 1:
        assert p.chunk in tfa.WIDE_CHUNKS and p.chunk * kv_bytes >= rows and p.chunk < S
    gap = lambda n: abs(ctas * n - 2 * 132)
    assert all(gap(p.n_chunks) <= gap(-(-S // c)) for c in tfa.WIDE_CHUNKS + (S,)
               if c * kv_bytes >= rows and c <= S)
    if shape == "decode":
        assert ctas * p.n_chunks >= 132
    if shape.startswith("decode") and ctas < 132:
        assert p.n_chunks > 1


def test_wide_plan_at_the_timed_shapes():
    """The plans of the shapes chip_smoke.py times (int8 KV): GQA 32/8 at d =
    320 in one CTA slice of 3 warpgroups (128, 128 and 64 columns of d), Q
    and whole K rows resident, 64-key tiles in two stages; d = 576 in two
    slices of 384 columns, 32-key tiles; causal flash at sq = S = 512 in one
    chunk; decode at b = 4, S = 2048 split in 8 chunks of 256 keys (d = 320)
    or 4 of 512 (576, two slices): 256 CTAs over a full window; absorbed
    MLA's decode (hq 128, hk 1, d 576: 16 CTAs unsplit) in 16 chunks of 128
    keys, int8 or bf16 K/V.  Each decode chunk is the fastest of the chunk
    sweep on the card (gemm_attn_bench.py --only wide)."""
    plan = lambda b, sq, S, d, hq=32, hk=8, kvb=1: tuple(
        tfa._wide_plan(b, sq, hq, hk, S, d, kvb, 132))
    assert plan(1, 512, 512, 320) == (3, 1, 64, 320, 2, 512, 1)
    assert plan(4, 1, 2048, 320) == (3, 1, 64, 320, 2, 256, 8)
    assert plan(1, 512, 512, 576) == (3, 2, 32, 576, 2, 512, 1)
    assert plan(4, 1, 2048, 576) == (3, 2, 32, 576, 2, 512, 4)
    assert plan(4, 1, 2048, 576, 128, 1) == (3, 2, 32, 576, 2, 128, 16)
    assert plan(4, 1, 2048, 576, 128, 1, 2) == (3, 2, 32, 576, 2, 128, 16)


def test_kv_load_width():
    """Bytes per K/V load of attn_fwd_kernel, from the rows' starts, strides
    and length: the cache's [b, S, hk, d] views at d = 128 load 16 bytes,
    int8 d = 20 rows 4, bf16 d = 36 rows 8, odd bf16 rows element by
    element (decode_attention's loads take the same widths)."""
    def cache(d, dt, hk=2):
        t = torch.zeros((2, 64, hk, d), dtype=dt)
        return t.permute(0, 2, 1, 3)
    assert tfa._vec_bytes(cache(128, torch.int8), cache(128, torch.int8)) == 16
    assert tfa._vec_bytes(cache(20, torch.int8), cache(20, torch.int8)) == 4
    assert tfa._vec_bytes(cache(36, torch.bfloat16), cache(36, torch.bfloat16)) == 8
    assert tfa._vec_bytes(cache(17, torch.bfloat16), cache(17, torch.bfloat16)) == 0
    k = cache(17, torch.int8, hk=4)
    assert tfa._vec_bytes(k, k) == 0 and tfa._row_align(k, k) % 4 != 0
    assert tfa._row_align(cache(20, torch.int8), cache(20, torch.int8)) % 4 == 0


def test_decode_plan():
    """The chunks of the split-KV decode_attention on a 132-SM H100: the
    longest chunk (512 ... 64 keys) whose K/V rows, scores and sums fit the
    CTA's 100 KB of shared memory and whose split of a full window over the
    KV heads gives 2 CTAs an SM; one chunk when the window fits it."""
    plan = lambda b, hq, hk, S, d=128, kvb=1: tfa._decode_plan(b, hq, hk, S, d, kvb, 132)
    assert plan(4, 32, 32, 2048) == (128, 16)        # row 2: 512 CTAs for a full row
    assert plan(4, 32, 32, 200) == (64, 4)
    assert plan(2, 4, 2, 64, d=16) == (64, 1)        # LlamaConfig.tiny(): no merge
    assert plan(1, 64, 8, 4096) == (64, 64)          # 70B GQA: 8 query heads a CTA
    assert plan(4, 32, 32, 2048, d=256, kvb=2) == (64, 32)
    for b, hq, hk, S, d, kvb in ((4, 32, 32, 2048, 128, 1), (1, 40, 40, 4096, 128, 2),
                                 (3, 8, 2, 1100, 80, 1), (1, 32, 1, 77, 256, 2),
                                 (1, 128, 1, 1024, 17, 2)):
        chunk, n = plan(b, hq, hk, S, d, kvb)
        assert chunk * n >= S > chunk * (n - 1)
        assert tfa._decode_smem(d, kvb, hq // hk, chunk) <= tfa.DECODE_SMEM


def _chunked_decode(q, k, v, kv_len, chunk, n_chunks, scale, kv_scale):
    """numpy emulation of decode_attn_kernel + attn_combine_kernel: per
    (row, KV head, chunk) the scores in log2 units of q (bf16) · K, the
    chunk's exact max and sum of 2^(s - max) and its unnormalised P·V
    (f32); then the merge of the chunks with max -inf skipped, 0 where no
    key was seen.  q [b, hq, d] f32 (bf16 values), k/v [b, hk, S, d]."""
    b, hq, d = q.shape
    hk, S = k.shape[1], k.shape[2]
    g = hq // hk
    sl = np.float32(scale * kv_scale * np.log2(np.e))
    out = np.zeros((b, hq, d), np.float32)
    for bi in range(b):
        L = min(int(kv_len[bi]), S)
        for h in range(hq):
            kh, ms, ls, accs = h // g, [], [], []
            for c in range(n_chunks):
                lo, hi = c * chunk, min(L, (c + 1) * chunk)
                if hi <= lo:
                    ms.append(-np.inf), ls.append(0.0), accs.append(np.zeros(d, np.float32))
                    continue
                s = (k[bi, kh, lo:hi].astype(np.float32) @ (q[bi, h] * sl)).astype(np.float32)
                m = s.max()
                p = np.exp2(s - m).astype(np.float32)
                ms.append(m), ls.append(p.sum()), accs.append(p @ v[bi, kh, lo:hi].astype(np.float32))
            M = max(ms)
            if M == -np.inf:
                continue
            w = [np.exp2(m - M) if m != -np.inf else 0.0 for m in ms]
            l = sum(wi * li for wi, li in zip(w, ls))
            out[bi, h] = sum(wi * a for wi, a in zip(w, accs)) * kv_scale / l
    return out


@pytest.mark.parametrize("int8", [True, False])
def test_chunked_decode_emulation_matches_jax(rng, int8):
    """The split-KV decode's arithmetic (numpy emulation: 128-key chunks of
    the 7B plan and 64-key ones, exact within each chunk, then the merge)
    against the JAX decode_attention (interpret) at kv_len 0, 1, 17, 255,
    256, 257 and 2048, GQA 8/2; a row with kv_len 0 outputs 0."""
    lens = [0, 1, 17, 255, 256, 257, 2048]
    b, hq, hk, S, d = len(lens), 8, 2, 2048, 64
    qj, qt = _q(rng, (b, hq, 1, d))
    (kj, vj), (kt, vt) = _kv(rng, b, hk, S, d, int8)
    scale = KV_SCALE if int8 else None
    kvl = np.array(lens, np.int32)
    want = np.asarray(jfa.decode_attention(qj, kj, vj, q_offset=jnp.asarray(kvl - 1),
                                           kv_len=jnp.asarray(kvl), kv_scale=scale, hk_blk=2,
                                           interpret=True), np.float32)[:, :, 0]
    kn, vn = kt.float().numpy(), vt.float().numpy()
    qn = qt.float().numpy()[:, :, 0]
    for chunk in (128, 64):
        got = _chunked_decode(qn, kn, vn, kvl, chunk, -(-S // chunk), 1 / np.sqrt(d),
                              scale if scale is not None else 1.0)
        assert np.all(got[0] == 0.0)
        r = verify(got, want, tol=2e-2, min_cosine=0.9999)
        assert r.passed and r.cosine_sim > 0.9999, r
        ref = tfa._attention_ref(qt, kt, vt, causal=False, q_offset=0, kv_len=torch.from_numpy(kvl),
                                 scale=1 / np.sqrt(d), kv_scale=scale).float().numpy()[:, :, 0]
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max())
