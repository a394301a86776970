"""The port's paged KV pool on the CPU, against the JAX package.

- the plain paged-attention and paged-write versions against the
  reference's Pallas kernels (interpret mode) and its plain versions;
- the port's ``KVPool`` against the reference's, driven by one random
  sequence of operations, snapshot for snapshot;
- teacher-forced ``decode_step(block_table=...)`` against the reference
  from one fragmented pool, on the kernel route and the gather route, with
  float32 and int8 pools;
- the port's paged decode bitwise equal to its dense decode;
- the paged server: tokens equal to the dense server's, and the
  reference's prefix-reuse, session and copy-on-write cases with the
  reference's pool counters.

Tolerances.  float32 pools: the two packages sum the attention products in
another order, ~2e-7 on O(1) outputs, held to 1e-5.  bfloat16 and int8
pools: p (times v_scale for int8) is rounded to bfloat16 before the PV
product, where a one-ulp float32 difference can move it by one bfloat16
ulp, so each term of the weighted mean may move by 2^-8 of itself: held to
2^-8 * max|v| (measured ~2e-7 here: no rounding flipped).  Decode logits
keep the contract of tests/test_torch_lm.py (1e-4 float32 pool, 5e-3 int8).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import PagedKVConfig as JPagedKVConfig
from repro.configs.registry import default_sparse as j_default_sparse
from repro.configs.registry import reduced_config as j_reduced
from repro.kernels import paged_attn as JPA
from repro.kernels import ref as jref
from repro.models import lm as jlm
from repro.runtime import kv_pool as jkv
from repro.runtime import server as jserver
from repro_torch import bridge
from repro_torch.configs.base import ModelConfig, PagedKVConfig
from repro_torch.configs.registry import default_sparse
from repro_torch.configs.registry import reduced_config as t_reduced
from repro_torch.core.sparse_mlp import MLP_STAT_KEYS
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attn as KA
from repro_torch.layers import attention as A
from repro_torch.models import lm
from repro_torch.runtime import kv_pool as tkv
from repro_torch.runtime.server import Request, Server, ServeConfig

ARCH = "prosparse-llama2-7b"


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


# ------------------------------------------------------------ kernels ------

def _fragmented(rng, b, nbps, n_spare=3):
    """A fragmented table: random distinct pool blocks (ids >= 2), slots 0
    and 1 sharing their first block."""
    n = 2 + b * nbps + n_spare
    ids = rng.permutation(n - 2)[: b * nbps] + 2
    table = ids.reshape(b, nbps).astype(np.int32)
    if b > 1:
        table[1, 0] = table[0, 0]
    return n, table


LAYOUTS = [(2, 2), (4, 2), (8, 2)]          # (H, K): MHA, rep 2, rep 4
OPTIONS = [(0.0, 0), (5.0, 0), (0.0, 11)]   # (softcap, window)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kvh", LAYOUTS)
@pytest.mark.parametrize("softcap,window", OPTIONS)
def test_paged_attention_plain_matches_reference(dtype, h, kvh, softcap,
                                                 window):
    """Lengths 0, a block boundary and s_max - 1 on a fragmented table with
    a shared block; against the Pallas kernel (interpret) and the
    reference's plain version."""
    rng = np.random.default_rng([len(dtype), h, int(softcap), window])
    b, hd, bs, nbps = 4, 8, 4, 4
    n, table = _fragmented(rng, b, nbps)
    s_max = nbps * bs
    lengths = np.asarray([0, bs, s_max - 1, 6], np.int32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    kp = jnp.asarray(rng.standard_normal((n, bs, kvh, hd)), jdt)
    vp = jnp.asarray(rng.standard_normal((n, bs, kvh, hd)), jdt)
    q = jnp.asarray(rng.standard_normal((b, h, hd)), jnp.float32)
    kw = dict(softcap=softcap, window=window)
    want_k = np.asarray(JPA.paged_attention(q, kp, vp, jnp.asarray(table),
                                            jnp.asarray(lengths),
                                            interpret=True, **kw))
    want_r = np.asarray(jref.paged_attention_ref(
        q, kp, vp, jnp.asarray(table), jnp.asarray(lengths), **kw))
    got = ops.paged_attention(_t(q), _t(kp), _t(vp), _t(table), _t(lengths),
                              **kw)
    assert got.dtype == torch.float32 and got.shape == (b, h, hd)
    vmax = float(np.abs(np.asarray(vp, np.float32)).max())
    tol = 2 ** -8 * vmax if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.numpy(), want_k, rtol=0, atol=tol)
    np.testing.assert_allclose(got.numpy(), want_r, rtol=0, atol=tol)


def test_paged_attention_int8_pool_matches_reference_plain():
    """An int8 pool with its factored scales (the reference's plain version
    only: its kernel does not take int8)."""
    rng = np.random.default_rng(3)
    b, h, kvh, hd, bs, nbps = 3, 4, 2, 8, 4, 3
    n, table = _fragmented(rng, b, nbps)
    lengths = np.asarray([0, 4, 11], np.int32)
    kp = rng.integers(-127, 128, (n, bs, kvh, hd)).astype(np.int8)
    vp = rng.integers(-127, 128, (n, bs, kvh, hd)).astype(np.int8)
    ks = jnp.asarray(rng.uniform(0.01, 0.1, (n, bs, kvh)), jnp.bfloat16)
    vs = jnp.asarray(rng.uniform(0.01, 0.1, (n, bs, kvh)), jnp.bfloat16)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    want = np.asarray(jref.paged_attention_ref(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lengths), ks, vs))
    got = ops.paged_attention(_t(q), _t(kp), _t(vp), _t(table), _t(lengths),
                              _t(ks), _t(vs))
    # p * v_scale rounded to bfloat16, as p for the bf16 pool
    veff = np.abs(vp.astype(np.float32)
                  * np.asarray(vs, np.float32)[..., None]).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2 ** -8 * float(veff))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_kv_write_bitwise_with_collisions(dtype):
    """Against the Pallas kernel (interpret): three slots on one row of one
    block (the write-off block's collisions), two on another; the last
    slot wins."""
    rng = np.random.default_rng(2)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    pages = jnp.asarray(rng.standard_normal((6, 4, 2, 8)), jdt)
    vals = jnp.asarray(rng.standard_normal((6, 2, 8)), jdt)
    blocks = np.asarray([1, 3, 1, 5, 1, 3], np.int32)
    offsets = np.asarray([2, 0, 2, 1, 2, 0], np.int32)
    want = np.asarray(JPA.paged_kv_write(pages, vals, jnp.asarray(blocks),
                                         jnp.asarray(offsets),
                                         interpret=True))
    tp = _t(pages)
    out = ops.paged_kv_write(tp, _t(vals), _t(blocks), _t(offsets))
    assert out is tp                                       # in place
    np.testing.assert_array_equal(_np(out), want.astype(np.float32))


def test_launch_counts_untouched_by_paged_ops_on_cpu():
    ops.reset_launch_counts()
    test_paged_kv_write_bitwise_with_collisions("float32")
    assert ops.launch_counts()["paged_kv_write"] == 0
    assert ops.launch_counts()["paged_attention"] == 0


# ------------------------------------------- the attention's host plan ----

def H100(p: int, smem: int) -> int:
    """plan's max_clusters for an H100's 132 SMs, off the card: CTAs per SM
    limited by threads (2048) and shared memory (228 KB, 1 KB reserved per
    CTA) only; the card's occupancy calculator also counts registers and
    cluster placement."""
    per_sm = min(2048 // KA.THREADS, 233472 // (smem + 1024))
    return 132 * per_sm // p


def _layout(rg, hd, elem, bs, seg, tr):
    """csrc/paged_attention.cu's shared memory, region by region: the ring
    of 3 K/V tiles (or the 128 threads' row-group partial outputs, if
    larger), q, the partial output, the scores, maxima, sums and block ids,
    each padded to 16 bytes."""
    pad = lambda x: -(-x // 16) * 16                      # noqa: E731
    ring = max(3 * tr * hd * elem, 128 // (hd * elem // 16) * hd * 4)
    return (pad(ring) + 2 * pad(rg * hd * 4) + pad(rg * seg * 4)
            + 2 * pad(rg * 4) + pad((-(-seg // bs) + 1) * 4))


# name: (B, H, K, hd, block, nbps, bytes per value), (P, query heads per
# CTA, tile rows, score rows per CTA)
PLANS = {
    "main": ((4, 32, 32, 128, 16, 16, 2), (4, 1, 32, 64)),
    "long": ((16, 32, 32, 128, 16, 256, 2), (8, 1, 32, 512)),
    "B=16 max_len 256": ((16, 32, 32, 128, 16, 16, 2), (2, 1, 32, 128)),
    "B=1": ((1, 32, 32, 128, 16, 16, 2), (4, 1, 32, 64)),
    "rep 8 max_len 8192": ((2, 32, 4, 128, 16, 512, 2), (8, 8, 32, 1024)),
    "rep 8 max_len 8192 float32": ((2, 32, 4, 128, 16, 512, 4),
                                   (8, 8, 16, 1024)),
    "hd 64": ((4, 16, 16, 64, 16, 32, 2), (8, 1, 64, 64)),
    "hd 256 float32": ((3, 8, 4, 256, 16, 32, 4), (8, 2, 8, 64)),
    "MQA rep 48": ((2, 48, 1, 128, 16, 8, 2), (2, 8, 32, 64)),
    "rep 6": ((3, 12, 2, 128, 16, 8, 4), (2, 8, 16, 64)),
    "block 1": ((3, 16, 4, 128, 1, 40, 4), (1, 4, 16, 40)),
    "max_len 1": ((4, 8, 8, 128, 1, 1, 2), (1, 1, 32, 1)),
    "B=64 GQA max_len 2048": ((64, 32, 8, 128, 16, 128, 2), (4, 4, 32, 512)),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_attention_plan_shapes(name):
    """Cluster size, query-head group, tile rows and score rows for the
    main and long timed shapes and the edge shapes of chip_smoke.py on an
    H100's 132 SMs, and the shared memory of the kernel's layout."""
    (b, h, kvh, hd, bs, nbps, elem), want = PLANS[name]
    pl = KA.plan(b, h, kvh, hd, bs, nbps, elem, H100)
    assert (pl.cluster, pl.rep_group, pl.tile_rows, pl.seg_rows) == want
    assert pl.seg_rows == -(-nbps * bs // pl.cluster)
    assert pl.clusters == b * kvh * -(-(h // kvh) // pl.rep_group)
    assert pl.smem_bytes == _layout(pl.rep_group, hd, elem, bs, pl.seg_rows,
                                    pl.tile_rows) <= KA.SMEM_LIMIT
    assert pl.tile_rows * hd * elem <= KA.STAGE_BYTES or \
        pl.tile_rows == KA.MIN_TILE_ROWS


def test_attention_plan_main_shape_bytes():
    """The main shape's CTA, region by region: 3 tiles of 32 bf16 rows of
    256 bytes, q and o of one head, 64 scores, m and l, 5 block ids; its
    128 clusters of 4 all fit on the card at once."""
    pl = KA.plan(4, 32, 32, 128, 16, 16, 2, H100)
    assert pl.smem_bytes == 3 * 32 * 256 + 512 + 512 + 256 + 16 + 16 + 32
    assert pl.clusters == 128 <= pl.fit


def test_attention_plan_splits_only_while_the_grid_fits():
    """The cluster doubles only while the doubled clusters all fit on the
    card at once: with room for 124 clusters of 4 (a second wave for the
    main shape's 128) it stops at 2; past one wave a long max_len still
    splits to 8, down to 512 rows a CTA."""
    def card(fit4):
        return lambda p, smem: {1: 1056, 2: 528, 4: fit4, 8: fit4 // 2}[p]
    assert KA.plan(4, 32, 32, 128, 16, 16, 2, card(128)).cluster == 4
    assert KA.plan(4, 32, 32, 128, 16, 16, 2, card(124)).cluster == 2
    long = KA.plan(16, 32, 32, 128, 16, 256, 2, card(124))
    assert (long.cluster, long.seg_rows) == (8, 512) and long.fit < 512
    with pytest.raises(RuntimeError, match="cannot be scheduled"):
        KA.plan(4, 32, 32, 128, 16, 16, 2, lambda p, smem: 0)
    assert KA.plan(4, 32, 32, 128, 16, 16, 2, H100, cluster=8).cluster == 8
    with pytest.raises(ValueError, match="1, 2, 4 or 8"):
        KA.plan(4, 32, 32, 128, 16, 16, 2, H100, cluster=3)


def test_attention_plan_takes_rep8_at_8192():
    """Refused before the split (rep 8 x 8192 float32 scores in one CTA:
    262144 bytes), taken now: the cluster of 8 holds 1024 rows a CTA."""
    assert 8 * 8192 * 4 > KA.SMEM_LIMIT
    pl = KA.plan(2, 32, 4, 128, 16, 512, 2, H100)
    assert pl.cluster == 8 and pl.smem_bytes <= KA.SMEM_LIMIT


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("rep", [1, 3, 8, 16])
def test_attention_plan_within_limit_or_raises(rep, elem):
    """Whenever the plan accepts a shape its CTA fits the shared memory
    limit, with a portable cluster (1-8 CTAs, never more than max_len
    rows); otherwise it raises a ValueError that names the limit."""
    kvh = 4
    for b in (1, 4, 64):
        for hd in (64, 128, 256):
            for bs, nbps in ((1, 64), (16, 16), (16, 512), (16, 4096)):
                s_max = nbps * bs
                try:
                    pl = KA.plan(b, rep * kvh, kvh, hd, bs, nbps, elem,
                                 H100)
                except ValueError as e:
                    assert f"limit of {KA.SMEM_LIMIT}" in str(e)
                    assert rep >= 8 and s_max > 8192
                    continue
                assert pl.cluster in (1, 2, 4, 8) and pl.cluster <= s_max
                assert pl.smem_bytes <= KA.SMEM_LIMIT
                assert pl.rep_group == min(8, 1 << (rep - 1).bit_length())
                assert pl.seg_rows <= max(KA.MAX_SEG_ROWS, -(-s_max // 8))


def test_attention_plan_rejects_impossible_shapes():
    with pytest.raises(ValueError, match=f"limit of {KA.SMEM_LIMIT}"):
        KA.plan(1, 32, 4, 128, 16, 4096, 2, H100)        # rep 8 x 65536
    with pytest.raises(ValueError, match="at most 256"):
        KA.plan(1, 4, 4, 512, 16, 4, 2, H100)
    with pytest.raises(ValueError, match="multiple of 8"):
        KA.plan(1, 4, 4, 100, 16, 4, 2, H100)
    with pytest.raises(ValueError, match="H a multiple of K"):
        KA.plan(1, 6, 4, 128, 16, 4, 2, H100)


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_attention_segments_cover_the_span(p):
    """The P segments of a live span [t_lo, t_hi] tile it in rank order
    with no gap and no overlap, each at most ceil(max_len / P) rows; a
    span shorter than P leaves the last CTAs empty."""
    s_max = 256
    seg_rows = -(-s_max // p)
    for t_lo, t_hi in [(0, 0), (0, p - 2), (0, p - 1), (0, p), (5, 9),
                       (0, 31), (0, 32 * p - 1), (0, 32 * p), (17, 200),
                       (s_max - 1, s_max - 1), (0, s_max - 1)]:
        if t_hi < t_lo or t_hi >= s_max:
            continue
        rows, idle = [], 0
        for rank in range(p):
            a, n = KA.segment(t_lo, t_hi, p, rank)
            assert 0 <= n <= seg_rows
            rows.extend(range(a, a + n))
            idle += n == 0
        assert rows == list(range(t_lo, t_hi + 1))
        span = t_hi - t_lo + 1
        assert idle == p - -(-span // -(-span // p))


def _cluster_attention(q, kp, vp, table, lengths, p, softcap=0.0,
                       window=0):
    """The kernel's dataflow on the CPU: each of the cluster's p CTAs
    scores its segment, all take the global maximum, round p = exp(s - m)
    to the pool dtype, and the partial outputs and sums are added in rank
    order."""
    b, h, hd = q.shape
    _, bs, kvh, _ = kp.shape
    s_max = table.shape[1] * bs
    rep = h // kvh
    out = torch.empty((b, h, hd))
    for bi in range(b):
        ln = int(lengths[bi])
        t_lo = max(0, ln - window + 1) if window > 0 else 0
        t_hi = min(ln, s_max - 1)
        none_live = t_hi < t_lo
        if none_live:
            t_lo, t_hi = 0, s_max - 1
        for hi in range(h):
            kh = hi // rep
            qr = q[bi, hi].to(kp.dtype).float()
            segs = []
            for rank in range(p):
                a, n = KA.segment(t_lo, t_hi, p, rank)
                t = torch.arange(a, a + n)
                blk = table[bi].long()[t // bs].clamp(0, kp.shape[0] - 1)
                k = kp[blk, t % bs, kh].float()
                v = vp[blk, t % bs, kh].float()
                s = k @ qr
                s = (torch.tanh(s * ((hd ** -0.5) / softcap)) * softcap
                     if softcap > 0 else s * hd ** -0.5)
                if none_live:
                    s = torch.full((n,), NEG_INF)
                segs.append((s, v))
            m = max(float(s.max()) for s, _ in segs if len(s))
            o, l = torch.zeros(hd), torch.zeros(())
            for s, v in segs:
                pr = torch.exp(s - m)
                o = o + pr.to(vp.dtype).float() @ v
                l = l + pr.sum()
            out[bi, hi] = o / torch.clamp(l, min=1e-30)
    return out


NEG_INF = -1e30


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [1, 4, 8])
@pytest.mark.parametrize("softcap,window", OPTIONS + [(0.0, 1), (0.0, 3)])
def test_cluster_split_matches_plain_version(dtype, p, softcap, window):
    """The split with one global maximum gives the plain version's output
    (up to summation order): lengths 0, shorter than P, at a block
    boundary, s_max - 1 and past it (none live with a window)."""
    rng = np.random.default_rng([p, len(dtype), window])
    b, h, kvh, hd, bs, nbps = 6, 4, 2, 8, 4, 4
    n, table = _fragmented(rng, b, nbps)
    s_max = nbps * bs
    lengths = torch.tensor([0, 2, bs, s_max - 1, 9, s_max + 20])
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    kp = torch.from_numpy(rng.standard_normal((n, bs, kvh, hd))).to(tdt)
    vp = torch.from_numpy(rng.standard_normal((n, bs, kvh, hd))).to(tdt)
    q = torch.from_numpy(rng.standard_normal((b, h, hd)).astype(np.float32))
    tab = torch.from_numpy(table)
    got = _cluster_attention(q, kp, vp, tab, lengths, p, softcap, window)
    want = ops.paged_attention(q, kp, vp, tab, lengths, softcap=softcap,
                               window=window)
    tol = 2 ** -8 * float(vp.float().abs().max()) if dtype == "bfloat16" \
        else 1e-5
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


# ------------------------------------------------------------- KVPool ------

def _session_view(sess):
    return None if sess is None else (sess["chain"],
                                      sess["history"].tolist(), sess["tier"])


def _drive_pools(seed: int, n_blocks: int, bs: int, steps: int = 250):
    """One random operation sequence on both pools; results, raised errors
    and snapshots must agree after every step."""
    rng = np.random.default_rng(seed)
    pools = [jkv.KVPool(n_blocks, bs, max_sessions=3),
             tkv.KVPool(n_blocks, bs, max_sessions=3)]
    held: list[int] = []
    prompts = [rng.integers(0, 5, size=int(rng.integers(bs, 5 * bs)))
               for _ in range(4)]
    salts = [b"", b"tier1"]

    def both(op):
        outs = []
        for p in pools:
            try:
                outs.append(("ok", op(p)))
            except Exception as e:                      # noqa: BLE001
                outs.append(("raise", type(e).__name__))
        assert outs[0] == outs[1], outs
        return outs[0]

    for step in range(steps):
        kind = rng.choice(["alloc", "incref", "decref", "commit", "match",
                           "cow", "store", "drop", "lookup"],
                          p=[.25, .08, .15, .14, .1, .08, .1, .04, .06])
        if kind == "alloc":
            st, v = both(lambda p: p.alloc())
            if st == "ok":
                held.append(v)
            else:
                assert v in ("PoolExhausted",)
        elif kind == "incref" and held:
            b = held[int(rng.integers(len(held)))]
            both(lambda p: p.incref(b))
            held.append(b)
        elif kind == "decref" and held:
            b = held.pop(int(rng.integers(len(held))))
            both(lambda p: p.decref(b))
        elif kind == "commit" and held:
            # a slot commits blocks it owns, none committed before
            toks = prompts[int(rng.integers(len(prompts)))]
            salt = salts[int(rng.integers(2))]
            fresh = list(dict.fromkeys(
                b for b in held if b not in pools[1]._hash_of))
            ids = fresh[:len(toks) // bs]
            if ids:
                for b in ids:
                    held.remove(b)
                _, out = both(lambda p: p.commit_chain(
                    p.block_hashes(salt, toks), list(ids)))
                held.extend(out)
        elif kind == "match":
            toks = prompts[int(rng.integers(len(prompts)))]
            salt = salts[int(rng.integers(2))]
            both(lambda p: p.match_prefix(salt, toks))
        elif kind == "cow" and held:
            b = held.pop(int(rng.integers(len(held))))
            st, v = both(lambda p: p.ensure_writable(b))
            held.append(v[0] if st == "ok" else b)
        elif kind == "store" and held:
            n = int(rng.integers(1, min(3, len(held)) + 1))
            chain = held[-n:]
            del held[-n:]
            sid = f"s{int(rng.integers(5))}"
            hist = rng.integers(0, 5, size=n * bs)
            both(lambda p: p.store_session(sid, list(chain), hist, "tier"))
        elif kind == "drop":
            sid = f"s{int(rng.integers(5))}"
            both(lambda p: p.drop_session(sid))
        elif kind == "lookup":
            sid = f"s{int(rng.integers(5))}"
            both(lambda p: _session_view(p.lookup_session(sid)))
        for p in pools:
            p.check_invariants()
        assert pools[0].snapshot() == pools[1].snapshot(), step
        assert list(pools[0].sessions) == list(pools[1].sessions)
    return pools[1].snapshot()


@pytest.mark.parametrize("seed,n_blocks,bs", [(0, 8, 2), (1, 12, 4),
                                              (2, 5, 1), (3, 20, 3)])
def test_kv_pool_matches_reference(seed, n_blocks, bs):
    snap = _drive_pools(seed, n_blocks, bs)
    # the sequence reached exhaustion, dedup, forks and session evictions
    assert snap["n_blocks"] == n_blocks


def test_kv_pool_exhaustion_and_reserved_ids():
    for mod in (jkv, tkv):
        pool = mod.KVPool(4, 2)
        got = [pool.alloc(), pool.alloc()]
        assert got == [2, 3]
        with pytest.raises(mod.PoolExhausted):
            pool.alloc()
        for bad in (0, 1, -1, 4):
            with pytest.raises(ValueError):
                pool.incref(bad)
    assert issubclass(tkv.PoolExhausted, RuntimeError)


# ------------------------------------------------- teacher-forced decode ---

B, STEPS, BS, NBPS = 2, 4, 4, 4


def _decode_cfgs(kv: str, kernel: bool):
    out = []
    for reduced in (j_reduced, t_reduced):
        cfg = reduced(ARCH)
        out.append(cfg.replace(kv_cache_dtype=kv, paged_attn_kernel=kernel,
                               sparse=dataclasses.replace(
                                   cfg.sparse, strategy="pallas")))
    return out


def _random_pool(rng, jcfg, n_blocks):
    """The reference's pool tree filled with stale random content."""
    tree = jax.tree.map(np.asarray, jlm.init_kv_pool(jcfg, n_blocks, BS))
    out = {}
    for name, a in tree["blocks"].items():
        if a.dtype == np.int8:
            out[name] = rng.integers(-127, 128, a.shape).astype(np.int8)
        elif name.endswith("scale"):
            out[name] = np.asarray(jnp.asarray(
                rng.uniform(0.005, 0.05, a.shape), a.dtype))
        else:
            out[name] = np.asarray(jnp.asarray(
                rng.standard_normal(a.shape), a.dtype))
    return {"blocks": out}


@functools.lru_cache(maxsize=None)
def _ref_params(seed: int, kv: str):
    jcfg, _ = _decode_cfgs(kv, False)
    return jlm.init_lm(jax.random.PRNGKey(seed), jcfg)


@pytest.mark.parametrize("kv,tol", [("float32", 1e-4), ("int8", 5e-3)])
@pytest.mark.parametrize("kernel", [True, False])
def test_paged_decode_teacher_forced(kv, tol, kernel):
    jcfg, tcfg = _decode_cfgs(kv, kernel)
    jparams = _ref_params(0, kv)
    tparams = lm.prepare_sparse(bridge.params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu"))
    jparams = jlm.prepare_sparse(jparams)
    rng = np.random.default_rng(4)
    n_blocks, table = _fragmented(rng, B, NBPS)
    tree = _random_pool(rng, jcfg, n_blocks)
    jpool = jax.tree.map(jnp.asarray, tree)
    tpool = bridge.pool_from_numpy(tree, tcfg, device="cpu")
    lens0 = np.asarray([5, 9], np.int32)
    forced = rng.integers(0, jcfg.vocab, size=(STEPS, B, 1))
    alphas = (jcfg.sparse.alpha_schedule().alphas(jcfg.n_layers)[:, None]
              + np.asarray([0.25, -0.25], np.float32)[None, :])
    jstep = jax.jit(functools.partial(jlm.decode_step, cfg=jcfg,
                                      collect_stats=True))
    ops.reset_launch_counts()
    for t in range(STEPS):
        lens = lens0 + t
        jl, jpool, jst = jstep(jparams, token=jnp.asarray(forced[t]),
                               caches=jpool, cache_len=jnp.asarray(lens),
                               alphas=jnp.asarray(alphas),
                               block_table=jnp.asarray(table))
        with torch.inference_mode():
            tl, tpool, tst = lm.decode_step(
                tparams, tcfg, torch.from_numpy(forced[t]), tpool,
                torch.from_numpy(lens), alphas=alphas, collect_stats=True,
                block_table=torch.from_numpy(table))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=tol, err_msg=f"step {t}")
        for k in MLP_STAT_KEYS:
            np.testing.assert_array_equal(tst[k].numpy(),
                                          np.asarray(jst[k]),
                                          err_msg=f"step {t} {k}")
    for i, layer in enumerate(tpool["blocks"]):
        for name, buf in layer.items():
            want = np.asarray(jpool["blocks"][name][i]).astype(np.float32)
            np.testing.assert_allclose(_np(buf).astype(np.float32), want,
                                       rtol=0, atol=1e-2 if kv == "int8"
                                       else 1e-5, err_msg=name)
    assert sum(ops.launch_counts().values()) == 0       # plain on the CPU


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("kernel", [True, False])
def test_paged_decode_bitwise_equals_dense(kv, kernel):
    """The port's own claim: paged decode from a fragmented pool whose
    slot lanes hold the dense cache's live tokens (stale garbage past
    them) gives the dense decode's logits and stats bit for bit."""
    cfg = t_reduced(ARCH)
    cfg = cfg.replace(kv_cache_dtype=kv, paged_attn_kernel=kernel,
                      sparse=dataclasses.replace(cfg.sparse,
                                                 strategy="pallas"))
    params = lm.prepare_sparse(lm.init_lm(cfg, 3, device="cpu"))
    rng = np.random.default_rng(5)
    plen, max_len = 6, NBPS * BS * 2
    nbps = max_len // BS
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (B, plen)))
    n_blocks, table = _fragmented(rng, B, nbps)
    with torch.inference_mode():
        _, dense = lm.prefill(params, cfg, prompt, max_len)
        pool = lm.init_kv_pool(cfg, n_blocks, BS, device="cpu")
        for layer, cache in zip(pool["blocks"], dense["blocks"]):
            for name, buf in layer.items():
                g = torch.from_numpy(rng.standard_normal(buf.shape)) * 3
                buf.copy_(g.to(buf.dtype) if buf.dtype != torch.int8
                          else g.clamp(-127, 127).to(torch.int8))
                for i in range(B):
                    rows = cache[name][i].reshape((nbps, BS)
                                                  + buf.shape[2:])
                    for j in range(-(-plen // BS)):
                        if i == 1 and j == 0:
                            continue     # shared block: slot 0's content
                        buf[int(table[i, j])] = rows[j]
                # past the prompt: stale garbage in the slots' own blocks
                # stays (the dense cache holds zeros there)
        for layer, cache in zip(pool["blocks"], dense["blocks"]):
            for name in layer:
                cache[name][1, :BS] = cache[name][0, :BS]
        lengths = np.full(B, plen, np.int64)
        tab = torch.from_numpy(table)
        for t in range(5):
            tok = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1)))
            ln = torch.from_numpy(lengths + t)
            ld, dense, sd = lm.decode_step(params, cfg, tok, dense, ln,
                                           collect_stats=True)
            lp, pool, sp = lm.decode_step(params, cfg, tok, pool, ln,
                                          collect_stats=True,
                                          block_table=tab)
            assert torch.equal(ld, lp), f"step {t}"
            for k in MLP_STAT_KEYS:
                assert torch.equal(sd[k], sp[k]), (t, k)
        live = plen + 5
        for layer, cache in zip(pool["blocks"], dense["blocks"]):
            view = A.paged_gather_kv(layer, tab)
            for name in view:
                assert torch.equal(view[name][:, :live],
                                   cache[name][:, :live])


# ------------------------------------------------------------- server ------

TINY = dict(name="tiny-paged", family="dense", n_layers=2, d_model=32,
            n_heads=2, n_kv_heads=2, d_ff=64, vocab=128, max_seq=256,
            dtype="float32", param_dtype="float32", kv_cache_dtype="float32",
            attn_chunk=256, loss_chunk=64, remat=False, activation="relu")


def _tiny(strategy="dense", kernel=False):
    """The reference test's tiny config in both packages."""
    out = []
    for mc, ds in ((JModelConfig, j_default_sparse),
                   (ModelConfig, default_sparse)):
        cfg = mc(**TINY, paged_attn_kernel=kernel)
        if strategy != "dense":
            cfg = cfg.replace(sparse=dataclasses.replace(
                ds(activation="relu"), strategy=strategy, group_size=8,
                capacity_frac=0.5))
        out.append(cfg)
    return out


@functools.lru_cache(maxsize=None)
def _tiny_params(strategy: str):
    jcfg, tcfg = _tiny(strategy)
    jparams = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    return jparams, bridge.params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


def _scfgs(pc, batch=2, max_len=64, bs=8):
    return (jserver.ServeConfig(batch=batch, max_len=max_len,
                                prefill_chunk=pc, prefill_interleave=8,
                                paged_kv=JPagedKVConfig(block_size=bs)),
            ServeConfig(batch=batch, max_len=max_len, prefill_chunk=pc,
                        prefill_interleave=8,
                        paged_kv=PagedKVConfig(block_size=bs)))


def _servers(pc, strategy="dense", **kw):
    jcfg, tcfg = _tiny(strategy)
    jp, tp = _tiny_params(strategy)
    jsc, tsc = _scfgs(pc, **kw)
    return (jserver.Server(jlm, jcfg, jsc, jp),
            Server(lm, tcfg, tsc, tp, device="cpu"))


def _port_server(pc, strategy="dense", kernel=False, paged=True, **kw):
    _, tcfg = _tiny(strategy, kernel)
    _, tsc = _scfgs(pc, **kw)
    if not paged:
        tsc = dataclasses.replace(tsc, paged_kv=None)
    return Server(lm, tcfg, tsc, _tiny_params(strategy)[1], device="cpu")


def _reqs(rng, plens, max_new=6):
    return [Request(uid=i, prompt=rng.integers(0, 128, size=p),
                    max_new=max_new) for i, p in enumerate(plens)]


@pytest.mark.parametrize("strategy,pc,kernel", [
    ("dense", 0, False), ("dense", 8, False), ("pallas", 0, False),
    ("pallas", 8, False), ("dense", 8, True), ("pallas", 8, True)])
def test_paged_serve_tokens_equal_dense(strategy, pc, kernel):
    plens = (5, 13, 9, 17)
    outs = {}
    for paged in (False, True):
        srv = _port_server(pc, strategy, kernel, paged)
        done = srv.serve(_reqs(np.random.default_rng(3), plens))
        outs[paged] = {r.uid: r.out for r in done}
    for uid in outs[False]:
        np.testing.assert_array_equal(outs[True][uid], outs[False][uid],
                                      err_msg=f"uid {uid}")
    srv.kv_pool.check_invariants()
    assert srv.paged_stats()["free_blocks"] > 0


def _same_stats(jsrv, tsrv):
    js, ts = jsrv.paged_stats(), tsrv.paged_stats()
    assert set(js) == set(ts)
    assert ts == js
    assert ts["preemptions"] == ts["shed"] == ts["admissions_deferred"] == 0


def test_prefix_reuse_matches_reference():
    """The reference's trie-reuse case: the second request sharing a
    committed 70-token prefix skips 4 of its 5 chunks in both packages,
    and emits the tokens of a fresh port server."""
    jsrv, tsrv = _servers(16, max_len=128)
    rng = np.random.default_rng(7)
    sys_prompt = rng.integers(0, 128, 70)
    pa = np.concatenate([sys_prompt, rng.integers(0, 128, 12)])
    pb = np.concatenate([sys_prompt, rng.integers(0, 128, 9)])
    outs = []
    for mod, srv in ((jserver, jsrv), (None, tsrv)):
        R = jserver.Request if mod else Request
        srv.serve([R(uid=0, prompt=pa, max_new=4)])
        run0 = srv.prefill_chunks_run
        [rb] = srv.serve([R(uid=1, prompt=pb, max_new=5)])
        st = srv.paged_stats()
        assert st["reuse_hits"] == 1 and st["reused_tokens"] == 64
        assert srv.prefill_chunks_skipped == 4
        assert srv.prefill_chunks_run - run0 == 1
        srv.kv_pool.check_invariants()
        outs.append(rb.out)
    _same_stats(jsrv, tsrv)
    fresh = _port_server(16, max_len=128)
    [want] = fresh.serve([Request(uid=1, prompt=pb, max_new=5)])
    np.testing.assert_array_equal(outs[1], want.out)


def test_session_continuation_and_sticky_tier():
    """Turn 2 of a session extends its history: it takes the session's
    tier over the one it asks for and skips the chunks its chain covers,
    with the reference's counters; its tokens equal a fresh serve's."""
    jsrv, tsrv = _servers(16, max_len=128)
    for srv, R in ((jsrv, jserver.Request), (tsrv, Request)):
        rng = np.random.default_rng(9)
        p1 = rng.integers(0, 128, 40)
        [r1] = srv.serve([R(uid=0, prompt=p1, max_new=6, sla="quality",
                            session_id="s0")])
        p2 = np.concatenate([p1, r1.out, rng.integers(0, 128, 5)])
        run0 = srv.prefill_chunks_run
        [r2] = srv.serve([R(uid=1, prompt=p2, max_new=4, sla="latency",
                            session_id="s0")])
        assert r2.sla == "quality"
        assert srv.prefill_chunks_skipped == 2
        assert srv.prefill_chunks_run - run0 == 2
        assert srv.kv_pool.lookup_session("s0")["tier"] == "quality"
        srv.kv_pool.check_invariants()
    _same_stats(jsrv, tsrv)
    fresh = _port_server(16, max_len=128)
    [want] = fresh.serve([Request(uid=1, prompt=p2, max_new=4,
                                  sla="quality")])
    np.testing.assert_array_equal(r2.out, want.out)


def test_cow_divergence_past_reuse_boundary():
    """A matched prefix past the chunk-aligned boundary is adopted for
    writing: the session-pinned originals fork (copy-on-write), with the
    reference's counters, and the tokens equal a fresh serve's."""
    jsrv, tsrv = _servers(16, max_len=128)
    rng = np.random.default_rng(11)
    common = rng.integers(0, 128, 24)           # 3 full blocks, boundary 16
    pa = np.concatenate([common, rng.integers(0, 128, 10)])
    pb = np.concatenate([common, rng.integers(0, 128, 13)])
    for srv, R in ((jsrv, jserver.Request), (tsrv, Request)):
        srv.serve([R(uid=0, prompt=pa, max_new=3, session_id="keep")])
        [rb] = srv.serve([R(uid=1, prompt=pb, max_new=4)])
        assert srv.paged_stats()["cow_forks"] >= 1
        srv.kv_pool.check_invariants()
    _same_stats(jsrv, tsrv)
    fresh = _port_server(16, max_len=128)
    [want] = fresh.serve([Request(uid=1, prompt=pb, max_new=4)])
    np.testing.assert_array_equal(rb.out, want.out)


def test_mixed_queue_pool_counters_match_reference():
    """A mixed queue (sessions, shared prefixes, mixed tiers, refills)
    through both servers, then a second serve() of turn 2: every pool
    counter equal after each serve."""
    jsrv, tsrv = _servers(8, strategy="pallas", batch=3, max_len=96)
    slas = ("latency", "balanced", "quality")
    outs = {}
    for srv, R in ((jsrv, jserver.Request), (tsrv, Request)):
        rng = np.random.default_rng(13)
        shared = rng.integers(0, 128, 20)
        reqs = []
        for i in range(7):
            own = rng.integers(0, 128, int(rng.integers(3, 20)))
            prompt = np.concatenate([shared, own]) if i % 2 else own
            reqs.append(R(uid=i, prompt=prompt,
                          max_new=int(rng.integers(2, 7)),
                          sla=slas[i % 3] if i % 2 == 0 else "balanced",
                          session_id=f"s{i}" if i < 3 else None))
        done = srv.serve(reqs)
        first = srv.paged_stats()
        hist = {r.uid: np.concatenate([r.prompt, r.out]) for r in done}
        turn2 = [R(uid=10 + i, prompt=np.concatenate(
                     [hist[i], rng.integers(0, 128, 8)]), max_new=3,
                   session_id=f"s{i}") for i in range(3)]
        done2 = srv.serve(turn2)
        assert [r.sla for r in sorted(done2, key=lambda r: r.uid)] == \
            [slas[0], "balanced", slas[2]]
        srv.kv_pool.check_invariants()
        outs[srv is tsrv] = (first, srv.paged_stats())
    assert outs[True] == outs[False]
    assert outs[True][1]["reuse_hits"] >= 3
    assert outs[True][1]["prefill_chunks_skipped"] > 0


def test_paged_server_validation():
    _, tcfg = _tiny()
    params = _tiny_params("dense")[1]
    bad = [dict(max_len=60, paged_kv=PagedKVConfig(block_size=8)),
           dict(max_len=64, prefill_chunk=4,
                paged_kv=PagedKVConfig(block_size=8))]
    for kw in bad:
        with pytest.raises(ValueError, match="block_size"):
            Server(lm, tcfg, ServeConfig(**kw), params, device="cpu")
    srv = Server(lm, tcfg, ServeConfig(batch=1, max_len=16,
                                       paged_kv=PagedKVConfig(
                                           block_size=4, pool_blocks=4)),
                 params, device="cpu")
    with pytest.raises(tkv.PoolExhausted):
        srv.serve([Request(uid=0, prompt=np.arange(10), max_new=2)])


def test_paged_config_fields_and_bridge_match_reference():
    """PagedKVConfig's fields and defaults are the reference's; the bridge
    unstacks a reference pool layer by layer and rejects a depth
    mismatch."""
    fields = [(f.name, f.default) for f in
              dataclasses.fields(PagedKVConfig)]
    assert fields == [(f.name, f.default) for f in
                      dataclasses.fields(JPagedKVConfig)]
    assert ServeConfig().paged_kv is None and \
        Request(uid=0, prompt=np.zeros(1)).session_id is None
    jcfg, tcfg = _decode_cfgs("int8", False)
    tree = _random_pool(np.random.default_rng(6), jcfg, 5)
    pool = bridge.pool_from_numpy(tree, tcfg, device="cpu")
    assert len(pool["blocks"]) == tcfg.n_layers
    for name, a in tree["blocks"].items():
        np.testing.assert_array_equal(_np(pool["blocks"][1][name]),
                                      a[1].astype(_np(
                                          pool["blocks"][1][name]).dtype))
    want = lm.init_kv_pool(tcfg, 5, BS, device="cpu")["blocks"][0]
    assert {k: (v.shape, v.dtype) for k, v in pool["blocks"][0].items()} \
        == {k: (v.shape, v.dtype) for k, v in want.items()}
    with pytest.raises(ValueError, match="layers"):
        bridge.pool_from_numpy(tree, tcfg.replace(n_layers=3), device="cpu")
