"""The paged KV write (``csrc/paged_kv_write.cu``) off the card.

- The paired entry (K and V in one launch, each slot's target computed
  from the block table and ``cache_len``) on the CPU, i.e. its plain
  version, against two calls of the reference's Pallas ``paged_kv_write``
  in interpret mode, given the targets the reference computes: positions
  at block edges and dead slots colliding on the write-off block.
- A numpy emulation of the kernel's recipe (each (slot, pool) item finds
  its target, skips when a later slot has the same one, copies in an
  arbitrary order) against ``ref.paged_kv_write_ref``, over slots and
  collisions drawn by hypothesis, for computed and given targets.
- The decode step's kernel route makes one paired write a layer and no
  single write.

Writes move values, so everything is bitwise."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import paged_attn as JPA
from repro_torch.configs.registry import reduced_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attn as KA
from repro_torch.models import lm

TRASH = 1          # the pool's write-off block (runtime/kv_pool.py)


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _slots(rng, b, nbps, bs, n_dead):
    """A fragmented table for b slots (ids >= 2) whose last n_dead slots
    are parked on the write-off block, and lengths: block edges (bs - 1,
    bs, 2 bs - 1, 2 bs) first, then random; the dead slots share two
    positions, so they collide in pairs."""
    n = 2 + b * nbps + 2
    table = (rng.permutation(n - 2)[: b * nbps] + 2).reshape(b, nbps)
    table = table.astype(np.int32)
    lens = rng.integers(0, nbps * bs, size=b)
    edges = [bs - 1, bs, 2 * bs - 1, 2 * bs]
    lens[: min(b, 4)] = edges[: min(b, 4)]
    if n_dead:
        table[b - n_dead:] = TRASH
        lens[b - n_dead:] = rng.choice([0, bs - 1], size=n_dead)
    return n, table, lens


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n_dead", [(4, 0), (6, 3), (9, 5)])
def test_pair_plain_equals_two_pallas_writes(dtype, b, n_dead):
    rng = np.random.default_rng(b + n_dead)
    bs, nbps, kvh, hd = 4, 3, 2, 8
    n, table, lens = _slots(rng, b, nbps, bs, n_dead)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    kp, vp = (jnp.asarray(rng.standard_normal((n, bs, kvh, hd)), jdt)
              for _ in range(2))
    kv, vv = (jnp.asarray(rng.standard_normal((b, kvh, hd)), jdt)
              for _ in range(2))
    # the reference's targets (repro/layers/attention.py:paged_update_kv)
    idx = jnp.asarray(lens).astype(jnp.int32)
    blk = jnp.take_along_axis(jnp.asarray(table), (idx // bs)[:, None],
                              axis=1)[:, 0]
    off = idx % bs
    want_k = np.asarray(JPA.paged_kv_write(kp, kv, blk, off, interpret=True))
    want_v = np.asarray(JPA.paged_kv_write(vp, vv, blk, off, interpret=True))
    for len_dtype in (torch.int32, torch.int64):
        tk, tv = _t(kp), _t(vp)
        ops.reset_launch_counts()
        ops.paged_kv_write_pair(tk, tv, _t(kv), _t(vv), _t(table),
                                torch.from_numpy(lens).to(len_dtype))
        assert ops.launch_counts()["paged_kv_write"] == 0   # plain on CPU
        np.testing.assert_array_equal(_np(tk), want_k.astype(np.float32))
        np.testing.assert_array_equal(_np(tv), want_v.astype(np.float32))
    if n_dead >= 2:                    # the collisions really happened
        tgt = list(zip(np.asarray(blk).tolist(), np.asarray(off).tolist()))
        assert len(set(tgt)) < b


# ---------------------------------------------- the kernel's recipe -------

def emulate(pages, vals, idx, pos, *, given_targets: bool, nbps: int = 0,
            order=None):
    """The kernel on numpy arrays: pages = [K, V] pools (N, bs, ...) (or
    one), vals their (B, ...) rows; idx the blocks (given) or the table
    (B, nbps); pos the offsets (given) or cache_len.  Item (b, p) computes
    slot b's target, skips it outside the pool or its table row, and skips
    when a later slot has the same target; the items run in ``order``
    (blocks run in no order on the card)."""
    n, bs = pages[0].shape[:2]
    b = vals[0].shape[0]

    def target(s):
        if given_targets:
            return int(idx[s]), int(pos[s])
        p = int(pos[s])
        if p < 0 or p >= nbps * bs:
            return -1, -1
        return int(idx[s, p // bs]), p % bs

    items = [(s, p) for s in range(b) for p in range(len(pages))]
    for item in (order if order is not None else range(len(items))):
        s, p = items[item]
        blk, off = target(s)
        if not (0 <= blk < n and 0 <= off < bs):
            continue
        if any(target(later) == (blk, off) for later in range(s + 1, b)):
            continue
        pages[p][blk, off] = vals[p][s]
    return pages


@settings(max_examples=60, deadline=None)
@given(b=st.integers(1, 12), nbps=st.integers(1, 4),
       bs=st.sampled_from([1, 2, 4, 16]), n_shared=st.integers(0, 12),
       seed=st.integers(0, 2 ** 31 - 1))
def test_emulation_matches_plain_version(b, nbps, bs, n_shared, seed):
    """Computed targets: slots share table rows (the write-off block's
    parking) and positions, so targets collide; the last slot wins."""
    rng = np.random.default_rng(seed)
    n = 2 + b * nbps
    table = rng.integers(1, n, size=(b, nbps)).astype(np.int32)
    share = rng.permutation(b)[: min(n_shared, b)]
    table[share] = TRASH
    lens = rng.integers(0, nbps * bs, size=b)
    lens[share] = rng.integers(0, min(bs, 2), size=len(share))
    pools = [rng.standard_normal((n, bs, 3)).astype(np.float32)
             for _ in range(2)]
    vals = [rng.standard_normal((b, 3)).astype(np.float32)
            for _ in range(2)]
    order = rng.permutation(2 * b)
    got = emulate([p.copy() for p in pools], vals, table, lens,
                  given_targets=False, nbps=nbps, order=order)
    want = [torch.from_numpy(p.copy()) for p in pools]
    ref.paged_kv_write_pair_ref(*want, *map(torch.from_numpy, vals),
                                torch.from_numpy(table),
                                torch.from_numpy(lens))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


@settings(max_examples=40, deadline=None)
@given(b=st.integers(1, 12), n=st.integers(1, 6), bs=st.integers(1, 5),
       seed=st.integers(0, 2 ** 31 - 1))
def test_emulation_given_targets_matches_plain_version(b, n, bs, seed):
    """Given targets (the reference's signature), drawn from a small pool
    so that many collide."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, n, size=b).astype(np.int32)
    offsets = rng.integers(0, bs, size=b).astype(np.int32)
    pages = rng.standard_normal((n, bs, 2, 3)).astype(np.float32)
    vals = rng.standard_normal((b, 2, 3)).astype(np.float32)
    [got] = emulate([pages.copy()], [vals], blocks, offsets,
                    given_targets=True, order=rng.permutation(b))
    want = ref.paged_kv_write_ref(torch.from_numpy(pages.copy()),
                                  torch.from_numpy(vals),
                                  torch.from_numpy(blocks),
                                  torch.from_numpy(offsets))
    np.testing.assert_array_equal(got, want.numpy())


def test_emulation_without_the_later_slot_rule_fails():
    """Dropping the skip makes the result depend on the order the items
    run in: with the first slot run last, it wins and the plain version
    disagrees."""
    pages = np.zeros((3, 2, 1), np.float32)
    vals = np.asarray([[1.0], [2.0]], np.float32)
    blocks, offsets = np.asarray([1, 1]), np.asarray([0, 0])

    def no_rule(order):
        out = pages.copy()
        for s in order:
            out[blocks[s], offsets[s]] = vals[s]
        return out

    want = ref.paged_kv_write_ref(torch.from_numpy(pages.copy()),
                                  torch.from_numpy(vals),
                                  torch.from_numpy(blocks.astype(np.int32)),
                                  torch.from_numpy(offsets.astype(np.int32)))
    assert not np.array_equal(no_rule([1, 0]), want.numpy())
    [got] = emulate([pages.copy()], [vals], blocks, offsets,
                    given_targets=True, order=[1, 0])
    np.testing.assert_array_equal(got, want.numpy())


def test_launchers_take_cuda_tensors_only():
    pages = torch.zeros((3, 2, 4))
    vals = torch.ones((2, 4))
    table = torch.ones((2, 1), dtype=torch.int32)
    lens = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        KA.paged_kv_write_pair(pages, pages.clone(), vals, vals, table, lens)
    with pytest.raises(ValueError, match="CUDA"):
        KA.paged_kv_write(pages, vals, lens, lens)


def test_decode_kernel_route_writes_once_a_layer(monkeypatch):
    """The paged decode step's kernel route makes one paired write a layer
    (one launch on the card) and no single write; the gather route
    makes none (it writes with the plain version, as the reference)."""
    calls = {"pair": 0, "single": 0}
    pair, single = ops.paged_kv_write_pair, ops.paged_kv_write

    def count_pair(*a):
        calls["pair"] += 1
        return pair(*a)

    def count_single(*a):
        calls["single"] += 1
        return single(*a)

    monkeypatch.setattr(ops, "paged_kv_write_pair", count_pair)
    monkeypatch.setattr(ops, "paged_kv_write", count_single)
    base = reduced_config("prosparse-llama2-7b")
    bs, b, nbps, steps = 4, 2, 3, 3
    for kernel in (True, False):
        cfg = base.replace(kv_cache_dtype="float32", paged_attn_kernel=kernel,
                           sparse=dataclasses.replace(base.sparse,
                                                      strategy="pallas"))
        params = lm.prepare_sparse(lm.init_lm(cfg, 0, device="cpu"))
        pool = lm.init_kv_pool(cfg, 2 + b * nbps, bs, device="cpu")
        table = (torch.arange(b * nbps, dtype=torch.int32) + 2).reshape(
            b, nbps)
        calls.update(pair=0, single=0)
        with torch.inference_mode():
            for t in range(steps):
                _, pool = lm.decode_step(
                    params, cfg, torch.zeros((b, 1), dtype=torch.int32),
                    pool, torch.tensor([3 + t, bs + t]), block_table=table)
        want = cfg.n_layers * steps if kernel else 0
        assert calls == {"pair": want, "single": 0}, (kernel, calls)
