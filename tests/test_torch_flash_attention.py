"""The port's blocked ``flash_attention`` against the reference's.

- Values: q (B, Sq, H, hd) against K/V (B, Sk, K, hd) for Sq and Sk in
  {1, 7, 13, 64, 97}, each pair at K/V chunks 1, 4, 8 and 1024 (the
  reference shrinks its chunk to a divisor of Sk, 1 at the primes; the
  port walks blocks of the given width with a shorter last one), over
  causal self-attention, a softcap, a sliding window, GQA, MQA and cross
  attention: within 1e-5 of ``repro.layers.attention.flash_attention``.
- Gradients of q, k and v against autograd through whole-sequence
  softmax attention, within 1e-5.
- Memory: a dispatch mode records every tensor the function allocates;
  none has more than B x H x Sq x kv_chunk elements (the output and one
  K/V block aside, which do not grow with Sq x Sk).
- ``attend`` and ``chunk_attend`` read the chunk they are given:
  prefill and chunked prefill at ``attn_chunk`` 4 and 1024 agree.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro.layers import attention as JA
from repro_torch.layers import attention as TA

B, HD = 2, 16
LENGTHS = (1, 7, 13, 64, 97)
CHUNKS = (1, 4, 8, 1024)
# (n_heads, n_kv_heads, softcap, window, cross)
VARIANTS = {
    "causal": (4, 4, 0.0, 0, False),
    "softcap": (4, 2, 5.0, 0, False),
    "window": (4, 2, 0.0, 5, False),
    "gqa_window_softcap": (6, 2, 3.0, 9, False),
    "mqa": (4, 1, 0.0, 0, False),
    "cross": (4, 2, 0.0, 0, True),
}


def _cfg(name: str):
    h, kvh, cap, win, cross = VARIANTS[name]
    kw = dict(d_model=h * HD, n_heads=h, n_kv_heads=kvh, head_dim=HD,
              softcap=cap, window=win, cross=cross)
    return JA.AttentionConfig(**kw), TA.AttentionConfig(**kw)


def _inputs(seed: int, sq: int, sk: int, h: int, kvh: int):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, sq, h, HD)).astype(np.float32)
    k = rng.standard_normal((B, sk, kvh, HD)).astype(np.float32)
    v = rng.standard_normal((B, sk, kvh, HD)).astype(np.float32)
    # causal queries sit at the end of the keys, as a prefill chunk does
    qpos = np.arange(sq) + max(0, sk - sq)
    return q, k, v, qpos, np.arange(sk)


@pytest.mark.parametrize("sk", LENGTHS)
@pytest.mark.parametrize("sq", LENGTHS)
def test_matches_reference(sq, sk):
    names = list(VARIANTS)
    for i, chunk in enumerate(CHUNKS):
        name = names[(LENGTHS.index(sq) + LENGTHS.index(sk) + i)
                     % len(names)]
        jcfg, tcfg = _cfg(name)
        q, k, v, qpos, kpos = _inputs(sq * 131 + sk, sq, sk, tcfg.n_heads,
                                      tcfg.n_kv_heads)
        want = JA.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jcfg, jnp.asarray(qpos),
                                  jnp.asarray(kpos), q_chunk=chunk,
                                  kv_chunk=chunk)
        got = TA.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), tcfg,
                                 torch.from_numpy(qpos),
                                 torch.from_numpy(kpos), kv_chunk=chunk)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5, err_msg=f"{name} chunk {chunk}")


def _whole(q, k, v, cfg, qpos, kpos):
    """Softmax attention over the whole sequence at once (autograd's
    yardstick)."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, hd)
    s = torch.einsum("bqkrh,btkh->bkrqt", qg, k) * hd ** -0.5
    s = TA._softcap(s, cfg)
    mask = TA._chunk_mask(cfg, qpos, kpos)
    if mask is not None:
        s = torch.where(mask, s, torch.tensor(TA.NEG_INF))
    p = torch.softmax(s, -1)
    return torch.einsum("bkrqt,btkh->bqkrh", p, v).reshape(b, sq, h, hd)


@pytest.mark.parametrize("name,sq,sk,chunk", [
    ("causal", 13, 13, 4), ("gqa_window_softcap", 64, 97, 8),
    ("mqa", 7, 64, 1024), ("cross", 13, 7, 1), ("window", 97, 97, 8)])
def test_gradient_matches_whole_sequence(name, sq, sk, chunk):
    _, cfg = _cfg(name)
    arrays = _inputs(7, sq, sk, cfg.n_heads, cfg.n_kv_heads)
    grads = []
    for fn in (lambda *a: TA.flash_attention(*a, kv_chunk=chunk), _whole):
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays[:3])
        out = fn(q, k, v, cfg, *(torch.from_numpy(a) for a in arrays[3:]))
        w = torch.from_numpy(np.random.default_rng(1).standard_normal(
            out.shape).astype(np.float32))
        (out * w).sum().backward()
        grads.append((out.detach(), q.grad, k.grad, v.grad))
    for tag, got, want in zip(("out", "dq", "dk", "dv"), *grads):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5,
                                   msg=lambda m: f"{tag}: {m}")


class _Largest(TorchDispatchMode):
    """The element count of the largest tensor any op allocates."""

    def __init__(self):
        super().__init__()
        self.most = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        fresh = [r.alias_info is None for r in func._schema.returns]
        for t, new in zip(tree_leaves(out), fresh * 8):
            if new and isinstance(t, torch.Tensor):
                self.most = max(self.most, t.numel())
        return out


@pytest.mark.parametrize("sq,sk,chunk", [(256, 256, 32), (128, 512, 64),
                                         (97, 97, 8), (1, 64, 4)])
def test_no_allocation_grows_with_sq_times_sk(sq, sk, chunk):
    _, cfg = _cfg("gqa_window_softcap")
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    arrays = [torch.from_numpy(a) for a in _inputs(3, sq, sk, h, kvh)]
    with _Largest() as mode:
        TA.flash_attention(*arrays[:3], cfg, *arrays[3:], kv_chunk=chunk)
    scores = B * h * sq * chunk
    assert mode.most <= max(scores, B * sq * h * HD, B * chunk * kvh * HD)
    if sq >= HD and chunk >= HD:
        assert mode.most <= scores < B * h * sq * sk


@pytest.mark.parametrize("chunk", [4, 1024])
def test_attend_and_chunk_attend_take_the_chunk(chunk):
    """The chunk changes only the float rounding: prefill attention and
    chunked prefill (two chunks of 8 against a 32-wide cache) at K/V
    blocks of ``chunk`` agree with the whole-sequence chain at 1024."""
    _, cfg = _cfg("softcap")
    cfg = dataclasses.replace(cfg, d_model=32)
    gen = torch.Generator().manual_seed(0)
    params = TA.init_attention(gen, cfg)
    x = torch.randn((B, 16, 32), generator=gen)
    pos = torch.arange(16)
    outs = []
    for c in (chunk, 1024):
        full = TA.attend(params, x, cfg, pos, kv_chunk=c)
        cache = TA.init_kv_cache(B, 32, cfg, torch.float32)
        parts = [TA.chunk_attend(params, x[:, o:o + 8], cfg, cache, o,
                                 kv_chunk=c)[0] for o in (0, 8)]
        outs.append((full, torch.cat(parts, 1)))
    for got, want in zip(outs[0], outs[1]):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    torch.testing.assert_close(outs[0][0], outs[0][1], rtol=0, atol=1e-5)
