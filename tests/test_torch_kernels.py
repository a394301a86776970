"""The port's plain kernel versions (what ``repro_torch.kernels.ops`` runs
on CPU tensors) against the reference's Pallas kernels in interpret mode.

Width: d=128, k=512, G=8, capacity_frac=0.1 -> C=16 of 64 groups, so the
capacity clamp binds.  Margins, counts and telemetry are exact; y is held
to rtol=atol=1e-5: both are float32 sums of the same products taken in a
different order, about 1e-6 apart here, and the reference's own drift
between paths it calls bitwise reaches 1.4e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import predictor as JP
from repro.core import selection as JS
from repro.core.sparse_mlp import DEAD_SLOT_ALPHA, SparseInferConfig
from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops

D, K, G = 128, 512, 8
CAP = SparseInferConfig(capacity_frac=0.1, group_size=G).capacity(K)
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed: int, b: int, gated: bool = True):
    rng = np.random.default_rng(seed)
    w = {n: (rng.standard_normal((K, D)) * D ** -0.5).astype(np.float32)
         for n in (("wg_t", "wu_t", "wd_t") if gated else ("wg_t", "wd_t"))}
    x = rng.standard_normal((b, D)).astype(np.float32)
    return w, x


ALPHAS = {"1.0": lambda b: np.full(b, 1.0, np.float32),
          "1.03": lambda b: np.full(b, 1.03, np.float32),
          "per-slot+dead": lambda b: np.asarray(
              [1.0, 0.9, 1.1, DEAD_SLOT_ALPHA][:b], np.float32)}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("alpha", list(ALPHAS))
@pytest.mark.parametrize("b", [1, 4])
def test_predict_group_margins_exact(alpha, b):
    w, x = _inputs(0, b)
    a = ALPHAS[alpha](b)
    pw = JP.pack_signs(jnp.asarray(w["wg_t"]))
    gm_r, cnt_r = jops.predict_group_margins(pw, jnp.asarray(x), D,
                                             jnp.asarray(a), group_size=G,
                                             interpret=True)
    gm_p, cnt_p = tops.predict_group_margins(_t(pw), _t(x), D, _t(a),
                                             group_size=G)
    np.testing.assert_array_equal(gm_p.numpy(), np.asarray(gm_r))
    np.testing.assert_array_equal(cnt_p.numpy(), np.asarray(cnt_r))


@pytest.mark.parametrize("variant", ["gated", "ungated", "fatrelu",
                                     "short-count"])
@pytest.mark.parametrize("alpha", list(ALPHAS))
def test_fused_sparse_mlp_and_telemetry(variant, alpha):
    b = 4
    w, x = _inputs(1, b, gated=variant != "ungated")
    a = ALPHAS[alpha](b)
    act = "fatrelu" if variant == "fatrelu" else "relu"
    thr = 0.05 if variant == "fatrelu" else 0.0
    pw = JP.pack_signs(jnp.asarray(w["wg_t"]))
    gm, _ = jops.predict_group_margins(pw, jnp.asarray(x), D, jnp.asarray(a),
                                       group_size=G, interpret=True)
    sel, st = JS.capacity_select_with_stats(JS.union_margin(gm), CAP)
    assert int(st.overflow) > 0, "the capacity clamp must bind here"
    count = sel.count // 2 if variant == "short-count" else sel.count
    jw = [jnp.asarray(w[n]) if n in w else None
          for n in ("wg_t", "wu_t", "wd_t")]
    y_r, tel_r = jops.fused_sparse_mlp(
        jnp.asarray(x), *jw, sel.indices, count, gm, group_size=G,
        activation=act, fatrelu_threshold=thr, collect_stats=True,
        interpret=True)
    tw = [_t(w[n]) if n in w else None for n in ("wg_t", "wu_t", "wd_t")]
    y_p, tel_p = tops.fused_sparse_mlp(
        _t(x), *tw, _t(sel.indices), _t(count), _t(gm), group_size=G,
        activation=act, fatrelu_threshold=thr, collect_stats=True)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_r), **TOL)
    np.testing.assert_array_equal(tel_p.numpy(), np.asarray(tel_r))
    y_only = tops.fused_sparse_mlp(_t(x), *tw, _t(sel.indices), _t(count),
                                   group_size=G, activation=act,
                                   fatrelu_threshold=thr)
    np.testing.assert_array_equal(y_only.numpy(), y_p.numpy())


def test_plain_version_rounds_h_to_input_dtype():
    """With bfloat16 inputs the plain version rounds h to bfloat16 before
    the down projection, as the reference kernel does."""
    w, x = _inputs(2, 2)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    sel = torch.arange(CAP, dtype=torch.int32)
    y = tops.fused_sparse_mlp(xb, _t(w["wg_t"]), _t(w["wu_t"]),
                              _t(w["wd_t"]), sel, torch.tensor(CAP),
                              group_size=G)
    rows = lambda m: _t(w[m]).reshape(K // G, G, D)[:CAP].reshape(-1, D)
    xf = xb.float()
    h = torch.relu(xf @ rows("wg_t").T) * (xf @ rows("wu_t").T)
    want = h.to(torch.bfloat16).float() @ rows("wd_t")
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)


def test_launch_counts_untouched_on_cpu():
    tops.reset_launch_counts()
    w, x = _inputs(3, 2)
    pw = _t(JP.pack_signs(jnp.asarray(w["wg_t"])))
    tops.predict_group_margins(pw, _t(x), D, 1.0, group_size=G)
    assert tops.launch_counts() == dict.fromkeys(
        ("predict_group_margins", "predict_chunk_group_margins",
         "fused_sparse_mlp", "fused_sparse_mlp_chunk", "fused_sparse_mlp_q",
         "fused_sparse_mlp_chunk_q", "paged_attention", "paged_kv_write"), 0)
