"""The float32 decode MLP (``csrc/fused_sparse_mlp.cu``) off the card: its
summation order and its host plan.

- A plain-torch emulation of the kernel's order: gate/up per row over the
  rounds of d (4096, 2048 or 1024 columns for batches of up to 4, 8 or 16
  tokens), in each round each thread's 16-byte pieces summed, the 32
  lanes of a warp added in the reduce-scatter's pairwise tree, the 8 warps
  added in order, the rounds added in order; h rounded to x's dtype.  Down
  per (512-column tile, group) unit: the group's zeroed partial added in
  selection order within each block's run of units; the runs added in
  block order.  Exact products are summed in float64 and rounded to
  float32 once per thread piece or group here; the card sums them in
  float32 instead.  Held against the reference's Pallas
  ``fused_sparse_mlp`` in interpret mode within rtol=atol=1e-5 (the port's
  TOL), over bf16 and float32 x, B in {1, 4, 5, 16}, gated and ungated,
  fatrelu, G in {1, 8, 16}, a short and a zero count, d in {64, 100} and d
  over a round's boundary (1100 at B=16, 4100 at B=4).
- The same emulation with h left unrounded for bf16 x fails that check.
- The plan: gate/up's rows and down's units cover every selected row and
  (tile, group) once, in equal contiguous ranges a block; each block's run
  in a tile has its own slot; no block is idle at the main shape, full and
  a third of the selection; the grid is resident and the shared memory
  fits for the occupancy it is given; it raises past its limits.
- The launcher refuses CPU tensors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import sparse_mlp_fused as KF
from test_torch_chunk_mlp_tc import SMS, TOL, _case

MATS = ("wg_t", "wu_t", "wd_t")


def H100(nb: int, smem: int) -> int:
    """decode_plan's occupancy for an H100 off the card: blocks per SM
    limited by threads (2048), registers (at most 128 a thread: 2 blocks)
    and shared memory (228 KB, 1 KB reserved per block, the static
    telemetry tile)."""
    return min(2048 // KF.D_THREADS, 2, 233472 // (smem + 1024 + 1024))


# ------------------------------------------------- the kernel's order --

def _tree(v: torch.Tensor) -> torch.Tensor:
    """The pairwise tree over the last axis (a power of two), float32:
    ((v0 + v1) + (v2 + v3)) + ..."""
    while v.shape[-1] > 1:
        v = v[..., 0::2] + v[..., 1::2]
    return v[..., 0]


def _in_order(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis from the first term on, float32."""
    s = v[..., 0]
    for i in range(1, v.shape[-1]):
        s = s + v[..., i]
    return s


def _gate_up(xf, w, pl):
    """The kernel's gate (or up) value of rows w (R, d) float32, x (B, d)
    float32 -> (R, B) float32."""
    r, d = w.shape
    b = xf.shape[0]
    rc = pl.round_cols
    prod = w.double()[:, None, :] * xf.double()[None]            # exact
    prod = torch.nn.functional.pad(prod, (0, pl.rounds * rc - d))
    # column (round, piece j, thread t, c) = round*rc + (j*256 + t)*4 + c
    pieces = prod.reshape(r, b, pl.rounds, rc // (4 * KF.D_THREADS),
                          KF.D_THREADS, 4)
    thread = pieces.sum((3, 5)).float()                # (R, B, rounds, 256)
    warps = _tree(thread.reshape(r, b, pl.rounds, KF.D_WARPS, 32))
    return _in_order(_in_order(warps))


def emulate_decode(x, wg, wu, wd, sel, count, *, group_size, act_kind, thr,
                   pl, round_h=True):
    """y of the float32 decode kernel for plan ``pl``, on the CPU;
    ``round_h`` False leaves h unrounded (a different function)."""
    b, d = x.shape
    g = group_size
    rows = (sel[:count].long()[:, None] * g
            + torch.arange(g)[None, :]).reshape(-1)
    xf = x.float()
    gate = _gate_up(xf, wg[rows], pl)                             # (R, B)
    ga = torch.relu(gate) if act_kind == 0 else torch.where(
        gate > thr, gate, torch.zeros(()))
    h = ga * _gate_up(xf, wu[rows], pl) if wu is not None else ga
    if round_h:
        h = h.to(x.dtype).float()
    # down: units (tile, group) tile-major in equal ranges a block; a
    # block's run in a tile adds its groups' partials, the runs in block
    # order
    n_units = pl.tiles * count
    y = torch.zeros((b, d))
    for ct in range(pl.tiles):
        c0, c1 = ct * KF.D_TILE, min(d, (ct + 1) * KF.D_TILE)
        if not count:
            continue
        first = KF.q_owner(ct * count, n_units, pl.grid)
        last = KF.q_owner((ct + 1) * count - 1, n_units, pl.grid)
        for blk in range(first, last + 1):
            u0, u1 = KF.q_range(n_units, pl.grid, blk)
            if u0 == u1:         # a block with no unit has no run
                continue
            acc = torch.zeros((b, c1 - c0))
            for u in range(max(u0, ct * count), min(u1, (ct + 1) * count)):
                j = u - ct * count
                r = rows[j * g:(j + 1) * g]
                acc = acc + (h[j * g:(j + 1) * g].T.double()
                             @ wd[r, c0:c1].double()).float()
            y[:, c0:c1] = y[:, c0:c1] + acc
    return y


def _reference(w, x, sel, count, g, act, thr, xdt):
    jw = [jnp.asarray(w[n]) if w[n] is not None else None for n in MATS]
    return np.asarray(jops.fused_sparse_mlp(
        jnp.asarray(x).astype(xdt), *jw, jnp.asarray(sel),
        jnp.asarray(count, jnp.int32), group_size=g, activation=act,
        fatrelu_threshold=thr, interpret=True))


def _near_boundary_allowance(w, xt, sel, count, g, act_kind, thr, gated):
    """What h's bf16 rounding may move y by where h's exact value lies
    within float rounding of a bf16 rounding boundary (the two sides may
    round it to neighbouring bf16 values); at most 2 such h."""
    rows = (sel[:count][:, None] * g + np.arange(g)[None, :]).reshape(-1)
    xb = np.asarray(xt.float(), np.float64)
    gx = xb @ w["wg_t"][rows].astype(np.float64).T
    ga = np.maximum(gx, 0) if act_kind == 0 else np.where(gx > thr, gx, 0)
    h = ga * (xb @ w["wu_t"][rows].astype(np.float64).T) if gated else ga
    hb = torch.from_numpy(h).float().to(torch.bfloat16).double().numpy()
    ulp = np.ldexp(1.0, np.frexp(hb)[1] - 8)    # bf16's spacing at hb
    frac = (h - hb) / ulp                       # in [-1/2, 1/2] ulp
    near = (np.abs(np.abs(frac) - 0.5) * ulp <= 1e-5 * np.abs(h)) & (h != 0)
    assert near.sum() <= 2, f"{near.sum()} h near a rounding boundary"
    return (near * ulp) @ np.abs(w["wd_t"][rows].astype(np.float64))


# name: (seed, B, d, k, G, gated, activation, threshold, count: "full",
# "short" (a third) or "zero")
CASES = {
    "B=4 gated relu G=8": (2, 4, 256, 512, 8, True, "relu", 0.0, "full"),
    "B=1 gated relu G=8 d=64": (3, 1, 64, 512, 8, True, "relu", 0.0, "full"),
    "B=16 gated relu G=8 short count": (4, 16, 256, 512, 8, True, "relu",
                                        0.0, "short"),
    "B=5 ungated relu G=1 d=100": (5, 5, 100, 256, 1, False, "relu", 0.0,
                                   "full"),
    "B=5 gated fatrelu G=16": (6, 5, 192, 768, 16, True, "fatrelu", 0.05,
                               "full"),
    "B=4 ungated fatrelu G=8 d=100": (7, 4, 100, 512, 8, False, "fatrelu",
                                      0.0, "full"),
    "B=16 gated relu G=1 d=64": (8, 16, 64, 256, 1, True, "relu", 0.0,
                                 "full"),
    "B=4 gated relu G=8 zero count": (9, 4, 256, 512, 8, True, "relu", 0.0,
                                      "zero"),
    "B=16 gated relu G=16 d=1100 (two rounds of 1024)": (
        10, 16, 1100, 256, 16, True, "relu", 0.0, "full"),
    "B=4 gated fatrelu G=8 d=4100 (two rounds of 4096)": (
        11, 4, 4100, 128, 8, True, "fatrelu", 0.05, "full"),
    "B=1 ungated relu G=16 d=4100 short count": (
        12, 1, 4100, 256, 16, False, "relu", 0.0, "short"),
}


def _check(case, xname, round_h=True):
    seed, b, d, k, g, gated, act, thr, which = CASES[case]
    w, x, sel, count = _case(seed, b, d, k, g, gated, which == "short")
    if which == "zero":
        count = 0
    bf16 = xname == "bfloat16"
    y_ref = _reference(w, x, sel, count, g, act, thr,
                       jnp.bfloat16 if bf16 else jnp.float32)
    xt = torch.from_numpy(x)
    if bf16:
        xt = xt.to(torch.bfloat16)
    tw = {n: torch.from_numpy(v) if v is not None else None
          for n, v in w.items()}
    pl = KF.decode_plan(b, d, len(sel) * g, g, SMS, H100)
    act_kind = 1 if (act == "fatrelu" or thr > 0) else 0
    y = emulate_decode(xt, *[tw[n] for n in MATS], torch.from_numpy(sel),
                       count, group_size=g, act_kind=act_kind, thr=thr,
                       pl=pl, round_h=round_h).numpy()
    allow = np.zeros_like(y)
    if bf16 and round_h and count:
        allow = _near_boundary_allowance(w, xt, sel, count, g, act_kind,
                                         thr, gated)
    err = np.abs(y - y_ref) - allow
    return bool((err <= TOL["atol"] + TOL["rtol"] * np.abs(y_ref)).all()), \
        float(np.abs(y - y_ref).max())


@pytest.mark.parametrize("xname", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_decode_order_matches_reference_kernel(case, xname):
    ok, err = _check(case, xname)
    assert ok, f"{case} x={xname}: max |y - y_ref| {err:.3e}"


@pytest.mark.parametrize("case", ["B=4 gated relu G=8",
                                  "B=16 gated relu G=8 short count"])
def test_unrounded_h_fails_the_same_check(case):
    """With bf16 x the reference rounds h to bf16 before the down
    projection; h left in float32 is ~2^-9 of h off, a different function,
    which the check above refuses."""
    ok, err = _check(case, "bfloat16", round_h=False)
    assert not ok and err > 1e-4, f"unrounded h within tolerance: {err:.3e}"


# -------------------------------------------------------------- the plan --

def test_plan_main_shape():
    """B=4 at d=4096 over 288 groups of 8 rows: one round of 4096 columns,
    3 stages of a row of Wg and of Wu (32 KB each), a chain row of 2 x 4
    carried and 8 x 2 x 4 warp sums, 18 rows a chain batch, 2 blocks a SM
    (264), 8 tiles of 512 columns for down.  B=16: rounds of 1024 columns
    (8 KB stages), 5 of down's 16.5 KB stages in the ring, 14 rows a chain
    batch; B=8: rounds of 2048."""
    pl = KF.decode_plan(4, 4096, 2304, 8, SMS, H100)
    assert (pl.nb, pl.round_cols, pl.rounds) == (4, 4096, 1)
    assert pl.stage_bytes == 2 * 4096 * 4
    assert pl.down_stage_bytes == 8 * (512 + 4) * 4
    assert pl.ring == 3 * pl.stage_bytes
    assert pl.row_floats == 9 * 8 and pl.chain_rows == 18
    assert pl.smem_bytes == pl.ring + 18 * pl.row_floats * 4
    assert (pl.grid, pl.tiles) == (264, 8)
    assert pl.h_floats == 2304 * 4 and pl.part_floats == 272 * 4 * 512
    p16 = KF.decode_plan(16, 4096, 2304, 8, SMS, H100)
    assert (p16.nb, p16.round_cols, p16.rounds) == (16, 1024, 4)
    assert p16.stage_bytes == 8192
    assert p16.down_stage_bytes == 8 * (512 + 16) * 4
    assert p16.ring == 5 * p16.down_stage_bytes and p16.grid == 264
    assert p16.chain_rows == 14
    p8 = KF.decode_plan(8, 4096, 2304, 8, SMS, H100)
    assert (p8.nb, p8.round_cols, p8.rounds, p8.grid) == (8, 2048, 2, 264)


@pytest.mark.parametrize("b", [1, 4, 5, 8, 9, 16])
@pytest.mark.parametrize("d", [64, 100, 4096, 4100, 5120, 8192])
def test_plan_rounds_cover_d(b, d):
    """Every thread holds 64 x values (its columns of a round times nb
    tokens); the rounds cover d; a stage holds a round's two row pieces,
    and the ring at least two of either stage; d of any width plans."""
    pl = KF.decode_plan(b, d, 2304, 8, SMS, H100)
    assert pl.nb >= b and pl.round_cols * pl.nb == KF.D_THREADS * 64
    assert (pl.rounds - 1) * pl.round_cols < d <= pl.rounds * pl.round_cols
    assert pl.stage_bytes == 2 * min(d, pl.round_cols) * 4
    assert pl.ring >= 2 * max(pl.stage_bytes, pl.down_stage_bytes)
    assert pl.smem_bytes <= KF.SMEM_LIMIT


@pytest.mark.parametrize("b,d,cap_rows,g", [
    (4, 4096, 2304, 8), (16, 4096, 2304, 8), (5, 100, 64, 1),
    (16, 1100, 64, 16), (1, 8192, 512, 8), (4, 5120, 2768, 8)])
def test_plan_covers_rows_and_units_once(b, d, cap_rows, g):
    """For every count (every 8th for the large capacities): gate/up's
    block ranges partition the selected rows in order; down's units
    (tile, group) are covered once, a block's run in a tile is held by the
    blocks q_owner finds for the tile's first and last unit, and the runs'
    slots (block + tile) are distinct and within part_floats."""
    pl = KF.decode_plan(b, d, cap_rows, g, SMS, H100)
    assert pl.tiles == -(-d // KF.D_TILE)
    n_sel = cap_rows // g
    for count in range(0, n_sel + 1, 1 if n_sel <= 64 else 8):
        nrows = count * g
        spans = [KF.q_range(nrows, pl.grid, i) for i in range(pl.grid)]
        assert spans[0][0] == 0 and spans[-1][1] == nrows
        assert all(a[1] == c[0] for a, c in zip(spans, spans[1:]))
        n_units = pl.tiles * count
        cover = np.zeros((pl.tiles, count), np.int32)
        slots = set()
        for i in range(pl.grid):
            u0, u1 = KF.q_range(n_units, pl.grid, i)
            for u in range(u0, u1):
                ct, j = divmod(u, count)
                cover[ct, j] += 1
                assert KF.q_owner(u, n_units, pl.grid) == i
                slots.add((i + ct, i))
        assert (cover == 1).all()
        assert len({s for s, _ in slots}) == len(slots)
        assert all(s < pl.part_floats // (pl.nb * KF.D_TILE)
                   for s, _ in slots)
        assert nrows * pl.nb <= pl.h_floats


@pytest.mark.parametrize("b", [4, 16])
@pytest.mark.parametrize("count", [288, 96])
def test_plan_no_idle_block_at_main_shape(b, count):
    """At the main shape every block has 8-9 (a third: 2-3) rows of
    gate/up and 8-9 (2-3) down units: max over mean within 1.04."""
    pl = KF.decode_plan(b, 4096, 2304, 8, SMS, H100)
    rows = [np.subtract(*KF.q_range(count * 8, pl.grid, i)[::-1])
            for i in range(pl.grid)]
    units = [np.subtract(*KF.q_range(pl.tiles * count, pl.grid, i)[::-1])
             for i in range(pl.grid)]
    for n in (rows, units):
        assert min(n) >= 1 and max(n) - min(n) <= 1
        assert max(n) / np.mean(n) < 1.04


@pytest.mark.parametrize("occ", [1, 2, 3, 8])
def test_plan_grid_resident_and_smem_fits(occ):
    for b in (1, 4, 9, 16):
        for d, g in ((4096, 8), (100, 1), (8192, 16), (5120, 32)):
            pl = KF.decode_plan(b, d, 64 * g, g, SMS,
                                lambda nb, smem: occ)
            assert pl.grid == min(occ, KF.MAX_BLOCKS_PER_SM) * SMS
            assert pl.smem_bytes == pl.ring \
                + pl.chain_rows * pl.row_floats * 4
            assert pl.chain_rows >= 1
            assert pl.smem_bytes <= KF.SMEM_LIMIT and pl.nb >= b
            # two blocks of the H100 fit on one SM at every shape
            assert H100(pl.nb, pl.smem_bytes) == 2


def test_plan_raises_past_its_limits():
    with pytest.raises(RuntimeError, match="fused_sparse_mlp: .*"
                       "cannot be scheduled"):
        KF.decode_plan(4, 4096, 2304, 8, SMS, lambda *a: 0)
    with pytest.raises(ValueError, match="bad shape"):
        KF.decode_plan(17, 4096, 2304, 8, SMS, H100)
    with pytest.raises(ValueError, match="bad shape"):
        KF.decode_plan(0, 4096, 2304, 8, SMS, H100)
    with pytest.raises(ValueError, match="bad shape"):
        KF.decode_plan(4, 4098, 2304, 8, SMS, H100)
    with pytest.raises(ValueError, match="bad shape"):
        KF.decode_plan(4, 4096, 2300, 8, SMS, H100)
    with pytest.raises(ValueError, match="bad shape"):
        KF.decode_plan(4, 4096, 0, 8, SMS, H100)


def test_decode_launcher_refuses_cpu_tensors():
    """The launcher takes CUDA tensors only: on the CPU the ops layer runs
    the plain version, and the launcher is never reached."""
    x = torch.zeros((4, 32))
    w = torch.zeros((64, 32))
    sel = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        KF.fused_sparse_mlp(x, w, w, w, sel, torch.tensor(2), group_size=8)
