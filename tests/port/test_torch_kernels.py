"""The fused value+gradient kernel's plain version == the JAX package's
Pallas kernel and XLA aggregator.

- f32 against the Pallas kernel in interpret mode, at the Pallas test's
  unaligned n=700, d=37 and its tolerances (value rtol 1e-5, gradient rtol
  and atol 1e-4: both sides sum in f32 in different orders);
- f64 against both aggregators at rtol 1e-12 (same arithmetic in f64).
The CUDA kernel itself runs only on the card (test_torch_cuda.py and
chip_smoke.py); here the wrapper must take the plain version for CPU
tensors and launch nothing.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_ml_tpu.ops import aggregators as jagg
from photon_ml_tpu.ops import losses as JL
from photon_ml_tpu.ops.pallas_kernels import fused_value_and_gradient as pallas_fvg
from photon_ml_tpu_torch.ops import aggregators as tagg
from photon_ml_tpu_torch.ops import hopper_kernels as hk
from photon_ml_tpu_torch.ops import losses as TL

NAMES = sorted(TL.BY_NAME)


def _inputs(with_wo, dtype, seed=7, n=700, d=37):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(dtype)
    y = (rng.uniform(size=n) > 0.5).astype(dtype)
    c = (rng.normal(size=d) * 0.1).astype(dtype)
    w = rng.uniform(0.5, 2.0, size=n).astype(dtype) if with_wo else None
    o = (rng.normal(size=n) * 0.1).astype(dtype) if with_wo else None
    return x, y, c, w, o


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("with_wo", [False, True], ids=["plain", "w+o"])
@pytest.mark.parametrize("name", NAMES)
def test_plain_matches_pallas_interpret_f32(name, with_wo):
    x, y, c, w, o = _inputs(with_wo, np.float32)
    v_j, g_j = pallas_fvg(JL.BY_NAME[name], _j(x), _j(y), _j(c), _j(w), _j(o), True)
    v_t, g_t = hk.fused_value_and_gradient_plain(
        TL.BY_NAME[name], _t(x), _t(y), _t(c), _t(w), _t(o))
    assert v_t.dtype == g_t.dtype == torch.float32
    np.testing.assert_allclose(v_t.item(), float(v_j), rtol=1e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("with_wo", [False, True], ids=["plain", "w+o"])
@pytest.mark.parametrize("name", NAMES)
def test_plain_matches_aggregators_f64(name, with_wo):
    x, y, c, w, o = _inputs(with_wo, np.float64)
    v_t, g_t = hk.fused_value_and_gradient_plain(
        TL.BY_NAME[name], _t(x), _t(y), _t(c), _t(w), _t(o))
    v_j, g_j = jagg.value_and_gradient(JL.BY_NAME[name], _j(x), _j(y), _j(c),
                                       weights=_j(w), offsets=_j(o))
    v_a, g_a = tagg.value_and_gradient(TL.BY_NAME[name], _t(x), _t(y), _t(c),
                                       weights=_t(w), offsets=_t(o))
    for v, g in ((v_j, g_j), (v_a, g_a)):
        np.testing.assert_allclose(v_t.item(), float(v), rtol=1e-12)
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("with_wo", [False, True, "mask+shift"],
                         ids=["plain", "w+o", "mask+shift"])
def test_cpu_wrapper_runs_plain_and_launches_nothing(with_wo):
    x, y, c, w, o = _inputs(bool(with_wo), np.float32)
    m = s = None
    if with_wo == "mask+shift":
        m = _t((np.arange(len(y)) % 3 != 0).astype(np.float32))
        s = _t(np.linspace(-1, 1, len(c)).astype(np.float32))
    before = hk.LAUNCHES
    v, g = hk.fused_value_and_gradient(TL.LOGISTIC, _t(x), _t(y), _t(c), _t(w), _t(o), m, s)
    v_p, g_p = hk.fused_value_and_gradient_plain(
        TL.LOGISTIC, _t(x), _t(y), _t(c), _t(w), _t(o), m, s)
    assert hk.LAUNCHES == before
    assert v.item() == v_p.item()
    assert torch.equal(g, g_p)


def test_wrapper_refuses_other_devices():
    x = torch.empty((4, 3), device="meta")
    v = torch.empty((4,), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        hk.fused_value_and_gradient(TL.LOGISTIC, x, v, torch.empty(3, device="meta"))


def _spans(addr, count):
    """Vectorised mirror of span_of() in the CUDA source: for spans of
    `count` floats at byte address `addr`, (phase, head, tail, bytes) of
    the 16-byte aligned interior the bulk copy takes."""
    lo = addr
    hi = addr + 4 * count
    a = (lo + 15) & ~15
    b = hi & ~15
    has = b > a
    phase = (lo >> 2) & 3
    head = np.where(has, (a - lo) >> 2, count)
    tail = np.where(has, (b - lo) >> 2, count)
    return phase, head, tail, np.where(has, b - a, 0)


PLAN_SMS = 132  # an H100 SXM


@pytest.mark.parametrize("misaligned", [False, True], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("d", [1, 3, 37, 124, 128, 2048, hk.D_MAX])
def test_width_limit_fits_shared_memory(d, misaligned):
    """Replay plan_fused as the kernel walks it, for X, y, w, o and the row
    mask m starting on 16-byte boundaries or 4 bytes past one (a row-slice
    view)."""
    skew = 4 if misaligned else 0
    bases = [(1 << 30) + skew, (1 << 33) + skew, (1 << 34) + skew, (1 << 35) + skew,
             (1 << 36) + skew]
    for n in (0, 1, 3, 700, 1_643_520):
        plan = hk.plan_fused(n, d, PLAN_SMS)
        lay, rows = plan.layout, plan.rows_per_tile
        assert lay.bytes <= hk.MAX_SMEM < 232_448
        assert lay.bytes == hk.smem_layout(d, rows, plan.stages).bytes
        assert plan.stages >= 2
        assert plan.grid <= PLAN_SMS * hk.BLOCKS_PER_SM
        assert plan.acc_per_thread * hk.CONSUMERS >= d
        assert plan.acc_per_thread == 1 or d > hk.CONSUMERS
        for off in (lay.stage_x, lay.stage_v, lay.stage, lay.c, lay.s, lay.red, lay.bars):
            assert (4 * off) % 16 == 0

        # the tiles of every block, in the kernel's order: b, b + grid, ...
        starts = np.concatenate([np.arange(b * rows, n, plan.grid * rows, dtype=np.int64)
                                 for b in range(plan.grid)])
        assert plan.grid == 1 or len(starts) >= plan.grid  # no idle block
        starts.sort()
        counts = np.minimum(rows, n - starts)
        # rows [0, n) exactly once
        assert int(counts.sum()) == n
        if n:
            assert starts[0] == 0 and np.all(starts[1:] == starts[:-1] + counts[:-1])
            assert np.all(counts >= 1)

        arrays = [(bases[0] + 4 * starts * d, counts * d, 0, lay.stage_x)]
        arrays += [(base + 4 * starts, counts, lay.stage_x + k * lay.stage_v, lay.stage_v)
                   for k, base in enumerate(bases[1:])]
        for addr, count, offset, room in arrays:
            phase, head, tail, nbytes = _spans(addr, count)
            assert np.all(phase + count <= room)
            copied = nbytes > 0
            # bulk copies: 16-byte source, destination (any stage) and size
            assert np.all((addr + 4 * head)[copied] % 16 == 0)
            assert np.all((4 * (offset + phase + head))[copied] % 16 == 0)
            assert np.all(nbytes % 16 == 0)
            # the rest is at most a few floats each side, loaded by the
            # 256 consumer threads
            assert np.all(4 * head + nbytes + 4 * (count - tail) == 4 * count)
            assert np.all(np.where(copied, head, 0) <= 3)
            assert np.all(np.where(copied, count - tail, 0) <= 3)
            assert np.all(np.where(copied, 0, count) <= 7)
            if not misaligned and offset == 0 and d % 4 == 0:
                assert np.all(head == np.where(copied, 0, count))


def test_plan_refuses_widths_it_cannot_take():
    assert hk.D_MAX >= 6428
    for d in (0, hk.D_MAX + 1):
        with pytest.raises(ValueError, match="d <="):
            hk.plan_fused(10, d, PLAN_SMS)


def test_plan_constants_match_the_cuda_source():
    src = (Path(hk.__file__).resolve().parent.parent / "csrc"
           / "fused_value_and_gradient.cu").read_text()
    assert f"constexpr int kConsumers = {hk.CONSUMERS};" in src
    assert "constexpr int kMaxSmem = 232448 - 1024;" in src
    assert hk.MAX_SMEM == 232_448 - 1024
    for a in hk.ACC_SIZES:
        assert f"case {a}: return launch<LOSS, {a}>" in src
    assert len(re.findall(r"case \d+: return launch<LOSS", src)) == len(hk.ACC_SIZES)


def test_kahan_pair_variant_applies_to_the_source():
    """scripts/kahan_pair.py builds a plain-sum variant of the kernel by
    replacing KahanSum::add; the text it replaces is in the source once."""
    import importlib.util
    root = Path(hk.__file__).resolve().parents[2]
    spec = importlib.util.spec_from_file_location("kahan_pair", root / "scripts" / "kahan_pair.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    src = (root / "photon_ml_tpu_torch" / "csrc" / "fused_value_and_gradient.cu").read_text()
    assert src.count(mod.KAHAN) == 1
    assert src.replace(mod.KAHAN, mod.PLAIN).count("s += v;") == 1


# --- the candidate-lanes kernel ----------------------------------------------

def _lane_inputs(n=300, d=9, lanes=5, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = (rng.uniform(size=n) > 0.5).astype(np.float64)
    c = rng.normal(size=(lanes, d)) * 0.2
    w = rng.uniform(0.5, 2.0, size=n)
    o = rng.normal(size=(lanes, n)) * 0.1
    m = (rng.uniform(size=n) > 0.3).astype(np.float64)
    o[:, np.flatnonzero(m == 0)[:2]] = np.inf      # dropped by the mask
    s = rng.normal(size=d) * 0.3
    return [torch.from_numpy(a) for a in (x, y, c, w, o, m, s)]


@pytest.mark.parametrize("inputs", ["plain", "w+o", "mask+shift", "all"])
@pytest.mark.parametrize("name", NAMES)
def test_lanes_plain_equals_single_plain_per_lane(name, inputs):
    """Lane k of the lanes function == the single kernel's function at
    c_k, offsets o_k, with the shift b_k = -(c_k . s) and grad - s swl."""
    loss = TL.BY_NAME[name]
    x, y, c, w, o, m, s = _lane_inputs()
    use_wo = inputs in ("w+o", "all")
    use_ms = inputs in ("mask+shift", "all")
    if not use_ms:
        o = torch.where(torch.isinf(o), torch.zeros_like(o), o)
    w_, o_ = (w, o) if use_wo else (None, None)
    m_, s_ = (m, s) if use_ms else (None, None)
    v, g, swl = hk.fused_value_and_gradient_lanes_plain(
        loss, x, y, c, w_, o_, m_, None if s_ is None else -(c @ s_))
    assert v.shape == swl.shape == (c.shape[0],) and g.shape == c.shape
    for k in range(c.shape[0]):
        v1, g1 = hk.fused_value_and_gradient_plain(
            loss, x, y, c[k], w_, None if o_ is None else o_[k], m_, s_)
        np.testing.assert_allclose(v[k].item(), v1.item(), rtol=1e-12)
        gk = g[k] if s_ is None else g[k] - s_ * swl[k]
        np.testing.assert_allclose(gk.numpy(), g1.numpy(), rtol=1e-12, atol=1e-12)
    assert torch.isfinite(v).all() and torch.isfinite(g).all()


def test_lanes_wrapper_on_the_cpu_runs_plain_and_launches_nothing():
    x, y, c, w, o, m, s = (t.float() for t in _lane_inputs())
    b = -(c @ s)
    before = hk.LANES_LAUNCHES
    got = hk.fused_value_and_gradient_lanes(TL.LOGISTIC, x, y, c, w, o, m, b)
    want = hk.fused_value_and_gradient_lanes_plain(TL.LOGISTIC, x, y, c, w, o, m, b)
    assert hk.LANES_LAUNCHES == before
    assert all(torch.equal(a, b_) for a, b_ in zip(got, want))
    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        hk.fused_value_and_gradient_lanes(TL.LOGISTIC, meta, torch.empty(4, device="meta"),
                                          torch.empty((2, 3), device="meta"))


LANE_WIDTHS = (1, 3, 5, 7, 8, 9, 31, 33, 37, 124, 256, 257, 512, 513, 1024, 1500, 2048)


@pytest.mark.parametrize("d", LANE_WIDTHS)
def test_lanes_plans_fit_shared_memory(d):
    """Replay plan_lanes as the kernel walks it: every plan fits shared
    memory, its tiles hold a multiple of 8 rows (so tiles of an aligned X
    stay 16-byte aligned) with two or more ring stages, every shared array
    starts on 16 bytes, each stage keeps a span of room for X and for each
    of O's K runs in their [K, n] layout (a run's phase at most 3 floats),
    the warps' gradient sums fit in the ring's place, the instantiated
    slots cover every warp's run of units, and the blocks' tiles cover the
    rows exactly once."""
    top = hk.max_lanes(d)
    assert top in (16, 8)
    for lanes in range(1, top + 1):
        nt = hk.lane_tiles(lanes)
        assert 8 * nt >= lanes
        for n in (0, 1, 3, 700, 950_051):
            plan = hk.plan_lanes(n, d, lanes, PLAN_SMS)
            lay, rows = plan.layout, plan.rows_per_tile
            assert lay == hk.lanes_smem_layout(d, lanes, rows, plan.stages)
            assert lay.bytes <= hk.MAX_SMEM and plan.stages >= 2
            assert rows in hk.LANES_ROWS and rows % 8 == 0
            assert plan.slots in hk.LANES_SLOT_SIZES[nt]
            assert plan.slots >= hk.grad_slots(d, rows)
            for off in (lay.stage_x, lay.stage_v, lay.stage, lay.cf, lay.zp, lay.sf,
                        lay.vs, lay.bars):
                assert off % 4 == 0
            assert lay.stage_x >= rows * d + 3 and lay.stage_v >= rows + 3
            assert lay.stage == lay.stage_x + (3 + lanes) * lay.stage_v
            assert lay.cf >= plan.stages * lay.stage
            assert lay.cf >= hk.LANES_WARPS * hk.grad_slots(d, rows) * nt * 128
            assert lay.bytes == 4 * lay.bars + 16 * plan.stages
            assert 1 <= plan.grid <= PLAN_SMS * plan.blocks_per_sm
            tiles = -(-n // rows)
            covered = sum(min(rows, n - t * rows) for b in range(plan.grid)
                          for t in range(b, tiles, plan.grid))
            assert covered == n
    if top < hk.LANES_MAX:
        with pytest.raises(ValueError, match="lanes"):
            hk.plan_lanes(10, d, top + 1, PLAN_SMS)


@pytest.mark.parametrize("d", LANE_WIDTHS)
def test_lanes_work_split_covers_every_product_once(d):
    """Replay how the kernel deals a tile's work to its 16 warps, as its
    source computes it: the margins' (m-tile of 16 rows, chunk of 8
    columns) pairs and the gradient's (m-tile of 16 columns, chunk of 8
    rows) units each taken by exactly one warp; every warp's slot index
    below grad_slots; and the block's final sum finds each gradient m-tile
    in the slots of exactly the warps whose runs reach it."""
    W = hk.LANES_WARPS
    for lanes in (1, hk.max_lanes(d)):
        rows = hk.plan_lanes(950_051, d, lanes, PLAN_SMS).rows_per_tile
        for tile_rows in sorted({rows, *(r for r in hk.LANES_ROWS if r <= rows)}):
            mtiles, split = hk.margin_tiles(tile_rows), hk.margin_split(tile_rows)
            chunks = -(-d // 8)
            margins = []
            for w in range(hk.LANES_WARPS):
                if mtiles < hk.LANES_WARPS:
                    firsts, part = [w % mtiles], w // mtiles
                else:
                    firsts, part = [w + W * i for i in range(mtiles // W)], 0
                lo, hi = part * chunks // split, (part + 1) * chunks // split
                margins += [(mt, c) for mt in firsts for c in range(lo, hi)]
            assert sorted(margins) == [(mt, c) for mt in range(mtiles) for c in range(chunks)]
            assert split * mtiles <= W or mtiles % W == 0
            qn, slots = -(-tile_rows // 8), hk.grad_slots(d, tile_rows)
            units = -(-d // 16) * qn
            taken, reach = [], {}
            for w in range(hk.LANES_WARPS):
                lo, hi = w * units // W, (w + 1) * units // W
                for i in range(slots + 1):
                    mt = lo // qn + i
                    q0, q1 = max(lo - mt * qn, 0), min(hi - mt * qn, qn)
                    if q0 < q1:
                        assert i < slots
                        taken += [(mt, q) for q in range(q0, q1)]
                        reach.setdefault(mt, []).append((w, i))
            assert sorted(taken) == [(mt, q) for mt in range(-(-d // 16)) for q in range(qn)]
            for mt, found in reach.items():
                final = [(w, mt - (w * units // W) // qn) for w in range(W)
                         if (w + 1) * units // W > w * units // W
                         and w * units // W < (mt + 1) * qn and (w + 1) * units // W > mt * qn]
                assert final == found


def test_lanes_width_limit_is_no_narrower_than_the_first_kernels():
    """max_lanes(d) at every d up to 2,048 is at least what the first lanes
    kernel took (16 lanes to d = 512, 8 to 1,024, 4 to 2,048); past 2,048
    the lanes kernel takes none, and a dense fixed effect runs the single
    kernel per lane (ops/lanes.py)."""
    for d in range(1, 2049):
        assert hk.max_lanes(d) >= (16 if d <= 512 else 8 if d <= 1024 else 4), d
    for d in (2049, 3000, 4096, hk.D_MAX):
        assert hk.max_lanes(d) == 0


def test_lanes_plan_refuses_what_the_kernel_cannot_take():
    assert hk.max_lanes(2049) == 0
    for bad in ((10, 31, 0), (10, 31, 17), (10, 2049, 1), (10, 2048, 9)):
        with pytest.raises(ValueError):
            hk.plan_lanes(*bad, PLAN_SMS)
    for rows, stages in ((48, None), (128, 9), (128, 1)):   # no such tile; no such ring
        with pytest.raises(ValueError):
            hk.plan_lanes(1000, 31, 16, PLAN_SMS, rows=rows, stages=stages)


def test_lanes_constants_match_the_cuda_source():
    src = (Path(hk.__file__).resolve().parent.parent / "csrc"
           / "fused_value_and_gradient_lanes.cu").read_text()
    assert f"constexpr int kConsumers = {hk.LANES_CONSUMERS};" in src
    assert "constexpr int kThreads = kConsumers + 32;" in src
    assert f"constexpr int kMaxLanes = {hk.LANES_MAX};" in src
    assert "constexpr int kMaxSmem = 232448 - 1024;" in src
    # every (n-tiles, slots) instantiation, with and without a lane mask
    for nt, sizes in hk.LANES_SLOT_SIZES.items():
        for size in sizes:
            assert f"case {size}: return launch<{nt}, {size}, LM>" in src
    assert len(re.findall(r"case \d+: return launch<", src)) == \
        sum(map(len, hk.LANES_SLOT_SIZES.values()))
    assert "dispatch<true>(" in src and "dispatch<false>(" in src
    # the device function's name tells it apart from the single kernel's
    # (chip_smoke.py's KERNEL_NAMES match profiles by substring)
    assert "lanes_value_gradient(const Args a)" in src and "fvg_" not in src
