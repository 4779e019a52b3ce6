"""PaddedSparse and the sparse products == the JAX package's, float64, on
the CPU; the sparse kernels' plain versions and launch plans.

- Layouts (from_dense, from_scipy with and without the column view,
  with_csc, pad_rows, densify) equal the JAX package's arrays element for
  element.
- matvec, rmatvec and sq_rmatvec equal JAX's at rtol 1e-12, with an atol
  of 1e-12 times the largest magnitude of the result (an element whose
  terms cancel to ~0 is held at the scale of the vector, since JAX's
  chunked prefix-scan differences carry rounding of that scale): on the
  ELL layout alone, on the column view built from ELL (padding slots in
  column 0), on scipy's exact CSC, on a stream of more than 65,536
  nonzeros (JAX's chunk length, so its multi-chunk path runs), with empty
  rows and columns, and with a dense intercept column.  JAX runs
  in-process: these are tiny jitted gathers.
- The kernels' plain versions equal a dense reference (rtol 1e-12).
- The kernels' launch plans are pure Python: replayed here at bench
  configs 6 and 7's shapes; kernel A's decomposition (tiles of whole
  rows, staggered slot order, unrolled partial sums, the value's block
  order; or P lanes per row) replayed in float32 against the plain
  margins and loss pass; kernel B's (tile map, runs split at column
  ends, in-tile segmented scan, spanning-column finish) against the
  plain column sum.
- Kernel B's tile map is built with the column view and carried with it.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from photon_ml_tpu.ops import features as JF
from photon_ml_tpu_torch.convert import padded_sparse_from_numpy
from photon_ml_tpu_torch.ops import features as TF
from photon_ml_tpu_torch.ops import hopper_kernels as hk
from photon_ml_tpu_torch.ops import losses as TL
from photon_ml_tpu_torch.ops import sparse_kernels as sk


def _matrix(case: str, seed: int = 3) -> np.ndarray:
    """Dense [n, d] float64 with the named structure."""
    rng = np.random.default_rng(seed)
    if case == "stream_65536":
        n, d, density = 3000, 400, 0.06       # ~72k nonzeros
    elif case == "intercept":
        n, d, density = 900, 250, 0.02
    else:
        n, d, density = 700, 37, 0.12
    x = rng.normal(size=(n, d)) * (rng.uniform(size=(n, d)) < density)
    if case in ("empty", "ell", "csc_from_ell", "csc_scipy"):
        x[[0, 5, 699]] = 0.0                  # empty rows, one of them last
        x[:, [0, 7, 36]] = 0.0                # empty columns, one of them last
    if case == "intercept":
        x[:, -1] = 1.0
    return x


def _both(case: str):
    """(dense x, JAX PaddedSparse, port PaddedSparse with the same arrays)."""
    x = _matrix(case)
    csr = sp.csr_matrix(x)
    if case == "ell" or case == "empty":
        j = JF.PaddedSparse.from_scipy(csr)
    elif case == "csc_from_ell":
        j = JF.PaddedSparse.from_scipy(csr).with_csc()
    else:
        j = JF.PaddedSparse.from_scipy(csr, with_csc=True)
    arr = lambda a: None if a is None else np.asarray(a)
    t = padded_sparse_from_numpy(arr(j.indices), arr(j.values), j.num_cols, arr(j.csc_row),
                                 arr(j.csc_val), arr(j.csc_end), device="cpu")
    return x, j, t


PRODUCT_CASES = ["ell", "csc_from_ell", "csc_scipy", "stream_65536", "empty", "intercept"]


@pytest.mark.parametrize("product", ["matvec", "rmatvec", "sq_rmatvec"])
@pytest.mark.parametrize("case", PRODUCT_CASES)
def test_products_match_jax(case, product):
    x, j, t = _both(case)
    assert t.has_csc == j.has_csc == (case not in ("ell", "empty"))
    if case == "stream_65536":
        assert int(np.asarray(j.csc_end)[-1]) > 65536
    rng = np.random.default_rng(11)
    arg = rng.normal(size=x.shape[1] if product == "matvec" else x.shape[0])
    want = np.asarray(getattr(JF, product)(j, jnp.asarray(arg)))
    got = getattr(TF, product)(t, torch.from_numpy(arg))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    dense = {"matvec": lambda: x @ arg, "rmatvec": lambda: x.T @ arg,
             "sq_rmatvec": lambda: (x * x).T @ arg}[product]()
    np.testing.assert_allclose(got.numpy(), dense, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


LAYOUT_CASES = ["ell", "empty", "intercept", "stream_65536"]


def _assert_same(t, j):
    assert t.num_cols == j.num_cols and t.has_csc == j.has_csc
    for name in ("indices", "values", "csc_row", "csc_val", "csc_end"):
        a, b = getattr(t, name), getattr(j, name)
        if b is None:
            assert a is None, name
            continue
        b = np.array(b)
        assert a.dtype == torch.from_numpy(b).dtype, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


@pytest.mark.parametrize("case", LAYOUT_CASES)
def test_from_dense_and_with_csc_match_jax(case):
    x = _matrix(case)
    j = JF.PaddedSparse.from_dense(x)
    t = TF.PaddedSparse.from_dense(x, device="cpu")
    _assert_same(t, j)
    _assert_same(t.with_csc(), j.with_csc())
    _assert_same(t.with_csc().without_csc(), j)
    # ELL padding slots stay in column 0's segment of the view
    pad = int((np.asarray(j.values) == 0).sum())
    assert int(t.with_csc().csc_end[1]) == int((x[:, 0] != 0).sum()) + pad


@pytest.mark.parametrize("with_csc", [False, True], ids=["ell", "csc"])
@pytest.mark.parametrize("case", LAYOUT_CASES)
def test_from_scipy_matches_jax(case, with_csc):
    csr = sp.csr_matrix(_matrix(case))
    _assert_same(TF.PaddedSparse.from_scipy(csr, with_csc=with_csc, device="cpu"),
                 JF.PaddedSparse.from_scipy(csr, with_csc=with_csc))


@pytest.mark.parametrize("case", ["ell", "csc_scipy"])
def test_pad_rows_and_densify_match_jax(case):
    x, j, t = _both(case)
    _assert_same(TF.pad_rows(t, 3), JF.pad_rows(j, 3))
    assert TF.pad_rows(t, 0) is t
    np.testing.assert_array_equal(TF.densify(TF.pad_rows(t, 3)).numpy(),
                                  np.asarray(JF.densify(JF.pad_rows(j, 3))))
    np.testing.assert_array_equal(TF.densify(t).numpy(), x)


def test_to_keeps_int32_indices():
    t = TF.PaddedSparse.from_dense(_matrix("ell"), device="cpu").with_csc()
    f = t.to("cpu", torch.float32)
    assert f.dtype == torch.float32 and f.csc_val.dtype == torch.float32
    assert f.indices.dtype == f.csc_row.dtype == f.csc_end.dtype == torch.int32
    assert f.shape == t.shape and f.device == torch.device("cpu")


def test_as_feature_matrix_column_view_rule():
    """On the CPU the column view is attached from CSC_MIN_COLS columns up,
    as the JAX package attaches it; a matrix that has one keeps it."""
    narrow = sp.random(4, 50, density=0.3, format="csr", random_state=1)
    wide = sp.random(4, TF.CSC_MIN_COLS, density=1e-4, format="csr", random_state=1)
    assert not TF.as_feature_matrix(narrow, "cpu", torch.float64, with_csc=True).has_csc
    assert TF.as_feature_matrix(wide, "cpu", torch.float64, with_csc=True).has_csc
    assert not TF.as_feature_matrix(wide, "cpu", torch.float64).has_csc
    kept = TF.PaddedSparse.from_scipy(narrow, with_csc=True, device="cpu")
    assert TF.as_feature_matrix(kept, "cpu", torch.float64).has_csc
    for x in (narrow, wide):
        jx = JF.as_feature_matrix(x, with_csc=True)
        assert isinstance(jx, JF.PaddedSparse)
        assert jx.has_csc == TF.as_feature_matrix(x, "cpu", with_csc=True).has_csc


def test_cuda_matrix_without_column_view_raises_in_rmatvec(monkeypatch):
    """The dispatch on a CUDA PaddedSparse: without its column view the
    gradient products raise rather than scatter (device mocked: no card
    here)."""
    t = TF.PaddedSparse.from_dense(_matrix("ell"), device="cpu")
    u = torch.ones(t.shape[0], dtype=torch.float64)
    monkeypatch.setattr(TF.PaddedSparse, "is_cuda", property(lambda self: True))
    for product in (TF.rmatvec, TF.sq_rmatvec):
        with pytest.raises(ValueError, match="no column view"):
            product(t, u)


def test_unported_representations_name_their_roadmap_entry():
    """Every representation has its path now: a sparse COO tensor (the
    port's BCOO, item 24) is ingested as a PaddedSparse and its products
    run; a sparse layout other than COO and CSR raises TypeError naming
    the two."""
    coo = torch.sparse_coo_tensor([[0, 1], [1, 0]], [1.0, 2.0], (2, 2),
                                  check_invariants=True)
    ingested = TF.as_feature_matrix(coo, "cpu")
    assert isinstance(ingested, TF.PaddedSparse)
    assert torch.equal(TF.densify(ingested), coo.to_dense())
    assert torch.equal(TF.matvec(coo, torch.ones(2)), torch.tensor([1.0, 2.0]))
    for bad in (coo.to_dense().to_sparse_csc(), coo.to_dense().to_sparse_bsr((1, 1))):
        with pytest.raises(TypeError, match="sparse_coo or torch.sparse_csr"):
            TF.as_feature_matrix(bad, "cpu")
        with pytest.raises(TypeError, match="sparse_coo or torch.sparse_csr"):
            TF.matvec(bad, torch.ones(2))
    # the implicit Kronecker design (ported with the factored random
    # effects) passes through ingest
    kd = TF.KroneckerDesign(torch.ones(3, 2), torch.ones(3, 4))
    assert TF.as_feature_matrix(kd, "cpu", torch.float64).dtype == torch.float64
    # the values' storage types the kernels take (bf16 since item 25);
    # every other one is refused
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match=f"got {dtype}"):
            sk._check("values", torch.zeros(2, dtype=dtype), tuple(sk.VALUE_BYTES), (2,),
                      torch.device("cpu"))


def test_named_constraints_name_their_roadmap_entry():
    """Named constraints (ROADMAP.md queue A item 12) are ported: they
    normalize on construction, resolve through an index map into the
    positional box, and without a map the resolution names what is
    missing."""
    from photon_ml_tpu_torch.data.index_map import build_index_map
    from photon_ml_tpu_torch.optim.config import OptimizerConfig
    cfg = OptimizerConfig(constraints=({"name": "a", "term": "", "lowerBound": 0.0},))
    assert cfg.constraints == (("a", "", 0.0, float("inf")),)
    resolved = cfg.resolved_constraints(build_index_map([("a", ""), ("b", "")]))
    assert resolved.box_lower == (0.0, -float("inf"), -float("inf"))
    assert resolved.constraints is None
    with pytest.raises(ValueError, match="index map"):
        cfg.resolved_constraints(None)


# ------------------------------------------------------------ plain versions

@pytest.mark.parametrize("with_wo", [False, True], ids=["plain", "w+o"])
@pytest.mark.parametrize("name", sorted(TL.BY_NAME))
def test_plain_margin_loss_and_column_sum_match_dense(name, with_wo):
    """Kernel A's plain version then kernel B's (power 1) == the dense
    fused pass; and through the wrappers on CPU tensors, which launch
    nothing."""
    x = _matrix("intercept")
    n, d = x.shape
    rng = np.random.default_rng(5)
    y = (rng.uniform(size=n) < 0.5) * 1.0
    c = rng.normal(size=d) * 0.1
    w = rng.uniform(0.5, 2.0, size=n) if with_wo else None
    o = rng.normal(size=n) * 0.1 if with_wo else None
    t_ = lambda a: None if a is None else torch.from_numpy(a)
    loss = TL.BY_NAME[name]
    ps = TF.PaddedSparse.from_dense(x, device="cpu").with_csc()
    v_d, g_d = hk.fused_value_and_gradient_plain(loss, t_(x), t_(y), t_(c), t_(w), t_(o))
    before = dict(sk.LAUNCHES)
    for fn in (sk.ell_margin_loss_plain, sk.ell_margin_loss):
        v, u = fn(loss, ps.indices, ps.values, t_(c), t_(y), t_(w), t_(o))
        g = sk.csc_column_sum(ps.csc_row, ps.csc_val, ps.csc_end, u, 1)
        np.testing.assert_allclose(v.item(), v_d.item(), rtol=1e-12)
        np.testing.assert_allclose(g.numpy(), g_d.numpy(), rtol=1e-12,
                                   atol=1e-12 * np.abs(g_d.numpy()).max())
    assert sk.LAUNCHES == before


def test_plain_margins_and_squared_column_sum_match_dense():
    x = _matrix("empty")
    rng = np.random.default_rng(6)
    c, u, o = rng.normal(size=x.shape[1]), rng.normal(size=x.shape[0]), rng.normal(size=x.shape[0])
    ps = TF.PaddedSparse.from_dense(x, device="cpu").with_csc()
    z = sk.ell_margins_plain(ps.indices, ps.values, torch.from_numpy(c), torch.from_numpy(o))
    np.testing.assert_allclose(z.numpy(), x @ c + o, rtol=1e-12, atol=1e-14)
    for power in (1, 2):
        g = sk.csc_column_sum_plain(ps.csc_row, ps.csc_val, ps.csc_end, torch.from_numpy(u),
                                    power)
        np.testing.assert_allclose(g.numpy(), (x ** power).T @ u, rtol=1e-12, atol=1e-14)
        assert g[[0, 7, 36]].tolist()[1:] == [0.0, 0.0]  # empty columns


# ------------------------------------------------------------ launch plans

PLAN_SMS = 132
# (name, n, k, d, nnz): bench config 6 ([200,000 x 250,000], <= 64 unique
# hashed features per row plus the intercept) and config 7's fixed effect
# (285,135 training rows of [x 14,983], <= 24 plus the intercept); k200:
# rows too long for a staged tile
SHAPES = [("config6", 200_000, 65, 250_000, 12_800_000),
          ("config7", 285_135, 25, 14_983, 7_100_000),
          ("n0", 0, 1, 37, 0), ("n1", 1, 3, 37, 3), ("n3", 3, 40, 37, 100),
          ("k1", 1000, 1, 37, 1000), ("k200", 5000, 200, 20_000, 1_000_000)]


def _margin_rows(plan, n: int, threads: int = sk.THREADS):
    """Kernel A's rows as the CUDA source walks them: {(block, thread):
    [rows in the order the thread takes them]}."""
    out = {}
    if plan.c_in_smem:
        for b in range(plan.grid):
            for r0 in range(b * plan.rows, n, plan.grid * plan.rows):
                for r in range(min(plan.rows, n - r0)):
                    out.setdefault((b, r % threads), []).append(r0 + r)
    else:
        for b in range(plan.grid):
            for base in range(b * plan.rows, n, plan.grid * plan.rows):
                for t in range(0, threads, plan.lanes):
                    if base + t // plan.lanes < n:
                        out.setdefault((b, t), []).append(base + t // plan.lanes)
    return out


@pytest.mark.parametrize("name,n,k,d,nnz", SHAPES, ids=[s[0] for s in SHAPES])
def test_plans_cover_the_work_once(name, n, k, d, nnz):
    """Replay kernel A's tiles (or its rounds of rows, lanes per row) and
    kernel B's tiles as the CUDA source walks them."""
    plan = sk.plan_margins(n, k, d, PLAN_SMS)
    if plan.c_in_smem:
        assert plan.lanes == 1 and k <= 112
        assert sk.MIN_ROWS <= plan.rows and (plan.rows <= sk.THREADS
                                             or plan.rows % sk.THREADS == 0)
        assert 2 <= plan.stages and 1 <= plan.grid <= PLAN_SMS
        assert n * k >= plan.grid * d and d <= sk.max_smem_cols(k, plan.rows)
        assert plan.smem_bytes == sk.margin_smem_bytes(
            k, plan.rows, plan.stages, d) <= sk.MAX_SMEM
    else:
        assert plan.lanes & (plan.lanes - 1) == 0 and plan.lanes <= 32
        assert plan.lanes >= min(k, 32) and plan.lanes < 2 * k
        assert (plan.lanes * plan.rows, plan.stages, plan.smem_bytes) == (sk.THREADS, 0, 0)
        assert 1 <= plan.grid <= PLAN_SMS * sk.BLOCKS_PER_SM
    rows = np.concatenate([np.asarray(r, np.int64)
                           for r in _margin_rows(plan, n).values()] + [np.zeros(0, np.int64)])
    assert len(rows) == n and len(np.unique(rows)) == n
    assert n * k < 2 ** 31 and nnz < 2 ** 31
    if name == "config7":
        assert plan.c_in_smem and plan.rows == sk.THREADS  # 59.9 KB of c
    if name in ("config6", "k200"):
        assert plan.lanes == 32                           # 1.0 MB of c; long rows

    cp = sk.plan_columns(nnz)
    assert cp.tile == sk.TILE == cp.run * sk.THREADS and cp.tiles >= 1
    assert cp.tiles * cp.tile >= nnz and (nnz == 0 or (cp.tiles - 1) * cp.tile < nnz)
    assert cp.smem_bytes <= 48 * 1024  # the block's static shared memory


def _tree(p: np.ndarray) -> np.ndarray:
    """Pairwise sums of the last axis until one is left: the CUDA
    source's ((p0 + p1) + (p2 + p3)) + ... for a power-of-two length."""
    while p.shape[-1] > 1:
        p = p[..., 0::2] + p[..., 1::2]
    return p[..., 0]


def _block_sum(v: np.ndarray) -> np.float32:
    """block_sum: each warp's xor-shuffle tree, then the warps in order."""
    v = np.concatenate([v, np.zeros(-len(v) % 32, v.dtype)]).reshape(-1, 32)
    off = 16
    while off:
        v = v + v[:, np.arange(32) ^ off]
        off >>= 1
    s = np.float32(0)
    for w in v[:, 0]:
        s = np.float32(s + w)
    return s


def replay_margins(indices: np.ndarray, values: np.ndarray, c: np.ndarray,
                   offsets=None, *, plan, threads: int = sk.THREADS,
                   unroll: int = sk.UNROLL, terms=None):
    """Kernel A in numpy, in the values' dtype, step for step as
    csrc/ell_sparse.cu walks it.  Staged rows (plan.stages > 0): tiles of
    plan.rows rows dealt to blocks in turn, the last one short; thread t
    takes rows t, t + threads, ... of a tile; row r of a tile visits its
    slots from r % k when k is even (0 when odd), wrapping, visit i into
    partial i % unroll; the partials meet in a pairwise tree.  Lanes per
    row (plan.stages 0, plan.lanes = P): lane j sums slots j, j + P, ...
    and the lanes meet in an xor tree.
    Asserts that every slot is visited once.  Returns z; with `terms`
    (a function z -> the rows' w l), also the value as the kernel sums it:
    each thread's rows in order, each block's block_sum, then the last
    block's threads each summing the partials b = t, t + block, ... and
    one more block_sum."""
    n, k = indices.shape
    dt = values.dtype.type
    prod = lambda r, s: values[r, s] * c[indices[r, s]]
    z = np.zeros(n, values.dtype)
    seen = np.zeros((n, k), int)
    if plan.c_in_smem:
        for b in range(plan.grid):
            for r0 in range(b * plan.rows, n, plan.grid * plan.rows):
                r = np.arange(min(plan.rows, n - r0))
                first = np.zeros_like(r) if k % 2 else r % k
                p = np.zeros((len(r), unroll), values.dtype)
                for i in range(k):
                    s = first + i
                    s = np.where(s >= k, s - k, s)
                    p[:, i % unroll] += prod(r0 + r, s)
                    seen[r0 + r, s] += 1
                z[r0 + r] = _tree(p)
        block_threads = threads + 32
    else:
        lanes = np.zeros((n, plan.lanes), values.dtype)
        for j in range(k):
            lanes[:, j % plan.lanes] += prod(np.arange(n), np.full(n, j))
            seen[:, j] += 1
        off = plan.lanes // 2
        while off:
            lanes = lanes + lanes[:, np.arange(plan.lanes) ^ off]
            off >>= 1
        z = lanes[:, 0].copy()
        block_threads = threads
    assert (seen == 1).all()
    if offsets is not None:
        z = z + offsets
    if terms is None:
        return z
    wl = terms(z)
    partial = np.zeros(plan.grid, values.dtype)
    for b in range(plan.grid):
        acc = np.zeros(block_threads, values.dtype)
        for (bb, t), rows in _margin_rows(plan, n, threads).items():
            if bb == b:
                for r in rows:
                    acc[t] = dt(acc[t] + wl[r])
        partial[b] = _block_sum(acc)
    last = np.zeros(block_threads, values.dtype)
    for t in range(block_threads):
        for q in partial[t::block_threads]:
            last[t] = dt(last[t] + q)
    return z, _block_sum(last)


def _ell(n: int, k: int, d: int, seed: int):
    """float32 ELL arrays with <= k nonzeros per row (padding slots: column
    0, value 0), rows 0 and 2 empty."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, k + 1, size=n)
    counts[[0, 2]] = 0
    idx = rng.integers(0, d, size=(n, k)).astype(np.int32)
    val = rng.uniform(0.2, 1.0, size=(n, k)).astype(np.float32)
    pad = np.arange(k)[None, :] >= counts[:, None]
    idx[pad], val[pad] = 0, 0.0
    return idx, val


MARGIN_KS = [1, 2, 8, 25, 32, 33, 64, 65]
# replay tilings: the kernel's own plan, tiles of 5 rows over 3 blocks of 4
# threads (two rows per thread, the last tile short), tiles of 3 rows over
# 2 blocks of 8 threads (idle threads)
REPLAY_TILES = {"plan": None, "5x3x4": (5, 3, 4), "3x2x8": (3, 2, 8)}


@pytest.mark.parametrize("tiling", list(REPLAY_TILES))
@pytest.mark.parametrize("k", MARGIN_KS)
def test_margin_tiles_replay_the_plain_margins(k, tiling):
    """Kernel A's decomposition, replayed in float32, lands within
    margins_tolerance of the plain margins (n = 701: no tiling divides
    it), and its value and u within the card checks' tolerances of the
    plain loss pass."""
    n, d = 701, 90
    idx, val = _ell(n, k, d, seed=k)
    rng = np.random.default_rng(100 + k)
    c = (rng.normal(size=d) * 0.3 / np.sqrt(k)).astype(np.float32)
    o = (rng.normal(size=n) * 0.1).astype(np.float32)
    y = (rng.uniform(size=n) < 0.3).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    if REPLAY_TILES[tiling] is None:
        plan, threads = sk.plan_margins(n, k, d, PLAN_SMS), sk.THREADS
        assert plan.c_in_smem and plan.grid == -(-n // plan.rows)
    else:
        rows, grid, threads = REPLAY_TILES[tiling]
        plan = sk.MarginPlan(1, rows, 2, grid, 0)
    t_ = torch.from_numpy
    loss = TL.LOGISTIC

    def terms(z):
        l, _ = loss.loss_and_dz(t_(z), t_(y))
        return (l * t_(w)).numpy()

    z, value = replay_margins(idx, val, c, o, plan=plan, threads=threads, terms=terms)
    want = sk.ell_margins_plain(t_(idx), t_(val).double(), t_(c).double(), t_(o).double())
    tol = sk.margins_tolerance(t_(idx), t_(val), t_(c), t_(o))
    assert bool(((t_(z).double() - want).abs() <= tol + 1e-30).all())
    v_p, u_p = sk.ell_margin_loss_plain(loss, t_(idx), t_(val).double(), t_(c).double(),
                                        t_(y).double(), t_(w).double(), t_(o).double())
    _, dl = loss.loss_and_dz(t_(z), t_(y))
    np.testing.assert_allclose(float(value), v_p.item(), rtol=1e-5)
    np.testing.assert_allclose((dl * t_(w)).numpy(), u_p.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("k", [1, 3, 25, 65, 113, 200])
def test_lanes_per_row_replay_the_plain_margins(k):
    """Where c is gathered from L2 (here: d too wide to stage), P lanes per
    row: the lanes' sums and their xor tree, replayed, within
    margins_tolerance."""
    n, d = 300, 60_000
    idx, val = _ell(n, k, d, seed=k)
    c = (np.random.default_rng(k).normal(size=d) * 0.05).astype(np.float32)
    plan = sk.plan_margins(n, k, d, PLAN_SMS)
    assert plan.lanes == min(32, 1 << (k - 1).bit_length()) and not plan.c_in_smem
    z = replay_margins(idx, val, c, plan=plan)
    t_ = torch.from_numpy
    want = sk.ell_margins_plain(t_(idx), t_(val).double(), t_(c).double())
    assert bool(((t_(z).double() - want).abs()
                 <= sk.margins_tolerance(t_(idx), t_(val), t_(c)) + 1e-30).all())


def _source() -> str:
    return (Path(sk.__file__).resolve().parent.parent / "csrc" / "ell_sparse.cu").read_text()


def test_margin_plan_fits_shared_memory_and_matches_the_source():
    """Kernel A's constants agree with csrc/ell_sparse.cu; its plan's
    shared memory is the layout the source states (c, then the stages'
    index span with 3 words of room and value span with 16 - vbytes bytes
    of room, then 2 stages + 1 mbarriers) and fits a block's 227 KB; c is
    staged exactly up to max_smem_cols; for float32 and bf16 values."""
    assert (_constexpr("kThreads"), _constexpr("kUnroll"), _constexpr("kMaxSmem")) == (
        sk.THREADS, sk.UNROLL, sk.MAX_SMEM)
    src = _source()
    for line in ("L.ring = round4(cols + 3);", "L.span = round4(rows * k + 3);",
                 "L.vspan = round4((vbytes * rows * k + 19 - vbytes) / 4);",
                 "L.stage = L.span + L.vspan;", "L.bars = L.ring + stages * L.stage;",
                 "L.bytes = L.bars * 4 + (2 * stages + 1) * 8;"):
        assert line in src, line
    r4 = lambda v: (v + 3) // 4 * 4
    for vbytes in (4, 2):
        for n, k, d in ((285_135, 25, 14_983), (701, 1, 37), (10 ** 6, 8, 20_000),
                        (3, 40, 37), (50_000, 112, 30), (10 ** 6, 56, 400)):
            plan = sk.plan_margins(n, k, d, PLAN_SMS, vbytes)
            assert plan.c_in_smem and plan.lanes == 1
            vspan = r4((vbytes * plan.rows * k + 19 - vbytes) // 4)
            assert plan.smem_bytes == 4 * (r4(d + 3) + plan.stages * (
                r4(plan.rows * k + 3) + vspan)) + 8 * (2 * plan.stages + 1)
            if vbytes == 4:
                assert vspan == r4(plan.rows * k + 3)
            assert plan.smem_bytes <= sk.MAX_SMEM < 232_448
            # the most rows whose 2 stages fit beside the smallest c
            most = max(r for r in range(1, 2048)
                       if sk.margin_smem_bytes(k, r, 2, 1, vbytes) <= sk.MAX_SMEM)
            assert plan.rows <= most and (plan.rows >= sk.THREADS or plan.rows == most)
            edge = sk.max_smem_cols(k, plan.rows, vbytes)
            assert sk.margin_smem_bytes(k, plan.rows, 2, edge, vbytes) <= sk.MAX_SMEM
            assert sk.margin_smem_bytes(k, plan.rows, 2, edge + 1, vbytes) > sk.MAX_SMEM
            big = 10 ** 7 // k  # enough rows that every block gathers more than d
            assert sk.plan_margins(big, k, edge, PLAN_SMS, vbytes).c_in_smem
            assert not sk.plan_margins(big, k, edge + 1, PLAN_SMS, vbytes).c_in_smem


def _tile_map(end: np.ndarray, tile: int) -> np.ndarray:
    """sk.tile_map for any tile length."""
    d, tiles = len(end) - 1, max(1, -(-int(end[-1]) // tile))
    return np.append(np.searchsorted(end[:d], np.arange(tiles) * tile), d)


def _seg_scan(segs, carry=(0.0, -1)):
    """Exclusive segmented scan of (v, c) pairs in order after `carry` (c >=
    0: a segment starts inside the pair), as block_seg_scan: the prefix of
    each pair, and the total."""
    out, acc = [], carry
    for v, c in segs:
        out.append(acc)
        acc = (v, c) if c >= 0 else (acc[0] + v, acc[1])
    return out, acc


def replay_column_sum(end: np.ndarray, contrib: np.ndarray, tile: int, run: int,
                      chunk: int, finish_run: int = sk.FINISH_RUN) -> np.ndarray:
    """Kernel B in numpy, step for step as csrc/ell_sparse.cu walks it:
    tile t's columns from the tile map; its column ends staged `chunk` at a
    time; thread i's run of `run` elements split at the column ends (a
    column inside one run written by its thread); the head and tail
    partials met by a segmented scan in thread order; then the last
    block's segmented scan over the tiles' (cont, first) pairs, in rounds
    of `finish_run` tiles per thread.  Asserts that every stream element is
    summed once, every column written once, and that every tile leaves
    cont and span_col set."""
    nnz, d = len(contrib), len(end) - 1
    threads = tile // run
    tiles = max(1, -(-nnz // tile))
    tcol = _tile_map(end, tile)
    g, first, cont = np.full(d, np.nan), np.full(tiles, np.nan), np.full(tiles, np.nan)
    span = np.full(tiles, -99)
    covered, written = np.zeros(nnz, int), np.zeros(d, int)

    def write(j, value):
        g[j] = value
        written[j] += 1

    for t in range(tiles):
        lo = t * tile
        ln = min(tile, nnz - lo)
        j0, j1 = int(tcol[t]), int(tcol[t + 1])
        chunks = -(-(j1 - j0) // (chunk - 1)) if j1 > j0 else 1
        for k in range(chunks):
            cb = j0 + k * (chunk - 1)
            m = min(chunk - 1, j1 - cb)
            ends = np.asarray(end[cb:cb + m + 1], np.int64) - lo   # staged, tile-relative
            assert len(ends) == m + 1 <= chunk
            if k == 0 and ends[0] <= 0:
                cont[t] = 0.0
            if k == chunks - 1:
                span[t] = j1 - 1 if ends[m] > ln and j1 > j0 else -1
            for i in range(m):
                if ends[i] == ends[i + 1]:
                    write(cb + i, 0.0)
            p0 = 0 if k == 0 else int(ends[0])
            p1 = min(int(ends[m]), ln)
            state = []
            for i in range(threads):
                r0 = i * run
                mine = min(run, max(0, ln - r0))
                b0, b1 = max(r0, p0), min(r0 + mine, p1)
                acc, head, head_col, cur, is_open = 0.0, 0.0, -1, -1, False
                if b0 < b1:
                    cur = cb - 1 + int(np.searchsorted(ends, b0, side="right"))
                    stop = ends[cur + 1 - cb]
                    for p in range(b0, b1):
                        acc += contrib[lo + p]
                        covered[lo + p] += 1
                        is_open = True
                        if p + 1 == stop:
                            if head_col < 0:
                                head, head_col = acc, cur
                            else:
                                assert cur >= j0
                                write(cur, acc)
                            acc, is_open = 0.0, False
                            if p + 1 < b1:
                                cur = (cur + 1 if ends[cur + 2 - cb] > p + 1 else
                                       cb - 1 + int(np.searchsorted(ends, p + 1, side="right")))
                                stop = ends[cur + 1 - cb]
                state.append((acc, head, head_col, cur, is_open, b1))
            ex, _ = _seg_scan([(s[0], 0 if s[2] >= 0 else -1) for s in state])
            for (acc, head, head_col, cur, is_open, b1), (ev, _) in zip(state, ex):
                if head_col >= 0:
                    if head_col < j0:
                        cont[t] = ev + head
                    else:
                        write(head_col, ev + head)
                if is_open and b1 == ln:
                    total = acc if head_col >= 0 else ev + acc
                    if cur < j0:
                        cont[t] = total
                    else:
                        assert span[t] == cur
                        first[t] = total
    assert not np.isnan(cont).any() and (span >= -1).all()

    carry = (0.0, -1)
    for base in range(0, tiles, threads * finish_run):
        segs, heads = [], []
        for i in range(threads):
            q0 = base + i * finish_run
            acc, head, col = 0.0, 0.0, -1
            for q in range(q0, min(q0 + finish_run, tiles)):
                acc += cont[q]
                if span[q] >= 0:
                    if col < 0:
                        head = acc
                    else:
                        write(col, acc)
                    acc, col = first[q], int(span[q])
            segs.append((acc, col))
            heads.append((col, head))
        ex, carry = _seg_scan(segs, carry)
        for (col, head), (ev, ec) in zip(heads, ex):
            if col >= 0 and ec >= 0:
                write(ec, ev + head)
    if carry[1] >= 0:
        write(carry[1], carry[0])
    assert np.all(covered == 1) and np.all(written == 1)
    return g


def _streams():
    """(name, end, rows) column-sorted streams with the trouble spots."""
    rng = np.random.default_rng(8)
    wide = sp.random(5000, 300, density=0.01, format="csr", random_state=2)
    wide = sp.hstack([wide, np.ones((5000, 1))]).tocsc()   # intercept: 5000 rows
    out = [("intercept", wide.indptr, wide.indices)]
    ell = TF.PaddedSparse.from_dense(_matrix("empty"), device="cpu").with_csc()
    out.append(("ell_padding", ell.csc_end.numpy(), ell.csc_row.numpy()))
    counts = rng.integers(0, 9, size=700)
    counts[[0, 1, 350, 698, 699]] = 0                       # empty columns, ends too
    end = np.concatenate([[0], np.cumsum(counts)])
    out.append(("empty_columns", end, rng.integers(0, 50, size=end[-1])))
    out.append(("no_nonzeros", np.zeros(5, np.int64), np.zeros(0, np.int64)))
    # columns that end exactly at tile boundaries, one exactly a tile long
    counts = np.array([sk.TILE - 5, 5, sk.TILE, 1, 2 * sk.TILE + 3, 0])
    end = np.concatenate([[0], np.cumsum(counts)])
    out.append(("tile_edges", end, rng.integers(0, 10, size=end[-1])))
    # a tile that meets more columns than one staged chunk: ~4,000 columns
    # of 0 or 1 entries in the first tile
    counts = rng.integers(0, 2, size=3 * sk.CHUNK + 2000)
    end = np.concatenate([[0], np.cumsum(counts)])
    out.append(("more_columns_than_chunk", end, rng.integers(0, 40, size=end[-1])))
    # runs that start and end exactly on column ends: columns of whole runs,
    # of a run and a half, and of 1 and RUN - 1 entries
    counts = np.tile([sk.RUN, sk.RUN, 2 * sk.RUN, 3, sk.RUN - 3, sk.RUN + 4, sk.RUN - 4,
                      1, sk.RUN - 1, 0], 60)
    end = np.concatenate([[0], np.cumsum(counts)])
    out.append(("run_edges", end, rng.integers(0, 30, size=end[-1])))
    # nnz not a multiple of 4: the last tile's last run is ragged
    counts = rng.integers(1, 40, size=300)
    counts[-1] += (3 - int(counts.sum())) % 4 + 4
    end = np.concatenate([[0], np.cumsum(counts)])
    assert end[-1] % 4 == 3
    out.append(("ragged_last_tile", end, rng.integers(0, 60, size=end[-1])))
    return out


# tile length -> (elements per thread, column ends staged at a time) of the
# replay: the kernel's own at TILE, small ones to cut tiles into several
# chunks and threads
REPLAY_RUNS = {sk.TILE: (sk.RUN, sk.CHUNK), 1: (1, 2), 3: (1, 3), 64: (8, 4)}


@pytest.mark.parametrize("tile", [sk.TILE, 1, 3, 64])
@pytest.mark.parametrize("name,end,rows", _streams(), ids=[s[0] for s in _streams()])
def test_column_sum_tiles_replay_the_plain_sum(name, end, rows, tile):
    rng = np.random.default_rng(9)
    u = rng.normal(size=int(rows.max()) + 1 if len(rows) else 1)
    vals = rng.normal(size=len(rows))
    contrib = vals * u[rows]
    want = sk.csc_column_sum_plain(torch.from_numpy(rows), torch.from_numpy(vals),
                                   torch.from_numpy(end), torch.from_numpy(u), 1).numpy()
    got = replay_column_sum(np.asarray(end), contrib, tile, *REPLAY_RUNS[tile])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    if name == "intercept" and tile == sk.TILE:
        assert np.diff(end)[-1] > 2 * sk.TILE  # the intercept spans tiles
    if name == "more_columns_than_chunk" and tile == sk.TILE:
        tiles = sk.tile_map(np.asarray(end))
        assert tiles[1] - tiles[0] > sk.CHUNK  # tile 0 takes several chunks
    if tile == sk.TILE and len(rows):
        np.testing.assert_array_equal(sk.tile_map(np.asarray(end)), _tile_map(end, tile))


@pytest.mark.parametrize("nnz", [2047, 2048, 2049])
def test_column_sum_replay_at_tile_lengths(nnz):
    """Streams one short of, exactly and one past a tile (the lengths
    chip_smoke checks on the card), with the intercept spanning both tiles
    of the last."""
    rng = np.random.default_rng(nnz)
    counts = rng.integers(0, 4, size=400)
    counts[-1] = 0
    counts[-1] = nnz - counts.sum()
    assert counts[-1] > sk.RUN
    end = np.concatenate([[0], np.cumsum(counts)])
    rows = rng.integers(0, 500, size=nnz)
    u, vals = rng.normal(size=500), rng.normal(size=nnz)
    want = sk.csc_column_sum_plain(torch.from_numpy(rows), torch.from_numpy(vals),
                                   torch.from_numpy(end), torch.from_numpy(u), 2).numpy()
    got = replay_column_sum(end, vals * vals * u[rows], sk.TILE, sk.RUN, sk.CHUNK)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def _constexpr(name: str) -> int:
    value = re.search(rf"constexpr int {name} = ([^;]+);", _source()).group(1)
    return int(eval(value, {"kThreads": sk.THREADS, "kRun": sk.RUN}))


def test_column_plan_fits_shared_memory_and_matches_the_source():
    """Kernel B's constants agree with csrc/ell_sparse.cu, and its static
    shared memory (the staged ends, each warp's scan total and column, the
    last-block flag) fits the 48 KB a block gets without opting in, far
    inside an H100 block's 227 KB."""
    assert (_constexpr("kThreads"), _constexpr("kRun"), _constexpr("kTile"),
            _constexpr("kChunk"), _constexpr("kFinishRun")) == (
        sk.THREADS, sk.RUN, sk.TILE, sk.CHUNK, sk.FINISH_RUN)
    for nnz in (0, 1, 2047, 2048, 2049, 7_100_000, 12_800_000):
        plan = sk.plan_columns(nnz)
        assert (plan.tile, plan.run) == (sk.TILE, sk.RUN)
        assert plan.smem_bytes == 4 * (sk.CHUNK + 2 * (sk.THREADS // 32) + 1)
        assert plan.smem_bytes <= 48 * 1024 < 232_448  # an H100 block's 227 KB


@pytest.mark.parametrize("route", ["with_csc", "from_scipy", "to", "pad_rows", "convert"])
def test_tile_map_is_built_with_the_column_view(route):
    """csc_tiles == the lower bounds of t * TILE in end[:d], then d; made
    where the view is made, carried by to and pad_rows, dropped with the
    view."""
    x = _matrix("stream_65536")
    csr = sp.csr_matrix(x)
    if route == "with_csc":
        t = TF.PaddedSparse.from_dense(x, device="cpu").with_csc()
    elif route == "from_scipy":
        t = TF.PaddedSparse.from_scipy(csr, with_csc=True, device="cpu")
    elif route == "to":
        t = TF.PaddedSparse.from_scipy(csr, with_csc=True, device="cpu").to("cpu",
                                                                            torch.float32)
    elif route == "pad_rows":
        t = TF.pad_rows(TF.PaddedSparse.from_dense(x, device="cpu").with_csc(), 3)
    else:
        _, _, t = _both("stream_65536")
    end = t.csc_end.numpy()
    d = len(end) - 1
    tiles = sk.plan_columns(int(end[-1])).tiles
    assert tiles > 30
    want = np.append(np.searchsorted(end[:d], np.arange(tiles) * sk.TILE), d)
    assert t.csc_tiles.dtype == torch.int32
    np.testing.assert_array_equal(t.csc_tiles.numpy(), want)
    assert t.without_csc().csc_tiles is None
    assert TF.PaddedSparse.from_scipy(csr, device="cpu").csc_tiles is None


def test_cached_tile_map_follows_the_end_tensor():
    """A direct csc_column_sum call without a map takes the cached one:
    made once per end tensor, made again after the tensor is written in
    place."""
    end = torch.tensor([0, 3000, 3000, 5000, 9000], dtype=torch.int32)
    first = sk.cached_tile_map(end)
    np.testing.assert_array_equal(first.numpy(), [0, 1, 3, 4, 4, 4])
    assert sk.cached_tile_map(end) is first
    end[1] = 1000
    np.testing.assert_array_equal(sk.cached_tile_map(end).numpy(), [0, 2, 3, 4, 4, 4])
    with pytest.raises(ValueError, match="not decrease"):
        sk.tile_map(np.array([0, 5, 4]))
