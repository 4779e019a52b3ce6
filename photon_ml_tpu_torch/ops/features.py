"""Feature-matrix products (port of photon_ml_tpu/ops/features.py).

Three representations: a dense [n, d] tensor; `PaddedSparse`, the JAX
package's padded row-sparse (ELL) batch with an optional column-sorted
(CSC) view of the same nonzeros; and `KroneckerDesign`, the implicit
[n, k*d] design of the factored random effects' latent refit.  Every
aggregate in ops/aggregators.py touches X only through the products below.

On a CUDA `PaddedSparse` the products run the hand-written kernels of
ops/sparse_kernels.py (csrc/ell_sparse.cu): `matvec` is kernel A in
margins mode, `rmatvec` and `sq_rmatvec` are kernel B over the column
view.  A CUDA `PaddedSparse` without its column view cannot take
`rmatvec`/`sq_rmatvec`: it raises, and never falls back to a scatter.  On
the CPU the products run the kernels' plain versions, and a matrix
without the column view takes a scatter-add (`index_add_`), as the JAX
package does.

A `KroneckerDesign`'s products are matrix products in torch (the JAX
package computes them in XLA, outside any Pallas kernel).

bf16 feature storage: a dense X or a PaddedSparse's values may be stored in
bfloat16 (`as_feature_matrix` keeps them so).  The products promote as the
JAX package's do (x @ v, jnp.promote_types): X is widened exactly to the
vector's dtype and the product accumulates there, never rounded to bf16.
A dense product widens X in row chunks of at most WIDEN_BYTES (a temporary
copy, on the card too: the fused kernel, not these products, is the
value+gradient pass); the sparse products' kernels take bf16 values as
they are.  (X*X) for sq_rmatvec is formed in the storage dtype first, as
the JAX package forms it.

A torch sparse tensor (`torch.sparse_coo` or `torch.sparse_csr`, [n, d],
duplicate entries summed) is the port's counterpart of the JAX package's
BCOO.  `as_feature_matrix` converts it into a `PaddedSparse` on the
tensor's own device (`PaddedSparse.from_torch`: the layout `from_scipy`
builds from the same matrix), so a solve runs kernels A and B on it.  The
products also take one as it is, as the JAX package's take a BCOO: on the
CPU as torch's sparse products (the plain version) in the promoted dtype,
on the card through its ELL form, converted once per tensor and cached
(`ell_form`).  Every other non-strided layout raises TypeError.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from photon_ml_tpu_torch import resolve_device
from photon_ml_tpu_torch.ops import sparse_kernels as sk

# the sparse layouts a torch tensor may take as a feature matrix: the
# port's BCOO
SPARSE_LAYOUTS = (torch.sparse_coo, torch.sparse_csr)


@dataclasses.dataclass
class KroneckerDesign:
    """Implicit [n, k*d] design matrix with row_i = kron(factors_i, x_i),
    the latent-projection refit's design (reference:
    FactoredRandomEffectCoordinate.kroneckerProductFeaturesAndCoefficients,
    which materializes it).  The products come straight from X [n, d] and
    the per-row latent factors F [n, k]:
      matvec(P_flat)  = ((X @ P^T) * F).sum(-1)
      rmatvec(u)      = (F * u[:, None])^T @ X
    so the k*d matrix never exists."""

    x: torch.Tensor        # [n, d]
    factors: torch.Tensor  # [n, k]

    @property
    def shape(self):
        return (self.x.shape[0], self.factors.shape[1] * self.x.shape[1])

    @property
    def ndim(self) -> int:
        return 2

    @property
    def dtype(self) -> torch.dtype:
        return self.x.dtype

    @property
    def is_cuda(self) -> bool:
        return self.x.is_cuda

    def to(self, device=None, dtype=None) -> "KroneckerDesign":
        return KroneckerDesign(self.x.to(device=device, dtype=dtype),
                               self.factors.to(device=device, dtype=dtype))

    def _unflatten_coef(self, v: torch.Tensor) -> torch.Tensor:
        return v.reshape(self.factors.shape[1], self.x.shape[1])


@dataclasses.dataclass
class PaddedSparse:
    """Padded row-sparse (ELL) batch: row i holds its nonzeros in
    `values[i, :]` at columns `indices[i, :]` (k = the most nonzeros of any
    row; padding slots hold column 0 with value 0).

    The optional `csc_*` tensors are a second, column-sorted view of the
    same nonzeros for the gradient product X^T u: the nonzeros of column j
    are `csc_val[csc_end[j]:csc_end[j + 1]]` at rows `csc_row[...]`.
    Built by `with_csc()` (from the ELL arrays, padding slots included in
    column 0's segment) or `from_scipy(..., with_csc=True)` (scipy's exact
    CSC, no padding).  Both also build `csc_tiles`, kernel B's tile map
    of the view (sparse_kernels.tile_map; the JAX package has no such
    field), once per view; `to` and `pad_rows` carry it."""

    indices: torch.Tensor                    # [n, k] int32, padding = 0
    values: torch.Tensor                     # [n, k], padding = 0.0
    num_cols: int
    csc_row: Optional[torch.Tensor] = None   # [nnz] int32, column-sorted
    csc_val: Optional[torch.Tensor] = None   # [nnz], same order
    csc_end: Optional[torch.Tensor] = None   # [d + 1] int32
    csc_tiles: Optional[torch.Tensor] = None  # [tiles + 1] int32: kernel B's tile map

    @property
    def has_csc(self) -> bool:
        return self.csc_row is not None

    @property
    def shape(self):
        return (self.indices.shape[0], self.num_cols)

    @property
    def ndim(self) -> int:
        return 2

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def is_cuda(self) -> bool:
        return self.values.is_cuda

    def to(self, device=None, dtype=None) -> "PaddedSparse":
        """On `device` with values in `dtype`, the column view's values too
        (indices stay int32)."""
        ints = lambda a: None if a is None else a.to(device=device)
        vals = lambda a: None if a is None else a.to(device=device, dtype=dtype)
        return PaddedSparse(ints(self.indices), vals(self.values), self.num_cols,
                            ints(self.csc_row), vals(self.csc_val),
                            ints(self.csc_end), ints(self.csc_tiles))

    def with_csc(self) -> "PaddedSparse":
        """Attach the column-sorted view, built on the host from the ELL
        arrays (as the JAX package builds it) and placed on their device.
        ELL padding slots (value 0 at column 0) stay in column 0's
        segment: they add nothing to its sums."""
        if self.has_csc:
            return self
        ind = self.indices.cpu().numpy()
        val = self.values.cpu()
        rows = np.repeat(np.arange(ind.shape[0], dtype=np.int32), ind.shape[1])
        cols = ind.reshape(-1)
        order = np.argsort(cols, kind="stable")
        end = np.zeros(self.num_cols + 1, np.int32)
        end[1:] = np.cumsum(np.bincount(cols[order], minlength=self.num_cols))
        dev = self.device
        return PaddedSparse(
            self.indices, self.values, self.num_cols,
            csc_row=torch.from_numpy(rows[order]).to(dev),
            csc_val=val.reshape(-1)[torch.from_numpy(order)].to(dev),
            csc_end=torch.from_numpy(end).to(dev),
            csc_tiles=torch.from_numpy(sk.tile_map(end)).to(dev))

    def without_csc(self) -> "PaddedSparse":
        return (PaddedSparse(self.indices, self.values, self.num_cols)
                if self.has_csc else self)

    @staticmethod
    def from_dense(x, device=None) -> "PaddedSparse":
        """A dense [n, d] array or tensor -> ELL on `device` (None means
        cuda), values in x's dtype (a bf16 tensor's too)."""
        if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
            # numpy has no bf16: build from the exact float32 copy
            return PaddedSparse.from_dense(x.float(), device).to(dtype=torch.bfloat16)
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        nnz = np.count_nonzero(x, axis=1)
        k = max(int(nnz.max()), 1) if len(nnz) else 1
        rows, cols = np.nonzero(x)
        slot = np.arange(len(rows)) - np.repeat(
            np.concatenate([[0], np.cumsum(nnz)[:-1]]), nnz)
        indices = np.zeros((x.shape[0], k), dtype=np.int32)
        values = np.zeros((x.shape[0], k), dtype=x.dtype)
        indices[rows, slot] = cols
        values[rows, slot] = x[rows, cols]
        dev = resolve_device(device)
        return PaddedSparse(torch.from_numpy(indices).to(dev),
                            torch.from_numpy(values).to(dev), x.shape[1])

    @staticmethod
    def from_scipy(mat, with_csc: bool = False, device=None) -> "PaddedSparse":
        """scipy.sparse -> ELL on `device` (None means cuda), built on the
        host without densifying.  `with_csc` also attaches the exact
        column-sorted view (scipy's own CSC: no padding slots)."""
        csr = mat.tocsr()
        csr.sum_duplicates()
        nnz = np.diff(csr.indptr)
        k = max(int(nnz.max()), 1) if len(nnz) else 1
        n = csr.shape[0]
        slot = np.arange(csr.indptr[-1]) - np.repeat(csr.indptr[:-1], nnz)
        rows = np.repeat(np.arange(n), nnz)
        indices = np.zeros((n, k), dtype=np.int32)
        values = np.zeros((n, k), dtype=csr.data.dtype if csr.data.size
                          else np.float32)
        indices[rows, slot] = csr.indices
        values[rows, slot] = csr.data
        dev = resolve_device(device)
        out = PaddedSparse(torch.from_numpy(indices).to(dev),
                           torch.from_numpy(values).to(dev), csr.shape[1])
        if with_csc:
            csc = mat.tocsc()
            csc.sum_duplicates()
            out.csc_row = torch.from_numpy(csc.indices.astype(np.int32)).to(dev)
            out.csc_val = torch.from_numpy(csc.data.astype(values.dtype)).to(dev)
            out.csc_end = torch.from_numpy(csc.indptr.astype(np.int32)).to(dev)
            out.csc_tiles = torch.from_numpy(sk.tile_map(csc.indptr)).to(dev)
        return out

    @staticmethod
    def from_torch(x: torch.Tensor, with_csc: bool = False) -> "PaddedSparse":  # photonlint: flush-point -- ingest: one read-back of the widest row's count
        """A sparse COO or CSR tensor -> ELL on the tensor's own device, in
        its dtype, by torch ops there: coalesced (duplicates summed), k the
        most nonzeros of any row (one read-back), rows' nonzeros in column
        order, so the layout `from_scipy` builds from the same matrix.
        `with_csc` also attaches the column view (rows in order within each
        column, as scipy's CSC) and its tile map, made on the device."""
        coo = (x.to_sparse_coo() if x.layout == torch.sparse_csr else x).coalesce()
        n, d = x.shape
        rows, cols = coo.indices()
        vals = coo.values()
        dev = vals.device
        counts = torch.bincount(rows, minlength=n)
        k = max(int(counts.max()), 1) if n and rows.numel() else 1
        slot = torch.arange(rows.numel(), device=dev) - (torch.cumsum(counts, 0) - counts)[rows]
        indices = torch.zeros((n, k), dtype=torch.int32, device=dev)
        values = torch.zeros((n, k), dtype=vals.dtype, device=dev)
        indices[rows, slot] = cols.to(torch.int32)
        values[rows, slot] = vals
        out = PaddedSparse(indices, values, d)
        if with_csc:
            order = torch.argsort(cols, stable=True)
            end = torch.zeros(d + 1, dtype=torch.int64, device=dev)
            end[1:] = torch.cumsum(torch.bincount(cols, minlength=d), 0)
            out.csc_row = rows[order].to(torch.int32)
            out.csc_val = vals[order]
            out.csc_end = end.to(torch.int32)
            out.csc_tiles = sk.tile_map_of(end, rows.numel())
        return out


FeatureMatrix = Union[torch.Tensor, PaddedSparse, KroneckerDesign]

# The JAX package attaches the column view only at this width and above:
# on its TPU the narrower view cost host-to-device transfer for no solve
# time.  The port keeps the threshold for CPU tensors only (so the CPU
# products take the JAX package's path, scatter-add below it), and
# attaches the view to every PaddedSparse it places on a CUDA device for
# training: the card's gradient product is kernel B, which needs it.
CSC_MIN_COLS = 100_000


def _is_scipy_sparse(x) -> bool:
    try:
        import scipy.sparse as sp
    except ImportError:  # pragma: no cover
        return False
    return sp.issparse(x)


def is_sparse(x) -> bool:
    """A torch sparse COO or CSR tensor: the port's BCOO."""
    return isinstance(x, torch.Tensor) and x.layout in SPARSE_LAYOUTS


def _check_layout(x) -> None:
    if (isinstance(x, torch.Tensor) and x.layout != torch.strided
            and x.layout not in SPARSE_LAYOUTS):
        raise TypeError(f"a feature matrix tensor is strided, torch.sparse_coo or "
                        f"torch.sparse_csr; got {x.layout}")


# id(tensor) -> (its _version, its ELL form with the column view); an
# entry goes when its tensor is freed
_ELL_FORMS: Dict[int, Tuple[int, "PaddedSparse"]] = {}
_ELL_FORMS_KEPT = 8


def ell_form(x: torch.Tensor) -> PaddedSparse:  # photonlint: flush-point -- one conversion (and read-back of the widest row) per tensor, then cached
    """The ELL form, with its column view, of a sparse tensor on the card,
    made at the first product for this tensor (and again after it is
    written in place), then cached while the tensor lives: the products of
    a raw sparse tensor run kernels A and B on it."""
    hit = _ELL_FORMS.get(id(x))
    if hit is not None and hit[0] == x._version:
        return hit[1]
    ell = PaddedSparse.from_torch(x, with_csc=True)
    if hit is None:
        if len(_ELL_FORMS) >= _ELL_FORMS_KEPT:
            _ELL_FORMS.pop(next(iter(_ELL_FORMS)))
        weakref.finalize(x, _ELL_FORMS.pop, id(x), None)
    _ELL_FORMS[id(x)] = (x._version, ell)
    return ell


def _storage(x_dtype: torch.dtype, dtype) -> torch.dtype:
    """The dtype features are stored in: bf16 features stay bf16 (the
    products promote), every other dtype becomes `dtype`."""
    return x_dtype if x_dtype == torch.bfloat16 else dtype


def as_feature_matrix(x, device=None, dtype=None,
                      with_csc: bool = False) -> FeatureMatrix:
    """Ingest adapter, onto `device` (None means cuda) in `dtype`:
    scipy.sparse or a sparse COO/CSR tensor -> PaddedSparse, a
    PaddedSparse moved, anything else a dense tensor.  A bf16 dense X or
    bf16 sparse values stay bf16 (the JAX package's bf16 feature storage);
    a KroneckerDesign and every other dtype is cast to `dtype`.  A sparse
    tensor is converted on its own device (`PaddedSparse.from_torch`),
    then moved; the JAX package passes its BCOO through as it is.
    `with_csc` asks for the column view a solve's gradient needs: always
    attached on a CUDA device, and on the CPU from CSC_MIN_COLS columns
    up, as the JAX package does."""
    dev = resolve_device(device)
    _check_layout(x)
    if isinstance(x, KroneckerDesign):
        return x.to(dev, dtype)
    if isinstance(x, PaddedSparse) or _is_scipy_sparse(x) or is_sparse(x):
        want = with_csc and (dev.type == "cuda" or x.shape[1] >= CSC_MIN_COLS)
        if is_sparse(x):
            return PaddedSparse.from_torch(x, with_csc=want).to(dev, _storage(x.dtype, dtype))
        if not isinstance(x, PaddedSparse):
            return PaddedSparse.from_scipy(x, with_csc=want, device=dev).to(dtype=dtype)
        x = x.to(dev, _storage(x.dtype, dtype))
        return x.with_csc() if want else x
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    if x.ndim != 2:
        raise ValueError(f"a feature matrix is 2-D; got shape {tuple(x.shape)}")
    return x.to(device=dev, dtype=_storage(x.dtype, dtype))


def _dense(x) -> torch.Tensor:
    _check_layout(x)
    return x


def _coo(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A CPU sparse tensor as COO in `dtype` (its values widened exactly)."""
    coo = x.to_sparse_coo() if x.layout == torch.sparse_csr else x
    return coo.to(dtype)


def _sparse_mv(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """X v for a CPU sparse tensor, in the promoted dtype (JAX's bcoo @ v)."""
    dt = torch.promote_types(x.dtype, v.dtype)
    return torch.sparse.mm(_coo(x, dt), v.to(dt)[:, None])[:, 0]


def _sparse_rmv(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """X^T u for a CPU sparse tensor, in the promoted dtype (JAX's u @ bcoo)."""
    dt = torch.promote_types(x.dtype, u.dtype)
    return torch.sparse.mm(_coo(x, dt).t(), u.to(dt)[:, None])[:, 0]


# a dense product whose X must be widened to the vector's dtype (bf16
# storage) widens it in row chunks of at most this many bytes
WIDEN_BYTES = 64 << 20


def _widened(x: torch.Tensor, dtype: torch.dtype):
    """(first row, rows of x widened exactly to `dtype`) in row chunks of
    at most WIDEN_BYTES."""
    rows = max(1, WIDEN_BYTES // (max(x.shape[1], 1) * dtype.itemsize))
    for lo in range(0, x.shape[0], rows):
        yield lo, x[lo:lo + rows].to(dtype)


def _mv(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """X v (v [d] or [d, K]) in the promoted dtype of X and v (JAX's
    x @ v)."""
    dt = torch.promote_types(x.dtype, v.dtype)
    if x.dtype == v.dtype == dt:
        return x @ v
    v = v.to(dt)
    parts = [xc @ v for _, xc in _widened(x, dt)]
    return torch.cat(parts) if parts else v.new_zeros((0,) + v.shape[1:])


def _rmv(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """X^T u (u [n] or [n, K]) in the promoted dtype of X and u (JAX's
    x.T @ u)."""
    dt = torch.promote_types(x.dtype, u.dtype)
    if x.dtype == u.dtype == dt:
        return x.T @ u
    u = u.to(dt)
    out = u.new_zeros((x.shape[1],) + u.shape[1:])
    for lo, xc in _widened(x, dt):
        out += xc.T @ u[lo:lo + xc.shape[0]]
    return out


def num_features(x: FeatureMatrix) -> int:
    return x.shape[-1]


def num_rows(x: FeatureMatrix) -> int:
    return x.shape[0]


def matvec(x: FeatureMatrix, v: torch.Tensor) -> torch.Tensor:
    """X @ v -> [n].  The margin product."""
    if isinstance(x, KroneckerDesign):
        p = x._unflatten_coef(v)
        return torch.sum((x.x @ p.T) * x.factors, dim=-1)
    if isinstance(x, PaddedSparse):
        if tuple(v.shape) != (x.num_cols,):
            raise ValueError(f"v has shape {tuple(v.shape)}, X has {x.num_cols} columns")
        return sk.ell_margins(x.indices, x.values, v)
    if is_sparse(x):
        return matvec(ell_form(x), v) if x.is_cuda else _sparse_mv(x, v)
    return _mv(_dense(x), v)


def _scatter(x: PaddedSparse, u: torch.Tensor, power: int) -> torch.Tensor:
    """X^T u (power 1) or (X*X)^T u (power 2) by scatter-add over the ELL
    slots: the JAX package's path without the column view, CPU only."""
    if x.is_cuda:
        raise ValueError(
            "this CUDA PaddedSparse has no column view: X^T u on the card is "
            "kernel B over the column-sorted stream; build the matrix with "
            "as_feature_matrix(..., with_csc=True) or call .with_csc()")
    vals = x.values if power == 1 else x.values * x.values
    acc = torch.promote_types(x.dtype, u.dtype)
    return torch.zeros(x.num_cols, dtype=acc).index_add_(
        0, x.indices.reshape(-1).long(), (vals * u[:, None]).reshape(-1).to(acc))


def rmatvec(x: FeatureMatrix, u: torch.Tensor) -> torch.Tensor:
    """X^T @ u -> [d].  The gradient-assembly product."""
    if isinstance(x, KroneckerDesign):
        return ((x.factors * u[:, None]).T @ x.x).reshape(-1)
    if isinstance(x, PaddedSparse):
        if x.has_csc:
            return sk.csc_column_sum(x.csc_row, x.csc_val, x.csc_end, u, 1, x.csc_tiles)
        return _scatter(x, u, 1)
    if is_sparse(x):
        return rmatvec(ell_form(x), u) if x.is_cuda else _sparse_rmv(x, u)
    return _rmv(_dense(x), u)


def sq_rmatvec(x: FeatureMatrix, u: torch.Tensor) -> torch.Tensor:
    """(X*X)^T @ u -> [d], for the Hessian diagonal."""
    if isinstance(x, KroneckerDesign):
        # kron(f, x)^2 == kron(f^2, x^2)
        f2 = x.factors * x.factors
        return ((f2 * u[:, None]).T @ (x.x * x.x)).reshape(-1)
    if isinstance(x, PaddedSparse):
        if x.has_csc:
            return sk.csc_column_sum(x.csc_row, x.csc_val, x.csc_end, u, 2, x.csc_tiles)
        return _scatter(x, u, 2)
    if is_sparse(x):
        if x.is_cuda:
            return sq_rmatvec(ell_form(x), u)
        # the square of each (summed) entry, in the storage dtype
        c = x.to_sparse_coo().coalesce()
        return _sparse_rmv(torch.sparse_coo_tensor(
            c.indices(), c.values() * c.values(), c.shape, is_coalesced=True), u)
    x = _dense(x)
    return _rmv(x * x, u)


def pad_rows(x: FeatureMatrix, rem: int) -> FeatureMatrix:
    """Append `rem` zero rows (pair with mask = 0)."""
    if rem == 0:
        return x
    zpad = lambda a: torch.cat([a, a.new_zeros((rem,) + tuple(a.shape[1:]))])
    if isinstance(x, KroneckerDesign):
        return KroneckerDesign(zpad(x.x), zpad(x.factors))
    if isinstance(x, PaddedSparse):
        # the column view is untouched: appended rows carry no nonzeros
        # and existing row ids stay valid against the grown u
        return PaddedSparse(zpad(x.indices), zpad(x.values), x.num_cols,
                            x.csc_row, x.csc_val, x.csc_end, x.csc_tiles)
    if is_sparse(x):
        # zero rows store nothing: only the shape grows, as a BCOO's does
        shape = (x.shape[0] + rem, x.shape[1])
        if x.layout == torch.sparse_csr:
            crow = x.crow_indices()
            return torch.sparse_csr_tensor(torch.cat([crow, crow[-1:].expand(rem)]),
                                           x.col_indices(), x.values(), shape)
        return torch.sparse_coo_tensor(x._indices(), x._values(), shape,
                                       is_coalesced=x.is_coalesced())
    return zpad(_dense(x))


def densify(x: FeatureMatrix) -> torch.Tensor:
    if isinstance(x, KroneckerDesign):
        # row i = kron(factors_i, x_i): [n, k, 1] * [n, 1, d] -> [n, k*d]
        return (x.factors[:, :, None] * x.x[:, None, :]).reshape(x.shape)
    if isinstance(x, PaddedSparse):
        n, d = x.shape
        out = torch.zeros((n, d), dtype=x.dtype, device=x.device)
        rows = torch.arange(n, device=x.device)[:, None].expand_as(x.indices)
        return out.index_put_((rows, x.indices.long()), x.values, accumulate=True)
    if is_sparse(x):
        return x.to_dense()
    return _dense(x)
