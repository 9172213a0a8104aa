"""Variable Density-Bound Block (VDBB) sparsity — functional core (port of
``repro/core/vdbb.py``).

Weight matrices are blocked along the reduction dimension K in blocks of
``bz``; each block of each column group keeps at most ``nnz`` non-zeros,
stored compressed as the values plus their int8 intra-block positions.
``group=None`` gives every column its own pattern (the paper); ``'matrix'``
shares one pattern across all N, so the product runs over the compressed K.

Tie-breaking matches ``jax.lax.top_k``: among equal scores the lowest
position wins. ``torch.topk`` does not promise that, so positions come from
a stable descending sort.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

DEFAULT_BZ = 8


@dataclasses.dataclass(frozen=True)
class DBBFormat:
    """Static description of a density-bound-block format.

    bz: block size along K; nnz: density bound (1..bz, nnz == bz is dense);
    group: pattern-sharing group along N (None per column, int g, or
    'matrix' for all N).
    """

    bz: int = DEFAULT_BZ
    nnz: int = DEFAULT_BZ
    group: Optional[Union[int, str]] = None

    def __post_init__(self):
        if not (1 <= self.nnz <= self.bz):
            raise ValueError(f"nnz must be in [1, bz]; got {self.nnz}/{self.bz}")

    @property
    def density(self) -> float:
        return self.nnz / self.bz

    @property
    def sparsity(self) -> float:
        return 1.0 - self.density

    @property
    def is_dense(self) -> bool:
        return self.nnz == self.bz

    def group_size(self, n: int) -> int:
        if self.group is None:
            return 1
        if self.group == "matrix":
            return n
        return int(self.group)

    def compression_ratio(self, bits: int = 8) -> float:
        """Compressed size is bits·nnz + bz (the bitmask) per block."""
        return (bits * self.bz) / (bits * self.nnz + self.bz)


DENSE = DBBFormat()


def _check_blockable(k: int, fmt: DBBFormat):
    if k % fmt.bz != 0:
        raise ValueError(f"K={k} not divisible by block size bz={fmt.bz}")


def _top_positions(scores: torch.Tensor, nnz: int) -> torch.Tensor:
    """Positions of the ``nnz`` largest scores along the last axis, lowest
    position first among ties (``jax.lax.top_k``'s rule)."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return order[..., :nnz]


def dbb_mask(w: torch.Tensor, fmt: DBBFormat) -> torch.Tensor:
    """Boolean mask keeping the top-|w| ``nnz`` entries of every block of
    (K, N) ``w``; with pattern sharing the score is summed over the group."""
    k, n = w.shape
    _check_blockable(k, fmt)
    if fmt.is_dense:
        return torch.ones_like(w, dtype=torch.bool)
    nb, g = k // fmt.bz, fmt.group_size(n)
    if n % g != 0:
        raise ValueError(f"N={n} not divisible by group={g}")
    ng = n // g
    scores = w.abs().reshape(nb, fmt.bz, ng, g).sum(dim=-1)  # (nb, bz, ng)
    idx = _top_positions(scores.transpose(1, 2), fmt.nnz)  # (nb, ng, nnz)
    keep = torch.zeros(nb, ng, fmt.bz, dtype=torch.bool, device=w.device)
    keep.scatter_(2, idx, True)
    keep = keep.transpose(1, 2)[..., None].expand(nb, fmt.bz, ng, g)
    return keep.reshape(k, n)


def dbb_prune(w: torch.Tensor, fmt: DBBFormat) -> torch.Tensor:
    """Magnitude-prune ``w`` to satisfy the DBB constraint (zero the rest)."""
    return torch.where(dbb_mask(w, fmt), w, torch.zeros_like(w))


def satisfies_dbb(w: torch.Tensor, fmt: DBBFormat) -> bool:
    """True iff every block of every column has <= nnz non-zeros."""
    k, n = w.shape
    _check_blockable(k, fmt)
    nz = (w.reshape(k // fmt.bz, fmt.bz, n) != 0).sum(dim=1)
    return bool((nz <= fmt.nnz).all())


@dataclasses.dataclass
class DBBWeight:
    """Compressed DBB weight.

    values: (nb, nnz, N), zero-padded where a block holds fewer non-zeros;
    indices: (nb, nnz, NG) int8 intra-block positions, ascending;
    fmt / shape: the static format and the dense (K, N) shape.

    A stacked weight (an LM's layer groups, the reference's ``jax.vmap`` of
    ``dbb_encode``) carries a leading axis on both arrays, values (L, nb,
    nnz, N) and indices (L, nb, nnz, NG), and the same (K, N) ``shape``;
    ``w[g]`` is the weight of group ``g`` (views, no copy).
    """

    values: torch.Tensor
    indices: torch.Tensor
    fmt: DBBFormat
    shape: tuple

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device

    def __getitem__(self, g) -> "DBBWeight":
        if self.values.dim() != 4:
            raise TypeError("only a stacked DBBWeight (a leading layers axis) is indexed")
        return dataclasses.replace(self, values=self.values[g], indices=self.indices[g])

    def nbytes_compressed(self) -> int:
        """Stored bytes: values + bitmask (bz bits per block and group)."""
        mask_bits = self.indices[..., 0, :].numel() * self.fmt.bz
        return self.values.numel() * self.values.element_size() + mask_bits // 8

    def nbytes_dense(self) -> int:
        stack = self.values.shape[0] if self.values.dim() == 4 else 1
        return stack * self.shape[0] * self.shape[1] * self.values.element_size()

    def to(self, device) -> "DBBWeight":
        return dataclasses.replace(self, values=self.values.to(device),
                                   indices=self.indices.to(device))


def dbb_encode(w: torch.Tensor, fmt: DBBFormat, *, prune: bool = False) -> DBBWeight:
    """Compress a DBB-constrained dense (K, N) matrix (magnitude-pruned to
    the constraint first when ``prune``). A stacked (L, K, N) matrix is
    encoded layer by layer into a stacked weight."""
    if w.dim() == 3:
        parts = [dbb_encode(wl, fmt, prune=prune) for wl in w]
        return DBBWeight(torch.stack([p.values for p in parts]),
                         torch.stack([p.indices for p in parts]), fmt, parts[0].shape)
    k, n = w.shape
    _check_blockable(k, fmt)
    if prune:
        w = dbb_prune(w, fmt)
    nb, g = k // fmt.bz, fmt.group_size(n)
    ng = n // g
    wb = w.reshape(nb, fmt.bz, ng, g)
    scores = wb.abs().sum(dim=-1)  # (nb, bz, ng)
    idx = _top_positions(scores.transpose(1, 2), fmt.nnz)  # (nb, ng, nnz)
    idx = torch.sort(idx, dim=-1).values.transpose(1, 2)  # (nb, nnz, ng)
    vals = torch.gather(wb, 1, idx[..., None].expand(nb, fmt.nnz, ng, g))
    return DBBWeight(vals.reshape(nb, fmt.nnz, n).contiguous(),
                     idx.to(torch.int8).contiguous(), fmt, (k, n))


def dbb_decode(dw: DBBWeight) -> torch.Tensor:
    """Expand a compressed DBB weight back to dense (K, N), in its own
    dtype (positions within a block are distinct, so a scatter is exact)."""
    k, n = dw.shape
    fmt = dw.fmt
    nb, g = k // fmt.bz, fmt.group_size(n)
    ng = n // g
    vals = dw.values.reshape(nb, fmt.nnz, ng, g)
    idx = dw.indices.long().reshape(nb, fmt.nnz, ng, 1).expand(nb, fmt.nnz, ng, g)
    dense = torch.zeros(nb, fmt.bz, ng, g, dtype=vals.dtype, device=vals.device)
    dense.scatter_(1, idx, vals)
    return dense.reshape(k, n)


def dbb_encode_conv(w: torch.Tensor, fmt: DBBFormat, *, prune: bool = False) -> DBBWeight:
    """Compress a conv weight (kh, kw, C, F) along K = kh·kw·C."""
    kh, kw, c, f = w.shape
    return dbb_encode(w.reshape(kh * kw * c, f), fmt, prune=prune)


def dbb_decode_conv(dw: DBBWeight, kh: int, kw: int) -> torch.Tensor:
    """Expand a compressed conv weight back to dense (kh, kw, C, F)."""
    k, f = dw.shape
    return dbb_decode(dw).reshape(kh, kw, k // (kh * kw), f)


def gather_compressed(a: torch.Tensor, idx: torch.Tensor, bz: int) -> torch.Tensor:
    """The activation mux: (M, nb·bz) -> (M, nb·nnz), taking column
    ``b·bz + idx[b, j]`` for each block ``b`` and slot ``j``."""
    m = a.shape[0]
    nb, nnz = idx.shape
    cols = (torch.arange(nb, device=a.device)[:, None] * bz + idx.long()).reshape(-1)
    return a.reshape(m, nb * bz).index_select(1, cols)


def dbb_matmul_ref(a: torch.Tensor, dw: DBBWeight) -> torch.Tensor:
    """A @ decode(W)."""
    return a @ dbb_decode(dw).to(a.dtype)


def dbb_matmul_gather_ref(a: torch.Tensor, dw: DBBWeight) -> torch.Tensor:
    """Compressed-K formulation (group='matrix' only): gather A's columns
    through the shared pattern, then multiply by the (nb·nnz, N) values."""
    fmt = dw.fmt
    k, n = dw.shape
    if fmt.group_size(n) != n:
        raise ValueError("gather formulation requires group='matrix'")
    ac = gather_compressed(a, dw.indices[:, :, 0], fmt.bz)
    return ac @ dw.values.reshape(-1, n).to(a.dtype)
