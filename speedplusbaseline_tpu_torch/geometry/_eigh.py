"""Batched symmetric eigendecomposition without a host sync.

``torch.linalg.eigh`` (and ``svd``) check their solver's ``info`` on the
host, so on the card every call waits for the device. The geometry calls an
eigensolver inside every eval step (the 12 x 12 EPnP matrix M^T M, Horn's
3 x 3 alignment, the 3 x 3 model covariance, the 4 x 4 quaternion mean), so
it uses this one: cyclic Jacobi in the parallel (round-robin) order. Each
round rotates n/2 disjoint (p, q) pairs of every matrix in the batch at
once, as one rotation matrix J; A <- J^T A J, V <- V J. A fixed number of
sweeps, no data-dependent exit, so the work is a fixed chain of batched
ops. Jacobi is at least as accurate as LAPACK's f32 ``syevd`` on these
positive semi-definite matrices; the tests hold it to float64 ``eigh``.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import torch

# Sweeps over all pairs. The off-diagonal mass falls quadratically once the
# pivots are small; 6 sweeps leave f32 rounding at n = 12 on the EPnP
# matrices (tests/test_torch_geometry.py::test_eigh_matches_float64).
SWEEPS = 6


def _rounds(n: int) -> List[List[Tuple[int, int]]]:
    """Round-robin pairing of 0..n-1: every pair once per sweep, disjoint
    pairs within a round (an odd n sits one index out each round)."""
    m = n + n % 2
    players = list(range(m))
    rounds = []
    for _ in range(m - 1):
        pairs = [(min(players[i], players[m - 1 - i]), max(players[i], players[m - 1 - i]))
                 for i in range(m // 2)]
        rounds.append([(p, q) for p, q in pairs if q < n])
        players = [players[0], players[-1]] + players[1:-1]
    return rounds


@functools.lru_cache(maxsize=None)
def _schedule(n: int, device: torch.device):
    """Per round: flat indices of (a_pp, a_qq, a_pq) and of J's (pp, qq, pq,
    qp) entries, as device tensors (made once per size and device)."""
    read, write = [], []
    for pairs in _rounds(n):
        p = [a for a, _ in pairs]
        q = [b for _, b in pairs]
        pp = [i * n + i for i in p]
        qq = [j * n + j for j in q]
        pq = [i * n + j for i, j in zip(p, q)]
        qp = [j * n + i for i, j in zip(p, q)]
        read.append(pp + qq + pq)
        write.append(pp + qq + pq + qp)
    return (torch.tensor(read, dtype=torch.long, device=device),
            torch.tensor(write, dtype=torch.long, device=device))


def eigh(A: torch.Tensor, sweeps: int = SWEEPS):
    """Eigenvalues in ascending order and the eigenvectors as columns, like
    ``torch.linalg.eigh``, of symmetric (..., n, n) matrices."""
    n = A.shape[-1]
    batch = A.shape[:-2]
    A = A.reshape(-1, n, n)
    B = A.shape[0]
    read, write = _schedule(n, A.device)
    k = read.shape[1] // 3
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    eye_flat = eye.reshape(1, n * n).expand(B, n * n)
    V = eye.expand(B, n, n)
    for _ in range(sweeps):
        for r in range(read.shape[0]):
            app, aqq, apq = A.reshape(B, n * n).index_select(1, read[r]).split(k, 1)
            zero = apq == 0
            theta = (aqq - app) / (2.0 * torch.where(zero, 1.0, apq))
            sign = torch.where(theta < 0, -1.0, 1.0)
            t = sign / (torch.abs(theta) + torch.sqrt(theta * theta + 1.0))
            t = torch.where(zero, 0.0, t)
            c = torch.rsqrt(t * t + 1.0)
            s = t * c
            J = eye_flat.scatter(1, write[r].expand(B, -1),
                                 torch.cat([c, c, s, -s], 1)).reshape(B, n, n)
            A = J.mT @ A @ J
            V = V @ J
    w, order = torch.sort(torch.diagonal(A, dim1=-2, dim2=-1), dim=-1)
    V = torch.gather(V, 2, order[:, None, :].expand(B, n, n))
    return w.reshape(*batch, n), V.reshape(*batch, n, n)
