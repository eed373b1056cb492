"""kNN search and PCA surface normals, streaming, on the device.

Counterpart of ``fpcr_tpu/ops/normals.py``. :func:`knn` streams target tiles
with a running top-k, so the ``[N, M]`` distance matrix never exists whole.
The running top-k keeps the JAX tie rule: on equal distance the lower target
index wins. ``torch.topk`` does not promise an order among equal values, so
:func:`smallest_k` selects by a key of (distance, position) from
``[carried | tile]``, where the carried entries (lower indices) and then the
tile's (ascending) come first.

Normals are the reference's: the k+1 nearest neighbours including the point
itself, the self slot dropped, the 3x3 covariance of the k neighbours, and
the eigenvector of its smallest eigenvalue (``ops/eigh3.py::eigh3``: kernel
eig3 on the card, ``torch.linalg.eigh`` on the CPU). Normals are
unoriented, as the reference's are. The search ranks by the norm form
``|p|² − 2p·q + |q|²``, whose float32 rounding (~1e-7 of ``|p|²``) swaps
neighbours that lie within ~1e-4 m² of each other on a scan tens of metres
across; :func:`estimate_normals` therefore takes :data:`RERANK` more
candidates and re-ranks them by the difference form (:func:`rerank`), which
picks float64's neighbours there. The JAX package keeps the norm form's
picks.

Recorded (``utils/timing.py``), :func:`estimate_normals` is the span
``normals`` (its counts: ``rows``, ``k`` and the search's ``tiles``) over
``knn`` (the self-kNN) and ``eig3`` (the covariances and the
eigensolve).

:func:`knn`, :func:`self_knn` and :func:`estimate_normals` take a batch as
well (clouds ``[B, M, 3]``, masks ``[B, M]``), the JAX package's ``vmap``
over the normals prepass (``models/batch.py``): one pass over the same
tiles for every element, each element's neighbours and normals bit for bit
those of its own call. Above ``banded_threshold`` the banded search runs
element by element.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils import timing
from .eigh3 import eigh3, smallest_eigenvector
from .matching import pairwise_sqdist, pairwise_sqdist_exact


def smallest_k(d: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest of non-negative ``d`` along its last dim, ascending,
    ties to the lower position: ``(values, positions int64)``. The key is
    the value's bits (order-preserving for non-negative floats) above the
    position, so every key is distinct and ``topk``'s order among equal
    values never matters."""
    bits = d.abs().contiguous().view(torch.int32).to(torch.int64)
    pos = torch.arange(d.shape[-1], dtype=torch.int64, device=d.device)
    key = torch.topk((bits << 32) | pos, k, dim=-1, largest=False).values
    pos = key & 0xFFFFFFFF
    return torch.gather(d, -1, pos), pos


def knn(p: torch.Tensor, q: torch.Tensor, k: int,
        q_mask: Optional[torch.Tensor] = None, *, chunk: int = 1024,
        tile: int = 2048, exact: bool = False
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest targets of every query point: ``(idx int32[N, k], sqdist
    f32[N, k])``, ascending by distance, ties to the lower target index.
    Slots with no valid target left hold ``(0, inf)``. A batch ``p`` [B, N,
    3], ``q`` [B, M, 3], ``q_mask`` [B, M] gives ``[B, N, k]``."""
    p = p.to(torch.float32)
    q = q.to(torch.float32)
    lead, n, m = p.shape[:-2], p.shape[-2], q.shape[-2]
    dist_fn = pairwise_sqdist_exact if exact else pairwise_sqdist
    out_d = torch.empty(lead + (n, k), dtype=torch.float32, device=p.device)
    out_i = torch.empty(lead + (n, k), dtype=torch.int32, device=p.device)
    for s0 in range(0, n, chunk):
        p_c = p[..., s0:s0 + chunk, :]
        rows = p_c.shape[-2]
        best_d = torch.full(lead + (rows, k), float("inf"),
                            dtype=torch.float32, device=p.device)
        best_i = torch.zeros(lead + (rows, k), dtype=torch.int32,
                             device=p.device)
        for t0 in range(0, m, tile):
            d = dist_fn(p_c, q[..., t0:t0 + tile, :])
            if q_mask is not None:
                valid = q_mask[..., t0:t0 + tile].to(torch.bool)
                d = torch.where(valid.unsqueeze(-2), d,
                                torch.full_like(d, float("inf")))
            tile_i = torch.arange(t0, t0 + d.shape[-1], dtype=torch.int32,
                                  device=p.device).expand(lead + (rows, -1))
            best_d, pos = smallest_k(torch.cat([best_d, d], dim=-1), k)
            best_i = torch.gather(torch.cat([best_i, tile_i], dim=-1), -1,
                                  pos)
        out_d[..., s0:s0 + rows, :] = best_d
        out_i[..., s0:s0 + rows, :] = best_i
    return out_i, out_d


def self_knn(q: torch.Tensor, kk: int, mask: Optional[torch.Tensor] = None,
             *, chunk: int = 2048, tile: int = 2048, exact: bool = False,
             banded_threshold: int = 100_000
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Self-kNN (``kk`` includes the self slot): the O(M²) streaming search
    up to ``banded_threshold`` points, the Morton-banded O(M·band) search
    above it with its chunk capped at 1024. ``exact=True`` keeps the
    streaming search at every size, since the banded one is approximate. A
    batch ``[B, M, 3]`` takes one streaming pass for every element, or the
    banded search element by element."""
    if q.shape[-2] > banded_threshold and not exact:
        from .morton import knn_morton

        if q.ndim == 3:
            outs = [knn_morton(q[b], kk, None if mask is None else mask[b],
                               chunk=min(chunk, 1024))
                    for b in range(q.shape[0])]
            return (torch.stack([o[0] for o in outs]),
                    torch.stack([o[1] for o in outs]))
        return knn_morton(q, kk, mask, chunk=min(chunk, 1024))
    return knn(q, q, kk, mask, chunk=chunk, tile=tile, exact=exact)


# candidates beyond the k + 1 that :func:`estimate_normals` re-ranks
RERANK = 4


def rerank(q: torch.Tensor, idx: torch.Tensor, d: torch.Tensor, kk: int
           ) -> torch.Tensor:
    """The ``kk`` nearest of each point's candidates ``idx`` [..., M, c]
    (``d`` their search distances, ``inf`` where no valid target was left)
    by difference-form distances, ascending, ties to the search's order:
    ``int32 [..., M, kk]``."""
    lead, m, c = idx.shape[:-2], idx.shape[-2], idx.shape[-1]
    cand = torch.take_along_dim(
        q, idx.reshape(lead + (m * c, 1)).long(), dim=-2).reshape(
            lead + (m, c, 3))
    diff = cand - q.unsqueeze(-2)
    dd = torch.where(torch.isinf(d), d, torch.sum(diff * diff, dim=-1))
    return torch.gather(idx, -1, smallest_k(dd, kk)[1])


def _neighbour_covariance(q: torch.Tensor, nbr_idx: torch.Tensor
                          ) -> torch.Tensor:
    """Unnormalised 3x3 covariance ``[M, 3, 3]`` of each point's neighbours
    (the reference also skips the 1/k factor); ``[B, M, 3, 3]`` for a
    batch."""
    lead, m, k = nbr_idx.shape[:-2], nbr_idx.shape[-2], nbr_idx.shape[-1]
    nbrs = torch.take_along_dim(
        q, nbr_idx.reshape(lead + (m * k, 1)).long(), dim=-2).reshape(
            lead + (m, k, 3))
    dev = nbrs - nbrs.mean(dim=-2, keepdim=True)
    return torch.matmul(dev.transpose(-1, -2), dev)


def estimate_normals(q: torch.Tensor, k: int = 4,
                     mask: Optional[torch.Tensor] = None, *,
                     chunk: int = 1024, tile: int = 2048, exact: bool = False,
                     include_self: bool = False,
                     banded_threshold: int = 100_000) -> torch.Tensor:
    """Unoriented PCA normals ``[M, 3]`` of a cloud from its k nearest
    non-self neighbours (``include_self`` adds the point itself). A
    degenerate neighbourhood gets (1,1,1)/√3. Unless ``exact``, the
    search's ``k + 1 +`` :data:`RERANK` nearest are re-ranked by the
    difference form. A batch ``[B, M, 3]`` (mask ``[B, M]``) gives ``[B, M,
    3]``, each element's its own call's."""
    span = timing.begin("normals")
    q = q.to(torch.float32)
    inner = timing.begin("knn")
    extra = 0 if exact else RERANK
    idx_all, d_all = self_knn(q, k + 1 + extra, mask, chunk=chunk,
                              tile=tile, exact=exact,
                              banded_threshold=banded_threshold)
    if extra:
        idx_all = rerank(q, idx_all, d_all, k + 1)
    if inner:
        inner.end()
    inner = timing.begin("eig3")
    nbr_idx = idx_all if include_self else idx_all[..., 1:]
    normals, _ = smallest_eigenvector(_neighbour_covariance(q, nbr_idx))
    if inner:
        inner.end()
    if span:
        m = q.shape[-2]
        banded = m > banded_threshold and not exact
        tiles = (-(-m // min(chunk, 1024)) if banded
                 else -(-m // chunk) * -(-m // tile))
        span.end(rows=m, k=k, tiles=tiles)
    return normals


def orient_normals(points: torch.Tensor, normals: torch.Tensor,
                   viewpoint=None) -> torch.Tensor:
    """Flip unoriented normals to a consistent sign: away from the centroid
    when ``viewpoint`` is None, else toward the viewpoint."""
    points = points.to(torch.float32)
    if viewpoint is None:
        ref = points - points.mean(dim=0, keepdim=True)
    else:
        ref = torch.as_tensor(viewpoint, dtype=torch.float32,
                              device=points.device)[None, :] - points
    s = torch.sign(torch.sum(normals * ref, dim=1, keepdim=True))
    return normals * torch.where(s == 0, torch.ones_like(s), s)


def normals_with_curvature(q: torch.Tensor, k: int = 4,
                           mask: Optional[torch.Tensor] = None, **kwargs
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normals and the surface-variation curvature ``lam_min / (lam0 + lam1
    + lam2)``, from the streaming kNN (``kwargs`` go to :func:`knn`)."""
    q = q.to(torch.float32)
    idx_all, _ = knn(q, q, k + 1, mask, **kwargs)
    vals, vecs = eigh3(_neighbour_covariance(q, idx_all[:, 1:]))
    trace = vals.sum(dim=-1)
    return vecs[..., :, 0].contiguous(), vals[..., 0] / torch.where(
        trace > 0, trace, torch.ones_like(trace))
