"""The self-kNN kernel of the normals prepass (``csrc/knn.cu``) on the CPU:
its numpy mirror (``ops/knn_mirror.py``) bit for bit against the plain
search ``ops.normals.knn(q, q, kk, mask, exact=True)`` on random clouds,
duplicated points (ties), masks that leave rows fewer than ``kk`` valid
targets, NaN points, batches and the OS1-16 hall scan's own order, under
several plans of slices and seeds' windows; the plan; the routing
rule of ``estimate_normals`` as a pure function; and the kernel's route
through ``estimate_normals`` with the mirror in the kernel's place. The
kernel itself runs on the card only (``tests/test_torch_gpu.py``)."""

import numpy as np
import pytest
import torch

import fpcr_tpu_torch as ft
from fpcr_tpu_torch.ops import knn_cuda
from fpcr_tpu_torch.ops import normals as tn
from fpcr_tpu_torch.ops.knn_cuda import K_MAX, plan_knn, sweep_blocks
from fpcr_tpu_torch.ops.knn_mirror import self_knn_mirror
from fpcr_tpu_torch.utils import timing

KKS = [5, 9, K_MAX]


def _plain(q, kk, mask=None):
    idx, d = tn.knn(torch.as_tensor(q), torch.as_tensor(q), kk,
                    None if mask is None else torch.as_tensor(mask),
                    exact=True)
    return idx.numpy(), d.numpy()


def _same(got, want):
    """Indices equal and distances equal bit for bit."""
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].view(np.int32),
                                  want[1].view(np.int32))


def _cloud(rng, m, scale=5.0):
    return rng.uniform(-scale, scale, (m, 3)).astype(np.float32)


def _duplicated(rng, m):
    """A cloud whose points repeat: a third are copies of others, some in
    threes, so equal distances tie across slices and inside them."""
    q = _cloud(rng, m)
    q[rng.integers(0, m, m // 3)] = q[rng.integers(0, m, m // 3)]
    q[m // 2:m // 2 + 3] = q[7]
    return q


def _lattice(m):
    """Points on an integer lattice: many exactly equal distances."""
    side = int(np.ceil(m ** (1 / 3)))
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1)
    return g.reshape(-1, 3)[:m].astype(np.float32)


CASES = {
    "random": lambda rng: (_cloud(rng, 1100), None),
    "duplicates": lambda rng: (_duplicated(rng, 900), None),
    "lattice": lambda rng: (_lattice(700), None),
    "masked": lambda rng: (_cloud(rng, 800), rng.random(800) < 0.7),
    "sparse mask": lambda rng: (_cloud(rng, 600),
                                np.isin(np.arange(600), [3, 250, 599])),
    "no valid": lambda rng: (_cloud(rng, 300), np.zeros(300, bool)),
    "fewer than kk": lambda rng: (_cloud(rng, 7), None),
}


@pytest.mark.parametrize("kk", KKS)
@pytest.mark.parametrize("case", list(CASES))
def test_mirror_equals_plain_exact_search(case, kk):
    """The mirror under the card's plan is the plain exact search bit for
    bit: ascending distance, ties to the lower index, masked targets never,
    ``(0, inf)`` past the valid ones."""
    rng = np.random.default_rng(list(CASES).index(case) * 31 + kk)
    q, mask = CASES[case](rng)
    _same(self_knn_mirror(q, kk, mask), _plain(q, kk, mask))


@pytest.mark.parametrize("slice_len,window", [(256, 64), (512, 0),
                                               (1024, 64), (2048, 64),
                                               (256, 0), (512, 7),
                                               (1024, 2000)])
def test_mirror_equal_under_any_plan(slice_len, window):
    """Slices of any length (one slice: no merge) and any seed's window
    (none, shorter than kk, longer than the cloud) give the same output."""
    rng = np.random.default_rng(slice_len + window)
    q = _duplicated(rng, 1500)
    mask = rng.random(1500) < 0.9
    _same(self_knn_mirror(q, 9, mask, slice_len=slice_len, window=window),
          _plain(q, 9, mask))


def test_mirror_nan_points_as_plain():
    """A NaN point finds no neighbour, ``(0, inf)`` in every slot, and is
    nobody's neighbour, as the plain search ranks NaN above +inf."""
    rng = np.random.default_rng(5)
    q = _cloud(rng, 500)
    q[[3, 200, 401]] = np.nan
    q[17, 1] = np.nan
    idx, d = self_knn_mirror(q, 5)
    _same((idx, d), _plain(q, 5))
    assert np.isinf(d[[3, 17, 200, 401]]).all()
    assert not np.isin(idx[np.isfinite(d)], [3, 17, 200, 401]).any()


@pytest.mark.parametrize("kk", [5, K_MAX])
def test_mirror_batch_equals_each_element(kk):
    """A batch [B, M, 3] with masks [B, M]: each element the plain search
    of its own cloud and mask."""
    rng = np.random.default_rng(kk)
    q = np.stack([_cloud(rng, 700), _duplicated(rng, 700),
                  _cloud(rng, 700, 0.01)])
    mask = rng.random((3, 700)) < np.array([[1.0], [0.8], [0.3]])
    idx, d = self_knn_mirror(q, kk, mask)
    assert idx.shape == (3, 700, kk) and d.shape == (3, 700, kk)
    for b in range(3):
        _same((idx[b], d[b]), _plain(q[b], kk, mask[b]))
    _same((idx, d), _plain(q, kk, mask))


def test_mirror_on_the_hall_scan_in_its_order():
    """The OS1-16 hall scan's first 2,048 points in the scan's order (a
    column of 16 beams after another; 2 mm noise), the order the seed's
    window relies on: the plain search bit for bit, at k + 1 = 5 and 9."""
    from benchmark import scenes

    cloud = scenes.ouster_hall("assets/Donut_1024x16.csv",
                               "assets/beam_intrinsics.csv")[:2048]
    rng = np.random.default_rng(17)
    q = (cloud + rng.normal(0, 0.002, cloud.shape)).astype(np.float32)
    for kk in (5, 9):
        _same(self_knn_mirror(q, kk), _plain(q, kk))


@pytest.mark.parametrize("batch,m,kk", [(1, 16384, 5), (1, 16384, 9),
                                         (1, 100_000, 5), (32, 16384, 5),
                                         (1, 1000, 5), (1, 1, 1),
                                         (3, 257, K_MAX)])
def test_plan_covers_the_targets(batch, m, kk):
    """Every target in one slice, slices a multiple of 256 and at most the
    kernel's shared memory, and at the hall's 16,384 points enough blocks
    to fill the card: 512 blocks of 16 slices of 1,024."""
    slices, slice_len = plan_knn(batch, m, kk, 132)
    assert slice_len % 256 == 0 and slice_len <= knn_cuda.MAX_SLICE
    assert (slices - 1) * slice_len < m <= slices * slice_len
    blocks = sweep_blocks(batch, m, kk, 132)
    assert blocks == batch * -(-m // knn_cuda.rows_per_block(kk)) * slices
    if (batch, m, kk) == (1, 16384, 5):
        assert (slices, slice_len, blocks) == (16, 1024, 512)
    if m >= 16384:
        assert blocks >= 3 * 132


CUDA = torch.device("cuda", 0)
CPU = torch.device("cpu")


@pytest.mark.parametrize("device,m,kk,threshold,route", [
    (CUDA, 16384, 5, 100_000, True),
    (CUDA, 100_000, K_MAX, 100_000, True),
    (CUDA, 100_001, 5, 100_000, False),
    (CUDA, 16384, K_MAX + 1, 100_000, False),
    (CUDA, 16384, 9, 16384, True),
    (CUDA, 16384, 9, 16383, False),
    (CPU, 16384, 5, 100_000, False),
    (CPU, 10, 2, 100_000, False),
])
def test_kernel_route_rule(device, m, kk, threshold, route):
    """The kernel serves a normals search on a CUDA device up to the banded
    threshold and ``K_MAX``; the CPU and everything else stream."""
    assert tn.knn_kernel_route(device, m, kk, threshold) is route


def _mirror_as_kernel(monkeypatch):
    """Put the mirror in the kernel's place and admit every call to the
    kernel's route; returns the list of the calls it served."""
    calls = []

    def fake(q, kk, mask=None):
        calls.append((tuple(q.shape), kk, mask is not None))
        idx, d = self_knn_mirror(q.numpy(), kk,
                                 None if mask is None else mask.numpy())
        return torch.as_tensor(idx), torch.as_tensor(d)

    monkeypatch.setattr(knn_cuda, "self_knn_cuda", fake)
    monkeypatch.setattr(knn_cuda, "sm_count", lambda index: 132)
    monkeypatch.setattr(tn, "knn_kernel_route",
                        lambda device, m, kk, threshold: m <= threshold)
    return calls


@pytest.mark.parametrize("batched", [False, True])
def test_estimate_normals_on_the_kernel_route(monkeypatch, batched):
    """On the kernel's route ``estimate_normals`` searches the ``k + 1``
    nearest once (no re-rank), its normals the exact streaming route's bit
    for bit; the span ``knn`` counts ``kernel`` 1 and ``normals`` the
    sweep's blocks as ``tiles``."""
    rng = np.random.default_rng(3)
    q = torch.as_tensor(np.stack([_duplicated(rng, 600),
                                  _cloud(rng, 600)]) if batched
                        else _duplicated(rng, 600))
    mask = torch.as_tensor(rng.random(q.shape[:-1]) < 0.9)
    want = tn.estimate_normals(q, k=4, mask=mask, exact=True)
    calls = _mirror_as_kernel(monkeypatch)
    with timing.recording():
        got = tn.estimate_normals(q, k=4, mask=mask)
    spans = timing.recorded_spans()
    timing.clear_spans()
    assert calls == [(tuple(q.shape), 5, True)]
    assert torch.equal(got, want)
    (knn_span,) = [s for s in spans if s.name == "knn"]
    (nspan,) = [s for s in spans if s.name == "normals"]
    assert knn_span.attrs == {"kernel": 1}
    b = 2 if batched else 1
    assert nspan.attrs == {"rows": 600, "k": 4,
                           "tiles": sweep_blocks(b, 600, 5, 132)}


def test_estimate_normals_streams_off_the_route(monkeypatch):
    """Above the banded threshold (or off the card) the kernel is not
    called: the span ``knn`` counts ``kernel`` 0 and ``tiles`` keeps the
    stream's meaning."""
    rng = np.random.default_rng(4)
    q = torch.as_tensor(_cloud(rng, 500))
    calls = _mirror_as_kernel(monkeypatch)
    with timing.recording():
        tn.estimate_normals(q, k=4, banded_threshold=400, chunk=128)
    spans = timing.recorded_spans()
    timing.clear_spans()
    assert calls == []
    (knn_span,) = [s for s in spans if s.name == "knn"]
    (nspan,) = [s for s in spans if s.name == "normals"]
    assert knn_span.attrs == {"kernel": 0}
    assert nspan.attrs == {"rows": 500, "k": 4, "tiles": 4}


def test_plain_route_on_the_cpu_is_unchanged():
    """On the CPU ``estimate_normals`` keeps the norm form's ``k + 1 +
    RERANK`` and the re-rank: its normals those of the search and re-rank
    written out."""
    rng = np.random.default_rng(6)
    q = torch.as_tensor(_duplicated(rng, 700))
    idx, d = tn.self_knn(q, 5 + tn.RERANK)
    nbr = tn.rerank(q, idx, d, 5)[:, 1:]
    want = tn.smallest_eigenvector(tn._neighbour_covariance(q, nbr))[0]
    assert torch.equal(ft.estimate_normals(q, k=4), want)


def test_wrapper_refuses_a_cpu_tensor():
    """The wrapper takes CUDA tensors only and refuses before any launch."""
    before = knn_cuda.self_knn_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        knn_cuda.self_knn_cuda(torch.zeros(10, 3), 5)
    assert knn_cuda.self_knn_cuda.launches == before
