// Fused direct7 NDT moments for Hopper (sm_90a): kernel K4.
//
// Replaces the TPU kernel fpcr_tpu/ops/ndt_pallas.py::ndt_fused_moments
// (kernel bodies _fused_kernel_factory and _fused_kernel_pipelined_factory,
// every mask / schedule / wsplit mode). The query rows are sorted by voxel
// key; chunk c holds rows [c*chunk, (c+1)*chunk) and reads the band of table
// rows [bases[c], bases[c] + band), clipped to the m rows of the table. The
// wrapper computes the bases, the query cells and the chunk anchors on the
// device, formula for formula the TPU kernel's (ops/ndt.py::fused_geometry).
//
// For every query i the kernel sums, over its direct7 neighbour voxels (its
// own cell and the six face neighbours; direct1: its own cell only) whose
// key is in the band and whose voxel is valid, in ascending key order:
//   out[i, 0:6]  += w * S          (S upper triangle 00 01 02 11 12 22)
//   out[i, 6:9]  += w * S mu'
//   out[i, 9]    += w * mu'^T S mu'
//   out[i, 10]   += 1              (neighbour count)
//   out[i, 11]   += q
// with mu' = (mu - lo) - a, x' = (x - lo) - a for the chunk's anchor a,
// r = x' - mu', q = r^T S r and w = d1d2 * expf(min(-d2/2 * q, 0)), and
// writes xprime[i] = x'. Lanes 12:16 are 0. A neighbour outside the band is a
// miss: the TPU kernel's banded miss semantics.
//
// What bounds it on this card: latency, not arithmetic or bytes. A query
// needs at most 7 table rows, ~200 flops and 76 bytes of output, so at 1M
// points the kernel moves ~80 MB to device memory; what remains is finding
// the neighbours. The TPU kernel tested every band row against every query
// ([band, chunk] masks and three MXU matmuls, ~1.2G pairs at 1M points with
// band 1152). Here each query binary-searches its (at most) 7 neighbour keys
// in the band instead: ~77 dependent shared-memory reads, no pair loop.
//   * one block of 128 threads per 128 queries of a chunk (lookup_chunk is a
//     multiple of 128), one query per thread: the query's neighbour keys and
//     row indices and its 12 sums stay in registers;
//   * the band's keys stream through shared memory in tiles of kTile keys,
//     so any band length works (the resolver's cap gives 8,576 rows); a key
//     is searched only in the tile whose key range holds it;
//   * a hit row is read from device memory as four float4 loads (the table
//     is row-major, 16 floats a row); the band's rows are shared by the
//     chunk's queries and stay in L2;
//   * the neighbours are summed in ascending key order, one thread a query:
//     no atomics, and the sums are the same on every run;
//   * q is computed directly from r (no bilinear bf16 expansion), with expf,
//     not __expf.
// Not carried over from the TPU kernel: the neighbourhood-mask matmul and
// its VPU twin, the h+m+l bf16 operand splits, the weighted one-hot
// extraction matmuls, the [16, m_pad] lane-major table and the VMEM rings.
//
// C interface (loaded with ctypes). Pointers are device pointers; `stream`
// is a cudaStream_t. The function launches one kernel, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // queries per block
constexpr int kTile = 2048;    // band keys staged in shared memory per step
constexpr int kAxisBits = 10;
constexpr int kAxisMax = (1 << kAxisBits) - 1;
constexpr int kNeighbours = 7;

// the direct7 offsets in ascending key order; direct1 is entry 3 alone
__constant__ int kOffsets[kNeighbours][3] = {
    {-1, 0, 0}, {0, -1, 0}, {0, 0, -1}, {0, 0, 0},
    {0, 0, 1},  {0, 1, 0},  {1, 0, 0}};

__device__ __forceinline__ int lower_bound(const int* keys, int count,
                                           int key) {
    int lo = 0, hi = count;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (keys[mid] < key) {
            lo = mid + 1;
        } else {
            hi = mid;
        }
    }
    return lo;
}

__global__ void __launch_bounds__(kThreads)
ndt_moments_kernel(const float* __restrict__ x, const float* __restrict__ lo,
                   const int* __restrict__ cells,
                   const int* __restrict__ bases,
                   const float* __restrict__ anchors,
                   const int* __restrict__ keys,
                   const float* __restrict__ tab, int n, int m, int chunk,
                   int band, int direct7, float d1d2, float d2,
                   float* __restrict__ out, float* __restrict__ xprime) {
    __shared__ int tile[kTile];

    const int blocks_per_chunk = chunk / kThreads;
    const int c = static_cast<int>(blockIdx.x) / blocks_per_chunk;
    const int i = c * chunk
                  + (static_cast<int>(blockIdx.x) - c * blocks_per_chunk)
                        * kThreads
                  + static_cast<int>(threadIdx.x);
    const bool live = i < n;
    const int base = bases[c];
    const int end = min(base + band, m);
    const int o_begin = direct7 ? 0 : 3;
    const int o_end = direct7 ? kNeighbours : 4;

    // the neighbour keys, -1 where a neighbour cell is off the grid (every
    // table key is >= 0, so -1 is never found)
    int want[kNeighbours];
    int row[kNeighbours];
    const int cx = live ? cells[3 * i] : -1;
    const int cy = live ? cells[3 * i + 1] : -1;
    const int cz = live ? cells[3 * i + 2] : -1;
#pragma unroll
    for (int o = 0; o < kNeighbours; ++o) {
        const int nx = cx + kOffsets[o][0];
        const int ny = cy + kOffsets[o][1];
        const int nz = cz + kOffsets[o][2];
        const bool on_grid = nx >= 0 && nx <= kAxisMax && ny >= 0
                             && ny <= kAxisMax && nz >= 0 && nz <= kAxisMax;
        want[o] = (o >= o_begin && o < o_end && on_grid)
                      ? (nx << (2 * kAxisBits)) | (ny << kAxisBits) | nz
                      : -1;
        row[o] = -1;
    }

    for (int t0 = base; t0 < end; t0 += kTile) {
        const int count = min(kTile, end - t0);
        __syncthreads();  // every thread is done with the previous tile
        for (int s = static_cast<int>(threadIdx.x); s < count; s += kThreads) {
            tile[s] = keys[t0 + s];
        }
        __syncthreads();
        const int first = tile[0];
        const int last = tile[count - 1];
#pragma unroll
        for (int o = 0; o < kNeighbours; ++o) {
            const int k = want[o];
            if (k >= first && k <= last) {
                const int p = lower_bound(tile, count, k);
                if (tile[p] == k) {
                    row[o] = t0 + p;
                }
            }
        }
    }
    if (!live) {
        return;
    }

    const float a0 = anchors[3 * c];
    const float a1 = anchors[3 * c + 1];
    const float a2 = anchors[3 * c + 2];
    const float x0 = (x[3 * i] - lo[0]) - a0;
    const float x1 = (x[3 * i + 1] - lo[1]) - a1;
    const float x2 = (x[3 * i + 2] - lo[2]) - a2;
    const float nh = -0.5f * d2;
    float acc[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) {
        acc[k] = 0.0f;
    }
#pragma unroll
    for (int o = 0; o < kNeighbours; ++o) {
        if (row[o] < 0) {
            continue;
        }
        // lanes [mu-lo (3) | S (6) | valid | 0 ...]
        const float4* t4 =
            reinterpret_cast<const float4*>(tab + 16 * static_cast<size_t>(row[o]));
        const float4 v0 = __ldg(t4);
        const float4 v1 = __ldg(t4 + 1);
        const float4 v2 = __ldg(t4 + 2);
        if (!(v2.y > 0.5f)) {
            continue;  // an invalid (under-populated) voxel
        }
        const float m0 = v0.x - a0, m1 = v0.y - a1, m2 = v0.z - a2;
        const float s00 = v0.w, s01 = v1.x, s02 = v1.y;
        const float s11 = v1.z, s12 = v1.w, s22 = v2.x;
        const float r0 = x0 - m0, r1 = x1 - m1, r2 = x2 - m2;
        const float sr0 = s00 * r0 + s01 * r1 + s02 * r2;
        const float sr1 = s01 * r0 + s11 * r1 + s12 * r2;
        const float sr2 = s02 * r0 + s12 * r1 + s22 * r2;
        const float q = r0 * sr0 + r1 * sr1 + r2 * sr2;
        const float w = d1d2 > 0.0f ? d1d2 * expf(fminf(nh * q, 0.0f)) : 0.0f;
        const float sm0 = s00 * m0 + s01 * m1 + s02 * m2;
        const float sm1 = s01 * m0 + s11 * m1 + s12 * m2;
        const float sm2 = s02 * m0 + s12 * m1 + s22 * m2;
        acc[0] += w * s00;
        acc[1] += w * s01;
        acc[2] += w * s02;
        acc[3] += w * s11;
        acc[4] += w * s12;
        acc[5] += w * s22;
        acc[6] += w * sm0;
        acc[7] += w * sm1;
        acc[8] += w * sm2;
        acc[9] += w * (m0 * sm0 + m1 * sm1 + m2 * sm2);
        acc[10] += 1.0f;
        acc[11] += q;
    }
    float4* o4 = reinterpret_cast<float4*>(out + 16 * static_cast<size_t>(i));
    o4[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    o4[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    o4[2] = make_float4(acc[8], acc[9], acc[10], acc[11]);
    o4[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    xprime[3 * i] = x0;
    xprime[3 * i + 1] = x1;
    xprime[3 * i + 2] = x2;
}

}  // namespace

extern "C" {

// Queries x[n,3] (voxel-key-sorted) with their cells[n,3], in num_chunks
// chunks of `chunk` rows (a multiple of 128), against the table keys[m] and
// tab[m,16]; chunk c reads rows [bases[c], bases[c] + band) with anchor
// anchors[c,3]. Writes out[n,16] and xprime[n,3].
int fpcr_ndt_moments(const float* x, const float* lo, const int* cells,
                     const int* bases, const float* anchors, int num_chunks,
                     const int* keys, const float* tab, int n, int m,
                     int chunk, int band, int direct7, float d1d2, float d2,
                     float* out, float* xprime, void* stream) {
    const int blocks = num_chunks * (chunk / kThreads);
    ndt_moments_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        x, lo, cells, bases, anchors, keys, tab, n, m, chunk, band, direct7,
        d1d2, d2, out, xprime);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
