// The self-kNN of the normals prepass on the CUDA cores of Hopper (sm_90a):
// for every point of a cloud q [B, M, 3], its kk nearest valid points of
// the same cloud (itself included), ranked by the difference form.
//
// It replaces no TPU kernel: the JAX package selects the neighbours with
// lax.top_k over streamed distance tiles (fpcr_tpu/ops/normals.py:44), and
// the port's plain version (ops/normals.py::knn, exact=True) does the same
// with torch.topk over int64 (distance bits, position) keys. On the card
// that plain stream took 64 tile steps of cat + topk + gather at 16,384
// points, 3,488 launches and about 25 ms of device and 43 ms of host a
// call: the normals prepass set the pace of point-to-plane ICP. This
// kernel computes the same function in two launches.
//
// What it computes, bit for bit the plain version's: each pair's squared
// distance as (dx*dx + dy*dy) + dz*dz with d = p - q, every operation
// rounded on its own (__fsub_rn, __fmul_rn, __fadd_rn: no contraction);
// the kk smallest, ascending, ties to the lower target index; a masked
// target, and a distance that is NaN or +inf, never enters; a slot with no
// valid target left holds (0, +inf).
//
// What bounds it on this card: the CUDA cores' issue over M^2 pairs (at
// 16,384 points 268M pairs, about 9.5 instructions a pair: 3 FADD for the
// difference, 3 FMUL, 2 FADD, a compare, and a load and a branch every
// eight pairs; 0.056 ms at 7 instructions a pair and 33.5 T/s); device
// memory moves O(M * S * kk). Its design:
//   * the targets are cut into S slices (blockIdx.y) so that the sweep
//     fills the card (ops/knn_cuda.py::plan_knn); a block stages its slice
//     whole in shared memory by 4-byte cp.async copies in two groups (the
//     first kFirst targets, then the rest), a masked target and the
//     padding as NaN coordinates, which no compare admits;
//   * a thread holds kRows query rows, each with its sorted top-kk in
//     registers; one broadcast float4 load of a staged target feeds the
//     rows, and most pairs cost one compare against the row's threshold.
//     A row inserts a target only where its distance is strictly below
//     the threshold, and the slice's targets come in ascending index, so
//     an equal distance never displaces a lower index;
//   * the threshold starts at a seed: while the copies land, each row
//     ranks the `window` points around it in index order (a scan's
//     neighbours lie there: the same beam's next columns, the next beams)
//     and admits from then on only distances at most the kk-th of those.
//     That kk-th bounds the row's true kk-th from above, so no neighbour
//     is lost; it saves the early insertions of every slice, which diverge
//     across a warp. Fewer than kk valid points in the window leave the
//     threshold at +inf;
//   * a merge kernel (one thread a row) reduces the S partial top-kk
//     lists by the same strict insertion, slice by slice in index order,
//     each list ascending: the order (distance, index). One slice writes
//     the output directly and needs no merge.
// Measured at the hall scan's 16,384 points, kk = 5 (NVIDIA H100 80GB
// HBM3, 700 W; PERF.md section 6): 0.218 ms, the sweep 0.211 (0.480
// without the seed; one target a step, 0.255), the merge 0.006, against
// the plain stream's ~50 ms. What is left over the bound is insertions
// that diverge across a warp, most from the scan's rangeless returns,
// 4,361 points within millimetres of the origin in every slice.
//
// Layouts: q [B, M, 3] float32, mask [B, M] uint8 (null: every point
// valid); partials and outputs [B, S, M, kk] and [B, M, kk], distances
// float32, indices int32. kk is a template parameter from 1 to kKMax.
//
// C interface (loaded with ctypes). Pointers are device pointers; `stream`
// is a cudaStream_t. Each function launches one kernel, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;    // threads a block
constexpr int kKMax = 16;        // the largest kk
constexpr int kMaxSlice = 2048;  // targets a block holds (32 KB)
constexpr int kFirst = 256;      // targets of the first copy group
constexpr int kQuantum = 32;     // a slice is staged in whole quanta

// query rows a thread: four up to kk = 8, two above (the lists' registers)
__host__ __device__ constexpr int rows_for(int kk) {
    return kk <= 8 ? 4 : 2;
}

__device__ __forceinline__ float sqdist(float px, float py, float pz,
                                        float qx, float qy, float qz) {
    const float dx = __fsub_rn(px, qx);
    const float dy = __fsub_rn(py, qy);
    const float dz = __fsub_rn(pz, qz);
    return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                     __fmul_rn(dz, dz));
}

// Insert (d, j) into the ascending list (D, I) of kk entries, where d is
// below its last: after every entry whose distance is at most d (those
// hold lower indices), the last entry falling off.
template <int kk>
__device__ __forceinline__ void insert(float (&D)[kk], int (&I)[kk], float d,
                                       int j) {
#pragma unroll
    for (int s = kk - 1; s > 0; --s) {
        if (d < D[s - 1]) {
            D[s] = D[s - 1];
            I[s] = I[s - 1];
        } else if (d < D[s]) {
            D[s] = d;
            I[s] = j;
        }
    }
    if (d < D[0]) {
        D[0] = d;
        I[0] = j;
    }
}

// the least float above a non-negative d (+inf stays +inf): d' < it
// exactly where d' <= d
__device__ __forceinline__ float next_up(float d) {
    return d == CUDART_INF_F ? d : __int_as_float(__float_as_int(d) + 1);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Stage targets [lo, hi) of the slice into tile[] as (x, y, z, -): a valid
// one by cp.async, a masked one and the padding past `count` as NaN.
__device__ __forceinline__ void stage(float4* tile,
                                      const float* __restrict__ q,
                                      const uint8_t* __restrict__ mask,
                                      int j_begin, int count, int lo, int hi) {
    for (int s = lo + static_cast<int>(threadIdx.x); s < hi; s += kThreads) {
        float4* t = tile + s;
        const int j = j_begin + s;
        if (s < count && (mask == nullptr || mask[j] != 0)) {
            cp_async4(&t->x, q + 3 * static_cast<size_t>(j));
            cp_async4(&t->y, q + 3 * static_cast<size_t>(j) + 1);
            cp_async4(&t->z, q + 3 * static_cast<size_t>(j) + 2);
        } else {
            *t = make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, 0.0f);
        }
    }
}

// Rows' step over two staged targets ta, tb (indices j, j + 1): the eight
// distances, one branch where any passes its row's threshold, and then
// each row's insertions, ta's before tb's, each tested against the
// threshold that the insertions before it leave.
template <int kk, int kRows>
__device__ __forceinline__ void sweep_pair(
    const float (&px)[kRows], const float (&py)[kRows],
    const float (&pz)[kRows], float (&thr)[kRows], float (&D)[kRows][kk],
    int (&I)[kRows][kk], float4 ta, float4 tb, int j) {
    float da[kRows], db[kRows];
    bool any = false;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        da[r] = sqdist(px[r], py[r], pz[r], ta.x, ta.y, ta.z);
        db[r] = sqdist(px[r], py[r], pz[r], tb.x, tb.y, tb.z);
        any |= (da[r] < thr[r]) | (db[r] < thr[r]);
    }
    if (any) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            if (da[r] < thr[r]) {
                insert<kk>(D[r], I[r], da[r], j);
                thr[r] = fminf(thr[r], D[r][kk - 1]);
            }
            if (db[r] < thr[r]) {
                insert<kk>(D[r], I[r], db[r], j + 1);
                thr[r] = fminf(thr[r], D[r][kk - 1]);
            }
        }
    }
}

// One slice of targets against kThreads * kRows query rows of one batch
// element (blockIdx.z): each row's partial top-kk over the slice, among
// the distances the seed admits, to part_d / part_i [B, S, M, kk].
// `window` is the seed's length (0: no seed, the threshold starts at +inf).
template <int kk>
__global__ void __launch_bounds__(kThreads)
knn_sweep_kernel(const float* __restrict__ q_all,
                 const uint8_t* __restrict__ mask_all, int m, int slice_len,
                 int window, float* __restrict__ part_d,
                 int* __restrict__ part_i) {
    constexpr int kRows = rows_for(kk);
    __shared__ __align__(16) float4 tile[kMaxSlice];

    const int b = blockIdx.z;
    const int slice = blockIdx.y;
    const int slices = gridDim.y;
    const float* __restrict__ q = q_all + 3 * static_cast<size_t>(b) * m;
    const uint8_t* __restrict__ mask =
        mask_all == nullptr ? nullptr : mask_all + static_cast<size_t>(b) * m;
    const int j_begin = slice * slice_len;
    const int count = min(m, j_begin + slice_len) - j_begin;
    const int padded = (count + kQuantum - 1) / kQuantum * kQuantum;
    const int first = min(padded, kFirst);
    const int row0 = blockIdx.x * kThreads * kRows + threadIdx.x;

    stage(tile, q, mask, j_begin, count, 0, first);
    cp_async_commit();
    stage(tile, q, mask, j_begin, count, first, padded);
    cp_async_commit();

    float px[kRows], py[kRows], pz[kRows], thr[kRows];
    float D[kRows][kk];
    int I[kRows][kk];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        // rows past m load the last row and are never written back
        const int i = min(row0 + r * kThreads, m - 1);
        px[r] = q[3 * static_cast<size_t>(i)];
        py[r] = q[3 * static_cast<size_t>(i) + 1];
        pz[r] = q[3 * static_cast<size_t>(i) + 2];
#pragma unroll
        for (int c = 0; c < kk; ++c) {
            D[r][c] = CUDART_INF_F;
            I[r][c] = 0;
        }
        thr[r] = CUDART_INF_F;
    }

    // the seed, while the copies land: the kk-th distance among the
    // `window` points around the row (clamped into [0, m)), read from
    // device memory; the lists start empty again after it
    if (window > 0) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            const int i = min(row0 + r * kThreads, m - 1);
            const int lo = min(max(i - window / 2, 0), max(m - window, 0));
            const int hi = min(lo + window, m);
#pragma unroll 4
            for (int j = lo; j < hi; ++j) {
                if (mask != nullptr && mask[j] == 0) continue;
                const float d = sqdist(px[r], py[r], pz[r],
                                       q[3 * static_cast<size_t>(j)],
                                       q[3 * static_cast<size_t>(j) + 1],
                                       q[3 * static_cast<size_t>(j) + 2]);
                if (d < D[r][kk - 1]) insert<kk>(D[r], I[r], d, j);
            }
            thr[r] = next_up(D[r][kk - 1]);
#pragma unroll
            for (int c = 0; c < kk; ++c) {
                D[r][c] = CUDART_INF_F;
                I[r][c] = 0;
            }
        }
    }

    // the first copy group, then the rest (both whole quanta: even)
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll 2
    for (int t = 0; t < first; t += 2) {
        sweep_pair<kk, kRows>(px, py, pz, thr, D, I, tile[t], tile[t + 1],
                              j_begin + t);
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll 2
    for (int t = first; t < padded; t += 2) {
        sweep_pair<kk, kRows>(px, py, pz, thr, D, I, tile[t], tile[t + 1],
                              j_begin + t);
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        const int i = row0 + r * kThreads;
        if (i >= m) continue;
        const size_t o =
            ((static_cast<size_t>(b) * slices + slice) * m + i) * kk;
#pragma unroll
        for (int c = 0; c < kk; ++c) {
            part_d[o + c] = D[r][c];
            part_i[o + c] = I[r][c];
        }
    }
}

// The merge, a thread a row: the S partial lists of the row, slice by
// slice (ascending target index) and each ascending, by strict insertion;
// a list is left at its first entry that the row's threshold refuses.
template <int kk>
__global__ void __launch_bounds__(kThreads)
knn_merge_kernel(const float* __restrict__ part_d,
                 const int* __restrict__ part_i, int batch, int m, int slices,
                 float* __restrict__ out_d, int* __restrict__ out_i) {
    const size_t row = static_cast<size_t>(blockIdx.x) * kThreads +
                       threadIdx.x;
    if (row >= static_cast<size_t>(batch) * m) return;
    const size_t b = row / m;
    const size_t i = row % m;
    float D[kk];
    int I[kk];
#pragma unroll
    for (int c = 0; c < kk; ++c) {
        D[c] = CUDART_INF_F;
        I[c] = 0;
    }
    for (int s = 0; s < slices; ++s) {
        const size_t o = ((b * slices + s) * m + i) * kk;
#pragma unroll
        for (int c = 0; c < kk; ++c) {
            const float d = part_d[o + c];
            if (!(d < D[kk - 1])) break;
            insert<kk>(D, I, d, part_i[o + c]);
        }
    }
    const size_t o = row * kk;
#pragma unroll
    for (int c = 0; c < kk; ++c) {
        out_d[o + c] = D[c];
        out_i[o + c] = I[c];
    }
}

template <int kk>
cudaError_t sweep(const float* q, const uint8_t* mask, int batch, int m,
                  int slice_len, int window, float* part_d, int* part_i,
                  cudaStream_t stream) {
    constexpr int kRowsPerBlock = kThreads * rows_for(kk);
    const dim3 grid((m + kRowsPerBlock - 1) / kRowsPerBlock,
                    (m + slice_len - 1) / slice_len, batch);
    knn_sweep_kernel<kk><<<grid, kThreads, 0, stream>>>(
        q, mask, m, slice_len, window, part_d, part_i);
    return cudaGetLastError();
}

template <int kk>
cudaError_t merge(const float* part_d, const int* part_i, int batch, int m,
                  int slices, float* out_d, int* out_i, cudaStream_t stream) {
    const size_t rows = static_cast<size_t>(batch) * m;
    const unsigned blocks =
        static_cast<unsigned>((rows + kThreads - 1) / kThreads);
    knn_merge_kernel<kk><<<blocks, kThreads, 0, stream>>>(
        part_d, part_i, batch, m, slices, out_d, out_i);
    return cudaGetLastError();
}

}  // namespace

#define FPCR_KNN_CASES(X)                                                   \
    X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13)    \
    X(14) X(15) X(16)

extern "C" {

int fpcr_knn_k_max(void) { return kKMax; }

int fpcr_knn_max_slice(void) { return kMaxSlice; }

int fpcr_knn_rows_per_block(int kk) { return kThreads * rows_for(kk); }

// The sweep: slices of `slice_len` targets (a multiple of 32, at most
// fpcr_knn_max_slice()) over blockIdx.y, batch elements over blockIdx.z,
// each row's partial top-kk of each slice into part_d / part_i [batch,
// ceil(m / slice_len), m, kk]; with one slice, the output. `window` the
// seed's points around a row (ops/knn_cuda.py::WINDOW on the path; 0 no
// seed, for timing).
int fpcr_knn_sweep(const float* q, const uint8_t* mask, int batch, int m,
                   int kk, int slice_len, int window, float* part_d,
                   int* part_i, void* stream) {
    if (batch <= 0 || batch > 65535 || m <= 0 || slice_len <= 0 ||
        slice_len > kMaxSlice || slice_len % kQuantum != 0 || window < 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const auto s = static_cast<cudaStream_t>(stream);
    switch (kk) {
#define FPCR_KNN_SWEEP(K)                                                   \
        case K:                                                             \
            return static_cast<int>(sweep<K>(q, mask, batch, m, slice_len,  \
                                             window, part_d, part_i, s));
        FPCR_KNN_CASES(FPCR_KNN_SWEEP)
#undef FPCR_KNN_SWEEP
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// The merge of the sweep's [batch, slices, m, kk] partials into out_d /
// out_i [batch, m, kk].
int fpcr_knn_merge(const float* part_d, const int* part_i, int batch, int m,
                   int kk, int slices, float* out_d, int* out_i,
                   void* stream) {
    if (batch <= 0 || m <= 0 || slices <= 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const auto s = static_cast<cudaStream_t>(stream);
    switch (kk) {
#define FPCR_KNN_MERGE(K)                                                   \
        case K:                                                             \
            return static_cast<int>(merge<K>(part_d, part_i, batch, m,      \
                                             slices, out_d, out_i, s));
        FPCR_KNN_CASES(FPCR_KNN_MERGE)
#undef FPCR_KNN_MERGE
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // extern "C"
