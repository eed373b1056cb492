// Exact brute-force nearest-neighbour search for Hopper (sm_90a).
//
// Replaces the TPU kernel fpcr_tpu/ops/matching_pallas.py::nn_argmin_pallas
// (kernel body _matching_kernel, modes "packed6" and "highest"): for every
// source point p_i, the index and squared distance of the nearest valid
// target q_j, argmin_j ||p_i - q_j||^2. Ties go to the lowest index. A row
// with no valid target gets index 0 and distance +inf, and every index lies
// in [0, m-1].
//
// What bounds it on this card: FP32 arithmetic over the N*M pairs. The
// targets are tiny (16 bytes each once staged) and live in shared memory
// and L2, so device-memory traffic is O(N + M) while the work is O(N * M).
// The design therefore spends as few instructions per pair as it can on the
// CUDA cores:
//   * the distance is the difference form, dx*dx + dy*dy + dz*dz as FMAs
//     (the reference CUDA code's own arithmetic). It is exact to a few ulp,
//     never negative, and needs no clamp; the expansion form would not save
//     instructions on CUDA cores;
//   * a target is staged as float4 (x, y, z, w) with w = 0 for a valid
//     target and +inf for a masked one, folded in as the first FMA's addend,
//     so the mask costs nothing per pair and a masked target can never win;
//   * each thread keeps PPT source points in registers, so one broadcast
//     shared-memory load of a target feeds PPT pairs;
//   * each thread scans its targets in ascending index with a strict '<',
//     which gives the first minimum without any extra compare.
// At the main path's sizes (8k-36k points) one source point per thread
// would launch fewer blocks than the card has SMs, so the target range is
// split over blockIdx.y into slices. Each slice writes a partial
// (distance, index) pair per row, and a second small kernel combines the
// slices in slice order comparing (distance, index) pairs, which keeps the
// first-minimum rule across slices.
//
// C interface (loaded with ctypes). Pointers are device pointers; `stream`
// is a cudaStream_t. Each function launches one kernel, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per block of the partial kernel
constexpr int kPPT = 2;        // source points held per thread
constexpr int kTile = 1024;    // targets staged in shared memory per step

__global__ void __launch_bounds__(kThreads)
nn_partial_kernel(const float* __restrict__ p, const float* __restrict__ q,
                  const uint8_t* __restrict__ q_mask, int n, int m,
                  int slice_len, float* __restrict__ part_d,
                  int* __restrict__ part_i) {
    __shared__ float4 tile[kTile];

    const int slice = blockIdx.y;
    const int j_begin = slice * slice_len;
    const int j_end = min(m, j_begin + slice_len);
    const int row0 = blockIdx.x * (kThreads * kPPT) + threadIdx.x;

    float px[kPPT], py[kPPT], pz[kPPT], best_d[kPPT];
    int best_i[kPPT];
#pragma unroll
    for (int k = 0; k < kPPT; ++k) {
        // rows past n load the last row and are never written back
        const int i = min(row0 + k * kThreads, n - 1);
        px[k] = p[3 * i];
        py[k] = p[3 * i + 1];
        pz[k] = p[3 * i + 2];
        best_d[k] = CUDART_INF_F;
        best_i[k] = 0;
    }

    for (int t0 = j_begin; t0 < j_end; t0 += kTile) {
        const int count = min(kTile, j_end - t0);
        __syncthreads();  // every thread is done with the previous tile
        for (int s = threadIdx.x; s < count; s += kThreads) {
            const int j = t0 + s;
            const bool valid = (q_mask == nullptr) || (q_mask[j] != 0);
            tile[s] = make_float4(q[3 * j], q[3 * j + 1], q[3 * j + 2],
                                  valid ? 0.0f : CUDART_INF_F);
        }
        __syncthreads();
#pragma unroll 4
        for (int s = 0; s < count; ++s) {
            const float4 t = tile[s];
#pragma unroll
            for (int k = 0; k < kPPT; ++k) {
                const float dx = px[k] - t.x;
                const float dy = py[k] - t.y;
                const float dz = pz[k] - t.z;
                const float d = fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, t.w)));
                if (d < best_d[k]) {  // strict: the first minimum stays
                    best_d[k] = d;
                    best_i[k] = t0 + s;
                }
            }
        }
    }

#pragma unroll
    for (int k = 0; k < kPPT; ++k) {
        const int i = row0 + k * kThreads;
        if (i < n) {
            const size_t o = static_cast<size_t>(slice) * n + i;
            part_d[o] = best_d[k];
            part_i[o] = best_i[k];
        }
    }
}

__global__ void nn_combine_kernel(const float* __restrict__ part_d,
                                  const int* __restrict__ part_i, int n,
                                  int slices, float* __restrict__ out_d,
                                  int* __restrict__ out_i) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float bd = CUDART_INF_F;
    int bi = 0;
    for (int s = 0; s < slices; ++s) {
        const size_t o = static_cast<size_t>(s) * n + i;
        const float d = part_d[o];
        const int j = part_i[o];
        if (d < bd || (d == bd && j < bi)) {
            bd = d;
            bi = j;
        }
    }
    out_d[i] = bd;
    out_i[i] = bi;
}

}  // namespace

extern "C" {

int fpcr_nn_rows_per_block(void) { return kThreads * kPPT; }

// Partial NN of rows [0, n) over target slices of `slice_len` targets:
// writes part_d/part_i as [slices, n] with slices = ceil(m / slice_len).
// With one slice these are the final outputs.
int fpcr_nn_partial(const float* p, const float* q, const uint8_t* q_mask,
                    int n, int m, int slice_len, float* part_d, int* part_i,
                    void* stream) {
    const int slices = (m + slice_len - 1) / slice_len;
    const int row_blocks = (n + kThreads * kPPT - 1) / (kThreads * kPPT);
    dim3 grid(row_blocks, slices);
    nn_partial_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        p, q, q_mask, n, m, slice_len, part_d, part_i);
    return static_cast<int>(cudaGetLastError());
}

// Combine [slices, n] partials into out_d/out_i [n], first minimum wins.
int fpcr_nn_combine(const float* part_d, const int* part_i, int n, int slices,
                    float* out_d, int* out_i, void* stream) {
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    nn_combine_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        part_d, part_i, n, slices, out_d, out_i);
    return static_cast<int>(cudaGetLastError());
}

const char* fpcr_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
