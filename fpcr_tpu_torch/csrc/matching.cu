// Brute-force nearest-neighbour search for Hopper (sm_90a): kernels K1, K2
// and the min-only sweep.
//
// K1 replaces the TPU kernel fpcr_tpu/ops/matching_pallas.py::
// nn_argmin_pallas (kernel body _matching_kernel, modes "packed6" and
// "highest"): for every source point p_i, the index and squared distance of
// the nearest valid target q_j, argmin_j ||p_i - q_j||^2. Ties go to the
// lowest index. A row with no valid target gets index 0 and distance +inf,
// and every index lies in [0, m-1].
//
// K2 replaces the same function's mode "packed6_idx" (kernel body
// _packed_idx_kernel) and the packed-int study kernel
// scripts/exp_packed_reduction.py::_kern_pint: min and argmin collapse into
// one int32 min over keys (bits(d_ij) & ~(2^b - 1)) | j. A non-negative
// float's bits order as an int32, so the key orders by the distance with its
// low b mantissa bits dropped, then by the index: ties within a bucket go to
// the lowest index. The running key starts at 0x7F7FFFFF (the bits of the
// largest finite float); a masked target's distance is +inf, whose bits
// 0x7F800000 exceed it, so a masked target never wins. An epilogue unpacks
// the key, clips the index to [0, m-1] and recomputes the exact distance to
// the selected target; a row whose key is still the initial one has no
// valid target and gets index 0 and +inf (K1's convention, not the TPU
// kernel's index >= m). The quantized distance is never returned.
//
// The min-only sweep replaces scripts/exp_packed_reduction.py::_kern_min:
// the least squared distance per row and nothing else, the floor of the two
// reductions above.
//
// What bounds them on this card: FP32 arithmetic over the N*M pairs. The
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
//   * K1 scans its targets in ascending index with a strict '<', which gives
//     the first minimum without any extra compare; K2 spends one LOP3 and
//     one integer min a pair in place of K1's compare and two selects; the
//     min-only sweep one float min.
// At the main path's sizes (8k-36k points) one source point per thread
// would launch fewer blocks than the card has SMs, so the target range is
// split over blockIdx.y into slices. Each slice writes a partial result per
// row, and a second small kernel combines the slices: K1 in slice order
// comparing (distance, index) pairs, which keeps the first-minimum rule
// across slices; K2 and the min-only sweep by a min, which is order-free.
// K2's combine is its epilogue, so K2 always launches two kernels.
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
constexpr int kKeyInit = 0x7F7FFFFF;  // bits of the largest finite float

enum class Reduce { kArgmin, kPacked, kMin };

// One slice of targets against kPPT * kThreads source rows. kArgmin writes
// part_d and part_i, kPacked the keys to part_i, kMin part_d.
template <Reduce R>
__global__ void __launch_bounds__(kThreads)
nn_partial_kernel(const float* __restrict__ p, const float* __restrict__ q,
                  const uint8_t* __restrict__ q_mask, int n, int m,
                  int slice_len, int idx_bits, float* __restrict__ part_d,
                  int* __restrict__ part_i) {
    __shared__ float4 tile[kTile];

    const int slice = blockIdx.y;
    const int j_begin = slice * slice_len;
    const int j_end = min(m, j_begin + slice_len);
    const int row0 = blockIdx.x * (kThreads * kPPT) + threadIdx.x;
    const int keep = ~((1 << idx_bits) - 1);  // the distance bits K2 keeps

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
        best_i[k] = R == Reduce::kPacked ? kKeyInit : 0;
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
            const int j = t0 + s;
#pragma unroll
            for (int k = 0; k < kPPT; ++k) {
                const float dx = px[k] - t.x;
                const float dy = py[k] - t.y;
                const float dz = pz[k] - t.z;
                const float d = fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, t.w)));
                if constexpr (R == Reduce::kArgmin) {
                    if (d < best_d[k]) {  // strict: the first minimum stays
                        best_d[k] = d;
                        best_i[k] = j;
                    }
                } else if constexpr (R == Reduce::kPacked) {
                    best_i[k] = min(best_i[k], (__float_as_int(d) & keep) | j);
                } else {
                    best_d[k] = fminf(best_d[k], d);
                }
            }
        }
    }

#pragma unroll
    for (int k = 0; k < kPPT; ++k) {
        const int i = row0 + k * kThreads;
        if (i < n) {
            const size_t o = static_cast<size_t>(slice) * n + i;
            if constexpr (R != Reduce::kPacked) part_d[o] = best_d[k];
            if constexpr (R != Reduce::kMin) part_i[o] = best_i[k];
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

// K2's epilogue: the least key over the slices, unpacked; the exact
// distance to the selected target in the difference form.
__global__ void nn_packed_epilogue_kernel(const float* __restrict__ p,
                                          const float* __restrict__ q,
                                          const int* __restrict__ part_key,
                                          int n, int m, int slices,
                                          int idx_bits,
                                          float* __restrict__ out_d,
                                          int* __restrict__ out_i) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    int key = kKeyInit;
    for (int s = 0; s < slices; ++s) {
        key = min(key, part_key[static_cast<size_t>(s) * n + i]);
    }
    if (key == kKeyInit) {  // no valid target
        out_d[i] = CUDART_INF_F;
        out_i[i] = 0;
        return;
    }
    const int j = min(key & ((1 << idx_bits) - 1), m - 1);
    const float dx = p[3 * i] - q[3 * j];
    const float dy = p[3 * i + 1] - q[3 * j + 1];
    const float dz = p[3 * i + 2] - q[3 * j + 2];
    out_d[i] = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
    out_i[i] = j;
}

__global__ void nn_min_combine_kernel(const float* __restrict__ part_d, int n,
                                      int slices, float* __restrict__ out_d) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float bd = CUDART_INF_F;
    for (int s = 0; s < slices; ++s) {
        bd = fminf(bd, part_d[static_cast<size_t>(s) * n + i]);
    }
    out_d[i] = bd;
}

constexpr int kCombineThreads = 256;

dim3 partial_grid(int n, int m, int slice_len) {
    const int slices = (m + slice_len - 1) / slice_len;
    const int row_blocks = (n + kThreads * kPPT - 1) / (kThreads * kPPT);
    return dim3(row_blocks, slices);
}

int combine_blocks(int n) {
    return (n + kCombineThreads - 1) / kCombineThreads;
}

}  // namespace

extern "C" {

int fpcr_nn_rows_per_block(void) { return kThreads * kPPT; }

// K1's partial NN of rows [0, n) over target slices of `slice_len` targets:
// writes part_d/part_i as [slices, n] with slices = ceil(m / slice_len).
// With one slice these are the final outputs.
int fpcr_nn_partial(const float* p, const float* q, const uint8_t* q_mask,
                    int n, int m, int slice_len, float* part_d, int* part_i,
                    void* stream) {
    nn_partial_kernel<Reduce::kArgmin>
        <<<partial_grid(n, m, slice_len), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(p, q, q_mask, n, m, slice_len,
                                                0, part_d, part_i);
    return static_cast<int>(cudaGetLastError());
}

// Combine [slices, n] partials into out_d/out_i [n], first minimum wins.
int fpcr_nn_combine(const float* part_d, const int* part_i, int n, int slices,
                    float* out_d, int* out_i, void* stream) {
    nn_combine_kernel<<<combine_blocks(n), kCombineThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        part_d, part_i, n, slices, out_d, out_i);
    return static_cast<int>(cudaGetLastError());
}

// K2's sweep: the least key of every row over each target slice, written
// to part_key as [slices, n]. idx_bits in [1, 23] with m <= 2^idx_bits.
int fpcr_nn_packed_partial(const float* p, const float* q,
                           const uint8_t* q_mask, int n, int m, int slice_len,
                           int idx_bits, int* part_key, void* stream) {
    nn_partial_kernel<Reduce::kPacked>
        <<<partial_grid(n, m, slice_len), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(p, q, q_mask, n, m, slice_len,
                                                idx_bits, nullptr, part_key);
    return static_cast<int>(cudaGetLastError());
}

// K2's epilogue: out_i/out_d [n] from the [slices, n] keys.
int fpcr_nn_packed_epilogue(const float* p, const float* q,
                            const int* part_key, int n, int m, int slices,
                            int idx_bits, float* out_d, int* out_i,
                            void* stream) {
    nn_packed_epilogue_kernel<<<combine_blocks(n), kCombineThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        p, q, part_key, n, m, slices, idx_bits, out_d, out_i);
    return static_cast<int>(cudaGetLastError());
}

// The min-only sweep: the least distance of every row over each target
// slice, written to part_d as [slices, n]; with one slice the output.
int fpcr_nn_min_partial(const float* p, const float* q, const uint8_t* q_mask,
                        int n, int m, int slice_len, float* part_d,
                        void* stream) {
    nn_partial_kernel<Reduce::kMin>
        <<<partial_grid(n, m, slice_len), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(p, q, q_mask, n, m, slice_len,
                                                0, part_d, nullptr);
    return static_cast<int>(cudaGetLastError());
}

// The least of the [slices, n] partial distances into out_d [n].
int fpcr_nn_min_combine(const float* part_d, int n, int slices, float* out_d,
                        void* stream) {
    nn_min_combine_kernel<<<combine_blocks(n), kCombineThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        part_d, n, slices, out_d);
    return static_cast<int>(cudaGetLastError());
}

const char* fpcr_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
