// Morton band nearest-neighbour search for Hopper (sm_90a): kernel K3 and
// its packed mode K3p.
//
// Replaces the TPU kernel fpcr_tpu/ops/morton_pallas.py::morton_nn_pallas
// (kernel bodies _band_kernel_factory and _band_kernel_pipelined_factory,
// modes "highest", "packed6" and the pipe/seq schedules: K3; the
// packed_idx branch of _band_kernel_factory, mode "packed6_idx": K3p).
// The source rows
// are Morton-sorted; chunk c holds rows [c*chunk, (c+1)*chunk). The wrapper
// computes each chunk's band base on the device (probe code, searchsorted,
// clip, align to 128) and passes bases[c]. For every source row the kernel
// scans the `band` target rows [base, base + band) of the Morton-sorted
// table and returns the row of least squared distance: ties go to the
// first row, as jnp.argmin picks. Rows at or past *valid_count (masked
// targets, which the table sorts to the end) and rows past m (band padding)
// never win. Outputs: the matched point and, when `extra` is given, the
// matched extra (e.g. target normals in table order) -- both copied from
// the table row, so they equal it bit for bit -- the squared distance, and
// the index in table order, in [0, m-1].
//
// K3p replaces the per-row (min, argmin) by one int32 min over keys
// (bits(d) & ~(2^b - 1)) | band_row, b = bit_length(band - 1) (10 bits for
// chunk 512 / window 64): the distance with its low b mantissa bits dropped,
// then the band row, so ties within a bucket go to the first row. The key
// starts at 0x7F7FFFFF (the largest finite float's bits); a masked or
// padding row's distance is +inf, whose bits exceed it, so such a row never
// wins. The epilogue unpacks the row, loads the matched point and extra by
// base + row (bit-equal to the table), and recomputes the exact distance
// from the matched point; the quantized distance is never returned.
//
// Convention for a row whose whole band holds no valid target (only when
// *valid_count is 0): distance +inf and index 0, with table row 0 as the
// matched point and extra. This is kernel K1's convention; the TPU kernel
// returns a ~1e30 surrogate distance and a band row there.
//
// What bounds it on this card: FP32 arithmetic over N * band pairs (805M
// at 1M points with chunk 512, window 64). The band is a contiguous slice
// of the table, so its device-memory traffic is small and every band is
// read once per chunk. The design follows kernel K1 (csrc/matching.cu):
//   * one block per chunk; the band is staged in shared memory as float4
//     (x, y, z, w) in tiles of kTile rows, w = 0 for a valid row and +inf
//     for a masked or padding row, folded in as the first FMA's addend, so
//     the mask costs nothing per pair;
//   * each thread keeps kPPT source rows in registers, so one broadcast
//     shared-memory load feeds kPPT pairs; a chunk larger than
//     kPPT * blockDim rows is processed in passes;
//   * the distance is the difference form with FMAs: no cancellation, never
//     negative, no clamp;
//   * each thread scans the band in ascending order with a strict '<',
//     which gives the first minimum without an extra compare (K3), or keeps
//     one running key with one LOP3 and one integer min a pair (K3p).
// Not carried over from the TPU kernel: the bf16x6 K-packing, the one-hot
// MXU extraction (a row is loaded by index here), the [8, M] lane-major
// tables and the VMEM ring schedules.
//
// C interface (loaded with ctypes). Pointers are device pointers; `stream`
// is a cudaStream_t. Each function launches one kernel, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxThreads = 256;  // threads per block at most
constexpr int kPPT = 2;           // source rows held per thread
constexpr int kTile = 1024;       // band rows staged in shared memory per step
constexpr int kKeyInit = 0x7F7FFFFF;  // bits of the largest finite float

// kPacked: K3p with keys of idx_bits index bits; else K3 (idx_bits unused).
template <bool kPacked>
__global__ void __launch_bounds__(kMaxThreads)
morton_band_kernel(const float* __restrict__ p, int n,
                   const float* __restrict__ q, int m,
                   const int* __restrict__ valid_count,
                   const float* __restrict__ extra,
                   const int* __restrict__ bases, int chunk, int band,
                   int idx_bits, float* __restrict__ out_q,
                   float* __restrict__ out_d, int* __restrict__ out_i,
                   float* __restrict__ out_e) {
    __shared__ float4 tile[kTile];

    const int tid = static_cast<int>(threadIdx.x);
    const int threads = static_cast<int>(blockDim.x);
    const int base = bases[blockIdx.x];
    const int valid_end = min(*valid_count, m);  // rows below it may win
    const int row_begin = static_cast<int>(blockIdx.x) * chunk;
    const int row_end = min(n, row_begin + chunk);
    const int per_pass = kPPT * threads;
    const int keep = ~((1 << idx_bits) - 1);  // the distance bits K3p keeps

    for (int r0 = row_begin; r0 < row_end; r0 += per_pass) {
        float px[kPPT], py[kPPT], pz[kPPT], best_d[kPPT];
        int best_s[kPPT];  // K3: the band row, -1 for none; K3p: the key
#pragma unroll
        for (int k = 0; k < kPPT; ++k) {
            // rows past the chunk load its last row and are never written
            const int i = min(r0 + k * threads + tid, row_end - 1);
            px[k] = p[3 * i];
            py[k] = p[3 * i + 1];
            pz[k] = p[3 * i + 2];
            best_d[k] = CUDART_INF_F;
            best_s[k] = kPacked ? kKeyInit : -1;
        }

        for (int t0 = 0; t0 < band; t0 += kTile) {
            const int count = min(kTile, band - t0);
            __syncthreads();  // every thread is done with the previous tile
            for (int s = tid; s < count; s += threads) {
                const int g = base + t0 + s;
                tile[s] = g < valid_end
                              ? make_float4(q[3 * g], q[3 * g + 1],
                                            q[3 * g + 2], 0.0f)
                              : make_float4(0.0f, 0.0f, 0.0f, CUDART_INF_F);
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
                    const float d =
                        fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, t.w)));
                    if constexpr (kPacked) {
                        best_s[k] = min(best_s[k],
                                        (__float_as_int(d) & keep) | (t0 + s));
                    } else if (d < best_d[k]) {  // strict: the first
                        best_d[k] = d;           // minimum stays
                        best_s[k] = t0 + s;
                    }
                }
            }
        }

#pragma unroll
        for (int k = 0; k < kPPT; ++k) {
            const int i = r0 + k * threads + tid;
            if (i < row_end) {
                int j;
                float d;
                if constexpr (kPacked) {
                    // an unchanged key: no valid row in the band
                    const bool none = best_s[k] == kKeyInit;
                    j = none ? 0
                             : min(base + (best_s[k] & ~keep), m - 1);
                    const float dx = px[k] - q[3 * j];
                    const float dy = py[k] - q[3 * j + 1];
                    const float dz = pz[k] - q[3 * j + 2];
                    d = none ? CUDART_INF_F
                             : fmaf(dz, dz, fmaf(dy, dy, dx * dx));
                } else {
                    j = best_s[k] < 0 ? 0 : base + best_s[k];
                    d = best_d[k];
                }
                out_d[i] = d;
                out_i[i] = j;
                out_q[3 * i] = q[3 * j];
                out_q[3 * i + 1] = q[3 * j + 1];
                out_q[3 * i + 2] = q[3 * j + 2];
                if (out_e != nullptr) {
                    out_e[3 * i] = extra[3 * j];
                    out_e[3 * i + 1] = extra[3 * j + 1];
                    out_e[3 * i + 2] = extra[3 * j + 2];
                }
            }
        }
    }
}

template <bool kPacked>
int launch(const float* p, int n, const float* q, int m,
           const int* valid_count, const float* extra, const int* bases,
           int num_chunks, int chunk, int band, int idx_bits, float* out_q,
           float* out_d, int* out_i, float* out_e, void* stream) {
    const int want = ((chunk + kPPT - 1) / kPPT + 31) / 32 * 32;
    const int threads = want < kMaxThreads ? want : kMaxThreads;
    morton_band_kernel<kPacked><<<num_chunks, threads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        p, n, q, m, valid_count, extra, bases, chunk, band, idx_bits, out_q,
        out_d, out_i, out_e);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K3: band NN of the n source rows p[n,3] in num_chunks chunks of `chunk` rows
// against the Morton-sorted table q[m,3] (valid rows below *valid_count),
// band `band` rows from bases[num_chunks]. `extra`/`out_e` may both be
// null. Writes out_q[n,3], out_d[n], out_i[n] and out_e[n,3].
int fpcr_morton_nn(const float* p, int n, const float* q, int m,
                   const int* valid_count, const float* extra,
                   const int* bases, int num_chunks, int chunk, int band,
                   float* out_q, float* out_d, int* out_i, float* out_e,
                   void* stream) {
    return launch<false>(p, n, q, m, valid_count, extra, bases, num_chunks,
                         chunk, band, 0, out_q, out_d, out_i, out_e, stream);
}

// K3p: as fpcr_morton_nn, by keys of idx_bits index bits (band <=
// 2^idx_bits, idx_bits <= 23).
int fpcr_morton_nn_packed(const float* p, int n, const float* q, int m,
                          const int* valid_count, const float* extra,
                          const int* bases, int num_chunks, int chunk,
                          int band, int idx_bits, float* out_q, float* out_d,
                          int* out_i, float* out_e, void* stream) {
    return launch<true>(p, n, q, m, valid_count, extra, bases, num_chunks,
                        chunk, band, idx_bits, out_q, out_d, out_i, out_e,
                        stream);
}

}  // extern "C"
