// Kernel S: the brute-force NN over the K-packed bf16 split distance, on the
// tensor cores of Hopper (sm_90a), with four epilogues.
//
// It replaces the TPU kernels of the brute matcher's tensor-core studies:
//   * scripts/exp_split_matmul.py::nn_argmin_packed (_packed_kernel, E4):
//     the argmin over the K=48 (terms 6) or K=24 (terms 3) split distance;
//   * scripts/exp_reduction2.py::run_variant (_kern, E3) on the K=48
//     operands: 'fullx', 'hier' and 'ts' (one function: the first-minimum
//     argmin), 'packed' and 'packed_ts' (one function: the int32 min of
//     (bits(max(d, 0)) & ~0x3FFF) | col, returned as the index and as the
//     key read as f32), 'minonly' (the least distance) and 'mmonly' (the
//     distance to one kept column).
// The operands are built in ops/split.py: p_in bf16[n_pad, K] and q_in
// bf16[m_pad, K], target-major, K = 8 * terms, and d = p_in . q_in^T.
//
// Each warp owns two m16 tiles of source rows (32 rows) and keeps their A
// fragments in registers for the whole sweep. The block's 256 threads stage
// 128 targets at a time in shared memory (K zero-padded to a multiple of 16:
// 48 for terms 6, 32 for terms 3; rows padded by 4 words so that the B
// fragment loads hit 32 distinct banks). Every 8 targets each warp issues
// K/16 mma.sync.m16n8k16 bf16 products per m16 tile into f32 accumulators,
// and reduces the accumulator fragment in registers: in the m16n8 layout
// lane l holds rows l/4 and l/4 + 8 and columns 2(l%4), 2(l%4) + 1. A
// thread sees its columns in ascending order, so a strict '<' keeps its
// first minimum; at the end the four lanes of a quad combine (d, j)
// lexicographically by __shfl_xor, so the first minimum of the slice wins.
// Target slices over blockIdx.y write partials that a second kernel
// combines as K1's are (slice order for the argmin, a min for the key and
// the least distance). Source rows past n are computed and never written;
// rows past n_pad read as zeros. Targets are swept up to round_up(m, 8): the
// caller pads q_in to at least that many rows with its 1e30 surrogate,
// which never wins.
//
// What bounds it on this card: neither the products at the tensor cores'
// peak (26 us for K=48 at 16,384^2) nor the reduction. chip_smoke.py's
// kernel times at 16,384^2 on an H100: the keep column, which reads one
// column but issues every product, 82 us; the min 79 us; the argmin and
// the packed key 106 us; the argmin at terms 3, with two thirds of the
// products, 95 us. About 80 us is the mma.sync pipeline itself (HMMA issue
// in dependent k-step chains, two shared B loads per k-step, the staging
// of each 128-target tile between two barriers), and the reduction adds
// 15-27 us on top. The design keeps the reduction to the accumulator
// registers (fragments stay in registers, B fragments are two
// conflict-free 32-bit shared loads per k-step shared by both m16 tiles,
// the index is the column itself); a wgmma + TMA pipeline that overlaps
// staging, products and reduction is the redesign that would move it.
// Every product is issued by an `asm volatile` mma. The SASS confirms it:
// each instance holds HMMA.16816.F32.BF16 (18 for terms 6 and 12 for terms
// 3, the loop unrolled twice plus its remainder) and no FFMA, which
// chip_smoke.py's build phase counts and fails on; and the keep column's
// kernel time grows with M as the argmin's does.
//
// C interface (loaded with ctypes). Pointers are device pointers; `stream`
// is a cudaStream_t. Each function launches one kernel, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMTiles = 2;                         // m16 tiles per warp
constexpr int kRowsPerBlock = 16 * kMTiles * kWarps;  // 256
constexpr int kTileN = 128;                        // targets staged per step
constexpr int kKeyInit = 0x7F7FFFFF;               // bits of FLT_MAX
constexpr int kKeepBits = ~((1 << 14) - 1);        // E3's 14 index bits

enum class Epilogue { kArgmin = 0, kPacked14 = 1, kMin = 2, kKeepColumn = 3 };

// d += a . b for one m16n8k16 tile: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The running reduction of one source row over the columns a thread sees.
template <Epilogue E>
struct RowState {
    float d;  // kArgmin, kMin: the least distance; kKeepColumn: the kept one
    int i;    // kArgmin: the index; kPacked14: the key

    __device__ __forceinline__ void take(float v, int col, int keep) {
        if constexpr (E == Epilogue::kArgmin) {
            if (v < d) {  // strict: the first minimum stays
                d = v;
                i = col;
            }
        } else if constexpr (E == Epilogue::kPacked14) {
            i = min(i, (__float_as_int(fmaxf(v, 0.0f)) & kKeepBits) | col);
        } else if constexpr (E == Epilogue::kMin) {
            d = fminf(d, v);
        } else {
            d = col == keep ? v : d;
        }
    }

    // Fold in the state of the lane `offset` away in the quad.
    __device__ __forceinline__ void combine_quad(int offset) {
        const float od = __shfl_xor_sync(0xffffffffu, d, offset);
        const int oi = __shfl_xor_sync(0xffffffffu, i, offset);
        if constexpr (E == Epilogue::kArgmin) {
            if (od < d || (od == d && oi < i)) {
                d = od;
                i = oi;
            }
        } else if constexpr (E == Epilogue::kPacked14) {
            i = min(i, oi);
        } else if constexpr (E == Epilogue::kMin) {
            d = fminf(d, od);
        }
    }
};

template <int kTerms, Epilogue E>
__global__ void __launch_bounds__(kThreads)
split_partial_kernel(const uint32_t* __restrict__ p_in,
                     const uint4* __restrict__ q_in, int n, int n_pad, int m,
                     int slice_len, int keep, float* __restrict__ part_d,
                     int* __restrict__ part_i) {
    constexpr int kK = 8 * kTerms;               // bf16 values a row
    constexpr int kKPad = (kK + 15) / 16 * 16;   // padded to the mma's k16
    constexpr int kSteps = kKPad / 16;
    constexpr int kSrcWords = kK / 2;            // 32-bit words a row in HBM
    constexpr int kRowWords = kKPad / 2 + 4;     // and in shared memory
    constexpr int kVecs = kSrcWords / 4;         // uint4 loads a target row
    static_assert(kSrcWords % 4 == 0, "a target row is whole uint4s");
    static_assert((kRowWords * 4) % 16 == 0, "shared rows are uint4-aligned");
    __shared__ __align__(16) uint32_t tile[kTileN * kRowWords];

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;  // the fragment's row (and B's column) group
    const int t = lane & 3;   // the thread's pair of columns

    // A fragments: rows g and g + 8 of each m16 tile, k pairs 2t and 2t + 8
    uint32_t a[kMTiles][kSteps][4];
    int rows[kMTiles][2];
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) {
        rows[mt][0] = blockIdx.x * kRowsPerBlock + (warp * kMTiles + mt) * 16
                      + g;
        rows[mt][1] = rows[mt][0] + 8;
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {      // k half: words 8s + t, + 4
                const int w = 8 * s + 4 * h + t;
#pragma unroll
                for (int r = 0; r < 2; ++r) {  // row g, g + 8
                    const int row = rows[mt][r];
                    a[mt][s][2 * h + r] =
                        (row < n_pad && w < kSrcWords)
                            ? p_in[static_cast<size_t>(row) * kSrcWords + w]
                            : 0u;
                }
            }
        }
    }

    // the K padding of the staged rows is zero for the whole sweep
    constexpr int kPadWords = kKPad / 2 - kSrcWords;
    if constexpr (kPadWords > 0) {
        for (int s = threadIdx.x; s < kTileN * kPadWords; s += kThreads) {
            tile[(s / kPadWords) * kRowWords + kSrcWords + s % kPadWords] = 0u;
        }
    }

    RowState<E> st[kMTiles][2];
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            st[mt][r].d = CUDART_INF_F;
            st[mt][r].i = E == Epilogue::kPacked14 ? kKeyInit : 0;
        }
    }
    const int j_begin = blockIdx.y * slice_len;
    const int j_end = min(m, j_begin + slice_len);
    for (int t0 = j_begin; t0 < j_end; t0 += kTileN) {
        const int count = (min(kTileN, j_end - t0) + 7) & ~7;  // whole n8s
        __syncthreads();  // every warp is done with the previous tile
        for (int s = threadIdx.x; s < count * kVecs; s += kThreads) {
            const int r = s / kVecs;
            const int v = s - r * kVecs;
            *reinterpret_cast<uint4*>(&tile[r * kRowWords + 4 * v]) =
                q_in[static_cast<size_t>(t0 + r) * kVecs + v];
        }
        __syncthreads();
#pragma unroll 2
        for (int nb = 0; nb < count; nb += 8) {
            const uint32_t* brow = &tile[(nb + g) * kRowWords];
            float c[kMTiles][4];
#pragma unroll
            for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
                for (int e = 0; e < 4; ++e) c[mt][e] = 0.0f;
            }
#pragma unroll
            for (int s = 0; s < kSteps; ++s) {
                const uint32_t b0 = brow[8 * s + t];
                const uint32_t b1 = brow[8 * s + 4 + t];
#pragma unroll
                for (int mt = 0; mt < kMTiles; ++mt) {
                    mma_bf16(c[mt], a[mt][s], b0, b1);
                }
            }
            const int col = t0 + nb + 2 * t;
#pragma unroll
            for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    st[mt][r].take(c[mt][2 * r], col, keep);
                    st[mt][r].take(c[mt][2 * r + 1], col + 1, keep);
                }
            }
        }
    }

    // the keep column: the one lane whose columns hold `keep` writes, in
    // its slice; otherwise the quad's lane 0 writes the slice's partials
    const bool mine = keep >= j_begin && keep < j_end && (keep & 7) >> 1 == t;
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int row = rows[mt][r];
            if constexpr (E == Epilogue::kKeepColumn) {
                if (mine && row < n) part_d[row] = st[mt][r].d;
            } else {
                st[mt][r].combine_quad(1);
                st[mt][r].combine_quad(2);
                if (t == 0 && row < n) {
                    const size_t o = static_cast<size_t>(blockIdx.y) * n + row;
                    if constexpr (E != Epilogue::kPacked14) {
                        part_d[o] = st[mt][r].d;
                    }
                    if constexpr (E != Epilogue::kMin) part_i[o] = st[mt][r].i;
                }
            }
        }
    }
}

// The [slices, n] partials into out_d / out_i [n]: the argmin in slice
// order, first minimum winning (clamped at 0 when asked); the key by an
// int32 min, unpacked to its 14 index bits and read as f32; the least
// distance with an index of zeros.
template <Epilogue E>
__global__ void split_combine_kernel(const float* __restrict__ part_d,
                                     const int* __restrict__ part_i, int n,
                                     int slices, int clamp,
                                     float* __restrict__ out_d,
                                     int* __restrict__ out_i) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float bd = CUDART_INF_F;
    int bi = E == Epilogue::kPacked14 ? kKeyInit : 0;
    for (int s = 0; s < slices; ++s) {
        const size_t o = static_cast<size_t>(s) * n + i;
        if constexpr (E == Epilogue::kArgmin) {
            const float d = part_d[o];
            if (d < bd) {  // strict: the earlier slice wins ties
                bd = d;
                bi = part_i[o];
            }
        } else if constexpr (E == Epilogue::kPacked14) {
            bi = min(bi, part_i[o]);
        } else {
            bd = fminf(bd, part_d[o]);
        }
    }
    if constexpr (E == Epilogue::kPacked14) {
        out_d[i] = __int_as_float(bi);
        out_i[i] = bi & ~kKeepBits;
    } else {
        out_d[i] = (E == Epilogue::kArgmin && clamp) ? fmaxf(bd, 0.0f) : bd;
        out_i[i] = bi;
    }
}

constexpr int kCombineThreads = 256;

template <int kTerms>
cudaError_t launch_partial(int epilogue, dim3 grid, cudaStream_t stream,
                           const uint32_t* p, const uint4* q, int n, int n_pad,
                           int m, int slice_len, int keep, float* part_d,
                           int* part_i) {
#define FPCR_SPLIT_LAUNCH(E)                                                 \
    split_partial_kernel<kTerms, E><<<grid, kThreads, 0, stream>>>(          \
        p, q, n, n_pad, m, slice_len, keep, part_d, part_i)
    switch (epilogue) {
        case 0: FPCR_SPLIT_LAUNCH(Epilogue::kArgmin); break;
        case 1: FPCR_SPLIT_LAUNCH(Epilogue::kPacked14); break;
        case 2: FPCR_SPLIT_LAUNCH(Epilogue::kMin); break;
        case 3: FPCR_SPLIT_LAUNCH(Epilogue::kKeepColumn); break;
        default: return cudaErrorInvalidValue;
    }
#undef FPCR_SPLIT_LAUNCH
    return cudaGetLastError();
}

}  // namespace

extern "C" {

int fpcr_split_rows_per_block(void) { return kRowsPerBlock; }

// The partial reduction of source rows [0, n) over target slices of
// `slice_len` targets (a multiple of 128): `epilogue` 0 argmin (part_d,
// part_i), 1 packed14 (keys to part_i), 2 min (part_d) as [slices, n] with
// slices = ceil(m / slice_len); 3 keep-column, the distance to column `keep`
// written to part_d[n] directly. `terms` 6 or 3; p_in has n_pad rows and
// q_in at least round_up(m, 8), both of 8 * terms bf16 values, q_in 16-byte
// aligned.
int fpcr_split_partial(const void* p_in, const void* q_in, int terms,
                       int epilogue, int n, int n_pad, int m, int slice_len,
                       int keep, float* part_d, int* part_i, void* stream) {
    const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock,
                    (m + slice_len - 1) / slice_len);
    const auto p = static_cast<const uint32_t*>(p_in);
    const auto q = static_cast<const uint4*>(q_in);
    const auto s = static_cast<cudaStream_t>(stream);
    cudaError_t rc;
    if (terms == 6) {
        rc = launch_partial<6>(epilogue, grid, s, p, q, n, n_pad, m,
                               slice_len, keep, part_d, part_i);
    } else if (terms == 3) {
        rc = launch_partial<3>(epilogue, grid, s, p, q, n, n_pad, m,
                               slice_len, keep, part_d, part_i);
    } else {
        rc = cudaErrorInvalidValue;
    }
    return static_cast<int>(rc);
}

// Combine the [slices, n] partials of `epilogue` 0, 1 or 2 into out_d and
// out_i [n]; `clamp` != 0 clamps the argmin's distance at 0.
int fpcr_split_combine(const float* part_d, const int* part_i, int epilogue,
                       int n, int slices, int clamp, float* out_d, int* out_i,
                       void* stream) {
    const int blocks = (n + kCombineThreads - 1) / kCombineThreads;
    const auto s = static_cast<cudaStream_t>(stream);
    switch (epilogue) {
        case 0:
            split_combine_kernel<Epilogue::kArgmin>
                <<<blocks, kCombineThreads, 0, s>>>(part_d, part_i, n, slices,
                                                    clamp, out_d, out_i);
            break;
        case 1:
            split_combine_kernel<Epilogue::kPacked14>
                <<<blocks, kCombineThreads, 0, s>>>(part_d, part_i, n, slices,
                                                    clamp, out_d, out_i);
            break;
        case 2:
            split_combine_kernel<Epilogue::kMin>
                <<<blocks, kCombineThreads, 0, s>>>(part_d, part_i, n, slices,
                                                    clamp, out_d, out_i);
            break;
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
