// The E1 distance-form sweeps and E2's min-only sweep on the CUDA cores of
// Hopper (sm_90a), redesigned: register tiling, a slice held whole in shared
// memory and filled by asynchronous copies, and a reduction of one float min
// (argmin, min-only) or half an integer min (packed key) a pair.
//
// It replaces the TPU kernels of two brute-matcher studies:
//   * scripts/exp_match_kernels.py, E1: make_v1 (v1 and v3), make_v2,
//     make_v4, make_v5 and make_v6, the brute-force NN under a biased or
//     expanded f32 distance form with an argmin or a packed key;
//   * scripts/exp_packed_reduction.py::make_minonly (_kern_min), E2: the
//     least squared distance of every row and nothing else.
// Each launch type computes, bit for bit, what its instance of
// csrc/matching.cu's nn_partial_kernel<Form, Reduce> computes, which stays
// as the yardstick (ops/matching_cuda.py::_nn_form_yardstick,
// _nn_min_only_yardstick): the same per-pair expressions (explicit fmaf in
// the same order; t.w + |p|^2 and d + |p|^2 as separate adds), the same
// first minimum and least key, and for the packed keys K2's epilogue
// arithmetic. The forms, with a = -2p held per row and the staged target
// (x, y, z, w):
//   kBiased   fma chain of a.q onto w = |q|^2 + C (v1, v2);
//   kExpand   the chain onto w = (|q|^2 + C) - C, then + |p|^2 (v4);
//   kExpand5  the chain onto w + |p|^2 with w = |q|^2 (v5, v6);
//   kDiff     fma(dz,dz, fma(dy,dy, fma(dx,dx, w))), d = p - q, w = 0 for a
//             valid target and +inf for a masked one (min-only).
//
// What bounds it on this card: the CUDA cores' issue of the per-pair
// instructions over N * M pairs (16,384^2 in both studies); the targets are
// 16 bytes each once staged and device-memory traffic is O(N + M). The
// first design spent 5-7 instructions a pair and issued them at 56-70% of
// the rate its own count allows. This one:
//   * holds kRows = 8 source rows a thread, so one broadcast float4 load of
//     a staged target feeds eight independent chains;
//   * stages the block's whole target slice (at most kMaxSlice) in shared
//     memory with 4-byte cp.async copies in two groups, the first kFirst
//     targets and the rest, so the sweep starts once the first group lands
//     and meets one more barrier, where the second has landed;
//   * argmin (v1, v6): a row takes fminf over each sub-tile of kSub targets
//     (one float min a pair) and records, by one strict compare a sub-tile,
//     the first sub-tile whose minimum lies below its best; a slice writes
//     its least value and that sub-tile. The finish (a lane a target) takes
//     the least over the slices, the earlier sub-tile on a tie, and rescans
//     that one sub-tile for the first target whose recomputed value equals
//     the least: the strict scan's first minimum, with its own bits where
//     -0.0 and +0.0 tie. fminf never keeps a NaN and the rescan never
//     matches one, so a NaN is never the argmin;
//   * packed key (v2, v4, v5): the least key is (the least bucket, the
//     first target in it), and a bucket, bits & ~(2^b - 1), is monotone in
//     the value's bits read as an int32; so a row takes the int32 min of
//     the raw bits over a sub-tile, three inputs at once (__vimin3_s32,
//     half an instruction a pair), then clamps it (v4, v5: an int32 max
//     with 0, which keys a negative value and -0.0 as +0.0 and keeps the
//     card's NaN, 0x7FFFFFFF, above every finite key) and masks it, and
//     records the first sub-tile of strictly lower bucket; a slice writes
//     bucket | sub-tile (the sub-tile fits in the index bits), the finish
//     takes their int32 min and rescans that sub-tile for the first target
//     in the bucket. The clamp moves out of the pair loop;
//   * min-only: min.NaN.f32 over the difference form (3 FADD, 3 FFMA, one
//     min a pair), so a NaN in a row's values makes its minimum NaN, as
//     _kern_min's jnp.minimum gives it.
// Instructions a pair: v1 4, v2 3.5, v4 and v5 4.5, v6 5, min-only 7, plus
// a sub-tile's compare (about 0.1 a pair). A first layout rescanned in the
// sweep, once a row and slice: divergent and latency-bound, it cost more
// than the rest of the reduction; the finish rescans one sub-tile a row.
// Measured at 16,384^2 (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section
// 6): the sums alone issue at about 70% of the rate their count allows
// (0.040 ms for v1 and v2), the reduction adds up to 0.008 ms and the
// finish 0.004-0.006 ms; v1 0.053 ms of kernel against the yardstick's
// 0.085, min-only 0.068 against 0.081.
//
// A masked target (min-only) is staged as (0, 0, 0, +inf): it contributes
// +inf whatever its coordinates, and a slice without a valid target writes
// +inf (a NaN source row meets only masked targets there), as the plain
// version masks its values. Targets past the slice's end, up to a whole
// sub-tile, are staged the same way: +inf or NaN, never a pick.
//
// Slices over blockIdx.y (ops/matching_cuda.py::_plan_forms) write
// [slices, n] partials; nn_forms_finish_kernel finishes the argmin and the
// packed key (two launches a call), matching.cu's fpcr_nn_min_combine the
// min-only sweep (with one slice its partial is the output). Modes 1 and 2
// are the timing ablations: the sums and the staging with no reduction,
// and the sums alone (the slice not staged); a three-input XOR of the
// values' bits (half an instruction a pair) keeps the sums, and each row
// writes its XOR to part_i.
//
// C interface (loaded with ctypes). Pointers are device pointers; `stream`
// is a cudaStream_t. Each function launches one kernel, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;                    // threads a block
constexpr int kRows = 8;                         // source rows a thread
constexpr int kRowsPerBlock = kThreads * kRows;  // 1,024
constexpr int kSub = 32;         // targets a sub-tile of the reduction
constexpr int kMaxSlice = 2048;  // targets a block holds (32 KB)
constexpr int kFirst = 256;      // targets of the first copy group
constexpr int kKeyInit = 0x7F7FFFFF;  // bits of the largest finite float
constexpr int kIntMax = 0x7FFFFFFF;

enum class Form { kDiff = 0, kBiased = 1, kExpand = 2, kExpand5 = 3 };
enum class Reduce { kArgmin = 0, kPacked = 1, kMin = 2 };
enum Mode { kFull = 0, kNoReduce = 1, kSumsOnly = 2 };

// One pair's value, in matching.cu's expressions and order. kDiff holds p
// in (ax, ay, az), the other forms a = -2p.
template <Form F>
__device__ __forceinline__ float pair_value(float ax, float ay, float az,
                                            float psq, float4 t) {
    if constexpr (F == Form::kDiff) {
        const float dx = __fsub_rn(ax, t.x);
        const float dy = __fsub_rn(ay, t.y);
        const float dz = __fsub_rn(az, t.z);
        return fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, t.w)));
    } else {
        const float w = F == Form::kExpand5 ? __fadd_rn(t.w, psq) : t.w;
        const float d = fmaf(az, t.z, fmaf(ay, t.y, fmaf(ax, t.x, w)));
        return F == Form::kExpand ? __fadd_rn(d, psq) : d;
    }
}

// the least of two floats, NaN if either is NaN
__device__ __forceinline__ float fmin_nan(float a, float b) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

// a value's bits as the packed key orders them: the int32 bits, clamped at
// 0 for v4 and v5 (a negative value and -0.0 key as +0.0)
template <bool kClamp>
__device__ __forceinline__ int key_bits(int bits) {
    return kClamp ? max(bits, 0) : bits;
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

// Copy targets [lo, hi) of the slice into tile[] as (x, y, z, w): the
// coordinates and, for the forms, q_w by cp.async; kDiff's w = 0, and a
// masked target and the padding past `count` as (0, 0, 0, +inf), by plain
// stores. Returns whether this thread staged a valid target.
template <bool kDiffForm>
__device__ __forceinline__ int stage_copies(float4* tile,
                                            const float* __restrict__ q,
                                            const float* __restrict__ q_w,
                                            const uint8_t* __restrict__ q_mask,
                                            int j_begin, int count, int lo,
                                            int hi) {
    int staged = 0;
    for (int s = lo + static_cast<int>(threadIdx.x); s < hi; s += kThreads) {
        float4* t = tile + s;
        const int j = j_begin + s;
        if (s < count &&
            (!kDiffForm || q_mask == nullptr || q_mask[j] != 0)) {
            staged = 1;
            cp_async4(&t->x, q + 3 * j);
            cp_async4(&t->y, q + 3 * j + 1);
            cp_async4(&t->z, q + 3 * j + 2);
            if constexpr (kDiffForm) {
                t->w = 0.0f;
            } else {
                cp_async4(&t->w, q_w + j);
            }
        } else {
            *t = make_float4(0.0f, 0.0f, 0.0f, CUDART_INF_F);
        }
    }
    return staged;
}

// One slice of targets against kRowsPerBlock source rows. kArgmin writes
// part_d (the slice's least value, +inf where none) and part_i (the first
// sub-tile holding it, -1 where none), kPacked part_i (the least bucket |
// its first sub-tile, kIntMax where none), kMin part_d (the least value,
// NaN where a value is NaN). q_mask (kDiff only) may be null.
template <Form F, Reduce R, int kMode>
__global__ void __launch_bounds__(kThreads, 4)
nn_forms_kernel(const float* __restrict__ p, const float* __restrict__ q,
                const float* __restrict__ q_w, const float* __restrict__ p_sq,
                const uint8_t* __restrict__ q_mask, int n, int m,
                int slice_len, int idx_bits, float* __restrict__ part_d,
                int* __restrict__ part_i) {
    __shared__ __align__(16) float4 tile[kMaxSlice];
    constexpr bool kDiffForm = F == Form::kDiff;
    constexpr bool kClamp = F == Form::kExpand || F == Form::kExpand5;
    constexpr bool kReduce = kMode == kFull;

    const int slice = blockIdx.y;
    const int j_begin = slice * slice_len;
    const int count = min(m, j_begin + slice_len) - j_begin;
    const int subs = (count + kSub - 1) / kSub;
    const int padded = subs * kSub;
    const int first = min(padded, kFirst);
    const int row0 = blockIdx.x * kRowsPerBlock + threadIdx.x;
    const int keep = ~((1 << idx_bits) - 1);  // the key's distance bits

    // the slice's targets in two copy groups; whether any is valid (the
    // min-only sweep's mask) is read at the first group's barrier
    int mine = 0, any_valid = 1;
    if constexpr (kMode != kSumsOnly) {
        mine = stage_copies<kDiffForm>(tile, q, q_w, q_mask, j_begin, count,
                                       0, first);
        cp_async_commit();
        mine |= stage_copies<kDiffForm>(tile, q, q_w, q_mask, j_begin, count,
                                        first, padded);
        cp_async_commit();
    }

    // kDiff holds p, the other forms a = -2p (exact) and |p|^2
    constexpr float kScale = kDiffForm ? 1.0f : -2.0f;
    float ax[kRows], ay[kRows], az[kRows], psq[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
        // rows past n load the last row and are never written back
        const int i = min(row0 + k * kThreads, n - 1);
        ax[k] = kScale * p[3 * i];
        ay[k] = kScale * p[3 * i + 1];
        az[k] = kScale * p[3 * i + 2];
        psq[k] = p_sq == nullptr ? 0.0f : p_sq[i];
    }

    // the running minimum of the sub-tile (argmin, packed: as int bits) or
    // of the slice (min-only), the best so far and its sub-tile
    float run_f[kRows], best_f[kRows];
    int run_i[kRows], best_b[kRows], rec[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
        run_f[k] = CUDART_INF_F;
        best_f[k] = CUDART_INF_F;
        run_i[k] = 0;
        best_b[k] = kIntMax;
        rec[k] = -1;
    }

    for (int s = 0; s < subs; ++s) {
        if constexpr (kMode != kSumsOnly) {
            if (s == 0) {
                cp_async_wait<1>();
                if constexpr (R == Reduce::kMin) {
                    any_valid = __syncthreads_or(mine);
                } else {
                    __syncthreads();
                }
            } else if (s * kSub == first) {
                cp_async_wait<0>();
                __syncthreads();
            }
        }
        const float4* tt = tile + s * kSub;
#pragma unroll
        for (int t = 0; t < kSub; t += 2) {
            const float4 ta = tt[t];
            const float4 tb = tt[t + 1];
#pragma unroll
            for (int k = 0; k < kRows; ++k) {
                const float d0 = pair_value<F>(ax[k], ay[k], az[k], psq[k],
                                               ta);
                const float d1 = pair_value<F>(ax[k], ay[k], az[k], psq[k],
                                               tb);
                if constexpr (!kReduce) {  // a three-input XOR keeps the sums
                    run_i[k] ^= __float_as_int(d0) ^ __float_as_int(d1);
                } else if constexpr (R == Reduce::kArgmin) {
                    const float lo = fminf(d0, d1);
                    run_f[k] = t == 0 ? lo : fminf(run_f[k], lo);
                } else if constexpr (R == Reduce::kPacked) {
                    const int b0 = __float_as_int(d0);
                    const int b1 = __float_as_int(d1);
                    run_i[k] = t == 0 ? min(b0, b1)
                                      : __vimin3_s32(run_i[k], b0, b1);
                } else {
                    run_f[k] = fmin_nan(run_f[k], fmin_nan(d0, d1));
                }
            }
        }
        if constexpr (kReduce && R == Reduce::kArgmin) {
#pragma unroll
            for (int k = 0; k < kRows; ++k) {
                if (run_f[k] < best_f[k]) {  // strict: an earlier sub-tile
                    best_f[k] = run_f[k];    // keeps its ties
                    rec[k] = s;
                }
            }
        } else if constexpr (kReduce && R == Reduce::kPacked) {
#pragma unroll
            for (int k = 0; k < kRows; ++k) {
                const int b = key_bits<kClamp>(run_i[k]) & keep;
                if (b < best_b[k]) {
                    best_b[k] = b;
                    rec[k] = s;
                }
            }
        }
    }

    // the rescan of each row's recorded sub-tile, and the partials
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
        const int i = row0 + k * kThreads;
        if (i >= n) continue;
        const size_t o = static_cast<size_t>(slice) * n + i;
        if constexpr (!kReduce) {
            part_i[o] = run_i[k];
        } else if constexpr (R == Reduce::kMin) {
            part_d[o] = any_valid ? run_f[k] : CUDART_INF_F;
        } else if constexpr (R == Reduce::kArgmin) {
            // the sub-tile's least value and the sub-tile (-1 for none)
            part_d[o] = best_f[k];
            part_i[o] = rec[k] < 0 ? -1 : j_begin / kSub + rec[k];
        } else {
            // the bucket and the sub-tile in the key's index bits, which
            // hold every sub-tile (m <= 2^idx_bits)
            part_i[o] = rec[k] < 0 ? kIntMax
                                   : best_b[k] | (j_begin / kSub + rec[k]);
        }
    }
}

// The finish of the argmin (v1, v6) and the packed key (v2, v4, v5), a
// block for kFinishRows rows. The block's threads read the rows' slice
// partials coalesced (thread t: row t % kFinishRows, slices t / kFinishRows,
// + kFinishStride, ...) and keep the least (argmin: the lower value, then
// the lower sub-tile; packed: the int32 min of bucket | sub-tile); shared
// memory merges them. Then each warp rescans the chosen sub-tile of its
// rows, lane t on target 32 s + t, with the sweep's expressions: the first
// target whose value equals the least (argmin: that value, its own bits)
// or whose bucket is the least (packed: the key min(bucket | j, kKeyInit),
// unpacked as K2's epilogue does, with the exact distance of the pick).
constexpr int kFinishRows = 32;
constexpr int kFinishStride = kThreads / kFinishRows;  // slice readers a row
constexpr int kFinishRowsPerWarp = kFinishRows / (kThreads / 32);

template <Reduce R>
__device__ __forceinline__ void take_partial(float d, int s, float& bd,
                                             int& bs) {
    if constexpr (R == Reduce::kArgmin) {
        if (d < bd || (d == bd && static_cast<unsigned>(s) <
                                      static_cast<unsigned>(bs))) {
            bd = d;
            bs = s;
        }
    } else {
        bs = min(bs, s);
    }
}

template <Form F, Reduce R>
__global__ void __launch_bounds__(kThreads)
nn_forms_finish_kernel(const float* __restrict__ p,
                       const float* __restrict__ q,
                       const float* __restrict__ q_w,
                       const float* __restrict__ p_sq, int n, int m,
                       int slices, int idx_bits,
                       const float* __restrict__ part_d,
                       const int* __restrict__ part_i,
                       float* __restrict__ out_d, int* __restrict__ out_i) {
    static_assert(kSub == 32, "a lane a target of the sub-tile");
    constexpr bool kClamp = F == Form::kExpand || F == Form::kExpand5;
    constexpr bool kArg = R == Reduce::kArgmin;
    __shared__ float sd[kFinishStride][kFinishRows];
    __shared__ int ss[kFinishStride][kFinishRows];
    const int keep = ~((1 << idx_bits) - 1);
    const int row0 = blockIdx.x * kFinishRows;
    const int r = threadIdx.x % kFinishRows;
    const int g = threadIdx.x / kFinishRows;

    float bd = CUDART_INF_F;
    int bs = kArg ? -1 : kIntMax;  // argmin: the sub-tile; packed: b | s
    if (row0 + r < n) {
#pragma unroll 4
        for (int sl = g; sl < slices; sl += kFinishStride) {
            const size_t o = static_cast<size_t>(sl) * n + row0 + r;
            take_partial<R>(kArg ? part_d[o] : 0.0f, part_i[o], bd, bs);
        }
    }
    sd[g][r] = bd;
    ss[g][r] = bs;
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < kFinishRowsPerWarp; ++k) {
        const int rr = warp * kFinishRowsPerWarp + k;
        const int i = row0 + rr;
        if (i >= n) break;  // uniform in the warp
        float rd = CUDART_INF_F;
        int rs = kArg ? -1 : kIntMax;
#pragma unroll
        for (int h = 0; h < kFinishStride; ++h) {
            take_partial<R>(sd[h][rr], ss[h][rr], rd, rs);
        }
        const int sub = kArg ? rs : rs & ~keep;
        const bool found = kArg ? rs >= 0 : rs != kIntMax;
        const int j = sub * kSub + lane;
        float v = CUDART_INF_F;
        bool mine = false;
        if (found && j < m) {
            v = pair_value<F>(-2.0f * p[3 * i], -2.0f * p[3 * i + 1],
                              -2.0f * p[3 * i + 2],
                              p_sq == nullptr ? 0.0f : p_sq[i],
                              make_float4(q[3 * j], q[3 * j + 1],
                                          q[3 * j + 2], q_w[j]));
            mine = kArg ? v == rd
                        : (key_bits<kClamp>(__float_as_int(v)) & keep) ==
                              (rs & keep);
        }
        const unsigned hit = __ballot_sync(0xffffffffu, mine);
        const int first = __ffs(hit) - 1;  // -1 where no lane hit
        const float vf = __shfl_sync(0xffffffffu, v, first < 0 ? 0 : first);
        if (lane != 0) continue;
        if constexpr (kArg) {
            out_d[i] = first < 0 ? CUDART_INF_F : vf;
            out_i[i] = first < 0 ? 0 : sub * kSub + first;
        } else {
            const int key = first < 0
                                ? kKeyInit
                                : min((rs & keep) | (sub * kSub + first),
                                      kKeyInit);
            if (key == kKeyInit) {  // no key below the initial one
                out_d[i] = CUDART_INF_F;
                out_i[i] = 0;
                continue;
            }
            const int jj = min(key & ~keep, m - 1);
            const float dx = p[3 * i] - q[3 * jj];
            const float dy = p[3 * i + 1] - q[3 * jj + 1];
            const float dz = p[3 * i + 2] - q[3 * jj + 2];
            out_d[i] = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
            out_i[i] = jj;
        }
    }
}

template <Form F, Reduce R>
cudaError_t finish(const float* p, const float* q, const float* q_w,
                   const float* p_sq, int n, int m, int slices, int idx_bits,
                   const float* part_d, const int* part_i, float* out_d,
                   int* out_i, cudaStream_t stream) {
    nn_forms_finish_kernel<F, R>
        <<<(n + kFinishRows - 1) / kFinishRows, kThreads, 0, stream>>>(
            p, q, q_w, p_sq, n, m, slices, idx_bits, part_d, part_i, out_d,
            out_i);
    return cudaGetLastError();
}

template <Form F, Reduce R, int kMode>
cudaError_t launch(const float* p, const float* q, const float* q_w,
                   const float* p_sq, const uint8_t* q_mask, int n, int m,
                   int slice_len, int idx_bits, float* part_d, int* part_i,
                   cudaStream_t stream) {
    const int slices = (m + slice_len - 1) / slice_len;
    const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, slices);
    nn_forms_kernel<F, R, kMode><<<grid, kThreads, 0, stream>>>(
        p, q, q_w, p_sq, q_mask, n, m, slice_len, idx_bits, part_d, part_i);
    return cudaGetLastError();
}

template <int kMode>
cudaError_t launch_mode(const float* p, const float* q, const float* q_w,
                        const float* p_sq, const uint8_t* q_mask, int form,
                        int reduce, int n, int m, int slice_len, int idx_bits,
                        float* part_d, int* part_i, cudaStream_t s) {
#define FPCR_FORMS(F, R)                                                     \
    launch<F, R, kMode>(p, q, q_w, p_sq, q_mask, n, m, slice_len, idx_bits,  \
                        part_d, part_i, s)
    if (q_mask != nullptr && (form != 0 || reduce != 2)) {
        return cudaErrorInvalidValue;  // only the min-only sweep masks
    }
    switch (form * 4 + reduce) {
        case 2: return FPCR_FORMS(Form::kDiff, Reduce::kMin);
        case 4: return FPCR_FORMS(Form::kBiased, Reduce::kArgmin);
        case 5: return FPCR_FORMS(Form::kBiased, Reduce::kPacked);
        case 9: return FPCR_FORMS(Form::kExpand, Reduce::kPacked);
        case 12: return FPCR_FORMS(Form::kExpand5, Reduce::kArgmin);
        case 13: return FPCR_FORMS(Form::kExpand5, Reduce::kPacked);
        default: return cudaErrorInvalidValue;
    }
#undef FPCR_FORMS
}

}  // namespace

extern "C" {

int fpcr_nn_forms_rows_per_block(void) { return kRowsPerBlock; }

int fpcr_nn_forms_max_slice(void) { return kMaxSlice; }

// The sweep over target slices of `slice_len` (a multiple of 32, at most
// fpcr_nn_forms_max_slice()) into [slices, n] partials, slices =
// ceil(m / slice_len). (form, reduce): (0, 2) the min-only sweep (q_mask
// optional, q_w and p_sq null) to part_d; (1, 0) v1 and (3, 0) v6 the least
// value to part_d and its sub-tile (-1 for none) to part_i; (1, 1) v2,
// (2, 1) v4 and (3, 1) v5 the least bucket | its sub-tile, with idx_bits,
// to part_i. fpcr_nn_forms_finish finishes the last five. q_w [m] is the staged lane, p_sq [n] |p|^2 (null for form 1).
// mode 0 the sweep, 1 without the reduction, 2 the sums alone (the mask
// not read);
// modes 1 and 2 write a word a row to part_i and nothing else.
int fpcr_nn_forms_partial(const float* p, const float* q, const float* q_w,
                          const float* p_sq, const uint8_t* q_mask, int form,
                          int reduce, int mode, int n, int m, int slice_len,
                          int idx_bits, float* part_d, int* part_i,
                          void* stream) {
    if (slice_len <= 0 || slice_len > kMaxSlice || slice_len % kSub != 0 ||
        n <= 0 || m <= 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const auto s = static_cast<cudaStream_t>(stream);
    cudaError_t rc;
    switch (mode) {
        case kFull:
            rc = launch_mode<kFull>(p, q, q_w, p_sq, q_mask, form, reduce, n,
                                    m, slice_len, idx_bits, part_d, part_i, s);
            break;
        case kNoReduce:
            rc = launch_mode<kNoReduce>(p, q, q_w, p_sq, q_mask, form, reduce,
                                        n, m, slice_len, idx_bits, part_d,
                                        part_i, s);
            break;
        case kSumsOnly:
            rc = launch_mode<kSumsOnly>(p, q, q_w, p_sq, q_mask, form, reduce,
                                        n, m, slice_len, idx_bits, part_d,
                                        part_i, s);
            break;
        default: rc = cudaErrorInvalidValue;
    }
    return static_cast<int>(rc);
}

// The finish of an argmin or packed sweep: the [slices, n] partials of
// fpcr_nn_forms_partial (part_d for the argmin only) into out_d, out_i [n]:
// (1, 0) v1 and (3, 0) v6 the first minimum's value and index, (0, inf)
// where none; (1, 1) v2, (2, 1) v4 and (3, 1) v5 the pick of the least key
// and its exact distance, (0, inf) where no key lies below kKeyInit.
int fpcr_nn_forms_finish(const float* p, const float* q, const float* q_w,
                         const float* p_sq, int form, int reduce, int n,
                         int m, int slices, int idx_bits, const float* part_d,
                         const int* part_i, float* out_d, int* out_i,
                         void* stream) {
    if (n <= 0 || m <= 0 || slices <= 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const auto s = static_cast<cudaStream_t>(stream);
#define FPCR_FINISH(F, R)                                                    \
    finish<F, R>(p, q, q_w, p_sq, n, m, slices, idx_bits, part_d, part_i,    \
                 out_d, out_i, s)
    cudaError_t rc;
    switch (form * 4 + reduce) {
        case 4: rc = FPCR_FINISH(Form::kBiased, Reduce::kArgmin); break;
        case 5: rc = FPCR_FINISH(Form::kBiased, Reduce::kPacked); break;
        case 9: rc = FPCR_FINISH(Form::kExpand, Reduce::kPacked); break;
        case 12: rc = FPCR_FINISH(Form::kExpand5, Reduce::kArgmin); break;
        case 13: rc = FPCR_FINISH(Form::kExpand5, Reduce::kPacked); break;
        default: rc = cudaErrorInvalidValue;
    }
#undef FPCR_FINISH
    return static_cast<int>(rc);
}

}  // extern "C"
