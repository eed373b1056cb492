// Kernel S on Hopper's warpgroup tensor cores (sm_90a): the brute-force NN
// over the K-packed bf16 split distance, with four epilogues, as a wgmma
// sweep fed by TMA copies through a ring of shared-memory tiles.
//
// It replaces the TPU kernels of the brute matcher's tensor-core studies:
//   * scripts/exp_split_matmul.py::nn_argmin_packed (_packed_kernel, E4):
//     the argmin over the K=48 (terms 6) or K=24 (terms 3) split distance;
//   * scripts/exp_reduction2.py::run_variant (_kern, E3) on the K=48
//     operands: the first-minimum argmin ('fullx', 'hier', 'ts'), the int32
//     min of (bits(max(d, 0)) & ~0x3FFF) | col ('packed', 'packed_ts'),
//     the least distance ('minonly') and the distance to one kept column
//     ('mmonly').
// The operands come from ops/split.py: p_in bf16[n_pad, K] and q_in
// bf16[m_pad, K], target-major, K = 8 * terms, and d = p_in . q_in^T. The
// function is that of csrc/split_mma.cu, the mma.sync kernel this one
// replaces, which stays as the yardstick (ops/split_cuda.py::
// _split_nn_mma_sync). It gives the first minimum of its own values.
//
// The sweep. A block holds 192 source rows as three warpgroups of 64, one
// block an SM, and walks one slice of the targets in tiles of 128. Each
// thread keeps its A fragments in registers for the whole sweep (K = 48:
// three k16 steps, 12 registers; K = 24 is padded to 32, two steps). A
// ring of four B tiles is kept in flight by thread 0: one 2-D TMA copy a
// tile, completing on the stage's "full" mbarrier; each warp releases a
// stage on its "empty" mbarrier once its products of that tile are done,
// and at tile t thread 0 refills tile t - 1's stage with tile t + 3 once
// every warp has released it. The copy lands the tile as wgmma's K-major B
// in a swizzled layout: 128 rows of 128 bytes (64 slots) in the 128-byte
// swizzle for K = 48, 8-row atoms 1,024 bytes apart; rows of 64 bytes (32
// slots) in the 64-byte swizzle for K = 24; the slots past K land as
// zeros; a k-step moves the descriptor 32 bytes along the row. Per tile a
// warpgroup issues one wgmma.m64n128k16 a k-step into 64 f32 accumulators
// a thread, waits, releases the stage and reduces; the other warpgroups'
// products run under the reduction, and the next tiles' copies under all
// three. No block barrier after the set-up. (Tried on the card, PERF.md
// section 6: a copy in 16-byte pieces, the no-swizzle core matrices as they
// are, cost about twice the products; two warpgroups left the tensor cores
// idle during their reductions; two blocks an SM, or a producer warp
// beside three warpgroups, ran out of registers.)
//
// The reduction. In the accumulator layout, lane 4g + t of warp w holds
// rows 16w + g and 16w + g + 8 and, of each 8-column block c, columns
// 8c + 2t and 8c + 2t + 1: 32 columns a row, ascending in (c, e). Columns at
// or past the slice's end (the ragged last tile) read as +inf. Per tile and
// row, a thread takes the least of its 32 values as the int32 min of their
// bits (a tree of three-input integer mins), which is the float min
// wherever no sign bit is set; where one is (a negative value or -0), it
// takes fminf over the 32 instead. A row improves where a lane of its quad
// holds a value strictly below the row's best (an earlier tile wins ties):
// one vote a warp, then, only where some row of the warp may improve, the
// quad's minimum (two shuffles), and the quad copies its 32 values of the
// row to registers, with the tile. After the slice, each lane searches its
// copied values for its first column equal to the best, and the quad takes
// the least column and its value: the first minimum of the slice, with the
// value's own bits. `packed14` takes the same path on the key's bucket,
// max(bits, 0) & ~0x3FFF (strictly lower buckets improve; the search takes
// the first column in the best bucket, and the key is bucket | column);
// `min` keeps a running fminf a row and combines the quad at the end;
// `keep` selects the kept column in its one tile and reads nothing else.
// NaN, as ops/split.py::split_nn_plain treats it: an argmin never picks
// it (E3/E4's pass over the whole block of columns that holds it), it
// keys above every finite value (E3's max(d, 0) keeps it, and its bits
// lie above +inf's), and it makes a row's least value NaN (`min` also
// takes a tree of integer maxes a tile, above +inf's bits only where a
// NaN is among the 32; the combine keeps it). -0 keys as +0 (E3's
// max(-0, 0)). The tensor cores' NaN is the canonical positive
// 0x7FFFFFFF. Source rows past n are computed and
// never written; rows past n_pad read as zeros. With one slice the sweep
// writes the outputs itself; with more it writes [slices, n] partials that
// a second kernel combines (slice order for the argmin, an int32 min for
// the key, a min that keeps a NaN for the least distance).
//
// Instances: terms 6 and 3 x the four epilogues.
//
// What bounds it on this card: the tensor cores' products, 2 * K_pad * N * M
// bf16 flops (26 us for K=48 at 16,384^2 at the dense peak). Measured
// times, their split into products, staging and reduction (by ablations
// that no longer ship) and the yardstick's times in the same call are in
// PERF.md (section 6, Kernel S), beside the card's name and power limit.
//
// C interface (loaded with ctypes). Pointers are device pointers; `stream`
// is a cudaStream_t. Each function launches one kernel, does not
// synchronise, allocates nothing, and returns cudaGetLastError(), or
// 1000 + the CUresult where the TMA descriptor cannot be encoded.

#include <cuda.h>  // the CUtensorMap types; the driver is reached at run time
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kGroups = 3;                      // warpgroups a block
constexpr int kRows = 64 * kGroups;             // source rows a block
constexpr int kThreads = 128 * kGroups;
constexpr int kTile = 128;                      // targets a tile (wgmma n)
constexpr int kStages = 4;                      // B tiles in the ring
constexpr int kSwizzleAtom = 1024;              // the ring's alignment
// a staged row's bytes at terms 3 (K = 24 slots, padded to 32), which is
// also the width of its swizzle; terms 6 takes 128 (48 slots, to 64)
constexpr int kSpan3 = 64;
constexpr int kKeyInit = 0x7F7FFFFF;            // bits of FLT_MAX
constexpr int kLow = (1 << 14) - 1;             // E3's 14 index bits
constexpr int kInfBits = 0x7F800000;            // bits of +inf
constexpr int kIntMax = 0x7FFFFFFF;
constexpr int kMaxDevices = 64;                // devices a process launches on
constexpr int kMapCache = 16;                   // TMA maps kept for reuse

enum class Epilogue { kArgmin = 0, kPacked14 = 1, kMin = 2, kKeepColumn = 3 };

template <int kTerms>
struct Shape {
    static constexpr int kK = 8 * kTerms;                // bf16 values a row
    static constexpr int kSteps = (kK + 15) / 16;        // k16 steps
    static constexpr int kSrcWords = kK / 2;             // words a row
    // a staged row: the swizzle's width in bytes, slots past K zeros
    static constexpr int kSpan = kTerms == 6 ? 128 : kSpan3;
    static constexpr int kStageBytes = kTile * kSpan;    // a B tile
    // the barriers, then the ring aligned to kSwizzleAtom
    static constexpr int kSmem = 2 * kSwizzleAtom + kStages * kStageBytes;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                     smem_u32(bar)),
                 "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_u32(bar)),
        "r"(bytes)
        : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                     smem_u32(bar))
                 : "memory");
}

// spin until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
    const uint32_t addr = smem_u32(bar);
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(addr), "r"(parity)
            : "memory");
    }
}

// one TMA copy of the box at (slot 0, row) into shared memory at `dst`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
            smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0),
        "r"(row)
        : "memory");
}

// the K-major descriptor of a B tile in the swizzle of kSpan bytes (128,
// 64 or 32): rows of kSpan bytes, 8-row atoms 8 kSpan bytes apart (SBO),
// LBO unused (1), the layout type 1, 2 or 3
template <int kSpan>
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
    const uint32_t a = smem_u32(p);
    constexpr uint64_t kLayout = kSpan == 128 ? 1 : kSpan == 64 ? 2 : 3;
    return static_cast<uint64_t>((a & 0x3FFFF) >> 4)
           | static_cast<uint64_t>(1) << 16
           | static_cast<uint64_t>(8 * kSpan >> 4) << 32 | kLayout << 62;
}

// d (+)= a . b^T over 16 slots: A 64 x 16 from registers (the mma.sync
// m16n8k16 A fragment of each warp's 16 rows), B 128 x 16 from shared
// memory, f32 accumulators (thread 32w + 4g + t holds rows 16w + g and
// 16w + g + 8, columns 8c + 2t + e: d[4c + 2h + e], h the row)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate));
}

template <int kN>
__device__ __forceinline__ void fence_acc(float (&d)[kN]) {
#pragma unroll
    for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the accumulator of row h, slot k = 2c + e (column 8c + 2t + e)
__device__ __forceinline__ int slot(int h, int k) {
    return 4 * (k >> 1) + 2 * h + (k & 1);
}

// the least of a thread's 32 values of row h, compared as int32 bits: a
// tree of three-input mins (the float min wherever no sign bit is set)
__device__ __forceinline__ int min_bits(const float (&acc)[64], int h) {
    int m[11];
#pragma unroll
    for (int i = 0; i < 11; ++i) {
        const int a = __float_as_int(acc[slot(h, 3 * i)]);
        const int b = __float_as_int(acc[slot(h, 3 * i + 1)]);
        m[i] = 3 * i + 2 < 32
                   ? min(a, min(b, __float_as_int(acc[slot(h, 3 * i + 2)])))
                   : min(a, b);
    }
    const int x = min(m[0], min(m[1], m[2]));
    const int y = min(m[3], min(m[4], m[5]));
    const int z = min(m[6], min(m[7], m[8]));
    return min(min(x, y), min(z, min(m[9], m[10])));
}

// the greatest of a thread's 32 values of row h as int32 bits, the same
// tree with maxes: above +inf's bits where one of them is a NaN
__device__ __forceinline__ int max_bits(const float (&acc)[64], int h) {
    int m[11];
#pragma unroll
    for (int i = 0; i < 11; ++i) {
        const int a = __float_as_int(acc[slot(h, 3 * i)]);
        const int b = __float_as_int(acc[slot(h, 3 * i + 1)]);
        m[i] = 3 * i + 2 < 32
                   ? max(a, max(b, __float_as_int(acc[slot(h, 3 * i + 2)])))
                   : max(a, b);
    }
    const int x = max(m[0], max(m[1], m[2]));
    const int y = max(m[3], max(m[4], m[5]));
    const int z = max(m[6], max(m[7], m[8]));
    return max(max(x, y), max(z, max(m[9], m[10])));
}

// the first of a lane's 32 copied values of a row that passes `hit`, as
// (column offset 8c + 2t + e, value); (kIntMax, 0) where none does
template <typename Hit>
__device__ __forceinline__ void first_hit(const float (&v)[32], int t,
                                          Hit hit, int& col, float& val) {
    col = kIntMax;
    val = 0.0f;
#pragma unroll
    for (int k = 31; k >= 0; --k) {
        if (hit(v[k])) {
            col = 8 * (k >> 1) + 2 * t + (k & 1);
            val = v[k];
        }
    }
}

template <int kTerms, Epilogue E>
__global__ void __launch_bounds__(kThreads, 1)
split_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                   const uint32_t* __restrict__ p_in, int n, int n_pad,
                   int m, int slice_len, int keep, int clamp,
                   float* __restrict__ part_d, int* __restrict__ part_i) {
    using S = Shape<kTerms>;
    extern __shared__ __align__(kSwizzleAtom) uint8_t smem[];
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    uint64_t* empty = full + kStages;
    // the ring on the first swizzle atom past the barriers
    const uint32_t base = smem_u32(smem);
    uint8_t* ring = smem + (((base + 2 * kStages * 8 + kSwizzleAtom - 1)
                             & ~(kSwizzleAtom - 1)) - base);

    const int tid = threadIdx.x;
    const int j_begin = blockIdx.y * slice_len;
    const int j_end = min(m, j_begin + slice_len);
    const int tiles = (j_end - j_begin + kTile - 1) / kTile;

    if (tid == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], kThreads / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // thread 0 issues the copies: the first kStages tiles now, then at tile
    // t the refill of tile t - 1's stage, once every warp has released it
    auto load = [&](int t) {
        const int st = t % kStages;
        mbar_expect_tx(&full[st], S::kStageBytes);
        tma_load(ring + st * S::kStageBytes, &q_map, &full[st],
                 j_begin + t * kTile);
    };
    if (tid == 0) {
        for (int t = 0; t < min(tiles, kStages); ++t) load(t);
    }

    const int group = tid >> 7;         // the warpgroup: rows 64 * group
    const int warp = (tid >> 5) & 3;    // the warp in its warpgroup
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t4 = lane & 3;            // the thread's pair of columns
    int rows[2];
    rows[0] = blockIdx.x * kRows + 64 * group + 16 * warp + g;
    rows[1] = rows[0] + 8;

    // A fragments: k-step s, words 8s + 4h + t4 of rows g (r = 0), g + 8
    uint32_t a[S::kSteps][4];
#pragma unroll
    for (int s = 0; s < S::kSteps; ++s) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int w = 8 * s + 4 * h + t4;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                a[s][2 * h + r] =
                    (rows[r] < n_pad && w < S::kSrcWords)
                        ? p_in[static_cast<size_t>(rows[r]) * S::kSrcWords + w]
                        : 0u;
            }
        }
    }

    // per row: the best value (argmin), bucket (packed14), least value
    // (min) or kept value (keep); the tile of the last improvement and the
    // thread's 32 values of that tile
    float best[2] = {CUDART_INF_F, CUDART_INF_F};
    int bucket[2] = {kInfBits, kInfBits};
    int best_tile[2] = {-1, -1};
    bool nan_seen[2] = {false, false};  // min: a NaN in the row
    float kept[2][32];
    float acc[64];
#pragma unroll
    for (int k = 0; k < 64; ++k) acc[k] = 0.0f;
    const int keep_tile = (E == Epilogue::kKeepColumn && keep >= j_begin
                           && keep < j_end)
                              ? (keep - j_begin) / kTile
                              : -1;

    for (int t = 0; t < tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(&full[s], (t / kStages) & 1);
        const uint64_t db = smem_desc<S::kSpan>(ring + s * S::kStageBytes);
        fence_acc(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int k = 0; k < S::kSteps; ++k) {
            // k-step k: slots 16k .. 16k + 15, 32 bytes on in each row
            wgmma_m64n128k16(acc, a[k], db + 2 * k, 0 < k);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_acc(acc);
        if (lane == 0) mbar_arrive(&empty[s]);
        if (tid == 0 && t >= 1 && t - 1 + kStages < tiles) {
            const int sp = (t - 1) % kStages;
            mbar_wait(&empty[sp], ((t - 1) / kStages) & 1);
            load(t - 1 + kStages);
        }

        const int t0 = j_begin + t * kTile;
        if constexpr (E == Epilogue::kKeepColumn) {
            if (t == keep_tile) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
#pragma unroll
                    for (int k = 0; k < 32; ++k) {
                        const int col = t0 + 8 * (k >> 1) + 2 * t4 + (k & 1);
                        best[h] = col == keep ? acc[slot(h, k)] : best[h];
                    }
                }
            }
            continue;
        }
        if (t0 + kTile > j_end) {  // the ragged last tile: +inf past the end
#pragma unroll
            for (int k = 0; k < 32; ++k) {
                const int col = t0 + 8 * (k >> 1) + 2 * t4 + (k & 1);
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    acc[slot(h, k)] =
                        col < j_end ? acc[slot(h, k)] : CUDART_INF_F;
                }
            }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int lo = min_bits(acc, h);
            // a row improves where one of its quad's lanes holds a value
            // below its best: one vote a warp, and only where some row of
            // the warp may improve, the quad's minimum (two shuffles)
            if constexpr (E == Epilogue::kPacked14) {
                int key = max(lo, 0) & ~kLow;  // the lane's least bucket
                if (__any_sync(0xffffffffu, key < bucket[h])) {
                    key = min(key, __shfl_xor_sync(0xffffffffu, key, 1));
                    key = min(key, __shfl_xor_sync(0xffffffffu, key, 2));
                    if (key < bucket[h]) {  // quad-uniform
                        bucket[h] = key;
                        best_tile[h] = t;
#pragma unroll
                        for (int k = 0; k < 32; ++k) {
                            kept[h][k] = acc[slot(h, k)];
                        }
                    }
                }
            } else {
                float v = __int_as_float(lo);
                if (lo < 0) {  // a sign bit: the float min of the 32
                    v = acc[slot(h, 0)];
#pragma unroll
                    for (int k = 1; k < 32; ++k) v = fminf(v, acc[slot(h, k)]);
                }
                if constexpr (E == Epilogue::kMin) {
                    best[h] = fminf(best[h], v);
                    nan_seen[h] |= max_bits(acc, h) > kInfBits;
                } else if (__any_sync(0xffffffffu, v < best[h])) {
                    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 1));
                    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 2));
                    if (v < best[h]) {  // strict, quad-uniform
                        best[h] = v;
                        best_tile[h] = t;
#pragma unroll
                        for (int k = 0; k < 32; ++k) {
                            kept[h][k] = acc[slot(h, k)];
                        }
                    }
                }
            }
        }
    }

    const bool direct = gridDim.y == 1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int row = rows[h];
        const size_t o = static_cast<size_t>(blockIdx.y) * n + row;
        if constexpr (E == Epilogue::kKeepColumn) {
            // the keep column: the one lane whose columns hold it writes
            const bool mine = keep_tile >= 0
                              && ((keep - j_begin) & 7) >> 1 == t4;
            if (mine && row < n) {
                part_d[row] = best[h];
            }
        } else if constexpr (E == Epilogue::kMin) {
            float v = best[h];
            v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 1));
            v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 2));
            int nan = nan_seen[h];
            nan |= __shfl_xor_sync(0xffffffffu, nan, 1);
            nan |= __shfl_xor_sync(0xffffffffu, nan, 2);
            if (t4 == 0 && row < n) part_d[o] = nan ? CUDART_NAN_F : v;
        } else {
            int col;
            float val;
            const int t0 = j_begin + best_tile[h] * kTile;
            if constexpr (E == Epilogue::kArgmin) {
                const float b = best[h];
                first_hit(kept[h], t4, [b](float x) { return x <= b; }, col,
                          val);
            } else {
                const int edge = bucket[h] | kLow;
                first_hit(kept[h], t4,
                          [edge](float x) {
                              return max(__float_as_int(x), 0) <= edge;
                          },
                          col, val);
            }
#pragma unroll
            for (int off = 1; off <= 2; off <<= 1) {
                const int oc = __shfl_xor_sync(0xffffffffu, col, off);
                const float ov = __shfl_xor_sync(0xffffffffu, val, off);
                if (oc < col) {
                    col = oc;
                    val = ov;
                }
            }
            if (t4 == 0 && row < n) {
                const bool found = best_tile[h] >= 0;
                if constexpr (E == Epilogue::kArgmin) {
                    const float d = found ? val : CUDART_INF_F;
                    const int i = found ? t0 + col : 0;
                    if (direct) {
                        part_d[row] = clamp ? fmaxf(d, 0.0f) : d;
                        part_i[row] = i;
                    } else {
                        part_d[o] = d;
                        part_i[o] = i;
                    }
                } else {
                    const int key = found ? bucket[h] | (t0 + col) : kKeyInit;
                    if (direct) {
                        part_d[row] = __int_as_float(key);
                        part_i[row] = key & kLow;
                    } else {
                        part_i[o] = key;
                    }
                }
            }
        }
    }
}

// The [slices, n] partials into out_d / out_i [n]: the argmin in slice
// order, first minimum winning (clamped at 0 when asked); the key by an
// int32 min, unpacked to its 14 index bits and read as f32; the least
// distance (a NaN kept) with an index of zeros.
template <Epilogue E>
__global__ void split_wgmma_combine_kernel(const float* __restrict__ part_d,
                                           const int* __restrict__ part_i,
                                           int n, int slices, int clamp,
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
        } else {  // a NaN stays
            const float d = part_d[o];
            bd = (d != d || bd != bd) ? CUDART_NAN_F : fminf(bd, d);
        }
    }
    if constexpr (E == Epilogue::kPacked14) {
        out_d[i] = __int_as_float(bi);
        out_i[i] = bi & kLow;
    } else {
        out_d[i] = (E == Epilogue::kArgmin && clamp) ? fmaxf(bd, 0.0f) : bd;
        out_i[i] = bi;
    }
}

constexpr int kCombineThreads = 256;

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found once at run time
EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* ptr = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t rc = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t rc = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
        if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess) {
            fn = reinterpret_cast<EncodeTiled>(ptr);
        }
    }
    return fn;
}

// The TMA map of q_in as [row][K slots], a box of 128 rows x (the
// swizzle's width) slots: the slots past K (and the rows past q_rows) land
// as zeros. A map is a function of (q_in, q_rows, terms) alone, so the
// last kMapCache are kept and a repeated call encodes nothing.
CUresult tensor_map(const void* q_in, int q_rows, int terms,
                    CUtensorMap* out) {
    struct Entry {
        const void* q;
        int rows, terms;
        CUtensorMap map;
    };
    static std::mutex lock;
    static Entry cache[kMapCache] = {};
    static int next = 0;
    std::lock_guard<std::mutex> hold(lock);
    for (const Entry& e : cache) {
        if (e.q == q_in && e.q != nullptr && e.rows == q_rows
            && e.terms == terms) {
            *out = e.map;
            return CUDA_SUCCESS;
        }
    }
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return CUDA_ERROR_NOT_SUPPORTED;
    const int span = terms == 6 ? Shape<6>::kSpan : Shape<3>::kSpan;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(8 * terms),
                                static_cast<cuuint64_t>(q_rows)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(16 * terms)};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(span / 2), kTile};
    const cuuint32_t unit[2] = {1, 1};
    const CUresult rc = encode(
        out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(q_in),
        dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
        span == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
        : span == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                     : CU_TENSOR_MAP_SWIZZLE_32B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (rc == CUDA_SUCCESS) {
        cache[next] = Entry{q_in, q_rows, terms, *out};
        next = (next + 1) % kMapCache;
    }
    return rc;
}

template <int kTerms, Epilogue E>
cudaError_t launch(const CUtensorMap& map, dim3 grid, cudaStream_t stream,
                   const uint32_t* p, int n, int n_pad, int m, int slice_len,
                   int keep, int clamp, float* part_d, int* part_i) {
    constexpr int kSmem = Shape<kTerms>::kSmem;
    // the instance's attributes, set once a device
    static std::mutex lock;
    static bool set[kMaxDevices] = {};
    int dev = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc != cudaSuccess) return rc;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    {
        std::lock_guard<std::mutex> hold(lock);
        if (!set[dev]) {
            rc = cudaFuncSetAttribute(
                split_wgmma_kernel<kTerms, E>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
            if (rc == cudaSuccess) {
                rc = cudaFuncSetAttribute(
                    split_wgmma_kernel<kTerms, E>,
                    cudaFuncAttributePreferredSharedMemoryCarveout,
                    cudaSharedmemCarveoutMaxShared);
            }
            if (rc != cudaSuccess) return rc;
            set[dev] = true;
        }
    }
    split_wgmma_kernel<kTerms, E><<<grid, kThreads, kSmem, stream>>>(
        map, p, n, n_pad, m, slice_len, keep, clamp, part_d, part_i);
    return cudaGetLastError();
}

template <int kTerms>
cudaError_t launch_terms(int epilogue, const CUtensorMap& map, dim3 grid,
                         cudaStream_t s, const uint32_t* p, int n, int n_pad,
                         int m, int slice_len, int keep, int clamp,
                         float* part_d, int* part_i) {
#define FPCR_WGMMA_LAUNCH(E)                                                  \
    launch<kTerms, E>(map, grid, s, p, n, n_pad, m, slice_len, keep, clamp,   \
                      part_d, part_i)
    switch (epilogue) {
        case 0: return FPCR_WGMMA_LAUNCH(Epilogue::kArgmin);
        case 1: return FPCR_WGMMA_LAUNCH(Epilogue::kPacked14);
        case 2: return FPCR_WGMMA_LAUNCH(Epilogue::kMin);
        case 3: return FPCR_WGMMA_LAUNCH(Epilogue::kKeepColumn);
        default: return cudaErrorInvalidValue;
    }
#undef FPCR_WGMMA_LAUNCH
}

}  // namespace

extern "C" {

int fpcr_split_wgmma_rows_per_block(void) { return kRows; }

// The sweep of source rows [0, n) over target slices of `slice_len`
// targets (a multiple of 128): `epilogue` 0 argmin (part_d, part_i), 1
// packed14 (keys to part_i), 2 min (part_d), as [slices, n] with slices =
// ceil(m / slice_len); with one slice the outputs themselves: part_d and
// part_i [n] the argmin's distance (clamped at 0 where `clamp`) and index,
// the key read as f32 and its 14 index bits, or the least distance; 3
// keep-column, the distance to column `keep` written to part_d[n]. `terms`
// 6 or 3; p_in holds n_pad rows and q_in q_rows >= round_up(m, 8) rows of
// 8 * terms bf16 values; both 16-byte aligned.
int fpcr_split_wgmma(const void* p_in, const void* q_in, int q_rows,
                     int terms, int epilogue, int n, int n_pad, int m,
                     int slice_len, int keep, int clamp, float* part_d,
                     int* part_i, void* stream) {
    if ((terms != 6 && terms != 3) || slice_len % kTile != 0 || n < 1
        || m < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    CUtensorMap map;
    const CUresult enc = tensor_map(q_in, q_rows, terms, &map);
    if (enc != CUDA_SUCCESS) return 1000 + static_cast<int>(enc);
    const dim3 grid((n + kRows - 1) / kRows, (m + slice_len - 1) / slice_len);
    const auto p = static_cast<const uint32_t*>(p_in);
    const auto s = static_cast<cudaStream_t>(stream);
    const cudaError_t rc =
        terms == 6 ? launch_terms<6>(epilogue, map, grid, s, p, n, n_pad, m,
                                     slice_len, keep, clamp, part_d, part_i)
                   : launch_terms<3>(epilogue, map, grid, s, p, n, n_pad, m,
                                     slice_len, keep, clamp, part_d, part_i);
    return static_cast<int>(rc);
}

// Combine the [slices, n] partials of `epilogue` 0, 1 or 2 into out_d and
// out_i [n]; `clamp` != 0 clamps the argmin's distance at 0.
int fpcr_split_wgmma_combine(const float* part_d, const int* part_i,
                             int epilogue, int n, int slices, int clamp,
                             float* out_d, int* out_i, void* stream) {
    const int blocks = (n + kCombineThreads - 1) / kCombineThreads;
    const auto s = static_cast<cudaStream_t>(stream);
#define FPCR_WGMMA_COMBINE(E)                                                 \
    split_wgmma_combine_kernel<E><<<blocks, kCombineThreads, 0, s>>>(         \
        part_d, part_i, n, slices, clamp, out_d, out_i)
    switch (epilogue) {
        case 0: FPCR_WGMMA_COMBINE(Epilogue::kArgmin); break;
        case 1: FPCR_WGMMA_COMBINE(Epilogue::kPacked14); break;
        case 2: FPCR_WGMMA_COMBINE(Epilogue::kMin); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef FPCR_WGMMA_COMBINE
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
