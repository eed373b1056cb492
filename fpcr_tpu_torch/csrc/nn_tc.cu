// Kernels K1 and K2 on the tensor cores of Hopper (sm_90a): one wgmma
// candidate sweep in the norm form, shared by both, and a certified exact
// finish that keeps every pick of the CUDA-core sweep bit for bit.
//
// K1 replaces the TPU kernel fpcr_tpu/ops/matching_pallas.py:196
// nn_argmin_pallas (modes "packed6" and "highest", :302): the index and the
// squared distance of the first minimum of the difference form
// fmaf(dz,dz, fmaf(dy,dy, fmaf(dx,dx, 0))) in ascending target order; a
// masked target never wins; a row with no valid target gets index 0 and
// +inf. K2 replaces the same function's mode "packed6_idx" (:273): the least
// key (bits(d) & ~(2^b - 1)) | j over the same d, then the exact distance of
// the pick. Both functions are those of csrc/matching.cu's CUDA-core sweep,
// which stays as the yardstick.
//
// The sweep. A block holds 128 source rows (two warpgroups of 64) and walks
// a slice of at most 4,096 targets in tiles of 128. Both sides are centred
// on the mean c of the block's rows, and d~ = |p'|^2 + |q'|^2 - 2 p'.q' is
// one product of 32-wide bf16 rows: every f32 lane splits exactly into three
// bf16 parts x = h + m + l, and the rows hold, per coordinate, the six
// products of parts of weight >= 2^-16 ((h,h') (h,m') (m,h') (h,l') (l,h')
// (m,m') of a = -2p' against q'), then |p'|^2's parts against ones and ones
// against |q'|^2's parts: 24 slots, zero-padded to 32, two k16 steps. The
// source rows are split once, and each warp keeps its A fragments in
// registers; the slice's centred targets are read once into shared memory,
// and each tile's bf16 split is written into one of three B buffers (no
// swizzle) under the previous tile's products. Per tile a warpgroup issues
// two wgmma.m64n128k16 (f32 accumulators, 64 registers a thread), stages the
// next tile, waits, and reduces the accumulators on the CUDA cores; the
// other warpgroups of the SM fill the wait. A masked target, and a column
// past the slice, carries 1e30 in its |q'|^2 slots and zeros in its
// coordinates, so no inf or NaN enters an accumulator.
//
// The reduction keeps, per row, only the least value of each tile (the
// float's bits compared as an int: about half an integer min a pair, three-
// input VIMNMX3) and folds it into (b1, t1, b2): the least value, its tile,
// and the least value of every other tile; the quad's four lanes merge by
// __shfl_xor at the end. Target slices over blockIdx.y write [3, slices, n]
// partials and the centres.
//
// The finish merges a row's slices (8 lanes a row), rescans tile t1 exactly
// (K1's first minimum, K2's least key, the expressions of matching.cu), and
// certifies the pick of exact distance d. G bounds |d~_ij - d_ij| for every
// valid j, d_ij the f32 difference form, as 24 * 2^-23 * (|p'_i| +
// |q'_j|)^2. Its terms, in units of 2^-23 (|p'| + |q'|)^2: the tensor cores'
// f32 sums, assuming at most 8 truncations of up to one ulp of the largest
// partial sum (<= (|p'| + |q'|)^2) and the 24 products and the accumulator
// aligned to the largest exponent with at least 3 guard bits (12); the
// difference form's own rounding (2.5); |p'|^2's and |q'|^2's f32 rounding
// (1.5); the centring's f32 rounding (1); the dropped split products (0.5);
// 1% for the partial sums' bound: 17.7 < 24. The card measures at most 2.81
// units on every input that chip_smoke.py checks (_nn_tc_tile_values, the
// test-only dump of one tile): 0.117 of G. With t = d (K1) or the upper edge
// of d's bucket (K2), a valid target outside t1 that reached t would lie
// within sqrt(t) of p, so |q'| <= |p'| + sqrt(t), and its value would lie
// below t + G with G taken at that |q'|; every value outside t1 is at least
// b2, so b2 - G > t certifies the pick: it is then the one the CUDA-core
// sweep makes, with the same bits. An uncertified row (a tie or near tie
// across tiles, no valid target in t1, a negative b2) goes to its block's
// list, and is rescanned against all M targets exactly and written by the
// same rule; the rescued rows are counted in a device counter. The rescue
// is spread over the card: the hall scan's rangeless returns fill whole
// blocks, and a block that rescanned its own list (75 rows on the
// benchmark's noised hall) kept one SM busy while the others idled. So the
// finish launch holds, after its certify blocks, one rescue block an SM; a
// block's role is the ticket it draws as it starts, so a rescue block waits
// only for certify blocks that are already running. The rescue blocks share
// the listed rows out in groups of up to 4, each row's targets in 1,024
// strided slices merged by the least (distance, index) or key. Two
// launches a call, nothing read back to the host.
//
// What bounds it on this card (NVIDIA H100 80GB HBM3, 700.00 W, 16,384^2,
// the synthetic scene; measured by ablations of the sweep, without the
// reduction, without restaging or without either, that no longer ship): the
// products (2 * 32 * N * M bf16 flops, 17 us at the dense peak) and their
// latency set a skeleton of 35 us (products, barrier and one column kept);
// restaging the tiles adds 16 us; the reduction, once the integer min/max of
// a best/runner-up key a pair (4 ALU instructions a pair at half the FP32
// rate: 72 us) and now half an instruction a pair, adds 2 us: 53 us for the
// sweep. The finish took 20-23 us: the tile rescan of every row and the
// exact rescan of the 1.7% of rows that did not certify. K1 0.075 ms against
// the CUDA-core sweep's 0.104 ms in the same process; K2 0.085 ms against
// 0.097 ms. With the rescue in the row's own block the finish took 22 us on
// the synthetic scene (279 rows rescued, at most 10 in one block), 56-92 us
// on the benchmark's noised hall scan (86-153 rows, up to 75 in one block)
// and 145 us on the noise-free hall (4,367 rows, whole blocks): one SM
// rescanning while the others idled. With the rescue spread it takes
// 13.1-14.8 us on the noised hall, 15.3 us on the synthetic scene and 63 us
// on the noise-free hall; at B = 32 (4,096 certify blocks) 212-286 us,
// against the in-block rescue's 213-307 us. The rescue's share, about 8 us
// a pass, is a chain of dependent reads (the wait, the lengths, the row,
// its point, the targets) more than its 1.2-2.5 M exact pairs.
//
// The batch axis: B independent (p, q, mask) elements of equal shapes run
// in one sweep launch and one finish launch, the sweep's element on
// blockIdx.z (B <= 65,535), a certify block's from its ticket, each block
// offsetting its inputs, partials, centres and outputs by its element. This is the counterpart of vmap over
// nn_argmin_pallas, which adds a batch axis to the TPU kernel's grid (the
// serving path, fpcr_tpu/models/batch.py). A block computes exactly what
// it computes unbatched, and the (least, tile, runner-up) state does not
// depend on how the targets are sliced, so every element's picks and
// distance bits equal those of a separate call. The finish has an instance
// without the offsets for B = 1: offsetting its pointers in every launch
// took the unbatched K1's kernel from 0.075 to 0.081 ms at 16,384^2 on this
// card (both versions timed in one chip call; the finish's registers rose
// from 57 to 64).
//
// C interface (loaded with ctypes). Pointers are device pointers; `stream`
// is a cudaStream_t. Each function launches one kernel, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kGroups = 2;               // warpgroups a sweep block
constexpr int kRows = 64 * kGroups;      // its source rows
constexpr int kTile = 128;               // targets a tile (the wgmma's n)
constexpr int kBuffers = 3;              // B tiles in shared memory
constexpr int kMaxSlice = 4096;          // targets a slice (in shared memory)
constexpr int kKeyInit = 0x7F7FFFFF;     // K2's initial key (matching.cu)
constexpr int kIntMax = 0x7FFFFFFF;
constexpr float kSurrogate = 1e30f;      // |q|^2 of a masked target
constexpr double kGuard = 24.0 / 8388608.0;  // G / (|p'| + |q'|)^2
constexpr int kStagedGroups = 3;         // k-groups 0-2 change; 3 is zeros
// the operands' shared layout, without swizzle: core matrices of 8 rows x 16
// bytes, 128 contiguous bytes each; LBO steps along K, SBO over 8 rows
constexpr int kCoreBytes = 128;  // LBO
constexpr int kGroupBytes = 512;  // SBO: one 8-row group's 4 core matrices

// the sweep's instances: the path's, and the guard check's, which also
// dumps one tile's values
enum Mode { kSweep = 0, kDump = 1 };

// uint4 offset of (row, k-group of 8 slots) in an operand tile
__device__ __forceinline__ int cell_offset(int row, int kg) {
    return (row >> 3) * (kGroupBytes / 16) + kg * (kCoreBytes / 16)
           + (row & 7);
}

__device__ __forceinline__ uint64_t smem_desc(const void* p) {
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    return static_cast<uint64_t>((a & 0x3FFFF) >> 4)
           | static_cast<uint64_t>(kCoreBytes >> 4) << 16
           | static_cast<uint64_t>(kGroupBytes >> 4) << 32;  // no swizzle
}

// d (+)= a . b^T over 16 slots: A 64 x 16 from registers (the mma.sync
// m16n8k16 A fragment of each warp's 16 rows: a0 row g, a1 row g + 8, slots
// 2t, 2t + 1; a2, a3 the same rows, slots 2t + 8, 2t + 9; g = lane / 4, t =
// lane % 4) and B 128 x 16 from shared memory, K-major bf16, f32
// accumulators (thread t of the warpgroup holds rows 16 (t / 32) + (t % 32)
// / 4 and 8 below it, columns 8 c + 2 (t % 4) + {0, 1}: d[4c + 2h + e])
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

__device__ __forceinline__ uint32_t pack2(float a, float b) {
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(a));
    const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(b));
    return lo | hi << 16;
}

// x = h + m + l exactly, each part rounded to nearest even through bf16
// (ops/split.py::split3_f32), the parts kept as floats
struct Parts {
    float h, m, l;
};

__device__ __forceinline__ Parts split3(float x) {
    Parts s;
    s.h = __bfloat162float(__float2bfloat16_rn(x));
    const float r = x - s.h;
    s.m = __bfloat162float(__float2bfloat16_rn(r));
    s.l = __bfloat162float(__float2bfloat16_rn(r - s.m));
    return s;
}

__device__ __forceinline__ float sq3(float x, float y, float z) {
    return fmaf(z, z, fmaf(y, y, x * x));
}

// Slots 8 KG .. 8 KG + 7 of a source row (kSource: a = -2p') or a target row
// (q'), as one uint4: slots 6c .. 6c + 5 the products of parts of coordinate
// c, (A part, B part) = (h,h) (h,m) (m,h) (h,l) (l,h) (m,m); 18-20 |p'|^2's
// parts against ones; 21-23 ones against |q'|^2's parts (w); 24-31 zeros.
// Only the splits that the group needs survive the compiler.
template <bool kSource, int KG>
__device__ __forceinline__ uint4 slot_group(float x, float y, float z,
                                            float w) {
    float v[32];
    const float c[3] = {x, y, z};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const Parts s = split3(kSource ? -2.0f * c[k] : c[k]);
        const float a[6] = {s.h, s.h, s.m, s.h, s.l, s.m};
        const float b[6] = {s.h, s.m, s.h, s.l, s.h, s.m};
#pragma unroll
        for (int t = 0; t < 6; ++t) v[6 * k + t] = kSource ? a[t] : b[t];
    }
    const Parts n = split3(w);
    const float np[3] = {n.h, n.m, n.l};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        v[18 + k] = kSource ? np[k] : 1.0f;
        v[21 + k] = kSource ? 1.0f : np[k];
    }
#pragma unroll
    for (int k = 24; k < 32; ++k) v[k] = 0.0f;
    return make_uint4(pack2(v[8 * KG], v[8 * KG + 1]),
                      pack2(v[8 * KG + 2], v[8 * KG + 3]),
                      pack2(v[8 * KG + 4], v[8 * KG + 5]),
                      pack2(v[8 * KG + 6], v[8 * KG + 7]));
}

// One changing k-group (0-2, warp-uniform) of a row, centred coordinates
template <bool kSource>
__device__ __forceinline__ uint4 slots(int kg, float x, float y, float z,
                                       float w) {
    if (kg == 0) return slot_group<kSource, 0>(x, y, z, w);
    if (kg == 1) return slot_group<kSource, 1>(x, y, z, w);
    return slot_group<kSource, 2>(x, y, z, w);
}

// A row's sweep state over the tiles it has seen: the least value (the
// float's bits as an int), its tile, and the least value of every other
// tile. Ties go to the lower tile.
struct Best {
    int b1 = kIntMax, t1 = -1, b2 = kIntMax;

    // one tile's least value; tiles come in ascending order
    __device__ __forceinline__ void take(int v, int tile) {
        if (v < b1) {
            b2 = b1;
            b1 = v;
            t1 = tile;
        } else {
            b2 = min(b2, v);
        }
    }

    // another state over disjoint columns: b2 stays a lower bound of every
    // value outside tile t1
    __device__ __forceinline__ void merge(const Best& o) {
        if (o.t1 == t1) {
            b1 = min(b1, o.b1);
            b2 = min(b2, o.b2);
        } else if (o.b1 < b1 || (o.b1 == b1 && o.t1 < t1)) {
            b2 = min(o.b2, b1);
            b1 = o.b1;
            t1 = o.t1;
        } else {
            b2 = min(b2, o.b1);
        }
    }
};

// A staged target: centred coordinates and the |q'|^2 slot (the surrogate
// with zero coordinates for a masked target or a column past the slice)
struct Target {
    float x, y, z, w;
};

__device__ __forceinline__ Target load_target(const float* __restrict__ q,
                                              const uint8_t* __restrict__ mask,
                                              int j, int j_end, float4 c) {
    if (j < j_end && (mask == nullptr || mask[j] != 0)) {
        const float x = q[3 * j] - c.x;
        const float y = q[3 * j + 1] - c.y;
        const float z = q[3 * j + 2] - c.z;
        return Target{x, y, z, sq3(x, y, z)};
    }
    return Target{0.0f, 0.0f, 0.0f, kSurrogate};
}

// The candidate sweep of 64 * kGroups source rows over one target slice, in
// tiles of 128 targets. kDump also writes d~ of the slice's first 64
// targets to dump[row * 64 + col]. The first block clears the finish's
// counters, `ctrl`.
template <int kMode>
__global__ void __launch_bounds__(128 * kGroups)
nn_tc_sweep_kernel(const float* __restrict__ p, const float* __restrict__ q,
                   const uint8_t* __restrict__ mask, int n, int m,
                   int slice_len, int* __restrict__ part,
                   float4* __restrict__ part_c, float* __restrict__ dump,
                   int* __restrict__ ctrl) {
    constexpr int kThreads = 128 * kGroups;
    constexpr int kCells = (kStagedGroups * kTile + kThreads - 1) / kThreads;
    __shared__ __align__(128) uint4 a_tile[kRows * 4];
    __shared__ __align__(128) uint4 b_tile[kBuffers][kTile * 4];
    __shared__ float4 warp_sum[kThreads / 32];
    __shared__ float4 centre;
    extern __shared__ float4 raw[];  // the slice's targets

    // the batch element on blockIdx.z: its source rows, targets, mask,
    // partials and centres
    {
        const size_t e = blockIdx.z;
        p += e * 3 * n;
        q += e * 3 * m;
        if (mask != nullptr) mask += e * m;
        part += e * 3 * gridDim.y * n;
        part_c += e * gridDim.x;
        if (dump != nullptr) dump += e * 64 * n;
    }
    const int tid = threadIdx.x;
    if (tid == 0 && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0) {
        ctrl[0] = 0;  // the finish's tickets
        ctrl[1] = 0;  // and its certify blocks done
    }
    const int group = tid >> 7;           // the warpgroup: A rows 64 * group
    const int warp = (tid >> 5) & 3;      // the warp in its warpgroup
    const int lane = tid & 31;
    const int slices = gridDim.y;
    const int row_base = blockIdx.x * kRows;
    const int j_begin = blockIdx.y * slice_len;
    const int j_end = min(m, j_begin + slice_len);
    const int tiles = (j_end - j_begin + kTile - 1) / kTile;

    // the centre: the mean of the block's valid rows, summed in a fixed order
    {
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (tid < kRows && row_base + tid < n) {
            const int i = row_base + tid;
            v = make_float4(p[3 * i], p[3 * i + 1], p[3 * i + 2], 1.0f);
        }
#pragma unroll
        for (int off = 16; off >= 1; off >>= 1) {
            v.x += __shfl_xor_sync(0xffffffffu, v.x, off);
            v.y += __shfl_xor_sync(0xffffffffu, v.y, off);
            v.z += __shfl_xor_sync(0xffffffffu, v.z, off);
            v.w += __shfl_xor_sync(0xffffffffu, v.w, off);
        }
        if (lane == 0) warp_sum[tid >> 5] = v;
        __syncthreads();
        if (tid == 0) {
            float4 s = warp_sum[0];
            for (int w = 1; w < kRows / 32; ++w) {
                s.x += warp_sum[w].x;
                s.y += warp_sum[w].y;
                s.z += warp_sum[w].z;
                s.w += warp_sum[w].w;
            }
            centre = make_float4(s.x / s.w, s.y / s.w, s.z / s.w, 0.0f);
            if (blockIdx.y == 0) part_c[blockIdx.x] = centre;
        }
        __syncthreads();
    }
    const float4 c = centre;

    // A: the block's source rows, centred and split once; rows past n and
    // k-group 3 are zeros, as is k-group 3 of every B buffer
    for (int cell = tid; cell < kRows * 4; cell += kThreads) {
        const int r = cell % kRows;
        const int kg = cell / kRows;
        const int i = row_base + r;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (kg < kStagedGroups && i < n) {
            const float x = p[3 * i] - c.x;
            const float y = p[3 * i + 1] - c.y;
            const float z = p[3 * i + 2] - c.z;
            v = slots<true>(kg, x, y, z, sq3(x, y, z));
        }
        a_tile[cell_offset(r, kg)] = v;
    }
    for (int r = tid; r < kBuffers * kTile; r += kThreads) {
        b_tile[r / kTile][cell_offset(r % kTile, 3)] =
            make_uint4(0u, 0u, 0u, 0u);
    }
    // the slice's targets, centred, with their |q'|^2 slot (the surrogate
    // for a masked target and past the slice), once into shared memory
    for (int s = tid; s < tiles * kTile; s += kThreads) {
        const Target t = load_target(q, mask, j_begin + s, j_end, c);
        raw[s] = make_float4(t.x, t.y, t.z, t.w);
    }
    __syncthreads();
    // B: this thread's cells (target s, k-group kg) of a tile
    auto stage = [&](int tile) {
#pragma unroll
        for (int k = 0; k < kCells; ++k) {
            const int cell = tid + k * kThreads;
            if (cell < kStagedGroups * kTile) {
                const float4 t = raw[tile * kTile + cell % kTile];
                b_tile[tile % kBuffers][cell_offset(cell % kTile,
                                                    cell / kTile)] =
                    slots<false>(cell / kTile, t.x, t.y, t.z, t.w);
            }
        }
    };
    stage(0);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // A's fragments in registers for the whole sweep: k-step s reads
    // k-groups 2s and 2s + 1 of rows g and g + 8 of the warp's 16
    uint32_t a_frag[2][4];
    {
        const int r = 64 * group + 16 * warp + (lane >> 2);
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
            for (int f = 0; f < 4; ++f) {
                const uint32_t* w = reinterpret_cast<const uint32_t*>(
                    &a_tile[cell_offset(r + 8 * (f & 1), 2 * ks + (f >> 1))]);
                a_frag[ks][f] = w[lane & 3];
            }
        }
    }
    const int row0 = row_base + 64 * group + 16 * warp + (lane >> 2);
    Best st[2];
    float acc[64];
#pragma unroll
    for (int k = 0; k < 64; ++k) acc[k] = 0.0f;

    // One tile: issue its products, stage the next tile under them, wait,
    // reduce. The other warpgroups' reductions fill the wait. Tile t + 1's
    // buffer last held tile t - 2, which every warpgroup is done with.
    for (int t = 0; t < tiles; ++t) {
        const uint64_t db = smem_desc(b_tile[t % kBuffers]);
        fence_acc(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        wgmma_m64n128k16(acc, a_frag[0], db, 0);
        // the second k16 step: slots 16-31, 256 bytes on (16-byte units)
        wgmma_m64n128k16(acc, a_frag[1], db + 16, 1);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        if (t + 1 < tiles) stage(t + 1);
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_acc(acc);
        if constexpr (kMode == kDump) {
            if (t == 0 && blockIdx.y == 0) {
#pragma unroll
                for (int k = 0; k < 32; ++k) {
                    const int row = row0 + 8 * ((k >> 1) & 1);
                    const int col = 8 * (k >> 2) + 2 * (lane & 3) + (k & 1);
                    if (row < n) dump[row * 64 + col] = acc[k];
                }
            }
        }
        // the least value (as an int) of the thread's 32 columns of each of
        // its two rows: acc[4 cb + 2 h + e], row h
        const int tile = j_begin / kTile + t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            int lo = __float_as_int(acc[2 * h]);
#pragma unroll
            for (int cb = 0; cb < 16; ++cb) {
                const int a = __float_as_int(acc[4 * cb + 2 * h + 1]);
                const int b = cb + 1 < 16
                                  ? __float_as_int(acc[4 * cb + 4 + 2 * h])
                                  : a;
                lo = min(lo, min(a, b));
            }
            st[h].take(lo, tile);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
    }

    // the quad's four lanes hold interleaved columns of the same rows
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            Best o;
            o.b1 = __shfl_xor_sync(0xffffffffu, st[h].b1, off);
            o.t1 = __shfl_xor_sync(0xffffffffu, st[h].t1, off);
            o.b2 = __shfl_xor_sync(0xffffffffu, st[h].b2, off);
            st[h].merge(o);
        }
    }
    if ((lane & 3) == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = row0 + 8 * h;
            if (row < n) {
                const size_t o = static_cast<size_t>(blockIdx.y) * n + row;
                const size_t plane = static_cast<size_t>(slices) * n;
                part[o] = st[h].b1;
                part[plane + o] = st[h].t1;
                part[2 * plane + o] = st[h].b2;
            }
        }
    }
}

// The exact squared distance of K1's and K2's CUDA-core sweep
// (matching.cu): w = 0 for a valid target, +inf for a masked one
__device__ __forceinline__ float exact_d(float px, float py, float pz,
                                         float4 t) {
    const float dx = px - t.x;
    const float dy = py - t.y;
    const float dz = pz - t.z;
    return fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, t.w)));
}

__device__ __forceinline__ float4 target4(const float* __restrict__ q,
                                          const uint8_t* __restrict__ mask,
                                          int j) {
    const bool valid = mask == nullptr || mask[j] != 0;
    return make_float4(q[3 * j], q[3 * j + 1], q[3 * j + 2],
                       valid ? 0.0f : CUDART_INF_F);
}

constexpr int kFinishRows = 128;      // rows a certify block: 8 lanes a row
constexpr int kFinishThreads = 1024;  // a finish block, certify or rescue
constexpr int kRescueRows = 4;        // listed rows a rescue group takes
constexpr int kRescueUnroll = 2;      // targets a thread loads at once
// a certify block's rows are a sweep block's: its list's length goes to
// the w of that block's centre, which the finish does not read
static_assert(kFinishRows == kRows, "a centre for each list");

__device__ __forceinline__ int load_acquire(const int* a) {
    int v;
    asm volatile("ld.acquire.gpu.s32 %0, [%1];\n"
                 : "=r"(v)
                 : "l"(a)
                 : "memory");
    return v;
}

// The inclusive sum of v over the block's threads up to this one, and in
// `total` the block's sum. Every thread of the block calls it.
__device__ __forceinline__ int block_scan(int v, int* warp_total,
                                          int& total) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
    }
    if (lane == 31) warp_total[warp] = v;
    __syncthreads();
    if (warp == 0) {
        int w = warp_total[lane];
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const int u = __shfl_up_sync(0xffffffffu, w, off);
            if (lane >= off) w += u;
        }
        warp_total[lane] = w;  // inclusive over the warps
    }
    __syncthreads();
    total = warp_total[kFinishThreads / 32 - 1];
    if (warp > 0) v += warp_total[warp - 1];
    __syncthreads();  // warp_total is free again
    return v;
}

// The finish: `lists` = B * ceil(n / 128) certify blocks, then gridDim.x -
// lists rescue blocks, in one launch. A block draws a ticket as it starts;
// the first `lists` tickets certify, the rest rescue. So every certify
// block has started, and never waits, before a rescue block waits for them:
// the wait cannot keep a certify block from an SM.
//
// Certify block c (element e = c / ceil(n / 128)): merge the slices'
// partials of each of its 128 rows (8 lanes a row), certify, write; its
// uncertified rows (as e * n + i) go to its list, written where its own
// rows' slice-0 values were, which only it reads, its length to lens[c];
// then it counts itself done. The lengths and the two counters live in the
// centres: lens[c] in the w of centre c, the counters in the four words
// after the last centre, which the sweep cleared.
//
// Rescue block k of R: wait until every certify block is done, then take
// groups of r consecutive listed rows, r = min(4, ceil(total / R)), the
// lists read in chunks of 1,024 (each chunk's exclusive prefix in shared
// memory, a row found by binary search), the chunk's groups dealt to the
// blocks in turn, continuing across chunks. A group rescans every target
// exactly: thread t's slice is targets t, t + 1024, ... in ascending order
// (K1's first minimum by the strict <, K2's least key), read once for all
// the group's rows where they share an element, and the slices merge by
// the least (distance, index) or key, the first minimum in ascending
// target order. Each row is then written and adds 1 to *rescued.
template <bool kPacked, bool kBatched>
__global__ void __launch_bounds__(kFinishThreads)
nn_tc_finish_kernel(const float* __restrict__ p, const float* __restrict__ q,
                    const uint8_t* __restrict__ mask, int* __restrict__ part,
                    float4* __restrict__ part_c, int rows_per_block,
                    int n, int m, int slices, int idx_bits, int lists,
                    float* __restrict__ out_d, int* __restrict__ out_i,
                    unsigned long long* __restrict__ rescued) {
    __shared__ int ticket;
    __shared__ int listed;
    __shared__ int list[kFinishRows];
    __shared__ int start[kFinishThreads + 1];
    __shared__ int warp_total[kFinishThreads / 32];
    __shared__ float warp_d[kRescueRows][kFinishThreads / 32];
    __shared__ int warp_i[kRescueRows][kFinishThreads / 32];
    __shared__ int group_row[kRescueRows];  // e * n + i of a group's rows
    const int tid = threadIdx.x;
    const int low = (1 << idx_bits) - 1;
    const size_t plane = static_cast<size_t>(slices) * n;
    const int per_element = (n + kFinishRows - 1) / kFinishRows;
    int* const ctrl = reinterpret_cast<int*>(part_c + lists);
    int* const lens = reinterpret_cast<int*>(part_c) + 3;  // stride 4
    if (tid == 0) ticket = atomicAdd(ctrl, 1);
    __syncthreads();
    const int c = ticket;

    if (c < lists) {
        // the element's rows, targets, mask, partials, centres and outputs
        // (the unbatched instance folds the offsets away)
        const size_t e = kBatched ? c / per_element : 0;
        const int blk = c - static_cast<int>(e) * per_element;
        const float* pe = p + e * 3 * n;
        const float* qe = q + e * 3 * m;
        const uint8_t* me = mask == nullptr ? nullptr : mask + e * m;
        int* parte = part + e * 3 * plane;
        const float4* ce =
            part_c + e * ((n + rows_per_block - 1) / rows_per_block);
        // every lane runs the merge's shuffles; a row past n repeats the
        // last
        const int i = min(blk * kFinishRows + (tid >> 3), n - 1);
        const bool own = blk * kFinishRows + (tid >> 3) < n;
        const int sub = tid & 7;
        if (tid == 0) listed = 0;
        __syncthreads();
        Best st;  // the row's 8 lanes together
        for (int sl = sub; sl < slices; sl += 8) {
            const size_t o = static_cast<size_t>(sl) * n + i;
            Best b;
            b.b1 = parte[o];
            b.t1 = parte[plane + o];
            b.b2 = parte[2 * plane + o];
            st.merge(b);
        }
#pragma unroll
        for (int off = 4; off >= 1; off >>= 1) {
            Best o;
            o.b1 = __shfl_xor_sync(0xffffffffu, st.b1, off);
            o.t1 = __shfl_xor_sync(0xffffffffu, st.t1, off);
            o.b2 = __shfl_xor_sync(0xffffffffu, st.b2, off);
            st.merge(o);
        }
        // the exact pick inside tile t1: lane `sub` takes its columns
        // sub, sub + 8, ... in ascending order
        const float px = pe[3 * i], py = pe[3 * i + 1], pz = pe[3 * i + 2];
        float bd = CUDART_INF_F;
        int bi = 0;
        int key = kKeyInit;
        const int j0 = kTile * st.t1;
        for (int j = j0 + sub; j < min(m, j0 + kTile); j += 8) {
            const float d = exact_d(px, py, pz, target4(qe, me, j));
            if constexpr (kPacked) {
                key = min(key, (__float_as_int(d) & ~low) | j);
            } else if (d < bd) {
                bd = d;
                bi = j;
            }
        }
#pragma unroll
        for (int off = 4; off >= 1; off >>= 1) {
            if constexpr (kPacked) {
                key = min(key, __shfl_xor_sync(0xffffffffu, key, off));
            } else {
                const float od = __shfl_xor_sync(0xffffffffu, bd, off);
                const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
                if (od < bd || (od == bd && oi < bi)) {
                    bd = od;
                    bi = oi;
                }
            }
        }
        if constexpr (kPacked) {
            if (key != kKeyInit) {
                bi = min(key & low, m - 1);
                bd = exact_d(px, py, pz, target4(qe, nullptr, bi));
            }
        }
        // every value outside tile t1 is at least float(b2); a target there
        // that reached t (the pick's distance, or for K2 the upper edge of
        // its bucket) would lie within sqrt(t) of p, so |q'| <= |p'| +
        // sqrt(t), and its value would be below t + G
        bool certified = st.b2 >= 0 && bd < CUDART_INF_F;
        if (certified) {  // b2 stays kIntMax where tile t1 holds every target
            const double lo = st.b2 == kIntMax
                                  ? CUDART_INF
                                  : static_cast<double>(__int_as_float(st.b2));
            const float4 cc = ce[i / rows_per_block];
            const double x = px - cc.x, y = py - cc.y, z = pz - cc.z;
            const float edge = __int_as_float((__float_as_int(bd) & ~low)
                                              + low + 1);
            const double t = kPacked ? edge : bd;
            const double r = 2.0 * sqrt(x * x + y * y + z * z)
                             + sqrt(t * (1.0 + 1.0 / 1048576.0));
            certified = lo - kGuard * r * r > t;
        }
        if (own && sub == 0) {
            if (certified) {
                out_d[e * n + i] = bd;
                out_i[e * n + i] = bi;
            } else {
                list[atomicAdd(&listed, 1)] = i;
            }
        }
        // every lane has read its row's partials: the block's rows' slice-0
        // values are free for its list
        __syncthreads();
        const int count = listed;
        if (tid < count) {
            parte[blk * kFinishRows + tid] = static_cast<int>(e) * n
                                             + list[tid];
        }
        if (tid == 0) lens[4 * c] = count;
        __threadfence();
        __syncthreads();
        if (tid == 0) atomicAdd(ctrl + 1, 1);
        return;
    }

    // a rescue block
    const int rank = c - lists;
    const int blocks = static_cast<int>(gridDim.x) - lists;
    if (tid == 0) {
        while (load_acquire(ctrl + 1) < lists) __nanosleep(64);
    }
    __syncthreads();
    int total;
    {
        int sum = 0;
        for (int k = tid; k < lists; k += kFinishThreads) {
            sum += __ldcg(lens + 4 * k);
        }
        block_scan(sum, warp_total, total);
    }
    if (total == 0) return;
    const int per_group = min(kRescueRows, (total + blocks - 1) / blocks);
    const int warp = tid >> 5;
    const int lane = tid & 31;
    int before = 0;  // groups of the earlier chunks
    for (int c0 = 0; c0 < lists; c0 += kFinishThreads) {
        const int here = min(kFinishThreads, lists - c0);
        int chunk;
        const int incl =
            block_scan(tid < here ? __ldcg(lens + 4 * (c0 + tid)) : 0,
                       warp_total, chunk);
        if (tid < here) start[tid + 1] = incl;
        if (tid == 0) start[0] = 0;
        __syncthreads();
        const int groups = (chunk + per_group - 1) / per_group;
        int g = (rank - before) % blocks;
        if (g < 0) g += blocks;
        for (; g < groups; g += blocks) {
            const int w0 = g * per_group;
            const int rows_here = min(per_group, chunk - w0);  // uniform
            // thread k finds row k, the last one repeated past rows_here
            if (tid < kRescueRows) {
                const int w = w0 + min(tid, rows_here - 1);
                int lo = 0, hi = here;  // the list with start[lo] <= w
                while (hi - lo > 1) {
                    const int mid = (lo + hi) >> 1;
                    if (start[mid] <= w) lo = mid;
                    else hi = mid;
                }
                const int at = c0 + lo;
                const size_t le = kBatched ? at / per_element : 0;
                const int lb = at - static_cast<int>(le) * per_element;
                group_row[tid] = __ldcg(part + le * 3 * plane
                                        + static_cast<size_t>(lb)
                                              * kFinishRows
                                        + w - start[lo]);
            }
            __syncthreads();
            const int e0 = kBatched ? group_row[0] / n : 0;
            bool one = true;  // every row of the group in one element
            float px[kRescueRows], py[kRescueRows], pz[kRescueRows];
            float bd[kRescueRows];
            int bi[kRescueRows], key[kRescueRows];
#pragma unroll
            for (int k = 0; k < kRescueRows; ++k) {
                const int r = group_row[k];
                if (kBatched) one = one && r / n == e0;
                const float* pr = p + 3 * static_cast<size_t>(r);
                px[k] = pr[0];
                py[k] = pr[1];
                pz[k] = pr[2];
                bd[k] = CUDART_INF_F;  // K1: the slice's first minimum
                bi[k] = 0;
                key[k] = kKeyInit;     // K2: the slice's least key
            }
            // one row's take of target j at t
            auto take = [&](int k, int j, float4 t) {
                const float d = exact_d(px[k], py[k], pz[k], t);
                if constexpr (kPacked) {
                    key[k] = min(key[k], (__float_as_int(d) & ~low) | j);
                } else if (d < bd[k]) {  // strict: ascending j in the slice
                    bd[k] = d;
                    bi[k] = j;
                }
            };
            if (one) {  // each target read once for the group's rows
                const size_t e = e0;
                const float* qe = q + 3 * e * m;
                const uint8_t* me = mask == nullptr ? nullptr : mask + e * m;
                for (int j0 = tid; j0 < m;
                     j0 += kRescueUnroll * kFinishThreads) {
                    float4 t[kRescueUnroll];
#pragma unroll
                    for (int u = 0; u < kRescueUnroll; ++u) {
                        const int j = j0 + u * kFinishThreads;
                        if (j < m) t[u] = target4(qe, me, j);
                    }
#pragma unroll
                    for (int u = 0; u < kRescueUnroll; ++u) {
                        const int j = j0 + u * kFinishThreads;
                        if (j >= m) break;
#pragma unroll
                        for (int k = 0; k < kRescueRows; ++k) {
                            if (k < rows_here) take(k, j, t[u]);
                        }
                    }
                }
            } else {  // rows of several elements: each its own targets
#pragma unroll
                for (int k = 0; k < kRescueRows; ++k) {
                    if (k >= rows_here) break;
                    const size_t e = group_row[k] / n;
                    const float* qe = q + 3 * e * m;
                    const uint8_t* me =
                        mask == nullptr ? nullptr : mask + e * m;
                    for (int j = tid; j < m; j += kFinishThreads) {
                        take(k, j, target4(qe, me, j));
                    }
                }
            }
            // the slices' merge: the warp's, then the block's
#pragma unroll
            for (int k = 0; k < kRescueRows; ++k) {
                if (k >= rows_here) break;
#pragma unroll
                for (int off = 16; off >= 1; off >>= 1) {
                    if constexpr (kPacked) {
                        key[k] = min(key[k], __shfl_xor_sync(0xffffffffu,
                                                             key[k], off));
                    } else {
                        const float od =
                            __shfl_xor_sync(0xffffffffu, bd[k], off);
                        const int oi =
                            __shfl_xor_sync(0xffffffffu, bi[k], off);
                        if (od < bd[k] || (od == bd[k] && oi < bi[k])) {
                            bd[k] = od;
                            bi[k] = oi;
                        }
                    }
                }
                if (lane == 0) {
                    warp_d[k][warp] = bd[k];
                    warp_i[k][warp] = kPacked ? key[k] : bi[k];
                }
            }
            __syncthreads();
#pragma unroll
            for (int k = 0; k < kRescueRows; ++k) {  // warp k merges row k
                if (warp != k || k >= rows_here) continue;
                float d = warp_d[k][lane];
                int j = warp_i[k][lane];
#pragma unroll
                for (int off = 16; off >= 1; off >>= 1) {
                    if constexpr (kPacked) {
                        j = min(j, __shfl_xor_sync(0xffffffffu, j, off));
                    } else {
                        const float od = __shfl_xor_sync(0xffffffffu, d, off);
                        const int oi = __shfl_xor_sync(0xffffffffu, j, off);
                        if (od < d || (od == d && oi < j)) {
                            d = od;
                            j = oi;
                        }
                    }
                }
                if (lane == 0) {
                    const int r = group_row[k];
                    if constexpr (kPacked) {
                        if (j == kKeyInit) {  // no valid target
                            d = CUDART_INF_F;
                            j = 0;
                        } else {
                            j = min(j & low, m - 1);
                            const size_t e = kBatched ? r / n : 0;
                            d = exact_d(px[k], py[k], pz[k],
                                        target4(q + 3 * e * m, nullptr, j));
                        }
                    }
                    out_d[r] = d;
                    out_i[r] = j;
                    atomicAdd(rescued, 1ull);
                }
            }
            __syncthreads();  // warp_d, warp_i and group_row are free again
        }
        before += groups;
        __syncthreads();  // start is rewritten by the next chunk
    }
}

}  // namespace

extern "C" {

// Source rows a block of the sweep.
int fpcr_nn_tc_rows_per_block(void) { return kRows; }

// Both functions take `batch` independent elements, at most
// 65,535: element e reads p + 3ne, q + 3me, q_mask + me and writes its own
// slices of every output below (batch 1 is the unbatched call).
//
// The candidate sweep of rows [0, n) over target slices of `slice_len`
// targets (a multiple of 128, at most 4096): part int32[batch, 3, slices,
// n] (per row the least value's bits, its 128-target tile, and the least
// value of every other tile) and part_c f32[batch, ceil(n / 128), 4] (each
// row block's centre), slices = ceil(m / slice_len). `part_c` holds 4
// floats more, the finish's counters, which the sweep clears. With a
// non-null `dump` (the guard check's instance) the sweep also writes d~ of
// targets [0, 64) to dump f32[batch, n, 64].
int fpcr_nn_tc_sweep(const float* p, const float* q, const uint8_t* q_mask,
                     int batch, int n, int m, int slice_len, int* part,
                     float* part_c, float* dump, void* stream) {
    if (slice_len % kTile != 0 || slice_len > kMaxSlice || batch < 1
        || batch > 65535) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 grid((n + kRows - 1) / kRows, (m + slice_len - 1) / slice_len,
                    batch);
    const auto s = static_cast<cudaStream_t>(stream);
    const auto c = reinterpret_cast<float4*>(part_c);
    const int smem = slice_len * static_cast<int>(sizeof(float4));
    int* const ctrl = reinterpret_cast<int*>(c + static_cast<size_t>(batch)
                                             * grid.x);
#define FPCR_TC_SWEEP(M)                                                      \
    cudaFuncSetAttribute(nn_tc_sweep_kernel<M>,                               \
                         cudaFuncAttributeMaxDynamicSharedMemorySize,         \
                         kMaxSlice * 16);                                     \
    nn_tc_sweep_kernel<M><<<grid, 128 * kGroups, smem, s>>>(                  \
        p, q, q_mask, n, m, slice_len, part, c, dump, ctrl)
    if (dump != nullptr) {
        FPCR_TC_SWEEP(kDump);
    } else {
        FPCR_TC_SWEEP(kSweep);
    }
#undef FPCR_TC_SWEEP
    return static_cast<int>(cudaGetLastError());
}

// The finish of K1 (`packed` 0) or K2 (`packed` 1, with idx_bits): out_d /
// out_i [batch, n] from the sweep's partials and centres (rows_per_block
// rows a centre, 128), in one launch of batch * ceil(n / 128) certify
// blocks and `rescue_blocks` rescue blocks; each rescued row adds 1 to
// *rescued. It writes its lists over `part`'s slice-0 values and their
// lengths over the centres' w, and counts in the words that the sweep
// cleared after the centres. batch * n must fit an int.
int fpcr_nn_tc_finish(const float* p, const float* q, const uint8_t* q_mask,
                      int* part, float* part_c, int rows_per_block,
                      int batch, int n, int m, int slices, int packed,
                      int idx_bits, int rescue_blocks, float* out_d,
                      int* out_i, unsigned long long* rescued, void* stream) {
    const long long lists =
        static_cast<long long>(batch) * ((n + kFinishRows - 1) / kFinishRows);
    if (batch < 1 || batch > 65535 || rescue_blocks < 1
        || rows_per_block != kFinishRows
        || static_cast<long long>(batch) * n > kIntMax
        || lists + rescue_blocks > kIntMax) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int grid = static_cast<int>(lists) + rescue_blocks;
    const auto s = static_cast<cudaStream_t>(stream);
    const auto c = reinterpret_cast<float4*>(part_c);
#define FPCR_TC_FINISH(P, B)                                                  \
    nn_tc_finish_kernel<P, B><<<grid, kFinishThreads, 0, s>>>(                \
        p, q, q_mask, part, c, rows_per_block, n, m, slices,                  \
        P ? idx_bits : 0, static_cast<int>(lists), out_d, out_i, rescued)
    if (packed) {
        if (batch > 1) FPCR_TC_FINISH(true, true);
        else FPCR_TC_FINISH(true, false);
    } else {
        if (batch > 1) FPCR_TC_FINISH(false, true);
        else FPCR_TC_FINISH(false, false);
    }
#undef FPCR_TC_FINISH
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
