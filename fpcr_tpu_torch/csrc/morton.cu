// Morton band nearest-neighbour search for Hopper (sm_90a): kernel K3 and
// its packed mode K3p.
//
// Replaces the TPU kernel fpcr_tpu/ops/morton_pallas.py::morton_nn_pallas
// (kernel bodies _band_kernel_factory and _band_kernel_pipelined_factory,
// modes "highest", "packed6" and the pipe/seq schedules: K3; the
// packed_idx branch of _band_kernel_factory, mode "packed6_idx": K3p),
// together with the band bases that the JAX package computes outside its
// kernel and hands in by scalar prefetch (morton_pallas.py:415-420).
//
// The source rows are Morton-sorted; chunk c holds rows [c*chunk,
// (c+1)*chunk), and one block serves it. For every source row the kernel
// scans the `band` target rows [base, base + band) of the Morton-sorted
// table and returns the row of least squared distance
// fmaf(dz,dz, fmaf(dy,dy, fmaf(dx,dx, 0))): ties go to the first row, as
// jnp.argmin picks. Rows at or past *valid_count (masked targets, which the
// table sorts to the end) and rows past m (band padding) never win.
// Outputs: the matched point and, when `extra` is given, the matched extra
// (e.g. target normals in table order) -- both copied from the table row,
// so they equal it bit for bit -- the squared distance, and the index in
// table order, in [0, m-1].
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
// A batch of B clouds of equal n and m runs in one launch: element e on
// blockIdx.z, with its own rows of p, of the table (points, codes, extra,
// valid_count, lo, inv_extent) and of the outputs, so its band bases come
// from its own codes and its culling from its own boxes. Each element's
// outputs are bit for bit those of its own unbatched launch. The unbatched
// launch (B = 1) keeps its instance without the element offsets (kBatched
// false), as kernel K1's finish does.
//
// Convention for a row whose whole band holds no valid target (only when
// *valid_count is 0): distance +inf and index 0, with table row 0 as the
// matched point and extra. This is kernel K1's convention; the TPU kernel
// returns a ~1e30 surrogate distance and a band row there.
//
// What bounds it on this card: instruction issue over the (source, band
// row) pairs it evaluates. A pair costs 3 FADD, 3 FFMA, a compare and two
// selects (K3) or a LOP3 and an integer min (K3p), and half of a broadcast
// shared load; the function fixes that arithmetic (a biased or norm form
// moves near-ties, and a K = 3 product does not pay on the tensor cores), so
// the design evaluates fewer pairs and fewer launches, picks unchanged:
//   * the prologue: one warp of the block reads the chunk's probe row
//     min(c*chunk + chunk/2, n-1), quantizes it to its 30-bit Morton code
//     in ops/morton.py::morton_codes' operation order (sub, mul by
//     1/extent, mul by 1024, each rounded to nearest, then truncation with
//     saturation, as torch's CUDA cast, and a clamp to [0, 1023]), finds its
//     rank in codes_sorted by a 32-ary lower-bound search (every lane tests
//     one of 32 evenly spaced rows a round: 4 rounds at 1M rows), and sets
//     the base clip(rank - band/2, 0, round_up(m, 128)) & ~127
//     (ops/morton.py::band_bases). The wrapper makes one launch a call;
//   * each warp holds kPPT groups of 32 consecutive sorted source rows, one
//     row of each group a lane (coalesced loads and stores), so one
//     broadcast shared load of a band row feeds every group that scans it;
//   * the band is staged in shared memory as float4 (x, y, z, w) in tiles
//     of kTile rows, w = 0 for a valid row and +inf for a masked or padding
//     row, folded in as the first FMA's addend; the staging warp of each
//     32-row sub-tile reduces the box of its valid rows (none: empty);
//   * culling (kCull): a group first takes a bound from one seed sub-tile,
//     the one at its expected band row (rank - base) + (group middle -
//     chunk/2): its rows' minimum distance there, by FMNMX, with no pick
//     set (a pick there would let a later-scanned equal distance earlier in
//     the band lose its first-minimum place). It then scans the sub-tiles
//     in band order and skips sub-tile t when lb(t), the box gap of t and
//     the group's box in the same FMA chain, exceeds its bound: the largest
//     over its rows of min(seed minimum, best so far), one REDUX. Lane t
//     computes lb(t) once a tile, and one ballot turns the test into a
//     mask of the sub-tiles to scan; the bound falls only when the group
//     scans, so the mask is renewed only then, and the warp jumps to the
//     next set bit: a skipped sub-tile costs nothing. Masks and bounds are
//     warp-uniform: no divergence. A group that scans runs the unchanged
//     scan (the same FMAs, the strict '<', the same band row);
//   * margin: none. Each of sub, FMA and max is correctly rounded and
//     monotone, and |px - qx| >= the box gap exactly, so lb(t) computed
//     with the same operations is <= every distance the scan computes in t.
//     A skipped sub-tile thus holds only distances above a row's bound, a
//     distance that row reaches in the band, and never its first minimum.
//     K3p compares buckets: t is skipped only when bits(lb) & keep exceeds
//     the largest bucket of min(seed, best key), so every key in t exceeds
//     the row's least key whatever its row bits; an equal bucket is
//     scanned. Bit patterns of non-negative floats order as the floats, so
//     both kernels compare int bits (K3 with keep = ~0);
//   * the distance is the difference form with FMAs: no cancellation, never
//     negative, no clamp.
// Not carried over from the TPU kernel: the bf16x6 K-packing, the one-hot
// MXU extraction (a row is loaded by index here), the [8, M] lane-major
// tables and the VMEM ring schedules. Not used: the tensor cores (K = 3;
// an mma.sync pipeline floors at ~80 us on 268M pairs, Kernel S).
//
// C interface (loaded with ctypes). Pointers are device pointers; `stream`
// is a cudaStream_t. Each function launches one kernel, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxThreads = 256;  // threads per block at most
constexpr int kPPT = 2;           // 32-row source groups per warp
constexpr int kSub = 32;          // rows of a band sub-tile and of a group
constexpr int kTile = 1024;       // band rows staged in shared memory per step
constexpr int kSubTiles = kTile / kSub;
constexpr int kKeyInit = 0x7F7FFFFF;  // bits of the largest finite float
constexpr int kAlign = 128;           // band bases align down to this
constexpr int kBits = 10;             // Morton bits an axis
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int part1by2(int x) {
    x &= 0x3FF;
    x = (x | (x << 16)) & 0x030000FF;
    x = (x | (x << 8)) & 0x0300F00F;
    x = (x | (x << 4)) & 0x030C30C3;
    x = (x | (x << 2)) & 0x09249249;
    return x;
}

// clamp(int32(((x - lo) * inv) * 1024), 0, 1023), each float step rounded
// to nearest and the cast truncating with saturation (NaN -> 0)
__device__ __forceinline__ int quantize(float x, float lo, float inv) {
    const float u = __fmul_rn(__fmul_rn(__fsub_rn(x, lo), inv),
                              static_cast<float>(1 << kBits));
    return min(max(__float2int_rz(u), 0), (1 << kBits) - 1);
}

// The first i in [0, m] with codes[i] >= code (torch.searchsorted's
// default side). The warp narrows [lo, hi] 32-ary: lane j tests row
// lo + (j + 1) * step - 1, and the first lane that finds codes >= code (a
// row at or past hi counts as one) bounds the next interval.
__device__ int lower_bound_warp(const int* __restrict__ codes, int m,
                                int code, int lane) {
    int lo = 0, hi = m;  // codes[i] < code below lo, >= code from hi on
    while (lo < hi) {
        const int step = (hi - lo + 31) / 32;
        const int pos = lo + (lane + 1) * step - 1;
        const bool ge = pos >= hi || __ldg(codes + pos) >= code;
        const unsigned ballot = __ballot_sync(kFull, ge);
        if (ballot == 0) {
            lo = hi;
        } else {
            const int f = __ffs(ballot) - 1;
            hi = min(lo + (f + 1) * step - 1, hi);
            lo += f * step;
        }
    }
    return lo;
}

__device__ __forceinline__ float sqdist(float px, float py, float pz,
                                        const float4& t) {
    const float dx = px - t.x;
    const float dy = py - t.y;
    const float dz = pz - t.z;
    return fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, t.w)));
}

// Scan band rows [s0, s1) of the staged tile for the groups in kMask.
template <bool kPacked, int kMask>
__device__ __forceinline__ void scan_rows(
    const float4* tile, int s0, int s1, int t0, int keep,
    const float (&px)[kPPT], const float (&py)[kPPT],
    const float (&pz)[kPPT], float (&best_d)[kPPT], int (&best_s)[kPPT]) {
#pragma unroll 4
    for (int s = s0; s < s1; ++s) {
        const float4 t = tile[s];
#pragma unroll
        for (int k = 0; k < kPPT; ++k) {
            if ((kMask >> k) & 1) {
                const float d = sqdist(px[k], py[k], pz[k], t);
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
}

// scan_rows for the runtime group mask, one compiled scan per mask value
template <bool kPacked, int kMask = (1 << kPPT) - 1>
__device__ __forceinline__ void scan_groups(
    int mask, const float4* tile, int s0, int s1, int t0, int keep,
    const float (&px)[kPPT], const float (&py)[kPPT],
    const float (&pz)[kPPT], float (&best_d)[kPPT], int (&best_s)[kPPT]) {
    if (mask == kMask) {
        scan_rows<kPacked, kMask>(tile, s0, s1, t0, keep, px, py, pz, best_d,
                                  best_s);
    } else if constexpr (kMask > 1) {
        scan_groups<kPacked, kMask - 1>(mask, tile, s0, s1, t0, keep, px, py,
                                        pz, best_d, best_s);
    }
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        v = fminf(v, __shfl_xor_sync(kFull, v, o));
    }
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
    }
    return v;
}

// the gap between [alo, ahi] and [blo, bhi] on one axis, rounded as the
// scan's subtraction rounds: at most |a - b| as computed, for a, b inside
__device__ __forceinline__ float gap(float alo, float ahi, float blo,
                                     float bhi) {
    return fmaxf(0.0f, fmaxf(__fsub_rn(blo, ahi), __fsub_rn(alo, bhi)));
}

// The group's mask of sub-tiles to scan: lane t's bit is set when
// sub-tile t has valid rows and its lower bound's compared bits `lb` do
// not exceed the group's bound, the largest over its rows of min(seed,
// best so far) in the same bits (K3: the distance; K3p: the bucket).
template <bool kPacked>
__device__ __forceinline__ unsigned wanted(bool rows, int lb, float seed,
                                           float best_d, int best_s,
                                           int cmp_keep) {
    const int own = kPacked ? min(__float_as_int(seed), best_s)
                            : __float_as_int(fminf(seed, best_d));
    const int bound = __reduce_max_sync(kFull, own) & cmp_keep;
    return __ballot_sync(kFull, rows && lb <= bound);
}

// kPacked: K3p with keys of idx_bits index bits; else K3 (idx_bits unused).
// kCull: skip band sub-tiles that cannot hold a pick; else scan them all.
// kBatched: element blockIdx.z of a batch (every pointer offset to its
// rows); else the one element of an unbatched launch.
template <bool kPacked, bool kCull, bool kBatched>
__global__ void __launch_bounds__(kMaxThreads)
morton_band_kernel(const float* __restrict__ p, int n,
                   const float* __restrict__ q, int m,
                   const int* __restrict__ valid_count,
                   const float* __restrict__ extra,
                   const int* __restrict__ codes_sorted,
                   const float* __restrict__ lo,
                   const float* __restrict__ inv_extent, int chunk, int band,
                   int idx_bits, float* __restrict__ out_q,
                   float* __restrict__ out_d, int* __restrict__ out_i,
                   float* __restrict__ out_e, int* __restrict__ out_bases,
                   int* __restrict__ out_visits) {
    __shared__ float4 tile[kTile];
    __shared__ float4 box_lo[kSubTiles], box_hi[kSubTiles];
    __shared__ int s_base, s_rank, s_visits;

    if constexpr (kBatched) {  // element e's rows of every array
        const long long e = blockIdx.z;
        const long long chunks = gridDim.x;
        p += e * 3 * n;
        q += e * 3 * m;
        valid_count += e;
        if (extra != nullptr) extra += e * 3 * m;
        codes_sorted += e * m;
        lo += e * 3;
        inv_extent += e * 3;
        out_q += e * 3 * n;
        out_d += e * n;
        out_i += e * n;
        if (out_e != nullptr) out_e += e * 3 * n;
        if (out_bases != nullptr) out_bases += e * chunks;
        if (out_visits != nullptr) out_visits += e * chunks;
    }

    const int tid = static_cast<int>(threadIdx.x);
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int warps = static_cast<int>(blockDim.x) >> 5;
    const int chunk_id = static_cast<int>(blockIdx.x);
    const int valid_end = min(*valid_count, m);  // rows below it may win
    const int row_begin = chunk_id * chunk;
    const int row_end = min(n, row_begin + chunk);
    const int per_pass = kPPT * kSub * warps;
    const int keep = ~((1 << idx_bits) - 1);  // the distance bits K3p keeps
    const int cmp_keep = kPacked ? keep : ~0;  // the bits a cull compares

    if (warp == 0) {  // the prologue: probe code, rank, base
        const int row = min(row_begin + chunk / 2, n - 1);
        const int code =
            (part1by2(quantize(p[3 * row], lo[0], inv_extent[0])) << 2) |
            (part1by2(quantize(p[3 * row + 1], lo[1], inv_extent[1])) << 1) |
            part1by2(quantize(p[3 * row + 2], lo[2], inv_extent[2]));
        const int rank = lower_bound_warp(codes_sorted, m, code, lane);
        if (lane == 0) {
            const int top = (m + kAlign - 1) / kAlign * kAlign;
            const int base = min(max(rank - band / 2, 0), top) & ~(kAlign - 1);
            s_base = base;
            s_rank = rank;
            s_visits = 0;
            if (out_bases != nullptr) out_bases[chunk_id] = base;
        }
    }
    __syncthreads();
    const int base = s_base;
    // the expected band row of source row r is r + expect0
    const int expect0 = s_rank - base - chunk / 2 - row_begin;
    int visits = 0;  // (group, sub-tile) visits of this warp

    for (int r0 = row_begin; r0 < row_end; r0 += per_pass) {
        const int w0 = r0 + warp * kPPT * kSub;  // the warp's first row
        float px[kPPT], py[kPPT], pz[kPPT], best_d[kPPT], seed[kPPT];
        float glo_x[kPPT], glo_y[kPPT], glo_z[kPPT];
        float ghi_x[kPPT], ghi_y[kPPT], ghi_z[kPPT];
        int best_s[kPPT];  // K3: the band row, -1 for none; K3p: the key
        int active = 0;    // groups with a row in the chunk
#pragma unroll
        for (int k = 0; k < kPPT; ++k) {
            const int g = w0 + k * kSub;
            active |= (g < row_end) << k;
            // rows past the chunk load its last row and are never written
            const int i = min(g + lane, row_end - 1);
            px[k] = p[3 * i];
            py[k] = p[3 * i + 1];
            pz[k] = p[3 * i + 2];
            best_d[k] = CUDART_INF_F;
            best_s[k] = kPacked ? kKeyInit : -1;
            seed[k] = CUDART_INF_F;
            if constexpr (kCull) {  // the group's box
                glo_x[k] = warp_min(px[k]);
                glo_y[k] = warp_min(py[k]);
                glo_z[k] = warp_min(pz[k]);
                ghi_x[k] = warp_max(px[k]);
                ghi_y[k] = warp_max(py[k]);
                ghi_z[k] = warp_max(pz[k]);
            }
        }

        for (int t0 = 0; t0 < band; t0 += kTile) {
            const int count = min(kTile, band - t0);
            const int nsub = (count + kSub - 1) / kSub;
            __syncthreads();  // every thread is done with the previous tile
            // warp w stages sub-tiles w, w + warps, ..., a row a lane
            for (int st = warp; st < nsub; st += warps) {
                const int s = st * kSub + lane;
                const int g = base + t0 + s;
                const bool valid = s < count && g < valid_end;
                const float4 v =
                    valid ? make_float4(q[3 * g], q[3 * g + 1], q[3 * g + 2],
                                        0.0f)
                          : make_float4(0.0f, 0.0f, 0.0f, CUDART_INF_F);
                if (s < count) tile[s] = v;
                if constexpr (kCull) {  // the box of the valid rows
                    const float inf = CUDART_INF_F;
                    const float bx_lo = warp_min(valid ? v.x : inf);
                    const float by_lo = warp_min(valid ? v.y : inf);
                    const float bz_lo = warp_min(valid ? v.z : inf);
                    const float bx_hi = warp_max(valid ? v.x : -inf);
                    const float by_hi = warp_max(valid ? v.y : -inf);
                    const float bz_hi = warp_max(valid ? v.z : -inf);
                    if (lane == 0) {
                        box_lo[st] = make_float4(bx_lo, by_lo, bz_lo, 0.0f);
                        box_hi[st] = make_float4(bx_hi, by_hi, bz_hi, 0.0f);
                    }
                }
            }
            __syncthreads();

            if constexpr (kCull) {  // the seed: a bound, no pick
#pragma unroll
                for (int k = 0; k < kPPT; ++k) {
                    if ((active >> k) & 1) {
                        const int e = min(max(expect0 + w0 + k * kSub
                                                  + kSub / 2 - t0, 0),
                                          count - 1);
                        const int s0 = e / kSub * kSub;
                        const int s1 = min(s0 + kSub, count);
                        float mn = CUDART_INF_F;
                        for (int s = s0; s < s1; ++s) {
                            mn = fminf(mn, sqdist(px[k], py[k], pz[k],
                                                  tile[s]));
                        }
                        seed[k] = fminf(seed[k], mn);
                    }
                }
            }

            if constexpr (kCull) {
                // lane t: the lower bound of sub-tile t for each group; a
                // group's mask holds the sub-tiles whose bound does not
                // exceed the group's. The bound falls only when a group
                // scans, so its mask is renewed then, and a skipped
                // sub-tile costs nothing
                const bool has = lane < nsub;
                const float4 tl = box_lo[has ? lane : 0];
                const float4 th = box_hi[has ? lane : 0];
                const bool rows = has && tl.x <= th.x;  // valid rows in it
                int lb[kPPT];
                unsigned want[kPPT];
#pragma unroll
                for (int k = 0; k < kPPT; ++k) {
                    const float gx = gap(tl.x, th.x, glo_x[k], ghi_x[k]);
                    const float gy = gap(tl.y, th.y, glo_y[k], ghi_y[k]);
                    const float gz = gap(tl.z, th.z, glo_z[k], ghi_z[k]);
                    const float d =
                        fmaf(gz, gz, fmaf(gy, gy, fmaf(gx, gx, 0.0f)));
                    lb[k] = __float_as_int(d) & cmp_keep;
                    want[k] = ((active >> k) & 1)
                                  ? wanted<kPacked>(rows, lb[k], seed[k],
                                                    best_d[k], best_s[k],
                                                    cmp_keep)
                                  : 0u;
                }
                for (int st = 0; st < nsub; ++st) {
                    unsigned any = 0;
#pragma unroll
                    for (int k = 0; k < kPPT; ++k) any |= want[k];
                    any &= ~0u << st;
                    if (any == 0) break;
                    st = __ffs(any) - 1;
                    int visit = 0;
#pragma unroll
                    for (int k = 0; k < kPPT; ++k) {
                        visit |= ((want[k] >> st) & 1) << k;
                    }
                    visits += __popc(visit);
                    scan_groups<kPacked>(visit, tile, st * kSub,
                                         min(st * kSub + kSub, count), t0,
                                         keep, px, py, pz, best_d, best_s);
#pragma unroll
                    for (int k = 0; k < kPPT; ++k) {
                        if ((visit >> k) & 1) {
                            want[k] = wanted<kPacked>(rows, lb[k], seed[k],
                                                      best_d[k], best_s[k],
                                                      cmp_keep);
                        }
                    }
                }
            } else {
                for (int st = 0; st < nsub; ++st) {
                    visits += __popc(active);
                    scan_groups<kPacked>(active, tile, st * kSub,
                                         min(st * kSub + kSub, count), t0,
                                         keep, px, py, pz, best_d, best_s);
                }
            }
        }

#pragma unroll
        for (int k = 0; k < kPPT; ++k) {
            const int i = w0 + k * kSub + lane;
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

    if (out_visits != nullptr) {  // uniform over the block
        if (lane == 0) atomicAdd(&s_visits, visits);
        __syncthreads();
        if (tid == 0) out_visits[chunk_id] = s_visits;
    }
}

template <bool kPacked, bool kCull>
int launch(const float* p, int batch, int n, const float* q, int m,
           const int* valid_count, const float* extra,
           const int* codes_sorted, const float* lo, const float* inv_extent,
           int chunk, int band, int idx_bits, float* out_q, float* out_d,
           int* out_i, float* out_e, int* out_bases, int* out_visits,
           void* stream) {
    const int rows_per_warp = kPPT * kSub;
    const int want = (chunk + rows_per_warp - 1) / rows_per_warp * 32;
    const int threads = want < kMaxThreads ? want : kMaxThreads;
    const int num_chunks = (n + chunk - 1) / chunk;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (batch == 1) {
        morton_band_kernel<kPacked, kCull, false><<<num_chunks, threads, 0,
                                                    s>>>(
            p, n, q, m, valid_count, extra, codes_sorted, lo, inv_extent,
            chunk, band, idx_bits, out_q, out_d, out_i, out_e, out_bases,
            out_visits);
    } else {
        const dim3 grid(num_chunks, 1, batch);
        morton_band_kernel<kPacked, kCull, true><<<grid, threads, 0, s>>>(
            p, n, q, m, valid_count, extra, codes_sorted, lo, inv_extent,
            chunk, band, idx_bits, out_q, out_d, out_i, out_e, out_bases,
            out_visits);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define FPCR_MORTON_ARGS                                                    \
    const float *p, int batch, int n, const float *q, int m,               \
        const int *valid_count, const float *extra, const int *codes_sorted, \
        const float *lo, const float *inv_extent, int chunk, int band,       \
        int idx_bits, float *out_q, float *out_d, int *out_i, float *out_e,  \
        int *out_bases, int *out_visits, void *stream
#define FPCR_MORTON_PASS                                                   \
    p, batch, n, q, m, valid_count, extra, codes_sorted, lo, inv_extent,    \
        chunk, band, idx_bits, out_q, out_d, out_i, out_e, out_bases,       \
        out_visits, stream

// K3: band NN of the n source rows p[n,3], in ceil(n/chunk) chunks of
// `chunk` rows, against the Morton-sorted table q[m,3] (valid rows below
// *valid_count; codes_sorted[m], lo[3] and inv_extent[3] its codes and
// quantization), band `band` rows. `extra`/`out_e` may both be null; so may
// out_bases[chunks] (each chunk's band base) and out_visits[chunks] (each
// block's (group, sub-tile) visits). idx_bits is K3p's and unused here.
// Writes out_q[n,3], out_d[n], out_i[n] and out_e[n,3]. A batch of
// `batch` elements (1 <= batch <= 65535) stacks every array along a
// leading axis: p[batch,n,3], q[batch,m,3], valid_count[batch], ...,
// out_bases[batch,chunks]; batch 1 is the unbatched launch.
int fpcr_morton_nn(FPCR_MORTON_ARGS) {
    return launch<false, true>(FPCR_MORTON_PASS);
}

// K3p: as fpcr_morton_nn, by keys of idx_bits index bits (band <=
// 2^idx_bits, idx_bits <= 23).
int fpcr_morton_nn_packed(FPCR_MORTON_ARGS) {
    return launch<true, true>(FPCR_MORTON_PASS);
}

// K3 and K3p with culling compiled out: every sub-tile scanned. The same
// outputs bit for bit; kept to hold the culled kernels against.
int fpcr_morton_nn_unculled(FPCR_MORTON_ARGS) {
    return launch<false, false>(FPCR_MORTON_PASS);
}

int fpcr_morton_nn_packed_unculled(FPCR_MORTON_ARGS) {
    return launch<true, false>(FPCR_MORTON_PASS);
}

#undef FPCR_MORTON_ARGS
#undef FPCR_MORTON_PASS

}  // extern "C"
