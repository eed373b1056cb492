// Kabsch rotation R = U·Vᵀ of a batch of 3x3 matrices for Hopper (sm_90a):
// kernel svd3, in two forms: the rotation (Kabsch) and Umeyama's.
//
// The port's own kernel, not a TPU kernel's counterpart: the JAX package
// computes this SVD in XLA (fpcr_tpu/ops/solve.py:84 and :183,
// jnp.linalg.svd), not in a Pallas kernel. It replaces torch.linalg.svd in
// ops/solve.py::rotation_from_svd on the card, where the library call
// checks its status on the host and so makes every point-to-point ICP
// iteration wait for the card; this kernel reports nothing and lets a whole
// registration run as one captured CUDA graph.
//
// Function, for each matrix W (row-major, 9 floats) of the batch:
//   W = U Σ Vᵀ, σ1 >= σ2 >= σ3, R = U Vᵀ;
//   with det_correction the column of U of the smallest singular value is
//   multiplied by sign(det(U Vᵀ)), so det R = +1: then u3 = det(V)·(u1 × u2).
// Conventions (ops/solve.py::rotation_from_svd's plain version on the CPU):
// W = 0 gives the identity (U = V); a rank-1 or rank-2 W gives a rotation
// (det +1 with det_correction), its free columns completed deterministically;
// a non-finite entry gives a NaN R (JAX's convention; LAPACK raises).
// A singular value below kRankTol·σ1 is taken as zero.
//
// Umeyama's form (ops/solve.py::umeyama_from_svd, the similarity solve of
// scaled ICP; JAX: fpcr_tpu/ops/solve.py:183) returns, beside the
// det-corrected R above, the scale's numerator σ1 + σ2 + d·σ3 with
// d = sign(det U · det Vᵀ) of the SVD's own U, whose u3 = W v3 / σ3: d is
// the sign of u3_fixed · (W v3), 1 where σ3 is at the rank tolerance (there
// u3 is not defined and d·σ3 is rounding noise either way). Its R is the
// rotation form's with the det fix, U·diag(1, 1, d)·Vᵀ: both are the one
// rotation whose third column of U is signed for det +1. W = 0 gives the
// identity and 0; a non-finite W gives NaN for both.
//
// What bounds it on this card: latency. A matrix reads 36 bytes and writes
// 36, and at the main path's batches (1 in run_icp, 32 in register_batch,
// 1,024 RANSAC hypotheses) the kernel is one block or a few, so no other
// warp hides anything: its time is the launch's own, which an empty kernel
// floors, plus the latency of one thread's dependent chain of arithmetic.
// On sm_90 a float64 division or square root is not one instruction but a
// reciprocal seed, a Newton sequence of DFMAs and a slow-path check.
//
// Design: one thread a matrix, a one-sided (Hestenes) Jacobi SVD, cut to
// the chain that the input needs.
//   1. W is scaled by a power of two, its largest |entry| into [0.5, 1):
//      exact, and the float32 sums below neither overflow nor underflow.
//   2. float32 sweeps on copies of A = W and V = I. Each rotation takes two
//      reciprocal square roots (rsqrtf, the SFU's) and no division. A pair
//      already orthogonal to 2⁻²⁰ of its columns' norms is skipped, and
//      the sweeps end at the first sweep that rotates no pair.
//   3. A float64 polish: V re-orthonormalised (Gram-Schmidt, v3 = v1 × v2),
//      A = W·V recomputed from W in float64 (the float32 A is not carried),
//      and float64 sweeps of the same rotation, stopping at 2⁻⁵²: one to
//      three sweeps that rotate, where a Jacobi SVD from V = I takes four
//      or five. σ3, which the det fix, the rank-2 case and Umeyama's d
//      depend on, is kept to ~1e-16 of σ1, as the yardstick keeps it.
//   4. The completion normalises with one reciprocal square root a vector
//      (u1 = a1·rsqrt(|a1|²), u2 likewise), not three divisions; u2 and u3
//      are re-orthogonalised (Gram-Schmidt, cross product) so that R is
//      orthogonal to float32 rounding whatever the rank; R is rounded to
//      float32 at the end.
// The caps (8 sweeps in each stage) are guards; a warp runs to the slowest
// matrix of its 32.
//
// Kernel eig3, the symmetric eigendecomposition of the normals prepass and
// of NDT's voxel frames, is built at the end of this file on the same
// rotate and sweeps templates.
//
// The yardstick, on no path: the first design (fixed 8 sweeps in float64,
// 24 rotations of three divisions and two square roots each, whatever the
// input), svd3_fixed_*_kernel, reached only through
// ops/svd3_cuda.py::_svd3_rotation_fixed and _svd3_umeyama_fixed. An
// ablation of the new design's parts, which no longer ships, found float64
// sweeps from V = I under the same stop test within 4% of the whole
// design's time on this card (NVIDIA H100 80GB HBM3, 700 W).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
// the yardstick's fixed sweep count (three rotations a sweep; one-sided
// Jacobi on a 3x3 converges quadratically, and 8 sweeps leave the columns
// orthogonal to float64 rounding for any conditioning the float32 input can
// express); also the new design's cap on each stage's sweeps
constexpr int kSweeps = 8;
// a singular value below this share of σ1 is taken as zero: its column of U
// is completed from the others rather than normalised from rounding noise
constexpr double kRankTol = 1e-13;
// the new design's stop tests: a pair (α = |a_p|², β = |a_q|², γ = a_p·a_q)
// is skipped when γ² <= tol·α·β, |γ| <= ε·√(αβ) squared, with ε = 2⁻²⁰ in
// the float32 sweeps and 2⁻⁵² in the float64 polish
constexpr float kTol32 = 0x1p-40f;
constexpr double kTol64 = 0x1p-104;

// ---- the yardstick: the first design, 8 float64 sweeps ----


__device__ __forceinline__ void jacobi_pair(double (&a)[3][3],
                                            double (&v)[3][3], int p, int q) {
    double alpha = 0.0, beta = 0.0, gamma = 0.0;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
        alpha += a[r][p] * a[r][p];
        beta += a[r][q] * a[r][q];
        gamma += a[r][p] * a[r][q];
    }
    if (gamma == 0.0) return;
    // the smaller root of t² + 2ζt − 1 = 0, ζ = (β − α) / 2γ
    const double zeta = (beta - alpha) / (2.0 * gamma);
    const double t = copysign(1.0, zeta) / (fabs(zeta) + sqrt(1.0 + zeta * zeta));
    const double c = 1.0 / sqrt(1.0 + t * t);
    const double s = c * t;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
        double x = a[r][p], y = a[r][q];
        a[r][p] = c * x - s * y;
        a[r][q] = s * x + c * y;
        x = v[r][p];
        y = v[r][q];
        v[r][p] = c * x - s * y;
        v[r][q] = s * x + c * y;
    }
}

__device__ __forceinline__ void swap_cols(double (&a)[3][3], double (&v)[3][3],
                                          double (&sig)[3], int p, int q) {
    if (sig[p] >= sig[q]) return;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
        double x = a[r][p];
        a[r][p] = a[r][q];
        a[r][q] = x;
        x = v[r][p];
        v[r][p] = v[r][q];
        v[r][q] = x;
    }
    const double x = sig[p];
    sig[p] = sig[q];
    sig[q] = x;
}

__device__ __forceinline__ double dot3(const double* x, const double* y) {
    return x[0] * y[0] + x[1] * y[1] + x[2] * y[2];
}

// x − (u·x) u for a unit u, in place; returns the norm of the result
__device__ __forceinline__ double reject(double* x, const double* u) {
    const double d = dot3(u, x);
    x[0] -= d * u[0];
    x[1] -= d * u[1];
    x[2] -= d * u[2];
    return sqrt(dot3(x, x));
}

// the yardstick's matrix b; kUmeyama: the Umeyama form, which also writes
// trace[b] (det_correction is then 1)
template <bool kUmeyama>
__device__ __forceinline__ void svd3_fixed_one(const float* __restrict__ w,
                                               int b, int det_correction,
                                               float* __restrict__ out,
                                               float* __restrict__ trace) {
    const float* wb = w + 9 * static_cast<long long>(b);
    float* rb = out + 9 * static_cast<long long>(b);

    double a[3][3], v[3][3];
    bool finite = true;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            const float x = wb[3 * r + c];
            finite = finite && isfinite(x);
            a[r][c] = static_cast<double>(x);
            v[r][c] = r == c ? 1.0 : 0.0;
        }
    }
    if (!finite) {
#pragma unroll
        for (int k = 0; k < 9; ++k) rb[k] = __int_as_float(0x7fc00000);
        if (kUmeyama) trace[b] = __int_as_float(0x7fc00000);
        return;
    }

    for (int sweep = 0; sweep < kSweeps; ++sweep) {  // a fixed count
        jacobi_pair(a, v, 0, 1);
        jacobi_pair(a, v, 0, 2);
        jacobi_pair(a, v, 1, 2);
    }
    double sig[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
        sig[c] = sqrt(a[0][c] * a[0][c] + a[1][c] * a[1][c] +
                      a[2][c] * a[2][c]);
    // descending σ, the columns of A and V with them
    swap_cols(a, v, sig, 0, 1);
    swap_cols(a, v, sig, 1, 2);
    swap_cols(a, v, sig, 0, 1);

    // the columns of U and of V as rows: u[k] is the k-th left vector
    double u[3][3], vc[3][3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int r = 0; r < 3; ++r) vc[k][r] = v[r][k];
    const double det_v =
        vc[0][0] * (vc[1][1] * vc[2][2] - vc[1][2] * vc[2][1]) -
        vc[0][1] * (vc[1][0] * vc[2][2] - vc[1][2] * vc[2][0]) +
        vc[0][2] * (vc[1][0] * vc[2][1] - vc[1][1] * vc[2][0]);

    const double tol = kRankTol * sig[0];
    if (!(sig[0] > 0.0)) {  // W = 0: U = V, R = I
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
            for (int r = 0; r < 3; ++r) u[k][r] = vc[k][r];
    } else {
#pragma unroll
        for (int r = 0; r < 3; ++r) {
            u[0][r] = a[r][0] / sig[0];
            u[1][r] = a[r][1];
        }
        double n = reject(u[1], u[0]);
        if (!(n > tol)) {  // rank 1: u2 from v2, else from the least axis
#pragma unroll
            for (int r = 0; r < 3; ++r) u[1][r] = vc[1][r];
            n = reject(u[1], u[0]);
            if (!(n > 1e-3)) {
                const double ax = fabs(u[0][0]), ay = fabs(u[0][1]),
                             az = fabs(u[0][2]);
                const int k = (ax <= ay && ax <= az) ? 0 : (ay <= az ? 1 : 2);
                u[1][0] = k == 0 ? 1.0 : 0.0;
                u[1][1] = k == 1 ? 1.0 : 0.0;
                u[1][2] = k == 2 ? 1.0 : 0.0;
                n = reject(u[1], u[0]);
            }
        }
#pragma unroll
        for (int r = 0; r < 3; ++r) u[1][r] /= n;
        // u1 × u2, signed so that det U = det V: then det(U Vᵀ) = +1
        u[2][0] = det_v * (u[0][1] * u[1][2] - u[0][2] * u[1][1]);
        u[2][1] = det_v * (u[0][2] * u[1][0] - u[0][0] * u[1][2]);
        u[2][2] = det_v * (u[0][0] * u[1][1] - u[0][1] * u[1][0]);
        if (!det_correction && sig[2] > tol) {
            // the SVD's own u3 = W v3 / σ3, whose sign may give det −1
            const double s = u[2][0] * a[0][2] + u[2][1] * a[1][2] +
                             u[2][2] * a[2][2];
            if (s < 0.0) {
                u[2][0] = -u[2][0];
                u[2][1] = -u[2][1];
                u[2][2] = -u[2][2];
            }
        }
    }
    if (kUmeyama) {
        // d = det U · det Vᵀ of the SVD's own u3 = W v3 / σ3 = a3 / σ3: the
        // sign of u3_fixed · a3, since det [u1, u2, u3_fixed] = det V
        double d = 1.0;
        if (sig[0] > 0.0 && sig[2] > tol &&
            u[2][0] * a[0][2] + u[2][1] * a[1][2] + u[2][2] * a[2][2] < 0.0)
            d = -1.0;
        trace[b] = __double2float_rn(sig[0] + sig[1] + d * sig[2]);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
            rb[3 * i + j] = __double2float_rn(
                u[0][i] * vc[0][j] + u[1][i] * vc[1][j] + u[2][i] * vc[2][j]);
}


// ---- the new design ----

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }
__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }
__device__ __forceinline__ float copysign_t(float x, float y) {
    return copysignf(x, y);
}
__device__ __forceinline__ double copysign_t(double x, double y) {
    return copysign(x, y);
}

// 2^e as a double, for -1022 <= e <= 1023
__device__ __forceinline__ double pow2(int e) {
    return __longlong_as_double(static_cast<long long>(1023 + e) << 52);
}

// One rotation of the columns p, q of A, applied to V as well, unless the
// pair is orthogonal already: γ² <= tol·α·β (a zero column included).
// Returns whether it rotated. The angle: tan 2θ = 2γ / (β − α), |θ| <= π/4.
// From d = β − α, g = 2γ and ρ = 1/√(d² + g²): cos 2θ = |d|·ρ and
// sin 2θ = sign(d)·g·ρ, so c = cos θ = √((1 + cos 2θ) / 2) and s = sin θ
// = sin 2θ / (2c): two reciprocal square roots, no division. The tangent
// s/c is the yardstick's sign(ζ) / (|ζ| + √(1 + ζ²)), ζ = d / g, but ζ is
// never formed: on a nearly orthogonal pair (|ζ| > 1e19, where ζ² overflows
// float32) s ≈ g / (2|d|) = 1 / (2ζ), Rutishauser's large-ζ tangent, comes
// out of the same lines. Only s/c sets how orthogonal the new pair is.
template <typename T>
__device__ __forceinline__ bool rotate(T (&a)[3][3], T (&v)[3][3], int p,
                                       int q, T tol) {
    T alpha = 0, beta = 0, gamma = 0;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
        alpha += a[r][p] * a[r][p];
        beta += a[r][q] * a[r][q];
        gamma += a[r][p] * a[r][q];
    }
    if (!(gamma * gamma > tol * (alpha * beta))) return false;
    const T d = beta - alpha, g = gamma + gamma;
    const T rho = rsqrt_t(d * d + g * g);
    const T h = T(0.5) + T(0.5) * abs_t(d) * rho;  // cos²θ
    const T r = rsqrt_t(h);
    const T c = h * r;
    const T s = copysign_t(T(0.5), d) * g * rho * r;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        T x = a[k][p], y = a[k][q];
        a[k][p] = c * x - s * y;
        a[k][q] = s * x + c * y;
        x = v[k][p];
        y = v[k][q];
        v[k][p] = c * x - s * y;
        v[k][q] = s * x + c * y;
    }
    return true;
}

// sweeps of the three pairs until a sweep rotates none, at most kSweeps
template <typename T>
__device__ __forceinline__ void sweeps(T (&a)[3][3], T (&v)[3][3], T tol) {
#pragma unroll 1
    for (int n = 0; n < kSweeps; ++n) {
        const bool r01 = rotate(a, v, 0, 1, tol);
        const bool r02 = rotate(a, v, 0, 2, tol);
        const bool r12 = rotate(a, v, 1, 2, tol);
        if (!(r01 || r02 || r12)) break;
    }
}

// x − (u·x) u for a unit u, in place; returns |result|²
__device__ __forceinline__ double reject2(double* x, const double* u) {
    const double d = dot3(u, x);
    x[0] -= d * u[0];
    x[1] -= d * u[1];
    x[2] -= d * u[2];
    return dot3(x, x);
}

// √x by one reciprocal square root; 0 for x = 0
__device__ __forceinline__ double norm_of(double x) {
    return x > 0.0 ? x * rsqrt(x) : 0.0;
}

// one matrix b of the batch; kUmeyama: the Umeyama form, which also writes
// trace[b] (det_correction is then 1)
template <bool kUmeyama>
__device__ __forceinline__ void svd3_one(const float* __restrict__ w, int b,
                                         int det_correction,
                                         float* __restrict__ out,
                                         float* __restrict__ trace) {
    const float* wb = w + 9 * static_cast<long long>(b);
    float* rb = out + 9 * static_cast<long long>(b);

    float wf[3][3];
    float m = 0.0f;
    bool finite = true;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            wf[r][c] = wb[3 * r + c];
            finite = finite && isfinite(wf[r][c]);
            m = fmaxf(m, fabsf(wf[r][c]));
        }
    }
    if (!finite) {
#pragma unroll
        for (int k = 0; k < 9; ++k) rb[k] = __int_as_float(0x7fc00000);
        if (kUmeyama) trace[b] = __int_as_float(0x7fc00000);
        return;
    }
    // W·2^-e, its largest |entry| in [0.5, 1): exact in float64
    int e = 0;
    if (m > 0.0f) frexp(static_cast<double>(m), &e);
    const double scale = pow2(-e);
    double ws[3][3];
    float a32[3][3], v32[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            ws[r][c] = static_cast<double>(wf[r][c]) * scale;
            a32[r][c] = __double2float_rn(ws[r][c]);
            v32[r][c] = r == c ? 1.0f : 0.0f;
        }
    }
    sweeps(a32, v32, kTol32);

    // V in float64: v1, v2 by Gram-Schmidt, v3 = v1 × v2 (V32 is a product
    // of rotations, det V32 = Π(c² + s²) > 0, so det V = +1 keeps its sign)
    double v[3][3];
    {
        double x[3], y[3];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
            x[r] = v32[r][0];
            y[r] = v32[r][1];
        }
        const double rx = rsqrt(dot3(x, x));
#pragma unroll
        for (int r = 0; r < 3; ++r) x[r] *= rx;
        const double ry = rsqrt(reject2(y, x));
#pragma unroll
        for (int r = 0; r < 3; ++r) {
            v[r][0] = x[r];
            v[r][1] = y[r] * ry;
        }
        v[0][2] = v[1][0] * v[2][1] - v[2][0] * v[1][1];
        v[1][2] = v[2][0] * v[0][1] - v[0][0] * v[2][1];
        v[2][2] = v[0][0] * v[1][1] - v[1][0] * v[0][1];
    }
    // A = W·V in float64, from W
    double a[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c)
            a[r][c] = ws[r][0] * v[0][c] + ws[r][1] * v[1][c] +
                      ws[r][2] * v[2][c];
    sweeps(a, v, kTol64);

    // σj² = |aj|², descending, the columns of A and V with them
    double nrm[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
        nrm[c] = a[0][c] * a[0][c] + a[1][c] * a[1][c] + a[2][c] * a[2][c];
    swap_cols(a, v, nrm, 0, 1);
    swap_cols(a, v, nrm, 1, 2);
    swap_cols(a, v, nrm, 0, 1);

    // the columns of U and of V as rows: u[k] is the k-th left vector
    double u[3][3], vc[3][3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int r = 0; r < 3; ++r) vc[k][r] = v[r][k];
    const double det_v =
        vc[0][0] * (vc[1][1] * vc[2][2] - vc[1][2] * vc[2][1]) -
        vc[0][1] * (vc[1][0] * vc[2][2] - vc[1][2] * vc[2][0]) +
        vc[0][2] * (vc[1][0] * vc[2][1] - vc[1][1] * vc[2][0]);

    const double tol2 = kRankTol * kRankTol * nrm[0];
    if (!(nrm[0] > 0.0)) {  // W = 0: U = V, R = I
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
            for (int r = 0; r < 3; ++r) u[k][r] = vc[k][r];
    } else {
        const double r0 = rsqrt(nrm[0]);
#pragma unroll
        for (int r = 0; r < 3; ++r) {
            u[0][r] = a[r][0] * r0;
            u[1][r] = a[r][1];
        }
        double n2 = reject2(u[1], u[0]);
        if (!(n2 > tol2)) {  // rank 1: u2 from v2, else from the least axis
#pragma unroll
            for (int r = 0; r < 3; ++r) u[1][r] = vc[1][r];
            n2 = reject2(u[1], u[0]);
            if (!(n2 > 1e-6)) {
                const double ax = fabs(u[0][0]), ay = fabs(u[0][1]),
                             az = fabs(u[0][2]);
                const int k = (ax <= ay && ax <= az) ? 0 : (ay <= az ? 1 : 2);
                u[1][0] = k == 0 ? 1.0 : 0.0;
                u[1][1] = k == 1 ? 1.0 : 0.0;
                u[1][2] = k == 2 ? 1.0 : 0.0;
                n2 = reject2(u[1], u[0]);
            }
        }
        const double rn = rsqrt(n2);
#pragma unroll
        for (int r = 0; r < 3; ++r) u[1][r] *= rn;
        // u1 × u2, signed so that det U = det V: then det(U Vᵀ) = +1
        u[2][0] = det_v * (u[0][1] * u[1][2] - u[0][2] * u[1][1]);
        u[2][1] = det_v * (u[0][2] * u[1][0] - u[0][0] * u[1][2]);
        u[2][2] = det_v * (u[0][0] * u[1][1] - u[0][1] * u[1][0]);
        if (!det_correction && nrm[2] > tol2) {
            // the SVD's own u3 = W v3 / σ3, whose sign may give det −1
            const double s = u[2][0] * a[0][2] + u[2][1] * a[1][2] +
                             u[2][2] * a[2][2];
            if (s < 0.0) {
                u[2][0] = -u[2][0];
                u[2][1] = -u[2][1];
                u[2][2] = -u[2][2];
            }
        }
    }
    if (kUmeyama) {
        // d = det U · det Vᵀ of the SVD's own u3 = W v3 / σ3 = a3 / σ3: the
        // sign of u3_fixed · a3, since det [u1, u2, u3_fixed] = det V; the
        // singular values scaled back by 2^e
        double d = 1.0;
        if (nrm[0] > 0.0 && nrm[2] > tol2 &&
            u[2][0] * a[0][2] + u[2][1] * a[1][2] + u[2][2] * a[2][2] < 0.0)
            d = -1.0;
        trace[b] = __double2float_rn(
            (norm_of(nrm[0]) + norm_of(nrm[1]) + d * norm_of(nrm[2])) *
            pow2(e));
    }
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
            rb[3 * i + j] = __double2float_rn(
                u[0][i] * vc[0][j] + u[1][i] * vc[1][j] + u[2][i] * vc[2][j]);
}

// ---- kernel eig3: the symmetric eigendecomposition ----
//
// The port's own kernel, not a TPU kernel's counterpart: the JAX package
// takes the normals' and NDT's eigenvectors from a closed form
// (fpcr_tpu/ops/eigh3.py), arccos(det(B)/2) and cross products, whose error
// grows without bound where two eigenvalues meet: on a 16-beam LiDAR scan a
// point's nearest neighbours lie nearly on a line, and its two smallest
// eigenvalues nearly meet. The reference takes them from LAPACK's ssyev on
// the host; torch.linalg.eigh on the card checks its status on the host.
// This kernel reports nothing, so the normals prepass issues no host read.
//
// Function, for each symmetric A (row-major, 9 floats) of the batch:
//   A = V diag(λ) Vᵀ, λ0 <= λ1 <= λ2; vals = λ, and vecs = V with column j
//   the j-th eigenvector (torch.linalg.eigh's layout).
// Conventions (ops/eigh3.py::eig3_plain on the CPU): where |A − qI| <=
// kIsoTol·|A| (Frobenius norms in float64, q = tr A / 3: A ≈ qI, the zero
// matrix included; then λ2 − λ0 <= √2·|A − qI|) V is the fixed frame
// (1,1,1)/√3, (2,−1,−1)/√6, (0,1,−1)/√2, the JAX package's fallback normal
// completed to a right-handed frame, and λ is as computed; a non-finite
// entry gives NaN in every output.
//
// Design: svd3's one-sided Jacobi, whose right singular vectors of a
// symmetric A are its eigenvectors.
//   1. A is scaled by a power of two as svd3 scales W (exact).
//   2. float32 sweeps on A from V = I (svd3's sweeps, 2⁻²⁰ stop).
//   3. A float64 polish on B = A + s·I, s = the largest absolute row sum of
//      A (>= every |λ|): B is positive semidefinite and has A's
//      eigenvectors, so an eigenvalue pair λ, −λ of A, which one-sided
//      Jacobi on A cannot tell apart (A² has one eigenvalue there), is
//      resolved too. V is re-orthonormalised, B·V recomputed in float64 and
//      swept to 2⁻⁵², as svd3's polish does.
//   4. λj = vjᵀ A vj in float64, the sign included; λ and V sorted
//      ascending; rounded to float32 at the end.
// The smallest eigenvector then lies within a few float32 epsilons·λ2 /
// (λ1 − λ0) rad of float64's, the angle the float32 input itself leaves.
// What bounds it on this card: latency, as svd3 (one thread a matrix, 36
// bytes read and 48 written).

// A ≈ qI where |A − qI| <= kIsoTol·|A|: half a float32 epsilon, so that
// λ2 − λ0 <= 1.3 float32 epsilons·max |λ|, where the float32 input does
// not resolve the smallest eigenvector's direction; squared here
constexpr double kIsoTol2 = 0x1p-44;

__device__ __forceinline__ void eig3_one(const float* __restrict__ in, int b,
                                         float* __restrict__ vals,
                                         float* __restrict__ vecs) {
    const float* ab = in + 9 * static_cast<long long>(b);
    float* lb = vals + 3 * static_cast<long long>(b);
    float* vb = vecs + 9 * static_cast<long long>(b);

    float af[3][3];
    float m = 0.0f;
    bool finite = true;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            af[r][c] = ab[3 * r + c];
            finite = finite && isfinite(af[r][c]);
            m = fmaxf(m, fabsf(af[r][c]));
        }
    }
    if (!finite) {
#pragma unroll
        for (int k = 0; k < 3; ++k) lb[k] = __int_as_float(0x7fc00000);
#pragma unroll
        for (int k = 0; k < 9; ++k) vb[k] = __int_as_float(0x7fc00000);
        return;
    }
    // A·2^-e, its largest |entry| in [0.5, 1): exact in float64
    int e = 0;
    if (m > 0.0f) frexp(static_cast<double>(m), &e);
    const double scale = pow2(-e);
    double as[3][3];
    float a32[3][3], v32[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            as[r][c] = static_cast<double>(af[r][c]) * scale;
            a32[r][c] = __double2float_rn(as[r][c]);
            v32[r][c] = r == c ? 1.0f : 0.0f;
        }
    }
    // A ≈ qI, decided on the input, not on the computed eigenvalues
    bool iso;
    {
        const double q = (as[0][0] + as[1][1] + as[2][2]) / 3.0;
        double dev = 0.0, all = 0.0;
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                const double x = as[r][c] - (r == c ? q : 0.0);
                dev += x * x;
                all += as[r][c] * as[r][c];
            }
        iso = dev <= kIsoTol2 * all;
    }
    sweeps(a32, v32, kTol32);

    // V in float64: v1, v2 by Gram-Schmidt, v3 = v1 × v2
    double v[3][3];
    {
        double x[3], y[3];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
            x[r] = v32[r][0];
            y[r] = v32[r][1];
        }
        const double rx = rsqrt(dot3(x, x));
#pragma unroll
        for (int r = 0; r < 3; ++r) x[r] *= rx;
        const double ry = rsqrt(reject2(y, x));
#pragma unroll
        for (int r = 0; r < 3; ++r) {
            v[r][0] = x[r];
            v[r][1] = y[r] * ry;
        }
        v[0][2] = v[1][0] * v[2][1] - v[2][0] * v[1][1];
        v[1][2] = v[2][0] * v[0][1] - v[0][0] * v[2][1];
        v[2][2] = v[0][0] * v[1][1] - v[1][0] * v[0][1];
    }
    // the shift: the largest absolute row sum
    double s = 0.0;
#pragma unroll
    for (int r = 0; r < 3; ++r)
        s = fmax(s, fabs(as[r][0]) + fabs(as[r][1]) + fabs(as[r][2]));
    // B·V in float64, B = A + s·I, from A
    double a[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c)
            a[r][c] = as[r][0] * v[0][c] + as[r][1] * v[1][c] +
                      as[r][2] * v[2][c] + s * v[r][c];
    sweeps(a, v, kTol64);

    // λj = vjᵀ A vj, negated so that swap_cols' descending order is λ's
    // ascending one
    double neg[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        double q = 0.0;
#pragma unroll
        for (int r = 0; r < 3; ++r)
            q += v[r][j] * (as[r][0] * v[0][j] + as[r][1] * v[1][j] +
                            as[r][2] * v[2][j]);
        neg[j] = -q;
    }
    swap_cols(a, v, neg, 0, 1);
    swap_cols(a, v, neg, 1, 2);
    swap_cols(a, v, neg, 0, 1);

    if (iso) {  // A ≈ qI: the fixed frame
        const double f = 0.57735026918962576, g = 0.81649658092772603,
                     h = 0.40824829046386302, k = 0.70710678118654752;
        v[0][0] = f; v[0][1] = g;  v[0][2] = 0.0;
        v[1][0] = f; v[1][1] = -h; v[1][2] = k;
        v[2][0] = f; v[2][1] = -h; v[2][2] = -k;
    }
    const double back = pow2(e);
#pragma unroll
    for (int j = 0; j < 3; ++j) lb[j] = __double2float_rn(-neg[j] * back);
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c) vb[3 * r + c] = __double2float_rn(v[r][c]);
}

__global__ void __launch_bounds__(kThreads)
eig3_kernel(const float* __restrict__ in, int batch, float* __restrict__ vals,
            float* __restrict__ vecs) {
    const int b = blockIdx.x * kThreads + threadIdx.x;
    if (b < batch) eig3_one(in, b, vals, vecs);
}

__global__ void __launch_bounds__(kThreads)
svd3_rotation_kernel(const float* __restrict__ w, int batch,
                     int det_correction, float* __restrict__ out) {
    const int b = blockIdx.x * kThreads + threadIdx.x;
    if (b < batch) svd3_one<false>(w, b, det_correction, out, nullptr);
}

__global__ void __launch_bounds__(kThreads)
svd3_umeyama_kernel(const float* __restrict__ w, int batch,
                    float* __restrict__ out, float* __restrict__ trace) {
    const int b = blockIdx.x * kThreads + threadIdx.x;
    if (b < batch) svd3_one<true>(w, b, 1, out, trace);
}

__global__ void __launch_bounds__(kThreads)
svd3_fixed_rotation_kernel(const float* __restrict__ w, int batch,
                           int det_correction, float* __restrict__ out) {
    const int b = blockIdx.x * kThreads + threadIdx.x;
    if (b < batch) svd3_fixed_one<false>(w, b, det_correction, out, nullptr);
}

__global__ void __launch_bounds__(kThreads)
svd3_fixed_umeyama_kernel(const float* __restrict__ w, int batch,
                          float* __restrict__ out, float* __restrict__ trace) {
    const int b = blockIdx.x * kThreads + threadIdx.x;
    if (b < batch) svd3_fixed_one<true>(w, b, 1, out, trace);
}

int blocks_of(int batch) { return (batch + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// w[batch, 3, 3] float32 row-major → out[batch, 3, 3] = U·Vᵀ, one thread a
// matrix; det_correction != 0 makes det out = +1.
int fpcr_svd3_rotation(const float* w, int batch, int det_correction,
                       float* out, void* stream) {
    if (batch <= 0) return 0;
    svd3_rotation_kernel<<<blocks_of(batch), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        w, batch, det_correction, out);
    return static_cast<int>(cudaGetLastError());
}

// Umeyama's form: w[batch, 3, 3] → out[batch, 3, 3] = U·diag(1, 1, d)·Vᵀ
// and trace[batch] = σ1 + σ2 + d·σ3, d = sign(det U · det Vᵀ)
int fpcr_svd3_umeyama(const float* w, int batch, float* out, float* trace,
                      void* stream) {
    if (batch <= 0) return 0;
    svd3_umeyama_kernel<<<blocks_of(batch), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        w, batch, out, trace);
    return static_cast<int>(cudaGetLastError());
}

// the yardstick's two forms, the same functions by the first design
int fpcr_svd3_fixed_rotation(const float* w, int batch, int det_correction,
                             float* out, void* stream) {
    if (batch <= 0) return 0;
    svd3_fixed_rotation_kernel<<<blocks_of(batch), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        w, batch, det_correction, out);
    return static_cast<int>(cudaGetLastError());
}

int fpcr_svd3_fixed_umeyama(const float* w, int batch, float* out,
                            float* trace, void* stream) {
    if (batch <= 0) return 0;
    svd3_fixed_umeyama_kernel<<<blocks_of(batch), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        w, batch, out, trace);
    return static_cast<int>(cudaGetLastError());
}

// a[batch, 3, 3] symmetric float32 row-major → vals[batch, 3] ascending
// and vecs[batch, 3, 3] with column j the j-th eigenvector, one thread a
// matrix
int fpcr_eig3(const float* a, int batch, float* vals, float* vecs,
              void* stream) {
    if (batch <= 0) return 0;
    eig3_kernel<<<blocks_of(batch), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(a, batch, vals, vecs);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
