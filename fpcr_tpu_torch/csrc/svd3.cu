// Kabsch rotation R = U·Vᵀ of a batch of 3x3 matrices for Hopper (sm_90a):
// kernel svd3, in two forms: the rotation (Kabsch) and Umeyama's.
//
// The port's own kernel, not a TPU kernel's counterpart: the JAX package
// computes this SVD in XLA (fpcr_tpu/ops/solve.py:84, jnp.linalg.svd). It
// replaces torch.linalg.svd in ops/solve.py::rotation_from_svd on the card,
// where the library call checks its status on the host and so makes every
// point-to-point ICP iteration wait for the card; this kernel reports
// nothing and lets a whole registration run as one captured CUDA graph.
//
// Function, for each matrix W (row-major, 9 floats) of the batch:
//   W = U Σ Vᵀ, σ1 >= σ2 >= σ3, R = U Vᵀ;
//   with det_correction the column of U of the smallest singular value is
//   multiplied by sign(det(U Vᵀ)), so det R = +1: then u3 = det(V)·(u1 × u2).
// Conventions (ops/solve.py::rotation_from_svd's plain version on the CPU):
// W = 0 gives the identity (U = V); a rank-1 or rank-2 W gives a rotation
// (det +1 with det_correction), its free columns completed deterministically;
// a non-finite entry gives a NaN R (JAX's convention; LAPACK raises).
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
// Design: one thread a matrix, a one-sided (Hestenes) Jacobi SVD in float64
// registers with a fixed number of sweeps. Each rotation makes two columns
// of A = W·V orthogonal; after the sweeps σj = |aj| and uj = aj / σj. float64
// costs nothing at this size and keeps the small singular value, which the
// det fix and the rank-2 case depend on, to ~1e-16 of σ1; R is rounded to
// float32 at the end. u2 and u3 are re-orthogonalised (Gram-Schmidt, cross
// product) so that R is orthogonal to float32 rounding whatever the rank.
//
// What bounds it on this card: launch latency. A matrix reads 36 bytes and
// writes 36; one thread does ~1,000 float64 operations. At the main path's
// batches (1 in run_icp, 32 in register_batch, 1,024 RANSAC hypotheses) the
// kernel is one block or a few, a few microseconds, all of it latency.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
// three rotations a sweep; one-sided Jacobi on a 3x3 converges
// quadratically, and 8 sweeps leave the columns orthogonal to float64
// rounding for any conditioning the float32 input can express
constexpr int kSweeps = 8;
// a singular value below this share of σ1 is taken as zero: its column of U
// is completed from the others rather than normalised from rounding noise
constexpr double kRankTol = 1e-13;

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

// one matrix b of the batch; kUmeyama: the Umeyama form, which also writes
// trace[b] (det_correction is then 1)
template <bool kUmeyama>
__device__ __forceinline__ void svd3_one(const float* __restrict__ w, int b,
                                         int det_correction,
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

    for (int sweep = 0; sweep < kSweeps; ++sweep) {
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

}  // namespace

extern "C" {

// w[batch, 3, 3] float32 row-major → out[batch, 3, 3] = U·Vᵀ, one thread a
// matrix; det_correction != 0 makes det out = +1.
int fpcr_svd3_rotation(const float* w, int batch, int det_correction,
                       float* out, void* stream) {
    if (batch <= 0) return 0;
    const int blocks = (batch + kThreads - 1) / kThreads;
    svd3_rotation_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        w, batch, det_correction, out);
    return static_cast<int>(cudaGetLastError());
}

// Umeyama's form: w[batch, 3, 3] → out[batch, 3, 3] = U·diag(1, 1, d)·Vᵀ
// and trace[batch] = σ1 + σ2 + d·σ3, d = sign(det U · det Vᵀ)
int fpcr_svd3_umeyama(const float* w, int batch, float* out, float* trace,
                      void* stream) {
    if (batch <= 0) return 0;
    const int blocks = (batch + kThreads - 1) / kThreads;
    svd3_umeyama_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        w, batch, out, trace);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
