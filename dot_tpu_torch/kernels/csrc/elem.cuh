// Per-element device math shared by the kernels of elem.cu: the batched
// 3x3 flip-SVD and the FCR / SNH / SNHWL materials of
// dot_tpu/kernels/soa.py, one element per thread, templated on float and
// double.
//
// Every expression keeps the operation order of dot_tpu_torch/kernels/soa.py
// (the plain PyTorch version): elem.cu is built with -fmad=false, so each
// product and sum rounds as the elementwise torch ops round. The fixed sweep
// counts (4 for float, 10 for double), the `small` test of _givens at the
// type's epsilon and the cswap order of _sort3_desc_soa decide the order of
// sigma and the signs of U and V, so they are kept exactly.
#pragma once

#include <cuda_runtime.h>

namespace dotk {

template <typename T> struct Num;
template <> struct Num<float> {
  static constexpr float eps = 1.1920928955078125e-07f;  // FLT_EPSILON
  static constexpr int sweeps = 4;
};
template <> struct Num<double> {
  static constexpr double eps = 2.220446049250313e-16;   // DBL_EPSILON
  static constexpr int sweeps = 10;
};

__device__ __forceinline__ float rsq(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsq(double x) { return rsqrt(x); }
__device__ __forceinline__ float lg(float x) { return logf(x); }
__device__ __forceinline__ double lg(double x) { return log(x); }

// torch.sign / torch.maximum semantics (maximum propagates NaN)
template <typename T> __device__ __forceinline__ T sgn(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : x);
}
template <typename T> __device__ __forceinline__ T mx(T a, T b) {
  return (a > b || a != a) ? a : b;
}
template <typename T> __device__ __forceinline__ T cl0(T a) {  // clamp(min=0)
  return a < T(0) ? T(0) : a;
}

// ---------------------------------------------------------------------------
// symmetric 3x3 Jacobi eigendecomposition
// ---------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ void givens(T app, T aqq, T apq, T& c_out, T& s_out) {
  const T eps = Num<T>::eps;
  const bool small = fabs(apq) <= eps * sqrt(fabs(app * aqq) + eps);
  const T tau = (aqq - app) / (T(2) * (small ? T(1) : apq));
  T t = sgn(tau) / (fabs(tau) + sqrt(T(1) + tau * tau));
  if (tau == T(0)) t = T(1);
  const T c = rsq(T(1) + t * t);
  const T s = t * c;
  c_out = small ? T(1) : c;
  s_out = small ? T(0) : s;
}

template <typename T>
__device__ __forceinline__ void rotcols(T V[9], int p, int q, T c, T s) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T vp = V[3 * i + p], vq = V[3 * i + q];
    V[3 * i + p] = c * vp - s * vq;
    V[3 * i + q] = s * vp + c * vq;
  }
}

// sym3 (a00, a01, a02, a11, a12, a22) -> unsorted eigenvalues w, V (det +1)
template <typename T>
__device__ void jacobi_eigh(const T a[6], T w[3], T V[9]) {
  T a00 = a[0], a01 = a[1], a02 = a[2], a11 = a[3], a12 = a[4], a22 = a[5];
#pragma unroll
  for (int k = 0; k < 9; ++k) V[k] = (k % 4 == 0) ? T(1) : T(0);
  for (int sw = 0; sw < Num<T>::sweeps; ++sw) {
    T c, s, n00, n11, n22, n01, n02, n12;
    // pair (0, 1)
    givens(a00, a11, a01, c, s);
    n00 = c * c * a00 - T(2) * s * c * a01 + s * s * a11;
    n11 = s * s * a00 + T(2) * s * c * a01 + c * c * a11;
    n01 = (c * c - s * s) * a01 + c * s * (a00 - a11);
    n02 = c * a02 - s * a12;
    n12 = s * a02 + c * a12;
    a00 = n00; a01 = n01; a02 = n02; a11 = n11; a12 = n12;
    rotcols(V, 0, 1, c, s);
    // pair (0, 2)
    givens(a00, a22, a02, c, s);
    n00 = c * c * a00 - T(2) * s * c * a02 + s * s * a22;
    n22 = s * s * a00 + T(2) * s * c * a02 + c * c * a22;
    n02 = (c * c - s * s) * a02 + c * s * (a00 - a22);
    n01 = c * a01 - s * a12;
    n12 = s * a01 + c * a12;
    a00 = n00; a01 = n01; a02 = n02; a12 = n12; a22 = n22;
    rotcols(V, 0, 2, c, s);
    // pair (1, 2)
    givens(a11, a22, a12, c, s);
    n11 = c * c * a11 - T(2) * s * c * a12 + s * s * a22;
    n22 = s * s * a11 + T(2) * s * c * a12 + c * c * a22;
    n12 = (c * c - s * s) * a12 + c * s * (a11 - a22);
    n01 = c * a01 - s * a02;
    n02 = s * a01 + c * a02;
    a01 = n01; a02 = n02; a11 = n11; a12 = n12; a22 = n22;
    rotcols(V, 1, 2, c, s);
  }
  w[0] = a00; w[1] = a11; w[2] = a22;
}

template <typename T>
__device__ __forceinline__ void cswap(T w[3], T V[9], int p, int q) {
  if (w[p] < w[q]) {
    const T t = w[p]; w[p] = w[q]; w[q] = t;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const T v = V[3 * i + p]; V[3 * i + p] = V[3 * i + q]; V[3 * i + q] = v;
    }
  }
}

template <typename T> __device__ __forceinline__ T det3(const T m[9]) {
  return m[0] * (m[4] * m[8] - m[5] * m[7])
       - m[1] * (m[3] * m[8] - m[5] * m[6])
       + m[2] * (m[3] * m[7] - m[4] * m[6]);
}

// ---------------------------------------------------------------------------
// flip-SVD: det U = det V = +1, s0 >= s1 >= |s2|, sign(s2) = sign(det F)
// ---------------------------------------------------------------------------
template <typename T>
__device__ void svd3_flip(const T f[9], T U[9], T s[3], T V[9]) {
  const T eps = Num<T>::eps;
  T amax = f[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) amax = mx(amax, T(fabs(f[k])));
  amax = mx(amax, T(fabs(f[0])));
  const T scale = amax > T(0) ? amax : T(1);
  T fn[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) fn[k] = f[k] / scale;

  T a[6];  // fn^T fn
  a[0] = fn[0] * fn[0] + fn[3] * fn[3] + fn[6] * fn[6];
  a[1] = fn[0] * fn[1] + fn[3] * fn[4] + fn[6] * fn[7];
  a[2] = fn[0] * fn[2] + fn[3] * fn[5] + fn[6] * fn[8];
  a[3] = fn[1] * fn[1] + fn[4] * fn[4] + fn[7] * fn[7];
  a[4] = fn[1] * fn[2] + fn[4] * fn[5] + fn[7] * fn[8];
  a[5] = fn[2] * fn[2] + fn[5] * fn[5] + fn[8] * fn[8];
  T w[3];
  jacobi_eigh(a, w, V);
  cswap(w, V, 0, 1);
  cswap(w, V, 0, 2);
  cswap(w, V, 1, 2);

  const T sg = sgn(det3(V));
  V[2] = V[2] * sg; V[5] = V[5] * sg; V[8] = V[8] * sg;

  T B[9];  // fn @ V, columns b_i = sigma_i u_i
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      B[3 * i + j] = fn[3 * i + 0] * V[0 + j] + fn[3 * i + 1] * V[3 + j]
                   + fn[3 * i + 2] * V[6 + j];
  const T b0[3] = {B[0], B[3], B[6]};
  const T b1[3] = {B[1], B[4], B[7]};
  const T b2[3] = {B[2], B[5], B[8]};
  const T tol = T(16) * eps;

  const T n0 = sqrt(b0[0] * b0[0] + b0[1] * b0[1] + b0[2] * b0[2]);
  const T inv0 = T(1) / mx(n0, tol);
  const bool ok0 = n0 > tol;
  T u0[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) u0[d] = ok0 ? b0[d] * inv0 : (d == 0 ? T(1) : T(0));

  const T d01 = u0[0] * b1[0] + u0[1] * b1[1] + u0[2] * b1[2];
  T b1o[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) b1o[d] = b1[d] - d01 * u0[d];
  const T n1 = sqrt(b1o[0] * b1o[0] + b1o[1] * b1o[1] + b1o[2] * b1o[2]);
  const bool ok1 = n1 > tol * mx(n0, T(1));
  const T inv1 = T(1) / mx(n1, tol);
  // fallback: unit vector orthogonal to u0 — cross with the axis least
  // aligned with u0
  const T au0 = fabs(u0[0]), au1 = fabs(u0[1]), au2 = fabs(u0[2]);
  const int m = (au0 < au1) ? ((au0 < au2) ? 0 : 2) : ((au1 < au2) ? 1 : 2);
  const T e0 = m == 0 ? T(1) : T(0), e1 = m == 1 ? T(1) : T(0),
          e2 = m == 2 ? T(1) : T(0);
  const T fb[3] = {u0[1] * e2 - u0[2] * e1, u0[2] * e0 - u0[0] * e2,
                   u0[0] * e1 - u0[1] * e0};
  const T nf = sqrt(fb[0] * fb[0] + fb[1] * fb[1] + fb[2] * fb[2]);
  const T invf = T(1) / mx(nf, tol);
  T u1[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) u1[d] = ok1 ? b1o[d] * inv1 : fb[d] * invf;
  const T u2[3] = {u0[1] * u1[2] - u0[2] * u1[1], u0[2] * u1[0] - u0[0] * u1[2],
                   u0[0] * u1[1] - u0[1] * u1[0]};

  U[0] = u0[0]; U[1] = u1[0]; U[2] = u2[0];
  U[3] = u0[1]; U[4] = u1[1]; U[5] = u2[1];
  U[6] = u0[2]; U[7] = u1[2]; U[8] = u2[2];
  s[0] = n0 * scale;
  s[1] = (u1[0] * b1[0] + u1[1] * b1[1] + u1[2] * b1[2]) * scale;
  s[2] = (u2[0] * b2[0] + u2[1] * b2[1] + u2[2] * b2[2]) * scale;
}

template <typename T> __device__ __forceinline__ void cofactor(const T f[9], T k[9]) {
  // columns of the cofactor matrix = cross products of F's columns
  const T c0[3] = {f[0], f[3], f[6]}, c1[3] = {f[1], f[4], f[7]},
          c2[3] = {f[2], f[5], f[8]};
  k[0] = c1[1] * c2[2] - c1[2] * c2[1];
  k[3] = c1[2] * c2[0] - c1[0] * c2[2];
  k[6] = c1[0] * c2[1] - c1[1] * c2[0];
  k[1] = c2[1] * c0[2] - c2[2] * c0[1];
  k[4] = c2[2] * c0[0] - c2[0] * c0[2];
  k[7] = c2[0] * c0[1] - c2[1] * c0[0];
  k[2] = c0[1] * c1[2] - c0[2] * c1[1];
  k[5] = c0[2] * c1[0] - c0[0] * c1[2];
  k[8] = c0[0] * c1[1] - c0[1] * c1[0];
}

// ---------------------------------------------------------------------------
// materials (sigma-space primitives + first Piola)
// ---------------------------------------------------------------------------
enum { FCR = 0, SNH = 1, SNHWL = 2 };

template <typename T, int M> struct Mat;

template <typename T> struct Mat<T, FCR> {
  __device__ static T psi(const T s[3], T u, T lam) {
    const T sq = (s[0] - T(1)) * (s[0] - T(1)) + (s[1] - T(1)) * (s[1] - T(1))
               + (s[2] - T(1)) * (s[2] - T(1));
    const T jm1 = s[0] * s[1] * s[2] - T(1);
    return u * sq + T(0.5) * lam * jm1 * jm1;
  }
  __device__ static void dpsi(const T s[3], T u, T lam, T d[3]) {
    const T t = lam * (s[0] * s[1] * s[2] - T(1));
    d[0] = T(2) * u * (s[0] - T(1)) + s[1] * s[2] * t;
    d[1] = T(2) * u * (s[1] - T(1)) + s[2] * s[0] * t;
    d[2] = T(2) * u * (s[2] - T(1)) + s[0] * s[1] * t;
  }
  __device__ static void d2psi(const T s[3], T u, T lam, T a[6]) {
    const T sp0 = s[1] * s[2], sp1 = s[2] * s[0], sp2 = s[0] * s[1];
    const T pm1 = s[0] * s[1] * s[2] - T(1);
    a[0] = T(2) * u + lam * sp0 * sp0;
    a[1] = lam * (s[2] * pm1 + sp0 * sp1);
    a[2] = lam * (s[1] * pm1 + sp0 * sp2);
    a[3] = T(2) * u + lam * sp1 * sp1;
    a[4] = lam * (s[0] * pm1 + sp2 * sp1);
    a[5] = T(2) * u + lam * sp2 * sp2;
  }
  __device__ static void b_left(const T s[3], T u, T lam, T b[3]) {
    const T pm1 = s[0] * s[1] * s[2] - T(1);
    const T hl = T(0.5) * lam;
    b[0] = u - hl * s[2] * pm1;
    b[1] = u - hl * s[0] * pm1;
    b[2] = u - hl * s[1] * pm1;
  }
  __device__ static void first_piola(const T f[9], const T U[9], const T s[3],
                                     const T V[9], T u, T lam, T P[9]) {
    T cof[9];
    cofactor(f, cof);
    const T jm1 = s[0] * s[1] * s[2] - T(1);
    const T t = lam * jm1;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const T R = U[3 * i] * V[3 * j] + U[3 * i + 1] * V[3 * j + 1]
                  + U[3 * i + 2] * V[3 * j + 2];
        P[3 * i + j] = T(2) * u * (f[3 * i + j] - R) + t * cof[3 * i + j];
      }
  }
};

template <typename T> struct Mat<T, SNH> {
  __device__ static T psi(const T s[3], T u, T lam) {
    const T jma = s[0] * s[1] * s[2] - (T(1) + u / lam);
    return T(0.5) * (u * (s[0] * s[0] + s[1] * s[1] + s[2] * s[2] - T(3))
                     + lam * jma * jma);
  }
  __device__ static void dpsi(const T s[3], T u, T lam, T d[3]) {
    const T t = lam * (s[0] * s[1] * s[2] - (T(1) + u / lam));
    d[0] = u * s[0] + s[1] * s[2] * t;
    d[1] = u * s[1] + s[2] * s[0] * t;
    d[2] = u * s[2] + s[0] * s[1] * t;
  }
  __device__ static void d2psi(const T s[3], T u, T lam, T a[6]) {
    const T sp0 = s[1] * s[2], sp1 = s[2] * s[0], sp2 = s[0] * s[1];
    const T l2 = lam * (T(2) * s[0] * s[1] * s[2] - (T(1) + u / lam));
    a[0] = u + lam * sp0 * sp0;
    a[1] = s[2] * l2;
    a[2] = s[1] * l2;
    a[3] = u + lam * sp1 * sp1;
    a[4] = s[0] * l2;
    a[5] = u + lam * sp2 * sp2;
  }
  __device__ static void b_left(const T s[3], T u, T lam, T b[3]) {
    const T t = lam * (s[0] * s[1] * s[2] - (T(1) + u / lam));
    b[0] = T(0.5) * (u - t * s[2]);
    b[1] = T(0.5) * (u - t * s[0]);
    b[2] = T(0.5) * (u - t * s[1]);
  }
  __device__ static void first_piola(const T f[9], const T U[9], const T s[3],
                                     const T V[9], T u, T lam, T P[9]) {
    T cof[9];
    cofactor(f, cof);
    const T jma = s[0] * s[1] * s[2] - (T(1) + u / lam);
    const T t = lam * jma;
#pragma unroll
    for (int k = 0; k < 9; ++k) P[k] = u * f[k] + t * cof[k];
  }
};

template <typename T> struct Mat<T, SNHWL> {
  __device__ static void parts(const T s[3], T u, T lam, T& s_sq1, T& t1, T& jma) {
    s_sq1 = s[0] * s[0] + s[1] * s[1] + s[2] * s[2] + T(1);
    t1 = u * (T(1) - T(1) / s_sq1);
    jma = s[0] * s[1] * s[2] - (T(1) + T(0.75) * u / lam);
  }
  __device__ static T psi(const T s[3], T u, T lam) {
    T s_sq1, t1, jma;
    parts(s, u, lam, s_sq1, t1, jma);
    return T(0.5) * (u * (s_sq1 - T(4) - lg(s_sq1)) + lam * jma * jma);
  }
  __device__ static void dpsi(const T s[3], T u, T lam, T d[3]) {
    T s_sq1, t1, jma;
    parts(s, u, lam, s_sq1, t1, jma);
    const T t0 = lam * jma;
    d[0] = s[0] * t1 + s[1] * s[2] * t0;
    d[1] = s[1] * t1 + s[2] * s[0] * t0;
    d[2] = s[2] * t1 + s[0] * s[1] * t0;
  }
  __device__ static void d2psi(const T s[3], T u, T lam, T a[6]) {
    T s_sq1, t1, jma;
    parts(s, u, lam, s_sq1, t1, jma);
    const T cv = T(2) * u / (s_sq1 * s_sq1);
    const T sp0 = s[1] * s[2], sp1 = s[2] * s[0], sp2 = s[0] * s[1];
    const T l2 = lam * (s[0] * s[1] * s[2] + jma);
    a[0] = t1 + cv * s[0] * s[0] + lam * sp0 * sp0;
    a[1] = cv * s[0] * s[1] + s[2] * l2;
    a[2] = cv * s[0] * s[2] + s[1] * l2;
    a[3] = t1 + cv * s[1] * s[1] + lam * sp1 * sp1;
    a[4] = cv * s[1] * s[2] + s[0] * l2;
    a[5] = t1 + cv * s[2] * s[2] + lam * sp2 * sp2;
  }
  __device__ static void b_left(const T s[3], T u, T lam, T b[3]) {
    T s_sq1, t1, jma;
    parts(s, u, lam, s_sq1, t1, jma);
    const T t0 = lam * jma;
    b[0] = T(0.5) * (t1 - t0 * s[2]);
    b[1] = T(0.5) * (t1 - t0 * s[0]);
    b[2] = T(0.5) * (t1 - t0 * s[1]);
  }
  __device__ static void first_piola(const T f[9], const T U[9], const T s[3],
                                     const T V[9], T u, T lam, T P[9]) {
    T s_sq1, t1, jma, cof[9];
    parts(s, u, lam, s_sq1, t1, jma);
    cofactor(f, cof);
    const T t0 = lam * jma;
#pragma unroll
    for (int k = 0; k < 9; ++k) P[k] = t1 * f[k] + t0 * cof[k];
  }
};

}  // namespace dotk
