// Per-element device math of the 2D (triangle) kernels of elem2d.cu: the
// closed-form 2x2 flip-SVD, the 2x2 symmetric eigendecomposition, the SPD
// projection of a packed sym2 and the FCR / SNH / SNHWL materials at dim 2
// of dot_tpu/kernels/soa2d.py (svd2_flip_soa :41, eigh2_soa :71,
// make_pd2_soa :85, FCR2D :101, SNH2D :141, SNHWL2D :178), one element per
// thread, templated on float and double.
//
// Every expression keeps the operation order of
// dot_tpu_torch/kernels/soa2d.py (the plain PyTorch version), and elem2d.cu
// is built with -fmad=false, so products and sums round as the elementwise
// torch ops round. atan2, sin and cos of the device library are not
// bit-equal to torch's, so the 2D kernels agree with their plain versions
// to a few ulp of the angle (f64 1e-10, f32 1e-5), not bit for bit as the
// 3D ones do. Where R = 0 (F a scaled rotation) atan2(0, 0) = 0 picks the
// angles, as in the plain version; U and V alone are then not unique, the
// products built from them are.
#pragma once

#include <cuda_runtime.h>

namespace dotk2 {

__device__ __forceinline__ float at2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double at2(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ void sc(float a, float& s, float& c) { sincosf(a, &s, &c); }
__device__ __forceinline__ void sc(double a, double& s, double& c) { sincos(a, &s, &c); }
__device__ __forceinline__ float lg(float x) { return logf(x); }
__device__ __forceinline__ double lg(double x) { return log(x); }

// torch.clamp(min=0): NaN stays NaN
template <typename T> __device__ __forceinline__ T cl0(T a) {
  return a < T(0) ? T(0) : a;
}

// F = U diag(s) V^T, det U = det V = +1, s0 >= |s1|, sign(s1) = sign(det F).
// mat2 layout (m00, m01, m10, m11).
template <typename T>
__device__ __forceinline__ void svd2_flip(const T f[4], T U[4], T s[2], T V[4]) {
  const T E = T(0.5) * (f[0] + f[3]);
  const T Fm = T(0.5) * (f[0] - f[3]);
  const T G = T(0.5) * (f[2] + f[1]);
  const T H = T(0.5) * (f[2] - f[1]);
  const T Q = sqrt(E * E + H * H);
  const T R = sqrt(Fm * Fm + G * G);
  s[0] = Q + R;
  s[1] = Q - R;
  const T a1 = at2(G, Fm);
  const T a2 = at2(H, E);
  const T gam = T(0.5) * (a2 + a1);   // U angle
  const T bet = T(0.5) * (a2 - a1);   // V^T angle: V = Rot(-bet)
  T cu, su, cv, sv;
  sc(gam, su, cu);
  sc(bet, sv, cv);
  U[0] = cu; U[1] = -su; U[2] = su; U[3] = cu;
  V[0] = cv; V[1] = sv; V[2] = -sv; V[3] = cv;
}

// [[a, b], [b, c]]: lam0 >= lam1, Q's columns the eigenvectors
template <typename T>
__device__ __forceinline__ void eigh2(T a, T b, T c, T lam[2], T Q[4]) {
  const T mean = T(0.5) * (a + c);
  const T half = T(0.5) * (a - c);
  const T r = sqrt(half * half + b * b);
  const T th = T(0.5) * at2(T(2) * b, a - c);
  T ct, st;
  sc(th, st, ct);
  lam[0] = mean + r;
  lam[1] = mean - r;
  Q[0] = ct; Q[1] = -st; Q[2] = st; Q[3] = ct;
}

// packed sym2 (h00, h01, h11) with its eigenvalues clamped at 0
template <typename T>
__device__ __forceinline__ void make_pd2(const T h[3], T out[3]) {
  T lam[2], Q[4];
  eigh2(h[0], h[1], h[2], lam, Q);
  const T l0 = cl0(lam[0]), l1 = cl0(lam[1]);
  out[0] = l0 * Q[0] * Q[0] + l1 * Q[1] * Q[1];
  out[1] = l0 * Q[0] * Q[2] + l1 * Q[1] * Q[3];
  out[2] = l0 * Q[2] * Q[2] + l1 * Q[3] * Q[3];
}

template <typename T>
__device__ __forceinline__ void cofactor2(const T f[4], T k[4]) {
  k[0] = f[3]; k[1] = -f[2]; k[2] = -f[1]; k[3] = f[0];
}

// ---------------------------------------------------------------------------
// materials (sigma-space primitives + first Piola), dim 2
// ---------------------------------------------------------------------------
enum { FCR = 0, SNH = 1, SNHWL = 2 };

template <typename T, int M> struct Mat2;

template <typename T> struct Mat2<T, FCR> {
  __device__ static T psi(const T s[2], T u, T lam) {
    const T jm1 = s[0] * s[1] - T(1);
    return u * ((s[0] - T(1)) * (s[0] - T(1)) + (s[1] - T(1)) * (s[1] - T(1)))
         + T(0.5) * lam * jm1 * jm1;
  }
  __device__ static void dpsi(const T s[2], T u, T lam, T d[2]) {
    const T t = lam * (s[0] * s[1] - T(1));
    d[0] = T(2) * u * (s[0] - T(1)) + s[1] * t;
    d[1] = T(2) * u * (s[1] - T(1)) + s[0] * t;
  }
  __device__ static void d2psi(const T s[2], T u, T lam, T h[3]) {
    h[0] = T(2) * u + lam * s[1] * s[1];
    h[1] = lam * (T(2) * s[0] * s[1] - T(1));
    h[2] = T(2) * u + lam * s[0] * s[0];
  }
  __device__ static T b_left(const T s[2], T u, T lam) {
    return u - T(0.5) * lam * (s[0] * s[1] - T(1));
  }
  __device__ static void first_piola(const T f[4], const T U[4], const T s[2],
                                     const T V[4], T u, T lam, T P[4]) {
    T cof[4];
    cofactor2(f, cof);
    const T t = lam * (s[0] * s[1] - T(1));
    const T R[4] = {U[0] * V[0] + U[1] * V[1], U[0] * V[2] + U[1] * V[3],
                    U[2] * V[0] + U[3] * V[1], U[2] * V[2] + U[3] * V[3]};
#pragma unroll
    for (int k = 0; k < 4; ++k) P[k] = T(2) * u * (f[k] - R[k]) + t * cof[k];
  }
};

template <typename T> struct Mat2<T, SNH> {
  __device__ static T psi(const T s[2], T u, T lam) {
    const T jma = s[0] * s[1] - (T(1) + u / lam);
    return T(0.5) * (u * (s[0] * s[0] + s[1] * s[1] - T(2)) + lam * jma * jma);
  }
  __device__ static void dpsi(const T s[2], T u, T lam, T d[2]) {
    const T t = lam * (s[0] * s[1] - (T(1) + u / lam));
    d[0] = u * s[0] + s[1] * t;
    d[1] = u * s[1] + s[0] * t;
  }
  __device__ static void d2psi(const T s[2], T u, T lam, T h[3]) {
    h[0] = u + lam * s[1] * s[1];
    h[1] = lam * (T(2) * s[0] * s[1] - (T(1) + u / lam));
    h[2] = u + lam * s[0] * s[0];
  }
  __device__ static T b_left(const T s[2], T u, T lam) {
    return T(0.5) * (u - lam * (s[0] * s[1] - (T(1) + u / lam)));
  }
  __device__ static void first_piola(const T f[4], const T U[4], const T s[2],
                                     const T V[4], T u, T lam, T P[4]) {
    T cof[4];
    cofactor2(f, cof);
    const T t = lam * (s[0] * s[1] - (T(1) + u / lam));
#pragma unroll
    for (int k = 0; k < 4; ++k) P[k] = u * f[k] + t * cof[k];
  }
};

template <typename T> struct Mat2<T, SNHWL> {
  __device__ static void parts(const T s[2], T u, T lam, T& s_sq1, T& t1, T& jma) {
    s_sq1 = s[0] * s[0] + s[1] * s[1] + T(1);
    t1 = u * (T(1) - T(1) / s_sq1);
    jma = s[0] * s[1] - (T(1) + T(0.75) * u / lam);
  }
  __device__ static T psi(const T s[2], T u, T lam) {
    T s_sq1, t1, jma;
    parts(s, u, lam, s_sq1, t1, jma);
    return T(0.5) * (u * (s_sq1 - T(3) - lg(s_sq1)) + lam * jma * jma);
  }
  __device__ static void dpsi(const T s[2], T u, T lam, T d[2]) {
    T s_sq1, t1, jma;
    parts(s, u, lam, s_sq1, t1, jma);
    const T t0 = lam * jma;
    d[0] = s[0] * t1 + s[1] * t0;
    d[1] = s[1] * t1 + s[0] * t0;
  }
  __device__ static void d2psi(const T s[2], T u, T lam, T h[3]) {
    T s_sq1, t1, jma;
    parts(s, u, lam, s_sq1, t1, jma);
    const T cv = T(2) * u / (s_sq1 * s_sq1);
    h[0] = t1 + cv * s[0] * s[0] + lam * s[1] * s[1];
    h[1] = cv * s[0] * s[1] + lam * (s[0] * s[1] + jma);
    h[2] = t1 + cv * s[1] * s[1] + lam * s[0] * s[0];
  }
  __device__ static T b_left(const T s[2], T u, T lam) {
    T s_sq1, t1, jma;
    parts(s, u, lam, s_sq1, t1, jma);
    return T(0.5) * (t1 - lam * jma);
  }
  __device__ static void first_piola(const T f[4], const T U[4], const T s[2],
                                     const T V[4], T u, T lam, T P[4]) {
    T s_sq1, t1, jma, cof[4];
    parts(s, u, lam, s_sq1, t1, jma);
    cofactor2(f, cof);
    const T t0 = lam * jma;
#pragma unroll
    for (int k = 0; k < 4; ++k) P[k] = t1 * f[k] + t0 * cof[k];
  }
};

}  // namespace dotk2
