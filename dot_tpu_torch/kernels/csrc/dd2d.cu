// K25-K28: the kernels of the 2D decomposed path (DOT, GSDD, LBFGS-PD / H /
// HI / JH at dim 2), with a plain C interface (loaded through ctypes by
// ops.py). The plain PyTorch versions are in kernels/dd2d.py.
//
// Layouts: x, p: (nV, 3) with z = 0; corner ids (3, N) int32; restTriInv
// (4, N); the element Hessians (36, N) row-major over the (corner, xy) dofs
// (K23's order: row r*6 + c holds H[r][c]); the subdomain matrices
// (P, n, n) row-major, slot p*n*n + r*n + c; d (P, n).
//
// K25 quadratic_form2d -- replaces System2D.quadratic_form with its corner
//   gather and defgrad_from_corners (dot_tpu/dim2.py:520-530, 557-565),
//   the DOT alpha-init's p^T H p + sum m |p|^2 and F(p). Bound: bytes, the
//   36 Hessian values per triangle (2.9 MB in f32 at 20K triangles): a few
//   microseconds, so the launch sets the time. Design: K21's. One thread
//   per triangle gathers p's six in-plane corner values, writes F(p) and
//   sums (H[r][c] p_r) p_c; the same thread adds the mass term of the vertex
//   with its index; each block reduces in shared memory and a one-block pass
//   sums the partials in a fixed order (no atomics: the sum sets the line
//   search's first step).
// K26 subdomain_assemble2d / subdomain_scale2d -- replaces
//   System2D.assemble_subdomains (dim2.py:588-602) and the equilibration
//   of factorize_fast (:604-616). Bound: bytes, the (P, n2p, n2p) matrices
//   written once (0.44 GB in f32 at P 4, n2p 5,248; 1.66 GB at P 1).
//   Design: one write pass, one warp a row (assemble_kernel below): the
//   row's slots come from the row-ordered tables (row_off, int32 col,
//   int32 items / seg_off: the part and row from the warp's index, the
//   column from col, no 64-bit division a slot); one lane a slot sums the
//   slot's run of element entries in plan order, applies the free mask of
//   row and column, adds mass_img f + (1 - f) on the diagonal and writes
//   d = sqrt(diag) (padding rows hold their diagonal slot alone: a unit
//   diagonal); the warp writes the row in 16 B vectors composed in
//   registers from zeros and its slots. Every byte of H is written once,
//   coalesced; no zero fill, no shared memory. The
//   second entry scales the same slots in place, one warp a row: 0 stays 0,
//   so the rest of the matrix is neither read nor written. It writes the
//   symmetrized value ((h / d_r) / d_c + (h / d_c) / d_r) / 2: the matrix
//   jnp.linalg.cholesky factors in dot_tpu (it symmetrizes its input),
//   from h alone, because a slot and its mirror sum the same values in the
//   same order (every local corner of a completed element is shared, so
//   each completion tuple has its mirror) and hold the same h.
// K27 h0_gather2d / h0_average2d / local_gather_one2d / local_scatter_one2d
//   -- K8's and K16's twins at two dofs per vertex with z = 0: the gather of
//   h0_apply (dim2.py:645-651) and its duplicate averaging (:652-658), and
//   one subdomain's gather and scatter of the GSDD sweep (:631-643). Bound:
//   bytes and launch latency (well under 1 MB a pass). Design: the gather
//   has one thread per local scalar; the averaging one thread per vertex
//   walking its run of the host-sorted gather permutation in order (the
//   dump segment nV of the padding slots is never read); the scatter zeroes
//   the direction and writes the valid local vertices only, so a padded
//   slot (l2g 0) leaves vertex 0 alone, as dot_tpu's dump row nV does.
// K28 pd_assemble2d / hessian_diag2d -- replaces System2D._build_pd_factor's
//   assembly of M + dt^2 D^T W D (dim2.py:704-726; the scaling is K26's
//   second entry on the same slots) and hessian_diag (:567-580). Bound:
//   bytes, the (nV)^2 scalar matrix written once (414 MB in f32 at 10,171
//   vertices). Design: K26's one-pass kernel with one dof per vertex, after
//   one thread per triangle has written the nine pair values
//   w_e (D_a . D_b) to a (9, N) scratch (two launches a call).
//   hessian_diag2d is K13's twin: one thread per vertex sums the (c, c)
//   diagonal entries over its vertex-sorted incidences in order, + mass,
//   with a z column of 1.
//
// Two more entry points of K26's slot kernel serve 2D ADMM-DD (plain versions
// in kernels/admm2d.py):
// dot_w_assemble2d -- replaces _weights' scatters (dim2.py:1130-1146) and
//   _w_masked (:1150-1152): the interface weights W (P, n2p, n2p) summed
//   over the completion tuples' slots with the free mask on rows and columns
//   (masking the sums gives dot_tpu's mask-after-scatter values) and no
//   diagonal term; and the consensus matrix C (ns2, ns2) over the same
//   values: K26's pass with the shared vertices' mass difference on the
//   diagonal, their free mask, a unit diagonal at fixed and dump rows, and
//   dc = sqrt(diag C). One launch: the blocks past W's rows take C's.
//   Bound: bytes, W written once (0.44 GB in f32 at P 4, n2p 5,248).
// dot_local_h_assemble2d -- replaces _local_h_factor's assembly
//   (dim2.py:1219-1232): K26's pass over the own triangles' blocks (the
//   local Hessians K23 computes at the local positions), the free mask,
//   + the masked W read at the same slot, + (mass_local + mass_dif f) f +
//   (1 - f) on the diagonal, and d. Its slot list is the union of the own
//   and W slots, so W is read only there and K26's scaling entry on the
//   same tables reaches every nonzero of the matrix; W is symmetric bit for
//   bit (a slot and its mirror sum the same tuples in the same order), so
//   the sum is too.
//
// Built with -fmad=false: products and sums round one by one, as the plain
// versions' elementwise ops do.

#include <cuda_runtime.h>

#include <cstdint>

namespace dotdd {

constexpr int kRedThreads = 256;   // K25 block size (power of two)
constexpr int kThreads = 128;
constexpr int kRowWarps = 4;     // one-pass assembly: row pieces (warps) a block
constexpr int kSegVecs = 512;    // 16 B vectors a row piece, about

inline int blocks(int64_t n, int t) { return static_cast<int>((n + t - 1) / t); }

template <typename T>
__device__ __forceinline__ void block_sum_store(T v, T* out) {
  __shared__ T sh[kRedThreads];
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int s = kRedThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = sh[0];
}

template <typename T>
__global__ void __launch_bounds__(kRedThreads)
sum_partials_kernel(const T* __restrict__ partials, int m, T* __restrict__ out) {
  T v = T(0);
  for (int i = threadIdx.x; i < m; i += kRedThreads) v += partials[i];
  block_sum_store(v, out);
}

// ---- K25 ------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kRedThreads)
quadratic_form2d_kernel(const T* __restrict__ p, const int* __restrict__ conn,
                        const T* __restrict__ g4, const T* __restrict__ H,
                        const T* __restrict__ mass, int n, int64_t n_vert,
                        T* __restrict__ Fp, T* __restrict__ partials) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(kRedThreads) + threadIdx.x;
  T v = T(0);
  if (t < n) {
    const int e = static_cast<int>(t);
    T pe[6], g[4];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int64_t vc = conn[c * n + e];
      pe[c * 2] = p[vc * 3];
      pe[c * 2 + 1] = p[vc * 3 + 1];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) g[k] = g4[k * n + e];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        Fp[(2 * i + j) * n + e] =
            (pe[2 + i] - pe[i]) * g[j] + (pe[4 + i] - pe[i]) * g[2 + j];
    T q = T(0);
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int c = 0; c < 6; ++c)
        q = q + H[static_cast<int64_t>(r * 6 + c) * n + e] * pe[r] * pe[c];
    v = q;
  }
  if (t < n_vert) {
    const T m = mass[t];
    T qm = T(0);
#pragma unroll
    for (int c = 0; c < 3; ++c) qm = qm + m * p[t * 3 + c] * p[t * 3 + c];
    v = v + qm;
  }
  block_sum_store(v, partials + blockIdx.x);
}

// ---- K26 / K28: one-pass assembly, symmetric scaling ------------------------
// One batch of (n_parts, n, n) matrices: the row-ordered slot tables (row
// id p*n + r; row_off (n_parts n + 1,), col (n_slot,), seg_off
// (n_slot + 1,) and items (n_item,), all int32), the free mask and mass per
// local vertex ((n_parts, n_loc); mass null: no diagonal term and no d),
// wadd (null or (n_parts, n, n): added at the slot after the mask); `rows`
// = n_parts n rows, kRowWarps a block over `blocks` blocks.
template <typename T>
struct AsmJob {
  const T* vals;
  const int* items;
  const int* seg_off;
  const int* row_off;
  const int* col;
  const T* freev;
  const T* mass;
  const T* wadd;
  const unsigned char* wslot;   // null, or 1 at the slots where wadd is read
  T* H;
  T* d;
  int rows, n, n_loc;
  int nseg, segv;      // a row's pieces (warps), 16 B vectors a piece
  int blocks;
};

// Loads of the tables and element values with an L2 evict-last policy:
// they are read again and again (by the slots of neighbouring rows) while
// the matrix streams through L2 on its way out, and without the hint that
// stream evicts them (a read missing L2 then waits on HBM behind the
// writes). volatile: a load is issued only where the code reaches it (a
// speculated one could read past a table's end).
__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}
__device__ __forceinline__ int ld_last(const int* p, uint64_t pol) {
  int v;
  asm volatile("ld.global.L2::cache_hint.b32 %0, [%1], %2;"
      : "=r"(v) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ float ld_last(const float* p, uint64_t pol) {
  float v;
  asm volatile("ld.global.L2::cache_hint.f32 %0, [%1], %2;"
      : "=f"(v) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ double ld_last(const double* p, uint64_t pol) {
  double v;
  asm volatile("ld.global.L2::cache_hint.f64 %0, [%1], %2;"
      : "=d"(v) : "l"(p), "l"(pol));
  return v;
}

// A slot's run summed in plan order, eight items a step: the loads of a
// step are independent (one round of latency for up to eight items: a
// diagonal slot's run is its vertex's triangles), the sum is taken in the
// order of the run.
template <typename T>
__device__ __forceinline__ T run_sum(const T* __restrict__ vals,
                                     const int* __restrict__ items, int q,
                                     int qend, uint64_t pol) {
  constexpr int kStep = 8;
  T s = T(0);
  for (; q < qend; q += kStep) {
    int i[kStep];
    T v[kStep];
#pragma unroll
    for (int u = 0; u < kStep; ++u)
      i[u] = q + u < qend ? ld_last(items + q + u, pol) : -1;
#pragma unroll
    for (int u = 0; u < kStep; ++u)
      v[u] = i[u] >= 0 ? ld_last(vals + i[u], pol) : T(0);
#pragma unroll
    for (int u = 0; u < kStep; ++u)
      if (q + u < qend) s += v[u];
  }
  return s;
}

// one 16 B evict-first store of a vector composed in registers
__device__ __forceinline__ void store_cs(float* p, const float (&e)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(e[0], e[1], e[2], e[3]));
}
__device__ __forceinline__ void store_cs(double* p, const double (&e)[2]) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(e[0], e[1]));
}

// One warp a row piece, nothing staged in shared memory. A row of n
// entries is a head (the entries before its first 32 B aligned one: K28's
// rows of odd width), nvec 16 B vectors and a tail; the vectors are cut
// into nseg pieces of an even segv (about kSegVecs: 8 KB of f32), the
// head going with the first piece and the tail with the last, so that a
// warp's work is short and even. Lane l holds the row's slots l, l + 32,
// ... (S a lane) and computes the value of each that falls in its piece
// (the run in plan order, the free mask of row and column, wadd, the
// diagonal's mass term and d). The warp
// then writes its piece once, 32 vectors a step (a "column chunk" of
// 32 x 16 B), each lane composing its vector from zeros and the slots that
// fall in it (a ballot of the chunk's slots, then shuffles). A row of
// more than 32 S slots (S = 4: dd2d.MAX_ROW, 128) is walked in windows of
// 32 S slots in column order, a column range taking the next window when
// it reaches past the current one's last column. Every byte of
// H is written once, coalesced, with evict-first stores (the matrix is far
// larger than L2 and read next by the library Cholesky); no barrier and no
// shared memory, so an SM holds as many pieces in flight as its registers
// allow and the slots' chains of dependent loads hide behind other pieces'
// stores. Blocks [0, j0.blocks) take j0's pieces, the rest j1's (j1.blocks
// 0: one job).
template <typename T, int DOF, int S>
__global__ void __launch_bounds__(kRowWarps * 32)
assemble_kernel(AsmJob<T> j0, AsmJob<T> j1) {
  const bool second = static_cast<int>(blockIdx.x) >= j0.blocks;
  const AsmJob<T> j = second ? j1 : j0;
  const int w =
      (second ? blockIdx.x - j0.blocks : blockIdx.x) * kRowWarps +
      (threadIdx.x >> 5);
  if (w >= j.rows * j.nseg) return;      // the whole warp
  const int row = w / j.nseg;
  const int g = w - row * j.nseg;
  const int lane = threadIdx.x & 31;
  const int n = j.n;
  const int p = row / n;
  const int r = row - p * n;
  const int base = p * j.n_loc;
  const int64_t rpos = static_cast<int64_t>(row) * n;
  constexpr int kVec = 16 / sizeof(T);
  // the body starts on a 32 B sector (and its pieces hold whole sectors),
  // so that no sector of it is written in halves by two warps
  const int mis = static_cast<int>(rpos % (2 * kVec));
  const int head = mis == 0 ? 0 : (2 * kVec - mis < n ? 2 * kVec - mis : n);
  const int nvec = (n - head) / kVec;
  const int tail0 = head + nvec * kVec;
  const bool last = g == j.nseg - 1;
  const int v_lo = g * j.segv < nvec ? g * j.segv : nvec;
  const int v_hi = last ? nvec : (v_lo + j.segv < nvec ? v_lo + j.segv : nvec);
  const int clo = g == 0 ? 0 : head + v_lo * kVec;       // the piece's columns
  const int chi = last ? n : head + v_hi * kVec;
  const uint64_t pol = evict_last_policy();
  const int kbeg = ld_last(j.row_off + row, pol);
  const int kend = ld_last(j.row_off + row + 1, pol);
  const T fr = ld_last(j.freev + base + r / DOF, pol);
  constexpr int kWin = 32 * S;
  int c[S];
  T v[S];
  // the window of slots wk .. wk + kWin - 1 (lane l: wk + l, wk + l + 32,
  // ...): the column and value of each slot that falls in this piece
  auto load = [&](int wk) {
#pragma unroll
    for (int u = 0; u < S; ++u) {
      const int k = wk + 32 * u + lane;
      c[u] = k < kend ? ld_last(j.col + k, pol) : -1;
      v[u] = T(0);
      if (c[u] >= clo && c[u] < chi) {
        const T fc = ld_last(j.freev + base + c[u] / DOF, pol);
        // wadd is 0 off its own slots (those marked in wslot): read there
        // only
        const T wv = j.wadd != nullptr && (j.wslot == nullptr || j.wslot[k])
                         ? j.wadd[rpos + c[u]] : T(0);
        T s = run_sum(j.vals, j.items, ld_last(j.seg_off + k, pol),
                      ld_last(j.seg_off + k + 1, pol), pol);
        s = s * fr * fc;
        if (j.wadd != nullptr) s = s + wv;
        if (c[u] == r && j.mass != nullptr) {
          s = s + (j.mass[base + r / DOF] * fr + (T(1) - fr));
          j.d[row] = sqrt(s);
        }
        v[u] = s;
      } else {
        c[u] = -1;                // not in this piece: in no window below
      }
    }
  };
  // a row of more than kWin slots is walked in windows, in column order:
  // those wholly left of the piece are skipped, and a column range that
  // reaches past the window's last column takes the next one
  int wk = kbeg;
  while (wk + kWin < kend && ld_last(j.col + wk + kWin - 1, pol) < clo)
    wk += kWin;
  load(wk);
  auto next_window = [&](int hi) {
    if (wk + kWin >= kend || ld_last(j.col + wk + kWin - 1, pol) >= hi)
      return false;
    wk += kWin;
    load(wk);
    return true;
  };
  T* out = j.H + rpos;
  // the value at column `want` of this row from the lanes' slots (the
  // columns the lanes ask for lie in [lo, hi), the same for the warp)
  auto pick = [&](int want, int lo, int hi, T& dst) {
#pragma unroll
    for (int u = 0; u < S; ++u) {
      unsigned m = __ballot_sync(0xffffffffu, c[u] >= lo && c[u] < hi);
      while (m) {
        const int src = __ffs(m) - 1;
        m &= m - 1;
        const int cs = __shfl_sync(0xffffffffu, c[u], src);
        const T vs = __shfl_sync(0xffffffffu, v[u], src);
        if (cs == want) dst = vs;
      }
    }
  };
  // head entries (first piece): one lane an entry
  if (g == 0 && head > 0) {
    T h = T(0);
    do {
      pick(lane, 0, head, h);
    } while (next_window(head));
    if (lane < head) out[lane] = h;
  }
  // the piece's aligned vectors, 32 a step
  for (int v0 = v_lo; v0 < v_hi; v0 += 32) {
    const int lo = head + v0 * kVec;
    const int hi = v0 + 32 < v_hi ? lo + 32 * kVec : head + v_hi * kVec;
    const int mine = lo + lane * kVec;
    T vec[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) vec[e] = T(0);
    do {
#pragma unroll
      for (int u = 0; u < S; ++u) {
        unsigned m = __ballot_sync(0xffffffffu, c[u] >= lo && c[u] < hi);
        while (m) {
          const int src = __ffs(m) - 1;
          m &= m - 1;
          const int cs = __shfl_sync(0xffffffffu, c[u], src);
          const T vs = __shfl_sync(0xffffffffu, v[u], src);
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            if (cs == mine + e) vec[e] = vs;
        }
      }
    } while (next_window(hi));
    if (v0 + lane < v_hi) store_cs(out + mine, vec);
  }
  // tail entries (last piece): one lane an entry
  if (last && tail0 < n) {
    T t = T(0);
    do {
      pick(tail0 + lane, tail0, n, t);
    } while (next_window(n));
    if (tail0 + lane < n) out[tail0 + lane] = t;
  }
}

// one warp a row: its slots scaled in place
template <typename T>
__global__ void __launch_bounds__(kThreads)
sym_scale_kernel(T* __restrict__ H, const T* __restrict__ d,
                 const int* __restrict__ row_off, const int* __restrict__ col,
                 int n_rows, int n) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (row >= n_rows) return;
  const int lane = threadIdx.x & 31;
  const int64_t rpos = static_cast<int64_t>(row) * n;
  const int64_t dpos = static_cast<int64_t>(row / n) * n;
  const T ir = T(1) / d[row];
  const int kend = row_off[row + 1];
  for (int k = row_off[row] + lane; k < kend; k += 32) {
    const int c = col[k];
    const T ic = T(1) / d[dpos + c];
    const T h = H[rpos + c];
    H[rpos + c] = (h * ir * ic + h * ic * ir) / T(2);
  }
}

// K28: vals (9, n), row a*3 + b = w (D_a . D_b); D_0 = -(row 0 + row 1) of
// restTriInv, D_{k+1} = row k
template <typename T>
__global__ void __launch_bounds__(kThreads)
pd_pair_vals_kernel(const T* __restrict__ g4, const T* __restrict__ w, int n,
                    T* __restrict__ vals) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  T g[4], D[3][2];
#pragma unroll
  for (int k = 0; k < 4; ++k) g[k] = g4[k * n + e];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    D[0][j] = -(g[j] + g[2 + j]);
    D[1][j] = g[j];
    D[2][j] = g[2 + j];
  }
  const T we = w[e];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      vals[(a * 3 + b) * n + e] = we * (D[a][0] * D[b][0] + D[a][1] * D[b][1]);
}

// ---- K27 ------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
gather2d_kernel(const T* __restrict__ rhs, const int64_t* __restrict__ l2g,
                const unsigned char* __restrict__ valid,
                const T* __restrict__ d, int64_t n_loc, T* __restrict__ r) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (t >= n_loc * 2) return;
  const int64_t i = t >> 1;
  r[t] = rhs[l2g[i] * 3 + (t & 1)] * T(valid[i]) / d[t];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
average2d_kernel(const T* __restrict__ z, const T* __restrict__ d,
                 const int64_t* __restrict__ perm,
                 const int64_t* __restrict__ seg_off, const T* __restrict__ dup,
                 int64_t n_vert, T* __restrict__ out) {
  const int64_t v = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (v >= n_vert) return;
  T s0 = T(0), s1 = T(0);
  const int64_t end = seg_off[v + 1];
  for (int64_t k = seg_off[v]; k < end; ++k) {
    const int64_t j = perm[k] * 2;
    s0 += z[j] / d[j];
    s1 += z[j + 1] / d[j + 1];
  }
  const T du = dup[v];
  out[v * 3] = s0 / du;
  out[v * 3 + 1] = s1 / du;
  out[v * 3 + 2] = T(0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter2d_kernel(const T* __restrict__ z, const T* __restrict__ d,
                 const int64_t* __restrict__ l2g,
                 const unsigned char* __restrict__ valid, int64_t n_loc,
                 T* __restrict__ out) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (t >= n_loc * 2) return;
  const int64_t i = t >> 1;
  if (!valid[i]) return;
  out[l2g[i] * 3 + (t & 1)] = z[t] / d[t];
}

// K28's second entry: one thread per vertex over its (element, corner)
// incidences e*3 + c, sorted by vertex
template <typename T>
__global__ void __launch_bounds__(kThreads)
hessian_diag2d_kernel(const T* __restrict__ H, int64_t n,
                      const int64_t* __restrict__ inc_perm,
                      const int64_t* __restrict__ inc_off,
                      const T* __restrict__ mass, int64_t n_vert,
                      T* __restrict__ out) {
  const int64_t v = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (v >= n_vert) return;
  T a0 = T(0), a1 = T(0);
  const int64_t end = inc_off[v + 1];
  for (int64_t k = inc_off[v]; k < end; ++k) {
    const int64_t inc = inc_perm[k];
    const int64_t e = inc / 3;
    const int c = static_cast<int>(inc - e * 3);
    a0 += H[static_cast<int64_t>(c * 14) * n + e];        // (2c, 2c)
    a1 += H[static_cast<int64_t>(c * 14 + 7) * n + e];    // (2c+1, 2c+1)
  }
  const T m = mass[v];
  out[v * 3] = a0 + m;
  out[v * 3 + 1] = a1 + m;
  out[v * 3 + 2] = T(1);
}

// ---- launchers ------------------------------------------------------------
template <typename T>
AsmJob<T> job(const void* vals, const void* items, const void* seg_off,
              const void* row_off, const void* col, const void* freev,
              const void* mass, const void* wadd, long long n_loc, long long n,
              long long n_parts, void* H, void* d,
              const void* wslot = nullptr) {
  AsmJob<T> j;
  j.wslot = static_cast<const unsigned char*>(wslot);
  j.vals = static_cast<const T*>(vals);
  j.items = static_cast<const int*>(items);
  j.seg_off = static_cast<const int*>(seg_off);
  j.row_off = static_cast<const int*>(row_off);
  j.col = static_cast<const int*>(col);
  j.freev = static_cast<const T*>(freev);
  j.mass = static_cast<const T*>(mass);
  j.wadd = static_cast<const T*>(wadd);
  j.H = static_cast<T*>(H);
  j.d = static_cast<T*>(d);
  j.rows = static_cast<int>(n_parts * n);
  j.n = static_cast<int>(n);
  j.n_loc = static_cast<int>(n_loc);
  const int vmax = static_cast<int>(n * sizeof(T) / 16);
  j.nseg = vmax > kSegVecs ? (vmax + kSegVecs - 1) / kSegVecs : 1;
  j.segv = ((vmax + j.nseg - 1) / j.nseg + 1) / 2 * 2;     // even
  j.blocks = (j.rows * j.nseg + kRowWarps - 1) / kRowWarps;
  return j;
}

// rows, slots and row pieces are int32 ids
template <typename T>
bool job_ok(long long n, long long n_parts) {
  const long long nseg = n * static_cast<long long>(sizeof(T)) / 16 / kSegVecs + 1;
  return n > 0 && n_parts > 0 && n_parts * n * nseg < (1LL << 31) - kRowWarps;
}

// one launch over j0's rows, then j1's (j1.blocks 0: none); max_row: the
// most slots a row of either holds (beyond 128: windows of 128)
template <typename T, int DOF>
int assemble_dof(const AsmJob<T>& j0, const AsmJob<T>& j1, int nb,
                 int max_row, cudaStream_t st) {
  const int nt = kRowWarps * 32;
  if (max_row <= 32)
    assemble_kernel<T, DOF, 1><<<nb, nt, 0, st>>>(j0, j1);
  else if (max_row <= 64)
    assemble_kernel<T, DOF, 2><<<nb, nt, 0, st>>>(j0, j1);
  else
    assemble_kernel<T, DOF, 4><<<nb, nt, 0, st>>>(j0, j1);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int assemble(const AsmJob<T>& j0, const AsmJob<T>& j1, int dof, int max_row,
             cudaStream_t st) {
  const long long nb = static_cast<long long>(j0.blocks) + j1.blocks;
  if (nb >= (1LL << 31) - 1 || max_row < 0) return 1;
  if (dof == 2)
    return assemble_dof<T, 2>(j0, j1, static_cast<int>(nb), max_row, st);
  if (dof == 1)
    return assemble_dof<T, 1>(j0, j1, static_cast<int>(nb), max_row, st);
  return 1;
}

template <typename T>
AsmJob<T> no_job() {
  AsmJob<T> j{};
  j.n = 1;
  return j;
}

template <typename T>
int one_pass(const void* vals, const void* items, const void* seg_off,
             const void* row_off, const void* col, const void* freev,
             const void* mass, const void* wadd, long long n_loc, long long n,
             long long n_parts, int dof, int max_row, void* H, void* d,
             cudaStream_t st, const void* wslot = nullptr) {
  if (!job_ok<T>(n, n_parts)) return 1;
  return assemble<T>(job<T>(vals, items, seg_off, row_off, col, freev, mass,
                            wadd, n_loc, n, n_parts, H, d, wslot),
                     no_job<T>(), dof, max_row, st);
}

template <typename T>
int pd_assemble(const void* g4, const void* w, int n_elem, void* vals,
                const void* items, const void* seg_off, const void* row_off,
                const void* col, const void* freev, const void* mass,
                long long n_vert, int max_row, void* H, void* d,
                cudaStream_t st) {
  if (n_elem <= 0 || !job_ok<T>(n_vert, 1)) return 1;
  pd_pair_vals_kernel<T><<<blocks(n_elem, kThreads), kThreads, 0, st>>>(
      (const T*)g4, (const T*)w, n_elem, (T*)vals);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return one_pass<T>(vals, items, seg_off, row_off, col, freev, mass, nullptr,
                     n_vert, n_vert, 1, 1, max_row, H, d, st);
}

// W (no diagonal term) and C (as K26) in one launch, 2 dofs a vertex
template <typename T>
int w_assemble(const void* vals, const void* w_items, const void* w_seg_off,
               const void* w_row_off, const void* w_col, const void* freev,
               long long n_loc, long long n, long long n_parts, void* W,
               const void* c_items, const void* c_seg_off,
               const void* c_row_off, const void* c_col, const void* sfree,
               const void* md_sh, long long c_n, int max_row, void* C,
               void* dc, cudaStream_t st) {
  if (!job_ok<T>(n, n_parts) || !job_ok<T>(c_n, 1)) return 1;
  return assemble<T>(
      job<T>(vals, w_items, w_seg_off, w_row_off, w_col, freev, nullptr,
             nullptr, n_loc, n, n_parts, W, nullptr),
      job<T>(vals, c_items, c_seg_off, c_row_off, c_col, sfree, md_sh,
             nullptr, c_n / 2, c_n, 1, C, dc),
      2, max_row, st);
}

}  // namespace dotdd

// dtype: 0 float32, 1 float64. Each entry returns the cudaGetLastError() of
// its launches (0 = cudaSuccess); a bad code or shape gives 1.
extern "C" {

int dot_qf2d_partials(int n, long long n_vert) {
  return dotdd::blocks(n > n_vert ? n : n_vert, dotdd::kRedThreads);
}

// p (n_vert, 3); conn (3, n) int32; g4 (4, n); H (36, n); mass (n_vert,);
// Fp (4, n) written; partials: dot_qf2d_partials values; out 0-d.
int dot_quadratic_form2d(int dtype, const void* p, const void* conn,
                         const void* g4, const void* H, const void* mass, int n,
                         long long n_vert, void* Fp, void* partials, void* out,
                         void* stream) {
  if (n <= 0) return 1;
  auto st = (cudaStream_t)stream;
  const int nb = dot_qf2d_partials(n, n_vert);
  auto cn = (const int*)conn;
  const int nt = dotdd::kRedThreads;
  if (dtype == 0) {
    dotdd::quadratic_form2d_kernel<float><<<nb, nt, 0, st>>>(
        (const float*)p, cn, (const float*)g4, (const float*)H,
        (const float*)mass, n, n_vert, (float*)Fp, (float*)partials);
    dotdd::sum_partials_kernel<float><<<1, nt, 0, st>>>(
        (const float*)partials, nb, (float*)out);
  } else if (dtype == 1) {
    dotdd::quadratic_form2d_kernel<double><<<nb, nt, 0, st>>>(
        (const double*)p, cn, (const double*)g4, (const double*)H,
        (const double*)mass, n, n_vert, (double*)Fp, (double*)partials);
    dotdd::sum_partials_kernel<double><<<1, nt, 0, st>>>(
        (const double*)partials, nb, (double*)out);
  } else {
    return 1;
  }
  return (int)cudaGetLastError();
}

// The slot tables of an (n_parts, n, n) batch, rows p*n + r in order
// (kernels/dd2d.py SlotTables), all int32: row_off (n_parts n + 1,) the
// row's slots, col (n_slot,) their columns (every diagonal slot among
// them), seg_off (n_slot + 1,) each slot's run of items (n_item,), indices
// into vals. max_row: the most slots a row holds.
//
// freev, mass (n_parts, n_loc); H (n_parts, n, n) and d (n_parts, n) are
// written; dof: 1 or 2 (n = dof * n_loc).
int dot_subdomain_assemble2d(int dtype, const void* vals, const void* items,
                             const void* seg_off, const void* row_off,
                             const void* col, const void* freev,
                             const void* mass, long long n_loc, long long n,
                             long long n_parts, int dof, int max_row, void* H,
                             void* d, void* stream) {
  auto st = (cudaStream_t)stream;
  if (dtype == 0)
    return dotdd::one_pass<float>(vals, items, seg_off, row_off, col, freev,
                                  mass, nullptr, n_loc, n, n_parts, dof,
                                  max_row, H, d, st);
  if (dtype == 1)
    return dotdd::one_pass<double>(vals, items, seg_off, row_off, col, freev,
                                   mass, nullptr, n_loc, n, n_parts, dof,
                                   max_row, H, d, st);
  return 1;
}

// vals (36, nE) row-major element Hessians; W's slot tables (P, n, n) with
// freev (P, n_loc); C's (one part, c_n = 2 (ns + 1)) with sfree, md_sh
// (ns + 1,). W (P, n, n), C (c_n, c_n) and dc (c_n,) are written.
int dot_w_assemble2d(int dtype, const void* vals, const void* w_items,
                     const void* w_seg_off, const void* w_row_off,
                     const void* w_col, const void* freev, long long n_loc,
                     long long n, long long n_parts, void* W,
                     const void* c_items, const void* c_seg_off,
                     const void* c_row_off, const void* c_col,
                     const void* sfree, const void* md_sh, long long c_n,
                     int max_row, void* C, void* dc, void* stream) {
  auto st = (cudaStream_t)stream;
  if (dtype == 0)
    return dotdd::w_assemble<float>(vals, w_items, w_seg_off, w_row_off,
                                    w_col, freev, n_loc, n, n_parts, W,
                                    c_items, c_seg_off, c_row_off, c_col,
                                    sfree, md_sh, c_n, max_row, C, dc, st);
  if (dtype == 1)
    return dotdd::w_assemble<double>(vals, w_items, w_seg_off, w_row_off,
                                     w_col, freev, n_loc, n, n_parts, W,
                                     c_items, c_seg_off, c_row_off, c_col,
                                     sfree, md_sh, c_n, max_row, C, dc, st);
  return 1;
}

// vals (36, P epad) row-major own Hessians; the own slot tables (their
// slots cover W's) with wslot (n_slot,) uint8, 1 at W's slots (Wm is 0
// elsewhere: read there only); freev, mass (P, n_loc); Wm (P, n, n);
// H (P, n, n) and d (P, n) are written.
int dot_local_h_assemble2d(int dtype, const void* vals, const void* items,
                           const void* seg_off, const void* row_off,
                           const void* col, const void* wslot,
                           const void* freev, const void* mass,
                           const void* Wm, long long n_loc, long long n,
                           long long n_parts, int max_row, void* H, void* d,
                           void* stream) {
  auto st = (cudaStream_t)stream;
  if (wslot == nullptr) return 1;
  if (dtype == 0)
    return dotdd::one_pass<float>(vals, items, seg_off, row_off, col, freev,
                                  mass, Wm, n_loc, n, n_parts, 2, max_row, H, d,
                                  st, wslot);
  if (dtype == 1)
    return dotdd::one_pass<double>(vals, items, seg_off, row_off, col, freev,
                                   mass, Wm, n_loc, n, n_parts, 2, max_row, H, d,
                                   st, wslot);
  return 1;
}

// In place over the slots of row_off / col (n_rows = n_parts n rows):
// H = ((H / d_r) / d_c + (H / d_c) / d_r) / 2.
int dot_subdomain_scale2d(int dtype, void* H, const void* d,
                          const void* row_off, const void* col,
                          long long n_rows, long long n, void* stream) {
  if (n_rows <= 0 || n <= 0 || n_rows >= (1LL << 31) / 32) return 1;
  auto st = (cudaStream_t)stream;
  const int nb = dotdd::blocks(n_rows * 32, dotdd::kThreads);
  auto ro = (const int*)row_off;
  auto cl = (const int*)col;
  const int nt = dotdd::kThreads;
  const int nr = static_cast<int>(n_rows), w = static_cast<int>(n);
  if (dtype == 0)
    dotdd::sym_scale_kernel<float><<<nb, nt, 0, st>>>(
        (float*)H, (const float*)d, ro, cl, nr, w);
  else if (dtype == 1)
    dotdd::sym_scale_kernel<double><<<nb, nt, 0, st>>>(
        (double*)H, (const double*)d, ro, cl, nr, w);
  else
    return 1;
  return (int)cudaGetLastError();
}

// g4 (4, n_elem); w (n_elem,); vals (9, n_elem) scratch; the slot tables
// of the (n_vert)^2 matrix (items index vals); freev, mass (n_vert,);
// H (n_vert, n_vert) and d (n_vert,) are written.
int dot_pd_assemble2d(int dtype, const void* g4, const void* w, int n_elem,
                      void* vals, const void* items, const void* seg_off,
                      const void* row_off, const void* col, const void* freev,
                      const void* mass, long long n_vert, int max_row, void* H,
                      void* d, void* stream) {
  auto st = (cudaStream_t)stream;
  if (dtype == 0)
    return dotdd::pd_assemble<float>(g4, w, n_elem, vals, items, seg_off,
                                     row_off, col, freev, mass, n_vert, max_row,
                                     H, d, st);
  if (dtype == 1)
    return dotdd::pd_assemble<double>(g4, w, n_elem, vals, items, seg_off,
                                      row_off, col, freev, mass, n_vert,
                                      max_row, H, d, st);
  return 1;
}

// rhs (nV, 3); l2g, valid: rows of n_loc local vertices, `part` selects
// the row (0 with n_loc = P N: all subdomains at once); d and r hold
// 2 n_loc values per row.
int dot_h0_gather2d(int dtype, const void* rhs, const void* l2g,
                    const void* valid, const void* d, long long part,
                    long long n_loc, void* r, void* stream) {
  if (n_loc == 0) return 0;
  auto st = (cudaStream_t)stream;
  auto idx = (const int64_t*)l2g + part * n_loc;
  auto val = (const unsigned char*)valid + part * n_loc;
  const int nb = dotdd::blocks(n_loc * 2, dotdd::kThreads);
  const int nt = dotdd::kThreads;
  if (dtype == 0)
    dotdd::gather2d_kernel<float><<<nb, nt, 0, st>>>(
        (const float*)rhs, idx, val, (const float*)d + part * n_loc * 2, n_loc,
        (float*)r);
  else if (dtype == 1)
    dotdd::gather2d_kernel<double><<<nb, nt, 0, st>>>(
        (const double*)rhs, idx, val, (const double*)d + part * n_loc * 2,
        n_loc, (double*)r);
  else
    return 1;
  return (int)cudaGetLastError();
}

// z, d (P, 2 N); perm (P N,) local slots sorted by vertex; seg_off
// (n_vert + 2,); dup (n_vert,); out (n_vert, 3).
int dot_h0_average2d(int dtype, const void* z, const void* d, const void* perm,
                     const void* seg_off, const void* dup, long long n_vert,
                     void* out, void* stream) {
  if (n_vert == 0) return 0;
  auto st = (cudaStream_t)stream;
  auto pm = (const int64_t*)perm;
  auto so = (const int64_t*)seg_off;
  const int nb = dotdd::blocks(n_vert, dotdd::kThreads);
  const int nt = dotdd::kThreads;
  if (dtype == 0)
    dotdd::average2d_kernel<float><<<nb, nt, 0, st>>>(
        (const float*)z, (const float*)d, pm, so, (const float*)dup, n_vert,
        (float*)out);
  else if (dtype == 1)
    dotdd::average2d_kernel<double><<<nb, nt, 0, st>>>(
        (const double*)z, (const double*)d, pm, so, (const double*)dup, n_vert,
        (double*)out);
  else
    return 1;
  return (int)cudaGetLastError();
}

// z (2 n_loc,); l2g, valid (P, n_loc); d (P, 2 n_loc); out (n_vert, 3),
// zeroed here.
int dot_local_scatter_one2d(int dtype, const void* z, const void* d,
                            const void* l2g, const void* valid, long long part,
                            long long n_loc, long long n_vert, void* out,
                            void* stream) {
  if (dtype != 0 && dtype != 1) return 1;
  auto st = (cudaStream_t)stream;
  const size_t sz = dtype == 0 ? sizeof(float) : sizeof(double);
  cudaError_t e = cudaMemsetAsync(out, 0, n_vert * 3 * sz, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_loc == 0) return 0;
  auto idx = (const int64_t*)l2g + part * n_loc;
  auto val = (const unsigned char*)valid + part * n_loc;
  const int nb = dotdd::blocks(n_loc * 2, dotdd::kThreads);
  const int nt = dotdd::kThreads;
  if (dtype == 0)
    dotdd::scatter2d_kernel<float><<<nb, nt, 0, st>>>(
        (const float*)z, (const float*)d + part * n_loc * 2, idx, val, n_loc,
        (float*)out);
  else
    dotdd::scatter2d_kernel<double><<<nb, nt, 0, st>>>(
        (const double*)z, (const double*)d + part * n_loc * 2, idx, val, n_loc,
        (double*)out);
  return (int)cudaGetLastError();
}

// H (36, n); inc_perm (3 n,) incidences e*3 + c sorted by vertex, inc_off
// (n_vert + 1,); mass (n_vert,); out (n_vert, 3).
int dot_hessian_diag2d(int dtype, const void* H, long long n,
                       const void* inc_perm, const void* inc_off,
                       const void* mass, long long n_vert, void* out,
                       void* stream) {
  if (n_vert == 0) return 0;
  auto st = (cudaStream_t)stream;
  auto ip = (const int64_t*)inc_perm;
  auto io = (const int64_t*)inc_off;
  const int nb = dotdd::blocks(n_vert, dotdd::kThreads);
  const int nt = dotdd::kThreads;
  if (dtype == 0)
    dotdd::hessian_diag2d_kernel<float><<<nb, nt, 0, st>>>(
        (const float*)H, n, ip, io, (const float*)mass, n_vert, (float*)out);
  else if (dtype == 1)
    dotdd::hessian_diag2d_kernel<double><<<nb, nt, 0, st>>>(
        (const double*)H, n, ip, io, (const double*)mass, n_vert,
        (double*)out);
  else
    return 1;
  return (int)cudaGetLastError();
}

}  // extern "C"
