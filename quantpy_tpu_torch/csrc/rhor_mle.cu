// Fused RrhoR maximum-likelihood iteration for Hopper (sm_90a).
//
// Replaces quantpy_tpu/ops/kernels.py::rhor_mle_pallas (body _rhor_kernel_t):
// n_iter fixed RrhoR iterations for a batch of resamples, in one launch, with
// the iteration state kept on chip between iterations. Per iteration and
// resample, with K POVM rows, D = 4^n bloch components and d = 2^n:
//
//   p = w2 b                      (K x D matvec)
//   c = f / max(p, 1e-10)
//   r = w2^T c                    (D x K matvec)
//   R, rho = PTM(r), PTM(b)       (real and imaginary parts of the
//                                  transposed d x d matrices)
//   S = R rho, T = S R            (two complex d x d products)
//   b' = (PTM_re^T vec T_re + PTM_im^T vec T_im) / d,  b' /= d b'_0
//
// What bounds it on this card. Every row and every column of PTM holds
// exactly d non-zeros, each one of +-1 and +-i, so the PTM maps are signed
// gathers of d terms per output (3 D d per resample-iteration). The least
// work is then 2 K D + 3 D d + 8 d^3 MACs per resample-iteration: 708,608 at
// the flagship size (n = 4: K = 1296, D = 256, d = 16), 1.39 TFLOP for a
// 16,384-resample call of 60 iterations, about 21 ms at the card's 67
// TFLOP/s FP32 peak; its 120 MB of inputs and outputs take 0.04 ms, so the
// function is compute-bound. The matrices (w2 and its transpose, 1.33 MB
// each in f32; the two gather tables, 16 KB each) are the same for every
// resample and stay in the 50 MB L2. What holds the kernel back is not the
// FMA rate but the load instructions that feed it: the w2 values streamed
// from L2 and the state rows read from shared memory, in the two POVM
// stages, which take most of the time (PERF.md).
//
// What the design does about it. A block of 256 threads owns a tile of BT
// resamples (BT = 32 bytes / sizeof(T): 8 in f32, 4 in f64) and runs all
// iterations in a loop. The tile's state (b, c, R, rho/T, r/S; K + 7 D rows
// of BT values) lives in shared memory, stored resample-minor so that one
// 32-byte vector load fetches a row. The two POVM products are
// register-tiled, with each thread's w2 values loaded kAhead steps before
// their use (a ring in registers): in p = w2 b a thread owns kGroupsP rows
// of w2 (strided by 256), and in r = w2^T c a quad of bloch components,
// read as one 16-byte vector, over a slice of the K rows (split-K, at most
// kMaxSplit slices, their partial sums reduced once through the R and rho
// buffers, which are dead in that stage). Each broadcast state-row load thus
// feeds 6 or 4 BT multiply-adds instead of BT. The PTM maps read the gather
// tables (int32, entry = index << 2 | imaginary << 1 | negative, laid out
// (d, D) so that neighbouring outputs read neighbouring entries) and add or
// subtract whole rows into the real or the imaginary accumulator; the
// coefficients are 0 and +-1, so the sums are exact reorderings of the
// dense products. Arithmetic is plain FP32/FP64 FMA on the CUDA cores: no
// tensor cores and no TF32. All of it fits the 128 registers a thread has
// at two blocks per SM, without spills (the d-length loops are kept rolled
// for that; ptxas's allocation at that cap is fragile, so time any rewrite
// of the POVM stages). When the state does not fit in shared memory
// (n >= 5), the caller passes a global scratch buffer of gridDim.x tiles
// instead and the same code runs through generic pointers. The ragged tail
// of the batch is masked: its rows read the last resample's inputs and are
// never stored.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kGroupsP = 6;   // w2 rows per thread in p = w2 b
constexpr int kAhead = 4;     // w2 loads in flight per row (f32; f64 half)
constexpr int kMaxSplit = 4;  // K slices of r = w2^T c (4 D rows of partials)

template <typename T>
struct TileOf;
template <>
struct TileOf<float> {
  static constexpr int value = 8;
};
template <>
struct TileOf<double> {
  static constexpr int value = 4;
};

// One row of the tile: the BT values of one index, one per resample.
template <typename T, int BT>
struct alignas(16) Row {
  T v[BT];
};

template <typename T, int BT>
__device__ __forceinline__ Row<T, BT> load_row(const T* p) {
  return *reinterpret_cast<const Row<T, BT>*>(p);
}

template <typename T, int BT>
__device__ __forceinline__ void store_row(T* p, const Row<T, BT>& r) {
  *reinterpret_cast<Row<T, BT>*>(p) = r;
}

// Four consecutive values of w2, read through the read-only path in one
// 16-byte vector (f32) or two (f64); `p` is aligned to the vector.
template <typename T>
struct Quad {
  T v[4];
};

template <typename T>
__device__ __forceinline__ Quad<T> load_quad(const T* p) {
  Quad<T> r;
  if constexpr (sizeof(T) == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    r.v[0] = a.x, r.v[1] = a.y, r.v[2] = a.z, r.v[3] = a.w;
  } else {
    const double2 a = __ldg(reinterpret_cast<const double2*>(p));
    const double2 c = __ldg(reinterpret_cast<const double2*>(p) + 1);
    r.v[0] = a.x, r.v[1] = a.y, r.v[2] = c.x, r.v[3] = c.y;
  }
  return r;
}

template <typename T, int BT>
__global__ void __launch_bounds__(kThreads, 2)
rhor_mle_kernel(const T* __restrict__ freq,     // (B, K)
                const T* __restrict__ bloch0,   // (B, D)
                const T* __restrict__ w2,       // (K, D)
                const T* __restrict__ w2t,      // (D, K)
                const int* __restrict__ fwd,    // (d, D) gathers of PTM rows
                const int* __restrict__ back,   // (d, D) gathers of PTM columns
                T* __restrict__ out,            // (B, D)
                T* __restrict__ scratch,        // null, or gridDim.x tiles
                int B, int K, int D, int d, int n_iter) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t tile_len = static_cast<size_t>(BT) * (K + 7 * static_cast<size_t>(D));
  T* ws = scratch != nullptr ? scratch + blockIdx.x * tile_len
                             : reinterpret_cast<T*>(smem_raw);
  const size_t rows_d = static_cast<size_t>(D) * BT;
  T* b = ws;                                       // (D, BT) bloch
  T* c = b + rows_d;                               // (K, BT) f / max(p, eps)
  T* rre = c + static_cast<size_t>(K) * BT;        // (D, BT) R, transposed
  T* rim = rre + rows_d;
  T* xre = rim + rows_d;                           // rho, then T
  T* xim = xre + rows_d;
  T* sre = xim + rows_d;                           // r (bloch of R), then S
  T* sim = sre + rows_d;

  const int tid = threadIdx.x;
  const T eps = T(1e-10);
  const int n_tiles = (B + BT - 1) / BT;
  constexpr int A = sizeof(T) == 4 ? kAhead : (kAhead + 1) / 2;
  // r = w2^T c: n_groups quads of components (D = 4^n), each summed over
  // `split` slices of K; with split > 1 the partial sums go to rre..xim
  const int n_groups = D / 4;
  const int split = n_groups >= kThreads ? 1 : min(kMaxSplit, kThreads / n_groups);
  const int slice = (K + split - 1) / split;
  T* part = split > 1 ? rre : sre;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b0 = tile * BT;
    for (int idx = tid; idx < D * BT; idx += kThreads) {
      const int t = idx / D, j = idx % D;
      const int row = min(b0 + t, B - 1);
      b[j * BT + t] = bloch0[static_cast<size_t>(row) * D + j];
    }
    __syncthreads();

    for (int it = 0; it < n_iter; ++it) {
      // p = w2 b and c = f / max(p, eps); thread owns POVM rows
      // k = base + g kThreads + tid, g < kGroupsP (rows past K are never
      // stored; a warp whose rows all lie past K skips them)
      for (int base = 0; base < K; base += kGroupsP * kThreads) {
        bool live[kGroupsP];
#pragma unroll
        for (int g = 0; g < kGroupsP; ++g) live[g] = base + g * kThreads + tid < K;
        const T* wk = w2t + base + tid;
        T acc[kGroupsP][BT] = {};
        // ring of the w2 values of the next A components: each is loaded A
        // steps before its use; loads past D are clamped to its last
        // component and never used
        T w[A][kGroupsP];
#pragma unroll
        for (int a = 0; a < A; ++a)
#pragma unroll
          for (int g = 0; g < kGroupsP; ++g)
            if (live[g])
              w[a][g] = __ldg(wk + static_cast<size_t>(min(a, D - 1)) * K + g * kThreads);
        for (int j0 = 0; j0 < D; j0 += A) {
#pragma unroll
          for (int a = 0; a < A; ++a) {
            const int j = j0 + a;
            if (j < D) {
              const Row<T, BT> x = load_row<T, BT>(b + j * BT);
#pragma unroll
              for (int g = 0; g < kGroupsP; ++g) {
                if (live[g]) {
#pragma unroll
                  for (int t = 0; t < BT; ++t) acc[g][t] += w[a][g] * x.v[t];
                }
              }
            }
            const T* wn = wk + static_cast<size_t>(min(j + A, D - 1)) * K;
#pragma unroll
            for (int g = 0; g < kGroupsP; ++g)
              if (live[g]) w[a][g] = __ldg(wn + g * kThreads);
          }
        }
#pragma unroll
        for (int g = 0; g < kGroupsP; ++g) {
          const int k = base + g * kThreads + tid;
          if (k < K) {
            Row<T, BT> cr;
#pragma unroll
            for (int t = 0; t < BT; ++t) {
              const int row = min(b0 + t, B - 1);
              const T p = acc[g][t] < eps ? eps : acc[g][t];
              cr.v[t] = __ldg(freq + static_cast<size_t>(row) * K + k) / p;
            }
            store_row<T, BT>(c + static_cast<size_t>(k) * BT, cr);
          }
        }
      }
      __syncthreads();

      // r = w2^T c into the S buffer; slot (slice s, group g) owns the quad
      // of bloch components 4 g .. 4 g + 3 over rows [s slice, (s+1) slice)
      for (int slot = tid; slot < n_groups * split; slot += kThreads) {
        const int g = slot % n_groups, s = slot / n_groups;
        T acc[4][BT] = {};
        const int k_begin = s * slice, k_end = min(K, k_begin + slice);
        if (k_begin < k_end) {
          // the same ring over the rows of the slice; loads past its end
          // are clamped to its last row and never used
          const T* wg = w2 + 4 * g;
          Quad<T> w[A];
#pragma unroll
          for (int a = 0; a < A; ++a)
            w[a] = load_quad(wg + static_cast<size_t>(min(k_begin + a, k_end - 1)) * D);
          for (int k0 = k_begin; k0 < k_end; k0 += A) {
#pragma unroll
            for (int a = 0; a < A; ++a) {
              const int k = k0 + a;
              if (k < k_end) {
                const Row<T, BT> x = load_row<T, BT>(c + static_cast<size_t>(k) * BT);
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                  for (int t = 0; t < BT; ++t) acc[i][t] += w[a].v[i] * x.v[t];
              }
              w[a] = load_quad(wg + static_cast<size_t>(min(k + A, k_end - 1)) * D);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          Row<T, BT> o;
#pragma unroll
          for (int t = 0; t < BT; ++t) o.v[t] = acc[i][t];
          store_row<T, BT>(part + (static_cast<size_t>(s) * D + 4 * g + i) * BT, o);
        }
      }
      __syncthreads();
      if (split > 1) {
        for (int j = tid; j < D; j += kThreads) {
          Row<T, BT> o = load_row<T, BT>(part + j * BT);
          for (int s = 1; s < split; ++s) {
            const Row<T, BT> x = load_row<T, BT>(part + (static_cast<size_t>(s) * D + j) * BT);
#pragma unroll
            for (int t = 0; t < BT; ++t) o.v[t] += x.v[t];
          }
          store_row<T, BT>(sre + j * BT, o);
        }
        __syncthreads();
      }

      // R = PTM r and rho = PTM b (real and imaginary parts), vec index i:
      // d signed gathers of PTM row i
      for (int i = tid; i < D; i += kThreads) {
        T ar[BT] = {}, ai[BT] = {}, xr[BT] = {}, xi[BT] = {};
#pragma unroll 1
        for (int m = 0; m < d; ++m) {
          const int e = __ldg(fwd + static_cast<size_t>(m) * D + i);
          const T sign = (e & 1) ? T(-1) : T(1);
          const T to_re = (e & 2) ? T(0) : sign;
          const T to_im = (e & 2) ? sign : T(0);
          const Row<T, BT> r = load_row<T, BT>(sre + (e >> 2) * BT);
          const Row<T, BT> x = load_row<T, BT>(b + (e >> 2) * BT);
#pragma unroll
          for (int t = 0; t < BT; ++t) {
            ar[t] += to_re * r.v[t];
            ai[t] += to_im * r.v[t];
            xr[t] += to_re * x.v[t];
            xi[t] += to_im * x.v[t];
          }
        }
        Row<T, BT> o0, o1, o2, o3;
#pragma unroll
        for (int t = 0; t < BT; ++t) {
          o0.v[t] = ar[t];
          o1.v[t] = ai[t];
          o2.v[t] = xr[t];
          o3.v[t] = xi[t];
        }
        store_row<T, BT>(rre + i * BT, o0);
        store_row<T, BT>(rim + i * BT, o1);
        store_row<T, BT>(xre + i * BT, o2);
        store_row<T, BT>(xim + i * BT, o3);
      }
      __syncthreads();

      // S = R rho (complex, d x d, row-major over the vec index); entry (a, e)
      for (int idx = tid; idx < D; idx += kThreads) {
        const int a = idx / d, e = idx % d;
        T accr[BT] = {}, acci[BT] = {};
#pragma unroll 1
        for (int m = 0; m < d; ++m) {
          const Row<T, BT> lr = load_row<T, BT>(rre + (a * d + m) * BT);
          const Row<T, BT> li = load_row<T, BT>(rim + (a * d + m) * BT);
          const Row<T, BT> hr = load_row<T, BT>(xre + (m * d + e) * BT);
          const Row<T, BT> hi = load_row<T, BT>(xim + (m * d + e) * BT);
#pragma unroll
          for (int t = 0; t < BT; ++t) {
            accr[t] += lr.v[t] * hr.v[t] - li.v[t] * hi.v[t];
            acci[t] += lr.v[t] * hi.v[t] + li.v[t] * hr.v[t];
          }
        }
        Row<T, BT> o0, o1;
#pragma unroll
        for (int t = 0; t < BT; ++t) {
          o0.v[t] = accr[t];
          o1.v[t] = acci[t];
        }
        store_row<T, BT>(sre + idx * BT, o0);
        store_row<T, BT>(sim + idx * BT, o1);
      }
      __syncthreads();

      // T = S R into the rho buffer
      for (int idx = tid; idx < D; idx += kThreads) {
        const int a = idx / d, e = idx % d;
        T accr[BT] = {}, acci[BT] = {};
#pragma unroll 1
        for (int m = 0; m < d; ++m) {
          const Row<T, BT> lr = load_row<T, BT>(sre + (a * d + m) * BT);
          const Row<T, BT> li = load_row<T, BT>(sim + (a * d + m) * BT);
          const Row<T, BT> hr = load_row<T, BT>(rre + (m * d + e) * BT);
          const Row<T, BT> hi = load_row<T, BT>(rim + (m * d + e) * BT);
#pragma unroll
          for (int t = 0; t < BT; ++t) {
            accr[t] += lr.v[t] * hr.v[t] - li.v[t] * hi.v[t];
            acci[t] += lr.v[t] * hi.v[t] + li.v[t] * hr.v[t];
          }
        }
        Row<T, BT> o0, o1;
#pragma unroll
        for (int t = 0; t < BT; ++t) {
          o0.v[t] = accr[t];
          o1.v[t] = acci[t];
        }
        store_row<T, BT>(xre + idx * BT, o0);
        store_row<T, BT>(xim + idx * BT, o1);
      }
      __syncthreads();

      // b' = (PTM_re^T vec T_re + PTM_im^T vec T_im) / d, bloch component
      // j: d signed gathers of PTM column j from T_re or T_im
      for (int j = tid; j < D; j += kThreads) {
        T acc[BT] = {};
#pragma unroll 1
        for (int m = 0; m < d; ++m) {
          const int e = __ldg(back + static_cast<size_t>(m) * D + j);
          const T sign = (e & 1) ? T(-1) : T(1);
          const Row<T, BT> x = load_row<T, BT>(((e & 2) ? xim : xre) + (e >> 2) * BT);
#pragma unroll
          for (int t = 0; t < BT; ++t) acc[t] += sign * x.v[t];
        }
        Row<T, BT> o;
#pragma unroll
        for (int t = 0; t < BT; ++t) o.v[t] = acc[t] / T(d);
        store_row<T, BT>(b + j * BT, o);
      }
      __syncthreads();

      // b' /= d b'_0: every thread reads b'_0 before any thread rewrites it
      T norm[BT];
      {
        const Row<T, BT> first = load_row<T, BT>(b);
#pragma unroll
        for (int t = 0; t < BT; ++t) norm[t] = T(d) * first.v[t];
      }
      __syncthreads();
      for (int j = tid; j < D; j += kThreads) {
        Row<T, BT> o = load_row<T, BT>(b + j * BT);
#pragma unroll
        for (int t = 0; t < BT; ++t) o.v[t] /= norm[t];
        store_row<T, BT>(b + j * BT, o);
      }
      __syncthreads();
    }

    for (int idx = tid; idx < D * BT; idx += kThreads) {
      const int t = idx / D, j = idx % D;
      if (b0 + t < B) out[static_cast<size_t>(b0 + t) * D + j] = b[j * BT + t];
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const T* freq, const T* bloch0, const T* w2, const T* w2t,
           const int* fwd, const int* back, T* out, T* scratch, int B, int K,
           int D, int d, int n_iter, int grid, void* stream) {
  constexpr int BT = TileOf<T>::value;
  const size_t smem =
      scratch != nullptr
          ? 0
          : sizeof(T) * BT * (static_cast<size_t>(K) + 7 * static_cast<size_t>(D));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rhor_mle_kernel<T, BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rhor_mle_kernel<T, BT><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      freq, bloch0, w2, w2t, fwd, back, out, scratch, B, K, D, d, n_iter);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Resamples per block for f32 (is_double = 0) or f64 (is_double = 1).
int rhor_mle_tile(int is_double) {
  return is_double ? TileOf<double>::value : TileOf<float>::value;
}

// Largest dynamic shared memory a block may opt into on `device`, in bytes
// (negative: a CUDA error code).
int rhor_mle_smem_limit(int device) {
  int value = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &value, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? value : -static_cast<int>(err);
}

const char* rhor_mle_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Every pointer is a device pointer; `fwd` and `back` are the (d, D) int32
// gather tables of kernels.py::_ptm_gather_tables; `scratch` is null when
// the tile state fits in shared memory. Returns cudaGetLastError() after
// the launch.
int rhor_mle_f32(const float* freq, const float* bloch0, const float* w2,
                 const float* w2t, const int* fwd, const int* back, float* out,
                 float* scratch, int B, int K, int D, int d, int n_iter,
                 int grid, void* stream) {
  return launch<float>(freq, bloch0, w2, w2t, fwd, back, out, scratch, B, K,
                       D, d, n_iter, grid, stream);
}

int rhor_mle_f64(const double* freq, const double* bloch0, const double* w2,
                 const double* w2t, const int* fwd, const int* back,
                 double* out, double* scratch, int B, int K, int D, int d,
                 int n_iter, int grid, void* stream) {
  return launch<double>(freq, bloch0, w2, w2t, fwd, back, out, scratch, B, K,
                        D, d, n_iter, grid, stream);
}

}  // extern "C"
