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
//   R, rho = PTM(r), PTM(b)       (four D x D maps: real and imaginary parts
//                                  of the transposed d x d matrices)
//   S = R rho, T = S R            (two complex d x d products)
//   b' = (PTM_re^T vec T_re + PTM_im^T vec T_im) / d,  b' /= d b'_0
//
// What bounds it on this card. At the flagship size (n = 4: K = 1296,
// D = 256, d = 16) one resample-iteration is 2 K D = 663,552 MACs for the two
// POVM products, 6 D^2 = 393,216 MACs for the six PTM maps and 8 d^3 = 32,768
// MACs for the sandwich (four real products per complex product, no
// Karatsuba). A 16,384-resample call of 60 iterations is therefore about
// 2.1 TFLOP: compute-bound, dominated by the POVM and PTM products. The
// matrices (w2 and its transpose, 1.33 MB each in f32; four PTM parts,
// 256 KB each) are the same for every resample, so they stay resident in the
// 50 MB L2 and every block streams them from there; each value read from L2
// feeds BT multiply-adds, one per resample of the tile.
//
// What the design does about it. One block of 256 threads owns a tile of BT
// resamples (BT = 32 bytes / sizeof(T): 8 in f32, 4 in f64) and runs all
// iterations in a loop. The tile's state (b, c, R, rho/T, r/S; K + 7 D rows
// of BT values) lives in shared memory, stored resample-minor so that one
// 32-byte vector load fetches a row for the whole tile and every thread
// keeps BT accumulators in registers. Each stage gives every thread whole
// output rows, reads the matrices coalesced (the transposed copies are
// passed in for that) and ends at __syncthreads(). Arithmetic is plain
// FP32/FP64 FMA on the CUDA cores: no tensor cores and no TF32. When the
// state does not fit in shared memory (n >= 5), the caller passes a global
// scratch buffer of gridDim.x tiles instead and the same code runs through
// generic pointers. The ragged tail of the batch is masked: its rows read
// the last resample's inputs and are never stored.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;

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

template <typename T, int BT>
__global__ void __launch_bounds__(kThreads)
rhor_mle_kernel(const T* __restrict__ freq,      // (B, K)
                const T* __restrict__ bloch0,    // (B, D)
                const T* __restrict__ w2,        // (K, D)
                const T* __restrict__ w2t,       // (D, K)
                const T* __restrict__ ptm_re,    // (D, D)
                const T* __restrict__ ptm_im,    // (D, D)
                const T* __restrict__ ptm_re_t,  // (D, D)
                const T* __restrict__ ptm_im_t,  // (D, D)
                T* __restrict__ out,             // (B, D)
                T* __restrict__ scratch,         // null, or gridDim.x tiles
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

  const T eps = T(1e-10);
  const int tid = threadIdx.x;
  const int n_tiles = (B + BT - 1) / BT;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b0 = tile * BT;
    for (int idx = tid; idx < D * BT; idx += kThreads) {
      const int t = idx / D, j = idx % D;
      const int row = min(b0 + t, B - 1);
      b[j * BT + t] = bloch0[static_cast<size_t>(row) * D + j];
    }
    __syncthreads();

    for (int it = 0; it < n_iter; ++it) {
      // p = w2 b and c = f / max(p, eps); thread owns POVM rows k
      for (int k = tid; k < K; k += kThreads) {
        T acc[BT] = {};
#pragma unroll 4
        for (int j = 0; j < D; ++j) {
          const T w = __ldg(w2t + static_cast<size_t>(j) * K + k);
          const Row<T, BT> x = load_row<T, BT>(b + j * BT);
#pragma unroll
          for (int t = 0; t < BT; ++t) acc[t] += w * x.v[t];
        }
        Row<T, BT> cr;
#pragma unroll
        for (int t = 0; t < BT; ++t) {
          const int row = min(b0 + t, B - 1);
          const T p = acc[t] < eps ? eps : acc[t];
          cr.v[t] = __ldg(freq + static_cast<size_t>(row) * K + k) / p;
        }
        store_row<T, BT>(c + static_cast<size_t>(k) * BT, cr);
      }
      __syncthreads();

      // r = w2^T c into the S buffer; thread owns bloch components j
      for (int j = tid; j < D; j += kThreads) {
        T acc[BT] = {};
#pragma unroll 4
        for (int k = 0; k < K; ++k) {
          const T w = __ldg(w2 + static_cast<size_t>(k) * D + j);
          const Row<T, BT> x = load_row<T, BT>(c + static_cast<size_t>(k) * BT);
#pragma unroll
          for (int t = 0; t < BT; ++t) acc[t] += w * x.v[t];
        }
        Row<T, BT> rr;
#pragma unroll
        for (int t = 0; t < BT; ++t) rr.v[t] = acc[t];
        store_row<T, BT>(sre + j * BT, rr);
      }
      __syncthreads();

      // R = PTM r and rho = PTM b (real and imaginary parts); vec index i
      for (int i = tid; i < D; i += kThreads) {
        T ar[BT] = {}, ai[BT] = {}, xr[BT] = {}, xi[BT] = {};
#pragma unroll 2
        for (int j = 0; j < D; ++j) {
          const T pr = __ldg(ptm_re_t + static_cast<size_t>(j) * D + i);
          const T pi = __ldg(ptm_im_t + static_cast<size_t>(j) * D + i);
          const Row<T, BT> r = load_row<T, BT>(sre + j * BT);
          const Row<T, BT> x = load_row<T, BT>(b + j * BT);
#pragma unroll
          for (int t = 0; t < BT; ++t) {
            ar[t] += pr * r.v[t];
            ai[t] += pi * r.v[t];
            xr[t] += pr * x.v[t];
            xi[t] += pi * x.v[t];
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

      // b' = (PTM_re^T vec T_re + PTM_im^T vec T_im) / d; bloch component j
      for (int j = tid; j < D; j += kThreads) {
        T acc[BT] = {};
#pragma unroll 2
        for (int i = 0; i < D; ++i) {
          const T pr = __ldg(ptm_re + static_cast<size_t>(i) * D + j);
          const T pi = __ldg(ptm_im + static_cast<size_t>(i) * D + j);
          const Row<T, BT> tr = load_row<T, BT>(xre + i * BT);
          const Row<T, BT> ti = load_row<T, BT>(xim + i * BT);
#pragma unroll
          for (int t = 0; t < BT; ++t) acc[t] += pr * tr.v[t] + pi * ti.v[t];
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
           const T* ptm_re, const T* ptm_im, const T* ptm_re_t,
           const T* ptm_im_t, T* out, T* scratch, int B, int K, int D, int d,
           int n_iter, int grid, void* stream) {
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
      freq, bloch0, w2, w2t, ptm_re, ptm_im, ptm_re_t, ptm_im_t, out, scratch,
      B, K, D, d, n_iter);
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

// Every pointer is a device pointer; `scratch` is null when the tile state
// fits in shared memory. Returns cudaGetLastError() after the launch.
int rhor_mle_f32(const float* freq, const float* bloch0, const float* w2,
                 const float* w2t, const float* ptm_re, const float* ptm_im,
                 const float* ptm_re_t, const float* ptm_im_t, float* out,
                 float* scratch, int B, int K, int D, int d, int n_iter,
                 int grid, void* stream) {
  return launch<float>(freq, bloch0, w2, w2t, ptm_re, ptm_im, ptm_re_t,
                       ptm_im_t, out, scratch, B, K, D, d, n_iter, grid, stream);
}

int rhor_mle_f64(const double* freq, const double* bloch0, const double* w2,
                 const double* w2t, const double* ptm_re, const double* ptm_im,
                 const double* ptm_re_t, const double* ptm_im_t, double* out,
                 double* scratch, int B, int K, int D, int d, int n_iter,
                 int grid, void* stream) {
  return launch<double>(freq, bloch0, w2, w2t, ptm_re, ptm_im, ptm_re_t,
                        ptm_im_t, out, scratch, B, K, D, d, n_iter, grid, stream);
}

}  // extern "C"
