// K10 — the dense part of a blocked HPF-MAP step: the prior gradients, the
// softplus chain rule, Adam and the step's loss, over every row of both
// tables in one launch.
//
// Replaces: no Pallas kernel.  It stands for the XLA fusion of the step
// body of pmf_tpu/models/hpf_map.py::train_epoch_blocked (its lax.scan
// step: the softplus prep, the frequency-scaled prior gradients, the
// sigmoid chain rule, the log-prior loss and optax Adam), which the
// reference compiles into one device program around its one Pallas
// kernel (K9's counterpart).  The port ran the same arithmetic as some
// thirty eager PyTorch launches a step (ops/map_dense.py::
// map_dense_step_plain, the plain version).
//
// Per row of p = [theta | xi] (users; items [beta | eta] with c, c', d'),
// K+1 columns, with acc the row's K9 sums [sum w * beta | count | sum nll]
// (items without the nll) and s = 1 / count(row) over the whole data:
//   sp      = softplus(p)                  (theta_k, xi)
//   w       = count * s
//   g_k     = acc_k + w * (xi - (a - 1) / theta_k)                  k < K
//   g_K     = w * (-a K / xi + sum_k theta_k - (a' - 1) / xi + b')
//   g       = g * sigmoid(p)                                 (chain rule)
//   mu      = b1 mu + (1 - b1) g,  nu = b2 nu + (1 - b2) g^2
//   p       = p - lr * (mu / c1) / (sqrt(nu / c2) + eps)
//   loss   += nll + w * (sum_k [-a log xi + xi theta_k - (a - 1) log theta_k]
//                        - (a' - 1) log xi + b' xi)
// and it writes softplus(p) of the moved row into sp, the table K9 reads
// at the next step.  Every row moves every step, also a row without a
// rating in the step: its moments decay and it moves by its momentum, as
// optax.adam's dense update.
//
// Rounding: the plain version's.  Each product, sum, quotient and root is
// one correctly rounded operation (__fmul_rn and the rest, so that nvcc
// contracts nothing into an fma), in the plain version's order and type:
// softplus, sigmoid and the prior terms in float32; w, the gradient and
// Adam in the parameters' type T (float or double; T = double promotes
// as PyTorch does, a float32 tensor times a float64 scale).  A tensor over
// a host scalar is the tensor times the scalar's reciprocal (PyTorch's
// CUDA division by a CPU scalar), a host scalar over a tensor the
// tensor's reciprocal times the scalar (Tensor.__rtruediv__).  So a row
// given the same sums and the same row sum of theta moves as the plain
// version moves it, to the bit; the row sums of theta and of the log
// prior are taken in another order (an xor butterfly over the lanes).
//
// What bounds it on an H100: memory.  Per row it reads p, mu, nu (K+1
// values of T each), its K9 row (K+2 or K+1 floats) and its scale, and
// writes p, mu, nu and the softplus row; at K = 20 on the bench's 221,000
// rows that is about 150 MB a step (0.045 ms at 3.35 TB/s), at K = 160
// about 1.14 GB (0.34 ms).  The arithmetic, about 40 operations and five
// transcendental functions an element, is far below the FP32 line.
//
// Design: a group of G lanes a row (G = 8 to K = 31, 16 to 63, 32 past
// it), lane g of a group on columns g, g + G, ... < K (any K >= 1), in one
// pass: each lane moves its columns, which need only the row's xi (every
// lane of the group computes it from p[K]), while it sums theta and the
// log prior of its columns; the group's sums then meet in an xor
// butterfly and its first lane moves the xi column, the only one that
// needs the row sum of theta.  A lane loads kChunk of its columns (p, its
// K9 sum, mu and nu) before it moves any: at K = 20 a group of 8 lanes
// takes a row in one round of loads, four rows a warp, at K = 160 a warp
// in two.  Timed in turns on the bench's steps (scripts/probe_k10.py
// --forms; H100 80GB HBM3, 700 W; PERF.md), K = 20, 50, 128, 160,
// 300: 0.1040, 0.1995, 0.4304, 0.5414, 0.9110 ms a step (44-71% of the
// bytes bound), against 0.1665, 0.2953, 0.5259, 0.6533, 1.1872 for one
// warp a row in two passes over it (11 of 32 lanes idle at K = 20) and
// 0.1384, 0.2900, 0.5933, 0.7283, 1.3208 for this form without the
// chunks (each store kept the next column's loads behind it).
// Blocks of kWarps warps take kRowsABlock rows (slot j of a block's rows
// on warp j % kWarps, the warp's groups on consecutive slots), the user
// rows' blocks first, then the items'.  The loss: each block adds its
// rows' sum (in double; a warp's groups and then its warps summed in a
// fixed order) to its own slot of a float64 array that the caller zeroes
// once a run of steps and sums once after it: no atomics, so a repeat
// gives equal bits.  A row whose count is not 0 (a row K9 stored this
// step) is set back to zeros after it is read, so the accumulators stay
// zero between steps and K9 needs no zero-fill.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps a block
constexpr int kRowsABlock = 32;  // ops/map_dense.py: ROWS_A_BLOCK
constexpr int kChunk = 4;  // columns a lane loads at once
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double quo(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double root(double a) { return __dsqrt_rn(a); }

// torch.logaddexp(x, 0) on the card: max(x, 0) + log1p(exp(-|x - 0|)).
__device__ __forceinline__ float softplus(float x) {
  return add(fmaxf(x, 0.f), log1pf(expf(-fabsf(x))));
}

// torch.sigmoid on the card: 1 / (1 + exp(-x)).
__device__ __forceinline__ float sigmoid(float x) { return quo(1.f, add(1.f, expf(-x))); }

// Sum v over the aligned group of G lanes that holds this lane (every
// lane of the group ends with the same value).
template <int G>
__device__ __forceinline__ float group_sum(float v, unsigned mask) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v = add(v, __shfl_xor_sync(mask, v, off, G));
  return v;
}

// One side's prior scalars, each the float32 of the plain version's
// Python float (a user side's; an item side's with c, c', d').
struct Priors {
  float shape_m1;       // a - 1
  float neg_shape_k;    // -a * K
  float rate_shape_m1;  // a' - 1
  float rate_rate;      // b'
  float neg_shape;      // -a
  float neg_rshape_m1;  // -(a' - 1)
};

template <class T>
struct Side {
  T* p;
  T* mu;
  T* nu;
  float* acc;  // K9's rows, acc_width floats each
  const T* scale;
  float* sp;  // softplus(p) after the step
  int64_t n;
  int acc_width;  // K + 2 (users: the nll) or K + 1
  Priors pr;
};

// Adam's scalars in T, as PyTorch rounds the Python floats of
// ops/adam.py::adam_update for a tensor of T on the card.
template <class T>
struct Adam {
  T b1, one_m_b1, b2, one_m_b2, inv_c1, inv_c2, eps, neg_lr;
};

// One row on the G lanes of a group (``mask``), lane g of them: returns
// its loss (every lane of the group the same value).
template <int G, class T>
__device__ __forceinline__ double dense_row(const Side<T>& s, int64_t row, int g,
                                            unsigned mask, int K, const Adam<T>& ad) {
  const int64_t W = K + 1;
  T* p = s.p + row * W;
  T* mu = s.mu + row * W;
  T* nu = s.nu + row * W;
  float* acc = s.acc + row * s.acc_width;
  float* sp = s.sp + row * W;
  const float count = acc[K];
  const T w = mul(T(count), s.scale[row]);
  const T p_xi = p[K];
  const float xi = softplus(float(p_xi));
  const float log_xi = logf(xi);
  const float lead = mul(s.pr.neg_shape, log_xi);  // -a log xi
  float sum_theta = 0.f, lp = 0.f;
  // kChunk of the lane's columns at a time: their loads all issued before
  // the first store (a store could alias a later load, so nvcc keeps the
  // order it is given).
  for (int k0 = g; k0 < K; k0 += kChunk * G) {
    T pc[kChunk], mc[kChunk], vc[kChunk];
    float ac[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int k = k0 + c * G;
      if (k < K) {
        pc[c] = p[k];
        ac[c] = acc[k];
        mc[c] = mu[k];
        vc[c] = nu[k];
      }
    }
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int k = k0 + c * G;
      if (k >= K) break;
      const float pf = float(pc[c]);
      const float th = softplus(pf);
      sum_theta = add(sum_theta, th);
      lp = add(lp, sub(add(lead, mul(xi, th)), mul(s.pr.shape_m1, logf(th))));
      const float inv = quo(1.f, th);
      T grad = add(T(ac[c]), mul(w, T(sub(xi, mul(inv, s.pr.shape_m1)))));
      grad = mul(grad, T(sigmoid(pf)));
      const T m = add(mul(ad.b1, mc[c]), mul(ad.one_m_b1, grad));
      const T v = add(mul(ad.b2, vc[c]), mul(ad.one_m_b2, mul(grad, grad)));
      const T moved = add(pc[c], mul(ad.neg_lr, quo(mul(m, ad.inv_c1),
                                                     add(root(mul(v, ad.inv_c2)), ad.eps))));
      p[k] = moved;
      mu[k] = m;
      nu[k] = v;
      sp[k] = softplus(float(moved));
    }
  }
  sum_theta = group_sum<G>(sum_theta, mask);
  lp = group_sum<G>(lp, mask);
  if (g == 0) {  // the xi column, which needs the row sum of theta
    const float inv = quo(1.f, xi);
    const float q = add(sub(add(mul(inv, s.pr.neg_shape_k), sum_theta),
                            mul(inv, s.pr.rate_shape_m1)),
                        s.pr.rate_rate);
    const T g_xi = mul(mul(w, T(q)), T(sigmoid(float(p_xi))));
    const T m = add(mul(ad.b1, mu[K]), mul(ad.one_m_b1, g_xi));
    const T v = add(mul(ad.b2, nu[K]), mul(ad.one_m_b2, mul(g_xi, g_xi)));
    const T moved = add(p_xi, mul(ad.neg_lr, quo(mul(m, ad.inv_c1),
                                                  add(root(mul(v, ad.inv_c2)), ad.eps))));
    p[K] = moved;
    mu[K] = m;
    nu[K] = v;
    sp[K] = softplus(float(moved));
  }
  lp = add(lp, add(mul(s.pr.neg_rshape_m1, log_xi), mul(s.pr.rate_rate, xi)));
  double loss = double(mul(w, T(lp)));
  if (s.acc_width > K + 1) loss += double(acc[K + 1]);
  __syncwarp(mask);  // every lane of the group has read the row of acc
  if (count != 0.f)
    for (int k = g; k < s.acc_width; k += G) acc[k] = 0.f;
  return loss;
}

template <int G, class T>
__device__ __forceinline__ double dense_block(const Side<T>& s, int64_t block, int K,
                                              const Adam<T>& ad) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = lane / G, g = lane % G;
  const unsigned mask = G == 32 ? kFull : ((1u << G) - 1) << (group * G);
  double loss = 0.0;
  for (int slot = group; slot < kRowsABlock / kWarps; slot += 32 / G) {
    const int64_t row = block * kRowsABlock + slot * kWarps + warp;
    if (row < s.n) loss += dense_row<G>(s, row, g, mask, K, ad);
  }
  // The warp's groups' sums, each from its first lane, in group order.
  double t = 0.0;
  for (int q = 0; q < 32 / G; ++q) t += __shfl_sync(kFull, loss, q * G);
  return t;
}

template <int G, class T>
__global__ void __launch_bounds__(kWarps * 32)
    map_dense_kernel(Side<T> user, Side<T> item, int64_t user_blocks, int K, Adam<T> ad,
                     double* partials) {
  const int64_t b = blockIdx.x;
  const double loss = b < user_blocks ? dense_block<G>(user, b, K, ad)
                                      : dense_block<G>(item, b - user_blocks, K, ad);
  __shared__ double part[kWarps];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = loss;
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = part[0];
    for (int w = 1; w < kWarps; ++w) t += part[w];
    partials[b] += t;
  }
}

Priors priors_of(const double* v) {
  return Priors{float(v[0]), float(v[1]), float(v[2]), float(v[3]), float(v[4]),
                float(v[5])};
}

template <class T>
int launch(void* p_u, void* mu_u, void* nu_u, float* acc_u, const void* scale_u, float* sp_u,
           int64_t n_u, void* p_i, void* mu_i, void* nu_i, float* acc_i, const void* scale_i,
           float* sp_i, int64_t n_i, int K, const double* priors, double* partials, double lr,
           double c1, double c2, cudaStream_t st) {
  const Side<T> user{static_cast<T*>(p_u), static_cast<T*>(mu_u), static_cast<T*>(nu_u),
                     acc_u, static_cast<const T*>(scale_u), sp_u, n_u, K + 2,
                     priors_of(priors)};
  const Side<T> item{static_cast<T*>(p_i), static_cast<T*>(mu_i), static_cast<T*>(nu_i),
                     acc_i, static_cast<const T*>(scale_i), sp_i, n_i, K + 1,
                     priors_of(priors + 6)};
  // The Python floats of ops/adam.py as PyTorch hands them to a kernel on
  // T: static_cast<T>, and the reciprocal of a divisor taken in T.
  const Adam<T> ad{T(0.9), T(1.0 - 0.9), T(0.999), T(1.0 - 0.999), T(1) / T(c1),
                   T(1) / T(c2), T(1e-8), T(-lr)};
  const int64_t ub = (n_u + kRowsABlock - 1) / kRowsABlock;
  const int64_t ib = (n_i + kRowsABlock - 1) / kRowsABlock;
  if (ub + ib > 0) {
    const unsigned blocks = (unsigned)(ub + ib);
    if (K < 32)
      map_dense_kernel<8, T><<<blocks, kWarps * 32, 0, st>>>(user, item, ub, K, ad, partials);
    else if (K < 64)
      map_dense_kernel<16, T><<<blocks, kWarps * 32, 0, st>>>(user, item, ub, K, ad, partials);
    else
      map_dense_kernel<32, T><<<blocks, kWarps * 32, 0, st>>>(user, item, ub, K, ad, partials);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One step over both tables.  p_*, mu_*, nu_*, scale_*: T = float, or
// double with is_double; acc_u (n_u, K + 2) and acc_i (n_i, K + 1), sp_*
// (n, K + 1) float; priors: 12 host doubles, the user side's (a - 1,
// -a * K, a' - 1, b', -a, -(a' - 1)) then the item side's (c, c', d');
// partials: ceil(n_u / 32) + ceil(n_i / 32) doubles, each block's slot.
// The accumulator rows it reads with a count are left zero.
extern "C" int pmf_map_dense(void* p_u, void* mu_u, void* nu_u, float* acc_u,
                             const void* scale_u, float* sp_u, int64_t n_u, void* p_i,
                             void* mu_i, void* nu_i, float* acc_i, const void* scale_i,
                             float* sp_i, int64_t n_i, int K, int is_double,
                             const double* priors, double* partials, double lr, double c1,
                             double c2, void* stream) {
  if (K < 1 || n_u < 0 || n_i < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double)
    return launch<double>(p_u, mu_u, nu_u, acc_u, scale_u, sp_u, n_u, p_i, mu_i, nu_i, acc_i,
                          scale_i, sp_i, n_i, K, priors, partials, lr, c1, c2, st);
  return launch<float>(p_u, mu_u, nu_u, acc_u, scale_u, sp_u, n_u, p_i, mu_i, nu_i, acc_i,
                       scale_i, sp_i, n_i, K, priors, partials, lr, c1, c2, st);
}
