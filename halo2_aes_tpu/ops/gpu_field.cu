// BN254 field and G1 kernels for the XLA foreign function interface.
//
// One thread per element.  A field element crosses the interface in the
// JAX layout, 16 little-endian 16-bit limbs each held in a uint32 lane
// (ops/field.py); in registers it is 8 32-bit words.  The Montgomery
// radix is R = 2^256 in both, so every result is bit-identical to the
// XLA limb code for canonical inputs.
//
// Built with nvcc for the GPU (the handlers take XLA's CUDA stream) and
// with a host C++ compiler for tests (the same handlers, registered on
// the CPU platform, loop over the elements).  The field constants come
// from the generated header h2a_field_params.h (ops/gpu_field.py).

#include <cstdint>

#include "xla/ffi/api/ffi.h"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#define HD inline
#endif

namespace ffi = xla::ffi;

struct Field {
  uint32_t p[8];
  uint32_t n0;  // -p^-1 mod 2^32
};

#include "h2a_field_params.h"  // H2A_FR, H2A_FQ initializers

static const Field kFields[2] = {H2A_FR, H2A_FQ};

// ---- element arithmetic ---------------------------------------------------

HD void load(const uint32_t* src, uint32_t* w) {
#ifdef __CUDA_ARCH__
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint4 v = s[i];
    w[2 * i] = v.x | (v.y << 16);
    w[2 * i + 1] = v.z | (v.w << 16);
  }
#else
  for (int i = 0; i < 8; ++i) w[i] = src[2 * i] | (src[2 * i + 1] << 16);
#endif
}

HD void store(const uint32_t* w, uint32_t* dst) {
#ifdef __CUDA_ARCH__
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    d[i] = make_uint4(w[2 * i] & 0xFFFFu, w[2 * i] >> 16,
                      w[2 * i + 1] & 0xFFFFu, w[2 * i + 1] >> 16);
#else
  for (int i = 0; i < 8; ++i) {
    dst[2 * i] = w[i] & 0xFFFFu;
    dst[2 * i + 1] = w[i] >> 16;
  }
#endif
}

// r = a - b; returns the borrow out (0 or 1)
HD uint32_t sub_raw(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t d = (uint64_t)a[i] - b[i] - borrow;
    r[i] = (uint32_t)d;
    borrow = d >> 63;
  }
  return (uint32_t)borrow;
}

// r = a + b; returns the carry out (0 or 1)
HD uint32_t add_raw(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += (uint64_t)a[i] + b[i];
    r[i] = (uint32_t)c;
    c >>= 32;
  }
  return (uint32_t)c;
}

// r = t mod p for t < 2p given as 8 words plus a top word
HD void cond_sub_p(uint32_t* r, const uint32_t* t, uint32_t top,
                   const Field& f) {
  uint32_t d[8];
  uint32_t borrow = sub_raw(d, t, f.p);
  bool ge = top || !borrow;
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = ge ? d[i] : t[i];
}

HD void fadd(uint32_t* r, const uint32_t* a, const uint32_t* b,
             const Field& f) {
  uint32_t s[8];
  uint32_t c = add_raw(s, a, b);
  cond_sub_p(r, s, c, f);
}

HD void fsub(uint32_t* r, const uint32_t* a, const uint32_t* b,
             const Field& f) {
  uint32_t d[8], e[8];
  uint32_t borrow = sub_raw(d, a, b);
  add_raw(e, d, f.p);
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = borrow ? e[i] : d[i];
}

HD void fneg(uint32_t* r, const uint32_t* a, const Field& f) {
  uint32_t d[8], nz = 0;
  sub_raw(d, f.p, a);
#pragma unroll
  for (int i = 0; i < 8; ++i) nz |= a[i];
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = nz ? d[i] : 0u;
}

// Montgomery multiply a*b*2^-256 mod p (CIOS, 32-bit words)
HD void fmul(uint32_t* r, const uint32_t* a, const uint32_t* b,
             const Field& f) {
  uint32_t t[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c += (uint64_t)t[j] + (uint64_t)a[j] * b[i];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[8] = (uint32_t)c;
    t[9] = (uint32_t)(c >> 32);
    uint32_t m = t[0] * f.n0;
    c = ((uint64_t)t[0] + (uint64_t)m * f.p[0]) >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      c += (uint64_t)t[j] + (uint64_t)m * f.p[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[7] = (uint32_t)c;
    t[8] = t[9] + (uint32_t)(c >> 32);
  }
  cond_sub_p(r, t, t[8], f);
}

HD void mul_b3(uint32_t* r, const uint32_t* a, const Field& f) {
  uint32_t a2[8], a4[8], a8[8];  // 9a = 8a + a, as in ops/curve.py
  fadd(a2, a, a, f);
  fadd(a4, a2, a2, f);
  fadd(a8, a4, a4, f);
  fadd(r, a8, a, f);
}

// Renes-Costello-Batina complete addition (a = 0, b3 = 9), the same
// dataflow as ops/curve.py add
HD void g1_add(uint32_t* X3, uint32_t* Y3, uint32_t* Z3, const uint32_t* X1,
               const uint32_t* Y1, const uint32_t* Z1, const uint32_t* X2,
               const uint32_t* Y2, const uint32_t* Z2, const Field& f) {
  uint32_t t0[8], t1[8], t2[8], u[8], v[8], t3[8], t4[8], xz[8];
  fmul(t0, X1, X2, f);
  fmul(t1, Y1, Y2, f);
  fmul(t2, Z1, Z2, f);
  fadd(u, X1, Y1, f);
  fadd(v, X2, Y2, f);
  fmul(t3, u, v, f);
  fsub(t3, t3, t0, f);
  fsub(t3, t3, t1, f);  // X1Y2 + X2Y1
  fadd(u, Y1, Z1, f);
  fadd(v, Y2, Z2, f);
  fmul(t4, u, v, f);
  fsub(t4, t4, t1, f);
  fsub(t4, t4, t2, f);  // Y1Z2 + Y2Z1
  fadd(u, X1, Z1, f);
  fadd(v, X2, Z2, f);
  fmul(xz, u, v, f);
  fsub(xz, xz, t0, f);
  fsub(xz, xz, t2, f);  // X1Z2 + X2Z1
  uint32_t t0_3[8], t2b[8], z3t[8], t1m[8], y3b[8];
  fadd(t0_3, t0, t0, f);
  fadd(t0_3, t0_3, t0, f);
  mul_b3(t2b, t2, f);
  fadd(z3t, t1, t2b, f);
  fsub(t1m, t1, t2b, f);
  mul_b3(y3b, xz, f);
  fmul(u, t4, y3b, f);   // X3a
  fmul(v, t3, t1m, f);   // X3b
  fsub(X3, v, u, f);
  fmul(u, y3b, t0_3, f);  // Y3a
  fmul(v, t1m, z3t, f);   // Y3b
  fadd(Y3, v, u, f);
  fmul(u, z3t, t4, f);    // Z3a
  fmul(v, t0_3, t3, f);   // Z3b
  fadd(Z3, u, v, f);
}

// RCB complete doubling (a = 0, b3 = 9), as ops/curve.py double
HD void g1_double(uint32_t* X3, uint32_t* Y3, uint32_t* Z3,
                  const uint32_t* X, const uint32_t* Y, const uint32_t* Z,
                  const Field& f) {
  uint32_t t0[8], t1[8], t2[8], t3[8], z8[8], t2b[8], y3s[8], t0m[8];
  fmul(t0, Y, Y, f);
  fmul(t1, Y, Z, f);
  fmul(t2, Z, Z, f);
  fmul(t3, X, Y, f);
  fadd(z8, t0, t0, f);
  fadd(z8, z8, z8, f);
  fadd(z8, z8, z8, f);  // 8 Y^2
  mul_b3(t2b, t2, f);
  fadd(y3s, t0, t2b, f);
  uint32_t t2b3[8];
  fadd(t2b3, t2b, t2b, f);
  fadd(t2b3, t2b3, t2b, f);
  fsub(t0m, t0, t2b3, f);
  uint32_t x3a[8], y3a[8], x3b[8];
  fmul(x3a, t2b, z8, f);
  fmul(Z3, t1, z8, f);
  fmul(y3a, t0m, y3s, f);
  fmul(x3b, t0m, t3, f);
  fadd(Y3, x3a, y3a, f);
  fadd(X3, x3b, x3b, f);
}

// ---- element-wise operators -----------------------------------------------

enum BinaryOp : int32_t { kMul = 0, kAdd = 1, kSub = 2 };

struct BinaryFn {
  const uint32_t* a;
  const uint32_t* b;
  uint32_t* o;
  Field f;
  int32_t op;
  HD void operator()(int64_t i) const {
    uint32_t x[8], y[8], r[8];
    load(a + 16 * i, x);
    load(b + 16 * i, y);
    if (op == kMul) fmul(r, x, y, f);
    else if (op == kAdd) fadd(r, x, y, f);
    else fsub(r, x, y, f);
    store(r, o + 16 * i);
  }
};

struct NegFn {
  const uint32_t* a;
  uint32_t* o;
  Field f;
  HD void operator()(int64_t i) const {
    uint32_t x[8], r[8];
    load(a + 16 * i, x);
    fneg(r, x, f);
    store(r, o + 16 * i);
  }
};

struct G1AddFn {
  const uint32_t *x1, *y1, *z1, *x2, *y2, *z2;
  uint32_t *x3, *y3, *z3;
  Field f;
  HD void operator()(int64_t i) const {
    uint32_t X1[8], Y1[8], Z1[8], X2[8], Y2[8], Z2[8], X3[8], Y3[8], Z3[8];
    load(x1 + 16 * i, X1);
    load(y1 + 16 * i, Y1);
    load(z1 + 16 * i, Z1);
    load(x2 + 16 * i, X2);
    load(y2 + 16 * i, Y2);
    load(z2 + 16 * i, Z2);
    g1_add(X3, Y3, Z3, X1, Y1, Z1, X2, Y2, Z2, f);
    store(X3, x3 + 16 * i);
    store(Y3, y3 + 16 * i);
    store(Z3, z3 + 16 * i);
  }
};

struct G1DoubleFn {
  const uint32_t *x, *y, *z;
  uint32_t *x3, *y3, *z3;
  Field f;
  HD void operator()(int64_t i) const {
    uint32_t X[8], Y[8], Z[8], X3[8], Y3[8], Z3[8];
    load(x + 16 * i, X);
    load(y + 16 * i, Y);
    load(z + 16 * i, Z);
    g1_double(X3, Y3, Z3, X, Y, Z, f);
    store(X3, x3 + 16 * i);
    store(Y3, y3 + 16 * i);
    store(Z3, z3 + 16 * i);
  }
};

// ---- launch: a grid on the GPU, a loop on the host -------------------------

#ifdef __CUDACC__
using Stream = cudaStream_t;

template <class Fn>
__global__ void each_element(int64_t n, Fn fn) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) fn(i);
}

template <class Fn>
static ffi::Error launch(Stream s, int64_t n, const Fn& fn) {
  if (n == 0) return ffi::Error::Success();
  const int threads = 128;
  each_element<<<(unsigned)((n + threads - 1) / threads), threads, 0, s>>>(
      n, fn);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(e));
  return ffi::Error::Success();
}

#define H2A_STREAM_PARAM Stream stream,
#define H2A_BIND ffi::Ffi::Bind().Ctx<ffi::PlatformStream<cudaStream_t>>()
#else
struct Stream {};
static const Stream stream{};

template <class Fn>
static ffi::Error launch(Stream, int64_t n, const Fn& fn) {
  for (int64_t i = 0; i < n; ++i) fn(i);
  return ffi::Error::Success();
}

#define H2A_STREAM_PARAM
#define H2A_BIND ffi::Ffi::Bind()
#endif

using U32 = ffi::Buffer<ffi::U32>;
using U32Out = ffi::ResultBuffer<ffi::U32>;

static int64_t rows(const U32& a) { return (int64_t)a.element_count() / 16; }

static ffi::Error check(int32_t field, std::initializer_list<int64_t> sizes) {
  if (field < 0 || field > 1)
    return ffi::Error::InvalidArgument("h2a: field must be 0 (Fr) or 1 (Fq)");
  int64_t n = *sizes.begin();
  for (int64_t s : sizes)
    if (s != n) return ffi::Error::InvalidArgument("h2a: operand sizes differ");
  return ffi::Error::Success();
}

static ffi::Error FieldBinary(H2A_STREAM_PARAM int32_t field, int32_t op,
                              U32 a, U32 b, U32Out o) {
  ffi::Error e = check(field, {rows(a), rows(b), (int64_t)o->element_count() / 16});
  if (e.failure()) return e;
  if (op < kMul || op > kSub)
    return ffi::Error::InvalidArgument("h2a: unknown binary op");
  return launch(stream, rows(a),
                BinaryFn{a.typed_data(), b.typed_data(), o->typed_data(),
                         kFields[field], op});
}

static ffi::Error FieldNeg(H2A_STREAM_PARAM int32_t field, U32 a, U32Out o) {
  ffi::Error e = check(field, {rows(a), (int64_t)o->element_count() / 16});
  if (e.failure()) return e;
  return launch(stream, rows(a),
                NegFn{a.typed_data(), o->typed_data(), kFields[field]});
}

static ffi::Error G1Add(H2A_STREAM_PARAM U32 x1, U32 y1, U32 z1, U32 x2,
                        U32 y2, U32 z2, U32Out x3, U32Out y3, U32Out z3) {
  ffi::Error e = check(1, {rows(x1), rows(y1), rows(z1), rows(x2), rows(y2),
                           rows(z2), (int64_t)x3->element_count() / 16});
  if (e.failure()) return e;
  return launch(stream, rows(x1),
                G1AddFn{x1.typed_data(), y1.typed_data(), z1.typed_data(),
                        x2.typed_data(), y2.typed_data(), z2.typed_data(),
                        x3->typed_data(), y3->typed_data(), z3->typed_data(),
                        kFields[1]});
}

static ffi::Error G1Double(H2A_STREAM_PARAM U32 x, U32 y, U32 z, U32Out x3,
                           U32Out y3, U32Out z3) {
  ffi::Error e = check(1, {rows(x), rows(y), rows(z),
                           (int64_t)x3->element_count() / 16});
  if (e.failure()) return e;
  return launch(stream, rows(x),
                G1DoubleFn{x.typed_data(), y.typed_data(), z.typed_data(),
                           x3->typed_data(), y3->typed_data(),
                           z3->typed_data(), kFields[1]});
}

XLA_FFI_DEFINE_HANDLER_SYMBOL(H2aFieldBinary, FieldBinary,
                              H2A_BIND.Attr<int32_t>("field")
                                  .Attr<int32_t>("op")
                                  .Arg<U32>()
                                  .Arg<U32>()
                                  .Ret<ffi::Buffer<ffi::U32>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(H2aFieldNeg, FieldNeg,
                              H2A_BIND.Attr<int32_t>("field")
                                  .Arg<U32>()
                                  .Ret<ffi::Buffer<ffi::U32>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(H2aG1Add, G1Add,
                              H2A_BIND.Arg<U32>()
                                  .Arg<U32>()
                                  .Arg<U32>()
                                  .Arg<U32>()
                                  .Arg<U32>()
                                  .Arg<U32>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(H2aG1Double, G1Double,
                              H2A_BIND.Arg<U32>()
                                  .Arg<U32>()
                                  .Arg<U32>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>());
