// The shading of a march's rays, written once for every kernel that shades
// them: the lattice hash, value noise and fbm, the polynomial atan2, the
// blackbody ramp, the Cunningham g-factor, the Novikov-Thorne profile and
// its _powi plans, the disk's two slot branches (analytic, Chebyshev
// spectral), the u-chart escape direction, the starfield and the
// photon-ring glow. The render kernel (csrc/render.cu) shades its pixels
// with them, the composite kernels (csrc/composite.cu) the staged rows, and
// the jets of the march and gradient kernels take the lattice hash and the
// value noise (csrc/march_step.cuh, csrc/march_adjoint.cuh). Each is
// generic over the number type Dual<T, D>: D = 0 is a plain value (the
// render kernel, the composite's forward), D > 0 carries D tangents (the
// composite's VJP differentiates a stage forward along its inputs).
// ops/composite.py holds the same functions in plain PyTorch, line for
// line, and render/shading.py the plain versions whose values they
// reproduce; ops/shade.py forms their numbers (DiskArgsT, StarArgsT) for
// every kernel.
// Everything here is in the namespace shade: march_step.cuh has a Dual and
// a K of its own.
//
// Rounding: every sum, difference, product and quotient is one explicit
// IEEE operation (op_add and its kin: __fadd_rn and the like, never
// contracted), in the plain version's order and with its operands in its
// places. A Python number meets a row rounded to the row's dtype; a
// tensor times a number is x * T(c), a number over a tensor is
// reciprocal(x) * T(c), as PyTorch computes them on the card. sqrt (see
// sqrt_), sin and cos round as _elementwise's by way of double; exp, log
// and pow are the dtype's library functions, as torch.exp, torch.log and
// torch.pow call them. The includers build with different flags
// (ops/build.py): render.cu, march.cu and march_grad.cu with --fmad=false,
// which their march steps need; composite.cu with nvcc's default
// --fmad=true (FMAD_SOURCES), under which the library functions contract
// as PyTorch's build of them does. The explicit operations round alike
// under either flag, so each includer gets from these functions the bits
// it got from a copy of its own, and the library functions round in each
// as its flag has them. The hashes make this mandatory: a last-bit
// difference moves a star.
//
// The tangents follow autograd's local derivatives and its conventions:
// maximum and minimum (so clip) split a tie evenly, where routes, floor
// and the hashes give none, remainder passes the tangent whole, abs has
// none at 0; a zero tangent stays zero through a factor that may be
// infinite (mulz), as autograd's routed zeros never meet it. A quotient's
// tangents multiply by one reciprocal, and sqrt's by 0.5 / sqrt(x): within
// an ulp of autograd's own quotients.

#pragma once

#ifndef BH_D
#define BH_D __device__ __forceinline__
#endif

namespace shade {

// ---------------------------------------------------------------------------
// Explicit IEEE operations and the library functions PyTorch calls
// ---------------------------------------------------------------------------

BH_D float op_add(float a, float b) { return __fadd_rn(a, b); }
BH_D double op_add(double a, double b) { return __dadd_rn(a, b); }
BH_D float op_sub(float a, float b) { return __fsub_rn(a, b); }
BH_D double op_sub(double a, double b) { return __dsub_rn(a, b); }
BH_D float op_mul(float a, float b) { return __fmul_rn(a, b); }
BH_D double op_mul(double a, double b) { return __dmul_rn(a, b); }
BH_D float op_div(float a, float b) { return __fdiv_rn(a, b); }
BH_D double op_div(double a, double b) { return __ddiv_rn(a, b); }
BH_D float lib_exp(float x) { return expf(x); }
BH_D double lib_exp(double x) { return exp(x); }
BH_D float lib_log(float x) { return logf(x); }
BH_D double lib_log(double x) { return log(x); }
BH_D float lib_pow(float x, float p) { return powf(x, p); }
BH_D double lib_pow(double x, double p) { return pow(x, p); }
BH_D float lib_floor(float x) { return floorf(x); }
BH_D double lib_floor(double x) { return floor(x); }
BH_D float lib_fmod(float x, float y) { return fmodf(x, y); }
BH_D double lib_fmod(double x, double y) { return fmod(x, y); }
BH_D float lib_max(float a, float b) { return fmaxf(a, b); }
BH_D double lib_max(double a, double b) { return fmax(a, b); }
BH_D float lib_min(float a, float b) { return fminf(a, b); }
BH_D double lib_min(double a, double b) { return fmin(a, b); }

// torch.maximum / torch.minimum on the card: a NaN operand is the result.
template <typename T> BH_D T vmax(T a, T b) {
  return a != a ? a : (b != b ? b : lib_max(a, b));
}
template <typename T> BH_D T vmin(T a, T b) {
  return a != a ? a : (b != b ? b : lib_min(a, b));
}

// torch.pow(v, p)'s routes for a Python number p (ops/tonemap.py::pow_route;
// the wrapper chooses one where an exponent comes from the scene). PyTorch
// forms INV_SQUARE's quotient in double, which rounded to float is float's
// own quotient (53 >= 2 x 24 + 2 bits: the double rounding is innocuous).
enum PowRoute { POW, FILL_ONE, COPY, SQRT, RSQRT, RECIPROCAL, SQUARE, CUBE,
                INV_SQUARE };

template <typename T> BH_D T pow_by(T v, double p, int route) {
  switch (route) {
    case RECIPROCAL: return op_div(T(1), v);
    case SQUARE: return op_mul(v, v);
    case CUBE: return op_mul(op_mul(v, v), v);
    case INV_SQUARE: return op_div(T(1), op_mul(v, v));
    default: return lib_pow(v, T(p));
  }
}

// ---------------------------------------------------------------------------
// Dual numbers
// ---------------------------------------------------------------------------

template <typename T, int D> struct Dual { T v; T d[D]; };
template <typename T> struct Dual<T, 0> { T v; };

template <int A, int B> struct DMax { static constexpr int v = A > B ? A : B; };

// A constant: a Python number rounded to T.
template <typename T> BH_D Dual<T, 0> K(double c) { return Dual<T, 0>{T(c)}; }
template <typename T> BH_D Dual<T, 0> val(T v) { return Dual<T, 0>{v}; }

// ``v`` along direction ``i`` of D (D > 0), or as a plain value.
template <typename T, int D> BH_D Dual<T, D> seed(T v, int i) {
  Dual<T, D> r;
  r.v = v;
  if constexpr (D > 0) {
#pragma unroll
    for (int j = 0; j < D; ++j) r.d[j] = T(j == i ? 1 : 0);
  }
  return r;
}
template <typename T, int D> BH_D Dual<T, D> lift(T v) { return seed<T, D>(v, -1); }
template <typename T, int D, int A> BH_D Dual<T, D> lift(const Dual<T, A>& x) {
  static_assert(A == D || A == 0, "tangents of another stage");
  if constexpr (A == D) return x;
  else return lift<T, D>(x.v);
}

template <typename T> BH_D T mulz(T d, T f) { return d == T(0) ? T(0) : op_mul(d, f); }

#define BH_DUAL_BINARY(NAME, BOTH, ONLY_X, ONLY_Y, VALUE)                     \
  template <typename T, int A, int B>                                         \
  BH_D Dual<T, DMax<A, B>::v> NAME(const Dual<T, A>& x, const Dual<T, B>& y) { \
    static_assert(A == B || A == 0 || B == 0, "mixed tangents");              \
    constexpr int R = DMax<A, B>::v;                                          \
    Dual<T, R> r;                                                             \
    r.v = VALUE;                                                              \
    if constexpr (A > 0 && B > 0) {                                           \
      _Pragma("unroll") for (int i = 0; i < R; ++i) r.d[i] = BOTH;            \
    } else if constexpr (A > 0) {                                             \
      _Pragma("unroll") for (int i = 0; i < R; ++i) r.d[i] = ONLY_X;          \
    } else if constexpr (B > 0) {                                             \
      _Pragma("unroll") for (int i = 0; i < R; ++i) r.d[i] = ONLY_Y;          \
    }                                                                         \
    return r;                                                                 \
  }

BH_DUAL_BINARY(operator+, op_add(x.d[i], y.d[i]), x.d[i], y.d[i],
               op_add(x.v, y.v))
BH_DUAL_BINARY(operator-, op_sub(x.d[i], y.d[i]), x.d[i], -y.d[i],
               op_sub(x.v, y.v))
BH_DUAL_BINARY(operator*, op_add(op_mul(x.d[i], y.v), op_mul(y.d[i], x.v)),
               op_mul(x.d[i], y.v), op_mul(y.d[i], x.v), op_mul(x.v, y.v))
#undef BH_DUAL_BINARY

// x / y of two rows (a tensor divided by a tensor: an exact quotient);
// the tangents through one reciprocal of y.
template <typename T, int A, int B>
BH_D Dual<T, DMax<A, B>::v> operator/(const Dual<T, A>& x, const Dual<T, B>& y) {
  static_assert(A == B || A == 0 || B == 0, "mixed tangents");
  constexpr int R = DMax<A, B>::v;
  Dual<T, R> r;
  r.v = op_div(x.v, y.v);
  if constexpr (R > 0) {
    const T ry = op_div(T(1), y.v);
    T qy = T(0);
    if constexpr (B > 0) qy = op_mul(r.v, ry);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if constexpr (A > 0 && B > 0)
        r.d[i] = op_sub(mulz(x.d[i], ry), mulz(y.d[i], qy));
      else if constexpr (A > 0)
        r.d[i] = mulz(x.d[i], ry);
      else
        r.d[i] = -mulz(y.d[i], qy);
    }
  }
  return r;
}

template <typename T, int A> BH_D Dual<T, A> operator-(const Dual<T, A>& x) {
  Dual<T, A> r;
  r.v = -x.v;
  if constexpr (A > 0) {
#pragma unroll
    for (int i = 0; i < A; ++i) r.d[i] = -x.d[i];
  }
  return r;
}

// A row and a Python number.
template <typename T, int A> BH_D Dual<T, A> operator+(const Dual<T, A>& x, double c) { return x + K<T>(c); }
template <typename T, int A> BH_D Dual<T, A> operator+(double c, const Dual<T, A>& x) { return K<T>(c) + x; }
template <typename T, int A> BH_D Dual<T, A> operator-(const Dual<T, A>& x, double c) { return x - K<T>(c); }
template <typename T, int A> BH_D Dual<T, A> operator-(double c, const Dual<T, A>& x) { return K<T>(c) - x; }
template <typename T, int A> BH_D Dual<T, A> operator*(const Dual<T, A>& x, double c) { return x * K<T>(c); }
template <typename T, int A> BH_D Dual<T, A> operator*(double c, const Dual<T, A>& x) { return K<T>(c) * x; }

// c / x for a Python number c: PyTorch's reciprocal(x) * c.
template <typename T, int A> BH_D Dual<T, A> operator/(double c, const Dual<T, A>& x) {
  Dual<T, A> r;
  const T rec = op_div(T(1), x.v);
  r.v = op_mul(rec, T(c));
  if constexpr (A > 0) {
    const T rr = op_mul(rec, rec);
#pragma unroll
    for (int i = 0; i < A; ++i) r.d[i] = op_mul(-mulz(x.d[i], rr), T(c));
  }
  return r;
}

// x / c with c rounded to T, divided exactly (_elementwise.div_c).
template <typename T, int A> BH_D Dual<T, A> div_c(const Dual<T, A>& x, double c) {
  Dual<T, A> r;
  r.v = op_div(x.v, T(c));
  if constexpr (A > 0) {
    const T rc = T(1.0 / c);
#pragma unroll
    for (int i = 0; i < A; ++i) r.d[i] = op_mul(x.d[i], rc);
  }
  return r;
}

// maximum / minimum: half each at a tie, the taken side's tangent
// elsewhere, both where neither is taken (a NaN).
template <typename T, int A, int B>
BH_D Dual<T, DMax<A, B>::v> minmax_(const Dual<T, A>& x, const Dual<T, B>& y,
                                    T v, bool take_x, bool take_y) {
  constexpr int R = DMax<A, B>::v;
  Dual<T, R> r;
  r.v = v;
  if constexpr (R > 0) {
    const bool eq = x.v == y.v;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      T zx = T(0), zy = T(0);
      if constexpr (A > 0) zx = x.d[i];
      if constexpr (B > 0) zy = y.d[i];
      r.d[i] = eq ? op_add(op_mul(T(0.5), zx), op_mul(T(0.5), zy))
                  : (take_x ? zx : (take_y ? zy : op_add(zx, zy)));
    }
  }
  return r;
}
template <typename T, int A, int B>
BH_D Dual<T, DMax<A, B>::v> maximum(const Dual<T, A>& x, const Dual<T, B>& y) {
  return minmax_(x, y, vmax(x.v, y.v), x.v > y.v, x.v < y.v);
}
template <typename T, int A, int B>
BH_D Dual<T, DMax<A, B>::v> minimum(const Dual<T, A>& x, const Dual<T, B>& y) {
  return minmax_(x, y, vmin(x.v, y.v), x.v < y.v, x.v > y.v);
}
template <typename T, int A> BH_D Dual<T, A> maximum(const Dual<T, A>& x, double c) { return maximum(x, K<T>(c)); }
template <typename T, int A> BH_D Dual<T, A> clip(const Dual<T, A>& x, double lo, double hi) {
  return minimum(maximum(x, K<T>(lo)), K<T>(hi));
}

template <typename T, int A, int B>
BH_D Dual<T, DMax<A, B>::v> where(bool c, const Dual<T, A>& x, const Dual<T, B>& y) {
  constexpr int R = DMax<A, B>::v;
  return c ? lift<T, R>(x) : lift<T, R>(y);
}
template <typename T, int A> BH_D Dual<T, A> where(bool c, const Dual<T, A>& x, double y) { return where(c, x, K<T>(y)); }
template <typename T, int A> BH_D Dual<T, A> where(bool c, double x, const Dual<T, A>& y) { return where(c, K<T>(x), y); }

// _elementwise.sqrt: by way of double, whose sqrt rounded to float is
// float's own correctly rounded sqrt (53 >= 2 x 24 + 2 bits: the double
// rounding is innocuous), so float takes __fsqrt_rn. The tangent is dx
// times 0.5 / sqrt(x) formed in double and rounded to T once (the 0-d
// sums of mass and spin cancel, and a factor formed in float moved them
// 3x further from autograd's, which works in double here).
BH_D float sqrt_rn(float x) { return __fsqrt_rn(x); }
BH_D double sqrt_rn(double x) { return __dsqrt_rn(x); }
template <typename T, int A> BH_D Dual<T, A> sqrt_(const Dual<T, A>& x) {
  Dual<T, A> r;
  r.v = sqrt_rn(x.v);
  if constexpr (A > 0) {
    const T f = T(__ddiv_rn(0.5, __dsqrt_rn(double(x.v))));
#pragma unroll
    for (int i = 0; i < A; ++i) r.d[i] = mulz(x.d[i], f);
  }
  return r;
}

template <typename T, int A> BH_D Dual<T, A> sin_(const Dual<T, A>& x) {
  const double xd = double(x.v);
  Dual<T, A> r;
  r.v = T(sin(xd));
  if constexpr (A > 0) {
    const T c = T(cos(xd));
#pragma unroll
    for (int i = 0; i < A; ++i) r.d[i] = op_mul(x.d[i], c);
  }
  return r;
}

template <typename T, int A> BH_D Dual<T, A> cos_(const Dual<T, A>& x) {
  const double xd = double(x.v);
  Dual<T, A> r;
  r.v = T(cos(xd));
  if constexpr (A > 0) {
    const T s = T(-sin(xd));
#pragma unroll
    for (int i = 0; i < A; ++i) r.d[i] = op_mul(x.d[i], s);
  }
  return r;
}

// torch.exp / torch.log in the row's dtype.
template <typename T, int A> BH_D Dual<T, A> exp_(const Dual<T, A>& x) {
  Dual<T, A> r;
  r.v = lib_exp(x.v);
  if constexpr (A > 0) {
#pragma unroll
    for (int i = 0; i < A; ++i) r.d[i] = mulz(x.d[i], r.v);
  }
  return r;
}
template <typename T, int A> BH_D Dual<T, A> log_(const Dual<T, A>& x) {
  Dual<T, A> r;
  r.v = lib_log(x.v);
  if constexpr (A > 0) {
    const T rx = op_div(T(1), x.v);
#pragma unroll
    for (int i = 0; i < A; ++i) r.d[i] = mulz(x.d[i], rx);
  }
  return r;
}

// torch.pow(x, p) by ``route``, with autograd's derivative p * x ** (p - 1)
// (x ** (p - 1) by ``route_m1``).
template <typename T, int A>
BH_D Dual<T, A> pow_(const Dual<T, A>& x, double p, int route = POW,
                     int route_m1 = POW) {
  Dual<T, A> r;
  r.v = pow_by(x.v, p, route);
  if constexpr (A > 0) {
    const T f = op_mul(pow_by(x.v, p - 1.0, route_m1), T(p));
#pragma unroll
    for (int i = 0; i < A; ++i) r.d[i] = mulz(x.d[i], f);
  }
  return r;
}

template <typename T, int A> BH_D Dual<T, A> abs_(const Dual<T, A>& x) {
  Dual<T, A> r;
  r.v = fabs(x.v);
  if constexpr (A > 0) {
    const T s = x.v > T(0) ? T(1) : (x.v < T(0) ? T(-1) : T(0));
#pragma unroll
    for (int i = 0; i < A; ++i) r.d[i] = op_mul(x.d[i], s);
  }
  return r;
}

template <typename T, int A> BH_D T floor_(const Dual<T, A>& x) { return lib_floor(x.v); }

// torch.remainder(x, c) on the card: fmod, then c added where the signs
// differ.
template <typename T, int A> BH_D Dual<T, A> remainder_(Dual<T, A> x, double c) {
  const T b = T(c);
  T m = lib_fmod(x.v, b);
  if (m != T(0) && ((b < T(0)) != (m < T(0)))) m = op_add(m, b);
  x.v = m;
  return x;
}

// sum_j g[j] * outs[j].d: a stage's input cotangents from its outputs'.
template <typename T, int D, int N>
BH_D void contract(const T (&g)[N], const Dual<T, D> (&outs)[N], T (&acc)[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
    T s = op_mul(g[0], outs[0].d[i]);
#pragma unroll
    for (int j = 1; j < N; ++j) s = op_add(s, op_mul(g[j], outs[j].d[i]));
    acc[i] = s;
  }
}

// ---------------------------------------------------------------------------
// Lattice hash noise (float32 whatever the rows' dtype)
// ---------------------------------------------------------------------------

BH_D float fract_(float x) { return op_sub(x, floorf(x)); }

// shading.hash21 of float32 lattice coordinates.
BH_D float hash21(float x, float y) {
  x = op_add(x, 0.5f);
  y = op_add(y, 0.5f);
  const float px = fract_(op_mul(x, 0.1031f));
  const float py = fract_(op_mul(y, 0.1030f));
  const float pz = fract_(op_mul(op_add(x, y), 0.0973f));
  const float d = op_add(op_add(op_mul(px, op_add(py, 33.33f)),
                                op_mul(py, op_add(pz, 33.33f))),
                         op_mul(pz, op_add(px, 33.33f)));
  return fract_(op_mul(op_add(op_add(px, py), op_mul(2.0f, d)), op_add(pz, d)));
}

template <typename T> BH_D float f32(T v) { return float(v); }

template <typename T, int D> BH_D Dual<T, D> smooth_(const Dual<T, D>& t) {
  return t * t * (3.0 - 2.0 * t);
}

template <typename T, int D>
BH_D Dual<T, D> value_noise2(const Dual<T, D>& x, const Dual<T, D>& y) {
  const T xf = floor_(x), yf = floor_(y);
  const Dual<T, D> tx = smooth_(x - val(xf)), ty = smooth_(y - val(yf));
  const T x1 = op_add(xf, T(1)), y1 = op_add(yf, T(1));
  const auto c00 = val(T(hash21(f32(xf), f32(yf))));
  const auto c10 = val(T(hash21(f32(x1), f32(yf))));
  const auto c01 = val(T(hash21(f32(xf), f32(y1))));
  const auto c11 = val(T(hash21(f32(x1), f32(y1))));
  return c00 * (1.0 - tx) * (1.0 - ty) + c10 * tx * (1.0 - ty)
         + c01 * (1.0 - tx) * ty + c11 * tx * ty;
}

template <typename T, int D>
BH_D Dual<T, D> fbm2(const Dual<T, D>& x, const Dual<T, D>& y, int octaves) {
  Dual<T, D> total = lift<T, D>(T(0));
  T amp = T(0.5), freq = T(1);   // powers of two: exact in either type
  for (int o = 0; o < octaves; ++o) {
    total = total + val(amp) * value_noise2(x * val(freq), y * val(freq));
    amp = op_mul(amp, T(0.5));
    freq = op_mul(freq, T(2));
  }
  return total;
}

// ---------------------------------------------------------------------------
// Colour, redshift and the disk
// ---------------------------------------------------------------------------

template <typename T, int D>
BH_D Dual<T, D> atan2_approx(const Dual<T, D>& y, const Dual<T, D>& x) {
  const Dual<T, D> ax = abs_(x), ay = abs_(y);
  const Dual<T, D> hi = maximum(ax, ay), lo = minimum(ax, ay);
  const Dual<T, D> z = lo / maximum(hi, 1e-30);
  const Dual<T, D> z2 = z * z;
  Dual<T, D> p = -0.0117212 * z2 + 0.0526477;
  p = p * z2 + -0.1172626;
  p = p * z2 + 0.1936999;
  p = p * z2 + -0.3326231;
  p = p * z2 + 0.9999798;
  Dual<T, D> t = p * z;
  t = where(ay.v > ax.v, 1.5707963267948966 - t, t);
  t = where(x.v < T(0), 3.141592653589793 - t, t);
  return where(y.v < T(0), -t, t);
}

template <typename T, int D> struct Rgb { Dual<T, D> c[3]; };

// shading.blackbody_ramp_rows.
template <typename T, int D> BH_D Rgb<T, D> blackbody_ramp(const Dual<T, D>& t_kelvin) {
  const Dual<T, D> t = div_c(clip(t_kelvin, 1000.0, 40000.0), 100.0);
  const bool le66 = t.v <= T(66), ge66 = t.v >= T(66), le19 = t.v <= T(19);
  Rgb<T, D> out;
  Dual<T, D> ch[3];
  ch[0] = le66 ? lift<T, D>(T(255))
               : 329.698727446 * pow_(maximum(t - 60.0, 1e-6), -0.1332047592);
  ch[1] = le66 ? 99.4708025861 * log_(maximum(t, 1e-6)) - 161.1195681661
               : 288.1221695283 * pow_(maximum(t - 60.0, 1e-6), -0.0755148492);
  ch[2] = ge66 ? lift<T, D>(T(255))
               : (le19 ? lift<T, D>(T(0))
                       : 138.5177312231 * log_(maximum(t - 10.0, 1e-6))
                             - 305.0447927307);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const Dual<T, D> v = clip(div_c(ch[c], 255.0), 0.0, 1.0);
    out.c[c] = v * v;
  }
  return out;
}

template <typename T, int D>
BH_D Dual<T, D> g_factor(const Dual<T, D>& m, const Dual<T, D>& a,
                         Dual<T, D> r, const Dual<T, D>& lam) {
  r = maximum(r, 1.05);
  const Dual<T, D> two_mr = 2.0 * m * r;
  const Dual<T, D> sig = r * r;
  const Dual<T, D> g_tt = -(1.0 - two_mr / sig);
  const Dual<T, D> g_tph = -two_mr * a / sig;
  const Dual<T, D> g_phph = r * r + a * a + two_mr * a * a / sig;
  const Dual<T, D> sqrt_m = sqrt_(m);
  const Dual<T, D> omega = sqrt_m / (r * sqrt_(r) + a * sqrt_m);
  const Dual<T, D> ut_inv_sq =
      -(g_tt + 2.0 * omega * g_tph + omega * omega * g_phph);
  const Dual<T, D> u_t = 1.0 / sqrt_(maximum(ut_inv_sq, 1e-6));
  Dual<T, D> doppler = 1.0 - lam * omega;
  doppler = where(fabs(doppler.v) < T(1e-4), 1e-4, doppler);
  return 1.0 / (u_t * doppler);
}

constexpr int CHEB_K = 16;   // render/shading.py::SPECTRAL_CHEB_K

// The disk's numbers (ops/shade.py::shade_args): Python floats held in S,
// rounded to the rows' dtype where they meet a row. The composite holds
// doubles; the render kernel, whose rows are float, holds them rounded to
// float on the host as the card would round them, which its instructions
// read in place (doubles took a conversion and a register each). Then the
// _powi plans {k, n, negative} (k < 0: torch.pow) and torch.pow's routes
// of p and p - 1.
template <typename S> struct DiskArgsT {
  S dens;   // density x the density scale where that is a number
  S outer_radius, t_peak, beam_p, outer_p, turbulence, softness;
  S one_minus_turb, edge_width;   // 1 - turbulence, 0.15 outer_radius
  S nt_peak;   // render/shading.py::NT_PEAK
  S artistic_rgb[3];
  int artistic;
  int beam_plan[3], outer_plan[3], beam_route[2], outer_route[2];
};

// The Chebyshev spectral disk's float32 tables
// (render/shading.py::spectral_kernel_tables), where each kernel keeps
// them: the temperature shape's CHEB_K coefficients, the three colour
// channels' 3 x CHEB_K, and 1 / log(r_out / r_in).
struct ChebTables {
  const float *t, *rgb, *inv_logr;
};

// shading._powi by its plan {k square roots, n by binary powers, negative},
// or torch.pow by its routes where the plan's k is negative.
template <typename T, int D>
BH_D Dual<T, D> powi(const Dual<T, D>& x, double p, const int* plan,
                     const int* route) {
  if (plan[0] < 0) return pow_(x, p, route[0], route[1]);
  Dual<T, D> base = x;
  for (int i = 0; i < plan[0]; ++i) base = sqrt_(base);
  int n = plan[1];
  bool have = false;
  Dual<T, D> acc = lift<T, D>(T(1)), bit = base;
  while (n) {
    if (n & 1) {
      acc = have ? acc * bit : bit;
      have = true;
    }
    n >>= 1;
    if (n) bit = bit * bit;
  }
  return plan[2] ? 1.0 / acc : acc;
}

template <typename T, int D> BH_D Dual<T, D> pow4(const Dual<T, D>& x) {
  const Dual<T, D> x2 = x * x;
  return x2 * x2;
}

template <typename T, int D> struct Geometry {
  bool valid;
  Dual<T, D> r_c, g, turb, edge;
};

// shading._disk_geometry.
template <typename T, int D, typename S>
BH_D Geometry<T, D> disk_geometry(const DiskArgsT<S>& k, const Dual<T, D>& m,
                                  const Dual<T, D>& a, const Dual<T, D>& r_in,
                                  Dual<T, D> r_c, Dual<T, D> phi_c,
                                  Dual<T, D> t_c, const Dual<T, D>& lam,
                                  int octaves) {
  Geometry<T, D> o;
  o.valid = (r_c.v > r_in.v) && (r_c.v < T(k.outer_radius));
  r_c = where(o.valid, r_c, r_in * 2.0);
  phi_c = where(o.valid, phi_c, 0.0);
  t_c = where(o.valid, t_c, 0.0);
  Dual<T, D> g = g_factor(m, a, maximum(r_c, r_in), lam);
  o.g = clip(g, 0.05, 5.0);
  const Dual<T, D> rk = maximum(r_c, r_in);
  const Dual<T, D> omega_k = sqrt_(m) / (rk * sqrt_(rk) + a * sqrt_(m));
  Dual<T, D> phase = phi_c - omega_k * t_c;
  phase = remainder_(phase, 6.283185307179586);
  const Dual<T, D> noise = fbm2(r_c * 1.7, phase * 3.0, octaves);
  o.turb = k.one_minus_turb + k.turbulence * (0.4 + 1.2 * noise);
  const Dual<T, D> inner =
      clip((r_c - r_in) / (k.softness * r_in + 1e-6), 0.0, 1.0);
  o.edge = smooth_(inner)
           * clip(div_c(k.outer_radius - r_c, k.edge_width), 0.0, 1.0);
  o.r_c = r_c;
  return o;
}

template <typename T, int D> struct Slot {
  Dual<T, D> c[3], alpha;
  bool valid;
};

// shading.nt_temperature_profile.
template <typename T, int D>
BH_D Dual<T, D> nt_profile(const Dual<T, D>& r, const Dual<T, D>& r_in,
                           double nt_peak) {
  constexpr int quarter[3] = {2, 1, 0}, minus_3q[3] = {2, 3, 1};
  constexpr int no_route[2] = {POW, POW};
  const Dual<T, D> x = maximum(r / r_in, 1.0 + 1e-6);
  const Dual<T, D> shape = powi(1.0 - sqrt_(1.0 / x), 0.25, quarter, no_route)
                           * powi(x, -0.75, minus_3q, no_route);
  return div_c(shape, nt_peak);
}

// shading.cheb_clenshaw of N float32 coefficients.
template <int N, typename T, int D>
BH_D Dual<T, D> clenshaw(const float* coeffs, const Dual<T, D>& t) {
  Dual<T, D> b1 = lift<T, D>(T(0)), b2 = lift<T, D>(T(0));
  for (int j = N - 1; j > 0; --j) {
    const Dual<T, D> nb = 2.0 * t * b1 - b2 + val(T(coeffs[j]));
    b2 = b1;
    b1 = nb;
  }
  return t * b1 - b2 + val(T(coeffs[0]));
}

// One crossing of the disk: shading.spectral_slot_core, the Chebyshev
// spectral branch, where ``spectral`` (SPECTRAL_T_LO 900, SPECTRAL_T_HI
// 4e4), else shading.disk_emission_rows, the analytic one.
template <typename T, int D, typename S>
BH_D Slot<T, D> disk_slot(bool spectral, const DiskArgsT<S>& k,
                          const ChebTables& tab, const Dual<T, D>& m,
                          const Dual<T, D>& a, const Dual<T, D>& r_in,
                          const Dual<T, D>& r_c, const Dual<T, D>& phi_c,
                          const Dual<T, D>& t_c, const Dual<T, D>& lam,
                          int octaves, const Dual<T, D>& dens_ds,
                          const Dual<T, D>& int_scale) {
  const Geometry<T, D> geo =
      disk_geometry(k, m, a, r_in, r_c, phi_c, t_c, lam, octaves);
  Slot<T, D> s;
  s.valid = geo.valid;
  s.alpha = where(geo.valid, clip(dens_ds * geo.edge * geo.turb, 0.0, 1.0), 0.0);
  if (spectral) {
    const Dual<T, D> x01 =
        log_(maximum(geo.r_c / r_in, 1e-6)) * val(T(*tab.inv_logr));
    const Dual<T, D> xs = sqrt_(clip(x01, 0.0, 1.0));
    const Dual<T, D> tx = clip(2.0 * xs - 1.0, -1.0, 1.0);
    const Dual<T, D> t_shape = clip(clenshaw<CHEB_K>(tab.t, tx), 0.0, 1.0);
    const Dual<T, D> t_obs = clip(geo.g * t_shape * k.t_peak, 900.0, 4e4);
    const Dual<T, D> y01 = pow_(div_c(t_obs - 900.0, 4e4 - 900.0), 0.4);
    const Dual<T, D> ty = clip(2.0 * y01 - 1.0, -1.0, 1.0);
    const Dual<T, D> masked =
        where(geo.valid, pow4(geo.g) * pow4(t_shape) * int_scale, 0.0);
    // Each channel scaled as it is formed: one live at a time, not three.
#pragma unroll
    for (int c = 0; c < 3; ++c)
      s.c[c] = maximum(clenshaw<CHEB_K>(tab.rgb + c * CHEB_K, ty), 0.0)
               * masked;
  } else {
    const Dual<T, D> t_shape =
        nt_profile(maximum(geo.r_c, r_in * (1 + 1e-4)), r_in, k.nt_peak);
    Rgb<T, D> color;
    if (k.artistic) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        color.c[c] = lift<T, D>(T(k.artistic_rgb[c]));
    } else {
      color =
          blackbody_ramp(clip(geo.g * t_shape * k.t_peak, 1000.0, 40000.0));
    }
    const Dual<T, D> outer = powi(maximum(r_in, geo.r_c) / r_in, k.outer_p,
                                  k.outer_plan, k.outer_route);
    const Dual<T, D> masked =
        where(geo.valid, powi(geo.g, k.beam_p, k.beam_plan, k.beam_route)
                             * pow4(t_shape) * outer * int_scale, 0.0);
#pragma unroll
    for (int c = 0; c < 3; ++c) s.c[c] = color.c[c] * masked;
  }
  return s;
}

// ---------------------------------------------------------------------------
// The sky behind escaped rays
// ---------------------------------------------------------------------------

// shading.escape_direction_u_rows of the rows (r, u, ph, p_t, p_r, p_u,
// p_phi).
template <typename T, int D>
BH_D void escape_direction_u(const Dual<T, D> (&rows)[7], const Dual<T, D>& m,
                             const Dual<T, D>& a, Dual<T, D> (&out)[3]) {
  const Dual<T, D>& r = rows[0];
  const Dual<T, D>& ph = rows[2];
  const Dual<T, D>& pt = rows[3];
  const Dual<T, D>& pr = rows[4];
  const Dual<T, D>& pu = rows[5];
  const Dual<T, D>& pph = rows[6];
  const Dual<T, D> u = clip(rows[1], -1.0, 1.0);
  const Dual<T, D> w = maximum(1.0 - u * u, 1e-12);
  const Dual<T, D> s = sqrt_(w);
  const Dual<T, D> sig = r * r + a * a * u * u;
  const Dual<T, D> delta = r * r - 2.0 * m * r + a * a;
  const Dual<T, D> inv_sig = 1.0 / sig;
  const Dual<T, D> h = 2.0 * m * r * inv_sig;
  const Dual<T, D> v_r = h * pt + delta * inv_sig * pr + a * inv_sig * pph;
  const Dual<T, D> v_th = -r * pu * s * inv_sig;
  const Dual<T, D> v_ph = r * s * (a * inv_sig * pr + pph * inv_sig / w);
  const Dual<T, D> sp = sin_(ph), cp = cos_(ph);
  const Dual<T, D> dx = v_r * s * cp + v_th * u * cp - v_ph * sp;
  const Dual<T, D> dy = v_r * s * sp + v_th * u * sp + v_ph * cp;
  const Dual<T, D> dz = v_r * u - v_th * s;
  const Dual<T, D> inv_n = 1.0 / sqrt_(maximum(dx * dx + dy * dy + dz * dz, 1e-30));
  out[0] = dx * inv_n;
  out[1] = dy * inv_n;
  out[2] = dz * inv_n;
}

// The starfield's numbers (ops/shade.py::shade_args), held in S as
// DiskArgsT's: the two lattice frequencies and star thresholds,
// brightness, nebula.
template <typename S> struct StarArgsT {
  S cells[2], thr[2], brightness, nebula;
};

// shading.starfield_rows of a direction.
template <typename T, int D, typename S>
BH_D Rgb<T, D> starfield(const Dual<T, D>& dx, const Dual<T, D>& dy,
                         const Dual<T, D>& dz, const StarArgsT<S>& k) {
  const Dual<T, D> u = atan2_approx(dy, dx);
  const Dual<T, D> v = clip(dz, -1.0, 1.0);
  Rgb<T, D> acc;
#pragma unroll
  for (int c = 0; c < 3; ++c) acc.c[c] = lift<T, D>(T(0));
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const double freq = k.cells[s];
    const T cu = floor_(u * freq), cv = floor_(v * freq);
    const float h = hash21(f32(cu), f32(cv));
    const T star = h < float(k.thr[s]) ? T(1) : T(0);
    const Dual<T, D> fu = u * freq - val(cu) - 0.5;
    const Dual<T, D> fv = v * freq - val(cv) - 0.5;
    const Dual<T, D> spot = exp_(-(fu * fu + fv * fv) * 40.0);
    const float temp = op_add(
        op_mul(12000.0f, hash21(f32(op_add(cu, T(7))), f32(op_add(cv, T(13))))),
        3000.0f);
    const Rgb<float, 0> color = blackbody_ramp(val(temp));
    const float h_mag = hash21(f32(op_add(cu, T(31))), f32(op_add(cv, T(5))));
    const Dual<T, D> w =
        val(star) * spot * val(T(op_mul(op_mul(h_mag, h_mag), h_mag)));
#pragma unroll
    for (int c = 0; c < 3; ++c) acc.c[c] = acc.c[c] + w * val(T(color.c[c].v));
  }
  const Dual<T, D> nebula = fbm2(u * 3.0, v * 3.0, 4);
  const Dual<T, D> neb2 = nebula * nebula;
  const Dual<T, D> nc[3] = {0.35 * neb2, 0.2 * neb2, 0.5 * nebula * sqrt_(nebula)};
  Rgb<T, D> out;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    out.c[c] = k.brightness * acc.c[c] + k.nebula * nc[c];
  return out;
}

// ---------------------------------------------------------------------------
// The photon-ring glow of an escaped ray
// ---------------------------------------------------------------------------

// shading's glow: 0.6 exp(-14 r_min_ph / max(r_ph, 1e-3)).
template <typename T, int D>
BH_D Dual<T, D> glow_of(const Dual<T, D>& r_min_ph, const Dual<T, D>& r_ph) {
  const Dual<T, D> near = exp_(-14.0 * r_min_ph / maximum(r_ph, 1e-3));
  return 0.6 * near;
}

// The glow's order: min(max(n_crossings, 0), 3) / 3.
template <typename T> BH_D T glow_order(int n_cross) {
  const int c = n_cross < 0 ? 0 : (n_cross > 3 ? 3 : n_cross);
  return op_div(T(c), T(3));
}

// The glow's colour weight of channel c: warm + order (cool - warm), the
// difference formed in double as the Python numbers' is.
template <typename T>
BH_D T glow_weight(int c, T order) {
  const double warm = c == 0 ? 1.0 : (c == 1 ? 0.82 : 0.55);
  const double cool = c == 0 ? 0.82 : (c == 1 ? 0.88 : 1.0);
  return op_add(op_mul(order, T(cool - warm)), T(warm));
}

}  // namespace shade
