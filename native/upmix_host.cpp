// upmix_host — native streaming host shell for the upmix framework.
//
// C++ equivalent of the reference's real-time engine (bela/upmix.cpp): a
// block-based stereo->LCR upmixer for low-latency local playback where no
// accelerator is attached.  The DSP semantics intentionally match the framework's
// JAX streaming path (upmix/models/streaming.py) and the NumPy oracle
// (upmix/oracle/reference.py) so the three implementations are
// SNR-comparable; tests bit-compare this engine against the oracle.
//
// Design differences from the reference implementation (this is not a
// translation):
//   - One shared input history per engine (not per-band ring buffers):
//     with the fixed 75% overlap every band's readiness threshold is
//     exactly 4 hardware blocks (verified in SURVEY.md §2.2), so band
//     pass p simply reads history[p*hop : p*hop + block].
//   - Forward FFTs are packed: L and R are transformed in ONE complex FFT
//     (z = wL + i*wR) and unpacked by conjugate symmetry; the C and Ls
//     inverse transforms share one complex IFFT the same way.  2+3
//     real transforms per pass become 1+2 complex ones.
//   - Band-limit gains are precomputed per-band gain vectors (the
//     "live-fade" raised-cosine semantics of the Python reference, or
//     hard-zero for C++-reference parity — see SURVEY.md §2.2 on the
//     reference C++ fade no-op bug).
//   - Synthesis window is WOLA-designed by default (Python-reference
//     semantics); "analysis" mode reproduces the C++ reference's plain
//     Blackman-Harris synthesis.
//
// API: extern "C", handle-based; see upmix_host.h-equivalent declarations
// at the bottom.  Thread model: single producer — one engine instance per
// stream.  Internally the engine can fan bands out over a persistent
// worker pool (n_threads > 1 or 0 = auto): bands own their scratch and
// output buffers, workers never touch shared mutable state, and the main
// thread sums band outputs in band order after the join, so results are
// bit-identical to the serial path (the pool is the native equivalent of
// the reference's ThreadPoolExecutor over bands,
// center_extraction.py:499-511).

#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fenv.h>
#include <memory>
#include <mutex>
#include <new>
#include <thread>
#include <vector>

namespace {

constexpr double kEps = 1e-12;  // mask/WOLA epsilon (reference EPS)
constexpr int kWarmupBlocks = 4;
constexpr int kMaxBands = 8;  // reference MAX_BANDS clamp (upmix.cpp:444-445)

// ---------------------------------------------------------------------------
// FFT: iterative radix-2 complex FFT for power-of-two sizes.
// ---------------------------------------------------------------------------

// Templated on the scalar type: FftT<double> is the parity engine
// (bit-exact with the original radix-2 double path was NOT required —
// the oracle bar is SNR); FftT<float> is the fast mode (half the memory
// traffic, twice the SIMD width).  Stages are fused in pairs into
// radix-4 butterflies ("radix-2^2": two DIT radix-2 stages on
// bit-reversed input collapse into one 4-point pass; the second stage's
// odd twiddle W^(k+m) = -i * W^k), halving the number of passes over
// the data.
template <typename T>
struct FftT {
  int n = 0;
  std::vector<int> rev;   // bit-reversal permutation
  std::vector<T> tw_re;   // packed twiddles W_n^k, k < n/2
  std::vector<T> tw_im;
  // Half-size plan chain for inverse_real (real-output inverse via one
  // n/2-point complex inverse).  Measured negative alternative (do not
  // retry): per-stage CONTIGUOUS twiddle tables to help the
  // auto-vectorizer — interleaved A/B showed a wash on double and -3%
  // on float; the butterflies are memory-pass-bound, not gather-bound.
  std::unique_ptr<FftT<T>> half;

  void init(int size) {
    n = size;
    rev.assign(n, 0);
    int log2n = 0;
    while ((1 << log2n) < n) ++log2n;
    for (int i = 0; i < n; ++i) {
      int r = 0;
      for (int b = 0; b < log2n; ++b)
        if (i & (1 << b)) r |= 1 << (log2n - 1 - b);
      rev[i] = r;
    }
    tw_re.assign(n / 2, T(0));
    tw_im.assign(n / 2, T(0));
    for (int k = 0; k < n / 2; ++k) {
      double a = -2.0 * M_PI * k / n;
      tw_re[k] = (T)std::cos(a);
      tw_im[k] = (T)std::sin(a);
    }
    if (n >= 4) {
      half.reset(new FftT<T>());
      half->init(n / 2);
    }
  }

  // In-place forward transform (sign -1).  For inverse, conjugate in/out.
  void forward(T* re, T* im) const {
    for (int i = 0; i < n; ++i) {
      int j = rev[i];
      if (j > i) {
        std::swap(re[i], re[j]);
        std::swap(im[i], im[j]);
      }
    }
    int log2n = 0;
    while ((1 << log2n) < n) ++log2n;
    int len = 2;
    if (log2n & 1) {
      // Odd stage count: one plain radix-2 stage (twiddle 1), the rest
      // fuse in pairs below.
      for (int i = 0; i < n; i += 2) {
        T xr = re[i + 1], xi = im[i + 1];
        re[i + 1] = re[i] - xr;
        im[i + 1] = im[i] - xi;
        re[i] += xr;
        im[i] += xi;
      }
      len = 4;
    }
    // Fused pass for the stage pair (len, 2*len): radix-4 butterflies on
    // x0 = x[i+k], x1 = x[i+k+m], x2 = x[i+k+2m], x3 = x[i+k+3m] with
    // m = len/2, w1 = W^(2k*step), w2 = W^(k*step), step = n/(2*len).
    for (; len <= n / 2; len <<= 2) {
      int m = len >> 1;
      int step = n / (2 * len);
      for (int i = 0; i < n; i += 2 * len) {
        for (int k = 0; k < m; ++k) {
          T w1r = tw_re[2 * k * step], w1i = tw_im[2 * k * step];
          T w2r = tw_re[k * step], w2i = tw_im[k * step];
          int a = i + k, b = a + m, c = a + 2 * m, d = a + 3 * m;
          // stage 1 (len): (x0, x1) and (x2, x3), both with w1
          T tr = re[b] * w1r - im[b] * w1i;
          T ti = re[b] * w1i + im[b] * w1r;
          T y0r = re[a] + tr, y0i = im[a] + ti;
          T y1r = re[a] - tr, y1i = im[a] - ti;
          T ur = re[d] * w1r - im[d] * w1i;
          T ui = re[d] * w1i + im[d] * w1r;
          T y2r = re[c] + ur, y2i = im[c] + ui;
          T y3r = re[c] - ur, y3i = im[c] - ui;
          // stage 2 (2*len): (y0, y2) with w2; (y1, y3) with -i*w2
          T vr = y2r * w2r - y2i * w2i;
          T vi = y2r * w2i + y2i * w2r;
          re[a] = y0r + vr; im[a] = y0i + vi;
          re[c] = y0r - vr; im[c] = y0i - vi;
          T sr0 = y3r * w2r - y3i * w2i;
          T si0 = y3r * w2i + y3i * w2r;
          T sr = si0, si = -sr0;  // multiply by -i
          re[b] = y1r + sr; im[b] = y1i + si;
          re[d] = y1r - sr; im[d] = y1i - si;
        }
      }
    }
    // The initial parity stage guarantees the fused pairs cover every
    // remaining stage exactly: (len, 2*len) with len = {2 or 4}·4^j up
    // to (n/2, n).
  }

  void inverse(T* re, T* im) const {
    for (int i = 0; i < n; ++i) im[i] = -im[i];
    forward(re, im);
    T s = T(1) / (T)n;
    for (int i = 0; i < n; ++i) {
      re[i] *= s;
      im[i] *= -s;
    }
  }

  // Real-output inverse from a conjugate-symmetric half-spectrum
  // (Sre/Sim hold n/2+1 bins) via ONE n/2-point complex inverse — the
  // classic irfft decimation: Z[k] = Ze[k] + i·W^{-k}·Zo[k] packs the
  // even/odd sample streams into one half-length transform, so a lone
  // real signal (the Rs channel) costs the same per-sample as the two
  // channels sharing the packed complex inverse.  zre/zim are n/2
  // scratch; out receives n real samples.
  void inverse_real(const T* Sre, const T* Sim, T* zre, T* zim,
                    T* out) const {
    int h = n / 2;
    for (int k = 0; k < h; ++k) {
      int kc = h - k;
      T xr = Sre[k], xi = Sim[k];
      T yr = Sre[kc], yi = -Sim[kc];
      T er = T(0.5) * (xr + yr), ei = T(0.5) * (xi + yi);
      T dr = T(0.5) * (xr - yr), di = T(0.5) * (xi - yi);
      // Zo = conj(W^k)·D with W^k = e^{-2πik/n} from the twiddle table.
      T wr = tw_re[k], wi = tw_im[k];
      T zor = wr * dr + wi * di;
      T zoi = wr * di - wi * dr;
      zre[k] = er - zoi;
      zim[k] = ei + zor;
    }
    half->inverse(zre, zim);
    for (int m = 0; m < h; ++m) {
      out[2 * m] = zre[m];
      out[2 * m + 1] = zim[m];
    }
  }
};

using Fft = FftT<double>;
using FftF = FftT<float>;

// ---------------------------------------------------------------------------
// Host-side config math (mirrors upmix/config.py, which mirrors the
// reference's sizing rules).
// ---------------------------------------------------------------------------

int next_power_of_2(int x) {
  if (x < 1) return 1;
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// rounding: 0 = python (banker's, no clamp), 1 = cpp (half-away, clamped)
int freq_to_bin(double f, double sr, int fft_size, int rounding) {
  if (rounding == 1) {
    double b = f * fft_size / sr;
    if (b < 0.0) b = 0.0;
    double mx = fft_size / 2;
    if (b > mx) b = mx;
    return (int)std::floor(b + 0.5);
  }
  int old = fegetround();
  fesetround(FE_TONEAREST);  // round-half-even, like Python round()
  long v = lrint(f / (sr / (double)fft_size));
  fesetround(old);
  return (int)v;
}

int compute_block_size(double f_low, double sr, int max_block, double thresh) {
  if (f_low <= 0.0) return max_block;
  double t = sr * thresh / f_low;
  int cand = next_power_of_2((int)std::ceil(t));
  return cand < max_block ? cand : max_block;
}

std::vector<float> make_blackman_harris(int n) {
  std::vector<float> w(n);
  const double a0 = 0.35875, a1 = 0.48829, a2 = 0.14128, a3 = 0.01168;
  for (int i = 0; i < n; ++i) {
    double x = 2.0 * M_PI * i / (n - 1);
    w[i] = (float)(a0 - a1 * std::cos(x) + a2 * std::cos(2 * x) -
                   a3 * std::cos(3 * x));
  }
  return w;
}

// Window kinds mirror upmix/ops/windows.py (same formulas as the
// NumPy generators, double math cast to float32):
//   0 = blackman_harris, 1 = sqrt_hann, 2 = hann, 3 = blackman,
//   4 = hamming, 5 = rect
std::vector<float> make_window(int kind, int n) {
  if (kind == 0) return make_blackman_harris(n);
  std::vector<float> w(n, 1.0f);
  if (kind == 5 || n < 2) return w;  // rect; degenerate n matches numpy's [1.]
  for (int i = 0; i < n; ++i) {
    double x = 2.0 * M_PI * i / (n - 1);
    double v;
    switch (kind) {
      case 1:  // sqrt(hann)
        v = std::sqrt(0.5 - 0.5 * std::cos(x));
        break;
      case 2:  // hann
        v = 0.5 - 0.5 * std::cos(x);
        break;
      case 3:  // blackman
        v = 0.42 - 0.5 * std::cos(x) + 0.08 * std::cos(2 * x);
        break;
      case 4:  // hamming
        v = 0.54 - 0.46 * std::cos(x);
        break;
      default:
        v = 1.0;
    }
    w[i] = (float)v;
  }
  return w;
}

std::vector<float> design_wola_synthesis(const std::vector<float>& aw, int hop) {
  int L = (int)aw.size();
  int K = L / hop;  // frames overlapping each sample at this hop
  std::vector<float> sw(L);
  for (int n = 0; n < L; ++n) {
    double denom = kEps;
    for (int k = 0; k < K; ++k) {
      float a = aw[(n + k * hop) % L];
      denom += (double)(a * a);
    }
    sw[n] = (float)(aw[n] / denom);
  }
  return sw;
}

// Live-fade raised-cosine / hard-zero gain curve
// (mirrors upmix/ops/gains.py; reference center_extraction.py:273-332).
std::vector<double> band_gain_curve(double f_low, double f_high, double sr,
                                    int fft_size, int xover_mode,  // 0=rc 1=hz
                                    double width_low, double width_high,
                                    int rounding) {
  int n_bins = fft_size / 2 + 1;
  int bin_low = freq_to_bin(f_low, sr, fft_size, rounding);
  int bin_high = freq_to_bin(f_high, sr, fft_size, rounding);
  if (bin_low > bin_high) std::swap(bin_low, bin_high);
  std::vector<double> g(n_bins, 1.0);

  if (xover_mode != 0) {  // hard zero
    for (int i = 0; i < bin_low && i < n_bins; ++i) g[i] = 0.0;
    for (int i = bin_high + 1; i < n_bins; ++i) g[i] = 0.0;
    return g;
  }

  if (bin_low < 0) bin_low = 0;
  if (bin_high > n_bins - 1) bin_high = n_bins - 1;
  if (bin_low > bin_high) {
    std::fill(g.begin(), g.end(), 0.0);
    return g;
  }
  int fade_lo = freq_to_bin(width_low, sr, fft_size, rounding);
  int fade_hi = freq_to_bin(width_high, sr, fft_size, rounding);

  if (f_low > 0.0) {
    int start = bin_low - fade_lo;
    if (start < 0) start = 0;
    for (int i = 0; i < start; ++i) g[i] = 0.0;
    int len = bin_low - start;
    for (int i = 0; i < len; ++i) {
      double x = (i + 0.5) / len;
      g[start + i] = 0.5 * (1.0 - std::cos(M_PI * x));
    }
  }
  if (f_high < sr * 0.5) {
    int start = bin_high + 1;
    int end = start + fade_hi;
    if (end > n_bins) end = n_bins;
    if (start < n_bins) {
      int len = end - start;
      for (int i = 0; i < len; ++i) {
        double x = (i + 0.5) / len;
        g[start + i] = 0.5 * (1.0 + std::cos(M_PI * x));
      }
      for (int i = end; i < n_bins; ++i) g[i] = 0.0;
    }
  }
  return g;
}

// ---------------------------------------------------------------------------
// Engine
// ---------------------------------------------------------------------------

// DSP scratch for one concurrently-running band pass.  Pooled engines
// give each band its own (bands then share no mutable state, so the
// worker pool needs no locking around the DSP); the serial engine shares
// ONE max-block-sized instance across all bands — the pre-pool memory
// footprint.
template <typename T>
struct ScratchT {
  std::vector<T> zre, zim, wre, wim;
  // spectra scratch per pass: L/R/C/Ls/Rs half-spectra
  std::vector<T> sLre, sLim, sRre, sRim, sCre, sCim, sSre, sSim,
      sTre, sTim;

  void alloc(int block) {
    zre.resize(block); zim.resize(block); wre.resize(block); wim.resize(block);
    int nb = block / 2 + 1;
    sLre.resize(nb); sLim.resize(nb); sRre.resize(nb); sRim.resize(nb);
    sCre.resize(nb); sCim.resize(nb); sSre.resize(nb); sSim.resize(nb);
    sTre.resize(nb); sTim.resize(nb);
  }
};

using Scratch = ScratchT<double>;
using ScratchF = ScratchT<float>;

struct Band {
  int block = 0, hop = 0, passes = 0;
  std::vector<float> aw, sw;
  std::vector<double> gain;        // [block/2 + 1]
  std::vector<float> gainf;        // float copy (fast mode)
  std::vector<float> accum;        // OLA accumulators [3][block] flattened
  Fft* fft = nullptr;              // shared per block size (read-only plan)
  FftF* fftf = nullptr;            // float-precision plan (fast mode)
  Scratch* sc = nullptr;           // own in pooled mode, shared in serial
  ScratchF* scf = nullptr;         // float scratch (fast mode)

  // per-hw-block output buffers (summed by the main thread, in band order)
  std::vector<float> blkC, blkLs, blkRs;

  float* acc(int ch) { return accum.data() + (size_t)ch * block; }
};

struct Engine {
  double sr = 0;
  int hw = 0;            // hardware block size
  int hist_len = 0;      // 4 * hw
  int64_t t = 0;         // hardware blocks received
  std::vector<float> histL, histR;  // shared input history, newest at tail
  std::vector<Band> bands;
  std::vector<Fft> ffts;            // one per distinct block size
  std::vector<FftF> fftfs;          // float plans (fast mode)
  std::vector<Scratch> scratches;   // per band (pooled) or one shared (serial)
  std::vector<ScratchF> scratchesf; // float scratch (fast mode)

  // Worker pool (band task parallelism).  Protocol: the main thread
  // publishes `next = 0, remaining = n` under the mutex and wakes the
  // workers; each worker claims band indices via `next`, processes the
  // band into its own buffers, and the last one signals `cv_done`.  The
  // main thread claims work too, so n_threads counts it (pool size =
  // n_threads - 1).
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  size_t next = 0;       // next band index to claim
  int remaining = -1;    // bands not yet finished; -1 = no batch pending
  bool stop = false;

  ~Engine() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_work.notify_all();
    for (auto& w : workers) w.join();
  }
};

void band_process(Engine& e, Band& b);

void worker_loop(Engine* e) {
  for (;;) {
    size_t idx;
    {
      std::unique_lock<std::mutex> lk(e->mu);
      e->cv_work.wait(lk, [e] { return e->stop || e->next < e->bands.size(); });
      if (e->stop) return;
      idx = e->next++;
    }
    band_process(*e, e->bands[idx]);
    {
      std::lock_guard<std::mutex> lk(e->mu);
      if (--e->remaining == 0) e->cv_done.notify_one();
    }
  }
}

// One pass of one band: read history window at offset, produce hop samples
// of (C, Ls, Rs) into out[3][hop] (float32, matching oracle numerics).
// Touches only band-owned scratch (and the engine's read-only history).
// Templated on the working precision: T=double is the parity mode
// (oracle's float64 spectra); T=float is the fast mode — half the memory
// traffic and twice the SIMD width through the FFTs and the mask, still
// comfortably >60 dB vs the oracle (the output is float32 either way).
template <typename T>
void band_pass_impl(Engine& e, Band& b, ScratchT<T>& sc, const FftT<T>& fft,
                    const T* gain, int offset, float* outC, float* outLs,
                    float* outRs) {
  int B = b.block, H = b.hop, NB = B / 2 + 1;
  const T eps = (T)kEps;

  // Packed forward FFT: z = wL + i*wR.
  for (int i = 0; i < B; ++i) {
    float l = e.histL[offset + i] * b.aw[i];
    float r = e.histR[offset + i] * b.aw[i];
    sc.zre[i] = (T)l;
    sc.zim[i] = (T)r;
  }
  fft.forward(sc.zre.data(), sc.zim.data());
  // Unpack: L[k] = (Z[k] + conj(Z[N-k]))/2; R[k] = (Z[k] - conj(Z[N-k]))/2i
  for (int k = 0; k < NB; ++k) {
    int kc = (B - k) & (B - 1);
    T ar = sc.zre[k], ai = sc.zim[k];
    T br = sc.zre[kc], bi = -sc.zim[kc];
    T lre = T(0.5) * (ar + br), lim = T(0.5) * (ai + bi);
    T rre = T(0.5) * (ai - bi), rim = T(-0.5) * (ar - br);
    T g = gain[k];
    sc.sLre[k] = lre * g; sc.sLim[k] = lim * g;
    sc.sRre[k] = rre * g; sc.sRim[k] = rim * g;
  }

  // Center-extraction mask (reference math; T=double matches the
  // oracle's float64 spectra exactly, T=float holds >60 dB).
  for (int k = 0; k < NB; ++k) {
    T lre = sc.sLre[k], lim = sc.sLim[k];
    T rre = sc.sRre[k], rim = sc.sRim[k];
    T magl = std::sqrt(lre * lre + lim * lim);
    T magr = std::sqrt(rre * rre + rim * rim);
    T cross = magl * magr;  // |L * conj(R)| == |L||R|
    T coh = cross / (cross + eps);
    T bal = (magl - magr) / (magl + magr + eps);
    T f = T(0.5) * coh * (T(1) - std::fabs(bal));
    T cre = f * (lre + rre), cim = f * (lim + rim);
    sc.sCre[k] = cre; sc.sCim[k] = cim;
    sc.sSre[k] = lre - cre; sc.sSim[k] = lim - cim;   // Ls
    sc.sTre[k] = rre - cre; sc.sTim[k] = rim - cim;   // Rs
  }

  // Packed inverse 1: c + i*ls from full spectra via conjugate symmetry.
  for (int k = 0; k < B; ++k) {
    T cr, ci, lr, li;
    if (k < NB) { cr = sc.sCre[k]; ci = sc.sCim[k]; lr = sc.sSre[k]; li = sc.sSim[k]; }
    else { int kc = B - k; cr = sc.sCre[kc]; ci = -sc.sCim[kc]; lr = sc.sSre[kc]; li = -sc.sSim[kc]; }
    sc.zre[k] = cr - li;
    sc.zim[k] = ci + lr;
  }
  fft.inverse(sc.zre.data(), sc.zim.data());
  // Inverse 2: rs alone — half-size real inverse (one B/2-point complex
  // transform instead of a full B-point one on the symmetry-packed
  // spectrum; wim's two halves are the Z scratch, wre receives rs).
  fft.inverse_real(sc.sTre.data(), sc.sTim.data(), sc.wim.data(),
                   sc.wim.data() + B / 2, sc.wre.data());

  // OLA accumulate (float32, synthesis-windowed — oracle casts the irfft
  // to float32 BEFORE the window multiply, reference ce.py:124-137).
  float* aC = b.acc(0); float* aL = b.acc(1); float* aR = b.acc(2);
  for (int i = 0; i < B; ++i) {
    float sw = b.sw[i];
    aC[i] += (float)sc.zre[i] * sw;
    aL[i] += (float)sc.zim[i] * sw;
    aR[i] += (float)sc.wre[i] * sw;
  }
  // Emit + shift.
  std::memcpy(outC, aC, sizeof(float) * H);
  std::memcpy(outLs, aL, sizeof(float) * H);
  std::memcpy(outRs, aR, sizeof(float) * H);
  std::memmove(aC, aC + H, sizeof(float) * (B - H));
  std::memmove(aL, aL + H, sizeof(float) * (B - H));
  std::memmove(aR, aR + H, sizeof(float) * (B - H));
  std::memset(aC + B - H, 0, sizeof(float) * H);
  std::memset(aL + B - H, 0, sizeof(float) * H);
  std::memset(aR + B - H, 0, sizeof(float) * H);
}

// Precision dispatch: a band carries EITHER double resources (parity
// mode) or float resources (fast mode), decided at engine creation.
void band_pass(Engine& e, Band& b, int offset, float* outC, float* outLs,
               float* outRs) {
  if (b.scf)
    band_pass_impl<float>(e, b, *b.scf, *b.fftf, b.gainf.data(), offset,
                          outC, outLs, outRs);
  else
    band_pass_impl<double>(e, b, *b.sc, *b.fft, b.gain.data(), offset,
                           outC, outLs, outRs);
}

// One band's full hardware block (all passes) into the band-owned output
// buffers — the unit of work the pool distributes.
void band_process(Engine& e, Band& b) {
  for (int p = 0; p < b.passes; ++p) {
    band_pass(e, b, p * b.hop, b.blkC.data() + p * b.hop,
              b.blkLs.data() + p * b.hop, b.blkRs.data() + p * b.hop);
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------------

extern "C" {

// Bumped whenever the upmix_create signature (or any other ABI surface)
// changes; the Python loader refuses libraries with a different value so
// a stale .so cannot silently drop arguments (e.g. round 2 added the
// trailing `window` parameter, round 3 `n_threads`, round 4 `precision`).
int upmix_abi_version() { return 5; }

}  // extern "C"

namespace {

// Shared engine construction.  win_data/win_off non-null = caller
// supplies each band's analysis-window coefficients (concatenated
// float32 + n_win+1 offsets; band i's window must be exactly its block
// size long) — the custom-window path, reference parity with
// python-prototype/main.py:65's arbitrary window_func.  Otherwise the
// window is generated internally from `window` (kind enum).
void* engine_create(double sr, int hw_block, const double* edges, int n_edges,
                    int xover_mode, int synthesis, int rounding,
                    double threshold_multi, double xo_fraction, int window,
                    const float* win_data, const long long* win_off, int n_win,
                    int n_threads, int precision) {
  if (window < 0 || window > 5) return nullptr;
  if (n_threads < 0) return nullptr;
  if (precision < 0 || precision > 1) return nullptr;
  if (sr <= 0 || hw_block < 4 || n_edges < 1) return nullptr;
  std::vector<double> e(edges, edges + n_edges);
  if (e.back() < sr / 2.0) e.push_back(sr / 2.0);
  if (e.size() < 2) return nullptr;
  // Clamp to kMaxBands band pairs, matching the reference aggregator and
  // UpmixConfig.streaming (drop the excess upper bands).
  if ((int)e.size() > kMaxBands + 1) e.resize(kMaxBands + 1);

  Engine* eng = new (std::nothrow) Engine();
  if (!eng) return nullptr;
  eng->sr = sr;
  eng->hw = hw_block;
  eng->hist_len = kWarmupBlocks * hw_block;
  eng->histL.assign(eng->hist_len, 0.0f);
  eng->histR.assign(eng->hist_len, 0.0f);

  int max_block = hw_block * kWarmupBlocks;
  double prev_width = 0.0;
  for (size_t i = 0; i + 1 < e.size(); ++i) {
    Band b;
    b.block = compute_block_size(e[i], sr, max_block, threshold_multi);
    b.hop = b.block / 4;  // fixed 75% overlap in the streaming engine
    if (b.hop < 1 || hw_block % b.hop != 0) { delete eng; return nullptr; }
    b.passes = hw_block / b.hop;
    if (win_data) {
      if ((int)i >= n_win) { delete eng; return nullptr; }
      long long a = win_off[i], z = win_off[i + 1];
      if (z - a != (long long)b.block) { delete eng; return nullptr; }
      b.aw.assign(win_data + a, win_data + z);
    } else {
      b.aw = make_window(window, b.block);
    }
    b.sw = synthesis == 0 ? design_wola_synthesis(b.aw, b.hop) : b.aw;
    double w_hi = e[i + 1] * xo_fraction;
    b.gain = band_gain_curve(e[i], e[i + 1], sr, b.block, xover_mode,
                             prev_width, w_hi, rounding);
    prev_width = w_hi;
    b.accum.assign((size_t)3 * b.block, 0.0f);
    b.blkC.resize(hw_block); b.blkLs.resize(hw_block); b.blkRs.resize(hw_block);
    eng->bands.push_back(std::move(b));
  }
  // Shared FFT plans per distinct block size, in the selected working
  // precision only (a band carries EITHER double or float resources).
  if (precision == 0) {
    eng->ffts.reserve(eng->bands.size());
    for (auto& b : eng->bands) {
      bool found = false;
      for (auto& f : eng->ffts)
        if (f.n == b.block) { found = true; break; }
      if (!found) {
        eng->ffts.emplace_back();
        eng->ffts.back().init(b.block);
      }
    }
    // (Re-resolve pointers after vector growth is done.)
    for (auto& b : eng->bands)
      for (auto& f : eng->ffts)
        if (f.n == b.block) { b.fft = &f; break; }
  } else {
    eng->fftfs.reserve(eng->bands.size());
    for (auto& b : eng->bands) {
      bool found = false;
      for (auto& f : eng->fftfs)
        if (f.n == b.block) { found = true; break; }
      if (!found) {
        eng->fftfs.emplace_back();
        eng->fftfs.back().init(b.block);
      }
    }
    for (auto& b : eng->bands) {
      for (auto& f : eng->fftfs)
        if (f.n == b.block) { b.fftf = &f; break; }
      // The gain curve is designed in double (same bin math as parity
      // mode), then narrowed once at creation.
      b.gainf.assign(b.gain.begin(), b.gain.end());
    }
  }

  // Worker pool: n_threads counts the caller's thread, so spawn one
  // fewer.  `next` starts past the end so idle workers sleep until the
  // first batch is published.
  if (n_threads == 0) {
    unsigned hc = std::thread::hardware_concurrency();
    n_threads = (int)eng->bands.size();
    if (hc > 0 && (int)hc < n_threads) n_threads = (int)hc;
  }
  if (n_threads > (int)eng->bands.size()) n_threads = (int)eng->bands.size();
  // Scratch: per band when workers will run concurrently; one shared
  // max-block instance in serial mode (the pre-pool memory footprint —
  // matters on embedded targets like Bela, which pin n_threads=1).
  if (precision == 0) {
    if (n_threads > 1) {
      eng->scratches.resize(eng->bands.size());
      for (size_t i = 0; i < eng->bands.size(); ++i) {
        eng->scratches[i].alloc(eng->bands[i].block);
        eng->bands[i].sc = &eng->scratches[i];
      }
    } else {
      int maxb = 0;
      for (auto& b : eng->bands) maxb = b.block > maxb ? b.block : maxb;
      eng->scratches.resize(1);
      eng->scratches[0].alloc(maxb);
      for (auto& b : eng->bands) b.sc = &eng->scratches[0];
    }
  } else {
    if (n_threads > 1) {
      eng->scratchesf.resize(eng->bands.size());
      for (size_t i = 0; i < eng->bands.size(); ++i) {
        eng->scratchesf[i].alloc(eng->bands[i].block);
        eng->bands[i].scf = &eng->scratchesf[i];
      }
    } else {
      int maxb = 0;
      for (auto& b : eng->bands) maxb = b.block > maxb ? b.block : maxb;
      eng->scratchesf.resize(1);
      eng->scratchesf[0].alloc(maxb);
      for (auto& b : eng->bands) b.scf = &eng->scratchesf[0];
    }
  }
  eng->next = eng->bands.size();
  eng->remaining = 0;
  for (int i = 0; i + 1 < n_threads; ++i)
    eng->workers.emplace_back(worker_loop, eng);
  return eng;
}

}  // namespace

extern "C" {

// xover_mode: 0 = raised_cosine (live-fade), 1 = hard_zero
// synthesis:  0 = wola, 1 = analysis (C++-reference parity)
// rounding:   0 = python, 1 = cpp
// window:     0 = blackman_harris, 1 = sqrt_hann, 2 = hann, 3 = blackman,
//             4 = hamming, 5 = rect (see make_window)
// n_threads:  total threads processing bands (main included): 1 = serial,
//             0 = auto (min(n_bands, hardware_concurrency)).  Band outputs
//             are summed in band order on the caller's thread, so results
//             are bit-identical at any thread count.
// precision:  0 = double working precision (parity mode, matches the
//             oracle's float64 spectra), 1 = float32 fast mode (half the
//             memory traffic / twice the SIMD width; >60 dB vs oracle).
void* upmix_create(double sr, int hw_block, const double* edges, int n_edges,
                   int xover_mode, int synthesis, int rounding,
                   double threshold_multi, double xo_fraction, int window,
                   int n_threads, int precision) {
  return engine_create(sr, hw_block, edges, n_edges, xover_mode, synthesis,
                       rounding, threshold_multi, xo_fraction, window,
                       nullptr, nullptr, 0, n_threads, precision);
}

// Custom analysis windows: win_data is every band's window concatenated
// (float32); win_off has n_win+1 entries, band i = win_data[off[i],
// off[i+1]) and MUST be exactly that band's block size long (the caller
// derives block sizes from the same chain_bands sizing rule).  n_win
// must cover every band the edges produce.
void* upmix_create_custom(double sr, int hw_block, const double* edges,
                          int n_edges, int xover_mode, int synthesis,
                          int rounding, double threshold_multi,
                          double xo_fraction, const float* win_data,
                          const long long* win_off, int n_win,
                          int n_threads, int precision) {
  if (!win_data || !win_off || n_win < 1) return nullptr;
  return engine_create(sr, hw_block, edges, n_edges, xover_mode, synthesis,
                       rounding, threshold_multi, xo_fraction, 0, win_data,
                       win_off, n_win, n_threads, precision);
}

void upmix_destroy(void* h) { delete static_cast<Engine*>(h); }

int upmix_num_bands(void* h) {
  return (int)static_cast<Engine*>(h)->bands.size();
}

int upmix_band_block_size(void* h, int i) {
  Engine* e = static_cast<Engine*>(h);
  if (i < 0 || i >= (int)e->bands.size()) return 0;
  return e->bands[i].block;
}

int upmix_latency_blocks(void*) { return kWarmupBlocks; }

// Process ONE hardware block: inL/inR length hw -> outC/outLs/outRs length
// hw.  Returns 1 if real output was produced, 0 during warmup (outputs are
// zero-filled — the reference's "not ready -> silence" degraded mode).
int upmix_process_block(void* h, const float* inL, const float* inR,
                        float* outC, float* outLs, float* outRs) {
  Engine& e = *static_cast<Engine*>(h);
  int hw = e.hw, hl = e.hist_len;
  // Slide history left by hw, append the new block.
  std::memmove(e.histL.data(), e.histL.data() + hw, sizeof(float) * (hl - hw));
  std::memmove(e.histR.data(), e.histR.data() + hw, sizeof(float) * (hl - hw));
  std::memcpy(e.histL.data() + hl - hw, inL, sizeof(float) * hw);
  std::memcpy(e.histR.data() + hl - hw, inR, sizeof(float) * hw);
  e.t += 1;

  std::memset(outC, 0, sizeof(float) * hw);
  std::memset(outLs, 0, sizeof(float) * hw);
  std::memset(outRs, 0, sizeof(float) * hw);
  if (e.t < kWarmupBlocks) return 0;

  if (e.workers.empty()) {
    // Serial path (n_threads = 1): process bands in order on this thread.
    for (auto& b : e.bands) band_process(e, b);
  } else {
    // Publish the batch; workers and this thread claim bands until the
    // queue drains, then wait for the stragglers.  Band outputs land in
    // band-owned buffers — no locking around the DSP, no allocation.
    {
      std::lock_guard<std::mutex> lk(e.mu);
      e.next = 0;
      e.remaining = (int)e.bands.size();
    }
    e.cv_work.notify_all();
    for (;;) {
      size_t idx;
      {
        std::lock_guard<std::mutex> lk(e.mu);
        if (e.next >= e.bands.size()) break;
        idx = e.next++;
      }
      band_process(e, e.bands[idx]);
      {
        std::lock_guard<std::mutex> lk(e.mu);
        --e.remaining;
      }
    }
    {
      std::unique_lock<std::mutex> lk(e.mu);
      e.cv_done.wait(lk, [&e] { return e.remaining == 0; });
    }
  }
  // Deterministic reduction: sum band outputs in band order on the
  // caller's thread — bit-identical at any thread count.
  for (auto& b : e.bands) {
    for (int i = 0; i < hw; ++i) {
      outC[i] += b.blkC[i];
      outLs[i] += b.blkLs[i];
      outRs[i] += b.blkRs[i];
    }
  }
  return 1;
}

// Convenience: stereo_sum streaming over n samples (n must be a multiple
// of the hw block).  out = side + 0.5 * center (reference Bela mix).
int upmix_process_stereo_sum(void* h, const float* inL, const float* inR,
                             int n, float* outL, float* outR) {
  Engine& e = *static_cast<Engine*>(h);
  if (n % e.hw != 0) return -1;
  std::vector<float> c(e.hw), ls(e.hw), rs(e.hw);
  for (int s = 0; s < n; s += e.hw) {
    upmix_process_block(h, inL + s, inR + s, c.data(), ls.data(), rs.data());
    for (int i = 0; i < e.hw; ++i) {
      outL[s + i] = ls[i] + 0.5f * c[i];
      outR[s + i] = rs[i] + 0.5f * c[i];
    }
  }
  return 0;
}

void upmix_reset(void* h) {
  Engine& e = *static_cast<Engine*>(h);
  std::fill(e.histL.begin(), e.histL.end(), 0.0f);
  std::fill(e.histR.begin(), e.histR.end(), 0.0f);
  e.t = 0;
  for (auto& b : e.bands) std::fill(b.accum.begin(), b.accum.end(), 0.0f);
}

}  // extern "C"
