// Frozen copy kept by the benchmark's reference (sebench/reference/pesq.py
// builds it into sebench/_build/); the system under test builds its own.
//
// P.862-family perceptual speech-quality estimator (wideband, 16 kHz).
//
// Native C++ replacement for the reference's `pesq` PyPI dependency (ITU C
// code via Cython), which sits inside the training loop (discriminator
// labels, reference models/discriminator.py:17-32), the data collator's
// silence check (datasets/voicebank_dataset.py:89), and the eval stack
// (utils/compute_metrics.py:61).  Exposed to Python via ctypes
// (speech_enhancement_tpu_torch/metrics/pesq.py, which builds it with g++
// at first use) with a thread-pool batch entry point replacing the
// reference's joblib fan-out.  A copy of native/pesq/pesq.cc, so that the
// port needs nothing of the JAX package; the code of the two must not
// diverge (tests/test_torch_pesq.py compares their scores).
//
// Implementation notes: this follows the P.862 signal flow — level
// alignment to 10^7 over the 350-3250 Hz band, wideband input IIR filter,
// envelope-based crude time alignment, 32 ms / 50% Hann-windowed power
// spectra, Bark-band grouping (49 bands), partial frequency- and
// gain-compensation, Zwicker loudness transform, asymmetric +
// symmetric disturbance aggregation (L2 over bands, L6 over frames within
// split-seconds, L2 over split-seconds), raw score 4.5 - 0.1 d_sym -
// 0.0309 d_asym, and the P.862.2 wideband MOS-LQO logistic map.  Time
// alignment is a global constant-delay estimate followed by per-utterance
// fine alignment (envelope-detected speech bursts, bounded local
// cross-correlation — the P.862 utterance-splitting stage); sample-aligned
// pairs (this framework's construction) pass through unchanged.  Scores are
// calibrated to the published anchor behavior (identical signals -> 4.64)
// and are monotone in distortion; they are not guaranteed bit-exact
// against the ITU binary.

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

// ----------------------------------------------------------------------
// Small iterative radix-2 complex FFT (sizes are powers of two).
// ----------------------------------------------------------------------
void fft(std::vector<double>& re, std::vector<double>& im) {
  const size_t n = re.size();
  for (size_t i = 1, j = 0; i < n; ++i) {
    size_t bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) {
      std::swap(re[i], re[j]);
      std::swap(im[i], im[j]);
    }
  }
  for (size_t len = 2; len <= n; len <<= 1) {
    const double ang = -2.0 * kPi / static_cast<double>(len);
    const double wr = std::cos(ang), wi = std::sin(ang);
    for (size_t i = 0; i < n; i += len) {
      double cr = 1.0, ci = 0.0;
      for (size_t k = 0; k < len / 2; ++k) {
        const size_t a = i + k, b = i + k + len / 2;
        const double tr = re[b] * cr - im[b] * ci;
        const double ti = re[b] * ci + im[b] * cr;
        re[b] = re[a] - tr;
        im[b] = im[a] - ti;
        re[a] += tr;
        im[a] += ti;
        const double ncr = cr * wr - ci * wi;
        ci = cr * wi + ci * wr;
        cr = ncr;
      }
    }
  }
}

size_t next_pow2(size_t n) {
  size_t p = 1;
  while (p < n) p <<= 1;
  return p;
}

// ----------------------------------------------------------------------
// Bark scale helpers (Zwicker / Terhardt formulas).
// ----------------------------------------------------------------------
double hz_to_bark(double f) {
  return 13.0 * std::atan(0.00076 * f) +
         3.5 * std::atan((f / 7500.0) * (f / 7500.0));
}

// Hearing threshold in the model's internal power units, sampled on the
// 49-band wideband Bark grid (the published P.862 wideband threshold
// curve: huge below ~100 Hz, minimum ~0.24 around 3 kHz, rising again).
const double kAbsThreshPower49[49] = {
    51286152.0, 2454709.5, 70794.59, 4897.789, 1174.897, 389.045, 104.712,
    45.708, 17.782, 9.772, 4.897, 3.090, 1.905, 1.258, 0.977, 0.724, 0.562,
    0.468, 0.447, 0.324, 0.323, 0.293, 0.258, 0.255, 0.252, 0.249, 0.246,
    0.244, 0.243, 0.243, 0.243, 0.245, 0.248, 0.253, 0.261, 0.271, 0.288,
    0.311, 0.342, 0.383, 0.435, 0.500, 0.579, 0.676, 0.793, 0.934, 1.101,
    1.298, 1.529};

struct BarkModel {
  int n_bands;
  std::vector<int> first_bin;    // per band, inclusive
  std::vector<int> n_bins;       // per band
  std::vector<double> center_bark;
  std::vector<double> width_bark;
  std::vector<double> abs_thresh_power;  // internal power units
  std::vector<double> center_hz;
};

// 49 Bark bands over [first_hz, nyquist] on a uniform Bark grid, FFT bins
// grouped by their center frequency (the ITU tables follow the same
// construction with hand-tuned rounding).
BarkModel make_bark_model(int fs, int nfft, int n_bands) {
  BarkModel m;
  m.n_bands = n_bands;
  const int n_bins = nfft / 2;  // exclude Nyquist bin for grouping
  const double bin_hz = static_cast<double>(fs) / nfft;
  const double bark_lo = hz_to_bark(0.5 * bin_hz);
  const double bark_hi = hz_to_bark((n_bins - 0.5) * bin_hz);
  const double dbark = (bark_hi - bark_lo) / n_bands;

  m.first_bin.assign(n_bands, -1);
  m.n_bins.assign(n_bands, 0);
  m.center_bark.resize(n_bands);
  m.width_bark.assign(n_bands, dbark);
  m.abs_thresh_power.resize(n_bands);
  m.center_hz.resize(n_bands);

  for (int bin = 1; bin < n_bins; ++bin) {  // skip DC
    const double f = bin * bin_hz;
    int band = static_cast<int>((hz_to_bark(f) - bark_lo) / dbark);
    band = std::min(std::max(band, 0), n_bands - 1);
    if (m.first_bin[band] < 0) m.first_bin[band] = bin;
    m.n_bins[band] += 1;
  }
  // empty high bands would only occur for tiny FFTs; guard anyway
  for (int b = 0; b < n_bands; ++b) {
    if (m.first_bin[b] < 0) {
      m.first_bin[b] = n_bins - 1;
      m.n_bins[b] = 1;
    }
    m.center_bark[b] = bark_lo + (b + 0.5) * dbark;
    // invert bark -> hz center by bisection
    double lo = 0.0, hi = fs / 2.0;
    for (int it = 0; it < 60; ++it) {
      const double mid = 0.5 * (lo + hi);
      if (hz_to_bark(mid) < m.center_bark[b]) lo = mid; else hi = mid;
    }
    m.center_hz[b] = 0.5 * (lo + hi);
    m.abs_thresh_power[b] = n_bands == 49 ? kAbsThreshPower49[b] : 1.0;
  }
  return m;
}

// ----------------------------------------------------------------------
// IIR filtering (cascade of biquads, direct form II transposed).
// ----------------------------------------------------------------------
struct Biquad {
  double b0, b1, b2, a1, a2;
};

void filter_inplace(std::vector<double>& x, const std::vector<Biquad>& sos) {
  for (const auto& s : sos) {
    double z1 = 0.0, z2 = 0.0;
    for (auto& v : x) {
      const double in = v;
      const double out = s.b0 * in + z1;
      z1 = s.b1 * in - s.a1 * out + z2;
      z2 = s.b2 * in - s.a2 * out;
      v = out;
    }
  }
}

// P.862.2 wideband input filter (single high-pass SOS, 16 kHz).
const std::vector<Biquad> kWbInputFilter = {
    {2.6657628, -5.3315255, 2.6657628, -1.8890331, 0.89487434}};

// ----------------------------------------------------------------------
// Level alignment: scale to 10^7 power over the 350-3250 Hz band.
// ----------------------------------------------------------------------
double bandpass_power(const std::vector<double>& x, int fs) {
  const size_t n = next_pow2(x.size());
  std::vector<double> re(n, 0.0), im(n, 0.0);
  std::copy(x.begin(), x.end(), re.begin());
  fft(re, im);
  const double bin_hz = static_cast<double>(fs) / n;
  const int lo = static_cast<int>(350.0 / bin_hz);
  const int hi = static_cast<int>(3250.0 / bin_hz);
  double p = 0.0;
  for (int k = lo; k <= hi && k < static_cast<int>(n / 2); ++k)
    p += re[k] * re[k] + im[k] * im[k];
  // Parseval: power per sample over the band (x2 for negative freqs)
  return 2.0 * p / (static_cast<double>(n) * static_cast<double>(x.size()));
}

// ----------------------------------------------------------------------
// Global constant-delay estimate: sample-level FFT cross-correlation of
// the full signals, argmax over +/- 500 ms.  (An earlier 4 ms
// log-energy-envelope version mis-estimated noisy pairs by thousands of
// samples — noise fills the silent gaps and flattens the envelope, so
// spurious envelope-correlation peaks win; the raw-waveform correlation
// peak at the true delay is far more robust and exact to the sample.)
// ----------------------------------------------------------------------
int estimate_delay(const std::vector<double>& ref,
                   const std::vector<double>& deg, int fs) {
  if (ref.size() < 256 || deg.size() < 256) return 0;
  const size_t n = next_pow2(ref.size() + deg.size());
  std::vector<double> ar(n, 0.0), ai(n, 0.0), br(n, 0.0), bi(n, 0.0);
  std::copy(ref.begin(), ref.end(), ar.begin());
  std::copy(deg.begin(), deg.end(), br.begin());
  fft(ar, ai);
  fft(br, bi);
  // c[lag] = sum_i ref[i] * deg[i + lag]: conj(A)*B, inverse FFT by the
  // conjugation trick (real-part argmax is scale-invariant, skip the /n)
  std::vector<double> cr(n), ci(n);
  for (size_t k = 0; k < n; ++k) {
    cr[k] = ar[k] * br[k] + ai[k] * bi[k];
    ci[k] = -(ar[k] * bi[k] - ai[k] * br[k]);
  }
  fft(cr, ci);
  const int max_lag = std::min<int>(fs / 2, static_cast<int>(n) / 2 - 1);
  int best_lag = 0;
  double best = -1e300;
  for (int lag = -max_lag; lag <= max_lag; ++lag) {
    const size_t idx = lag >= 0 ? lag : n + lag;
    if (cr[idx] > best) {
      best = cr[idx];
      best_lag = lag;
    }
  }
  return best_lag;  // samples: deg delayed by best_lag vs ref
}

// ----------------------------------------------------------------------
// Per-utterance fine alignment (the P.862 utterance-splitting stage).
//
// After global constant-delay compensation, detect speech utterances on
// the reference via the 4 ms log-energy envelope, estimate a bounded
// local delay per utterance (coarse envelope cross-correlation refined by
// sample-level search), and rebuild the degraded signal with each
// utterance's segment locally shifted.  A local shift is only applied
// when its normalized correlation beats lag 0 by a clear margin, so
// sample-aligned pairs (this framework's training/eval case) pass through
// bit-identically and calibration anchors are unaffected.
// ----------------------------------------------------------------------
void align_utterances(const std::vector<double>& ref,
                      std::vector<double>& deg, int fs) {
  const int frame = fs / 250;  // 4 ms
  const size_t nf = std::min(ref.size(), deg.size()) / frame;
  if (nf < 75) return;  // < 300 ms: nothing to split
  const int max_lag = (3 * fs) / 40;  // +/- 75 ms local search window

  // speech activity on the reference envelope: within 25 dB of the peak
  std::vector<double> e(nf);
  double peak = -1e300;
  for (size_t i = 0; i < nf; ++i) {
    double s = 0.0;
    for (int j = 0; j < frame; ++j)
      s += ref[i * frame + j] * ref[i * frame + j];
    e[i] = 10.0 * std::log10(s + 1e-10);
    peak = std::max(peak, e[i]);
  }
  std::vector<char> act(nf);
  for (size_t i = 0; i < nf; ++i) act[i] = e[i] > peak - 25.0;
  // merge gaps < 200 ms so one utterance spans short pauses
  const int min_gap = 50;
  int last_on = -1;
  for (size_t i = 0; i < nf; ++i) {
    if (!act[i]) continue;
    if (last_on >= 0 && static_cast<int>(i) - last_on < min_gap)
      for (int j = last_on + 1; j < static_cast<int>(i); ++j) act[j] = 1;
    last_on = static_cast<int>(i);
  }

  std::vector<double> out = deg;
  size_t i = 0;
  while (i < nf) {
    if (!act[i]) {
      ++i;
      continue;
    }
    size_t s = i;
    while (i < nf && act[i]) ++i;
    const size_t e_fr = i;
    if (static_cast<int>(e_fr - s) < 25) continue;  // < 100 ms burst
    const int lo = static_cast<int>(s) * frame;
    const int hi = static_cast<int>(e_fr) * frame;

    // coarse: envelope cross-correlation over frame-granular lags
    const int nseg = static_cast<int>(e_fr - s);
    auto seg_env = [&](const std::vector<double>& x, int start_fr,
                       int count) {
      std::vector<double> env(count, 0.0);
      for (int f = 0; f < count; ++f) {
        const int base = (start_fr + f) * frame;
        if (base < 0 ||
            base + frame > static_cast<int>(x.size()))
          continue;
        double ss = 0.0;
        for (int j = 0; j < frame; ++j) ss += x[base + j] * x[base + j];
        env[f] = std::log10(ss + 1e-10);
      }
      // mean-center: raw log-energy dot products are dominated by the
      // (negative) baseline, not the alignment
      double m = 0.0;
      for (double v : env) m += v;
      m /= count;
      for (double& v : env) v -= m;
      return env;
    };
    const std::vector<double> er = seg_env(ref, static_cast<int>(s), nseg);
    const int max_lag_fr = max_lag / frame;
    int best_fr = 0;
    double best_fr_c = -1e300;
    for (int lag = -max_lag_fr; lag <= max_lag_fr; ++lag) {
      const std::vector<double> ed =
          seg_env(deg, static_cast<int>(s) + lag, nseg);
      double c = 0.0;
      for (int f = 0; f < nseg; ++f) c += er[f] * ed[f];
      if (c > best_fr_c) {
        best_fr_c = c;
        best_fr = lag;
      }
    }

    // fine: normalized sample cross-correlation around the coarse lag
    auto ncorr = [&](int lag) {
      double c = 0.0, pr = 1e-10, pd = 1e-10;
      for (int t = lo; t < hi; ++t) {
        const int u = t + lag;
        if (u < 0 || u >= static_cast<int>(deg.size())) continue;
        c += ref[t] * deg[u];
        pr += ref[t] * ref[t];
        pd += deg[u] * deg[u];
      }
      return c / std::sqrt(pr * pd);
    };
    const int center = best_fr * frame;
    int best = 0;
    double best_c = ncorr(0);
    const double r0 = best_c;
    for (int lag = center - frame; lag <= center + frame; ++lag) {
      if (lag == 0) continue;
      const double c = ncorr(lag);
      if (c > best_c) {
        best_c = c;
        best = lag;
      }
    }
    // apply only a clearly better non-zero shift (keeps aligned pairs
    // bit-identical)
    if (std::getenv("SE_PESQ_DEBUG"))
      std::fprintf(stderr,
                   "[pesq] utt [%d,%d): coarse %d fine %d r0=%.3f rb=%.3f\n",
                   lo, hi, center, best, r0, best_c);
    if (best != 0 && best_c > r0 + 0.05) {
      for (int t = lo; t < hi && t < static_cast<int>(out.size()); ++t) {
        const int u = t + best;
        out[t] = (u >= 0 && u < static_cast<int>(deg.size())) ? deg[u] : 0.0;
      }
    }
  }
  deg.swap(out);
}

// ----------------------------------------------------------------------
// Perceptual model.
// ----------------------------------------------------------------------
struct Frames {
  // [n_frames][n_bands] pitch power densities
  std::vector<std::vector<double>> pitch_pow;
  std::vector<double> total_audible;  // per frame, above-threshold power
};

Frames compute_pitch_powers(const std::vector<double>& x, int fs,
                            const BarkModel& bark, double sp) {
  const int nfft = fs == 16000 ? 512 : 256;  // 32 ms
  const int hop = nfft / 2;
  const int n_frames =
      x.size() >= static_cast<size_t>(nfft)
          ? static_cast<int>((x.size() - nfft) / hop) + 1
          : 0;
  std::vector<double> window(nfft);
  for (int i = 0; i < nfft; ++i)
    window[i] = 0.5 * (1.0 - std::cos(2.0 * kPi * i / nfft));

  Frames out;
  out.pitch_pow.resize(n_frames);
  out.total_audible.resize(n_frames);
  std::vector<double> re(nfft), im(nfft);
  for (int f = 0; f < n_frames; ++f) {
    for (int i = 0; i < nfft; ++i) {
      re[i] = x[f * hop + i] * window[i];
      im[i] = 0.0;
    }
    fft(re, im);
    auto& bands = out.pitch_pow[f];
    bands.assign(bark.n_bands, 0.0);
    for (int b = 0; b < bark.n_bands; ++b) {
      double p = 0.0;
      for (int k = bark.first_bin[b]; k < bark.first_bin[b] + bark.n_bins[b];
           ++k)
        p += re[k] * re[k] + im[k] * im[k];
      bands[b] = p * sp;
    }
    double aud = 0.0;
    for (int b = 0; b < bark.n_bands; ++b)
      if (bands[b] > bark.abs_thresh_power[b]) aud += bands[b];
    out.total_audible[f] = aud;
  }
  return out;
}

double zwicker_loudness(double power, double thresh, double center_bark,
                        double sl) {
  double h = center_bark < 4.0 ? 6.0 / (center_bark + 2.0) : 1.0;
  if (h > 2.0) h = 2.0;
  h = std::pow(h, 0.15);
  const double mzp = 0.23 * h;
  if (power <= thresh) return 0.0;
  const double s =
      std::pow(thresh / 0.5, mzp) *
      (std::pow(0.5 + 0.5 * power / thresh, mzp) - 1.0);
  return sl * s;
}

// weighted Lp over bands: W * (sum_b (w_b |x_b|)^p / W)^(1/p)
double pseudo_lp(const std::vector<double>& x, const std::vector<double>& w,
                 double p) {
  double tot_w = 0.0, acc = 0.0;
  for (size_t b = 0; b < x.size(); ++b) {
    acc += std::pow(std::fabs(x[b]) * w[b], p);
    tot_w += w[b];
  }
  if (tot_w <= 0.0) return 0.0;
  return tot_w * std::pow(acc / tot_w, 1.0 / p);
}

// Lp over a window of frame values
double lp_norm(const std::vector<double>& v, size_t lo, size_t hi, double p) {
  double acc = 0.0;
  size_t n = 0;
  for (size_t i = lo; i < hi && i < v.size(); ++i, ++n)
    acc += std::pow(std::fabs(v[i]), p);
  if (n == 0) return 0.0;
  return std::pow(acc / n, 1.0 / p);
}

struct PesqResult {
  double mos;   // mapped MOS-LQO (wb)
  int error;    // 0 ok; nonzero = no usable signal
};

PesqResult pesq_internal(const float* ref_in, size_t n_ref,
                         const float* deg_in, size_t n_deg, int fs) {
  PesqResult res{-1.0, 0};
  if (fs != 16000 && fs != 8000) {
    res.error = 2;
    return res;
  }
  if (n_ref < static_cast<size_t>(fs) / 4 ||
      n_deg < static_cast<size_t>(fs) / 4) {
    res.error = 3;  // under 0.25 s of audio
    return res;
  }
  std::vector<double> ref(ref_in, ref_in + n_ref);
  std::vector<double> deg(deg_in, deg_in + n_deg);

  // ITU scale convention: inputs are 16-bit-PCM-scale samples.  Accept
  // float [-1, 1] audio by rescaling when magnitudes are small.
  auto max_abs = [](const std::vector<double>& v) {
    double m = 0;
    for (double x : v) m = std::max(m, std::fabs(x));
    return m;
  };
  if (max_abs(ref) <= 2.0 && max_abs(deg) <= 2.0) {
    for (auto& v : ref) v *= 32768.0;
    for (auto& v : deg) v *= 32768.0;
  }

  // ---- level alignment to 10^7 band power
  const double pr = bandpass_power(ref, fs);
  const double pd = bandpass_power(deg, fs);
  if (pr < 1e-6 || pd < 1e-6) {
    res.error = 4;  // silent input (the reference's collator retry trigger)
    return res;
  }
  const double target = 1e7;
  const double gr = std::sqrt(target / pr), gd = std::sqrt(target / pd);
  for (auto& v : ref) v *= gr;
  for (auto& v : deg) v *= gd;

  // ---- wideband input filter
  filter_inplace(ref, kWbInputFilter);
  filter_inplace(deg, kWbInputFilter);

  // ---- constant-delay compensation
  const int delay = estimate_delay(ref, deg, fs);
  if (delay > 0) {
    deg.erase(deg.begin(), deg.begin() + std::min<size_t>(delay, deg.size()));
  } else if (delay < 0) {
    ref.erase(ref.begin(),
              ref.begin() + std::min<size_t>(-delay, ref.size()));
  }
  const size_t n = std::min(ref.size(), deg.size());
  ref.resize(n);
  deg.resize(n);

  if (std::getenv("SE_PESQ_DEBUG"))
    std::fprintf(stderr, "[pesq] global delay estimate: %d\n", delay);

  // ---- per-utterance fine alignment (P.862 utterance splitting)
  align_utterances(ref, deg, fs);

  // ---- perceptual model
  const double sp = 6.910853e-6;   // power scaling, 16 kHz (pesqpar)
  const double sl = 1.866055e-1;   // loudness scaling, 16 kHz
  const BarkModel bark = make_bark_model(fs, fs == 16000 ? 512 : 256, 49);
  Frames fr = compute_pitch_powers(ref, fs, bark, sp);
  Frames fd = compute_pitch_powers(deg, fs, bark, sp);
  const int n_frames = static_cast<int>(
      std::min(fr.pitch_pow.size(), fd.pitch_pow.size()));
  if (n_frames < 4) {
    res.error = 3;
    return res;
  }

  // frequency compensation: equalize the reference toward the degraded
  // per band, factor clipped to [-20 dB, +20 dB], estimated over frames
  // with audible reference power.
  std::vector<double> band_factor(bark.n_bands, 1.0);
  {
    std::vector<double> sum_r(bark.n_bands, 0.0), sum_d(bark.n_bands, 0.0);
    for (int f = 0; f < n_frames; ++f) {
      if (fr.total_audible[f] < 1e4) continue;
      for (int b = 0; b < bark.n_bands; ++b) {
        sum_r[b] += fr.pitch_pow[f][b];
        sum_d[b] += fd.pitch_pow[f][b];
      }
    }
    for (int b = 0; b < bark.n_bands; ++b) {
      double factor = (sum_d[b] + 1000.0) / (sum_r[b] + 1000.0);
      band_factor[b] = std::min(std::max(factor, 0.01), 100.0);
    }
  }

  // short-term gain compensation of the degraded signal per frame
  std::vector<double> frame_gain(n_frames, 1.0);
  {
    double h = 1.0;
    for (int f = 0; f < n_frames; ++f) {
      double tr = 0.0, td = 0.0;
      for (int b = 0; b < bark.n_bands; ++b) {
        tr += fr.pitch_pow[f][b] * band_factor[b];
        td += fd.pitch_pow[f][b];
      }
      double g = (tr + 5e3) / (td + 5e3);
      g = std::min(std::max(g, 3e-4), 5.0);
      h = 0.8 * h + 0.2 * g;
      frame_gain[f] = h;
    }
  }

  // disturbances per frame
  std::vector<double> d_sym(n_frames), d_asym(n_frames);
  std::vector<double> sym_bands(bark.n_bands), asym_bands(bark.n_bands);
  for (int f = 0; f < n_frames; ++f) {
    for (int b = 0; b < bark.n_bands; ++b) {
      const double pref = fr.pitch_pow[f][b] * band_factor[b];
      const double pdeg = fd.pitch_pow[f][b] * frame_gain[f];
      const double lr = zwicker_loudness(pref, bark.abs_thresh_power[b],
                                         bark.center_bark[b], sl);
      const double ld = zwicker_loudness(pdeg, bark.abs_thresh_power[b],
                                         bark.center_bark[b], sl);
      double d = ld - lr;
      const double m = 0.25 * std::min(ld, lr);
      d = d > m ? d - m : (d < -m ? d + m : 0.0);
      sym_bands[b] = d;
      // asymmetry factor from the power ratio
      double ratio = (pdeg + 50.0) / (pref + 50.0);
      double af = std::pow(ratio, 1.2);
      if (af < 3.0) af = 0.0;
      if (af > 12.0) af = 12.0;
      asym_bands[b] = d * af;
    }
    d_sym[f] = pseudo_lp(sym_bands, bark.width_bark, 2.0);
    d_asym[f] = pseudo_lp(asym_bands, bark.width_bark, 1.0);

    // emphasis: quiet reference frames weigh less
    double tr = 0.0;
    for (int b = 0; b < bark.n_bands; ++b)
      tr += fr.pitch_pow[f][b] * band_factor[b];
    const double hpow = std::pow((tr + 1e5) / 1e7, 0.04);
    d_sym[f] = std::min(d_sym[f] / hpow, 45.0);
    d_asym[f] = std::min(d_asym[f] / hpow, 45.0);
  }

  // time aggregation: L6 over 20-frame split-seconds (50% overlap), then
  // L2 over split-seconds.
  const int ssec = 20;
  std::vector<double> s_sym, s_asym;
  for (int start = 0; start < n_frames; start += ssec / 2) {
    s_sym.push_back(lp_norm(d_sym, start, start + ssec, 6.0));
    s_asym.push_back(lp_norm(d_asym, start, start + ssec, 6.0));
  }
  // 0.8: empirical calibration aligning the white-noise SNR response with
  // the published P.862.2 curve (see tests/test_pesq.py anchors)
  const double kCal = 0.8;
  const double D = kCal * lp_norm(s_sym, 0, s_sym.size(), 2.0);
  const double DA = kCal * lp_norm(s_asym, 0, s_asym.size(), 2.0);

  const double raw = 4.5 - 0.1 * D - 0.0309 * DA;
  // P.862.2 wideband MOS-LQO mapping
  const double mos = 0.999 + 4.0 / (1.0 + std::exp(-1.3669 * raw + 3.8224));
  res.mos = mos;
  return res;
}

}  // namespace

extern "C" {

// Returns MOS-LQO; negative values are error codes (-error).
double pesq_mos(const float* ref, int64_t n_ref, const float* deg,
                int64_t n_deg, int fs) {
  const PesqResult r = pesq_internal(ref, static_cast<size_t>(n_ref), deg,
                                     static_cast<size_t>(n_deg), fs);
  return r.error ? -static_cast<double>(r.error) : r.mos;
}

// Batch API over equal-length pairs with an internal thread pool —
// replaces the reference's joblib Parallel fan-out (discriminator.py:27).
void pesq_batch(const float* ref, const float* deg, int64_t batch,
                int64_t length, int fs, int n_threads, double* out) {
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  if (n_threads <= 0) n_threads = 1;
  std::vector<std::thread> pool;
  std::atomic<int64_t> next{0};
  auto worker = [&]() {
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= batch) return;
      out[i] = pesq_mos(ref + i * length, length, deg + i * length, length, fs);
    }
  };
  const int use = static_cast<int>(
      std::min<int64_t>(n_threads, batch > 0 ? batch : 1));
  for (int t = 0; t < use; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // extern "C"
