"""Composite speech-quality metrics: WSS, LLR, SNR/SSNR, STOI, and the
CSIG/CBAK/COVL regressions (the port's copy of
speech_enhancement_tpu/metrics/composite.py).

The reference's MATLAB-derived implementation (utils/compute_metrics.py),
vectorized over frames in numpy and scipy.  PESQ comes from the port's
native engine (``metrics/pesq.py``).  Host-side evaluation metrics over
decoded waveforms.
"""

from __future__ import annotations

import math

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view
from scipy import signal as sp_signal


def _hann_like(winlength: int) -> np.ndarray:
    """The reference's window: 0.5*(1 - cos(2*pi*(1..N)/(N+1)))."""
    return 0.5 * (1 - np.cos(2 * math.pi * np.arange(1, winlength + 1) / (winlength + 1)))


def _frames(x: np.ndarray, winlength: int, skiprate: int, num_frames: int):
    view = sliding_window_view(x, winlength)[::skiprate]
    return view[:num_frames]


# --------------------------------------------------------------------------
# WSS — weighted spectral slope distortion (Klatt 1982)
# --------------------------------------------------------------------------

_CENT_FREQ = np.array([
    50.0, 120.0, 190.0, 260.0, 330.0, 400.0, 470.0, 540.0, 617.372,
    703.378, 798.717, 904.128, 1020.38, 1148.30, 1288.72, 1442.54,
    1610.70, 1794.16, 1993.93, 2211.08, 2446.71, 2701.97, 2978.04,
    3276.17, 3597.63,
])
_BANDWIDTH = np.array([
    70.0, 70.0, 70.0, 70.0, 70.0, 70.0, 70.0, 77.3724, 86.0056, 95.3398,
    105.411, 116.256, 127.914, 140.423, 153.823, 168.154, 183.457,
    199.776, 217.153, 235.631, 255.255, 276.072, 298.126, 321.465,
    346.136,
])


def _critical_band_filters(sample_rate: int, n_fftby2: int) -> np.ndarray:
    max_freq = sample_rate / 2
    min_factor = math.exp(-30.0 / (2.0 * 2.303))
    j = np.arange(n_fftby2)
    f0 = (_CENT_FREQ / max_freq) * n_fftby2
    bw = (_BANDWIDTH / max_freq) * n_fftby2
    norm = np.log(_BANDWIDTH[0]) - np.log(_BANDWIDTH)
    filt = np.exp(
        -11.0 * ((j[None, :] - np.floor(f0)[:, None]) / bw[:, None]) ** 2
        + norm[:, None]
    )
    return np.where(filt > min_factor, filt, 0.0)


def _run_end_peaks(energy: np.ndarray, slope: np.ndarray) -> np.ndarray:
    """Nearest-peak energies per band (frames-vectorized replica of the
    reference's left/right while-loop search, compute_metrics.py:152-180)."""
    frames, nb = slope.shape  # nb = num_crit - 1 slope entries
    # R[n]: smallest m >= n with slope[m] <= 0 (capped at nb)
    R = np.full((frames, nb + 1), nb, dtype=np.int64)
    for n in range(nb - 1, -1, -1):
        R[:, n] = np.where(slope[:, n] <= 0, n, R[:, n + 1])
    # L[n]: largest m <= n with slope[m] > 0 (floored at -1)
    L = np.full((frames, nb + 1), -1, dtype=np.int64)
    for n in range(nb):
        L[:, n + 1] = np.where(slope[:, n] > 0, n, L[:, n])
    peaks = np.empty((frames, nb))
    rows = np.arange(frames)
    for i in range(nb):
        # right search exits at n = R[i] (slope[n] <= 0 or n == nb), peak E[n-1]
        peak_right = energy[rows, np.clip(R[:, i] - 1, 0, nb)]
        # left search exits at n = L[i] (slope[n] > 0 or n == -1), peak E[n+1]
        peak_left = energy[rows, np.clip(L[:, i + 1] + 1, 0, nb)]
        peaks[:, i] = np.where(slope[:, i] > 0, peak_right, peak_left)
    return peaks


def wss(clean: np.ndarray, processed: np.ndarray, sample_rate: int) -> np.ndarray:
    """Per-frame weighted spectral-slope distortion
    (compute_metrics.py:79-205)."""
    if len(clean) != len(processed):
        raise ValueError("Files must have same length.")
    winlength = int(round(30 * sample_rate / 1000))
    skiprate = winlength // 4
    num_crit = 25
    n_fft = int(2 ** np.ceil(np.log2(2 * winlength)))
    n_fftby2 = n_fft // 2
    Kmax, Klocmax = 20.0, 1.0

    crit_filter = _critical_band_filters(sample_rate, n_fftby2)
    num_frames = int(len(clean) / skiprate - winlength / skiprate)
    window = _hann_like(winlength)

    cf = _frames(clean / 32768.0, winlength, skiprate, num_frames) * window
    pf = _frames(processed / 32768.0, winlength, skiprate, num_frames) * window

    cspec = np.abs(np.fft.fft(cf, n_fft, axis=1)) ** 2
    pspec = np.abs(np.fft.fft(pf, n_fft, axis=1)) ** 2
    ce = 10 * np.log10(np.maximum(cspec[:, :n_fftby2] @ crit_filter.T, 1e-10))
    pe = 10 * np.log10(np.maximum(pspec[:, :n_fftby2] @ crit_filter.T, 1e-10))

    cs = ce[:, 1:num_crit] - ce[:, : num_crit - 1]
    ps = pe[:, 1:num_crit] - pe[:, : num_crit - 1]

    c_peak = _run_end_peaks(ce, cs)
    p_peak = _run_end_peaks(pe, ps)

    dbmax_c = np.max(ce, axis=1, keepdims=True)
    dbmax_p = np.max(pe, axis=1, keepdims=True)
    w_max_c = Kmax / (Kmax + dbmax_c - ce[:, : num_crit - 1])
    w_loc_c = Klocmax / (Klocmax + c_peak - ce[:, : num_crit - 1])
    w_c = w_max_c * w_loc_c
    w_max_p = Kmax / (Kmax + dbmax_p - pe[:, : num_crit - 1])
    w_loc_p = Klocmax / (Klocmax + p_peak - pe[:, : num_crit - 1])
    w_p = w_max_p * w_loc_p
    w = (w_c + w_p) / 2.0
    slope_diff = (cs - ps)[:, : num_crit - 1]
    return np.sum(w * slope_diff**2, axis=1) / np.sum(w, axis=1)


# --------------------------------------------------------------------------
# LLR — log-likelihood ratio via order-P LPC
# --------------------------------------------------------------------------


def _batch_lpc(frames: np.ndarray, order: int):
    """Levinson-Durbin over all frames at once.  Returns (R, A) with
    A = [1, -a_1..-a_P] LPC polynomial rows (compute_metrics.py:248-274)."""
    n = frames.shape[1]
    lags = np.arange(order + 1)
    R = np.empty((frames.shape[0], order + 1))
    for k in range(order + 1):
        R[:, k] = np.einsum("ij,ij->i", frames[:, : n - k], frames[:, k:])
    a = np.zeros((frames.shape[0], order))
    E = R[:, 0].copy()
    for i in range(order):
        if i == 0:
            sum_term = np.zeros(frames.shape[0])
        else:
            sum_term = np.einsum("ij,ij->i", a[:, :i], R[:, i:0:-1])
        rc = (R[:, i + 1] - sum_term) / E
        a_new = a.copy()
        a_new[:, i] = rc
        if i > 0:
            a_new[:, :i] = a[:, :i] - rc[:, None] * a[:, i - 1 :: -1][:, :i]
        a = a_new
        E = (1 - rc * rc) * E
    A = np.concatenate([np.ones((frames.shape[0], 1)), -a], axis=1)
    return R, A


def _toeplitz_quad(R: np.ndarray, A: np.ndarray) -> np.ndarray:
    """x^T Toeplitz(R) x batched: R[0]*c0 + 2*sum_lag R[lag]*c_lag where
    c_lag is the autocorrelation of A."""
    order = A.shape[1]
    c = np.empty_like(R)
    for lag in range(order):
        c[:, lag] = np.einsum("ij,ij->i", A[:, : order - lag], A[:, lag:])
    return R[:, 0] * c[:, 0] + 2.0 * np.sum(R[:, 1:] * c[:, 1:], axis=1)


def llr(clean: np.ndarray, processed: np.ndarray, sample_rate: int) -> np.ndarray:
    """Per-frame log-likelihood ratio (compute_metrics.py:208-245)."""
    if len(clean) != len(processed):
        raise ValueError("Both Speech Files must be same length.")
    winlength = int(round(30 * sample_rate / 1000))
    skiprate = winlength // 4
    P = 10 if sample_rate < 10000 else 16
    num_frames = (len(clean) - winlength) // skiprate
    window = _hann_like(winlength)

    cf = _frames(clean, winlength, skiprate, num_frames) * window
    pf = _frames(processed, winlength, skiprate, num_frames) * window
    R_c, A_c = _batch_lpc(cf, P)
    _, A_p = _batch_lpc(pf, P)
    numerator = _toeplitz_quad(R_c, A_p)
    denominator = _toeplitz_quad(R_c, A_c)
    return np.log(numerator / denominator)


# --------------------------------------------------------------------------
# SNR — overall + segmental
# --------------------------------------------------------------------------


def snr(clean: np.ndarray, processed: np.ndarray, sample_rate: int):
    """(overall SNR, per-frame segmental SNR clamped to [-10, 35] dB)
    (compute_metrics.py:277-315)."""
    if len(clean) != len(processed):
        raise ValueError("Both Speech Files must be same length.")
    overall = 10 * np.log10(
        np.sum(clean**2) / np.sum((clean - processed) ** 2)
    )
    winlength = round(30 * sample_rate / 1000)
    skiprate = winlength // 4
    num_frames = int(len(clean) / skiprate - winlength / skiprate)
    window = _hann_like(winlength)
    cf = _frames(clean, winlength, skiprate, num_frames) * window
    pf = _frames(processed, winlength, skiprate, num_frames) * window
    eps = np.spacing(1)
    sig = np.sum(cf**2, axis=1)
    noise = np.sum((cf - pf) ** 2, axis=1)
    seg = 10 * np.log10(sig / (noise + eps) + eps)
    return overall, np.clip(seg, -10.0, 35.0)


# --------------------------------------------------------------------------
# STOI — short-time objective intelligibility (Taal 2010)
# --------------------------------------------------------------------------


def _thirdoct(fs: int, n_fft: int, num_bands: int, mn: int):
    """1/3-octave band matrix (compute_metrics.py:374-414)."""
    f = np.linspace(0, fs, n_fft + 1)[: n_fft // 2 + 1]
    k = np.arange(num_bands)
    cf = 2.0 ** (k / 3) * mn
    fl = np.sqrt(cf * 2.0 ** ((k - 1) / 3) * mn)
    fr = np.sqrt(cf * 2.0 ** ((k + 1) / 3) * mn)
    A = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        b = np.argmin((f - fl[i]) ** 2)
        fl_ii = b
        b = np.argmin((f - fr[i]) ** 2)
        fr_ii = b
        A[i, fl_ii:fr_ii] = 1
    rnk = np.sum(A, axis=1)
    result = 0
    for i in range(len(rnk) - 1):
        if rnk[i + 1] >= rnk[i] and rnk[i + 1] != 0:
            result = i
    num_bands = result + 2
    return A[:num_bands], cf[:num_bands]


def _remove_silent_frames(x, y, dyn_range, n, k):
    frames = np.arange(0, len(x) - n, k)
    w = sp_signal.windows.hann(n + 2)[1 : n + 1]
    idx = frames[:, None] + np.arange(-1, n - 1)[None, :]
    msk = 20 * np.log10(np.linalg.norm(x[idx] * w, axis=1) / np.sqrt(n))
    msk = (msk - np.max(msk) + dyn_range) > 0
    x_sil = np.zeros(len(x))
    y_sil = np.zeros(len(y))
    count = 0
    for j in range(len(frames)):
        if msk[j]:
            jj_i = slice(frames[j], frames[j] + n)
            jj_o = slice(frames[count], frames[count] + n)
            x_sil[jj_o] += x[jj_i] * w
            y_sil[jj_o] += y[jj_i] * w
            count += 1
    end = frames[count - 1] + n if count > 0 else 0
    return x_sil[:end], y_sil[:end]


def _stdft(x, n, k, n_fft):
    frames_size = int((len(x) - n) / k)
    w = sp_signal.windows.hann(n + 2)[1 : n + 1]
    z = sp_signal.stft(
        x, window=w, nperseg=n, noverlap=k, nfft=n_fft,
        return_onesided=False, boundary=None,
    )[2]
    return np.transpose(z)[:frames_size]


def stoi(x: np.ndarray, y: np.ndarray, fs_signal: int) -> float:
    """Full STOI (compute_metrics.py:318-371): resample to 10 kHz, remove
    silent frames, 1/3-octave decomposition, clipped windowed correlation."""
    if len(x) != len(y):
        raise ValueError("x and y should have the same length")
    fs, n_frame, K, J, mn = 10000, 256, 512, 15, 150
    N, beta, dyn_range = 30, -15.0, 40
    H, _ = _thirdoct(fs, K, J, mn)
    if fs_signal != fs:
        x = sp_signal.resample_poly(x, fs, fs_signal)
        y = sp_signal.resample_poly(y, fs, fs_signal)
    x, y = _remove_silent_frames(x, y, dyn_range, n_frame, n_frame // 2)
    x_hat = _stdft(x, n_frame, n_frame // 2, K)[:, : K // 2 + 1].T
    y_hat = _stdft(y, n_frame, n_frame // 2, K)[:, : K // 2 + 1].T
    X = np.sqrt(H @ np.abs(x_hat) ** 2)
    Y = np.sqrt(H @ np.abs(y_hat) ** 2)
    c = 10 ** (-beta / 20)
    n_seg = X.shape[1] - N + 1
    if n_seg <= 0:
        return float("nan")
    d_interm = np.zeros(n_seg)
    for m in range(n_seg):
        X_seg = X[:, m : m + N]
        Y_seg = Y[:, m : m + N]
        alpha = np.sqrt(
            np.sum(X_seg**2, axis=1, keepdims=True)
            / np.sum(Y_seg**2, axis=1, keepdims=True)
        )
        aY = Y_seg * alpha
        Yp = np.minimum(aY, X_seg + X_seg * c)
        xn = X_seg - X_seg.mean(axis=1, keepdims=True)
        xn /= np.linalg.norm(xn, axis=1, keepdims=True)
        yn = Yp - Yp.mean(axis=1, keepdims=True)
        yn /= np.linalg.norm(yn, axis=1, keepdims=True)
        d_interm[m] = np.sum(xn * yn) / J
    return float(d_interm.mean())


# --------------------------------------------------------------------------
# Composite
# --------------------------------------------------------------------------


def compute_metrics(
    clean: np.ndarray,
    enhanced: np.ndarray,
    Fs: int = 16000,
    path: int = 0,
    pesq_fn=None,
):
    """(pesq, CSIG, CBAK, COVL, SSNR, STOI) of a clean/enhanced pair
    (compute_metrics.py:25-76).  ``pesq_fn(fs, ref, deg)`` defaults to the
    native C++ engine; pass path=1 to read the arguments as wav paths."""
    alpha = 0.95
    if path == 1:
        from scipy.io import wavfile

        sr1, clean = wavfile.read(clean)
        sr2, enhanced = wavfile.read(enhanced)
        if sr1 != sr2:
            raise ValueError("The two files do not match!\n")
        Fs = sr1
    if len(clean) != len(enhanced):
        length = min(len(clean), len(enhanced))
        clean = clean[:length] + np.spacing(1)
        enhanced = enhanced[:length] + np.spacing(1)

    clean = np.asarray(clean, np.float64)
    enhanced = np.asarray(enhanced, np.float64)

    wss_dist_vec = np.sort(wss(clean, enhanced, Fs))
    wss_dist = np.mean(wss_dist_vec[: round(len(wss_dist_vec) * alpha)])

    llr_vec = np.sort(llr(clean, enhanced, Fs))
    llr_mean = np.mean(llr_vec[: round(len(llr_vec) * alpha)])

    _, seg_snr_vec = snr(clean, enhanced, Fs)
    seg_snr = float(np.mean(seg_snr_vec))

    if pesq_fn is None:
        from speech_enhancement_tpu_torch.metrics.pesq import pesq as pesq_fn
    pesq_mos = pesq_fn(Fs, clean, enhanced, "wb")

    csig = np.clip(3.093 - 1.029 * llr_mean + 0.603 * pesq_mos - 0.009 * wss_dist, 1, 5)
    cbak = np.clip(1.634 + 0.478 * pesq_mos - 0.007 * wss_dist + 0.063 * seg_snr, 1, 5)
    covl = np.clip(1.594 + 0.805 * pesq_mos - 0.512 * llr_mean - 0.007 * wss_dist, 1, 5)

    stoi_val = stoi(clean, enhanced, Fs)
    return pesq_mos, float(csig), float(cbak), float(covl), seg_snr, stoi_val
