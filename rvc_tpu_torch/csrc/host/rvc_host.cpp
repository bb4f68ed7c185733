// Host kernels of rvc_tpu_torch: the loops around the card's work that
// plain numpy runs in several passes or in Python.
//
//   peak_quantize_i16    the conversion's upload buffer: the peak, then the
//                        int16 quantization, in two streaming passes
//   frame_rms            the slicer's centre-padded frame RMS, summed in
//                        double
//   slicer_silence_tags  the slicer's sequential silence state machine
//   dequantize_i16       int16 back to float32 at one scale (not bound: the
//                        port dequantizes on the card)
//
// A plain C interface, loaded with ctypes by rvc_tpu_torch/native.py, which
// builds this file with g++ -O3 -shared -fPIC at first use. The numpy
// versions (ops/filters.py, ops/slicer.py, *_numpy) are the plain
// versions: peak_quantize_i16 and the state machine give their bits (the
// same arithmetic, the same tie-breaking); frame_rms, summed in double,
// agrees within float32 rounding. The tests assert both.

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// peak_quantize_i16: one streaming pass over the padded song buffer.
//
// The conversion's host prep (pipelines/convert.py):
//   peak = |x|.max();  q = rint(x * 32766/max(peak,1e-9)) -> int16
// numpy needs three passes and two temporaries (|x|, the scaled copy);
// this does one read pass for the peak and one fused scale+round+store
// pass — the auto-vectorizer turns both into SIMD loops.
// Returns the peak so the caller can form inv_scale.
// ---------------------------------------------------------------------------
double peak_quantize_i16(const float* x, int64_t n, int16_t* out) {
    float peak = 0.0f;
    for (int64_t i = 0; i < n; ++i) {
        float a = std::fabs(x[i]);
        if (a > peak) peak = a;
    }
    float p = peak > 1e-9f ? peak : 1e-9f;
    float scale = 32766.0f / p;
    for (int64_t i = 0; i < n; ++i) {
        // rint (round-half-to-even) matches np.rint exactly
        out[i] = (int16_t)std::rint(x[i] * scale);
    }
    return (double)peak;
}

// ---------------------------------------------------------------------------
// frame_rms: center-padded frame RMS (librosa.feature.rms semantics),
// streaming with a running sum of squares — O(n) instead of numpy's
// materialized (n_frames, frame_length) matrix (a 4x data blowup at the
// slicer's win=4*hop). Accumulates in double, so it matches ops/slicer.py
// frame_rms_numpy within float32 rounding (numpy sums in float32 pairwise).
//   y: length n;  out: length 1 + (n + 2*(frame//2) - frame) / hop
// ---------------------------------------------------------------------------
int64_t frame_rms(const float* y, int64_t n, int64_t frame, int64_t hop,
                  float* out) {
    const int64_t pad = frame / 2;
    const int64_t total = n + 2 * pad;
    if (total < frame) return 0;
    const int64_t n_frames = 1 + (total - frame) / hop;
    // padded value at index i (zero outside [pad, pad+n))
    auto at = [&](int64_t i) -> double {
        i -= pad;
        return (i >= 0 && i < n) ? (double)y[i] : 0.0;
    };
    if (hop * 8 < frame) {
        // heavy overlap: sliding sum of squares.  Recompute from scratch
        // every ~4096 frames to stop fp drift from accumulating.
        double ss = 0.0;
        for (int64_t i = 0; i < frame; ++i) { double v = at(i); ss += v * v; }
        int64_t start = 0;
        for (int64_t f = 0; f < n_frames; ++f) {
            if (f && (f & 4095) == 0) {
                ss = 0.0;
                for (int64_t i = start; i < start + frame; ++i) {
                    double v = at(i); ss += v * v;
                }
            }
            out[f] = (float)std::sqrt(ss > 0.0 ? ss / (double)frame : 0.0);
            for (int64_t i = start; i < start + hop; ++i) {
                double v = at(i); ss -= v * v;
            }
            for (int64_t i = start + frame; i < start + frame + hop; ++i) {
                double v = at(i); ss += v * v;
            }
            start += hop;
        }
    } else {
        // light overlap (the slicer's frame = 4*hop case): direct per-frame
        // sums are cheap and exactly match the numpy mean-of-squares.
        for (int64_t f = 0; f < n_frames; ++f) {
            const int64_t start = f * hop;
            double ss = 0.0;
            for (int64_t i = start; i < start + frame; ++i) {
                double v = at(i); ss += v * v;
            }
            out[f] = (float)std::sqrt(ss / (double)frame);
        }
    }
    return n_frames;
}

// ---------------------------------------------------------------------------
// slicer_silence_tags: the Slicer state machine (ops/slicer.py
// Slicer._silence_tags_numpy; reference lib/slicer2.py:76-183 semantics). Sequential
// and branchy — exactly the shape of loop CPython is worst at and C is
// built for. Emits (start, end) frame pairs into tags (capacity
// max_tags pairs); returns the number of pairs written.
// argmin tie-breaking: first occurrence, matching np.argmin.
// ---------------------------------------------------------------------------
static int64_t argmin_range(const float* rms, int64_t lo, int64_t hi_incl,
                            int64_t n) {
    if (hi_incl >= n) hi_incl = n - 1;
    int64_t best = lo;
    float bv = rms[lo];
    for (int64_t i = lo + 1; i <= hi_incl; ++i) {
        if (rms[i] < bv) { bv = rms[i]; best = i; }
    }
    return best;
}

int64_t slicer_silence_tags(const float* rms, int64_t n, double threshold,
                            int64_t min_interval, int64_t min_length,
                            int64_t max_sil_kept, int64_t* tags,
                            int64_t max_tags) {
    const int64_t K = max_sil_kept;
    int64_t n_tags = 0;
    int64_t sil_start = -1;
    int64_t clip_start = 0;
    for (int64_t i = 0; i < n; ++i) {
        if ((double)rms[i] < threshold) {
            if (sil_start < 0) sil_start = i;
            continue;
        }
        if (sil_start < 0) continue;
        const bool leading = (sil_start == 0) && (i > K);
        const bool middle = (i - sil_start >= min_interval) &&
                            (i - clip_start >= min_length);
        if (!leading && !middle) { sil_start = -1; continue; }
        const int64_t run = i - sil_start;
        if (n_tags >= max_tags) return -1;  // caller must grow the buffer
        if (run <= K) {
            const int64_t pos = argmin_range(rms, sil_start, i, n);
            if (sil_start == 0) {
                tags[2 * n_tags] = 0; tags[2 * n_tags + 1] = pos;
            } else {
                tags[2 * n_tags] = pos; tags[2 * n_tags + 1] = pos;
            }
            ++n_tags;
            clip_start = pos;
        } else if (run <= 2 * K) {
            const int64_t pos = argmin_range(rms, i - K, sil_start + K, n);
            const int64_t pos_l = argmin_range(rms, sil_start, sil_start + K, n);
            const int64_t pos_r = argmin_range(rms, i - K, i, n);
            if (sil_start == 0) {
                tags[2 * n_tags] = 0; tags[2 * n_tags + 1] = pos_r;
                clip_start = pos_r;
            } else {
                const int64_t lo = pos_l < pos ? pos_l : pos;
                const int64_t hi = pos_r > pos ? pos_r : pos;
                tags[2 * n_tags] = lo; tags[2 * n_tags + 1] = hi;
                clip_start = hi;
            }
            ++n_tags;
        } else {
            const int64_t pos_l = argmin_range(rms, sil_start, sil_start + K, n);
            const int64_t pos_r = argmin_range(rms, i - K, i, n);
            if (sil_start == 0) {
                tags[2 * n_tags] = 0; tags[2 * n_tags + 1] = pos_r;
            } else {
                tags[2 * n_tags] = pos_l; tags[2 * n_tags + 1] = pos_r;
            }
            ++n_tags;
            clip_start = pos_r;
        }
        sil_start = -1;
    }
    if (sil_start >= 0 && n - sil_start >= min_interval) {
        if (n_tags >= max_tags) return -1;
        int64_t sil_end = sil_start + K < n ? sil_start + K : n;
        const int64_t pos = argmin_range(rms, sil_start, sil_end, n);
        tags[2 * n_tags] = pos; tags[2 * n_tags + 1] = n + 1;
        ++n_tags;
    }
    return n_tags;
}

// ---------------------------------------------------------------------------
// dequantize_i16: out[i] = (float)x[i] * scale. The download side of the
// int16 link format (one fused pass; numpy does astype + multiply).
// ---------------------------------------------------------------------------
void dequantize_i16(const int16_t* x, int64_t n, double scale, float* out) {
    const float s = (float)scale;
    for (int64_t i = 0; i < n; ++i) out[i] = (float)x[i] * s;
}

}  // extern "C"
