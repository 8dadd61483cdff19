// Kernel D: the McCandless formant-slot tracker scanned over frames, one
// thread per recording.
//
// Replaces voxtpu/ops/formant_scan_pallas.py::mccandless_scan_pallas
// (pallas_call at formant_scan_pallas.py:284). Semantics follow
// voxtpu.formants.estimate_formants_step (the reference's
// EstimateFormants, spectrum.rs:232-333) exactly, frame after frame:
//   step 2: each of the first min(L, 6) estimates takes its nearest
//           resonance (first wins on ties, as argmin), over the whole
//           resonance row including its zero tail;
//   step 3: dedup of neighbouring slots with the moving pointer w;
//   step 4: fill empty slots with the first min(R, 6) resonances (b1, b2,
//           b3 branches);
//   step 5: stable sort, invalid slots first, then by frequency;
//   write-back: the winners (valid, freq > 0) overwrite the leading
//           estimates in order.
// The carry (L estimates) resets to the seed at the first frame of every
// recording: F = files * file_len frames, one thread per file. Only
// comparisons, copies and |a - b| touch the values, so the result is
// bit-identical to the plain version in any dtype.
//
// What bounds it: latency. The recurrence is serial over frames; each frame
// is a few hundred dependent scalar operations, about 6 x R distance
// compares plus branchy slot logic, on 2 x R values read from device
// memory. One recording is one thread: the card is almost idle, and the
// time is (frames) x (one frame's dependent chain). Measured at the 44.1 kHz
// CLI default (one recording of 35,689 frames, float32): 194-196 ms, 5.4 us
// per frame, the largest share of the whole analysis; the plain PyTorch
// loop on the card takes 5.6-7.9 ms per frame (NVIDIA H100 80GB HBM3, 700 W).
//
// Design: the slots and estimates live in per-thread arrays; no shared
// memory and no synchronisation. The TPU kernel's sentinel encoding, DMA
// blocks and 128-lane tiles are gone. Spreading one recording over many
// threads needs a different algorithm (the frame-to-frame dependency is
// data-dependent), which is later work.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kSlots = 6;  // FormantSlots = [Option<Resonance>; 6] (spectrum.rs:228)
constexpr int kMaxL = 16;

template <typename T>
__device__ __forceinline__ void set_slot(T* sf, T* sb, bool* sv, int k, T f, T b, bool v) {
  sf[k] = f;
  sb[k] = b;
  sv[k] = v;
}

template <typename T>
__global__ void formant_scan_kernel(const T* __restrict__ rf, const T* __restrict__ rb,
                                    const T* __restrict__ ef0, const T* __restrict__ eb0,
                                    T* __restrict__ out_f, T* __restrict__ out_b, int files,
                                    int file_len, int R, int L) {
  const int file = blockIdx.x * blockDim.x + threadIdx.x;
  if (file >= files) return;

  T ef[kMaxL];
  T eb[kMaxL];
  for (int i = 0; i < L; ++i) {
    ef[i] = ef0[i];
    eb[i] = eb0[i];
  }
  const int ns = L < kSlots ? L : kSlots;
  const int nfill = R < kSlots ? R : kSlots;

  const long t0 = static_cast<long>(file) * file_len;
  for (long t = t0; t < t0 + file_len; ++t) {
    const T* f = rf + t * R;
    const T* b = rb + t * R;
    T sf[kSlots];
    T sb[kSlots];
    bool sv[kSlots];

    // Step 2: nearest resonance per estimate slot (spectrum.rs:234-245).
    // argmin semantics: the first minimum wins, and a NaN distance is the
    // minimum.
    for (int s = 0; s < kSlots; ++s) {
      if (s < ns) {
        int best = 0;
        T bd = fabs(f[0] - ef[s]);
        for (int j = 1; j < R; ++j) {
          const T d = fabs(f[j] - ef[s]);
          if (!isnan(bd) && (isnan(d) || d < bd)) {
            bd = d;
            best = j;
          }
        }
        set_slot(sf, sb, sv, s, f[best], b[best], true);
      } else {
        set_slot(sf, sb, sv, s, T(0), T(0), false);
      }
    }

    // Step 3: dedup with the moving pointer w (spectrum.rs:250-272).
    int w = 0;
    bool unassigned = false;
    for (int r = 1; r < kSlots; ++r) {
      const bool valid_r = sv[r];
      const bool same = valid_r && sf[r] == sf[w] && sb[r] == sb[w];
      const T est_r = ef[r < L - 1 ? r : L - 1];
      const T est_w = ef[w < L - 1 ? w : L - 1];
      const bool closer_r = fabs(sf[r] - est_r) < fabs(sf[r] - est_w);
      const bool inval_w = same && closer_r;
      if (inval_w) sv[w] = false;
      if (same && !closer_r) sv[r] = false;
      unassigned = unassigned || same;
      if (inval_w || (!same && valid_r)) w = r;
    }

    // Step 4: fill empty slots with unassigned peaks (spectrum.rs:274-310);
    // iterations j >= 6 change nothing.
    for (int j = 0; j < nfill; ++j) {
      const T pf = f[j];
      const T pb = b[j];
      bool contains = false;
      for (int k = 0; k < kSlots; ++k) contains = contains || (sv[k] && sf[k] == pf && sb[k] == pb);
      bool can = unassigned && !contains;
      if (can && !sv[j]) {
        set_slot(sf, sb, sv, j, pf, pb, true);
        can = false;
      }
      if (j > 0 && can && !sv[j - 1]) {
        set_slot(sf, sb, sv, j - 1, sf[j], sb[j], sv[j]);
        set_slot(sf, sb, sv, j, pf, pb, true);
        can = false;
      }
      if (j + 1 < kSlots && can && !sv[j + 1]) {
        set_slot(sf, sb, sv, j + 1, sf[j], sb[j], sv[j]);
        set_slot(sf, sb, sv, j, pf, pb, true);
      }
    }

    // Step 5: stable sort, invalid slots first, then ascending frequency
    // (spectrum.rs:312-324). Insertion sort with a strict compare is stable.
    T key[kSlots];
    for (int k = 0; k < kSlots; ++k) key[k] = sv[k] ? sf[k] : -INFINITY;
    for (int i = 1; i < kSlots; ++i) {
      for (int j = i; j > 0 && key[j - 1] > key[j]; --j) {
        const T kf = key[j - 1], ff = sf[j - 1], bb = sb[j - 1];
        const bool vv = sv[j - 1];
        key[j - 1] = key[j];
        set_slot(sf, sb, sv, j - 1, sf[j], sb[j], sv[j]);
        key[j] = kf;
        set_slot(sf, sb, sv, j, ff, bb, vv);
      }
    }

    // Write-back: winners overwrite the leading estimates in order
    // (spectrum.rs:326-332).
    int count = 0;
    for (int p = 0; p < kSlots; ++p) {
      if (sv[p] && sf[p] > T(0)) {
        if (count < L) {
          ef[count] = sf[p];
          eb[count] = sb[p];
        }
        ++count;
      }
    }

    for (int i = 0; i < L; ++i) {
      out_f[t * L + i] = ef[i];
      out_b[t * L + i] = eb[i];
    }
  }
}

template <typename T>
int launch(const void* rf, const void* rb, const void* ef0, const void* eb0, void* out_f,
           void* out_b, int F, int R, int L, int file_len, void* stream) {
  if (L < 1 || L > kMaxL || R < 1 || file_len < 1 || F % file_len != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int files = F / file_len;
  if (files > 0) {
    constexpr int kThreads = 32;
    formant_scan_kernel<T><<<vt::blocks_for(files, kThreads), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(rf), static_cast<const T*>(rb), static_cast<const T*>(ef0),
        static_cast<const T*>(eb0), static_cast<T*>(out_f), static_cast<T*>(out_b), files,
        file_len, R, L);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

VT_EXPORT int vt_formant_scan_f32(const void* rf, const void* rb, const void* ef0,
                                  const void* eb0, void* out_f, void* out_b, int F, int R, int L,
                                  int file_len, void* stream) {
  return launch<float>(rf, rb, ef0, eb0, out_f, out_b, F, R, L, file_len, stream);
}

VT_EXPORT int vt_formant_scan_f64(const void* rf, const void* rb, const void* ef0,
                                  const void* eb0, void* out_f, void* out_b, int F, int R, int L,
                                  int file_len, void* stream) {
  return launch<double>(rf, rb, ef0, eb0, out_f, out_b, F, R, L, file_len, stream);
}
