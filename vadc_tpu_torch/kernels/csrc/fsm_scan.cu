// The batch segmenter's hysteresis FSM over a whole slab in one launch.
//
// Replaces no TPU kernel: the JAX package runs its vectorized FSM as a
// lax.scan (vadc_tpu/engine/vectorized_segmenter.py), which XLA fuses into
// one loop on the device. The port's plain version
// (engine/vectorized_segmenter.py: segment_batch) advances the FSM one
// chunk column at a time in about 30 small torch ops, each a launch from
// the host; this kernel is that loop on the device.
//
// probs [B, T] fp32 (entry (b, t) at probs + b*stride_b + t*stride_t) ->
// events [3, T, B] int32 (closed, seg_start, seg_end, each [T, B], as
// segment_batch stacks them), and the FSM's state after the slab (bool
// `triggered` as bytes, int32 `speech_start` and `temp_end`) read from the
// `*_in` arrays and written to the `*_out` arrays, which may be the same.
// One thread owns one stream and walks the T columns in order, its state in
// registers; the transitions are fsm_step's, in its order. Global chunk
// index of column t: chunk0 + t. valid (int32 [B] or null): a stream is
// inactive at a global index >= valid[b], its state frozen and `closed` 0;
// seg_start and seg_end are written as fsm_step computes them, active or
// not. The thresholds are fp32: the plain version compares an fp32 tensor
// with a Python float in fp32.
//
// What bounds it on an H100: nothing of the card. A v5 slab of 512 streams
// x 64 columns is 128 KB of probabilities in and 384 KB of events out
// (0.15 us at 3.35 TB/s) and some 20 integer operations a stream and
// column; each thread's steps form one dependent chain of 64 steps. The
// design's answer is to make it one launch: loads are issued eight columns
// ahead of the chain (they do not depend on the state), the event stores
// are coalesced across the threads of a warp (consecutive streams).
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int AHEAD = 8;  // columns loaded ahead of the steps

__global__ void __launch_bounds__(THREADS)
fsm_scan_kernel(const float* __restrict__ probs, long long stride_b, long long stride_t,
                int batch, int n_cols, float threshold, float neg_threshold,
                int min_silence, int min_speech, int chunk0, const int* __restrict__ valid,
                const unsigned char* triggered_in, const int* speech_in, const int* temp_in,
                unsigned char* triggered_out, int* speech_out, int* temp_out,
                int* __restrict__ events) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= batch) return;
  const float* row = probs + b * stride_b;
  const long long plane = static_cast<long long>(n_cols) * batch;
  int* closed_out = events + b;
  int* start_out = events + plane + b;
  int* end_out = events + 2 * plane + b;
  const int last = valid ? valid[b] : 0x7fffffff;  // active while idx < last
  bool triggered = triggered_in[b] != 0;
  int speech_start = speech_in[b];
  int temp_end = temp_in[b];

  for (int t0 = 0; t0 < n_cols; t0 += AHEAD) {
    float p[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      p[u] = t0 + u < n_cols ? __ldg(row + (t0 + u) * stride_t) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      const int t = t0 + u;
      if (t >= n_cols) break;
      const int idx = chunk0 + t;
      const bool above = p[u] >= threshold;
      const bool below_neg = p[u] < neg_threshold;
      // prob >= threshold cancels a tentative end
      int te = above ? 0 : temp_end;
      // not triggered and above -> trigger
      const bool newly = !triggered && above;
      int ss = newly ? idx : speech_start;
      bool trig = triggered || newly;
      // triggered (before this chunk) and below neg_threshold -> tentative
      // end, maybe close
      const bool tentative = triggered && below_neg;
      if (tentative && te == 0) te = idx;
      const bool closing = tentative && idx - te >= min_silence;
      const bool closed = closing && te - ss >= min_speech;
      const bool active = idx < last;
      const long long at = static_cast<long long>(t) * batch;
      closed_out[at] = closed && active;
      start_out[at] = ss;
      end_out[at] = te;
      // reset on close (valid or discarded); an inactive stream keeps its state
      if (active) {
        triggered = trig && !closing;
        speech_start = closing ? 0 : ss;
        temp_end = closing ? 0 : te;
      }
    }
  }
  triggered_out[b] = triggered ? 1 : 0;
  speech_out[b] = speech_start;
  temp_out[b] = temp_end;
}

}  // namespace

extern "C" int vadc_fsm_scan(const float* probs, long long stride_b, long long stride_t,
                             int batch, int n_cols, float threshold, float neg_threshold,
                             int min_silence, int min_speech, int chunk0, const int* valid,
                             const unsigned char* triggered_in, const int* speech_in,
                             const int* temp_in, unsigned char* triggered_out, int* speech_out,
                             int* temp_out, int* events, void* stream) {
  if (batch <= 0 || n_cols <= 0 || chunk0 < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (batch + THREADS - 1) / THREADS;
  fsm_scan_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      probs, stride_b, stride_t, batch, n_cols, threshold, neg_threshold, min_silence,
      min_speech, chunk0, valid, triggered_in, speech_in, temp_in, triggered_out, speech_out,
      temp_out, events);
  return static_cast<int>(cudaGetLastError());
}
