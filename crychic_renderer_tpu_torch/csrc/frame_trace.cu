// Frame trace marks for Hopper (sm_90a): the device half of
// app/profiler.FrameTrace. A traced frame's CUDA graph holds one mark
// launch at its start and one after each stage of passes/frame.py's
// render_frame; each is one thread that reads %globaltimer (ns) and
// writes it into the ring of the frame's marks.
//
// The graph is captured from one stream, so its nodes form one chain: a
// mark runs after every kernel captured before it has finished and before
// any kernel captured after it starts. The marks therefore cut the
// replay's kernels into contiguous stages, and the difference of two
// marks is the device time of the stage between them.
//
// Ring layout: ring is (rows, cols) int64, row r = frame % rows. Column 0
// holds the frame number, column 1 the start mark, columns 2 .. cols - 1
// the end mark of each stage (0 where the frame has no such stage). The
// start mark (start != 0) advances the frame counter, a device int64 the
// graph owns: it takes f = *counter, writes *counter = f + 1, stores the
// frame's row in *row for the later marks and for the counts written
// after the frame (app/profiler.FrameTrace.write_counts), and clears the
// row's stage columns. Each replay of the graph is thus one frame, and a
// ring read after the frames have finished says which frame every row
// holds.

#include <cuda_runtime.h>

namespace {

__global__ void frame_mark_kernel(long long* counter, long long* row,
                                  long long* ring, int rows, int cols,
                                  int col, int start) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  long long r;
  if (start) {
    const long long f = *counter;
    *counter = f + 1;
    r = f % rows;
    *row = r;
    long long* out = ring + r * cols;
    out[0] = f;
    for (int c = 2; c < cols; ++c) out[c] = 0;
  } else {
    r = *row;
  }
  ring[r * cols + col] = static_cast<long long>(t);
}

}  // namespace

// Queue one mark on `stream`: column `col` of the current frame's row
// (with start != 0: the start mark, col 1, which advances the frame).
// Returns a cudaError_t (0 on success).
extern "C" int crychic_frame_mark(void* counter, void* row, void* ring,
                                  int rows, int cols, int col, int start,
                                  void* stream) {
  if (rows <= 0 || cols < 2 || col < 1 || col >= cols)
    return static_cast<int>(cudaErrorInvalidValue);
  frame_mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(counter), static_cast<long long*>(row),
      static_cast<long long*>(ring), rows, cols, col, start);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* crychic_frame_trace_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
