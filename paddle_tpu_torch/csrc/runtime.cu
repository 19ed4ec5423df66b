// Error reporting for the ctypes wrappers: every kernel entry point returns
// cudaGetLastError() as an int, and the wrapper asks for its message here.
#include <cuda_runtime.h>

extern "C" const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
