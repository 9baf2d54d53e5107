// Error text for the cudaError_t codes the other entry points return.
#include <cuda_runtime.h>

extern "C" const char* pcis_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
