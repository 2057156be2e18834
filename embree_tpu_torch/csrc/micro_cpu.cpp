// CPU twin of the three loop-probe kernels (test-only).
//
// Compiles every probe of micro_ops.cu, micro_expand.cu and micro_v8.cu
// (their layouts, passes, tables and carried values, written against
// micro.cuh's block) for the host with g++ and -ffp-contract=off, over
// micro::Host: the block's threads one after another between barriers,
// each warp's lanes in lockstep for its reductions. A machine without a GPU
// holds the kernels' arithmetic against the plain PyTorch versions bit for
// bit with it. Never on the main path.
//
// Build: g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC micro_cpu.cpp
//        -o libmicro_twin.so
#include "micro_expand.cu"
#include "micro_ops.cu"
#include "micro_v8.cu"

// Same arguments as micro_ops / micro_expand / micro_v8 (micro_*.cu)
// without the stream, host pointers, plus aux: where not null, each
// thread's copy of acc[0, 0] (the dynamic slices; kBlock words). Return 0,
// or 1 for an unknown probe or shape.
extern "C" int micro_ops_twin(int probe, const int32_t* x, int rows,
                              int32_t* out, int iters, int32_t* aux) {
  return micro::twin_unit<ops::Ops>(probe, x, rows, out, iters, aux);
}

extern "C" int micro_expand_twin(int probe, const int32_t* x, int rows,
                                 int32_t* out, int iters, int32_t* aux) {
  return micro::twin_unit<expand::Expand>(probe, x, rows, out, iters, aux);
}

extern "C" int micro_v8_twin(int probe, const int32_t* x, int rows,
                             int32_t* out, int iters, int32_t* aux) {
  return micro::twin_unit<v8::V8>(probe, x, rows, out, iters, aux);
}
