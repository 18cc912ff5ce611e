// The sin (SIREN) instantiations of the Fourier-feature MLP kernels (csrc/ff_mlp.cuh):
// K2-FF, K7, K8, K3 and wide K4 with act 2, called through csrc/ff_mlp.cu's entry points.
// A translation unit of their own, so the build compiles them beside the tanh / sigmoid
// ones and the sin branch leaves those as they were.

#include "ff_mlp.cuh"

template struct FfHost<true>;
