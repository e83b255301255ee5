"""The native C++ bulk query sampler (sampler.cpp), built with g++ at first
use and bound with ctypes."""

from graphqembed_tpu_torch.native.binding import (  # noqa: F401
    native_all_edges_1p,
    native_available,
    native_sample_arrays,
    native_sample_clean_arrays,
    native_sample_clean_many,
    native_sample_many,
)
