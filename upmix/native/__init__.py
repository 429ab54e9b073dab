"""ctypes bindings for the native C++ streaming host shell.

The shared library (native/libupmix_host.so, built with `make -C native`)
implements the framework's streaming semantics in pure C++ for low-latency
local playback without an accelerator — the native-equivalent of the reference's
real-time engine (bela/upmix.cpp), bit-comparable against both the NumPy
oracle and the JAX streaming path.
"""

from upmix.native.host import (
    NativeStreamingUpmixer,
    is_available,
    library_path,
)

__all__ = ["NativeStreamingUpmixer", "is_available", "library_path"]
