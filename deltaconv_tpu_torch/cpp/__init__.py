"""Native (C++) preprocessing ops of the port: geodesic FPS and a CPU kNN
(counterpart of ``deltaconv_tpu/cpp``, its own copy of the source).

The shared library is built with ``g++`` at first use into
``deltaconv_tpu_torch/_build/`` and loaded through ``ctypes``
(:func:`load_library`); importing this package builds nothing.
"""

from .build import load_library

__all__ = ["load_library"]
