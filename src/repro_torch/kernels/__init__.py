"""Hand-written CUDA C++ kernels for Hopper (``sm_90a``).

Each kernel directory carries:
  csrc/*.cu — the kernel, with a plain ``extern "C"`` launch entry that
              returns ``cudaGetLastError()``
  ops.py    — the wrapper: checks, allocation, launch on the current
              stream, a launch count; on CPU tensors the plain version
  ref.py    — an independent plain-PyTorch oracle for the tests

``_build.py`` compiles every ``csrc/*.cu`` with ``nvcc`` on first use.
"""
