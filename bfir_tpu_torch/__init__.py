"""bfir_tpu_torch: the bfir_tpu streaming engine on PyTorch and CUDA.

A port of ``bfir_tpu`` (JAX on a TPU) to PyTorch with hand-written CUDA
kernels for NVIDIA Hopper. It keeps the reference's layer names and
function names so each counterpart is easy to find:

- ``core``     — the uniform complex convolver and the two-stage
                 non-uniform engine
- ``ops``      — FFT layouts, FIR design, equalizer, resampler, overflow
                 accounting
- ``kernels``  — the halfcomplex ring MAC (K1-K3) and the tail-fire inverse
                 (K4), each a CUDA kernel with its plain PyTorch version
- ``engine``   — chain composition, known-answer self-check, streaming
                 session
- ``convert``  — state and coefficients to and from ``bfir_tpu`` (numpy)

Every function that makes tensors takes an explicit ``device``; CPU tensors
run the kernels' plain versions, CUDA tensors run the kernels. Modules of
``bfir_tpu`` that load no JAX (``core.spec``, ``io``, ``engine.cache``,
``utils``) are used as they are.
"""
