"""bfir_tpu_torch: the bfir_tpu streaming engine on PyTorch and CUDA.

A port of ``bfir_tpu`` (JAX on a TPU) to PyTorch with hand-written CUDA
kernels for NVIDIA Hopper. It keeps the reference's layer names and
function names so each counterpart is easy to find:

- ``core``     — configuration specs, the uniform complex convolver and its
                 batched bulk form, the two-stage non-uniform engine with
                 its split-tail schedule, the G-batch bulk scan and the
                 offline ``BulkRenderer``
- ``ops``      — FFT layouts, FIR design, equalizer, resampler, dither and
                 overflow accounting, PCM codecs and the output stage,
                 delay lines
- ``kernels``  — the halfcomplex ring MAC (K1-K3) and its one-band form
                 (K5, K6), the tail-fire inverse (K4), the correlation MAC
                 (K7), the packed engine's MAC (K8) and the hp-TPDF
                 requantizer (K9), each a CUDA kernel with its plain
                 PyTorch version
- ``engine``   — chain composition, artifact cache, known-answer
                 self-check, streaming session with ``render`` and
                 ``process_raw``
- ``io``       — WAV and the other sound-file formats (numpy / ctypes)
- ``utils``    — logging sink, block timer, cache-key hashing
- ``cli``      — the offline render command
- ``convert``  — state and coefficients to and from ``bfir_tpu`` (numpy)

Every function that makes tensors takes an explicit ``device``; CPU tensors
run the kernels' plain versions, CUDA tensors run the kernels. The package
imports nothing of ``bfir_tpu`` and never imports JAX.
"""
