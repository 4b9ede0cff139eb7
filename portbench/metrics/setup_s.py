"""``setup_s``: seconds from process start to the window's first call
(imports, CUDA init, the seeded impulse and input, the impulse file, the
engine's build with its self-check, and the warm-up)."""


def read(run):
    return run.setup_s
