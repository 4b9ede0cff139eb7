"""``realtime_x``: the frames the window's calls returned, over the
window's seconds and the sample rate: how many times faster than real
time the card runs the deployment."""


def read(run):
    w = run.window
    return w.frames / w.seconds / run.rate
